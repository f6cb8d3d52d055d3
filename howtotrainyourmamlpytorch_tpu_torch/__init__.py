"""PyTorch + CUDA port of the MAML/MAML++ few-shot system for NVIDIA Hopper.

The JAX package ``howtotrainyourmamlpytorch_tpu`` beside it is the
reference; this package imports neither it nor JAX. Its first slice serves
MAML++ episodes (adapt + classify) with the fused batch-norm + LeakyReLU
forward and backward as hand-written sm_90a kernels (``ops/fused_norm.py``,
``csrc/fused_norm.cu``).
"""
