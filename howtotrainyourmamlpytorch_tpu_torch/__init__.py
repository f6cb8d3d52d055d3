"""PyTorch + CUDA port of the MAML/MAML++ few-shot system for NVIDIA Hopper.

The JAX package ``howtotrainyourmamlpytorch_tpu`` beside it is the
reference; this package imports neither it nor JAX. It trains MAML++ from
an experiment JSON through its command line (``train_maml_system``: data
loader, experiment runtime, checkpoints interchangeable with the JAX
package's), serves episodes over HTTP (``serve_maml``: the micro-batcher,
admission, the safe hot swap, geometry, metrics) and meta-trains at
first and second order, with every Pallas kernel of the JAX package (the
fused batch norm + LeakyReLU, its any-order and pooled forms) as
hand-written sm_90a kernels (``ops/fused_norm.py``, ``csrc/fused_norm.cu``).
"""
