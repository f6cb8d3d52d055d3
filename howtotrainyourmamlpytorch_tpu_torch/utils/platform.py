"""Device choice for the port's entry points.

Entry points run on the card: ``resolve_device()`` returns ``cuda`` and
raises where there is none. Tests and other CPU callers ask for the CPU
explicitly with ``device="cpu"``; nothing falls back to it silently.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def set_f32_numerics() -> None:
    """Full float32 and reproducible results for cuDNN and cuBLAS, on the
    serve and the train path.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits; the port is held to the JAX package in float32.
    cuDNN may also pick algorithms that add in a different order on every
    run, so the same episode could be served other logits; with
    deterministic algorithms (and the fused-norm kernels' fixed-order sums)
    it gets the same logits every time (``tools/port_serve_determinism.py``
    measures both)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
