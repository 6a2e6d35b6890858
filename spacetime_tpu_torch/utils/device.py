"""Device resolution and the float32 matmul precision rule.

The solver never moves to another device on its own: asking for CUDA where
there is none raises. ``resolve_device`` is also the one place that turns
TF32 off. The H100 runs float32 matrix products in TF32 when allowed, which
keeps about three decimal digits; a ~1e-3 perturbation of the coarse
inverses or the wavelet product stalls PCG and the mixed-precision
refinement, as the bf16 passes do on the TPU (the JAX package's
``Precision.HIGHEST`` rule, solver/heateq.py ``_dot``).
"""

from __future__ import annotations

import torch


def full_precision_matmul() -> None:
    """Run float32 matrix products and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises where CUDA is asked for and
    absent. Sets the matmul precision rule before the caller's first
    product."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    full_precision_matmul()
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
