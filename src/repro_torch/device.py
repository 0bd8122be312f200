"""Device selection shared by every entry point of the port, and the
precision its runs hold convolutions to."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device, and raises when there is none: the
    port never falls back to the CPU on its own. Pass ``device="cpu"`` to
    run on the CPU (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def full_f32_convolutions():
    """Hold cuDNN's float32 convolutions in full f32 for the duration, and
    restore the caller's setting after. cuDNN computes them in TF32 by
    default (``torch.backends.cudnn.allow_tf32``), which moves the CNN's
    and SqueezeNet's gradients on a batch by 2e-3 to 1e-2 relative to the
    CPU's, against under 2e-6 in full f32 (NVIDIA H100). A run on the card
    is meant to equal the same run on the CPU; its loss over a few rounds
    at ``global_lr=1`` hides that difference, its gradients show it."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before
