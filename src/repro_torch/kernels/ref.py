"""Plain-torch oracles for the port's kernels, named as in
``repro/kernels/ref.py``; ``score_backend="reference"`` routes here."""
from __future__ import annotations

import torch

from repro_torch.kernels.scored_reduce import scored_reduce_plain

#: d (U, N); mean (N,) -> (dots, norms_sq, mean_sq), in f32.
scored_reduce_reference = scored_reduce_plain


def osafl_scores_reference(d: torch.Tensor, chi: float = 1.0) -> torch.Tensor:
    mean = torch.mean(d.float(), dim=0)
    dots, norms, msq = scored_reduce_reference(d, mean)
    cos = dots / torch.clamp(torch.sqrt(norms) * torch.sqrt(msq), min=1e-12)
    return (chi + cos) / (chi + 1.0)
