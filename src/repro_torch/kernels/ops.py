"""Public wrappers around the port's kernels, named as in
``repro/kernels/ops.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels.scored_reduce import osafl_scores_fused, scored_reduce


def osafl_scores(d_stacked: torch.Tensor, chi: float = 1.0) -> torch.Tensor:
    """OSAFL scores of stacked updates d_stacked (U, N)."""
    return osafl_scores_fused(d_stacked, chi)


def fused_scored_reduce(d_stacked: torch.Tensor, mean: torch.Tensor):
    return scored_reduce(d_stacked, mean)
