"""Public wrappers around the port's kernels, named as in
``repro/kernels/ops.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.scored_reduce import osafl_scores_fused, scored_reduce


def flash_attention(q, k, v, *, causal=True, scale=None):
    """Model-layout wrapper: q (B, S, H, D), k/v (B, S, Hkv, D) -> (B, S, H, D).
    The kernel reads and writes the transposed (B, H, S, D) views through
    their strides, so nothing is copied."""
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, scale=scale,
                         out=out.transpose(1, 2))
    return out


def osafl_scores(d_stacked: torch.Tensor, chi: float = 1.0) -> torch.Tensor:
    """OSAFL scores of stacked updates d_stacked (U, N)."""
    return osafl_scores_fused(d_stacked, chi)


def fused_scored_reduce(d_stacked: torch.Tensor, mean: torch.Tensor):
    return scored_reduce(d_stacked, mean)
