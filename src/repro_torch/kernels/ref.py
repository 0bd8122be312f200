"""Plain-torch oracles for the port's kernels, named as in
``repro/kernels/ref.py``; ``score_backend="reference"`` routes here."""
from __future__ import annotations

import torch

from repro_torch.kernels.scored_reduce import scored_reduce_plain


def mha_reference(q, k, v, *, causal=True, scale=None):
    """q (B, H, S, D); k (B, Hkv, S, D); v (B, Hkv, S, Dv) -> (B, H, S,
    Dv): repeated kv heads, f32 logits, -inf mask, softmax, cast to q's
    dtype."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    if Hkv != H:
        k = torch.repeat_interleave(k, H // Hkv, dim=1)
        v = torch.repeat_interleave(v, H // Hkv, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", probs, v.float())
    return out.to(q.dtype)

#: d (U, N); mean (N,) -> (dots, norms_sq, mean_sq), in f32.
scored_reduce_reference = scored_reduce_plain


def osafl_scores_reference(d: torch.Tensor, chi: float = 1.0) -> torch.Tensor:
    mean = torch.mean(d.float(), dim=0)
    dots, norms, msq = scored_reduce_reference(d, mean)
    cos = dots / torch.clamp(torch.sqrt(norms) * torch.sqrt(msq), min=1e-12)
    return (chi + cos) / (chi + 1.0)
