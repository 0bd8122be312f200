"""Public wrappers around the port's kernels, named as in
``repro/kernels/ops.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (_math_dtype,
                                                 flash_attention_bhsd,
                                                 flash_attention_bwd)
from repro_torch.kernels.scored_reduce import osafl_scores_fused, scored_reduce


def _bhsd(x: torch.Tensor) -> torch.Tensor:
    """A (B, S, H, D) tensor as the (B, H, S, D) view the kernels read."""
    return x.transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel, which also
    writes the rows' log-sum-exp, and the backward kernels (their plain
    versions for CPU tensors). In the ``setup_context`` form, so
    ``torch.func.grad`` takes it as ``.backward()`` does. Model layout:
    q (B, S, H, D), k/v (B, S, Hkv, D) -> (out (B, S, H, D), lse (B, H,
    S)); lse is not differentiable."""

    @staticmethod
    def forward(q, k, v, causal, scale):
        B, S, H, _ = q.shape
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        lse = torch.empty((B, H, S), dtype=_math_dtype(q), device=q.device)
        flash_attention_bhsd(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal,
                             scale=scale, out=_bhsd(out), lse=lse)
        return out, lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, scale = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = (torch.empty_like(x, memory_format=torch.contiguous_format)
                      for x in (q, k, v))
        flash_attention_bwd(_bhsd(q), _bhsd(k), _bhsd(v), _bhsd(out), lse,
                            _bhsd(dout.contiguous()), causal=ctx.causal,
                            scale=ctx.scale, dq=_bhsd(dq), dk=_bhsd(dk),
                            dv=_bhsd(dv))
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, scale=None):
    """Model-layout wrapper: q (B, S, H, D), k/v (B, S, Hkv, D) -> (B, S, H, D).
    The kernels read and write the transposed (B, H, S, D) views through
    their strides, so nothing is copied. Where a gradient may be asked
    (grad mode on and an input that requires one) the call goes through
    ``FlashAttention``, which also keeps what the backward needs; else the
    forward kernel alone runs, with no log-sum-exp (serving)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale)[0]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_attention_bhsd(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal,
                         scale=scale, out=_bhsd(out))
    return out


def osafl_scores(d_stacked: torch.Tensor, chi: float = 1.0) -> torch.Tensor:
    """OSAFL scores of stacked updates d_stacked (U, N)."""
    return osafl_scores_fused(d_stacked, chi)


def fused_scored_reduce(d_stacked: torch.Tensor, mean: torch.Tensor):
    return scored_reduce(d_stacked, mean)
