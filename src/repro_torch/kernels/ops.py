"""Public wrappers around the port's kernels, named as in
``repro/kernels/ops.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
    q (B, S, H, D), k (B, S, Hkv, D), v (B, S, Hkv, Dv) -> (out (B, S, H,
    Dv), lse (B, H, S)); lse is not differentiable.

    The backward kernels take one head dim. So on CUDA tensors with Dv < D
    (MLA's training forward) the backward zero-pads v, out and dout to D,
    runs them, and keeps dv's first Dv columns: a route chosen by shape,
    not a fallback. The zero columns change nothing else: o's are zero,
    so rowsum(do o) and do v^T are those of the unpadded tensors. CPU
    tensors take the plain backward at Dv as they are."""

    @staticmethod
    def forward(q, k, v, causal, scale):
        B, S, H, _ = q.shape
        out = q.new_empty((B, S, H, v.shape[-1]))
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
        dout = dout.contiguous()
        D, Dv = q.shape[-1], v.shape[-1]
        pad = q.device.type == "cuda" and Dv < D
        if pad:         # one head dim for the kernels (the class docstring)
            v, out, dout = (F.pad(x, (0, D - Dv)) for x in (v, out, dout))
        dq, dk, dv = (torch.empty_like(x, memory_format=torch.contiguous_format)
                      for x in (q, k, v))
        flash_attention_bwd(_bhsd(q), _bhsd(k), _bhsd(v), _bhsd(out), lse,
                            _bhsd(dout), causal=ctx.causal,
                            scale=ctx.scale, dq=_bhsd(dq), dk=_bhsd(dk),
                            dv=_bhsd(dv))
        return dq, dk, dv[..., :Dv] if pad else dv, None, None


def flash_attention(q, k, v, *, causal=True, scale=None):
    """Model-layout wrapper: q (B, S, H, D), k (B, S, Hkv, D), v (B, S,
    Hkv, Dv) -> (B, S, H, Dv), Dv <= D (MLA passes v at its own head dim).
    The kernels read and write the transposed (B, H, S, D) views through
    their strides, so nothing is copied. Where a gradient may be asked
    (grad mode on and an input that requires one) the call goes through
    ``FlashAttention``, which also keeps what the backward needs; else the
    forward kernel alone runs, with no log-sum-exp (serving)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale)[0]
    out = q.new_empty((*q.shape[:3], v.shape[-1]))
    flash_attention_bhsd(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal,
                         scale=scale, out=_bhsd(out))
    return out


def osafl_scores(d_stacked: torch.Tensor, chi: float = 1.0) -> torch.Tensor:
    """OSAFL scores of stacked updates d_stacked (U, N)."""
    return osafl_scores_fused(d_stacked, chi)


def fused_scored_reduce(d_stacked: torch.Tensor, mean: torch.Tensor):
    return scored_reduce(d_stacked, mean)
