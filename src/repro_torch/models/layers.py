"""Shared building blocks of the transformer zoo (``repro/models/layers.py``):
plain functions on tensors over dict parameter trees in the reference's
layout. Each function computes in the dtype and at the rounding points the
reference does (norms and RoPE in f32 inside, cast back).

Init draws from an explicit ``torch.Generator`` and puts the tensor on the
generator's device. It cannot reproduce the reference's threefry numbers,
so parity tests import the reference's weights instead
(``repro_torch.models.transformer.params_from_numpy``). ``gen=None`` gives
meta tensors: the layout without the numbers, which ``params_from_numpy``
checks an imported tree against.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


# the largest f32 draw behind a narrower leaf (bytes): a larger leaf is
# drawn a block of leading indices at a time into its own storage. A bf16
# expert stack of arctic-480b at two layers, (2, 128, 7168, 4864), is 17.8
# GB; drawn whole, its f32 draw would add 35.7 GB beside it
DRAW_LIMIT = 1 << 30


_KEEP = contextvars.ContextVar("keep_drawn", default=None)


@contextlib.contextmanager
def keep_drawn(fn):
    """While open (in this thread or task), each leaf ``dense_init`` makes
    (a meta tensor too) is passed to ``fn`` and replaced by what ``fn``
    returns, as soon as it is made: a caller keeps a part of each leaf and
    the whole leaf is freed before the next is drawn
    (``launch/sharding.init_shards``)."""
    token = _KEEP.set(fn)
    try:
        yield
    finally:
        _KEEP.reset(token)


def dense_init(gen, shape, scale: float = 0.02, dtype=torch.float32):
    """``scale`` * N(0, 1) of ``shape`` on ``gen``'s device. A float32
    leaf, or one whose f32 draw is at most ``DRAW_LIMIT`` bytes, is one
    draw (so the numbers of every f32 config stay as they were); a larger
    leaf of a narrower dtype is drawn in blocks straight into the result."""
    if gen is None:
        out = torch.empty(shape, dtype=dtype, device="meta")
    elif dtype == torch.float32 or math.prod(shape) * 4 <= DRAW_LIMIT:
        x = torch.randn(shape, generator=gen, device=gen.device)
        out = x.mul_(scale).to(dtype)
        del x                       # the f32 draw freed before a keep cuts
    else:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        _draw_into(out, gen, scale)
    keep = _KEEP.get()
    return out if keep is None else keep(out)


def _draw_into(out, gen, scale: float) -> None:
    if out.numel() * 4 <= DRAW_LIMIT:
        x = torch.randn(out.shape, generator=gen, device=gen.device)
        out.copy_(x.mul_(scale))
    elif out.shape[0] == 1:
        _draw_into(out[0], gen, scale)
    else:
        for part in out.split(max(1, DRAW_LIMIT // (4 * out[0].numel()))):
            _draw_into(part, gen, scale)


def _full(gen, shape, value: float, dtype):
    device = "meta" if gen is None else gen.device
    return torch.full(shape, value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(gen, d: int, dtype=torch.float32, lead: tuple = ()):
    return {"scale": _full(gen, (*lead, d), 1.0, dtype)}


def rmsnorm(params, x, eps: float = 1e-5, tp=None):
    """RMS norm over the last dimension. ``tp`` (a ``core/shmap.
    ModelAxis``): ``x`` is this column's equal part of the normed width
    (its heads' channels); the mean square is the columns' sums of
    squares model-summed over the whole width (``copy_in`` after
    ``reduce_out``: each column uses the sum for its own part, so its
    gradient is summed too), and the whole ``scale`` leaf is cut to this
    column's part (``split``, so its gradient is whole on every
    column)."""
    dtype = x.dtype
    x = x.float()
    if tp is None:
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        scale = params["scale"]
    else:
        ss = torch.sum(torch.square(x), dim=-1, keepdim=True)
        var = tp.copy_in(tp.reduce_out(ss)) / (x.shape[-1] * tp.size)
        scale = tp.split(params["scale"])
    y = x * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


def init_layernorm(gen, d: int, dtype=torch.float32, lead: tuple = ()):
    return {"scale": _full(gen, (*lead, d), 1.0, dtype),
            "bias": _full(gen, (*lead, d), 0.0, dtype)}


def layernorm(params, x, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., seq, n_heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (hd/2,)
    angles = positions[..., :, None].float() * freqs            # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                    # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, d_ff: int | None = None,
             dtype=torch.float32, lead: tuple = ()):
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    params = {"w_up": dense_init(gen, (*lead, d, f), dtype=dtype),
              "w_down": dense_init(gen, (*lead, f, d), dtype=dtype)}
    if cfg.mlp == "swiglu":
        params["w_gate"] = dense_init(gen, (*lead, d, f), dtype=dtype)
    return params


def mlp_fwd(params, x, kind: str, tp=None):
    """The MLP on ``x``. ``tp`` (a ``core/shmap.ModelAxis``, given where
    the rules split d_ff over the model axis): ``w_up`` and ``w_gate``
    hold this column's d_ff columns and ``w_down`` its rows; the partial
    outputs are model-summed."""
    dtype = x.dtype
    if tp is not None:
        x = tp.copy_in(x)
    up = x @ params["w_up"].to(dtype)
    if kind == "swiglu":
        h = F.silu(x @ params["w_gate"].to(dtype)) * up
    elif kind == "relu2":                     # nemotron squared-ReLU
        h = torch.square(torch.relu(up))
    elif kind == "gelu":                      # jax.nn.gelu's default: tanh
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    out = h @ params["w_down"].to(dtype)
    return out if tp is None else tp.reduce_out(out)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen, vocab: int, d: int, dtype=torch.float32):
    return {"table": dense_init(gen, (vocab, d), dtype=dtype)}


def embed(params, tokens, compute_dtype, tp=None):
    """The tokens' rows of the table in ``compute_dtype``. ``tp`` (where
    the rules split d_model over the model axis): the table holds this
    column's d_model columns, and the columns' rows are gathered."""
    # gather, then cast: the reference's cast-then-gather rounds each value
    # the same way without converting the whole table
    x = params["table"][tokens].to(compute_dtype)
    return x if tp is None else tp.gather(x)


def unembed(params, x, tp=None):
    """Tied logits ``x @ table.T``. ``tp`` (a d_model-split table): each
    column's partial product over its d_model columns, model-summed into
    the whole vocabulary's logits on every column."""
    if tp is None:
        return x @ params["table"].to(x.dtype).T
    return tp.reduce_out(tp.split(x) @ params["table"].to(x.dtype).T)
