"""Grouped-query attention, multi-head latent attention and
cross-attention (``repro/models/attention.py``): optional qkv bias and
sliding window, prefill and single-step decode over an explicit KV cache;
MLA's naive prefill and absorbed decode over a latent cache; full
attention over an encoder's or a vision tower's memory.

Cache layout (full attention): {"k": (B, L, n_kv, hd), "v": (B, L, n_kv, hd)}
with the write position passed separately. Sliding-window caches are ring
buffers of length ``window``. Unlike the reference, whose arrays are
immutable, decode writes the new key and value into the cache in place and
returns the same cache: a functional copy would move the whole cache every
step.

Every causal, unwindowed attention whose query and key lengths agree
(prefill and the training forward) goes through ``kernels.ops.
flash_attention``: the CUDA kernel on the card, its plain version on the
CPU. That is the reference with ``REPRO_USE_FLASH=1``; the port has no such
switch. Decode over the cache, windowed and non-causal attention (whisper's
encoder) and cross-attention take ``_sdpa``, plain torch ops at the
reference's rounding points, as the reference does: its flash kernel takes
neither a query length unlike the key length nor a length off its blocks.

MLA's prefill attention has a q/k head dim of ``qk_nope + qk_rope`` (192)
and a v head dim of ``v_head_dim`` (128). The flash kernel takes the two
head dims as they are: v goes in at its 128 columns and the output comes
out at them, with nothing padded or sliced (on the card, bf16 runs the
Hopper kernel's (192, 128) instantiation). The latent cache holds
``c`` (B, L, kv_lora_rank) and the shared rope key (B, L, qk_rope); decode
writes both in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense_init,
                                       init_rmsnorm, rmsnorm)


def _sdpa(q, k, v, mask, scale):
    """q: (B,S,H,D) k/v: (B,L,Hkv,D) mask: broadcastable (B,1,S,L) or None.
    Logits in q's dtype, softmax in f32, probabilities back in q's dtype, as
    the reference rounds. Each kv head serves its group of query heads by
    broadcasting, so the repeated heads are never built. Operands of two
    dtypes (cross-attention over a memory wider than the model's compute
    dtype) meet in the wider one, as ``jnp.einsum`` promotes them."""
    B, S, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    qk = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(B, S, Hkv, H // Hkv, D).to(qk)
    logits = torch.einsum("bsngd,btnd->bngst", qg, k.to(qk)) * scale
    logits = logits.reshape(B, H, S, L)
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    pv = torch.promote_types(q.dtype, v.dtype)
    probs = probs.reshape(B, Hkv, H // Hkv, S, L).to(pv)
    return torch.einsum("bngst,btnd->bsngd", probs, v.to(pv)).reshape(
        B, S, H, D)


def causal_mask(s_q: int, s_k: int, q_offset=0, window: int = 0,
                device=None):
    """(1,1,S,L) boolean mask; window>0 limits lookback (sliding window)."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m = m & (qi - kj < window)
    return m[None, None]


def _attention(q, k, v, mask, scale, *, causal_full: bool):
    """The flash kernel for causal, unwindowed self-attention; else _sdpa."""
    if causal_full and q.shape[1] == k.shape[1]:
        return ops.flash_attention(q, k, v, causal=True, scale=scale)
    return _sdpa(q, k, v, mask, scale)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def init_gqa(gen, cfg: ModelConfig, dtype=torch.float32, lead: tuple = ()):
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    p = {"wq": dense_init(gen, (*lead, d, H * hd), dtype=dtype),
         "wk": dense_init(gen, (*lead, d, Hkv * hd), dtype=dtype),
         "wv": dense_init(gen, (*lead, d, Hkv * hd), dtype=dtype),
         "wo": dense_init(gen, (*lead, H * hd, d), dtype=dtype)}
    if cfg.qkv_bias:
        device = "meta" if gen is None else gen.device
        for name, width in (("bq", H * hd), ("bk", Hkv * hd),
                            ("bv", Hkv * hd)):
            p[name] = torch.zeros((*lead, width), dtype=dtype, device=device)
    return p


def tp_split(cfg: ModelConfig, M: int) -> tuple:
    """``(q, kv, heads)`` of GQA over M model columns, by the rules of
    ``launch/sharding.py``: whether ``wq`` (and ``bq``, ``wo``'s rows) and
    ``wk``/``wv`` (and their biases) are split (their widths divide by
    M), and whether the split falls on whole heads (H and Hkv divide by
    M), so that each column runs its own H / M query heads over its Hkv /
    M kv heads."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = M > 1 and (H * hd) % M == 0
    kv = M > 1 and (Hkv * hd) % M == 0
    return q, kv, q and kv and H % M == 0 and Hkv % M == 0


def gqa_fwd(params, x, cfg: ModelConfig, positions, *, cache=None,
            cache_pos=None, causal: bool = True, rope: bool = True,
            tp=None):
    """x: (B,S,d). Training/prefill when cache is None; else single-step
    decode (S==1) writing into the cache at ``cache_pos`` (an int).

    ``tp`` (a ``core/shmap.ModelAxis``): the projections split as
    ``tp_split`` says, each split one computing this column's output
    columns. On whole heads each column attends with its own query and kv
    heads (flash on the local heads; the cache holds the local kv heads)
    and feeds ``wo``'s rows of them, and the partial outputs are
    model-summed. Where a split falls inside a head, the split
    projections' columns are gathered, every column attends with every
    head (the cache holds every kv head) and feeds its part of the heads'
    output to its rows of ``wo``.

    Returns (y, cache)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    q_split, kv_split, local = tp_split(cfg, 1 if tp is None else tp.size)
    x_in = tp.copy_in(x) if q_split or kv_split else x

    def project(w, b, split):
        y = (x_in if split else x) @ params[w].to(dt)
        if cfg.qkv_bias:
            y = y + params[b].to(dt)
        return tp.gather(y) if split and not local else y
    q = project("wq", "bq", q_split)
    k = project("wk", "bk", kv_split)
    v = project("wv", "bv", kv_split)
    if local:
        H, Hkv = H // tp.size, Hkv // tp.size
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    scale = hd ** -0.5
    window = cfg.sliding_window

    if cache is None:
        mask = (causal_mask(S, S, window=window, device=x.device)
                if causal else None)
        o = _attention(q, k, v, mask, scale,
                       causal_full=causal and window == 0)
    else:
        if S != 1:
            raise ValueError(f"decode takes one token per step, got S={S}")
        pos = int(cache_pos)
        L = cache["k"].shape[1]
        slot = pos % L if window > 0 else pos     # ring buffer (L == window)
        if not 0 <= slot < L:
            raise IndexError(f"cache position {pos} is outside the cache "
                             f"of length {L}")
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        idx = torch.arange(L, device=x.device)
        if window > 0:
            abs_pos = pos - torch.remainder(slot - idx, L)
            valid = (abs_pos >= 0) & (abs_pos <= pos)
        else:
            valid = idx <= pos
        o = _sdpa(q, cache["k"].to(dt), cache["v"].to(dt),
                  valid[None, None, None, :], scale)
    o = o.reshape(B, S, H * hd)
    if not q_split:
        return o @ params["wo"].to(dt), cache
    if not local:
        o = tp.split(o)
    return tp.reduce_out(o @ params["wo"].to(dt)), cache


def init_gqa_cache(cfg: ModelConfig, batch: int, length: int,
                   dtype=torch.bfloat16, device=None, lead: tuple = (),
                   model_parallel: int = 1):
    """Zeroed k and v caches; over ``model_parallel`` columns each holds
    its local kv heads where ``tp_split`` puts whole heads on it."""
    L = min(length, cfg.sliding_window) if cfg.sliding_window else length
    n_kv = cfg.n_kv_heads
    if tp_split(cfg, model_parallel)[2]:
        n_kv //= model_parallel
    shape = (*lead, batch, L, n_kv, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Cross-attention (the vision decoder's image layers, whisper's decoder)
# ---------------------------------------------------------------------------

def init_cross_attn(gen, cfg: ModelConfig, d_memory: int,
                    dtype=torch.float32, lead: tuple = ()):
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    return {"wq": dense_init(gen, (*lead, d, H * hd), dtype=dtype),
            "wk": dense_init(gen, (*lead, d_memory, Hkv * hd), dtype=dtype),
            "wv": dense_init(gen, (*lead, d_memory, Hkv * hd), dtype=dtype),
            "wo": dense_init(gen, (*lead, H * hd, d), dtype=dtype)}


def _promoted_matmul(a, w, dt):
    """``a @ w.astype(dt)`` as ``jnp`` computes it: the weight rounded to
    ``dt`` first, then both operands in the wider of their dtypes."""
    w = w.to(dt)
    ct = torch.promote_types(a.dtype, dt)
    return a.to(ct) @ w.to(ct)


def cross_attn_fwd(params, x, memory, cfg: ModelConfig, tp=None):
    """x: (B,S,d); memory: (B,M,d_mem). Full (non-causal) attention over
    the memory through ``_sdpa``, with no mask; S and M may differ. A memory
    in a wider dtype than x's (f32 frames or patches into a bf16 model)
    makes k, v and the output that dtype, as in the reference.

    ``tp`` (a ``core/shmap.ModelAxis``; the memory whole on every column):
    ``wq``/``wk``/``wv`` column-split and ``wo`` row-split as ``tp_split``
    says, as in ``gqa_fwd``; x and the memory cross into the model region
    (``copy_in``) ahead of the split projections. On whole heads each
    column attends with its own query and kv heads and feeds ``wo``'s rows
    of them; where a split falls inside a head, the projections' columns
    are gathered, every column attends with every head and feeds its part
    of the output; the partial outputs are model-summed."""
    B, S, _ = x.shape
    M = memory.shape[1]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    q_split, kv_split, local = tp_split(cfg, 1 if tp is None else tp.size)
    if q_split:
        x = tp.copy_in(x)
    if kv_split:
        memory = tp.copy_in(memory)

    def whole(y, split):
        return tp.gather(y) if split and not local else y
    q = whole(x @ params["wq"].to(dt), q_split)
    k = whole(_promoted_matmul(memory, params["wk"], dt), kv_split)
    v = whole(_promoted_matmul(memory, params["wv"], dt), kv_split)
    if local:
        H, Hkv = H // tp.size, Hkv // tp.size
    o = _sdpa(q.reshape(B, S, H, hd), k.reshape(B, M, Hkv, hd),
              v.reshape(B, M, Hkv, hd), None, hd ** -0.5)
    o = o.reshape(B, S, H * hd)
    if not q_split:
        return _promoted_matmul(o, params["wo"], dt)
    if not local:
        o = tp.split(o)
    return tp.reduce_out(_promoted_matmul(o, params["wo"], dt))


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V3)
# ---------------------------------------------------------------------------

def init_mla(gen, cfg: ModelConfig, dtype=torch.float32, lead: tuple = ()):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": dense_init(gen, (*lead, d, m.q_lora_rank), dtype=dtype),
        "q_norm": init_rmsnorm(gen, m.q_lora_rank, dtype, lead),
        "wq_b": dense_init(gen, (*lead, m.q_lora_rank, H * qk), dtype=dtype),
        "wkv_a": dense_init(gen, (*lead, d, m.kv_lora_rank
                                  + m.qk_rope_head_dim), dtype=dtype),
        "kv_norm": init_rmsnorm(gen, m.kv_lora_rank, dtype, lead),
        "wkv_b": dense_init(gen, (*lead, m.kv_lora_rank,
                                  H * (m.qk_nope_head_dim + m.v_head_dim)),
                            dtype=dtype),
        "wo": dense_init(gen, (*lead, H * m.v_head_dim, d), dtype=dtype),
    }


def mla_tp_split(cfg: ModelConfig, M: int) -> tuple:
    """``(q, kv, o, heads)`` of MLA over M model columns, by the rules of
    ``launch/sharding.py``: whether ``wq_b``'s and ``wkv_b``'s columns and
    ``wo``'s rows are split (their widths divide by M), and whether the
    split falls on whole heads (H divides by M), so that each column runs
    its own H / M heads. ``wq_a``, ``wkv_a`` and the norms stay whole."""
    m = cfg.mla
    H = cfg.n_heads
    q = M > 1 and (H * (m.qk_nope_head_dim + m.qk_rope_head_dim)) % M == 0
    kv = M > 1 and (H * (m.qk_nope_head_dim + m.v_head_dim)) % M == 0
    o = M > 1 and (H * m.v_head_dim) % M == 0
    return q, kv, o, M > 1 and H % M == 0


def _mla_qkv(params, x, cfg: ModelConfig, positions, tp=None):
    """q's nope and rope parts, the normed latent and the rope key.
    ``tp``: the heads split whole, ``wq_b`` holding this column's heads;
    the whole low-rank outputs cross into the model region here, after
    their norms."""
    m = cfg.mla
    B, S, _ = x.shape
    dt = x.dtype
    H = cfg.n_heads if tp is None else cfg.n_heads // tp.size
    q = rmsnorm(params["q_norm"], x @ params["wq_a"].to(dt), cfg.norm_eps)
    if tp is not None:
        q = tp.copy_in(q)
    q = (q @ params["wq_b"].to(dt)).reshape(
        B, S, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv = x @ params["wkv_a"].to(dt)
    c_kv, k_rope = kv.split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    c_kv = rmsnorm(params["kv_norm"], c_kv, cfg.norm_eps)        # (B,S,rank)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)                          # (B,S,1,r)
    if tp is not None:
        c_kv, k_rope = tp.copy_in(c_kv), tp.copy_in(k_rope)
    return q_nope, q_rope, c_kv, k_rope


def _whole_mla(params, tp, splits: tuple) -> dict:
    """The MLA leaves with ``wq_b``/``wkv_b``'s columns and ``wo``'s rows
    gathered where they are split (each column's gradient back as its
    own part): a split inside a head runs whole on every column."""
    params = dict(params)
    for (name, dim), split in zip((("wq_b", -1), ("wkv_b", -1), ("wo", 0)),
                                  splits):
        if split:
            params[name] = tp.gather(params[name], dim=dim)
    return params


def mla_fwd(params, x, cfg: ModelConfig, positions, *, cache=None,
            cache_pos=None, tp=None):
    """MLA attention. Prefill/train: naive expansion through the flash
    kernel, q and k at ``qk_nope + qk_rope`` and v at ``v_head_dim``.
    Decode (S == 1, ``cache_pos`` an int): absorbed form over the latent
    cache {"c": (B, L, rank), "k_rope": (B, L, r)}, written in place.

    ``tp`` (a ``core/shmap.ModelAxis``): ``wq_b``/``wkv_b`` column-split
    and ``wo`` row-split as ``mla_tp_split`` says; ``wq_a``, ``wkv_a``,
    the norms and the latent cache are whole on every column. On whole
    heads each column runs its own H / M heads (flash on them in prefill,
    the absorbed decode over the whole latent cache) and feeds ``wo``'s
    rows of them, and the partial outputs are model-summed; ``q`` after
    ``q_norm``, ``c_kv`` and ``k_rope`` cross into the model region
    (``copy_in``), so ``wq_a``, ``wkv_a`` and the norms receive the whole
    gradient, the same on every column. Where a split falls inside a
    head, the split leaves are gathered and every column runs the whole
    attention.
    Returns (y, cache)."""
    splits = mla_tp_split(cfg, 1 if tp is None else tp.size)
    if tp is not None and not splits[3]:
        params, tp = _whole_mla(params, tp, splits[:3]), None
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads if tp is None else cfg.n_heads // tp.size
    dt = x.dtype
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, cfg, positions, tp)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    wkv_b = params["wkv_b"].to(dt).reshape(
        m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim)
    w_k = wkv_b[:, :, :m.qk_nope_head_dim]                       # (rank,H,dk)
    w_v = wkv_b[:, :, m.qk_nope_head_dim:]                       # (rank,H,dv)

    if cache is None:
        k_nope = torch.einsum("bsr,rhd->bshd", c_kv, w_k)
        v = torch.einsum("bsr,rhd->bshd", c_kv, w_v)
        k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)],
                      dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        o = ops.flash_attention(q, k, v, causal=True, scale=scale)
    else:
        if S != 1:
            raise ValueError(f"decode takes one token per step, got S={S}")
        pos = int(cache_pos)
        L = cache["c"].shape[1]
        if not 0 <= pos < L:
            raise IndexError(f"cache position {pos} is outside the cache "
                             f"of length {L}")
        cache["c"][:, pos] = c_kv[:, 0].to(cache["c"].dtype)
        cache["k_rope"][:, pos] = k_rope[:, 0, 0].to(cache["k_rope"].dtype)
        c, r = cache["c"].to(dt), cache["k_rope"].to(dt)
        # absorbed: scores = (q_nope W_k^T) c^T + q_rope k_rope^T
        q_abs = torch.einsum("bshd,rhd->bshr", q_nope, w_k)     # (B,1,H,rank)
        logits = (torch.einsum("bshr,btr->bhst", q_abs, c)
                  + torch.einsum("bshd,btd->bhst", q_rope, r)) * scale
        valid = torch.arange(L, device=x.device) <= pos
        logits = torch.where(valid[None, None, None, :], logits,
                             torch.finfo(logits.dtype).min)
        probs = torch.softmax(logits.float(), dim=-1).to(dt)
        o_lat = torch.einsum("bhst,btr->bshr", probs, c)
        o = torch.einsum("bshr,rhd->bshd", o_lat, w_v)          # (B,1,H,dv)
    y = o.reshape(B, S, H * m.v_head_dim) @ params["wo"].to(dt)
    return (y if tp is None else tp.reduce_out(y)), cache


def init_mla_cache(cfg: ModelConfig, batch: int, length: int,
                   dtype=torch.bfloat16, device=None, lead: tuple = ()):
    m = cfg.mla
    return {"c": torch.zeros((*lead, batch, length, m.kv_lora_rank),
                             dtype=dtype, device=device),
            "k_rope": torch.zeros((*lead, batch, length, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
