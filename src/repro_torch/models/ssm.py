"""State-space and recurrent blocks (``repro/models/ssm.py``): Mamba2
(chunked SSD) and xLSTM's mLSTM (matrix memory) and sLSTM (scalar memory),
each with its prefill forward, its state cache and its one-token decode.

Each function computes in the dtype and at the rounding points the
reference does: the compute dtype for the projections, f32 for the decays,
gates and states, and the reference's casts between them. Where
``jnp.einsum`` promotes a bf16 operand against an f32 one (the sLSTM's f32
state against its bf16 recurrent weights), the operand is cast to f32 here,
since ``torch.einsum`` takes one dtype.

Mamba2's chunked SSD runs the reference's ``lax.scan`` over chunks as
batched products over all chunks at once: each chunk's intra-chunk output
and its state input, then the (B, H, 64, N) f32 state recurrence alone as a
loop over the chunks, then each chunk's output from its incoming state in
one batched product. The intra-chunk decays ``exp(seg_t - seg_s)`` are
masked in the exponent (to -inf) before ``exp``, which leaves the values
where ``s <= t`` as the reference's mask-after gives them. The sequence
length must be a multiple of the chunk size (``ValueError``; nothing is
padded).

mLSTM dispatches as the reference: the chunked form (carrying (C, n, m)
over chunks of Q = min(chunk_size, 256), the decode recurrence's running
max) when L >= 2Q and L % Q == 0, the quadratic form otherwise. The sLSTM
prefill is a loop over tokens: the recurrence is sequential.

The caches hold f32 states whatever the KV cache's dtype (the conv window
of Mamba2 in ``init_mamba_cache``'s ``dtype``, f32 by default; mLSTM's and
sLSTM's m starts at -1e9). Decode writes the new state into the cache in
place and returns the same cache, as the port's KV decode does.

``gen=None`` in the init functions gives meta tensors (the layout only);
``lead`` puts leading stack axes on every leaf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, init_rmsnorm, rmsnorm

HEAD_P = 64  # mamba2 head dim


def _fill(gen, lead: tuple, parts, dtype):
    """A vector of runs ``[(length, value), ...]``, with leading axes
    ``lead`` (the reference's concatenated gate biases)."""
    device = "meta" if gen is None else gen.device
    vec = torch.cat([torch.full((n,), v, dtype=dtype, device=device)
                     for n, v in parts])
    return vec.expand(*lead, -1).clone()


def _causal_conv(x, w, b):
    """x: (B, L, C); w: (K, C) depthwise causal conv, one rounding per
    product and per sum, in the reference's order."""
    K, L = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, :L] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + L] * w[i]
    return out + b


def _window_conv(window, w):
    """One decode step of the conv: window (B, K, C), w (K, C) -> (B, C),
    each output a dot over the K taps rounded once (the reference's
    ``einsum("bkc,kc->bc")``)."""
    return (window.float() * w.float()).sum(1).to(window.dtype)


def _tril(n: int, device) -> torch.Tensor:
    return torch.ones((n, n), dtype=torch.bool, device=device).tril()


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = max(1, d_inner // HEAD_P)
    d_inner = n_heads * HEAD_P
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim


def init_mamba(gen, cfg: ModelConfig, dtype=torch.float32, lead: tuple = ()):
    s = cfg.ssm
    d_inner, H, conv_dim = mamba_dims(cfg)
    d = cfg.d_model
    return {
        "in_proj": dense_init(
            gen, (*lead, d, 2 * d_inner + 2 * s.n_groups * s.d_state + H),
            dtype=dtype),
        "conv_w": dense_init(gen, (*lead, s.d_conv, conv_dim), scale=0.5,
                             dtype=dtype),
        "conv_b": _fill(gen, lead, [(conv_dim, 0.0)], dtype),
        "A_log": _fill(gen, lead, [(H, 0.0)], dtype),
        "D": _fill(gen, lead, [(H, 1.0)], dtype),
        "dt_bias": _fill(gen, lead, [(H, 0.0)], dtype),
        "norm": init_rmsnorm(gen, d_inner, dtype, lead),
        "out_proj": dense_init(gen, (*lead, d_inner, d), dtype=dtype),
    }


def _split_proj(cfg, proj):
    """(z, the conv's input [x | B | C], dt) of the input projection: the
    reference splits x, B and C apart and concatenates them again, and
    they lie side by side, so the conv's input is one slice."""
    d_inner, H, conv_dim = mamba_dims(cfg)
    return torch.split(proj, [d_inner, conv_dim, H], dim=-1)


def mamba_fwd(params, x, cfg: ModelConfig):
    """Chunked SSD. x: (B, L, d) -> (B, L, d); L a multiple of the chunk
    size."""
    s = cfg.ssm
    d_inner, H, _ = mamba_dims(cfg)
    N, G, Q, P = s.d_state, s.n_groups, s.chunk_size, HEAD_P
    B_, L, _ = x.shape
    if L % Q:
        raise ValueError(f"mamba_fwd: the sequence length {L} is not a "
                         f"multiple of the chunk size {Q}")
    dt_ = x.dtype
    proj = x @ params["in_proj"].to(dt_)
    z, conv_in, dt_raw = _split_proj(cfg, proj)
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"].to(dt_),
                                   params["conv_b"].to(dt_)))
    xi, Bm, Cm = torch.split(conv_out, [d_inner, G * N, G * N], dim=-1)
    xh = xi.reshape(B_, L, H, P)
    Bm = Bm.reshape(B_, L, G, N).mean(2)                       # (B, L, N)
    Cm = Cm.reshape(B_, L, G, N).mean(2)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())  # (B, L, H)
    A = -torch.exp(params["A_log"].float())                     # (H,)
    la = dt * A                                                 # log decay

    # chunk-major, heads ahead of positions: (B, nc, H, Q[, ...])
    nc = L // Q
    seg = torch.cumsum(la.reshape(B_, nc, Q, H), dim=2).transpose(2, 3)
    dtc = dt.reshape(B_, nc, Q, H).transpose(2, 3)
    xc = xh.reshape(B_, nc, Q, H, P).transpose(2, 3)            # (B,nc,H,Q,P)
    Bc = Bm.reshape(B_, nc, Q, N)[:, :, None]                   # (B,nc,1,Q,N)
    Cc = Cm.reshape(B_, nc, Q, N)[:, :, None]

    # intra-chunk: w[t, s] = (C_t . B_s) exp(seg_t - seg_s) dt_s, s <= t
    cb = (Cc @ Bc.transpose(-1, -2)).float()                    # (B,nc,1,Q,Q)
    dec = torch.exp((seg[..., :, None] - seg[..., None, :]).masked_fill_(
        ~_tril(Q, x.device), float("-inf")))                    # (B,nc,H,Q,Q)
    w = cb * dec * dtc[..., None, :]
    y_intra = w.to(dt_) @ xc                                    # (B,nc,H,Q,P)
    del cb, dec, w

    # each chunk's state input: sum_s exp(seg_Q - seg_s) dt_s B_s x_s
    decay_out = torch.exp(seg[..., -1:] - seg)                  # (B,nc,H,Q)
    h_in = (xc * (decay_out * dtc).to(dt_)[..., None]).transpose(-1, -2) @ Bc
    # the state entering each chunk: h <- exp(seg_Q) h + h_in, in f32
    decay = torch.exp(seg[..., -1])                             # (B,nc,H)
    h = torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
    h0 = []
    for c in range(nc):
        h0.append(h.to(dt_))
        h = decay[:, c, :, None, None] * h + h_in[:, c].float()
    h0 = torch.stack(h0, dim=1)                                 # (B,nc,H,P,N)
    y_state = ((Cc @ h0.transpose(-1, -2))
               * torch.exp(seg).to(dt_)[..., None])             # (B,nc,H,Q,P)

    y = (y_intra + y_state).transpose(2, 3).reshape(B_, L, H, P)
    y = y + params["D"].to(dt_)[:, None] * xh
    y = y.reshape(B_, L, d_inner)
    y = rmsnorm(params["norm"], y, cfg.norm_eps) * F.silu(z)
    return y @ params["out_proj"].to(dt_)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None, lead: tuple = ()):
    s = cfg.ssm
    _, H, conv_dim = mamba_dims(cfg)
    return {
        "conv": torch.zeros((*lead, batch, s.d_conv - 1, conv_dim),
                            dtype=dtype, device=device),
        "h": torch.zeros((*lead, batch, H, HEAD_P, s.d_state),
                         dtype=torch.float32, device=device),
    }


def mamba_decode_step(params, x, cache, cfg: ModelConfig):
    """x: (B, 1, d). O(1) decode; writes the conv window and the state into
    ``cache`` in place. Returns (y, cache)."""
    s = cfg.ssm
    d_inner, H, _ = mamba_dims(cfg)
    N, G = s.d_state, s.n_groups
    B_ = x.shape[0]
    dt_ = x.dtype
    proj = x @ params["in_proj"].to(dt_)
    z, conv_in, dt_raw = _split_proj(cfg, proj)                 # (B, 1, C)
    window = torch.cat([cache["conv"].to(dt_), conv_in], dim=1)
    conv_out = (_window_conv(window, params["conv_w"].to(dt_))
                + params["conv_b"].to(dt_))
    conv_out = F.silu(conv_out)[:, None, :]
    xi, Bm, Cm = torch.split(conv_out, [d_inner, G * N, G * N], dim=-1)
    xh = xi.reshape(B_, H, HEAD_P)
    Bv = Bm.reshape(B_, G, N).mean(1)
    Cv = Cm.reshape(B_, G, N).mean(1)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"].float())  # (B,H)
    A = -torch.exp(params["A_log"].float())
    a = torch.exp(dt * A)                                        # (B, H)
    h = cache["h"]
    h.mul_(a[:, :, None, None]).add_(
        (dt[:, :, None] * xh.float())[..., None] * Bv.float()[:, None, None])
    y = (h @ Cv.float()[:, None, :, None])[..., 0].to(dt_)      # (B, H, P)
    y = y + params["D"].to(dt_)[:, None] * xh
    y = y.reshape(B_, 1, d_inner)
    y = rmsnorm(params["norm"], y, cfg.norm_eps) * F.silu(z)
    y = y @ params["out_proj"].to(dt_)
    cache["conv"].copy_(window[:, 1:])
    return y, cache


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory)
# ---------------------------------------------------------------------------

def xlstm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = int(cfg.d_model * s.mlstm_proj_factor)
    H = cfg.n_heads
    return d_inner, H, d_inner // H


def init_mlstm(gen, cfg: ModelConfig, dtype=torch.float32, lead: tuple = ()):
    d = cfg.d_model
    d_inner, H, _ = xlstm_dims(cfg)
    return {
        "up_proj": dense_init(gen, (*lead, d, 2 * d_inner), dtype=dtype),
        "conv_w": dense_init(gen, (*lead, 4, d_inner), scale=0.5,
                             dtype=dtype),
        "conv_b": _fill(gen, lead, [(d_inner, 0.0)], dtype),
        "wq": dense_init(gen, (*lead, d_inner, d_inner), dtype=dtype),
        "wk": dense_init(gen, (*lead, d_inner, d_inner), dtype=dtype),
        "wv": dense_init(gen, (*lead, d_inner, d_inner), dtype=dtype),
        "w_gates": dense_init(gen, (*lead, d_inner, 2 * H), dtype=dtype),
        "gate_bias": _fill(gen, lead, [(H, 0.0), (H, 3.0)], dtype),
        "norm": init_rmsnorm(gen, d_inner, dtype, lead),
        "down_proj": dense_init(gen, (*lead, d_inner, d), dtype=dtype),
    }


def mlstm_fwd(params, x, cfg: ModelConfig):
    """mLSTM forward. The chunkwise form for long sequences (linear memory
    in L), the quadratic parallel form otherwise. x: (B, L, d)."""
    Q = min(cfg.ssm.chunk_size, 256)
    if x.shape[1] >= 2 * Q and x.shape[1] % Q == 0:
        return mlstm_fwd_chunked(params, x, cfg)
    return _mlstm_fwd_quadratic(params, x, cfg)


def _mlstm_inputs(params, x, cfg: ModelConfig):
    """The projections both forms share: z (B, L, di); q, k, v (B, L, H,
    P) in the compute dtype; the f32 input gate and log forget gate (B, L,
    H)."""
    _, H, P = xlstm_dims(cfg)
    B_, L, _ = x.shape
    dt_ = x.dtype
    up = x @ params["up_proj"].to(dt_)
    xi, z = torch.chunk(up, 2, dim=-1)
    xc = F.silu(_causal_conv(xi, params["conv_w"].to(dt_),
                             params["conv_b"].to(dt_)))
    q = (xc @ params["wq"].to(dt_)).reshape(B_, L, H, P)
    k = (xc @ params["wk"].to(dt_)).reshape(B_, L, H, P) / (P ** 0.5)
    v = (xi @ params["wv"].to(dt_)).reshape(B_, L, H, P)
    gates = ((xi @ params["w_gates"].to(dt_)).float()
             + params["gate_bias"].float())
    ig, fg = torch.chunk(gates, 2, dim=-1)                      # (B, L, H)
    return z, q, k, v, ig, F.logsigmoid(fg)


def _mlstm_out(params, h, z, cfg):
    h = rmsnorm(params["norm"], h, cfg.norm_eps) * F.silu(z)
    return h @ params["down_proj"].to(h.dtype)


def _mlstm_fwd_quadratic(params, x, cfg: ModelConfig):
    """Parallel (quadratic) mLSTM forward. x: (B, L, d)."""
    d_inner = xlstm_dims(cfg)[0]
    B_, L, _ = x.shape
    dt_ = x.dtype
    z, q, k, v, ig, logf = _mlstm_inputs(params, x, cfg)
    cumf = torch.cumsum(logf, dim=1)
    # D[t, s] = cumf_t - cumf_s + i_s  (s <= t)
    Dm = cumf[:, :, None, :] - cumf[:, None, :, :] + ig[:, None, :, :]
    Dm = Dm.masked_fill(~_tril(L, x.device)[None, :, :, None],
                        float("-inf"))                          # (B,T,S,H)
    m = torch.amax(Dm, dim=2, keepdim=True)                     # (B,T,1,H)
    w = torch.exp(Dm - m)
    scores = torch.einsum("bthp,bshp->btsh", q, k).float() * w
    norm = torch.maximum(scores.sum(2, keepdim=True).abs(), torch.exp(-m))
    scores = (scores / norm).to(dt_)
    h = torch.einsum("btsh,bshp->bthp", scores, v).reshape(B_, L, d_inner)
    return _mlstm_out(params, h, z, cfg)


def mlstm_fwd_chunked(params, x, cfg: ModelConfig):
    """Chunkwise-stabilized mLSTM: the matrix memory (C, n, m) carried
    across chunks of length Q, (B, Q, Q, H) blocks within one. Position
    tau combines the inter-chunk term exp(F_tau + m - M) (C q) with the
    intra-chunk terms under the running max M = max(F_tau + m,
    max_s D[tau, s]); the chunk-end update mirrors the decode recurrence."""
    d_inner, H, P = xlstm_dims(cfg)
    Q = min(cfg.ssm.chunk_size, 256)
    B_, L, _ = x.shape
    dt_ = x.dtype
    z, q, k, v, ig, logf = _mlstm_inputs(params, x, cfg)
    nc = L // Q
    if nc * Q != L:
        raise ValueError(f"mlstm_fwd_chunked: the sequence length {L} is "
                         f"not a multiple of the chunk size {Q}")
    qc, kc, vc = (t.reshape(B_, nc, Q, H, P).float() for t in (q, k, v))
    ic = ig.reshape(B_, nc, Q, H)
    fc = logf.reshape(B_, nc, Q, H)
    tri = _tril(Q, x.device)[None, :, :, None]

    C = torch.zeros((B_, H, P, P), dtype=torch.float32, device=x.device)
    n = torch.zeros((B_, H, P), dtype=torch.float32, device=x.device)
    m = torch.full((B_, H), -1e9, dtype=torch.float32, device=x.device)
    hs = []
    for c in range(nc):
        qq, kk, vv, ii = qc[:, c], kc[:, c], vc[:, c], ic[:, c]
        Fc = torch.cumsum(fc[:, c], dim=1)                      # (B, Q, H)
        D = Fc[:, :, None, :] - Fc[:, None, :, :] + ii[:, None, :, :]
        D = D.masked_fill(~tri, float("-inf"))
        m_intra = torch.amax(D, dim=2)                          # (B, Q, H)
        m_inter = Fc + m[:, None, :]
        M = torch.maximum(m_intra, m_inter)
        w = torch.exp(D - M[:, :, None, :])                     # (B,Q,S,H)
        scores = torch.einsum("bthp,bshp->btsh", qq, kk) * w
        inter_scale = torch.exp(m_inter - M)                    # (B, Q, H)
        num_inter = (torch.einsum("bhpq,bthq->bthp", C, qq)
                     * inter_scale[..., None])
        num = torch.einsum("btsh,bshp->bthp", scores, vv) + num_inter
        den = (scores.sum(2)
               + torch.einsum("bhp,bthp->bth", n, qq) * inter_scale)
        den = torch.maximum(den.abs(), torch.exp(-M))
        hs.append(num / den[..., None])                         # (B,Q,H,P)
        FQ = Fc[:, -1, :]                                       # (B, H)
        m_endc = torch.amax(FQ[:, None, :] - Fc + ii, dim=1)
        m_new = torch.maximum(FQ + m, m_endc)
        decay = torch.exp(FQ[:, None, :] - Fc + ii - m_new[:, None, :])
        keep = torch.exp(FQ + m - m_new)
        C = (keep[:, :, None, None] * C
             + torch.einsum("bsh,bshp,bshq->bhpq", decay, vv, kk))
        n = keep[:, :, None] * n + torch.einsum("bsh,bshp->bhp", decay, kk)
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B_, L, d_inner).to(dt_)
    return _mlstm_out(params, h, z, cfg)


def init_mlstm_cache(cfg: ModelConfig, batch: int, device=None,
                     lead: tuple = ()):
    d_inner, H, P = xlstm_dims(cfg)

    def zeros(*shape):
        return torch.zeros((*lead, batch, *shape), dtype=torch.float32,
                           device=device)
    return {"conv": zeros(3, d_inner), "C": zeros(H, P, P), "n": zeros(H, P),
            "m": torch.full((*lead, batch, H), -1e9, dtype=torch.float32,
                            device=device)}


def mlstm_decode_step(params, x, cache, cfg: ModelConfig):
    """x: (B, 1, d); writes the conv window and (C, n, m) into ``cache`` in
    place. Returns (y, cache)."""
    d_inner, H, P = xlstm_dims(cfg)
    B_ = x.shape[0]
    dt_ = x.dtype
    up = x @ params["up_proj"].to(dt_)
    xi, z = torch.chunk(up, 2, dim=-1)                          # (B, 1, di)
    window = torch.cat([cache["conv"], xi.float()], dim=1)
    xc = (_window_conv(window.to(dt_), params["conv_w"].to(dt_))
          + params["conv_b"].to(dt_))
    xc = F.silu(xc)[:, None, :]
    q = (xc @ params["wq"].to(dt_)).reshape(B_, H, P).float()
    k = ((xc @ params["wk"].to(dt_)).reshape(B_, H, P) / (P ** 0.5)).float()
    v = (xi @ params["wv"].to(dt_)).reshape(B_, H, P).float()
    gates = ((xi @ params["w_gates"].to(dt_)).float()[:, 0]
             + params["gate_bias"].float())
    ig, fg = torch.chunk(gates, 2, dim=-1)                      # (B, H)
    logf = F.logsigmoid(fg)
    m = cache["m"]
    m_new = torch.maximum(logf + m, ig)
    fs = torch.exp(logf + m - m_new)[:, :, None]
    is_ = torch.exp(ig - m_new)[:, :, None]
    C = cache["C"].mul_(fs[..., None]).add_(
        is_[..., None] * torch.einsum("bhp,bhq->bhpq", v, k))
    n = cache["n"].mul_(fs).add_(is_ * k)
    m.copy_(m_new)
    num = torch.einsum("bhpq,bhq->bhp", C, q)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", n, q).abs(),
                        torch.exp(-m_new))[:, :, None]
    h = (num / den).reshape(B_, 1, d_inner).to(dt_)
    cache["conv"].copy_(window[:, 1:])
    return _mlstm_out(params, h, z, cfg), cache


def init_slstm(gen, cfg: ModelConfig, dtype=torch.float32, lead: tuple = ()):
    d = cfg.d_model
    H = cfg.n_heads
    P = d // H
    return {
        "w_in": dense_init(gen, (*lead, d, 4 * d), dtype=dtype),   # i,f,z,o
        "r": dense_init(gen, (*lead, H, P, 4 * P), dtype=dtype),   # block-diag
        "bias": _fill(gen, lead, [(d, 0.0), (d, 3.0), (2 * d, 0.0)], dtype),
        "norm": init_rmsnorm(gen, d, dtype, lead),
        "out_proj": dense_init(gen, (*lead, d, d), dtype=dtype),
    }


def _slstm_cell(carry, xt, r, one, H, P):
    """One sLSTM step. carry: (c, n, m, h), each (B, H, P) f32; xt (B, 4d)
    in the compute dtype; r (H, P, 4P), the compute dtype's values in f32
    (``jnp.einsum`` promotes them against the f32 h); ``one`` an f32 1."""
    c, n, m, h = carry
    pre = xt + torch.einsum("bhp,hpq->bhq", h, r).reshape(xt.shape)  # f32
    i_raw, f_raw, z_raw, o_raw = pre.reshape(xt.shape[0], 4, H, P).unbind(1)
    logf_m = F.logsigmoid(f_raw) + m
    m_new = torch.maximum(logf_m, i_raw)
    i_s = torch.exp(i_raw - m_new)
    f_s = torch.exp(logf_m - m_new)
    c_new = f_s * c + i_s * torch.tanh(z_raw)
    n_new = f_s * n + i_s
    # torch.maximum splits the gradient at a tie as jnp.maximum does (the
    # first step's n_new is exactly 1); clamp would not
    h_new = torch.sigmoid(o_raw) * c_new / torch.maximum(n_new, one)
    return c_new, n_new, m_new, h_new


def slstm_fwd(params, x, cfg: ModelConfig, carry=None):
    """Recurrent sLSTM over the sequence, a loop over tokens. x: (B, L, d)
    -> (y, carry)."""
    H = cfg.n_heads
    B_, L, d = x.shape
    P = d // H
    dt_ = x.dtype
    pre = x @ params["w_in"].to(dt_) + params["bias"].to(dt_)  # (B, L, 4d)
    if carry is None:
        def zero():
            return torch.zeros((B_, H, P), dtype=torch.float32,
                               device=x.device)
        carry = (zero(), zero(), torch.full((B_, H, P), -1e9,
                                            dtype=torch.float32,
                                            device=x.device), zero())
    r = params["r"].to(dt_).float()
    one = torch.ones((), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(L):
        carry = _slstm_cell(carry, pre[:, t], r, one, H, P)
        hs.append(carry[3])
    h = torch.stack(hs, dim=1).reshape(B_, L, d).to(dt_)
    h = rmsnorm(params["norm"], h, cfg.norm_eps)
    return h @ params["out_proj"].to(dt_), carry


def init_slstm_cache(cfg: ModelConfig, batch: int, device=None,
                     lead: tuple = ()):
    H = cfg.n_heads
    shape = (*lead, batch, H, cfg.d_model // H)
    out = {key: torch.zeros(shape, dtype=torch.float32, device=device)
           for key in ("c", "n", "h")}
    out["m"] = torch.full(shape, -1e9, dtype=torch.float32, device=device)
    return out


def slstm_decode_step(params, x, cache, cfg: ModelConfig):
    """x: (B, 1, d); writes (c, n, m, h) into ``cache`` in place. Returns
    (y, cache)."""
    y, carry = slstm_fwd(params, x, cfg, carry=(cache["c"], cache["n"],
                                                 cache["m"], cache["h"]))
    for key, t in zip(("c", "n", "m", "h"), carry):
        cache[key].copy_(t)
    return y, cache
