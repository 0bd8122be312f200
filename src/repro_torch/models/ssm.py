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

Tensor parallelism (``tp``, a ``core/shmap.ModelAxis``; the leaves are
this column's shards by ``launch/sharding.py``'s rules). Where the heads
divide the columns (and Mamba2's group-shared B/C width does), each
column runs its own heads: the packed input projections (Mamba2's
``in_proj`` [z | x | B | C | dt], mLSTM's ``up_proj`` [x | z] and
``w_gates`` [i | f]), cut by the rules across their segments, are
computed from this column's columns and their activations gathered
whole with ``gather_in`` (the gradient summed over the columns, then this
column's part); so are the depthwise conv's small leaves. Each column
then takes its heads' channels (Mamba2's B and C whole), runs the
recurrence on its heads with no collective inside the chunk or token
loops, norms over the whole width (``rmsnorm(..., tp=)``), gates with its
channels of z and feeds its rows of the output projection, whose partial
outputs are model-summed. Where the heads do not divide, every column
runs every head: each split projection's output is gathered plain over a
``copy_in`` input, the split small leaves are gathered, and the output
projection takes ``split`` rows then the sum. sLSTM always runs that way:
its recurrent term, reshaped as the reference reshapes it, feeds head h's
outputs into every head's gates, so no column can run its heads alone
without a collective each token (``r`` is gathered once a call). The
caches hold this column's heads of the states (and Mamba2's conv window
its heads' x channels and the whole B and C); mLSTM's conv window and
sLSTM's states are whole on every column.
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


def _columns(tp) -> int:
    return 1 if tp is None else tp.size


def _whole(tp, t, width: int, dim: int = -1):
    """``t`` whole along ``dim``: where the rules split it (it holds not
    ``width`` but width / M there), the columns' parts gathered, each
    column's gradient its own part (every column uses the whole alike)."""
    if tp is None or t.shape[dim] == width:
        return t
    return tp.gather(t, dim)


def _col_proj(x, w, tp, width: int):
    """``x @ w`` whole on every column: where the rules split ``w``'s
    ``width`` columns, this column's product over ``copy_in(x)``, gathered
    plain."""
    if tp is None or w.shape[-1] == width:
        return x @ w
    return tp.gather(tp.copy_in(x) @ w)


def _rows_out(y, w, tp):
    """``y @ w`` for an output projection: where the rules split ``w``'s
    rows, this column's part of the whole ``y`` (``split``) through them,
    the partial outputs model-summed."""
    if tp is None or w.shape[0] == y.shape[-1]:
        return y @ w
    return tp.reduce_out(tp.split(y) @ w)


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


def mamba_local(cfg: ModelConfig, M: int) -> bool:
    """Whether each of M > 1 model columns runs its own H / M heads of
    Mamba2: H and the group-shared B/C width 2 G N divide M (so every
    packed leaf splits)."""
    s = cfg.ssm
    H = mamba_dims(cfg)[1]
    return M > 1 and H % M == 0 and (2 * s.n_groups * s.d_state) % M == 0


def _own_x(tp, t, d_inner: int):
    """[x | B | C] along the last axis -> [this column's x channels | B |
    C]."""
    return torch.cat([tp.slice(t[..., :d_inner]), t[..., d_inner:]], dim=-1)


def _mamba_in(params, x, cfg: ModelConfig, tp):
    """The input side as this column runs it: (z, the conv's input, dt
    before its bias, the leaves as this column uses them, local). Local
    heads: z, x and dt this column's heads' channels, B and C whole, the
    conv's leaves [its x | B | C] (``A_log``, ``D``, ``dt_bias`` are its
    heads' shards already). Otherwise every head, whole."""
    d_inner, H, conv_dim = mamba_dims(cfg)
    w = params["in_proj"].to(x.dtype)
    p = dict(params)
    local = mamba_local(cfg, _columns(tp))
    if local:
        proj = tp.gather_in(tp.copy_in(x) @ w)
    else:
        proj = _col_proj(x, w, tp, d_inner + conv_dim + H)
    z, conv_in, dt_raw = _split_proj(cfg, proj)
    if local:
        z, dt_raw = tp.slice(z), tp.slice(dt_raw)
        conv_in = _own_x(tp, conv_in, d_inner)
        for name in ("conv_w", "conv_b"):
            p[name] = _own_x(tp, tp.gather_in(params[name]), d_inner)
    elif tp is not None:
        for name, width in (("conv_w", conv_dim), ("conv_b", conv_dim),
                            ("A_log", H), ("D", H), ("dt_bias", H)):
            p[name] = _whole(tp, params[name], width)
    return z, conv_in, dt_raw, p, local


def _mamba_out(p, y, z, cfg: ModelConfig, tp, local: bool):
    """The norm over the whole d_inner, the gate and ``out_proj``."""
    dt_ = y.dtype
    if local:
        y = rmsnorm(p["norm"], y, cfg.norm_eps, tp=tp) * F.silu(z)
        return tp.reduce_out(y @ p["out_proj"].to(dt_))
    y = rmsnorm(p["norm"], y, cfg.norm_eps) * F.silu(z)
    return _rows_out(y, p["out_proj"].to(dt_), tp)


def mamba_fwd(params, x, cfg: ModelConfig, tp=None):
    """Chunked SSD. x: (B, L, d) -> (B, L, d); L a multiple of the chunk
    size. ``tp``: the model axis (module docstring)."""
    s = cfg.ssm
    N, G, Q, P = s.d_state, s.n_groups, s.chunk_size, HEAD_P
    B_, L, _ = x.shape
    if L % Q:
        raise ValueError(f"mamba_fwd: the sequence length {L} is not a "
                         f"multiple of the chunk size {Q}")
    dt_ = x.dtype
    z, conv_in, dt_raw, params, local = _mamba_in(params, x, cfg, tp)
    H = params["A_log"].shape[-1]                 # this column's heads
    d_inner = H * P
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
    return _mamba_out(params, y, z, cfg, tp, local)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None, lead: tuple = (), model_parallel: int = 1):
    """The conv window and the f32 state; over ``model_parallel`` columns
    with local heads (``mamba_local``), this column's heads of the state
    and its heads' x channels of the window beside the whole B and C."""
    s = cfg.ssm
    d_inner, H, conv_dim = mamba_dims(cfg)
    if mamba_local(cfg, model_parallel):
        H //= model_parallel
        conv_dim -= d_inner - d_inner // model_parallel
    return {
        "conv": torch.zeros((*lead, batch, s.d_conv - 1, conv_dim),
                            dtype=dtype, device=device),
        "h": torch.zeros((*lead, batch, H, HEAD_P, s.d_state),
                         dtype=torch.float32, device=device),
    }


def mamba_decode_step(params, x, cache, cfg: ModelConfig, tp=None):
    """x: (B, 1, d). O(1) decode; writes the conv window and the state into
    ``cache`` in place (``init_mamba_cache``'s layout for ``tp``). Returns
    (y, cache)."""
    s = cfg.ssm
    N, G = s.d_state, s.n_groups
    B_ = x.shape[0]
    dt_ = x.dtype
    z, conv_in, dt_raw, params, local = _mamba_in(params, x, cfg, tp)
    H = params["A_log"].shape[-1]
    d_inner = H * HEAD_P
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
    y = _mamba_out(params, y, z, cfg, tp, local)
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


def mlstm_fwd(params, x, cfg: ModelConfig, tp=None):
    """mLSTM forward. The chunkwise form for long sequences (linear memory
    in L), the quadratic parallel form otherwise. x: (B, L, d). ``tp``:
    the model axis (module docstring)."""
    Q = min(cfg.ssm.chunk_size, 256)
    if x.shape[1] >= 2 * Q and x.shape[1] % Q == 0:
        return mlstm_fwd_chunked(params, x, cfg, tp)
    return _mlstm_fwd_quadratic(params, x, cfg, tp)


def heads_local(n_heads: int, M: int) -> bool:
    """Whether each of M > 1 model columns runs its own heads of an
    xLSTM block (the heads divide M)."""
    return M > 1 and n_heads % M == 0


def _mlstm_up(params, x, cfg: ModelConfig, tp):
    """``up_proj``'s two halves: xi whole on every column, z this
    column's heads' channels where the heads are local, else whole."""
    d_inner, H, _ = xlstm_dims(cfg)
    w = params["up_proj"].to(x.dtype)
    if heads_local(H, _columns(tp)):
        xi, z = torch.chunk(tp.gather_in(tp.copy_in(x) @ w), 2, dim=-1)
        return xi, tp.slice(z)
    return torch.chunk(_col_proj(x, w, tp, 2 * d_inner), 2, dim=-1)


def _mlstm_conv(params, cfg: ModelConfig, tp):
    """The conv's taps and bias, whole on every column."""
    d_inner, H, _ = xlstm_dims(cfg)
    w, b = params["conv_w"], params["conv_b"]
    if heads_local(H, _columns(tp)):
        return tp.gather_in(w), tp.gather_in(b)
    return _whole(tp, w, d_inner), _whole(tp, b, d_inner)


def _mlstm_proj(params, xc, xi, cfg: ModelConfig, tp):
    """q, k (scaled), v (B, L, H', P) in the compute dtype and the input
    and forget gates' pre-activations (B, L, H') in f32, from the whole
    conv output ``xc`` and input ``xi``: H' this column's heads where they
    are local, else every head."""
    d_inner, H, P = xlstm_dims(cfg)
    B_, L, _ = xc.shape
    dt_ = xc.dtype
    wq, wk, wv, wg = (params[n].to(dt_) for n in ("wq", "wk", "wv",
                                                   "w_gates"))
    if heads_local(H, _columns(tp)):
        q, k, v = xc @ wq, xc @ wk, xi @ wv
        gates = (tp.gather_in(xi @ wg).float()
                 + tp.copy_in(params["gate_bias"]).float())
        ig, fg = (tp.slice(g) for g in torch.chunk(gates, 2, dim=-1))
        H //= tp.size
    else:
        q, k = _col_proj(xc, wq, tp, d_inner), _col_proj(xc, wk, tp, d_inner)
        v = _col_proj(xi, wv, tp, d_inner)
        gates = (_col_proj(xi, wg, tp, 2 * H).float()
                 + params["gate_bias"].float())
        ig, fg = torch.chunk(gates, 2, dim=-1)                  # (B, L, H)
    return (q.reshape(B_, L, H, P), k.reshape(B_, L, H, P) / (P ** 0.5),
            v.reshape(B_, L, H, P), ig, fg)


def _mlstm_inputs(params, x, cfg: ModelConfig, tp=None):
    """The projections both forms share: z (B, L, di'); q, k, v (B, L,
    H', P) in the compute dtype; the f32 input gate and log forget gate
    (B, L, H'); H' and di' this column's heads and channels under ``tp``
    where the heads are local."""
    dt_ = x.dtype
    xi, z = _mlstm_up(params, x, cfg, tp)
    w, b = _mlstm_conv(params, cfg, tp)
    xc = F.silu(_causal_conv(xi, w.to(dt_), b.to(dt_)))
    q, k, v, ig, fg = _mlstm_proj(params, xc, xi, cfg, tp)
    return z, q, k, v, ig, F.logsigmoid(fg)


def _mlstm_out(params, h, z, cfg, tp=None):
    if heads_local(cfg.n_heads, _columns(tp)):
        h = rmsnorm(params["norm"], h, cfg.norm_eps, tp=tp) * F.silu(z)
        return tp.reduce_out(h @ params["down_proj"].to(h.dtype))
    h = rmsnorm(params["norm"], h, cfg.norm_eps) * F.silu(z)
    return _rows_out(h, params["down_proj"].to(h.dtype), tp)


def _mlstm_fwd_quadratic(params, x, cfg: ModelConfig, tp=None):
    """Parallel (quadratic) mLSTM forward. x: (B, L, d)."""
    B_, L, _ = x.shape
    dt_ = x.dtype
    z, q, k, v, ig, logf = _mlstm_inputs(params, x, cfg, tp)
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
    h = torch.einsum("btsh,bshp->bthp", scores, v).reshape(B_, L, -1)
    return _mlstm_out(params, h, z, cfg, tp)


def mlstm_fwd_chunked(params, x, cfg: ModelConfig, tp=None):
    """Chunkwise-stabilized mLSTM: the matrix memory (C, n, m) carried
    across chunks of length Q, (B, Q, Q, H) blocks within one. Position
    tau combines the inter-chunk term exp(F_tau + m - M) (C q) with the
    intra-chunk terms under the running max M = max(F_tau + m,
    max_s D[tau, s]); the chunk-end update mirrors the decode recurrence."""
    Q = min(cfg.ssm.chunk_size, 256)
    B_, L, _ = x.shape
    dt_ = x.dtype
    z, q, k, v, ig, logf = _mlstm_inputs(params, x, cfg, tp)
    H, P = q.shape[2], q.shape[3]                 # this column's heads
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
    h = torch.stack(hs, dim=1).reshape(B_, L, H * P).to(dt_)
    return _mlstm_out(params, h, z, cfg, tp)


def init_mlstm_cache(cfg: ModelConfig, batch: int, device=None,
                     lead: tuple = (), model_parallel: int = 1):
    """The conv window (whole on every column) and the f32 (C, n, m);
    over ``model_parallel`` columns with local heads (``heads_local``),
    this column's heads of C, n and m."""
    d_inner, H, P = xlstm_dims(cfg)
    if heads_local(H, model_parallel):
        H //= model_parallel

    def zeros(*shape):
        return torch.zeros((*lead, batch, *shape), dtype=torch.float32,
                           device=device)
    return {"conv": zeros(3, d_inner), "C": zeros(H, P, P), "n": zeros(H, P),
            "m": torch.full((*lead, batch, H), -1e9, dtype=torch.float32,
                            device=device)}


def mlstm_decode_step(params, x, cache, cfg: ModelConfig, tp=None):
    """x: (B, 1, d); writes the conv window and (C, n, m) into ``cache`` in
    place (``init_mlstm_cache``'s layout for ``tp``). Returns (y,
    cache)."""
    B_ = x.shape[0]
    dt_ = x.dtype
    xi, z = _mlstm_up(params, x, cfg, tp)                       # (B, 1, di)
    window = torch.cat([cache["conv"], xi.float()], dim=1)
    w, b = _mlstm_conv(params, cfg, tp)
    xc = _window_conv(window.to(dt_), w.to(dt_)) + b.to(dt_)
    xc = F.silu(xc)[:, None, :]
    q, k, v, ig, fg = _mlstm_proj(params, xc, xi, cfg, tp)
    q, k, v = (t[:, 0].float() for t in (q, k, v))              # (B, H, P)
    ig, fg = ig[:, 0], fg[:, 0]                                 # (B, H)
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
    h = (num / den).reshape(B_, 1, -1).to(dt_)
    cache["conv"].copy_(window[:, 1:])
    return _mlstm_out(params, h, z, cfg, tp), cache


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


def slstm_fwd(params, x, cfg: ModelConfig, carry=None, tp=None):
    """Recurrent sLSTM over the sequence, a loop over tokens. x: (B, L, d)
    -> (y, carry). ``tp``: every head on every column (module
    docstring)."""
    H = cfg.n_heads
    B_, L, d = x.shape
    P = d // H
    dt_ = x.dtype
    pre = (_col_proj(x, params["w_in"].to(dt_), tp, 4 * d)
           + params["bias"].to(dt_))                            # (B, L, 4d)
    if carry is None:
        def zero():
            return torch.zeros((B_, H, P), dtype=torch.float32,
                               device=x.device)
        carry = (zero(), zero(), torch.full((B_, H, P), -1e9,
                                            dtype=torch.float32,
                                            device=x.device), zero())
    r = _whole(tp, params["r"], H, dim=0).to(dt_).float()
    one = torch.ones((), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(L):
        carry = _slstm_cell(carry, pre[:, t], r, one, H, P)
        hs.append(carry[3])
    h = torch.stack(hs, dim=1).reshape(B_, L, d).to(dt_)
    h = rmsnorm(params["norm"], h, cfg.norm_eps)
    return _rows_out(h, params["out_proj"].to(dt_), tp), carry


def init_slstm_cache(cfg: ModelConfig, batch: int, device=None,
                     lead: tuple = ()):
    H = cfg.n_heads
    shape = (*lead, batch, H, cfg.d_model // H)
    out = {key: torch.zeros(shape, dtype=torch.float32, device=device)
           for key in ("c", "n", "h")}
    out["m"] = torch.full(shape, -1e9, dtype=torch.float32, device=device)
    return out


def slstm_decode_step(params, x, cache, cfg: ModelConfig, tp=None):
    """x: (B, 1, d); writes (c, n, m, h) into ``cache`` in place (whole on
    every column under ``tp``). Returns (y, cache)."""
    y, carry = slstm_fwd(params, x, cfg, carry=(cache["c"], cache["n"],
                                                 cache["m"], cache["h"]),
                         tp=tp)
    for key, t in zip(("c", "n", "m", "h"), carry):
        cache[key].copy_(t)
    return y, cache
