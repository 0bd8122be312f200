"""Flash attention (causal or not, grouped-query): the CUDA kernel's wrapper
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel``, launched by ``flash_attention_bhsd``). q (B, H, S, D),
k (B, Hkv, S, D) and v (B, Hkv, S, Dv) with Dv <= D (MLA: D = 192, Dv =
128), H a multiple of Hkv, query head h reading kv head ``h // (H //
Hkv)``; f32 math with an online softmax, output (B, H, S, Dv) in q's
dtype, ``scale`` defaulting to D ** -0.5. ``csrc/flash_attention.cu``
holds three kernels and its entry point picks one by (dtype, D, Dv) alone:
bf16 with Dv <= 128 takes the Hopper kernel (TMA, mbarriers,
warp-specialised ``wgmma``; instantiated at (D, Dv) buckets of (64, 64),
(128, 128), (192, 128) and (256, 128)), bf16 with Dv > 128 an ``mma.sync``
kernel, f32 a CUDA-core one. The source says what each design does about
its bound (operations, at the serving path's prefill shapes).
``flash_attention_bhsd`` launches it for CUDA tensors and raises if it
cannot; only CPU tensors take ``flash_attention_plain``.
``flash_attention_bhsd.launches`` counts the kernel's launches.

The backward (``flash_attention_bwd``, ``csrc/flash_attention_bwd.cu``)
takes the forward's output and its per-row log-sum-exp, which the forward
writes when it is given an ``lse`` buffer, and gives dq, dk, dv in the
inputs' dtype and layout; ``flash_attention_plain_bwd`` is its plain
version, which takes Dv < D as the forward does. The kernels take one head
dim (Dv == D); ``kernels.ops.FlashAttention`` pads v for them when Dv < D.
Their entry point also picks by (dtype, D) alone: bf16 with
D <= 128 takes the Hopper route (a preprocess, one TMA/``wgmma`` pass for
dk, dv and dq's partial sums, added into an f32 workspace in a fixed
order of turns, and a conversion of that workspace into dq), bf16 with
D > 128 ``mma.sync`` kernels, f32 CUDA-core ones; ``_bwd_scratch`` makes
each route's scratch. ``flash_attention_bwd.launches`` counts its calls on
the card.
``kernels.ops.flash_attention`` ties the two into one autograd function.
The plain versions also take float64 (the gradient checks); the kernels
do not.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load_library

NEG_INF = -1e30                 # the TPU kernel's mask value
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PLAIN_DTYPES = (*_DTYPE_CODE, torch.float64)   # float64: the plain versions
_MAX_HEAD_DIM = 256
_MAX_BATCH_HEADS = 65535        # grid.y limit
_MAX_STRIDE_BYTES = 1 << 40     # a TMA tensor map's stride limit


def _math_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic: f32, or f64 for f64 inputs."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _causal_keep(S: int, device):
    pos = torch.arange(S, device=device)
    return pos[:, None] >= pos[None, :]


def flash_attention_plain(q, k, v, *, causal=True, scale=None,
                          return_lse=False):
    """The same function in plain torch: f32 math, q scaled before the dot,
    masked scores -1e30, output divided by max(l, 1e-30), cast to q's dtype,
    (B, H, S, Dv) for v of head dim Dv.
    One batch row at a time, so the (H, S, S) scores of one row are the
    largest temporary; kv heads are broadcast over their query group, never
    repeated in memory. With ``return_lse`` it returns ``(out, lse)``, lse
    the (B, H, S) log-sum-exp of the scaled scores, m + log(l), in the
    arithmetic's dtype."""
    _check(q, k, v)
    B, H, S, D = q.shape
    Hkv, Dv = k.shape[1], v.shape[-1]
    scale = D ** -0.5 if scale is None else scale
    md = _math_dtype(q)
    out = q.new_empty((B, H, S, Dv))
    lse = torch.empty((B, H, S), dtype=md, device=q.device)
    keep = _causal_keep(S, q.device) if causal else None
    for b in range(B):
        qb = q[b].to(md).reshape(Hkv, H // Hkv, S, D) * scale
        s = qb @ k[b].to(md)[:, None].transpose(-1, -2)     # (Hkv, G, S, S)
        if keep is not None:
            s = torch.where(keep, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        o = (p @ v[b].to(md)[:, None]) / den
        out[b] = o.reshape(H, S, Dv).to(q.dtype)
        lse[b] = (m + torch.log(den)).reshape(H, S)
    return (out, lse) if return_lse else out


def flash_attention_plain_bwd(q, k, v, o, lse, do, causal=True, scale=None):
    """The backward in plain torch: f32 math (f64 for f64 inputs), one batch
    row at a time. With s = scale q k^T and P = exp(s - lse) (0 where
    masked): delta = rowsum(do o), dS = P (do v^T - delta), dq = scale dS k,
    dk = scale dS^T q and dv = P^T do, the last two summed over each kv
    head's query group. o and do are (B, H, S, Dv) like the forward's
    output. Returns (dq, dk, dv) in the inputs' dtype."""
    _check(q, k, v)
    _check_grad_inputs(q, v, o, lse, do)
    B, H, S, D = q.shape
    Hkv, Dv = k.shape[1], v.shape[-1]
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    md = _math_dtype(q)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    keep = _causal_keep(S, q.device) if causal else None
    for b in range(B):
        qb = q[b].to(md).reshape(Hkv, G, S, D)
        kb = k[b].to(md)[:, None]                            # (Hkv, 1, S, D)
        vb = v[b].to(md)[:, None]
        dob = do[b].to(md).reshape(Hkv, G, S, Dv)
        s = (qb * scale) @ kb.transpose(-1, -2)              # (Hkv, G, S, S)
        p = torch.exp(s - lse[b].to(md).reshape(Hkv, G, S, 1))
        if keep is not None:
            p = torch.where(keep, p, 0.0)
        delta = (dob * o[b].to(md).reshape(Hkv, G, S, Dv)).sum(-1,
                                                                keepdim=True)
        ds = p * (dob @ vb.transpose(-1, -2) - delta)
        dq[b] = (scale * (ds @ kb)).reshape(H, S, D).to(q.dtype)
        dk[b] = (scale * (ds.transpose(-1, -2) @ qb)).sum(1).to(k.dtype)
        dv[b] = (p.transpose(-1, -2) @ dob).sum(1).to(v.dtype)
    return dq, dk, dv


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash attention needs q (B, H, S, D), k (B, Hkv, "
                         f"S, D) and v (B, Hkv, S, Dv); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    Hkv, Dv = k.shape[1], v.shape[-1]
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B
            or k.shape[2:] != (S, D) or Hkv < 1 or H % Hkv):
        raise ValueError(f"flash attention needs k (B, Hkv, S, D) and v "
                         f"(B, Hkv, S, Dv) with H a multiple of Hkv; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if B < 1 or S < 1:
        raise ValueError(f"flash attention needs B, S >= 1; got "
                         f"{tuple(q.shape)}")
    if D % 8 or not 8 <= D <= _MAX_HEAD_DIM:
        raise ValueError(f"flash attention takes a head dim D that is a "
                         f"multiple of 8 from 8 to {_MAX_HEAD_DIM}; got {D}")
    if Dv % 8 or not 8 <= Dv <= D:
        raise ValueError(f"flash attention takes v's head dim Dv, a multiple "
                         f"of 8 with 8 <= Dv <= D; got Dv = {Dv}, D = {D}")
    if (q.dtype not in _PLAIN_DTYPES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(f"flash attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype (float64 in the plain version); got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")


def _check_grad_inputs(q, v, o, lse, do) -> None:
    B, H, S, _ = q.shape
    shape = (B, H, S, v.shape[-1])
    for name, x in (("o", o), ("do", do)):
        if x.shape != shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"the backward needs {name} like q at v's head "
                             f"dim ({q.dtype} {shape} on {q.device}); got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if (lse.shape != (B, H, S) or lse.dtype != _math_dtype(q)
            or lse.device != q.device):
        raise ValueError(f"the backward needs the forward's lse, "
                         f"{_math_dtype(q)} {(B, H, S)} on {q.device}; got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")


def _check_card(q) -> None:
    """What the kernels take beyond ``_check``: a CUDA device, f32 or bf16,
    and B * H within the grid."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the flash attention kernels take float32 or "
                        f"bfloat16, not {q.dtype}")
    B, H = q.shape[:2]
    if B * H > _MAX_BATCH_HEADS:
        raise ValueError(f"flash attention takes B * H <= "
                         f"{_MAX_BATCH_HEADS}; got {B * H}")


def _out(x, like, name, width=None):
    """``x``, or a new contiguous tensor like ``like``, whose last dim is
    ``width`` if given."""
    shape = (*like.shape[:-1], like.shape[-1] if width is None else width)
    if x is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    if x.shape != shape or x.dtype != like.dtype or x.device != like.device:
        raise ValueError(f"{name} must be a {like.dtype} tensor of shape "
                         f"{shape} on {like.device}")
    return x


def _check_layout(name: str, x: torch.Tensor) -> None:
    """The kernel reads rows of D elements through (b, h, s) strides, by TMA
    tensor maps for bf16 at D <= 128: the last dim must be dense, every row
    start 16-byte aligned, and each stride below 2**40 bytes."""
    per16 = 16 // x.element_size()
    if (x.stride(3) != 1 or x.data_ptr() % 16
            or any(st % per16 for st in x.stride()[:3])):
        raise ValueError(f"flash attention needs {name} with a dense last "
                         f"dim and 16-byte aligned rows; got strides "
                         f"{x.stride()} at offset {x.storage_offset()}")
    if any(st * x.element_size() >= _MAX_STRIDE_BYTES
           for st in x.stride()[:3]):
        raise ValueError(f"flash attention needs {name}'s strides below "
                         f"2**40 bytes (a tensor map's limit); got "
                         f"{x.stride()} in {x.element_size()}-byte elements")


def flash_attention_bhsd(q, k, v, *, causal=True, scale=None, out=None,
                         lse=None):
    """q (B, H, S, D); k (B, Hkv, S, D); v (B, Hkv, S, Dv), Dv <= D ->
    (B, H, S, Dv) in q's dtype. Launches the CUDA kernel for CUDA tensors;
    CPU tensors take ``flash_attention_plain``. ``out``, if given, is a
    (B, H, S, Dv) tensor
    (any strides the kernel can write) that receives the result; ``lse``,
    if given, a contiguous (B, H, S) tensor that receives the log-sum-exp
    (f32 on the card)."""
    _check(q, k, v)
    B, H, S, D = q.shape
    scale = D ** -0.5 if scale is None else float(scale)
    if lse is not None and (lse.shape != (B, H, S) or not lse.is_contiguous()
                            or lse.dtype != _math_dtype(q)
                            or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous {_math_dtype(q)} tensor "
                         f"of shape {(B, H, S)} on {q.device}")
    if q.device.type == "cpu":
        res, res_lse = flash_attention_plain(q, k, v, causal=causal,
                                             scale=scale, return_lse=True)
        if lse is not None:
            lse.copy_(res_lse)
        return res if out is None else out.copy_(res)
    _check_card(q)
    out = _out(out, q, "out", v.shape[-1])
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_layout(name, x)
    strides = (ctypes.c_longlong * 12)(
        *(st for x in (q, k, v, out) for st in x.stride()[:3]))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), strides,
            B, H, k.shape[1], S, D, v.shape[-1], scale, int(bool(causal)),
            stream)
    if err != 0:
        raise RuntimeError("flash attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0   # kernel launches so far (plain excluded)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, scale=None,
                        dq=None, dk=None, dv=None):
    """The gradients (dq, dk, dv) of ``flash_attention_bhsd`` at q, k, v,
    given its output o, its log-sum-exp lse and the output's gradient do
    ((B, H, S, Dv) like the output). Launches the backward kernels (a
    preprocess for rowsum(do o), then dk/dv and dq: three launches on every
    route) for CUDA tensors and raises if it cannot, as it does for Dv < D,
    which the kernels do not take (``ops.FlashAttention`` pads v for them);
    CPU tensors take ``flash_attention_plain_bwd``. dq, dk, dv, if given,
    are tensors (any strides the kernels can write) that receive the
    results."""
    _check(q, k, v)
    _check_grad_inputs(q, v, o, lse, do)
    B, H, S, D = q.shape
    scale = D ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        res = flash_attention_plain_bwd(q, k, v, o, lse, do, causal=causal,
                                        scale=scale)
        return tuple(r if x is None else x.copy_(r)
                     for r, x in zip(res, (dq, dk, dv)))
    _check_card(q)
    if v.shape[-1] != D:
        raise ValueError(f"the backward kernels take one head dim (Dv == D); "
                         f"got D = {D}, Dv = {v.shape[-1]}")
    dq, dk, dv = (_out(x, like, name) for x, like, name in
                  ((dq, q, "dq"), (dk, k, "dk"), (dv, v, "dv")))
    for name, x in zip(("q", "k", "v", "o", "do", "dq", "dk", "dv"),
                       (q, k, v, o, do, dq, dk, dv)):
        _check_layout(name, x)
    if not lse.is_contiguous():
        raise ValueError("the backward needs a contiguous lse")
    _launch_bwd(q, k, v, o, lse, do, dq, dk, dv, _bwd_scratch(q), causal,
                scale, _ALL_PHASES)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0    # backward calls on the card so far

# the backward's kernels, by the C entry point's phase bits
BWD_PHASES = {"preprocess": 1, "main": 2, "dq": 4}
_ALL_PHASES = 7
_BWD_TILE = 64                  # query rows of a dq workspace tile


def _hopper_bwd(q) -> bool:
    """Whether the backward takes the Hopper route: bf16 with D <= 128."""
    return q.dtype == torch.bfloat16 and q.shape[-1] <= 128


def _bwd_scratch(q) -> dict:
    """The backward's scratch, made with ``torch.empty`` (only the turn
    counters are zeroed). Hopper route: ``delta`` (B, H, S padded to whole
    64-row tiles, 2) f32 pairs (lse * log2 e, delta); ``dq_accum``, the f32
    workspace of dq's sums, (B, H, tiles, 64, DP) with DP = 64 or 128;
    ``turns`` (B, H, tiles) int32. Other routes: ``delta`` (B, H, S)
    f32. The C entry point holds the same layout and refuses a launch
    whose scratch is smaller."""
    B, H, S, D = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    if not _hopper_bwd(q):
        return {"delta": torch.empty((B, H, S), **f32), "dq_accum": None,
                "turns": None}
    tiles = -(-S // _BWD_TILE)
    width = 64 if D <= 64 else 128
    return {"delta": torch.empty((B, H, tiles * _BWD_TILE, 2), **f32),
            "dq_accum": torch.empty((B, H, tiles, _BWD_TILE, width), **f32),
            "turns": torch.zeros((B, H, tiles), dtype=torch.int32,
                                 device=q.device)}


def _launch_bwd(q, k, v, o, lse, do, dq, dk, dv, scratch: dict, causal,
                scale, phases: int) -> None:
    """One call of the backward's C entry point on checked tensors:
    ``phases`` picks its kernels (``BWD_PHASES``; all of them for the
    backward, one at a time to time them apart, the main kernel's turns
    zeroed again before each of its runs)."""
    B, H, S, D = q.shape
    tensors = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(
        *(st for x in tensors for st in x.stride()[:3]))
    ptr = {n: None if x is None else x.data_ptr() for n, x in scratch.items()}
    # the C entry point refuses scratch smaller than its route's layout
    scratch_len = (ctypes.c_longlong * 3)(
        *(0 if scratch[n] is None else scratch[n].numel()
          for n in ("delta", "dq_accum", "turns")))
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            _DTYPE_CODE[q.dtype], *(x.data_ptr() for x in tensors),
            lse.data_ptr(), ptr["delta"], ptr["dq_accum"], ptr["turns"],
            strides, scratch_len, B, H, k.shape[1], S, D, scale,
            int(bool(causal)),
            phases, stream)
    if err != 0:
        raise RuntimeError("flash attention backward launch failed: "
                           + lib.flash_attention_bwd_error_string(err)
                           .decode())


def _library() -> ctypes.CDLL:
    return bind(load_library("flash_attention"))


def _bwd_library() -> ctypes.CDLL:
    return bind_bwd(load_library("flash_attention_bwd"))


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' types on a loaded build of
    ``csrc/flash_attention_bwd.cu``."""
    if lib.flash_attention_bwd_launch.argtypes is None:
        lib.flash_attention_bwd_launch.argtypes = [
            ctypes.c_int, *[ctypes.c_void_p] * 12,
            *[ctypes.POINTER(ctypes.c_longlong)] * 2, *[ctypes.c_int] * 5,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' types on a loaded build of
    ``csrc/flash_attention.cu``."""
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def bound_flops(q, k, v, *, causal=True) -> int:
    """Operations the two products need on these inputs: D + Dv
    multiply-adds (q k^T, then p v) for each (query, key) pair that is not
    masked, S(S+1)/2 pairs per head when causal, S^2 otherwise."""
    B, H, S, D = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    return 2 * B * H * pairs * (D + v.shape[-1])


def bound_bytes(q, k, v) -> int:
    """Bytes the function must move: q, k, v read once, o (B, H, S, Dv)
    written once."""
    o = q.numel() // q.shape[-1] * v.shape[-1]
    return (q.numel() + k.numel() + v.numel() + o) * q.element_size()


def bound_flops_bwd(q, k, *, causal=True) -> int:
    """Operations the backward's five products need (s and dp recomputed,
    dv, dk, dq): 2.5 times the forward's two, at one head dim."""
    return 5 * bound_flops(q, k, k, causal=causal) // 2


def bound_bytes_bwd(q, k, v) -> int:
    """Bytes the backward must move: q, k, v, o, do and the f32 lse read
    once, dq, dk, dv written once."""
    B, H, S, _ = q.shape
    return ((4 * q.numel() + 2 * k.numel() + 2 * v.numel())
            * q.element_size() + 4 * B * H * S)
