"""Flash attention (causal or not, grouped-query): the CUDA kernel's wrapper
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel``, launched by ``flash_attention_bhsd``). q (B, H, S, D),
k and v (B, Hkv, S, D), H a multiple of Hkv, query head h reading kv head
``h // (H // Hkv)``; f32 math with an online softmax, output in q's dtype,
``scale`` defaulting to D ** -0.5. ``csrc/flash_attention.cu`` holds three
kernels and its entry point picks one by (dtype, D) alone: bf16 with
D <= 128 takes the Hopper kernel (TMA, mbarriers, warp-specialised
``wgmma``), bf16 with D > 128 an ``mma.sync`` kernel, f32 a CUDA-core one.
The source says what each design does about its bound (operations, at the
serving path's prefill shape). ``flash_attention_bhsd`` launches it for
CUDA tensors and raises if it cannot; only CPU tensors take
``flash_attention_plain``. ``flash_attention_bhsd.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load_library

NEG_INF = -1e30                 # the TPU kernel's mask value
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
_MAX_BATCH_HEADS = 65535        # grid.y limit
_MAX_STRIDE_BYTES = 1 << 40     # a TMA tensor map's stride limit


def flash_attention_plain(q, k, v, *, causal=True, scale=None):
    """The same function in plain torch: f32 math, q scaled before the dot,
    masked scores -1e30, output divided by max(l, 1e-30), cast to q's dtype.
    One batch row at a time, so the (H, S, S) scores of one row are the
    largest temporary; kv heads are broadcast over their query group, never
    repeated in memory."""
    _check(q, k, v)
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    keep = None
    if causal:
        pos = torch.arange(S, device=q.device)
        keep = pos[:, None] >= pos[None, :]
    for b in range(B):
        qb = q[b].float().reshape(Hkv, H // Hkv, S, D) * scale
        s = qb @ k[b].float()[:, None].transpose(-1, -2)    # (Hkv, G, S, S)
        if keep is not None:
            s = torch.where(keep, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = s.sub_(m).exp_()
        den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        o = (p @ v[b].float()[:, None]) / den
        out[b] = o.reshape(H, S, D).to(q.dtype)
    return out


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash attention needs q (B, H, S, D) and k, v "
                         f"(B, Hkv, S, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D)
            or Hkv < 1 or H % Hkv):
        raise ValueError(f"flash attention needs k, v (B, Hkv, S, D) with H "
                         f"a multiple of Hkv; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if B < 1 or S < 1:
        raise ValueError(f"flash attention needs B, S >= 1; got "
                         f"{tuple(q.shape)}")
    if D % 8 or not 8 <= D <= _MAX_HEAD_DIM:
        raise ValueError(f"flash attention takes a head dim D that is a "
                         f"multiple of 8 from 8 to {_MAX_HEAD_DIM}; got {D}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")


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


def flash_attention_bhsd(q, k, v, *, causal=True, scale=None, out=None):
    """q (B, H, S, D); k, v (B, Hkv, S, D) -> (B, H, S, D) in q's dtype.
    Launches the CUDA kernel for CUDA tensors; CPU tensors take
    ``flash_attention_plain``. ``out``, if given, is a (B, H, S, D) tensor
    (any strides the kernel can write) that receives the result."""
    _check(q, k, v)
    B, H, S, D = q.shape
    scale = D ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        res = flash_attention_plain(q, k, v, causal=causal, scale=scale)
        return res if out is None else out.copy_(res)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    if B * H > _MAX_BATCH_HEADS:
        raise ValueError(f"flash attention takes B * H <= "
                         f"{_MAX_BATCH_HEADS}; got {B * H}")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.shape != q.shape or out.dtype != q.dtype or out.device != q.device:
        raise ValueError(f"out must be a {q.dtype} tensor of shape "
                         f"{tuple(q.shape)} on {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_layout(name, x)
    strides = (ctypes.c_longlong * 12)(
        *(st for x in (q, k, v, out) for st in x.stride()[:3]))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), strides, B, H, k.shape[1], S, D, scale,
            int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError("flash attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0   # kernel launches so far (plain excluded)


def _library() -> ctypes.CDLL:
    return bind(load_library("flash_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' types on a loaded build of
    ``csrc/flash_attention.cu``."""
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def bound_flops(q, k, *, causal=True) -> int:
    """Operations the two products need on these inputs: 2 D multiply-adds
    for each (query, key) pair that is not masked, S(S+1)/2 pairs per head
    when causal, S^2 otherwise."""
    B, H, S, D = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4 * B * H * D * pairs


def bound_bytes(q, k, v) -> int:
    """Bytes the function must move: q, k, v read once, o written once."""
    return (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
