"""OSAFL score reduction (paper eqs. 19-20): the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/scored_reduce.py``
(``_scored_kernel``, launched by ``scored_reduce``). One pass over the
stacked contribution buffer ``d`` (U, N) and the mean (N,) gives

    dots[u] = <d_u, mean>,  norms[u] = ||d_u||^2,  mean_sq = ||mean||^2

in f32. The kernel (``csrc/scored_reduce.cu``) is bound by the bytes of
``d`` it must read from device memory; its source says how the design
keeps them streaming. ``scored_reduce`` launches it for a CUDA tensor and
raises if it cannot; only a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Grid sizing: about 16 waves of 8 resident 256-thread blocks on each of the
# H100's 132 SMs, so the last wave's tail stays small; chunks are whole
# multiples of 1024 elements (one sweep of 256 threads x 16 bytes of f32).
_TARGET_BLOCKS = 132 * 8 * 16
_CHUNK_QUANTUM = 1024
_MIN_CHUNK = 2048
_MAX_ROWS = 65535               # grid.y limit


def scored_reduce_plain(d: torch.Tensor, mean: torch.Tensor):
    """The same function in plain torch ops, in f32."""
    d32, m32 = d.float(), mean.float()
    return d32 @ m32, (d32 ** 2).sum(1), (m32 ** 2).sum()


def _check(d: torch.Tensor, mean: torch.Tensor) -> None:
    if d.dim() != 2 or mean.dim() != 1 or mean.shape[0] != d.shape[1]:
        raise ValueError(f"scored_reduce needs d (U, N) and mean (N,); got "
                         f"{tuple(d.shape)} and {tuple(mean.shape)}")
    if d.shape[0] < 1 or d.shape[1] < 1:
        raise ValueError(f"scored_reduce needs U, N >= 1; got "
                         f"{tuple(d.shape)}")
    if d.dtype not in _DTYPE_CODE:
        raise TypeError(f"scored_reduce takes float32 or bfloat16 d, "
                        f"got {d.dtype}")
    if mean.dtype != torch.float32:
        raise TypeError(f"scored_reduce takes a float32 mean, got "
                        f"{mean.dtype}")
    if d.device != mean.device:
        raise ValueError(f"d is on {d.device} but mean on {mean.device}")


def _grid(U: int, N: int) -> tuple:
    """(chunk, nchunks): columns per block and blocks per row."""
    want = max(1, -(-_TARGET_BLOCKS // U))
    chunk = -(-N // want)
    chunk = max(_MIN_CHUNK, -(-chunk // _CHUNK_QUANTUM) * _CHUNK_QUANTUM)
    return chunk, -(-N // chunk)


def scored_reduce(d: torch.Tensor, mean: torch.Tensor):
    """d (U, N) f32|bf16, mean (N,) f32 -> (dots (U,), norms (U,), mean_sq ())
    in f32. Launches the CUDA kernel for CUDA tensors; a CPU tensor takes
    ``scored_reduce_plain``."""
    _check(d, mean)
    if d.device.type == "cpu":
        return scored_reduce_plain(d, mean)
    if d.device.type != "cuda":
        raise ValueError(f"scored_reduce runs on cuda or cpu, not {d.device}")
    if not (d.is_contiguous() and mean.is_contiguous()):
        raise ValueError("scored_reduce needs contiguous d and mean")
    U, N = d.shape
    if U > _MAX_ROWS:
        raise ValueError(f"scored_reduce takes at most {_MAX_ROWS} rows, "
                         f"got {U}")
    chunk, nchunks = _grid(U, N)
    lib = _library()
    part = torch.empty((2 * U + 1, nchunks), dtype=torch.float32,
                       device=d.device)
    out = torch.empty(2 * U + 1, dtype=torch.float32, device=d.device)
    dots, norms, msq = out[:U], out[U:2 * U], out[2 * U:]
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = lib.scored_reduce_launch(
            _DTYPE_CODE[d.dtype], d.data_ptr(), mean.data_ptr(), U, N, chunk,
            nchunks, part.data_ptr(), dots.data_ptr(), norms.data_ptr(),
            msq.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("scored_reduce kernel launch failed: "
                           + lib.scored_reduce_error_string(err).decode())
    scored_reduce.launches += 1
    return dots, norms, msq[0]


scored_reduce.launches = 0      # kernel launches so far (plain calls excluded)


def _library() -> ctypes.CDLL:
    lib = load_library("scored_reduce")
    if lib.scored_reduce_launch.argtypes is None:
        lib.scored_reduce_launch.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.scored_reduce_launch.restype = ctypes.c_int
        lib.scored_reduce_error_string.argtypes = [ctypes.c_int]
        lib.scored_reduce_error_string.restype = ctypes.c_char_p
        lib.scored_reduce_prepare.argtypes = []
        lib.scored_reduce_prepare.restype = ctypes.c_int
    return lib


def prepare(device) -> None:
    """Build and load the kernel library, and load its kernels on the CUDA
    ``device``, without launching anything: what a CUDA graph capture of a
    path through ``scored_reduce`` needs done before it starts (the build
    may run ``nvcc``; the loads are host calls a capture cannot hold)."""
    lib = _library()
    with torch.cuda.device(device):
        err = lib.scored_reduce_prepare()
    if err != 0:
        raise RuntimeError("scored_reduce kernels failed to load: "
                           + lib.scored_reduce_error_string(err).decode())


def osafl_scores_fused(d: torch.Tensor, chi: float = 1.0) -> torch.Tensor:
    """Scored weights from stacked updates d (U, N):
    lambda_u = (chi + cos(d_u, mean)) / (chi + 1)."""
    mean = torch.mean(d, dim=0).float()
    dots, norms, msq = scored_reduce(d, mean)
    cos = dots / torch.clamp(torch.sqrt(norms) * torch.sqrt(msq), min=1e-12)
    return (chi + cos) / (chi + 1.0)


def bound_bytes(d: torch.Tensor) -> int:
    """Bytes the reduction must move: d and mean read once, 2U+1 f32
    results written once."""
    U, N = d.shape
    return U * N * d.element_size() + N * 4 + (2 * U + 1) * 4


def bound_flops(d: torch.Tensor) -> int:
    """Operations on these inputs: a multiply-add for the dot and one for
    the norm per element of d, one for mean_sq per element of the mean."""
    U, N = d.shape
    return 4 * U * N + 2 * N
