"""Philox-4x32-10 (Salmon et al., SC'11), the counter-based generator of
cuRAND and torch, written in int64 tensor ops with 32-bit masks: each
output word is a pure function of (key, counter), with no generator state,
so the CPU and the card compute the same bits and a CUDA graph can replay
the draws. The fused round's draws (``core/round_fused.py``) and the
count-sketch signs (``core/scores.py``) are made from it."""
from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_PHILOX_ROUNDS = 10


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product of 32-bit words ``a``
    (int64 tensor) and ``m``: the product is taken in 16-bit halves of
    ``m``, so no partial product leaves int64."""
    p_lo = a * (m & 0xFFFF)                   # < 2**48
    p_hi = a * (m >> 16)                      # < 2**48
    s = p_lo + ((p_hi & 0xFFFF) << 16)        # < 2**49
    return (p_hi >> 16) + (s >> 32), s & MASK32


def philox4x32(counter, key) -> Tuple[torch.Tensor, ...]:
    """Philox-4x32-10 of four int64 tensors of 32-bit counter words under a
    key of two 32-bit ints: four int64 tensors of output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(_PHILOX_ROUNDS):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & MASK32
            k1 = (k1 + _PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3
