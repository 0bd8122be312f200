"""Online scores (paper eqs. 19-21, 34-35) on parameter trees, and the tree
arithmetic the loop servers are built from (``repro/core/scores.py``).

Exact scores: lambda_u = (chi + cos(d_mean, d_u)) / (chi + 1), Delta_u =
lambda_u. Every tree op returns new tensors and never writes in place: the
loop servers start with one tree shared by all U buffer slots.

Sketched scores (``sketch_tree``, ``lambda_scores_sketched``,
``sketch_stacked``): the same formula on a k-dim count-sketch of each
update (bucket ``j % k`` after a random sign flip), an unbiased
inner-product estimator that cuts the score's memory from O(N) to O(k).
The reference draws its signs with jax's threefry inside the jitted step;
the port draws them on the leaf's device from Philox-4x32-10 counters
(``src/repro_torch/core/philox.py``): sign j of leaf i under the server's
``sketch_key`` words is bit j % 128 of the Philox block (j // 128, leaf
i, a tag) under that key, so the card and the CPU compute the same bits,
every round flips the same signs, and a resumed run (its ``sketch_key``
in the snapshot) keeps them. They are drawn once per key and leaf and
kept as int8 +-1 (``sketch_signs_int8``), which the sketches multiply into
their f32 sums as they are; ``sketch_signs`` gives them in float32. The
two packages' signs are equal in distribution, not bit for bit; fed the
same signs, the sketches agree.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.flatten import tree_get, tree_map, tree_paths
from repro_torch.core.philox import MASK32, philox4x32


def _logical_sum(terms: dict, layout, like: torch.Tensor) -> torch.Tensor:
    """The sum over the logical tree of per-leaf terms (path -> 0-d or
    (k,) tensor), each leaf's term of this rank's shard: the whole leaves'
    in sorted-key order plus the model-summed split leaves' (each whole
    leaf counted once, not once a column)."""
    whole = torch.zeros_like(like)
    split = torch.zeros_like(like)
    for p, t in terms.items():
        if layout.split(p):
            split = split + t
        else:
            whole = whole + t
    return whole + layout.axis.sum(split)


def tree_dot(a, b, layout=None) -> torch.Tensor:
    """Sum of f32 dot products over the leaves, in sorted-key order (the
    reference's leaf order); a 0-d tensor. With ``layout`` (a
    ``launch/sharding.ModelLayout``), ``a`` and ``b`` are this rank's
    shards and the dot is the logical trees'."""
    terms = {p: torch.vdot(tree_get(a, p).reshape(-1).float(),
                           tree_get(b, p).reshape(-1).float())
             for p in tree_paths(a)}
    if layout is None:
        return sum(terms.values())
    return _logical_sum(terms, layout, next(iter(terms.values())))


def tree_norm(a, layout=None) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a, layout))


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def cosine(a, b, eps: float = 1e-12) -> torch.Tensor:
    return tree_dot(a, b) / torch.clamp(tree_norm(a) * tree_norm(b), min=eps)


def lambda_scores(updates: Sequence, chi: float = 1.0) -> np.ndarray:
    """Paper eqs. 19-21: d_mean = (1/U) sum_u d_u; lambda in [0, 1]. Each
    lambda is computed in f32 on the updates' device, as the reference
    computes it, and the U of them reach the host in one copy."""
    U = len(updates)
    d_mean = tree_scale(updates[0], 1.0 / U)
    for d in updates[1:]:
        d_mean = tree_add(d_mean, tree_scale(d, 1.0 / U))
    lam = torch.stack([(chi + cosine(d_mean, d)) / (chi + 1.0)
                       for d in updates])
    return lam.cpu().numpy().astype(np.float64)



# salt of the sign streams (ASCII "skt"), a Philox counter word, so they
# share no counter with any other draw
_SKETCH_TAG = 0x736B74
# column block of the sign-flipped sums: bounds the transient copy to
# about 2**26 elements (256 MB of f32) whatever the buffer's size; the
# signs are drawn in blocks of as many
_BLOCK_ELEMS = 1 << 26
_SIGNS_PER_CALL = 128           # one Philox call: four 32-bit words


@functools.lru_cache(maxsize=64)
def _signs_cached(k0: int, k1: int, i: int, n: int,
                  device: str) -> torch.Tensor:
    """The (n,) int8 +-1 signs of leaf ``i`` under key words (k0, k1),
    drawn on ``device``: sign j is 1 - 2 * (bit j % 128 of the Philox
    output of counter (j // 128 low word, high word, i, tag)), the output
    taken as four little-endian 32-bit words."""
    dev = torch.device(device)
    out = torch.empty(n, dtype=torch.int8, device=dev)
    byte_shift = torch.arange(0, 32, 8, dtype=torch.int64, device=dev)
    bit_shift = torch.arange(8, dtype=torch.uint8, device=dev)
    calls = -(-n // _SIGNS_PER_CALL)
    step = _BLOCK_ELEMS // _SIGNS_PER_CALL
    for c0 in range(0, calls, step):
        c = torch.arange(c0, min(calls, c0 + step), dtype=torch.int64,
                         device=dev)
        words = torch.stack(philox4x32(
            (c & MASK32, c >> 32, torch.full_like(c, i),
             torch.full_like(c, _SKETCH_TAG)), (k0, k1)), dim=1)
        octets = ((words[:, :, None] >> byte_shift) & 0xFF).to(torch.uint8)
        bits = (octets[..., None] >> bit_shift) & 1        # (m, 4, 4, 8)
        lo = c0 * _SIGNS_PER_CALL
        hi = min(n, lo + bits.numel())
        out[lo:hi] = (1 - 2 * bits.to(torch.int8)).view(-1)[:hi - lo]
    return out


def sketch_signs_int8(key, i: int, n: int, device="cpu") -> torch.Tensor:
    """The (n,) int8 +-1 signs of leaf ``i`` under ``key`` (the (2,)
    uint32 ``sketch_key`` words), drawn on ``device`` once and kept there:
    what the sketches multiply by. Fixed per (key, leaf, n): a server whose
    key never advances flips the same signs every round."""
    k = np.asarray(key, np.uint32).reshape(-1)
    return _signs_cached(int(k[0]), int(k[1]), int(i), int(n),
                         str(torch.device(device)))


def sketch_signs(key, i: int, n: int, device="cpu") -> torch.Tensor:
    """``sketch_signs_int8`` as (n,) float32 +-1 (a new tensor; the cache
    holds the int8 signs)."""
    return sketch_signs_int8(key, i, n, device).float()


def _bucket_sums(mat: torch.Tensor, signs: torch.Tensor, k: int
                 ) -> torch.Tensor:
    """(R, N) rows -> (R, k): ``out[r, b] = sum_{j % k == b} s_j x[r, j]``
    in f32. The whole buckets are summed as a strided (R, N // k, k) view
    in row blocks, and the ragged tail (``N % k`` columns, buckets
    ``0 .. N % k - 1``) apart, so no padded or sign-flipped (R, N) copy is
    made. ``signs`` (+-1, int8 or float) enter the elementwise product as
    they are: an int8 sign is promoted inside it, exactly."""
    R, N = mat.shape
    full = N - N % k
    out = torch.zeros((R, k), dtype=torch.float32, device=mat.device)
    if full:
        sgn = signs[:full].view(full // k, k)
        step = max(1, _BLOCK_ELEMS // max(full, 1))
        for r0 in range(0, R, step):
            blk = mat[r0:r0 + step, :full].float().view(-1, full // k, k)
            out[r0:r0 + step] = (blk * sgn).sum(dim=1)
    if full < N:
        out[:, :N - full] += mat[:, full:].float() * signs[full:N]
    return out


def sketch_tree(tree, key, k: int, signs: Optional[Sequence] = None,
                layout=None) -> torch.Tensor:
    """k-dim count-sketch of a parameter tree: each leaf (in sorted-key
    order) flattened, its entries sign-flipped and summed into bucket
    ``j % k``. ``signs`` (one (n_i,) vector per leaf) replaces the drawn
    signs (``sketch_signs_int8(key, i, n_i)``). With ``layout``, ``tree``
    is this rank's shards and the sketch is the logical tree's: a split
    leaf's entries take the signs and buckets of their indices j in the
    whole leaf, and the split leaves' sums are model-summed."""
    out, terms = None, {}
    for i, p in enumerate(tree_paths(tree)):
        leaf = tree_get(tree, p)
        n = leaf.numel() if layout is None else math.prod(layout.shapes[p])
        sg = (sketch_signs_int8(key, i, n, leaf.device)
              if signs is None else torch.as_tensor(
                  signs[i], dtype=torch.float32, device=leaf.device))
        if layout is not None and layout.split(p):
            j = layout.flat_index(p, leaf.device)
            part = torch.zeros(k, dtype=torch.float32, device=leaf.device)
            part.index_add_(0, j % k, sg[j] * leaf.reshape(-1).float())
        else:
            part = _bucket_sums(leaf.reshape(1, -1), sg, k)[0]
        if layout is not None:
            terms[p] = part
        else:
            out = part if out is None else out + part
    if layout is not None:
        return _logical_sum(terms, layout, next(iter(terms.values())))
    return out


def lambda_scores_sketched(sketches: torch.Tensor, chi: float = 1.0
                           ) -> np.ndarray:
    """sketches: (U, k). The exact scores' formula on the sketches, in
    f32."""
    mean = torch.mean(sketches, dim=0)
    dots = sketches @ mean
    norms = (torch.linalg.vector_norm(sketches, dim=1)
             * torch.linalg.vector_norm(mean))
    cos = dots / torch.clamp(norms, min=1e-12)
    return ((chi + cos) / (chi + 1.0)).cpu().numpy()


def sketch_stacked(mat: torch.Tensor, key, k: int,
                   signs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Count-sketch every row of a stacked (U, N) update matrix at once:
    ``sketch_tree``'s single-leaf case (leaf 0's signs), (U, k) in f32.
    ``signs`` ((N,) or longer) replaces the drawn signs."""
    N = mat.shape[1]
    sg = (sketch_signs_int8(key, 0, N, mat.device) if signs is None
          else torch.as_tensor(signs, dtype=torch.float32,
                               device=mat.device))
    return _bucket_sums(mat, sg, k)
