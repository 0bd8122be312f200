"""Online scores (paper eqs. 19-21, 34-35) on parameter trees, and the tree
arithmetic the loop servers are built from (``repro/core/scores.py``).

Exact scores: lambda_u = (chi + cos(d_mean, d_u)) / (chi + 1), Delta_u =
lambda_u. Every tree op returns new tensors and never writes in place: the
loop servers start with one tree shared by all U buffer slots.

Sketched scores (``sketch_tree``, ``lambda_scores_sketched``,
``sketch_stacked``): the same formula on a k-dim count-sketch of each
update (bucket ``j % k`` after a random sign flip), an unbiased
inner-product estimator that cuts the score's memory from O(N) to O(k).
The reference draws its signs with jax's threefry; the port draws them
from a CPU ``torch.Generator`` seeded from the server's ``sketch_key``
words and the leaf index (``sketch_signs``), once per key and leaf, so the
card and the CPU see one stream and every round the same signs. The two
packages' signs are equal in distribution, not bit for bit; fed the same
signs, the sketches agree.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.flatten import tree_get, tree_map, tree_paths


def tree_dot(a, b) -> torch.Tensor:
    """Sum of f32 dot products over the leaves, in sorted-key order (the
    reference's leaf order); a 0-d tensor."""
    return sum(torch.vdot(tree_get(a, p).reshape(-1).float(),
                          tree_get(b, p).reshape(-1).float())
               for p in tree_paths(a))


def tree_norm(a) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


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



# salt of the sign streams (ASCII "skt"), so they share no seed with the
# request noise or the host draws
_SKETCH_TAG = 0x736B74
# column block of the sign-flipped sums: bounds the transient copy to
# about 2**26 elements (256 MB of f32) whatever the buffer's size
_BLOCK_ELEMS = 1 << 26


@functools.lru_cache(maxsize=64)
def _signs_cached(k0: int, k1: int, i: int, n: int,
                  device: str) -> torch.Tensor:
    seed = np.random.SeedSequence([_SKETCH_TAG, k0, k1, i]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(seed))
    bits = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int8)
    return (bits.float() * 2.0 - 1.0).to(device)


def sketch_signs(key, i: int, n: int, device="cpu") -> torch.Tensor:
    """The (n,) float32 +-1 signs of leaf ``i`` under ``key`` (the (2,)
    uint32 ``sketch_key`` words), drawn on the CPU and kept on ``device``.
    Fixed per (key, leaf, n): a server whose key never advances flips the
    same signs every round."""
    k = np.asarray(key, np.uint32).reshape(-1)
    return _signs_cached(int(k[0]), int(k[1]), int(i), int(n),
                         str(torch.device(device)))


def _bucket_sums(mat: torch.Tensor, signs: torch.Tensor, k: int
                 ) -> torch.Tensor:
    """(R, N) rows -> (R, k): ``out[r, b] = sum_{j % k == b} s_j x[r, j]``
    in f32. The whole buckets are summed as a strided (R, N // k, k) view
    in row blocks, and the ragged tail (``N % k`` columns, buckets
    ``0 .. N % k - 1``) apart, so no padded or sign-flipped (R, N) copy is
    made."""
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


def sketch_tree(tree, key, k: int, signs: Optional[Sequence] = None
                ) -> torch.Tensor:
    """k-dim count-sketch of a parameter tree: each leaf (in sorted-key
    order) flattened, its entries sign-flipped and summed into bucket
    ``j % k``. ``signs`` (one (n_i,) vector per leaf) replaces the drawn
    signs (``sketch_signs(key, i, n_i)``)."""
    out = None
    for i, p in enumerate(tree_paths(tree)):
        flat = tree_get(tree, p).reshape(1, -1)
        sg = (sketch_signs(key, i, flat.shape[1], flat.device)
              if signs is None else torch.as_tensor(
                  signs[i], dtype=torch.float32, device=flat.device))
        part = _bucket_sums(flat, sg, k)[0]
        out = part if out is None else out + part
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
    sg = (sketch_signs(key, 0, N, mat.device) if signs is None
          else torch.as_tensor(signs, dtype=torch.float32,
                               device=mat.device))
    return _bucket_sums(mat, sg, k)
