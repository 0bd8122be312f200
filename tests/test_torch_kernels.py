"""The port's scored_reduce wrapper and its plain version against the
Pallas kernel (interpret mode) and the JAX oracle, and the Python around
the CUDA kernel that the CPU can reach (input checks, grid sizing)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.scored_reduce import osafl_scores_fused as j_scores
from repro.kernels.scored_reduce import scored_reduce as j_scored_reduce
from repro_torch.kernels import ops, ref
from repro_torch.kernels import scored_reduce as sr

SHAPES = [(4, 1000, 256), (16, 4096, 1024), (8, 131, 64), (2, 17, 2048)]
# the reference kernel test's tolerances (tests/test_kernels.py)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(U, N, dtype, seed=0):
    """The same f32 numpy draw, cast to ``dtype`` by each framework."""
    d32 = np.random.default_rng(seed).normal(size=(U, N)).astype(np.float32)
    jd = jnp.asarray(d32).astype(getattr(jnp, dtype))
    td = torch.from_numpy(d32).to(getattr(torch, dtype))
    return jd, td


@pytest.mark.parametrize("U,N,block", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scored_reduce_matches_pallas_and_reference(U, N, block, dtype):
    jd, td = _inputs(U, N, dtype)
    # bf16 inputs are bit-identical in both frameworks
    np.testing.assert_array_equal(np.asarray(jd.astype(jnp.float32)),
                                  td.float().numpy())
    jmean = jnp.mean(jd.astype(jnp.float32), axis=0)
    tmean = torch.from_numpy(np.array(jmean))
    launches = sr.scored_reduce.launches
    got = [x.numpy() for x in sr.scored_reduce(td, tmean)]
    assert sr.scored_reduce.launches == launches    # CPU: plain version
    plain = [x.numpy() for x in sr.scored_reduce_plain(td, tmean)]
    pallas = j_scored_reduce(jd, jmean, block_n=block)
    oracle = jref.scored_reduce_reference(jd, jmean)
    tol = TOL[dtype]
    for a, b, c, e in zip(got, plain, pallas, oracle):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, np.asarray(c), rtol=tol, atol=tol)
        np.testing.assert_allclose(a, np.asarray(e), rtol=tol, atol=tol)


@pytest.mark.parametrize("U,N", [(8, 5000), (1, 17), (7, 131)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_osafl_scores_match_pallas_and_reference(U, N, dtype):
    jd, td = _inputs(U, N, dtype, seed=3)
    tol = 1e-5 if dtype == "float32" else 3e-2
    fused = sr.osafl_scores_fused(td, chi=1.0).numpy()
    np.testing.assert_allclose(fused, np.asarray(j_scores(jd, chi=1.0)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(ref.osafl_scores_reference(td).numpy(),
                               np.asarray(jref.osafl_scores_reference(jd)),
                               rtol=tol, atol=tol)
    np.testing.assert_array_equal(ops.osafl_scores(td).numpy(), fused)


def test_ops_fused_scored_reduce_is_the_wrapper():
    _, td = _inputs(3, 40, "float32")
    mean = td.mean(0)
    for a, b in zip(ops.fused_scored_reduce(td, mean),
                    sr.scored_reduce(td, mean)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("d,mean,err", [
    (torch.zeros(3, 4), torch.zeros(5), ValueError),         # N mismatch
    (torch.zeros(4), torch.zeros(4), ValueError),            # d not 2-D
    (torch.zeros(0, 4), torch.zeros(4), ValueError),         # U = 0
    (torch.zeros(3, 4, dtype=torch.float64), torch.zeros(4), TypeError),
    (torch.zeros(3, 4), torch.zeros(4, dtype=torch.bfloat16), TypeError),
])
def test_wrapper_rejects_bad_inputs(d, mean, err):
    with pytest.raises(err):
        sr.scored_reduce(d, mean)


@pytest.mark.parametrize("U,N", [(1, 17), (3, 131), (17, 4099), (16, 18_404),
                                 (1, 3_821_156), (256, 3_821_156),
                                 (65535, 2048)])
def test_grid_covers_every_column_once(U, N):
    chunk, nchunks = sr._grid(U, N)
    assert chunk % 8 == 0 and chunk >= sr._MIN_CHUNK
    assert (nchunks - 1) * chunk < N <= nchunks * chunk
    if N >= 132 * sr._MIN_CHUNK:
        assert U * nchunks >= 132          # even one client fills the SMs


def test_bound_counts_at_the_main_path_shape():
    d = torch.empty((256, 3_821_156), dtype=torch.float32, device="meta")
    # 3.91 GB of d, the mean once, 2U+1 results
    assert sr.bound_bytes(d) == 256 * 3_821_156 * 4 + 3_821_156 * 4 + 513 * 4
    assert sr.bound_flops(d) == 4 * 256 * 3_821_156 + 2 * 3_821_156
