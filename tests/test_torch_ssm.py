"""The port's state-space and recurrent blocks (``repro_torch.models.ssm``:
Mamba2's chunked SSD, mLSTM in its quadratic and chunked forms, sLSTM)
against live runs of the JAX reference on the CPU, at the reduced configs
of zamba2-2.7b and xlstm-350m: each forward, a run of decode steps with
its caches, the caches' layout, and the properties the reference's own
tests hold (chunk-size invariance, chunked mLSTM equal to quadratic).

Weights and inputs come from numpy seeds (``draw_like``) in the layout of
the reference's init (``jax.eval_shape``); the reference runs under
``jax.jit``. Tolerances: f32 atol 1e-5, rtol 1e-4 (the reference's
chunked-against-quadratic contract, tests/test_model_properties.py:149-153)
where one form is held to the same form; bf16 2e-2, the reference's bf16
kernel tolerance (tests/test_kernels.py:26); a form held to another form
at the reference's own tolerance for that pair.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.flatten import (tree_from_leaves, tree_get, tree_map,
                                      tree_paths)
from repro_torch.models import ssm
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401

DTYPES = ("float32", "bfloat16")
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's intra-op threads held at 1 while this module runs: the suite
    runs several files at once on a few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cfgs(reference, arch, dtype="float32", **ssm_change):
    """The reduced config of both packages in ``dtype`` compute (f32
    parameters, as the configs say); ``ssm_change`` edits its SSMConfig."""
    out = []
    for c in (reference.configs.get_config(arch).reduced(),
              get_config(arch).reduced()):
        c = dataclasses.replace(c, dtype=dtype,
                                ssm=dataclasses.replace(c.ssm, **ssm_change))
        out.append(c)
    return out


def draw_like(init, seed):
    """Numpy weights in the layout (and dtypes) of the reference's
    ``init()``, near the init's own values: norm scales and Mamba2's skip
    ``D`` 1 + 0.1 N(0, 1), conv taps 0.5 N(0, 1) (the init's scale), the
    other constant-initialised leaves (biases, ``A_log``) 0.1 N(0, 1) with 3
    added to the forget gates' biases, every matrix 0.02 N(0, 1)."""
    shapes = jax.eval_shape(init)
    rng = np.random.default_rng(seed)
    paths = tree_paths(shapes)
    leaves = []
    for path in paths:
        s = tree_get(shapes, path)
        x, name = rng.normal(size=s.shape), path[-1]
        if name in ("scale", "D"):
            x = 1 + 0.1 * x
        elif name == "conv_w":
            x = 0.5 * x
        elif name in ("conv_b", "A_log", "dt_bias", "gate_bias", "bias"):
            x = 0.1 * x
            n = s.shape[-1]
            if name == "gate_bias":         # mLSTM [input | forget]
                x[..., n // 2:] += 3.0
            elif name == "bias":            # sLSTM [i | f | z | o]
                x[..., n // 4:n // 2] += 3.0
        else:
            x = 0.02 * x
        leaves.append(x.astype(s.dtype))
    return tree_from_leaves(paths, leaves)


def block_params(reference, jc, init: str, seed=0):
    w = draw_like(lambda: getattr(reference.ssm, init)(
        jax.random.PRNGKey(0), jc), seed)
    return w, tree_map(lambda a: torch.from_numpy(np.array(a)), w)


def inputs(shape, dtype, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def close(got, expect, dtype, tol=None):
    atol, rtol = tol or TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(expect, jnp.float32)),
                               atol=atol, rtol=rtol)


def jit_fwd(reference, name, jc):
    return jax.jit(lambda p, x: getattr(reference.ssm, name)(p, x, jc))


# -- Mamba2 ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_fwd_matches_reference(reference, dtype):
    """Two chunks of 32 at the reduced width (d_inner 512: 8 heads of 64;
    d_state 16)."""
    jc, tc = cfgs(reference, "zamba2-2.7b", dtype)
    w, tw = block_params(reference, jc, "init_mamba")
    jx, tx = inputs((2, 64, jc.d_model), dtype, 1)
    ty = ssm.mamba_fwd(tw, tx, tc)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    close(ty, jit_fwd(reference, "mamba_fwd", jc)(w, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode_steps_match_reference(reference, dtype):
    """Six decode steps from a zeroed cache: each output, then the conv
    window and the f32 state, written into the port's cache in place."""
    jc, tc = cfgs(reference, "zamba2-2.7b", dtype)
    w, tw = block_params(reference, jc, "init_mamba", seed=1)
    jcache = reference.ssm.init_mamba_cache(jc, 2)
    tcache = ssm.init_mamba_cache(tc, 2)
    state = tcache["h"]
    step = jax.jit(lambda p, x, c: reference.ssm.mamba_decode_step(p, x, c,
                                                                   jc))
    for i in range(6):
        jx, tx = inputs((2, 1, jc.d_model), dtype, 10 + i)
        jy, jcache = step(w, jx, jcache)
        ty, tcache = ssm.mamba_decode_step(tw, tx, tcache, tc)
        close(ty, jy, dtype)
    assert tcache["h"] is state and tcache["h"].dtype == torch.float32
    for key in ("conv", "h"):
        close(tcache[key], jcache[key], dtype)


@pytest.mark.parametrize("chunks", [(8, 16), (16, 32)])
def test_mamba_chunk_size_invariance(reference, chunks):
    """The port's chunked SSD does not depend on the chunk size (the
    reference's contract, tests/test_model_properties.py:120-134)."""
    jc, _ = cfgs(reference, "zamba2-2.7b")
    _, tw = block_params(reference, jc, "init_mamba", seed=2)
    _, tx = inputs((2, 32, jc.d_model), "float32", 3)
    ys = [ssm.mamba_fwd(tw, 0.5 * tx, cfgs(reference, "zamba2-2.7b",
                                           chunk_size=q)[1])
          for q in chunks]
    torch.testing.assert_close(ys[0], ys[1], atol=1e-4, rtol=1e-3)


def test_mamba_fwd_equals_its_decode(reference):
    """The chunked forward (three chunks) against the recurrence, token by
    token, in f32 (the reference's forward-against-decode tolerance,
    tests/test_models.py:91-94)."""
    jc, tc = cfgs(reference, "zamba2-2.7b")
    _, tw = block_params(reference, jc, "init_mamba", seed=4)
    _, tx = inputs((2, 96, jc.d_model), "float32", 5)
    cache = ssm.init_mamba_cache(tc, 2)
    dec = [ssm.mamba_decode_step(tw, tx[:, t:t + 1], cache, tc)[0]
           for t in range(96)]
    torch.testing.assert_close(torch.cat(dec, 1), ssm.mamba_fwd(tw, tx, tc),
                               atol=6e-3, rtol=1e-2)


def test_mamba_fwd_refuses_a_ragged_length(reference):
    """L must be a multiple of the chunk size (the reference asserts it);
    nothing is padded."""
    jc, tc = cfgs(reference, "zamba2-2.7b")
    _, tw = block_params(reference, jc, "init_mamba")
    _, tx = inputs((1, 40, jc.d_model), "float32", 6)
    with pytest.raises(ValueError, match="multiple of the chunk size 32"):
        ssm.mamba_fwd(tw, tx, tc)


# -- mLSTM -------------------------------------------------------------------

@pytest.mark.parametrize("L,Q", [(64, 16), (96, 32), (128, 64)])
def test_mlstm_forms_match_reference(reference, L, Q):
    """Both forms at the reference's (L, Q) pairs, each against the
    reference's same form, and the chunked against the quadratic at the
    reference's contract (tests/test_model_properties.py:138-153)."""
    jc, tc = cfgs(reference, "xlstm-350m", chunk_size=Q)
    w, tw = block_params(reference, jc, "init_mlstm")
    jx, tx = inputs((2, L, jc.d_model), "float32", 7)
    got = {}
    for name in ("_mlstm_fwd_quadratic", "mlstm_fwd_chunked"):
        got[name] = getattr(ssm, name)(tw, 0.5 * tx, tc)
        close(got[name], jit_fwd(reference, name, jc)(w, 0.5 * jx),
              "float32")
    torch.testing.assert_close(got["mlstm_fwd_chunked"],
                               got["_mlstm_fwd_quadratic"], atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("L,form", [(32, "_mlstm_fwd_quadratic"),
                                    (64, "mlstm_fwd_chunked"),
                                    (80, "_mlstm_fwd_quadratic")])
def test_mlstm_dispatch(reference, L, form):
    """Q = min(chunk_size, 256) = 32 at the reduced config: the chunked form
    for L >= 2Q with L % Q == 0, the quadratic otherwise, bit for bit."""
    jc, tc = cfgs(reference, "xlstm-350m")
    _, tw = block_params(reference, jc, "init_mlstm", seed=1)
    _, tx = inputs((1, L, jc.d_model), "float32", 8)
    assert torch.equal(ssm.mlstm_fwd(tw, tx, tc),
                       getattr(ssm, form)(tw, tx, tc))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_fwd_matches_reference(reference, dtype):
    """The dispatching forward at L = 64 (chunked, two chunks of 32)."""
    jc, tc = cfgs(reference, "xlstm-350m", dtype)
    w, tw = block_params(reference, jc, "init_mlstm", seed=2)
    jx, tx = inputs((2, 64, jc.d_model), dtype, 9)
    ty = ssm.mlstm_fwd(tw, tx, tc)
    assert ty.dtype == tx.dtype
    close(ty, jit_fwd(reference, "mlstm_fwd", jc)(w, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_decode_steps_match_reference(reference, dtype):
    jc, tc = cfgs(reference, "xlstm-350m", dtype)
    w, tw = block_params(reference, jc, "init_mlstm", seed=3)
    jcache = reference.ssm.init_mlstm_cache(jc, 2)
    tcache = ssm.init_mlstm_cache(tc, 2)
    step = jax.jit(lambda p, x, c: reference.ssm.mlstm_decode_step(p, x, c,
                                                                   jc))
    for i in range(6):
        jx, tx = inputs((2, 1, jc.d_model), dtype, 20 + i)
        jy, jcache = step(w, jx, jcache)
        ty, tcache = ssm.mlstm_decode_step(tw, tx, tcache, tc)
        close(ty, jy, dtype)
    for key in ("conv", "C", "n", "m"):
        assert tcache[key].dtype == torch.float32
        close(tcache[key], jcache[key], dtype)


# -- sLSTM -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_fwd_matches_reference(reference, dtype):
    """The token loop over 24 steps: the output and the final carry."""
    jc, tc = cfgs(reference, "xlstm-350m", dtype)
    w, tw = block_params(reference, jc, "init_slstm")
    jx, tx = inputs((2, 24, jc.d_model), dtype, 11)
    jy, jcarry = jax.jit(lambda p, x: reference.ssm.slstm_fwd(p, x, jc))(w,
                                                                        jx)
    ty, tcarry = ssm.slstm_fwd(tw, tx, tc)
    assert ty.dtype == tx.dtype
    close(ty, jy, dtype)
    for got, want in zip(tcarry, jcarry):
        assert got.dtype == torch.float32
        close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_decode_steps_match_reference(reference, dtype):
    jc, tc = cfgs(reference, "xlstm-350m", dtype)
    w, tw = block_params(reference, jc, "init_slstm", seed=1)
    jcache = reference.ssm.init_slstm_cache(jc, 2)
    tcache = ssm.init_slstm_cache(tc, 2)
    step = jax.jit(lambda p, x, c: reference.ssm.slstm_decode_step(p, x, c,
                                                                   jc))
    for i in range(6):
        jx, tx = inputs((2, 1, jc.d_model), dtype, 30 + i)
        jy, jcache = step(w, jx, jcache)
        ty, tcache = ssm.slstm_decode_step(tw, tx, tcache, tc)
        close(ty, jy, dtype)
    for key in ("c", "n", "m", "h"):
        close(tcache[key], jcache[key], dtype)


# -- the caches ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_caches_are_the_reference_layout(reference, kind):
    """Shapes, dtypes (f32 states; Mamba2's conv window in the dtype asked,
    f32 by default) and initial values (m at -1e9), with leading axes; every
    leaf its own storage, since decode writes in place."""
    arch = "zamba2-2.7b" if kind == "mamba" else "xlstm-350m"
    jc, tc = cfgs(reference, arch)
    want = to_numpy_tree(getattr(reference.ssm, f"init_{kind}_cache")(jc, 3))
    got = getattr(ssm, f"init_{kind}_cache")(tc, 3, lead=(2, 5))
    assert tree_paths(got) == tree_paths(want)
    ptrs = set()
    for path in tree_paths(want):
        g, w = tree_get(got, path), tree_get(want, path)
        assert tuple(g.shape) == (2, 5) + w.shape, path
        assert str(g.dtype) == f"torch.{w.dtype.name}", path
        assert bool((g == torch.from_numpy(np.array(w))).all()), path
        ptrs.add(g.data_ptr())
    assert len(ptrs) == len(tree_paths(want))
    if kind == "mamba":
        conv = ssm.init_mamba_cache(tc, 3, dtype=torch.bfloat16)["conv"]
        assert conv.dtype == torch.bfloat16
