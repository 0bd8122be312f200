"""The port's MoE decoders (arctic-480b; deepseek-v3-671b with MLA, dense
first layers, a shared expert and MTP) against live runs of the JAX
reference on the CPU, at the reduced configs: the MoE layer (its overflow
and tie rules included), MLA prefill and absorbed decode, the whole model's
``forward``, ``decode_step`` and ``loss_fn`` with its gradients,
``serve_decode.run`` against the reference's serving loop, and the bf16
parameter trees that ``params_from_numpy`` carries across.

Weights and inputs come from numpy seeds: a tree of the reference's layout
(``jax.eval_shape`` of its ``init_model``) filled from a numpy generator,
carried to the port by ``params_from_numpy``. The reference runs under
``jax.jit`` (one compilation a test: eagerly, each new shape of each
operation compiles alone, which costs more here). "float32" runs
compute and keep parameters in f32; "bfloat16" runs are the reduced
configs as they are (bf16 compute, bf16 parameters). Tolerances: 1e-4 in
f32, 2e-2 in bf16 (tests/test_kernels.py:26). A prompt's forward and its
decode route alike only when no assignment is dropped, so those
comparisons run at ``capacity_factor=50`` (tests/test_models.py:66-70).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.flatten import (tree_from_leaves, tree_get, tree_map,
                                      tree_paths)
from repro_torch.core.pod import make_prefill_step
from repro_torch.launch import serve_decode
from repro_torch.models import attention, layers, moe, transformer
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401
from test_torch_transformer import _close, _f32, flash_oracle  # noqa: F401

ARCHS = ("arctic-480b", "deepseek-v3-671b")
DTYPES = ("float32", "bfloat16")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
_ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's intra-op threads held at 1 while this module runs: the suite
    runs several files at once on a few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(reference, arch, dtype, **moe_change):
    """The reduced config of both packages: as it is for bf16, in f32
    compute and parameters for f32; ``moe_change`` edits its MoEConfig."""
    out = []
    for c in (reference.configs.get_config(arch).reduced(),
              get_config(arch).reduced()):
        if dtype == "float32":
            c = dataclasses.replace(c, dtype="float32",
                                    param_dtype="float32")
        if moe_change:
            c = dataclasses.replace(
                c, moe=dataclasses.replace(c.moe, **moe_change))
        out.append(c)
    return out


def _draw_like(init, seed):
    """Numpy weights in the layout (and dtypes) of the reference's
    ``init()``: norm scales 1 + 0.1 N(0, 1), every other leaf 0.02 N(0, 1)."""
    shapes = jax.eval_shape(init)
    rng = np.random.default_rng(seed)
    paths = tree_paths(shapes)
    leaves = []
    for path in paths:
        s = tree_get(shapes, path)
        x = rng.normal(size=s.shape)
        x = 1 + 0.1 * x if path[-1] == "scale" else 0.02 * x
        leaves.append(x.astype(s.dtype))
    return tree_from_leaves(paths, leaves)


def _model(reference, arch, dtype, seed=0, **moe_change):
    jc, tc = _cfgs(reference, arch, dtype, **moe_change)
    w = _draw_like(lambda: reference.transformer.init_model(
        jax.random.PRNGKey(0), jc), seed)
    return jc, tc, w, transformer.params_from_numpy(w, tc, device="cpu")


def _torch_tree(w):
    return tree_map(lambda a: transformer._leaf_tensor(a, "cpu"), w)


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


# -- configs and parameter trees --------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_gives_the_reference_tree(reference, arch):
    """Full width (as meta tensors and shape structs: nothing is drawn) and
    reduced: leaf for leaf, shapes and dtypes."""
    for jc, tc in ((reference.configs.get_config(arch), get_config(arch)),
                   _cfgs(reference, arch, "bfloat16")):
        want = jax.eval_shape(
            lambda: reference.transformer.init_model(jax.random.PRNGKey(0),
                                                     jc))
        got = transformer.init_model(None, tc)
        assert tree_paths(got) == tree_paths(want)
        for path in tree_paths(want):
            w, g = tree_get(want, path), tree_get(got, path)
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype) == f"torch.{w.dtype.name}", path
    assert transformer.param_count(got) == sum(
        int(np.prod(tree_get(want, p).shape)) for p in tree_paths(want))


def test_bf16_tree_is_carried_bit_for_bit(reference):
    """A reduced arctic at its own bf16 ``param_dtype``: every leaf arrives
    as bfloat16 with the reference's bits."""
    jc, tc, w, tp = _model(reference, "arctic-480b", "bfloat16")
    assert tc.param_dtype == "bfloat16"
    for path in tree_paths(w):
        got, want = tree_get(tp, path), tree_get(w, path)
        assert got.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16), err_msg=str(path))
    bad = to_numpy_tree(w)
    bad["final_norm"]["scale"] = bad["final_norm"]["scale"].astype(np.float32)
    with pytest.raises(ValueError, match="final_norm.scale"):
        transformer.params_from_numpy(bad, tc, device="cpu")


def test_params_from_numpy_needs_no_ml_dtypes():
    """With ``ml_dtypes`` blocked (the card's machine has none), the port
    imports and carries an f32 MoE tree across."""
    code = (
        "import sys, dataclasses\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.core.flatten import tree_map\n"
        "from repro_torch.models import transformer as T\n"
        "cfg = dataclasses.replace(get_config('deepseek-v3-671b').reduced(),"
        " param_dtype='float32')\n"
        "p = T.init_model(torch.Generator().manual_seed(0), cfg)\n"
        "q = T.params_from_numpy(tree_map(lambda t: t.numpy(), p), cfg,"
        " device='cpu')\n"
        "print(T.param_count(q), 'ml_dtypes' in sys.modules and"
        " sys.modules['ml_dtypes'] is not None)\n")
    env = {**os.environ, "PYTHONPATH": str(_ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    n, loaded = out.stdout.split()
    assert int(n) > 0 and loaded == "False"


def test_dense_init_draws_large_narrow_leaves_in_blocks(monkeypatch):
    """f32 leaves, and narrower ones whose f32 draw fits ``DRAW_LIMIT``,
    are one draw as before; a larger narrow leaf is drawn in blocks into
    its own storage, each block a fresh draw."""
    def draw(shape, dtype):
        return layers.dense_init(torch.Generator().manual_seed(3), shape,
                                 dtype=dtype)
    want = torch.randn((6, 5, 40), generator=torch.Generator().manual_seed(3))
    want = want.mul_(0.02)
    monkeypatch.setattr(layers, "DRAW_LIMIT", 4 * 5 * 40 * 2)
    assert torch.equal(draw((6, 5, 40), torch.float32), want)
    assert torch.equal(draw((2, 5, 40), torch.bfloat16),
                       want[:2].to(torch.bfloat16))
    got = draw((6, 5, 40), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (6, 5, 40)
    assert torch.equal(got[:2], want[:2].to(torch.bfloat16))   # 1st block
    assert not torch.equal(got[2:4], got[:2])
    assert abs(float(got.float().std()) - 0.02) < 2e-3
    # a single leading index over the limit is split further
    monkeypatch.setattr(layers, "DRAW_LIMIT", 4 * 40)
    got = draw((1, 5, 40), torch.bfloat16)
    assert got.shape == (1, 5, 40) and bool(got.ne(0).any(-1).all())
    assert len({tuple(r.tolist()) for r in got[0].float()}) == 5


# -- the MoE layer -----------------------------------------------------------

def _moe_params(reference, jc, seed=0):
    w = _draw_like(lambda: reference.moe.init_moe(
        jax.random.PRNGKey(0), jc, dtype=jnp.dtype(jc.param_dtype)), seed)
    return w, _torch_tree(w)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_fwd_matches_reference(reference, arch, dtype):
    jc, tc = _cfgs(reference, arch, dtype)
    w, tw = _moe_params(reference, jc)
    jx, tx = _x((2, 13, jc.d_model), dtype, 1)
    jy, jaux = jax.jit(lambda p, x: reference.moe.moe_fwd(p, x, jc))(w, jx)
    ty, taux = moe.moe_fwd(tw, tx, tc)
    assert ty.dtype == tx.dtype and taux.dtype == torch.float32
    _close(ty, jy, TOL[dtype])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4)


def test_capacity_overflow_empties_slot_zero(reference):
    """T=16 tokens all routed to expert 0 of 2 (k=1) at C=11: the
    reference's last write leaves slot 0 empty (token 16, gate 0), and the
    first token loses its expert. Then a reduced arctic at
    ``capacity_factor`` 0.5 (C = 8 for 26 tokens on 4 experts) against the
    reference: the same drops."""
    ids = torch.zeros((16, 1), dtype=torch.int64)
    gates = torch.linspace(0.5, 1.0, 16)[:, None]
    table, gate_table, count, slot = moe.dispatch(ids, gates, 2, 11)
    assert table[0].tolist() == [16] + list(range(1, 11))
    assert table[1].tolist() == [16] * 11
    assert gate_table[0, 0] == 0 and gate_table[0, 1] == gates[1, 0]
    assert count.tolist() == [16, 0]
    assert slot[:, 0].tolist() == [22] + list(range(1, 11)) + [22] * 5

    jc, tc = _cfgs(reference, "arctic-480b", "float32", capacity_factor=0.5)
    w, tw = _moe_params(reference, jc, seed=2)
    jx, tx = _x((2, 13, jc.d_model), "float32", 3)
    stats = moe.dispatch_stats(tw, tx, tc)
    assert stats["capacity"] == 8 and stats["tokens"] == 26
    assert int(stats["over_capacity"]) > 0 and int(stats["slot0_emptied"]) > 0
    jy, jaux = jax.jit(lambda p, x: reference.moe.moe_fwd(p, x, jc))(w, jx)
    ty, taux = moe.moe_fwd(tw, tx, tc)
    _close(ty, jy, TOL["float32"])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4)


def test_router_ties_go_to_the_lower_expert(reference):
    """Router columns 1, 2 and 3 equal: a token whose top is that column
    takes [1, 2], one whose top is column 0 takes [0, 1] (the tie at the
    k-th place to the lower index), as ``jax.lax.top_k``; the layer's
    output agrees with the reference's."""
    jc, tc = _cfgs(reference, "arctic-480b", "float32", capacity_factor=50.0)
    w, tw = _moe_params(reference, jc, seed=4)
    r = w["router"].copy()
    r[:, 2] = r[:, 3] = r[:, 1]
    w["router"] = r
    tw["router"] = torch.from_numpy(r.copy())
    jx, tx = _x((2, 13, jc.d_model), "float32", 5)
    _, _, ids = moe.route(tw["router"], tx.reshape(26, -1), 2)
    _, jids = jax.lax.top_k(jax.nn.softmax(
        jx.reshape(26, -1) @ jnp.asarray(r), axis=-1), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    rows = {tuple(row) for row in ids.tolist()}
    assert rows == {(1, 2), (0, 1)}
    jy, _ = jax.jit(lambda p, x: reference.moe.moe_fwd(p, x, jc))(w, jx)
    ty, _ = moe.moe_fwd(tw, tx, tc)
    _close(ty, jy, TOL["float32"])


# -- MLA ---------------------------------------------------------------------

def _mla_params(reference, jc, seed):
    w = _draw_like(lambda: reference.attention.init_mla(
        jax.random.PRNGKey(0), jc, dtype=jnp.dtype(jc.param_dtype)), seed)
    return w, _torch_tree(w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_prefill_matches_reference(reference, monkeypatch, dtype):
    """The port's prefill (v zero-padded through the flash wrapper) against
    the reference's ``_sdpa`` path (``REPRO_USE_FLASH`` unset)."""
    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    jc, tc = _cfgs(reference, "deepseek-v3-671b", dtype)
    w, tw = _mla_params(reference, jc, 0)
    jx, tx = _x((2, 13, jc.d_model), dtype, 6)
    pos = np.broadcast_to(np.arange(13), (2, 13))
    jy, _ = jax.jit(lambda p, x, i: reference.attention.mla_fwd(
        p, x, jc, i))(w, jx, jnp.asarray(pos))
    ty, cache = attention.mla_fwd(tw, tx, tc, torch.from_numpy(pos.copy()))
    assert cache is None and ty.shape == (2, 13, jc.d_model)
    _close(ty, jy, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_absorbed_decode_matches_reference(reference, dtype):
    jc, tc = _cfgs(reference, "deepseek-v3-671b", dtype)
    w, tw = _mla_params(reference, jc, 1)
    jcache = reference.attention.init_mla_cache(jc, 2, 10)
    tcache = attention.init_mla_cache(tc, 2, 10)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    step = jax.jit(lambda p, x, i, c, at: reference.attention.mla_fwd(
        p, x, jc, i, cache=c, cache_pos=at))
    for pos in range(7):
        jx, tx = _x((2, 1, jc.d_model), dtype, 10 + pos)
        jy, jcache = step(w, jx, jnp.full((2, 1), pos), jcache,
                          jnp.int32(pos))
        ty, tcache = attention.mla_fwd(tw, tx, tc, torch.full((2, 1), pos),
                                       cache=tcache, cache_pos=pos)
        _close(ty, jy, TOL[dtype])
    for key in ("c", "k_rope"):
        _close(tcache[key], jcache[key], TOL[dtype])


# -- the whole model ---------------------------------------------------------

class _Routes:
    """Each MoE call's routing in both packages, in call order: the
    reference's f32 router logits and top-k ids (recorded around its
    ``moe_fwd`` by an ordered debug callback, which runs under jit) and
    the port's ids (around ``moe.route``)."""

    def __init__(self, reference, monkeypatch):
        self.ref, self.port = [], []
        real_fwd, real_route = reference.transformer.moe_fwd, moe.route

        def ref_fwd(p, x, cfg):
            xt = x.reshape(-1, x.shape[-1])
            logits = (xt @ p["router"].astype(x.dtype)).astype(jnp.float32)
            _, ids = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.moe.top_k)
            jax.debug.callback(
                lambda a, b: self.ref.append((np.asarray(a), np.asarray(b))),
                logits, ids, ordered=True)
            return real_fwd(p, x, cfg)

        def port_route(router, xt, k):
            out = real_route(router, xt, k)
            self.port.append(out[2].numpy())
            return out
        monkeypatch.setattr(reference.transformer, "moe_fwd", ref_fwd)
        monkeypatch.setattr(moe, "route", port_route)

    def flipped(self, tol: float) -> list:
        """Per MoE call, the tokens whose chosen experts differ between the
        packages; each must be a near tie of the reference's own, its k-th
        and (k+1)-th logits within ``tol``."""
        jax.effects_barrier()           # the callbacks run asynchronously
        assert len(self.ref) == len(self.port) > 0
        out = []
        for (logits, jids), tids in zip(self.ref, self.port):
            k = jids.shape[1]
            rows = np.nonzero((np.sort(jids, 1) != np.sort(tids, 1)).any(1))[0]
            top = -np.sort(-logits, axis=1)
            assert np.all(top[rows, k - 1] - top[rows, k] <= tol), rows
            out.append(rows)
        return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_and_loss_match_reference(flash_oracle, monkeypatch, arch,
                                          dtype):
    """Logits, the aux loss (MTP's included for deepseek-v3) and the loss
    with labels; the prefill step's next token. Both packages' prefill
    attention goes through their flash wrapper. In bf16 a router whose k-th
    and (k+1)-th logits lie within the tolerance may choose unlike the
    reference (their inputs differ by bf16 rounding); such a flip is
    allowed there alone, at ``capacity_factor`` 50 (no drop, so a flip
    reaches only its own sequence's later positions, which are left out of
    the logits' comparison)."""
    change = {} if dtype == "float32" else {"capacity_factor": 50.0}
    jc, tc, w, tp = _model(flash_oracle, arch, dtype, **change)
    routes = _Routes(flash_oracle, monkeypatch)
    rng = np.random.default_rng(7)
    B, S = 2, 19
    tok = rng.integers(0, jc.vocab_size, size=(B, S))
    lab = rng.integers(0, jc.vocab_size, size=(B, S))
    jlogits, jaux = jax.jit(lambda p, b: flash_oracle.transformer.forward(
        p, b, jc))(w, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
    jloss = flash_oracle.transformer._ce(jlogits, jnp.asarray(lab)) + jaux
    tbatch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    tlogits, aux = transformer.forward(tp, tbatch, tc)
    assert flash_oracle.calls["port"] == tc.n_layers + tc.mtp_depth
    assert tlogits.dtype == getattr(torch, dtype)
    n_moe = tc.n_layers - tc.moe.first_dense_layers
    flips = routes.flipped(TOL[dtype])[:n_moe]        # the trunk's layers
    keep = np.ones((B, S), bool)
    for rows in flips:
        for t in rows:
            keep[t // S, t % S:] = False
    if dtype == "float32":
        assert keep.all()
    assert keep.mean() > 0.5
    np.testing.assert_allclose(tlogits.float().numpy()[keep],
                               _f32(jlogits)[keep], atol=TOL[dtype],
                               rtol=TOL[dtype])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL[dtype])
    if tc.mtp_depth:                    # the MTP loss is most of this aux
        _, router_aux = transformer.forward(tp, {"tokens": tbatch["tokens"]},
                                            tc)
        assert float(aux) > 10 * float(router_aux) > 0
    tloss, _ = transformer.loss_fn(tp, tbatch, tc)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL[dtype])
    tnext = make_prefill_step(tc)(tp, tbatch)
    assert tnext.dtype == torch.int32 and tnext.shape == (B,)
    if dtype == "float32":
        np.testing.assert_array_equal(
            tnext.numpy(), np.argmax(_f32(jlogits)[:, -1], -1))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_reference(reference, monkeypatch, arch, dtype):
    """Five decode steps from an empty cache; the logits of each step and
    the caches after the last. A bf16 router flip at a near tie (see
    ``test_forward_and_loss_match_reference``) ends the comparison of its
    sequence."""
    jc, tc, w, tp = _model(reference, arch, dtype, seed=1)
    routes = _Routes(reference, monkeypatch)
    jcache = reference.transformer.init_cache(jc, 2, 8)
    tcache = transformer.init_cache(tc, 2, 8, device="cpu")
    assert tree_paths(tcache) == tree_paths(to_numpy_tree(jcache))
    tok = np.random.default_rng(8).integers(0, jc.vocab_size, size=(2, 5))
    live = np.ones(2, bool)
    step = jax.jit(lambda p, c, t, i: reference.transformer.decode_step(
        p, c, t, i, jc))
    for pos in range(5):
        jl, jcache = step(w, jcache, jnp.asarray(tok[:, pos:pos + 1]),
                          jnp.int32(pos))
        tl, tcache = transformer.decode_step(
            tp, tcache, torch.from_numpy(tok[:, pos:pos + 1]), pos, tc)
        assert tl.shape == (2, 1, jc.vocab_size)
        n_moe = tc.n_layers - tc.moe.first_dense_layers
        for rows in routes.flipped(TOL[dtype])[-n_moe:]:
            live[rows] = False
        assert live.any() and (dtype == "bfloat16" or live.all())
        np.testing.assert_allclose(tl.float().numpy()[live], _f32(jl)[live],
                                   atol=TOL[dtype], rtol=TOL[dtype])
    if live.all():
        for path in tree_paths(tcache):
            _close(tree_get(tcache, path), tree_get(jcache, path),
                   TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_decode_when_nothing_is_dropped(arch):
    """At ``capacity_factor=50`` the prompt's forward (flash) and its
    sequential decode (cache) route every token alike: last-position logits
    within 1e-4 in f32 with an f32 cache."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              param_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=50.0))
    params = transformer.init_model(torch.Generator().manual_seed(9), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (2, 11),
                           generator=torch.Generator().manual_seed(10))
    with torch.inference_mode():
        lf, _ = transformer.forward(params, {"tokens": prompt}, cfg)
        cache = transformer.init_cache(cfg, 2, 11, device="cpu",
                                       dtype=torch.float32)
        for i in range(11):
            ld, cache = transformer.decode_step(params, cache,
                                                prompt[:, i:i + 1], i, cfg)
    torch.testing.assert_close(ld[:, -1], lf[:, -1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_decode_matches_reference_serving_loop(reference, monkeypatch,
                                                     arch):
    """``serve_decode.run`` on the CPU (f32) against the reference's own
    ``init_cache`` + ``make_serve_step`` loop from the same weights and
    prompt: the same tokens."""
    jc, tc, w, tp = _model(reference, arch, "float32", seed=2)
    monkeypatch.setattr(serve_decode, "init_model", lambda gen, cfg: tp)
    B, P, T, L = 2, 4, 4, 8
    res = serve_decode.run(tc, batch=B, prompt_len=P, decode_steps=T,
                           cache_len=L, seed=3, device="cpu")
    assert res["tokens"].shape == (B, T) and res["tokens"].dtype == torch.int32
    serve = jax.jit(reference.pod.make_serve_step(jc))
    cache = reference.transformer.init_cache(jc, B, L)
    prompt = jnp.asarray(res["prompt"].numpy())
    for i in range(P):
        nxt, cache = serve(w, cache, prompt[:, i:i + 1], jnp.int32(i))
    out, tok = [], nxt
    for i in range(T):
        tok, cache = serve(w, cache, tok, jnp.int32(P + i))
        out.append(np.asarray(tok))
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.concatenate(out, axis=1))


def _loss_grads(params, batch, cfg):
    paths = tree_paths(params)
    leaves = [tree_get(params, p).clone().requires_grad_() for p in paths]
    loss, m = transformer.loss_fn(tree_from_leaves(paths, leaves), batch, cfg)
    return loss, m, dict(zip(paths, torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax_grad(reference, monkeypatch, arch):
    """``torch.autograd.grad`` of the port's ``loss_fn`` (aux and MTP
    losses included) against ``jax.value_and_grad`` of the reference's
    (attention through ``_sdpa``), f32, every leaf within 1e-4 of its own
    largest gradient."""
    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    jc, tc, w, tp = _model(reference, arch, "float32", seed=3)
    rng = np.random.default_rng(11)
    tok = rng.integers(0, jc.vocab_size, size=(2, 12))
    lab = rng.integers(0, jc.vocab_size, size=(2, 12))
    (jloss, jm), jgrad = jax.jit(jax.value_and_grad(
        lambda p: reference.transformer.loss_fn(
            p, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}, jc),
        has_aux=True))(w)
    loss, m, grads = _loss_grads(tp, {"tokens": torch.from_numpy(tok),
                                      "labels": torch.from_numpy(lab)}, tc)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"].detach()), float(jm["aux"]),
                               rtol=1e-4)
    jg = to_numpy_tree(jgrad)
    assert sorted(grads) == tree_paths(jg)
    for path, g in grads.items():
        want = tree_get(jg, path)
        scale = np.abs(want).max()
        assert scale > 0, path
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=str(path))


def test_remat_carries_the_aux_loss(reference):
    """Under ``cfg.remat`` each layer is recomputed in the backward; the
    loss, its MoE aux loss and the gradients stay as they were."""
    _, tc, _, tp = _model(reference, "arctic-480b", "float32", seed=4)
    tok, lab = np.random.default_rng(12).integers(0, tc.vocab_size,
                                                  size=(2, 2, 9))
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    loss, m, grads = _loss_grads(tp, batch, tc)
    rloss, rm, rgrads = _loss_grads(tp, batch,
                                    dataclasses.replace(tc, remat=True))
    assert float(m["aux"]) > 0 and rm["aux"].item() == m["aux"].item()
    assert rloss.item() == loss.item()
    for path in grads:
        torch.testing.assert_close(rgrads[path], grads[path], rtol=0, atol=0)
