"""The port's recurrent families of the zoo, zamba2-2.7b (Mamba2 groups with
one shared attention block) and xlstm-350m (mLSTM groups, each followed by
an sLSTM block), against live runs of the JAX reference on the CPU at the
reduced configs: configs and parameter trees, ``forward`` and the prefill
step, ``decode_step`` sequences and ``init_cache``, ``loss_fn``'s
gradients against ``jax.grad``, ``serve_decode.run`` against the
reference's serving loop, and the port's forward against its own decode.

Weights come from numpy seeds in the reference's layout
(``test_torch_ssm.draw_like``), carried by ``params_from_numpy``. The
reference's shared attention block takes its flash path (``REPRO_USE_FLASH``
routed to the kernel's oracle, ``flash_oracle``) where the port's takes
its flash wrapper, except in the gradient test (the reference trains
through ``_sdpa``). Tolerances: f32 compute 1e-4 (f32 caches in decode);
forward against decode atol 6e-3, rtol 1e-2 (tests/test_models.py:91-94).
In bf16 each package's logits lie 0.09-0.14 from the f32 logits over 8
recurrent blocks (the reference's own bf16 run included), so there the
port is held to be no farther from the f32 logits than the reference is,
with a quarter's headroom (``BF16_HEADROOM``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.flatten import tree_from_leaves, tree_get, tree_paths
from repro_torch.core.pod import make_prefill_step
from repro_torch.kernels import ops
from repro_torch.launch import serve_decode
from repro_torch.models import transformer
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401
from test_torch_ssm import draw_like, one_thread  # noqa: F401
from test_torch_transformer import flash_oracle  # noqa: F401

ARCHS = ("zamba2-2.7b", "xlstm-350m")
BF16_HEADROOM = 1.25


def _cfgs(reference, arch, dtype="float32"):
    return [dataclasses.replace(c, dtype=dtype) for c in (
        reference.configs.get_config(arch).reduced(),
        get_config(arch).reduced())]


def _model(reference, arch, dtype="float32", seed=0):
    jc, tc = _cfgs(reference, arch, dtype)
    w = draw_like(lambda: reference.transformer.init_model(
        jax.random.PRNGKey(0), jc), seed)
    return jc, tc, w, transformer.params_from_numpy(w, tc, device="cpu")


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _bf16_as_close_as_reference(port_bf16, ref_bf16, ref_f32):
    """The port's bf16 logits no farther from the f32 logits than the
    reference's bf16 logits are, with ``BF16_HEADROOM``."""
    ref_err = np.abs(ref_bf16 - ref_f32).max()
    port_err = np.abs(port_bf16 - ref_f32).max()
    assert 0 < port_err <= BF16_HEADROOM * ref_err, (port_err, ref_err)


# -- configs and parameter trees ---------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(reference, arch):
    j, t = reference.configs.get_config(arch), get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_gives_the_reference_tree(reference, arch):
    """Full width (meta tensors against shape structs: nothing is drawn) and
    reduced: leaf for leaf, shapes and dtypes, and the parameter count."""
    for jc, tc in ((reference.configs.get_config(arch), get_config(arch)),
                   _cfgs(reference, arch)):
        want = jax.eval_shape(lambda: reference.transformer.init_model(
            jax.random.PRNGKey(0), jc))
        got = transformer.init_model(None, tc)
        assert tree_paths(got) == tree_paths(want)
        for path in tree_paths(want):
            w, g = tree_get(want, path), tree_get(got, path)
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype) == f"torch.{w.dtype.name}", path
        assert transformer.param_count(got) == sum(
            int(np.prod(tree_get(want, p).shape)) for p in tree_paths(want))


@pytest.mark.parametrize("n_layers,slstm_every,groups", [
    (2, 8, (1, 7)), (24, 8, (3, 7)), (12, 8, (1, 7)), (5, 0, (1, 5))])
def test_xlstm_group_arithmetic(reference, n_layers, slstm_every, groups):
    """The reference's arithmetic, kept: max(1, n_layers // slstm_every)
    groups of slstm_every - 1 mLSTM blocks and one sLSTM block each (the
    reduced config's n_layers 2 gives 7 + 1 blocks, 12 layers give 8
    blocks); without slstm_every one group of n_layers mLSTM blocks."""
    jc, tc = (dataclasses.replace(
        c, n_layers=n_layers,
        ssm=dataclasses.replace(c.ssm, slstm_every=slstm_every))
        for c in _cfgs(reference, "xlstm-350m"))
    assert transformer._xlstm_groups(tc) == groups
    got = transformer.init_model(None, tc)
    want = jax.eval_shape(lambda: reference.transformer.init_model(
        jax.random.PRNGKey(0), jc))
    assert tuple(got["mlstm_layers"]["ln"]["scale"].shape) == (
        *groups, tc.d_model) == want["mlstm_layers"]["ln"]["scale"].shape
    assert ("slstm_layers" in got) == ("slstm_layers" in want) == bool(
        slstm_every)
    if slstm_every:
        assert tuple(got["slstm_layers"]["s"]["r"].shape[:1]) == groups[:1]
    caches = transformer.init_cache(tc, 2, 4, device="cpu")
    assert tuple(caches["mlstm"]["C"].shape[:2]) == groups


def test_params_from_numpy_checks_the_recurrent_leaves(reference):
    jc, tc, w, _ = _model(reference, "zamba2-2.7b")
    bad = to_numpy_tree(w)
    bad["mamba_layers"]["m"]["A_log"] = bad["mamba_layers"]["m"]["A_log"][0]
    with pytest.raises(ValueError, match="mamba_layers.m.A_log"):
        transformer.params_from_numpy(bad, tc, device="cpu")
    bad = to_numpy_tree(w)
    del bad["shared_block"]["mlp"]
    with pytest.raises(ValueError, match="leaves"):
        transformer.params_from_numpy(bad, tc, device="cpu")


# -- forward and decode against the reference -------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(flash_oracle, arch):
    """Logits, loss and the prefill step's next token over 64 tokens (two
    chunks of the SSD and of the chunked mLSTM) in f32 compute; the bf16
    run no farther from the f32 logits than the reference's bf16 run. The
    port's shared block goes through its flash wrapper once a group;
    xLSTM has no attention."""
    ref, port = {}, {}
    tok = _tokens(512, (2, 64), 7)
    lab = _tokens(512, (2, 64), 8)
    for dtype in ("float32", "bfloat16"):
        jc, tc, w, tp = _model(flash_oracle, arch, dtype)
        jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
        tbatch = {"tokens": torch.from_numpy(tok),
                  "labels": torch.from_numpy(lab)}
        before = flash_oracle.calls["port"]
        jlogits, _ = jax.jit(lambda p, b: flash_oracle.transformer.forward(
            p, b, jc))(w, jbatch)
        tlogits, aux = transformer.forward(tp, tbatch, tc)
        assert tlogits.dtype == getattr(torch, dtype) and float(aux) == 0.0
        n_attn = (tc.n_layers // tc.hybrid.shared_attn_every
                  if tc.hybrid else 0)
        assert flash_oracle.calls["port"] - before == n_attn
        ref[dtype], port[dtype] = _f32(jlogits), tlogits.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(port[dtype], ref[dtype], atol=1e-4,
                                       rtol=1e-4)
            jloss = flash_oracle.transformer._ce(jlogits, jbatch["labels"])
            tloss, _ = transformer.loss_fn(tp, tbatch, tc)
            np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
            np.testing.assert_array_equal(
                make_prefill_step(tc)(tp, tbatch).numpy(),
                np.argmax(ref[dtype][:, -1], -1))
    _bf16_as_close_as_reference(port["bfloat16"], ref["bfloat16"],
                                ref["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(reference, arch):
    """Five decode steps from empty caches. f32 compute with f32 caches in
    both packages: each step's logits and the caches after the last within
    1e-4. bf16 compute with bf16 KV caches (the recurrent states stay f32):
    each step no farther from the f32 run than the reference's bf16 run."""
    tok = _tokens(512, (2, 5), 9)
    ref, port = {}, {}
    for dtype in ("float32", "bfloat16"):
        jc, tc, w, tp = _model(reference, arch, dtype, seed=1)
        cache_dtype = getattr(torch, dtype)
        jcache = jax.tree.map(
            lambda c: c.astype(jnp.float32) if c.dtype == jnp.bfloat16
            and dtype == "float32" else c,
            reference.transformer.init_cache(jc, 2, 8))
        tcache = transformer.init_cache(tc, 2, 8, device="cpu",
                                        dtype=cache_dtype)
        step = jax.jit(lambda p, c, t, i: reference.transformer.decode_step(
            p, c, t, i, jc))
        ref[dtype], port[dtype] = [], []
        for pos in range(5):
            jl, jcache = step(w, jcache, jnp.asarray(tok[:, pos:pos + 1]),
                              jnp.int32(pos))
            tl, tcache = transformer.decode_step(
                tp, tcache, torch.from_numpy(tok[:, pos:pos + 1]), pos, tc)
            assert tl.shape == (2, 1, tc.vocab_size)
            ref[dtype].append(_f32(jl))
            port[dtype].append(tl.float().numpy())
        if dtype == "float32":
            np.testing.assert_allclose(np.stack(port[dtype]),
                                       np.stack(ref[dtype]), atol=1e-4,
                                       rtol=1e-4)
            jn = to_numpy_tree(jcache)
            assert tree_paths(tcache) == tree_paths(jn)
            for path in tree_paths(jn):
                np.testing.assert_allclose(
                    tree_get(tcache, path).numpy(), tree_get(jn, path),
                    atol=1e-4, rtol=1e-4, err_msg=str(path))
    _bf16_as_close_as_reference(*(np.stack(x) for x in (
        port["bfloat16"], ref["bfloat16"], ref["float32"])))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(reference, arch):
    """Leaf for leaf, shapes, dtypes and initial values against the
    reference's ``init_cache`` (bf16 KV caches, f32 recurrent states, m at
    -1e9); ``dtype`` moves the KV caches alone."""
    jc, tc = _cfgs(reference, arch, "bfloat16")
    want = to_numpy_tree(reference.transformer.init_cache(jc, 3, 16))
    got = transformer.init_cache(tc, 3, 16, device="cpu")
    assert tree_paths(got) == tree_paths(want)
    for path in tree_paths(want):
        g, w = tree_get(got, path), tree_get(want, path)
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype) == f"torch.{w.dtype.name}", path
        np.testing.assert_array_equal(g.float().numpy(),
                                      w.astype(np.float32), err_msg=str(path))
    wide = transformer.init_cache(tc, 3, 16, device="cpu",
                                  dtype=torch.float32)
    for path in tree_paths(want):
        moved = tree_get(wide, path).dtype != tree_get(got, path).dtype
        assert moved == (path[0] == "attn"), path


# -- the port against itself --------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [32, 64])
def test_forward_equals_decode(arch, S):
    """The prompt's forward (chunked SSD and flash; the quadratic mLSTM at
    32 tokens, the chunked one at 64) against its sequential decode over
    the caches, at every position, f32 compute and caches (the reference's
    own contract, tests/test_models.py:59-95)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = transformer.init_model(torch.Generator().manual_seed(1), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (2, S),
                           generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        full, _ = transformer.forward(params, {"tokens": prompt}, cfg)
        cache = transformer.init_cache(cfg, 2, S, device="cpu",
                                       dtype=torch.float32)
        steps = []
        for i in range(S):
            logits, cache = transformer.decode_step(
                params, cache, prompt[:, i:i + 1], i, cfg)
            steps.append(logits)
    torch.testing.assert_close(torch.cat(steps, 1), full, atol=6e-3,
                               rtol=1e-2)


def test_zamba_prefill_refuses_a_ragged_prompt():
    cfg = get_config("zamba2-2.7b").reduced()
    params = transformer.init_model(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="chunk size"):
        transformer.forward(params, {"tokens": torch.zeros((1, 40),
                                                           dtype=torch.long)},
                            cfg)


def _loss_grads(params, batch, cfg):
    paths = tree_paths(params)
    leaves = [tree_get(params, p).clone().requires_grad_() for p in paths]
    loss, _ = transformer.loss_fn(tree_from_leaves(paths, leaves), batch,
                                  cfg)
    return loss, dict(zip(paths, torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax_grad(reference, monkeypatch, arch):
    """``torch.autograd.grad`` of the port's ``loss_fn`` (flash's plain
    backward for the shared block) against ``jax.value_and_grad`` of the
    reference's (attention through ``_sdpa``) over 64 tokens, f32: every
    leaf within 1e-4 of its own largest gradient. Under ``cfg.remat`` the
    port's loss and gradients are the same bit for bit."""
    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    jc, tc, w, tp = _model(reference, arch, seed=3)
    tok, lab = _tokens(512, (2, 2, 64), 11)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: reference.transformer.loss_fn(
            p, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            jc)[0]))(w)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    loss, grads = _loss_grads(tp, batch, tc)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jg = to_numpy_tree(jgrad)
    assert sorted(grads) == tree_paths(jg)
    for path, g in grads.items():
        want = tree_get(jg, path)
        scale = np.abs(want).max()
        assert scale > 0, path
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=str(path))
    rloss, rgrads = _loss_grads(tp, batch, dataclasses.replace(tc,
                                                               remat=True))
    assert rloss.item() == loss.item()
    for path in grads:
        torch.testing.assert_close(rgrads[path], grads[path], rtol=0, atol=0)


# -- the slice end to end -----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_decode_matches_reference_serving_loop(reference, monkeypatch,
                                                     arch):
    """``serve_decode.run`` on the CPU (f32 compute, bf16 KV caches in both
    packages) against the reference's ``init_cache`` + ``make_serve_step``
    loop from the same weights and prompt: the same tokens."""
    jc, tc, w, tp = _model(reference, arch, seed=2)
    monkeypatch.setattr(serve_decode, "init_model", lambda gen, cfg: tp)
    B, P, T, L = 2, 4, 5, 12
    launches = ops.flash_attention_bhsd.launches
    res = serve_decode.run(tc, batch=B, prompt_len=P, decode_steps=T,
                           cache_len=L, seed=3, device="cpu")
    assert ops.flash_attention_bhsd.launches == launches
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
