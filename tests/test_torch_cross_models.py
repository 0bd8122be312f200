"""The port's cross-attention families of the zoo, whisper-medium (an
encoder over frame embeddings, decoder blocks with self- and
cross-attention) and llama-3.2-vision-11b (groups of self-attention
layers, each followed by a gated cross-attention layer over projected
patches), against live runs of the JAX reference on the CPU at the reduced
configs: configs and parameter trees, ``cross_attn_fwd``,
``whisper_encode``, ``forward`` and the prefill step, ``decode_step``
sequences (whisper's past ``max_decoder_len``) and ``init_cache``,
``loss_fn``'s gradients against ``jax.grad``, the synthetic frames and
patches, and ``serve_decode.run`` against the reference's serving loop.

Weights come from numpy seeds in the reference's layout
(``test_torch_ssm.draw_like``), carried by ``params_from_numpy``. Both
tanh gates of every vision cross layer are set away from their zero init
(``_gates``): at zero a wrong cross-attention would change no logit. The
vision config runs at depth 4 (two groups of one self-attention layer and
one cross layer): the reduced config's depth 2 is one group. The
reference's causal self-attention takes its flash path (``flash_oracle``)
where the port's takes its flash wrapper, except in the gradient test (the
reference trains through ``_sdpa``); the encoder and every
cross-attention take ``_sdpa`` in both. Tolerances: f32 compute 1e-4 (f32
caches in decode), bf16 2e-2 (tests/test_kernels.py:26), greedy tokens
equal in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.flatten import tree_from_leaves, tree_get, tree_paths
from repro_torch.core.pod import make_prefill_step, make_serve_step
from repro_torch.data import synthetic
from repro_torch.launch import serve_decode
from repro_torch.models import attention, transformer
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401
from test_torch_ssm import draw_like, one_thread  # noqa: F401
from test_torch_transformer import flash_oracle  # noqa: F401

ARCHS = ("whisper-medium", "llama-3.2-vision-11b")
DTYPES = ("float32", "bfloat16")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
VISION_LAYERS = 4


def _reduced(cfg, dtype):
    cfg = cfg.reduced()
    if cfg.vision is not None:
        cfg = dataclasses.replace(cfg, n_layers=VISION_LAYERS)
    return dataclasses.replace(cfg, dtype=dtype)


def _cfgs(reference, arch, dtype="float32"):
    return (_reduced(reference.configs.get_config(arch), dtype),
            _reduced(get_config(arch), dtype))


def _gates(w, seed):
    """Both gates of every cross layer set to +-U(0.3, 0.9)."""
    if "cross_layers" in w:
        rng = np.random.default_rng(seed)
        for name in ("gate_attn", "gate_mlp"):
            g = w["cross_layers"][name]
            w["cross_layers"][name] = (
                rng.choice([-1, 1], g.shape) * rng.uniform(0.3, 0.9, g.shape)
            ).astype(g.dtype)
    return w


def _model(reference, arch, dtype="float32", seed=0):
    jc, tc = _cfgs(reference, arch, dtype)
    w = _gates(draw_like(lambda: reference.transformer.init_model(
        jax.random.PRNGKey(0), jc), seed), seed)
    return jc, tc, w, transformer.params_from_numpy(w, tc, device="cpu")


def _inputs(cfg, B, seed):
    """The memory's inputs: whisper's frames or the patches (f32)."""
    rng = np.random.default_rng(seed)
    if cfg.encoder is not None:
        shape = (B, cfg.encoder.n_frames, cfg.d_model)
        return "frames", (rng.normal(size=shape) * 0.5).astype(np.float32)
    shape = (B, cfg.vision.n_patches, cfg.vision.d_vision)
    return "patches", (rng.normal(size=shape) * 0.5).astype(np.float32)


def _ref_memory(reference, w, name, x, jc):
    if name == "frames":
        return reference.transformer.whisper_encode(w, jnp.asarray(x), jc)
    cd = jnp.dtype(jc.dtype)
    return jnp.asarray(x).astype(cd) @ w["vision_proj"].astype(cd)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, expect, dtype, **kw):
    np.testing.assert_allclose(got.float().numpy(), _f32(expect),
                               atol=TOL[dtype], rtol=TOL[dtype], **kw)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


# -- configs and parameter trees ---------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(reference, arch):
    j, t = reference.configs.get_config(arch), get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_gives_the_reference_tree(reference, arch):
    """Full width and depth (meta tensors against shape structs: nothing is
    drawn) and reduced: leaf for leaf, shapes and dtypes, the parameter
    count; the gates start at zero, as in the reference."""
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
    drawn = transformer.init_model(torch.Generator().manual_seed(0), tc)
    if "cross_layers" in drawn:
        for name in ("gate_attn", "gate_mlp"):
            assert not drawn["cross_layers"][name].any()


def test_params_from_numpy_checks_the_new_leaves(reference):
    for arch, path in (("whisper-medium", ("dec_layers", "xattn", "wk")),
                       ("llama-3.2-vision-11b",
                        ("cross_layers", "gate_attn"))):
        jc, tc, w, _ = _model(reference, arch)
        bad = to_numpy_tree(w)
        leaf = tree_get(bad, path)
        tree_get(bad, path[:-1])[path[-1]] = leaf[..., :1]
        with pytest.raises(ValueError, match=".".join(path)):
            transformer.params_from_numpy(bad, tc, device="cpu")
    bad = to_numpy_tree(w)
    del bad["vision_proj"]
    with pytest.raises(ValueError, match="leaves"):
        transformer.params_from_numpy(bad, tc, device="cpu")


# -- cross-attention and the encoder -----------------------------------------

@pytest.mark.parametrize("arch", ARCHS)      # MHA 4/4 and GQA 4/2
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attn_matches_reference(reference, arch, dtype):
    """Full attention of 7 queries over a memory of 11, no mask."""
    jc, tc = _cfgs(reference, arch, dtype)
    assert (tc.n_heads, tc.n_kv_heads) == (
        (4, 4) if arch == "whisper-medium" else (4, 2))
    w = draw_like(lambda: reference.attention.init_cross_attn(
        jax.random.PRNGKey(0), jc, jc.d_model), 1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, jc.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, 11, jc.d_model)).astype(np.float32)
    cd = getattr(jnp, dtype)
    want = reference.attention.cross_attn_fwd(
        w, jnp.asarray(x).astype(cd), jnp.asarray(mem).astype(cd), jc)
    got = attention.cross_attn_fwd(
        {k: torch.from_numpy(v) for k, v in w.items()},
        torch.from_numpy(x).to(getattr(torch, dtype)),
        torch.from_numpy(mem).to(getattr(torch, dtype)), tc)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 7,
                                                                 jc.d_model)
    _close(got, want, dtype)


def test_cross_attn_promotes_a_wider_memory(reference):
    """An f32 memory into a bf16 model: ``jnp`` promotes ``memory @
    wk.astype(bf16)`` to f32, so k, v and the output are f32; the port
    follows (``torch.matmul`` itself refuses two dtypes)."""
    jc, tc = _cfgs(reference, "llama-3.2-vision-11b", "bfloat16")
    w = draw_like(lambda: reference.attention.init_cross_attn(
        jax.random.PRNGKey(0), jc, jc.d_model), 3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, jc.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, 9, jc.d_model)).astype(np.float32)
    want = reference.attention.cross_attn_fwd(
        w, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(mem), jc)
    got = attention.cross_attn_fwd(
        {k: torch.from_numpy(v) for k, v in w.items()},
        torch.from_numpy(x).bfloat16(), torch.from_numpy(mem), tc)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_whisper_encode_matches_reference(reference, dtype):
    """The encoder's non-causal blocks without RoPE over 16 frames with
    their sinusoidal positions (``_sdpa`` in both packages)."""
    jc, tc, w, tp = _model(reference, "whisper-medium", dtype, seed=4)
    _, frames = _inputs(tc, 2, 5)
    want = reference.transformer.whisper_encode(w, jnp.asarray(frames), jc)
    got = transformer.whisper_encode(tp, torch.from_numpy(frames), tc)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    _close(transformer._sinusoid(16, 256, torch.float32),
           reference.transformer._sinusoid(16, 256, jnp.float32), "float32")


# -- forward and decode against the reference -------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(flash_oracle, arch, dtype):
    """Logits, loss and the prefill step's next token over 24 tokens: the
    port's causal self-attention through its flash wrapper once a layer
    (whisper's decoder, the vision groups' self layers), never in the
    encoder or a cross-attention."""
    jc, tc, w, tp = _model(flash_oracle, arch, dtype)
    name, x = _inputs(tc, 2, 6)
    tok, lab = _tokens(tc.vocab_size, (2, 2, 24), 7)
    jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
              name: jnp.asarray(x)}
    tbatch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
              name: torch.from_numpy(x)}
    jlogits, _ = jax.jit(lambda p, b: flash_oracle.transformer.forward(
        p, b, jc))(w, jbatch)
    tlogits, aux = transformer.forward(tp, tbatch, tc)
    n_self = (tc.n_layers if tc.encoder else
              tc.n_layers // tc.vision.cross_attn_every
              * (tc.vision.cross_attn_every - 1))
    assert flash_oracle.calls["port"] == n_self
    assert flash_oracle.calls["reference"] >= 1
    assert tlogits.dtype == getattr(torch, dtype) and float(aux) == 0.0
    _close(tlogits, jlogits, dtype)
    jloss = flash_oracle.transformer._ce(jlogits, jbatch["labels"])
    tloss, _ = transformer.loss_fn(tp, tbatch, tc)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL[dtype])
    tnext = make_prefill_step(tc)(tp, tbatch)
    assert tnext.dtype == torch.int32 and tnext.shape == (2,)
    if dtype == "float32":
        np.testing.assert_array_equal(tnext.numpy(),
                                      np.argmax(_f32(jlogits)[:, -1], -1))


def _decode_both(reference, jc, tc, w, tp, tok, memory_input, dtype,
                 cache_len):
    """Decode ``tok`` token by token in both packages from empty caches
    (f32 caches in f32 compute); returns each step's logits and the final
    caches."""
    name, x = memory_input
    jmem = _ref_memory(reference, w, name, x, jc)
    tmem = transformer.memory_of(tp, {name: torch.from_numpy(x)}, tc)
    B, T = tok.shape
    jcache = reference.transformer.init_cache(jc, B, cache_len)
    if dtype == "float32":
        jcache = jax.tree.map(lambda c: c.astype(jnp.float32), jcache)
    tcache = transformer.init_cache(tc, B, cache_len, device="cpu",
                                    dtype=getattr(torch, dtype))
    step = jax.jit(lambda p, c, t, i, m: reference.transformer.decode_step(
        p, c, t, i, jc, memory=m))
    jl, tl = [], []
    for pos in range(T):
        lj, jcache = step(w, jcache, jnp.asarray(tok[:, pos:pos + 1]),
                          jnp.int32(pos), jmem)
        lt, tcache = transformer.decode_step(
            tp, tcache, torch.from_numpy(tok[:, pos:pos + 1]), pos, tc,
            memory=tmem)
        assert lt.shape == (B, 1, tc.vocab_size)
        jl.append(_f32(lj))
        tl.append(lt.float().numpy())
    return np.concatenate(jl, 1), np.concatenate(tl, 1), jcache, tcache


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_reference(reference, arch, dtype):
    """Six decode steps over the memory from empty caches: each step's
    logits, then the caches after the last."""
    jc, tc, w, tp = _model(reference, arch, dtype, seed=1)
    tok = _tokens(tc.vocab_size, (2, 6), 9)
    jl, tl, jcache, tcache = _decode_both(reference, jc, tc, w, tp, tok,
                                          _inputs(tc, 2, 8), dtype, 8)
    np.testing.assert_allclose(tl, jl, atol=TOL[dtype], rtol=TOL[dtype])
    jn = to_numpy_tree(jax.tree.map(lambda c: c.astype(jnp.float32),
                                    jcache))
    assert tree_paths(tcache) == tree_paths(jn)
    for path in tree_paths(jn):
        np.testing.assert_allclose(tree_get(tcache, path).float().numpy(),
                                   tree_get(jn, path), atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=str(path))


def test_whisper_decodes_past_max_decoder_len(reference):
    """70 steps through a cache of max_decoder_len = 64 positions: past it,
    both packages write the last slot while RoPE positions run on. Each
    step's logits within 1e-4 (f32) and the greedy tokens equal."""
    jc, tc, w, tp = _model(reference, "whisper-medium", seed=2)
    L = tc.encoder.max_decoder_len
    assert L == 64
    tok = _tokens(tc.vocab_size, (2, L + 6), 10)
    jl, tl, jcache, tcache = _decode_both(reference, jc, tc, w, tp, tok,
                                          _inputs(tc, 2, 11), "float32",
                                          L + 40)
    assert tuple(tcache["self"]["k"].shape) == jcache["self"]["k"].shape \
        == (tc.n_layers, 2, L, tc.n_kv_heads, tc.resolved_head_dim)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(reference, arch):
    """Leaf for leaf, shapes, dtypes and zeros against the reference's
    ``init_cache`` (whisper's clamped to max_decoder_len: 100 -> 64);
    ``dtype`` moves every leaf."""
    jc, tc = _cfgs(reference, arch, "bfloat16")
    want = to_numpy_tree(reference.transformer.init_cache(jc, 3, 100))
    got = transformer.init_cache(tc, 3, 100, device="cpu")
    assert tree_paths(got) == tree_paths(want) == [("self", "k"),
                                                   ("self", "v")]
    for path in tree_paths(want):
        g, w = tree_get(got, path), tree_get(want, path)
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype) == f"torch.{w.dtype.name}", path
        assert not g.float().any() and not w.astype(np.float32).any()
    lead = (tc.n_layers,) if tc.encoder else (2, 1)
    assert tuple(got["self"]["k"].shape[:len(lead) + 2]) == (
        *lead, 3, 64 if tc.encoder else 100)
    wide = transformer.init_cache(tc, 3, 100, device="cpu",
                                  dtype=torch.float32)
    assert wide["self"]["v"].dtype == torch.float32


# -- the port against itself --------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_decode(arch):
    """The prompt's forward (flash for causal self-attention) against its
    sequential decode over the caches and the same memory, at every
    position, f32 compute and caches, nonzero gates."""
    cfg = _reduced(get_config(arch), "float32")
    params = transformer.init_model(torch.Generator().manual_seed(1), cfg)
    if "cross_layers" in params:
        params["cross_layers"]["gate_attn"].fill_(0.5)
        params["cross_layers"]["gate_mlp"].fill_(-0.6)
    name, x = _inputs(cfg, 2, 12)
    S = 32
    prompt = torch.randint(0, cfg.vocab_size, (2, S),
                           generator=torch.Generator().manual_seed(2))
    batch = {"tokens": prompt, name: torch.from_numpy(x)}
    with torch.inference_mode():
        full, _ = transformer.forward(params, batch, cfg)
        memory = transformer.memory_of(params, batch, cfg)
        cache = transformer.init_cache(cfg, 2, S, device="cpu",
                                       dtype=torch.float32)
        steps = []
        for i in range(S):
            logits, cache = transformer.decode_step(
                params, cache, prompt[:, i:i + 1], i, cfg, memory=memory)
            steps.append(logits)
    torch.testing.assert_close(torch.cat(steps, 1), full, atol=1e-4,
                               rtol=1e-4)


def test_memory_families_refuse_to_run_without_memory():
    for arch in ARCHS:
        cfg = _reduced(get_config(arch), "float32")
        params = transformer.init_model(torch.Generator().manual_seed(0),
                                        cfg)
        cache = transformer.init_cache(cfg, 1, 4, device="cpu")
        tok = torch.zeros((1, 1), dtype=torch.long)
        with pytest.raises(ValueError, match="memory"):
            transformer.decode_step(params, cache, tok, 0, cfg)
        with pytest.raises(KeyError):
            transformer.forward(params, {"tokens": tok}, cfg)


def _loss_grads(params, batch, cfg):
    paths = tree_paths(params)
    leaves = [tree_get(params, p).clone().requires_grad_() for p in paths]
    loss, _ = transformer.loss_fn(tree_from_leaves(paths, leaves), batch,
                                  cfg)
    return loss, dict(zip(paths, torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax_grad(reference, monkeypatch, arch):
    """``torch.autograd.grad`` of the port's ``loss_fn`` (flash's plain
    backward for the causal self-attention) against ``jax.value_and_grad``
    of the reference's (``_sdpa``) over 16 tokens, f32: every leaf within
    1e-4 of its own largest gradient, the encoder's, the vision
    projection's and the gates' included. Under ``cfg.remat`` the port's
    loss and gradients are the same bit for bit."""
    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    jc, tc, w, tp = _model(reference, arch, seed=3)
    name, x = _inputs(tc, 2, 13)
    tok, lab = _tokens(tc.vocab_size, (2, 2, 16), 14)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: reference.transformer.loss_fn(
            p, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
                name: jnp.asarray(x)}, jc)[0]))(w)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
             name: torch.from_numpy(x)}
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


# -- the synthetic batches ----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_frames_and_patches(reference, arch):
    """The frame (whisper) and patch (vision) branches of the three batch
    makers: the reference's names, shapes and dtypes; draws 0.02 N(0, 1)
    (their spread, not their values: the reference draws threefry); the
    learnable task's zeros and its tokens exactly, given the phases."""
    jc, tc = _cfgs(reference, arch)
    name = "frames" if tc.encoder else "patches"
    want = reference.synthetic.train_batch_shapes(jc, 3, 10)
    got = synthetic.train_batch_shapes(tc, 3, 10)
    assert sorted(got) == sorted(want) == sorted(["tokens", "labels", name])
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype) == f"torch.{want[k].dtype.name}"
        assert got[k].device.type == "meta"
    jb = reference.synthetic.make_train_batch(jax.random.PRNGKey(0), jc, 3,
                                              10)
    tb = synthetic.make_train_batch(torch.Generator().manual_seed(0), tc, 3,
                                    10)
    for k in jb:
        assert tuple(tb[k].shape) == jb[k].shape
        assert str(tb[k].dtype) == f"torch.{jb[k].dtype.name}"
    assert abs(float(tb[name].std()) - 0.02) < 2e-3
    np.testing.assert_array_equal(tb["labels"][:, :-1].numpy(),
                                  tb["tokens"][:, 1:].numpy())
    jl = reference.synthetic.learnable_sequence_batch(jax.random.PRNGKey(1),
                                                      jc, 3, 10)
    phase = np.array(jl["tokens"][:, :1])
    tl = synthetic.learnable_sequence_batch(None, tc, 3, 10,
                                            phase=torch.from_numpy(phase))
    assert sorted(tl) == sorted(jl)
    for k in jl:
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))
        assert str(tl[k].dtype) == f"torch.{jl[k].dtype.name}"


# -- the slice end to end -----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_decode_matches_reference_serving_loop(reference, monkeypatch,
                                                     arch):
    """``serve_decode.run`` on the CPU (f32 compute, bf16 KV caches in both
    packages) against the reference's ``init_cache`` + ``make_serve_step``
    loop from the same weights (nonzero gates), memory and prompt: the
    same tokens. The run's memory is the reference's from the same frames
    (whisper's encoder, f32) or patches (bf16 projection); whisper decodes
    past its 64-position cache."""
    jc, tc, w, tp = _model(reference, arch, seed=5)
    monkeypatch.setattr(serve_decode, "init_model", lambda gen, cfg: tp)
    B, P = 2, 4
    T = 64 if tc.encoder else 5
    res = serve_decode.run(tc, batch=B, prompt_len=P, decode_steps=T,
                           cache_len=P + T, seed=3, device="cpu")
    assert res["tokens"].shape == (B, T) and res["tokens"].dtype == torch.int32
    # the run's draws: its generator gives the memory's input first (the
    # weights are patched in, so nothing is drawn for them)
    gen = torch.Generator().manual_seed(3)
    if tc.encoder:
        frames = 0.02 * torch.randn((B, tc.encoder.n_frames, tc.d_model),
                                    generator=gen)
        jmem = reference.transformer.whisper_encode(
            w, jnp.asarray(frames.numpy()), jc)
        np.testing.assert_allclose(res["memory"].numpy(), np.asarray(jmem),
                                   atol=1e-4, rtol=1e-4)
    else:
        patches = 0.02 * torch.randn(
            (B, tc.vision.n_patches, tc.vision.d_vision), generator=gen)
        jmem = (jnp.asarray(patches.numpy()).astype(jnp.bfloat16)
                @ w["vision_proj"].astype(jnp.bfloat16))
        assert res["memory"].dtype == torch.bfloat16
        _close(res["memory"], jmem, "bfloat16")
    jmem = jnp.asarray(res["memory"].float().numpy()).astype(
        jmem.dtype)
    serve = jax.jit(reference.pod.make_serve_step(jc))
    cache = reference.transformer.init_cache(jc, B, P + T)
    prompt = jnp.asarray(res["prompt"].numpy())
    for i in range(P):
        nxt, cache = serve(w, cache, prompt[:, i:i + 1], jnp.int32(i), jmem)
    out, tok = [], nxt
    for i in range(T):
        tok, cache = serve(w, cache, tok, jnp.int32(P + i), jmem)
        out.append(np.asarray(tok))
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.concatenate(out, axis=1))
    # the serve step takes the memory by keyword too
    step = make_serve_step(tc)
    cache = transformer.init_cache(tc, B, P + T, device="cpu")
    with torch.inference_mode():
        first, _ = step(tp, cache, res["prompt"][:, :1], 0,
                        memory=res["memory"])
    assert first.shape == (B, 1)
