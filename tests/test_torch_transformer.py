"""The port's dense-decoder serving slice against a live run of the JAX
reference on the CPU: configs, layers, GQA prefill and decode, the whole
``forward`` and a ``decode_step`` sequence on imported weights, and
``serve_decode.run`` against the reference's own serving loop.

On the reference side ``REPRO_USE_FLASH=1`` sends causal prefill attention
to ``repro.kernels.ops.flash_attention``, which these tests point at the
kernel's oracle ``mha_reference`` (the Pallas kernel does not run on this
jax: ``pl.load`` is gone). The port has no switch: its causal prefill
always takes the flash wrapper, whose plain version runs on the CPU.

Tolerances: float32 configs agree to 1e-4 (f32 sums in another order; the
KV cache is bf16 in both packages); bfloat16 configs to 2e-2, the
reference's bf16 kernel tolerance (tests/test_kernels.py:26).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import SSMConfig, get_config
from repro_torch.configs.base import EncoderConfig, VisionConfig
from repro_torch.core.pod import make_prefill_step
from repro_torch.kernels import ops
from repro_torch.launch import serve_decode
from repro_torch.models import attention, layers, transformer
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _variants(cfg):
    """The reduced config (4 heads over 2 kv heads) and one that keeps the
    full model's odd 7:1 grouping (14 over 2)."""
    small = cfg.reduced()
    return {"reduced": small,
            "group7": dataclasses.replace(small, n_heads=14, n_kv_heads=2,
                                          d_model=448)}


def _cfgs(reference, arch, variant, dtype):
    jc = _variants(reference.configs.get_config(arch))[variant]
    tc = _variants(get_config(arch))[variant]
    return (dataclasses.replace(jc, dtype=dtype),
            dataclasses.replace(tc, dtype=dtype))


@pytest.fixture
def flash_oracle(reference, monkeypatch):
    """The reference's flash path, routed to the kernel's oracle; counts the
    calls of both packages' model-layout flash wrappers in ``.calls``."""
    calls = {"reference": 0, "port": 0}

    def flash(q, k, v, *, causal=True, scale=None):
        calls["reference"] += 1
        t = (0, 2, 1, 3)
        out = reference.ref.mha_reference(q.transpose(t), k.transpose(t),
                                          v.transpose(t), causal=causal,
                                          scale=scale)
        return out.transpose(t)

    port_flash = ops.flash_attention

    def port_spy(*args, **kw):
        calls["port"] += 1
        return port_flash(*args, **kw)
    monkeypatch.setenv("REPRO_USE_FLASH", "1")
    monkeypatch.setattr(reference.ops, "flash_attention", flash)
    monkeypatch.setattr(ops, "flash_attention", port_spy)
    reference.calls = calls
    yield reference
    del reference.calls


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, expect, tol):
    np.testing.assert_allclose(got.float().numpy(), _f32(expect), atol=tol,
                               rtol=tol)


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "qwen1.5-4b",
                                  "nemotron-4-15b", "arctic-480b",
                                  "deepseek-v3-671b"])
def test_configs_match_reference(reference, arch):
    j, t = reference.configs.get_config(arch), get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.resolved_head_dim == j.resolved_head_dim


def test_unported_architectures_raise():
    """Every architecture of the zoo builds now, the audio and vision
    families (whisper, llama-3.2-vision) included; an attention kind other
    than GQA or MLA outside xLSTM is refused, in every family."""
    for arch in ("whisper-medium", "llama-3.2-vision-11b"):
        cfg = get_config(arch)
        assert transformer.param_count(transformer.init_model(None, cfg)) > 0
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-model")
    dense = get_config("deepseek-coder-33b").reduced()
    for change in (dict(), dict(encoder=EncoderConfig()),
                   dict(vision=VisionConfig())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            transformer.init_model(None, dataclasses.replace(
                dense, attention="none", **change))
    # a Mamba2 SSMConfig without the hybrid config is a plain decoder, as
    # in the reference's dispatch
    plain = dataclasses.replace(dense, ssm=SSMConfig())
    assert set(transformer.init_model(None, plain)) == set(
        transformer.init_model(None, dense))


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_rope_match_reference(reference, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    bias = rng.normal(size=(32,)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) * 37, (2, 9))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = TOL[dtype]
    _close(layers.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-5),
           reference.layers.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-5),
           tol)
    _close(layers.layernorm({"scale": torch.from_numpy(scale),
                             "bias": torch.from_numpy(bias)}, tx),
           reference.layers.layernorm({"scale": jnp.asarray(scale),
                                       "bias": jnp.asarray(bias)}, jx), tol)
    _close(layers.apply_rope(tx, torch.from_numpy(pos.copy()), 1e4),
           reference.layers.apply_rope(jx, jnp.asarray(pos), 1e4), tol)


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_reference(reference, kind, dtype):
    jc = dataclasses.replace(
        reference.configs.get_config("deepseek-coder-33b").reduced(),
        mlp=kind, d_model=64, d_ff=96)
    jp = to_numpy_tree(reference.layers.init_mlp(jax.random.PRNGKey(1), jc))
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    x = np.random.default_rng(2).normal(size=(3, 5, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = layers.mlp_fwd(tp, tx, kind)
    assert got.dtype == tx.dtype
    _close(got, reference.layers.mlp_fwd(jp, jx, kind), TOL[dtype])


def test_embed_and_unembed_match_reference(reference):
    table = np.random.default_rng(3).normal(size=(50, 16)).astype(np.float32)
    tok = np.array([[0, 7, 49], [3, 3, 1]])
    got = layers.embed({"table": torch.from_numpy(table)},
                       torch.from_numpy(tok), torch.bfloat16)
    expect = reference.layers.embed({"table": jnp.asarray(table)},
                                    jnp.asarray(tok), jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), _f32(expect))
    _close(layers.unembed({"table": torch.from_numpy(table)}, got),
           reference.layers.unembed({"table": jnp.asarray(table)}, expect),
           2e-2)


# -- GQA ---------------------------------------------------------------------

def _gqa_weights(reference, jc, seed=0):
    return to_numpy_tree(reference.attention.init_gqa(
        jax.random.PRNGKey(seed), jc))


@pytest.mark.parametrize("variant", ["reduced", "group7"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_prefill_matches_reference(flash_oracle, variant, dtype):
    jc, tc = _cfgs(flash_oracle, "deepseek-coder-33b", variant, dtype)
    w = _gqa_weights(flash_oracle, jc)
    x = np.random.default_rng(5).normal(size=(2, 13, jc.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(13), (2, 13))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jy, _ = flash_oracle.attention.gqa_fwd(w, jx, jc, jnp.asarray(pos))
    ty, cache = attention.gqa_fwd({k: torch.from_numpy(v.copy())
                                   for k, v in w.items()}, tx, tc,
                                  torch.from_numpy(pos.copy()))
    assert cache is None
    assert flash_oracle.calls == {"reference": 1, "port": 1}
    _close(ty, jy, TOL[dtype])


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_decode_matches_reference(reference, window, dtype):
    jc, tc = _cfgs(reference, "deepseek-coder-33b", "group7", dtype)
    jc = dataclasses.replace(jc, sliding_window=window)
    tc = dataclasses.replace(tc, sliding_window=window)
    w = _gqa_weights(reference, jc, seed=1)
    tw = {k: torch.from_numpy(v.copy()) for k, v in w.items()}
    jcache = reference.attention.init_gqa_cache(jc, 2, 12)
    tcache = attention.init_gqa_cache(tc, 2, 12)
    assert tuple(tcache["k"].shape) == jcache["k"].shape
    rng = np.random.default_rng(6)
    for pos in range(9):                      # past the window's ring wrap
        x = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
        jx = jnp.asarray(x).astype(getattr(jnp, dtype))
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        jy, jcache = reference.attention.gqa_fwd(
            w, jx, jc, jnp.full((2, 1), pos), cache=jcache,
            cache_pos=jnp.int32(pos))
        ty, tcache = attention.gqa_fwd(tw, tx, tc, torch.full((2, 1), pos),
                                       cache=tcache, cache_pos=pos)
        _close(ty, jy, TOL[dtype])
        np.testing.assert_array_equal(tcache["k"].float().numpy(),
                                      _f32(jcache["k"]))


# -- the whole model ---------------------------------------------------------

def _model(reference, arch, variant, dtype, seed=0):
    jc, tc = _cfgs(reference, arch, variant, dtype)
    w = to_numpy_tree(reference.transformer.init_model(
        jax.random.PRNGKey(seed), jc))
    return jc, tc, w, transformer.params_from_numpy(w, tc, device="cpu")


@pytest.mark.parametrize("arch,variant", [
    ("deepseek-coder-33b", "reduced"), ("deepseek-coder-33b", "group7"),
    ("qwen1.5-4b", "reduced"), ("nemotron-4-15b", "reduced")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_reference(flash_oracle, arch, variant,
                                          dtype):
    jc, tc, w, tp = _model(flash_oracle, arch, variant, dtype)
    rng = np.random.default_rng(7)
    tok = rng.integers(0, jc.vocab_size, size=(2, 19))
    lab = rng.integers(0, jc.vocab_size, size=(2, 19))
    jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tbatch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    jlogits, _ = flash_oracle.transformer.forward(w, jbatch, jc)
    tlogits, aux = transformer.forward(tp, tbatch, tc)
    # both went through their flash wrapper: the port once per layer, the
    # reference's lax.scan over layers at least once (it traces its body)
    assert flash_oracle.calls["port"] == tc.n_layers
    assert flash_oracle.calls["reference"] >= 1
    assert tlogits.dtype == getattr(torch, dtype) and float(aux) == 0.0
    _close(tlogits, jlogits, TOL[dtype])
    jloss, _ = flash_oracle.transformer.loss_fn(w, jbatch, jc)
    tloss, _ = transformer.loss_fn(tp, tbatch, tc)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL[dtype])
    assert transformer.param_count(tp) == \
        flash_oracle.transformer.param_count(w)
    jnext = flash_oracle.pod.make_prefill_step(jc)(w, jbatch)
    tnext = make_prefill_step(tc)(tp, tbatch)
    assert tnext.dtype == torch.int32 and tnext.shape == (2,)
    if dtype == "float32":
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))


@pytest.mark.parametrize("variant", ["reduced", "group7"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(reference, variant, dtype):
    jc, tc, w, tp = _model(reference, "deepseek-coder-33b", variant, dtype,
                           seed=1)
    jcache = reference.transformer.init_cache(jc, 2, 16)
    tcache = transformer.init_cache(tc, 2, 16, device="cpu")
    tok = np.random.default_rng(8).integers(0, jc.vocab_size, size=(2, 6))
    for pos in range(6):
        jl, jcache = reference.transformer.decode_step(
            w, jcache, jnp.asarray(tok[:, pos:pos + 1]), jnp.int32(pos), jc)
        tl, tcache = transformer.decode_step(
            tp, tcache, torch.from_numpy(tok[:, pos:pos + 1]), pos, tc)
        assert tl.shape == (2, 1, jc.vocab_size)
        _close(tl, jl, TOL[dtype])
    np.testing.assert_allclose(tcache["dense"]["v"].float().numpy(),
                               _f32(jcache["dense"]["v"]),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_params_from_numpy_checks_every_leaf(reference):
    jc, tc, w, _ = _model(reference, "deepseek-coder-33b", "reduced",
                          "float32")
    bad = to_numpy_tree(w)
    bad["lm_head"] = bad["lm_head"][:, :-1]
    with pytest.raises(ValueError, match="lm_head"):
        transformer.params_from_numpy(bad, tc, device="cpu")
    bad = to_numpy_tree(w)
    bad["final_norm"]["scale"] = bad["final_norm"]["scale"].astype(np.float64)
    with pytest.raises(ValueError, match="final_norm.scale"):
        transformer.params_from_numpy(bad, tc, device="cpu")
    bad = to_numpy_tree(w)
    del bad["dense_layers"]["ln2"]
    with pytest.raises(ValueError, match="leaves"):
        transformer.params_from_numpy(bad, tc, device="cpu")


# -- the slice end to end ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_decode_matches_reference_serving_loop(reference, monkeypatch,
                                                     dtype):
    """``serve_decode.run`` on the CPU against the reference's own
    ``init_cache`` + ``make_serve_step`` loop from the same weights and
    prompt: token ids agree step by step wherever the reference's top-2
    logit gap exceeds the tolerance; at a closer call the two may part, and
    the comparison stops there (the inputs differ after it)."""
    jc, tc, w, tp = _model(reference, "deepseek-coder-33b", "group7", dtype,
                           seed=2)
    monkeypatch.setattr(serve_decode, "init_model", lambda gen, cfg: tp)
    B, P, T, L = 2, 5, 6, 12
    res = serve_decode.run(tc, batch=B, prompt_len=P, decode_steps=T,
                           cache_len=L, seed=3, device="cpu")
    assert res["tokens"].shape == (B, T) and res["tokens"].dtype == torch.int32
    assert res["prefill_s"] > 0 and res["decode_s"] > 0

    gaps = []
    real = reference.pod.decode_step

    def recording(*args, **kw):
        logits, cache = real(*args, **kw)
        top2 = np.sort(_f32(logits[:, -1, :]), axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        return logits, cache
    monkeypatch.setattr(reference.pod, "decode_step", recording)
    serve = reference.pod.make_serve_step(jc)
    cache = reference.transformer.init_cache(jc, B, L)
    prompt = jnp.asarray(res["prompt"].numpy())
    for i in range(P):
        nxt, cache = serve(w, cache, prompt[:, i:i + 1], jnp.int32(i))
    out, tok = [], nxt
    for i in range(T):
        tok, cache = serve(w, cache, tok, jnp.int32(P + i))
        out.append(np.asarray(tok))
    expect = np.concatenate(out, axis=1)
    got = res["tokens"].numpy()
    # gaps[P - 1 + t] decided token t
    live = np.ones(B, bool)
    for t in range(T):
        clear = gaps[P - 1 + t] > TOL[dtype]
        assert np.all(got[live & clear, t] == expect[live & clear, t]), t
        live &= got[:, t] == expect[:, t]
    if dtype == "float32":
        np.testing.assert_array_equal(got, expect)
