"""The gradient of the port's flash attention and of the dense decoders'
training loss, against ``jax.grad`` of the JAX package on the CPU.

``flash_attention_plain_bwd`` (the backward kernels' plain version) and the
autograd function ``kernels.ops.flash_attention`` are held to the
vector-Jacobian product of ``repro.kernels.ref.mha_reference`` (the Pallas
kernel defines no VJP, so the reference trains through plain attention).
Each gradient is held on its own: its largest error over its own largest
magnitude to 2e-5 in f32 and 2e-2 in bf16 (tests/test_kernels.py:26), and
the Frobenius norm of its error over its own to FRO_TOL. With one key,
dS = P (dp - delta) cancels to rounding noise in dq and dk, so at S = 1
both are taken over the largest among dq, dk and dv instead.
``loss_fn``'s parameter gradients agree with the reference's ``loss_fn``
(``REPRO_USE_FLASH`` unset, so its attention is ``_sdpa``) to rtol 1e-4 in
f32. The backward kernels are held
to the plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.core.flatten import tree_from_leaves, tree_get, tree_paths
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import transformer
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the error's Frobenius norm over the gradient's own
FRO_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# (B, H, Hkv, S, D): MHA, GQA with G = 2 and 4, a ragged S
SHAPES = [(2, 4, 4, 24, 32), (2, 4, 2, 33, 16), (1, 8, 2, 40, 64),
          (1, 4, 1, 1, 8)]


def _draw(B, H, Hkv, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, H, S, D))]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's intra-op threads held at 1 while this module runs: the test
    suite runs several files at once on a few cores, where more threads
    only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_vjp(arrs, dtype, causal):
    """mha_reference's output and (dq, dk, dv) at the cotangent do."""
    def fwd_bwd(q, k, v, do):
        out, pull = jax.vjp(lambda q, k, v: jref.mha_reference(
            q, k, v, causal=causal), q, k, v)
        return out, pull(do)
    return jax.jit(fwd_bwd)(*(jnp.asarray(a).astype(getattr(jnp, dtype))
                              for a in arrs))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel_close(got, want, tol, scale=None):
    """max |got - want| <= tol * scale, scale = max |want| by default."""
    want = _f32(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max() if scale is None else scale
    err = np.abs(got - want).max() / max(scale, 1e-30)
    assert err <= tol, err


def _grads_close(got, want, dtype):
    """Each of dq, dk, dv on its own (the module's docstring)."""
    want = [_f32(w) for w in want]
    one_key = want[0].shape[-2] == 1
    top = max(np.abs(w).max() for w in want)
    top_fro = max(np.linalg.norm(w) for w in want)
    for g, w in zip(got, want):
        g = g.detach().float().numpy()
        assert g.shape == w.shape
        e = g - w
        largest, fro = ((top, top_fro) if one_key
                        else (np.abs(w).max(), np.linalg.norm(w)))
        assert np.abs(e).max() <= TOL[dtype] * largest, (
            np.abs(e).max(), largest)
        assert np.linalg.norm(e) <= FRO_TOL[dtype] * fro, (
            np.linalg.norm(e), fro)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_jax_grad(shape, dtype, causal):
    """The plain backward on the plain forward's output and log-sum-exp,
    and ``ops.flash_attention`` (model layout) under ``.backward()``,
    against the vector-Jacobian product of the reference's oracle; on CPU
    tensors no kernel launches."""
    arrs = _draw(*shape)
    jout, want = _jax_vjp(arrs, dtype, causal)
    q, k, v, do = (torch.from_numpy(a).to(getattr(torch, dtype))
                   for a in arrs)
    launches = (fa.flash_attention_bhsd.launches,
                fa.flash_attention_bwd.launches)
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                      return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == shape[:2] + shape[3:4]
    got = fa.flash_attention_plain_bwd(q, k, v, o, lse, do, causal=causal)
    for g, x in zip(got, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
    _grads_close(got, want, dtype)

    qm, km, vm = (x.transpose(1, 2).clone().requires_grad_()
                  for x in (q, k, v))
    out = ops.flash_attention(qm, km, vm, causal=causal)
    _rel_close(out.transpose(1, 2), jout, TOL[dtype])
    out.backward(do.transpose(1, 2))
    _grads_close([x.grad.transpose(1, 2) for x in (qm, km, vm)], want,
                 dtype)
    assert (fa.flash_attention_bhsd.launches,
            fa.flash_attention_bwd.launches) == launches


# q/k head dim D and v head dim Dv apart (B, H, Hkv, S, D, Dv): a GQA
# group of 2 at a ragged S, and MHA with Dv below a 64 bucket
DV_SHAPES = [(2, 4, 2, 33, 24, 16), (1, 4, 4, 40, 64, 40)]


@pytest.mark.parametrize("shape", DV_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_with_two_head_dims_matches_jax_grad(shape, dtype, causal):
    """MLA's case, v narrower than q and k: the plain backward at Dv and
    ``ops.flash_attention``'s gradients (the autograd function, on CPU
    tensors the plain versions at Dv as they are) against the
    vector-Jacobian product of the reference's oracle."""
    B, H, Hkv, S, D, Dv = shape
    rng = np.random.default_rng(D + Dv)
    arrs = [rng.normal(size=sh).astype(np.float32) for sh in
            ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, Dv), (B, H, S, Dv))]
    jout, want = _jax_vjp(arrs, dtype, causal)
    q, k, v, do = (torch.from_numpy(a).to(getattr(torch, dtype))
                   for a in arrs)
    launches = (fa.flash_attention_bhsd.launches,
                fa.flash_attention_bwd.launches)
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                      return_lse=True)
    assert o.shape == (B, H, S, Dv)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for g, x in zip(got, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
    _grads_close(got, want, dtype)

    qm, km, vm = (x.transpose(1, 2).clone().requires_grad_()
                  for x in (q, k, v))
    out = ops.flash_attention(qm, km, vm, causal=causal)
    assert out.shape == (B, S, H, Dv)
    _rel_close(out.transpose(1, 2), jout, TOL[dtype])
    out.backward(do.transpose(1, 2))
    _grads_close([x.grad.transpose(1, 2) for x in (qm, km, vm)], want,
                 dtype)
    assert (fa.flash_attention_bhsd.launches,
            fa.flash_attention_bwd.launches) == launches


@pytest.mark.parametrize("causal", [True, False])
def test_padded_backward_route_gives_the_two_head_dim_gradients(causal):
    """The card's route for Dv < D (``FlashAttention.backward``): v, o and
    do zero-padded to D through the one-head-dim backward, dv's first Dv
    columns kept, gives what the backward at Dv gives; the padded columns
    of dv are zero."""
    B, H, Hkv, S, D, Dv = 2, 4, 2, 33, 24, 16
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
                   for sh in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, Dv),
                              (B, H, S, Dv)))
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                      return_lse=True)
    want = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    vp, op, dop = (torch.nn.functional.pad(x, (0, D - Dv))
                   for x in (v, o, do))
    torch.testing.assert_close(fa.flash_attention_plain(q, k, vp,
                                                        causal=causal),
                               op, rtol=1e-6, atol=1e-6)
    got = fa.flash_attention_bwd(q, k, vp, op, lse, dop, causal=causal)
    assert torch.count_nonzero(got[2][..., Dv:]) == 0
    for g, w in zip((got[0], got[1], got[2][..., :Dv]), want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_func_grad_takes_the_autograd_function(dtype):
    """``torch.func.grad`` through ``ops.flash_attention`` gives what
    ``.backward()`` gives, bit for bit."""
    q, k, v, do = (torch.from_numpy(a).to(dtype).transpose(1, 2)
                   for a in _draw(2, 4, 2, 33, 16, seed=1))

    def loss(q, k, v):
        return (ops.flash_attention(q, k, v).float() * do.float()).sum()
    grads = torch.func.grad(loss, argnums=(0, 1, 2))(q, k, v)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    loss(*leaves).backward()
    for g, x in zip(grads, leaves):
        torch.testing.assert_close(g, x.grad, rtol=0, atol=0)


@pytest.mark.parametrize("Hkv,causal", [(1, True), (2, False)])
def test_plain_path_passes_gradcheck_in_float64(Hkv, causal):
    gen = torch.Generator().manual_seed(Hkv)
    q = torch.randn((1, 8, 2, 8), generator=gen, dtype=torch.float64)
    k, v = (torch.randn((1, 8, Hkv, 8), generator=gen, dtype=torch.float64)
            for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, causal=causal),
        tuple(x.requires_grad_() for x in (q, k, v)))


def test_forward_without_a_gradient_keeps_no_lse():
    q = torch.randn((1, 5, 4, 8))
    k = torch.randn((1, 5, 2, 8))
    with torch.no_grad():
        out = ops.flash_attention(q.requires_grad_(), k, k)
    assert out.grad_fn is None
    assert ops.flash_attention(q, k, k).grad_fn is not None


def test_plain_forward_is_unchanged_by_the_lse():
    """The values of the plain forward with and without the log-sum-exp,
    which is the log of its softmax denominator."""
    q, k, v, _ = (torch.from_numpy(a) for a in _draw(2, 4, 2, 17, 16))
    o = fa.flash_attention_plain(q, k, v)
    o2, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    torch.testing.assert_close(o, o2, rtol=0, atol=0)
    s = (q * 16 ** -0.5) @ k.repeat_interleave(2, 1).transpose(-1, -2)
    s = s.masked_fill(~torch.ones(17, 17, dtype=torch.bool).tril(),
                      float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6,
                               atol=1e-6)


def test_backward_wrapper_checks_its_inputs():
    q, k, v, do = (torch.from_numpy(a) for a in _draw(1, 4, 2, 8, 16))
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, o, lse[:, :2], do)
    with pytest.raises(ValueError, match="do like q"):
        fa.flash_attention_bwd(q, k, v, o, lse, do[..., :8])
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bhsd(q, k, v, lse=torch.empty(1, 4, 8,
                                                         dtype=torch.float64))
    # given outputs receive the results
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, dq=dq, dk=dk, dv=dv)
    assert got[0] is dq and got[1] is dk and got[2] is dv
    want = fa.flash_attention_plain_bwd(q, k, v, o, lse, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bound_of_the_backward_at_the_prefill_shape():
    # B=4, S=4096, H=56, Hkv=8, D=128, bf16, causal (chip_smoke.py)
    q = torch.empty((4, 56, 4096, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((4, 8, 4096, 128), dtype=torch.bfloat16, device="meta")
    assert fa.bound_flops_bwd(q, k) == 5 * 962_307_555_328 // 2
    assert round(fa.bound_flops_bwd(q, k) / 989e12 * 1e3, 2) == 2.43
    assert fa.bound_bytes_bwd(q, k, k) == (
        2 * (4 * 4 * 56 + 4 * 4 * 8) * 4096 * 128 + 4 * 4 * 56 * 4096)


@pytest.mark.parametrize("dtype,D,S,route", [
    (torch.bfloat16, 128, 4096, "hopper"),
    (torch.bfloat16, 120, 777, "hopper"),
    (torch.bfloat16, 40, 1, "hopper"), (torch.bfloat16, 256, 130, "mma"),
    (torch.float32, 128, 130, "f32")])
def test_backward_scratch_follows_the_route(dtype, D, S, route):
    """The Hopper route (bf16, D <= 128) takes the (lse * log2 e, delta)
    pairs padded to whole 64-row tiles, an f32 dq workspace of 64 x 64 or
    64 x 128 tiles and zeroed int32 turn counters; the other routes a
    (B, H, S) delta alone. At the prefill shape the workspace is 470
    MB."""
    q = torch.empty((4, 56, S, D), dtype=dtype, device="meta")
    got = fa._bwd_scratch(q)
    assert fa._hopper_bwd(q) == (route == "hopper")
    if route != "hopper":
        assert got["delta"].shape == (4, 56, S)
        assert got["dq_accum"] is None and got["turns"] is None
        return
    tiles, width = -(-S // 64), 64 if D <= 64 else 128
    assert got["delta"].shape == (4, 56, tiles * 64, 2)
    assert got["dq_accum"].shape == (4, 56, tiles, 64, width)
    assert got["dq_accum"].dtype == torch.float32
    assert got["turns"].shape == (4, 56, tiles)
    assert got["turns"].dtype == torch.int32
    if S == 4096:
        assert got["dq_accum"].numel() * 4 == 4 * 56 * 4096 * 128 * 4


def test_library_path_follows_every_shared_header(tmp_path, monkeypatch):
    """A build is named by its source and every ``csrc/*.cuh`` header, so
    an edit of a shared header rebuilds both flash libraries; an edit
    elsewhere in ``csrc/`` does not."""
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    assert (csrc / "hopper.cuh").exists()
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("flash_attention", "flash_attention_bwd", "scored_reduce")
    before = {n: build.library_path(n) for n in names}
    (csrc / "notes.txt").write_text("not a header")
    assert {n: build.library_path(n) for n in names} == before
    (csrc / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text()
                                     + "// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    assert all(after[n].parent == build.BUILD_DIR
               and after[n].name.startswith(f"lib{n}-") for n in names)
    (csrc / "flash_attention_bwd.cu").write_text(
        (csrc / "flash_attention_bwd.cu").read_text() + "// edited\n")
    assert build.library_path("flash_attention_bwd") != after[
        "flash_attention_bwd"]
    assert build.library_path("flash_attention") == after["flash_attention"]


@pytest.mark.parametrize("cached", [False, True])
def test_build_returns_ptxas_report_for_a_cached_library(tmp_path, monkeypatch,
                                                         cached):
    """A library built before comes back with the ptxas report that its
    build wrote beside it, so ``chip_smoke.py`` finds the backward's Hopper
    kernel in both D buckets whether or not ``nvcc`` ran in this process;
    a library without its report is built again."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    name = "flash_attention_bwd"
    report = "".join(
        f"ptxas info    : Function properties for _ZN12_GLOBAL__N_121"
        f"bwd_bf16_wgmma_kernelILi{d}EEEv14CUtensorMap_st\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {r} registers, used 1 barriers\n"
        for d, r in ((128, 247), (64, 184)))
    nvcc_runs = []

    class FakeNvcc:
        def __init__(self, cmd, **_):
            nvcc_runs.append(cmd)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF")
            self.returncode = 0

        def communicate(self):
            return report, None

    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeNvcc)
    path = build.library_path(name)
    if cached:
        path.write_bytes(b"\x7fELF")     # a library without its report
        build.build((name,))
        assert len(nvcc_runs) == 1
    first = build.build((name,))[name]
    assert first["log"] == report and first["path"] == path
    assert path.with_suffix(".log").read_text() == report
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        path.with_suffix(".log").name, path.name]
    again = build.build((name,))[name]
    assert len(nvcc_runs) == 1
    assert again == {"path": path, "seconds": 0.0, "log": report}
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    got = chip_smoke.hopper_bwd_report(again["log"])
    assert sorted(got) == ["128", "64"]
    assert got["128"] == [
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 247 registers, used 1 barriers"]


# -- the training loss -------------------------------------------------------

def _loss_grads(params, batch, cfg):
    paths = tree_paths(params)
    leaves = [tree_get(params, p).clone().requires_grad_() for p in paths]
    loss, _ = transformer.loss_fn(tree_from_leaves(paths, leaves), batch, cfg)
    return loss, dict(zip(paths, torch.autograd.grad(loss, leaves)))


def _model(reference, arch, seed=0, **change):
    jc = dataclasses.replace(reference.configs.get_config(arch).reduced(),
                             dtype="float32", **change)
    tc = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                             **change)
    w = to_numpy_tree(reference.transformer.init_model(
        jax.random.PRNGKey(seed), jc))
    return jc, tc, w, transformer.params_from_numpy(w, tc, device="cpu")


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "deepseek-coder-33b"])
def test_loss_gradients_match_jax_grad(reference, monkeypatch, arch):
    """``torch.autograd.grad`` of the port's ``loss_fn`` (attention through
    the flash autograd function) against ``jax.grad`` of the reference's
    (through ``_sdpa``), reduced config in f32, every leaf to rtol 1e-4."""
    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    jc, tc, w, tp = _model(reference, arch)
    rng = np.random.default_rng(3)
    tok = rng.integers(0, jc.vocab_size, size=(2, 24))
    lab = rng.integers(0, jc.vocab_size, size=(2, 24))
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(
        lambda p: reference.transformer.loss_fn(
            p, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}, jc),
        has_aux=True))(w)
    before = fa.flash_attention_bwd.launches
    loss, grads = _loss_grads(tp, {"tokens": torch.from_numpy(tok),
                                   "labels": torch.from_numpy(lab)}, tc)
    assert fa.flash_attention_bwd.launches == before      # CPU: plain
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jg = to_numpy_tree(jgrad)
    assert sorted(grads) == tree_paths(jg)
    for path, g in grads.items():
        want = tree_get(jg, path)
        scale = np.abs(want).max()
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=str(path))


def test_remat_gives_the_same_gradients(reference, monkeypatch):
    monkeypatch.delenv("REPRO_REMAT_POLICY", raising=False)
    _, tc, _, tp = _model(reference, "qwen1.5-4b", seed=1)
    batch = {"tokens": torch.randint(0, tc.vocab_size, (2, 16),
                                     generator=torch.Generator().manual_seed(4)),
             "labels": torch.randint(0, tc.vocab_size, (2, 16),
                                     generator=torch.Generator().manual_seed(5))}
    loss, grads = _loss_grads(tp, batch, tc)
    rloss, rgrads = _loss_grads(tp, batch,
                                dataclasses.replace(tc, remat=True))
    assert rloss.item() == loss.item()
    for path in grads:
        torch.testing.assert_close(rgrads[path], grads[path], rtol=0, atol=0)
    monkeypatch.setenv("REPRO_REMAT_POLICY", "dots")
    with pytest.raises(NotImplementedError, match="dots"):
        _loss_grads(tp, batch, dataclasses.replace(tc, remat=True))
