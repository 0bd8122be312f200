"""The port's CUDA kernels on the card: each against its plain version, and
the launch counts that show the main path went through them. Skipped where
there is no card. Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import json

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import scored_reduce as sr

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


# norms and mean_sq: the reference kernel test's rtol; dots relative to
# sqrt(norms * mean_sq), the size of the terms they sum
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


# ragged and small shapes, then the (U, N) buffers of the CNN, SqueezeNet
# and LSTM at the paper's U=256 (two N are not multiples of 8)
@pytest.mark.parametrize("U,N", [(1, 17), (3, 131), (17, 4099),
                                 (16, 18_404), (64, 1_000_003),
                                 (256, 1_118_500), (256, 106_376),
                                 (256, 381_284)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scored_reduce_matches_plain_version(cuda, U, N, dtype):
    gen = torch.Generator(device=cuda).manual_seed(U * N)
    d = torch.randn((U, N), generator=gen, device=cuda).to(dtype)
    mean = d.float().mean(0)
    before = sr.scored_reduce.launches
    dots, norms, msq = sr.scored_reduce(d, mean)
    torch.cuda.synchronize()
    assert sr.scored_reduce.launches == before + 1
    pd, pn, pm = sr.scored_reduce_plain(d, mean)
    tol = TOL[dtype]
    torch.testing.assert_close(norms, pn, rtol=tol, atol=0)
    torch.testing.assert_close(msq, pm, rtol=tol, atol=0)
    scale = torch.sqrt(pn * pm)
    assert bool(((dots - pd).abs() <= tol * scale + 1e-30).all())


def test_scored_reduce_is_deterministic(cuda):
    d = torch.randn((33, 70_001), device=cuda)
    mean = d.mean(0)
    a = sr.scored_reduce(d, mean)
    b = sr.scored_reduce(d, mean)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_scored_reduce_rejects_strided_input(cuda):
    d = torch.randn((8, 64), device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        sr.scored_reduce(d, torch.zeros(32, device=cuda))


def test_harness_round_launches_the_kernel_once(cuda):
    from repro_torch.harness import ExperimentConfig, run
    before = sr.scored_reduce.launches
    hist = run("osafl", ExperimentConfig(model="mlp", dataset=2,
                                         num_clients=16, rounds=2,
                                         capacity=(16, 32)),
               eval_samples=64)
    assert sr.scored_reduce.launches == before + 2
    assert all(torch.isfinite(torch.tensor(h["test_loss"])) for h in hist)


# the CNN and SqueezeNet take global_lr=1: at the default 16 a one-ulp
# change of their weights moves a later round's loss by more than 1e-4
# (tests/test_torch_precision.py)
SMALL_RUNS = {
    "cnn": dict(dataset=1, num_clients=4, rounds=2, global_lr=1.0),
    "squeezenet": dict(dataset=1, num_clients=4, rounds=2, global_lr=1.0),
    "lstm": dict(dataset=2, num_clients=8, rounds=3),
}


@pytest.mark.parametrize("model", sorted(SMALL_RUNS))
def test_cuda_run_matches_cpu_run(cuda, monkeypatch, model):
    """The same seeded run on the card and on the CPU, with cuDNN's TF32
    left on by the caller: the harness holds convolutions in full f32 and
    gives the caller's setting back."""
    from repro_torch.harness import ExperimentConfig, run
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    xc = ExperimentConfig(model=model, capacity=(16, 32), seed=3,
                          **SMALL_RUNS[model])
    before = sr.scored_reduce.launches
    gpu = run("osafl", xc, eval_samples=64)
    assert sr.scored_reduce.launches == before + xc.rounds
    assert torch.backends.cudnn.allow_tf32 is True
    cpu = run("osafl", xc, eval_samples=64, device="cpu")
    for g, c in zip(gpu, cpu):
        assert g["participants"] == c["participants"]
        assert abs(g["test_loss"] - c["test_loss"]) <= 1e-4 * abs(
            c["test_loss"])


@pytest.mark.parametrize("model", ["cnn", "squeezenet"])
def test_conv_reruns_are_bit_identical(cuda, model):
    """The same seed gives the same history bit for bit (the reference's
    contract): cuDNN is held to deterministic algorithms inside a run."""
    from repro_torch.harness import ExperimentConfig, run
    xc = ExperimentConfig(model=model, capacity=(16, 32), seed=3,
                          **SMALL_RUNS[model])
    keys = ("test_loss", "test_acc", "participants")
    first, again = (run("osafl", xc, eval_samples=64) for _ in range(2))
    assert [[h[k] for k in keys] for h in first] == [
        [h[k] for k in keys] for h in again]


@pytest.mark.parametrize("alg", ["osafl", "fedavg"])
def test_loop_run_matches_cpu_run(cuda, alg):
    """The loop engine on the card against the CPU; it never scores through
    the kernel."""
    from repro_torch.harness import ExperimentConfig, run
    xc = ExperimentConfig(model="mlp", dataset=2, num_clients=16, rounds=3,
                          capacity=(16, 32), seed=3, engine="loop")
    before = sr.scored_reduce.launches
    gpu = run(alg, xc, eval_samples=64)
    assert sr.scored_reduce.launches == before
    cpu = run(alg, xc, eval_samples=64, device="cpu")
    assert len(gpu) == len(cpu) == xc.rounds
    for g, c in zip(gpu, cpu):
        assert g["participants"] == c["participants"]
        assert abs(g["test_loss"] - c["test_loss"]) <= 1e-4 * abs(
            c["test_loss"])


def test_list_round_matches_loop_server(cuda):
    """``StackedOSAFLServer.round(updates)`` against ``OSAFLServer.round``
    on the same list on the card, 3 rounds of partial participation: one
    ``scored_reduce`` launch a round, all of them the stacked server's."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.baselines import make_server
    from repro_torch.core.flatten import tree_get, tree_map, tree_paths
    from repro_torch.core.osafl import ClientUpdate
    from repro_torch.models.small import init_small
    U = 12
    p = init_small(0, "mlp", cuda)
    loop, stacked = (make_server(p, FLConfig(engine=e, global_lr=4.0), U,
                                 device=cuda) for e in ("loop", "stacked"))
    gen = torch.Generator(device=cuda).manual_seed(0)
    for r in range(3):
        ups = [ClientUpdate(u, tree_map(lambda v: 0.1 * torch.randn(
            v.shape, generator=gen, device=cuda), p), 1)
            for u in range(r, U, 2)]
        before = sr.scored_reduce.launches
        a = loop.round(ups)
        assert sr.scored_reduce.launches == before
        b = stacked.round(ups)
        torch.cuda.synchronize()
        assert sr.scored_reduce.launches == before + 1
        for path in tree_paths(a):
            torch.testing.assert_close(tree_get(a, path), tree_get(b, path),
                                       rtol=0, atol=1e-5)
        torch.testing.assert_close(torch.as_tensor(loop.last_scores),
                                   torch.as_tensor(stacked.last_scores),
                                   rtol=0, atol=1e-5, check_dtype=False)


GRAD_TOL = 1e-5        # relative L2, as chip_smoke.py holds it


def _grads(model, device):
    from repro_torch.harness import ExperimentConfig
    from repro_torch.harness.experiments import _stacked_setup
    from repro_torch.models.small import init_small, small_loss
    xc = ExperimentConfig(model=model, capacity=(16, 32), seed=3,
                          **SMALL_RUNS[model])
    batch = _stacked_setup("osafl", xc, 64, torch.device(device)).test_batch
    grads = torch.func.grad(lambda p: small_loss(p, batch, model)[0])(
        init_small(xc.seed, model, device))
    return torch.cat([g.reshape(-1).double().cpu()
                      for g in torch.utils._pytree.tree_leaves(grads)])


@pytest.mark.parametrize("model", ["cnn", "squeezenet"])
def test_conv_grads_match_cpu_only_in_full_f32(cuda, monkeypatch, model):
    """The gradients separate full f32 from cuDNN's TF32, which the run
    gate's loss at global_lr=1 does not: printed beside them, the same
    small run with TF32 on (the harness's hold bypassed) against the
    CPU."""
    import contextlib

    import repro_torch.harness.experiments as tex
    from repro_torch.device import full_f32_convolutions
    from repro_torch.harness import ExperimentConfig, run
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cpu = _grads(model, "cpu")
    with full_f32_convolutions():
        f32 = _grads(model, cuda)
    tf32 = _grads(model, cuda)
    rel = {name: float((g - cpu).norm() / cpu.norm())
           for name, g in (("f32", f32), ("tf32", tf32))}
    xc = ExperimentConfig(model=model, capacity=(16, 32), seed=3,
                          **SMALL_RUNS[model])
    cpu_run = run("osafl", xc, eval_samples=64, device="cpu")
    monkeypatch.setattr(tex, "full_f32_convolutions", contextlib.nullcontext)
    tf32_run = run("osafl", xc, eval_samples=64)
    print(json.dumps({"model": model, "grad_rel_l2": rel,
                      "tf32_run_loss_rel": [
                          abs(g["test_loss"] / c["test_loss"] - 1)
                          for g, c in zip(tf32_run, cpu_run)]}))
    assert rel["f32"] <= GRAD_TOL < rel["tf32"]


# -- flash attention ---------------------------------------------------------

# chip_smoke.py's kernel-phase shapes (B, H, Hkv, S, D); tests/test_kernels.py
# (D = 256 takes the mma.sync kernel in bf16)
FLASH_SHAPES = [(1, 7, 1, 1, 128), (2, 14, 2, 77, 64), (1, 4, 4, 130, 64),
                (2, 56, 8, 24, 128), (1, 8, 2, 512, 128), (2, 14, 2, 300, 128),
                (2, 14, 2, 130, 40), (1, 8, 2, 130, 256)]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(cuda, B, H, Hkv, S, D, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=cuda).to(dtype)
            for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_plain_version(cuda, shape, dtype, causal):
    q, k, v = _qkv(cuda, *shape, dtype)
    before = fa.flash_attention_bhsd.launches
    out = fa.flash_attention_bhsd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bhsd.launches == before + 1
    plain = fa.flash_attention_plain(q, k, v, causal=causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), plain.float(), rtol=tol,
                               atol=tol)


def test_flash_attention_is_deterministic(cuda):
    q, k, v = _qkv(cuda, 2, 14, 2, 300, 128, torch.bfloat16, seed=1)
    assert torch.equal(fa.flash_attention_bhsd(q, k, v),
                       fa.flash_attention_bhsd(q, k, v))


@pytest.mark.parametrize("S,D", [(70, 64), (300, 128)])
def test_flash_attention_reads_model_layout_views(cuda, S, D):
    q, k, v = _qkv(cuda, 2, 14, 2, S, D, torch.bfloat16, seed=2)
    qm, km, vm = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = ops.flash_attention(qm, km, vm)        # (B, S, H, D), no copies
    assert out.shape == qm.shape and out.is_contiguous()
    torch.testing.assert_close(out.transpose(1, 2),
                               fa.flash_attention_plain(q, k, v),
                               rtol=2e-2, atol=2e-2)
    # the same function as on contiguous inputs, bit for bit
    assert torch.equal(out.transpose(1, 2), fa.flash_attention_bhsd(q, k, v))


# The Hopper kernel (bf16, D <= 128): D below, at and inside its buckets of
# 64 and 128 (TMA fills the missing columns with zeros), S of one key, of
# one tile, just past one and ending mid-tile above one, kv groups of 7:1
# and 2:1
@pytest.mark.parametrize("D", [40, 64, 128])
@pytest.mark.parametrize("S", [1, 77, 128, 130, 300])
@pytest.mark.parametrize("B,H,Hkv", [(1, 7, 1), (2, 14, 2), (1, 16, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_hopper_flash_matches_plain_version(cuda, D, S, B, H, Hkv, causal):
    q, k, v = _qkv(cuda, B, H, Hkv, S, D, torch.bfloat16, seed=S + D)
    before = fa.flash_attention_bhsd.launches
    out = fa.flash_attention_bhsd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bhsd.launches == before + 1
    torch.testing.assert_close(
        out.float(), fa.flash_attention_plain(q, k, v, causal=causal).float(),
        rtol=2e-2, atol=2e-2)


def test_flash_attention_refuses_what_it_cannot_read(cuda):
    q, k, v = _qkv(cuda, 1, 4, 2, 16, 64, torch.float32)
    shifted = torch.randn(q.numel() + 2, device=cuda)[2:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fa.flash_attention_bhsd(shifted, k, v)       # 8-byte offset
    strided = torch.randn((1, 4, 16, 128), device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fa.flash_attention_bhsd(strided, k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_bhsd(q.half(), k.half(), v.half())


def test_prefill_step_launches_flash_once_per_layer(cuda):
    from repro_torch.configs import get_config
    from repro_torch.core.pod import make_prefill_step
    from repro_torch.models.transformer import init_model
    cfg = dataclasses.replace(get_config("deepseek-coder-33b").reduced(),
                              n_layers=3, n_heads=14, n_kv_heads=2,
                              d_model=448)
    params = init_model(torch.Generator(device=cuda).manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda)
    before = fa.flash_attention_bhsd.launches
    nxt = make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert fa.flash_attention_bhsd.launches == before + cfg.n_layers
    assert nxt.shape == (2,) and nxt.dtype == torch.int32
