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


@pytest.mark.parametrize("kw", [
    dict(model="mlp", dataset=2, num_clients=16, rounds=3),
    dict(model="fcn", dataset=1, num_clients=8, rounds=2),
], ids=["mlp-d2-u16", "fcn-d1-u8"])
def test_stacked_requests_run_matches_cpu_run(cuda, kw):
    """The stacked request model draws its noise on the host, so the card's
    stream is the CPU's: the same seeded run matches, participants exact."""
    from repro_torch.harness import ExperimentConfig, run
    xc = ExperimentConfig(capacity=(16, 32), seed=3,
                          request_backend="stacked", **kw)
    gpu = run("osafl", xc, eval_samples=64)
    cpu = run("osafl", xc, eval_samples=64, device="cpu")
    assert len(gpu) == len(cpu) == xc.rounds
    for g, c in zip(gpu, cpu):
        assert g["participants"] == c["participants"]
        assert abs(g["test_loss"] - c["test_loss"]) <= 1e-4 * abs(
            c["test_loss"])


@pytest.mark.parametrize("dataset", [1, 2])
def test_stacked_stream_on_card_is_the_cpu_stream(cuda, dataset):
    import numpy as np
    from repro_torch.data.video_caching import make_population
    from repro_torch.data.video_caching_stacked import StackedRequestStream
    cat, streams = make_population(3, 64, topk=2)
    gpu, cpu = (StackedRequestStream.from_streams(cat, streams, seed=5,
                                                  device=d)
                for d in ("cuda", "cpu"))
    rng = np.random.default_rng(0)
    for _ in range(4):
        counts = rng.integers(0, 9, 64)
        for a, b in zip(gpu.draw(counts, dataset, 8)[:2],
                        cpu.draw(counts, dataset, 8)[:2]):
            assert torch.equal(a.cpu(), b)
    for k, v in cpu.state_dict().items():
        assert np.array_equal(np.asarray(gpu.state_dict()[k]),
                              np.asarray(v)), k


def test_f32_solve_on_card_meets_the_x64_contract(cuda):
    """DESIGN.md's f32 tolerance against x64 on the card, at U=256 with the
    FCN's payload."""
    import numpy as np
    from repro_torch.core import resource as tres
    from repro_torch.core import resource_stacked as trs
    net = tres.NetworkConfig()
    rng = np.random.default_rng(0)
    sysb = trs.stack_clients(tres.make_clients(rng, 256))
    chb = trs.sample_channels(rng, sysb)
    dx, df = (trs.optimize_clients_batched(net, sysb, chb, 3_900_000,
                                           backend=b, device="cuda")
              for b in ("x64", "f32"))
    assert np.array_equal(df.feasible, dx.feasible)
    flips = df.kappa != dx.kappa
    assert flips.mean() <= 0.10
    m = dx.feasible & ~flips
    for k in ("f", "p", "e_total"):
        a, b = getattr(df, k)[m], getattr(dx, k)[m]
        assert np.median(np.abs(a - b) / np.abs(b)) <= 1e-3, k


@pytest.mark.parametrize("backend", ["python", "stacked"])
def test_resume_on_card_is_bit_exact(cuda, tmp_path, backend):
    from repro_torch.checkpoint import diff_snapshots, load_run_state
    from repro_torch.harness import (ExperimentConfig, checkpoint_path,
                                     run)
    xc = ExperimentConfig(model="mlp", dataset=2, num_clients=16, rounds=4,
                          capacity=(16, 32), seed=3,
                          request_backend=backend)
    full = run("osafl", xc, eval_samples=64, save_every_k=4,
               checkpoint_dir=tmp_path / "a")
    run("osafl", dataclasses.replace(xc, rounds=2), eval_samples=64,
        save_every_k=2, checkpoint_dir=tmp_path / "b")
    resumed = run("osafl", xc, eval_samples=64, save_every_k=2,
                  checkpoint_dir=tmp_path / "b",
                  resume_from=checkpoint_path(tmp_path / "b", 2))
    keys = ("test_loss", "test_acc", "participants")
    assert [[h[k] for k in keys] for h in full] == [
        [h[k] for k in keys] for h in resumed]
    assert not diff_snapshots(
        load_run_state(checkpoint_path(tmp_path / "a", 4)),
        load_run_state(checkpoint_path(tmp_path / "b", 4)))


# the new knobs on the MLP, card against CPU: every algorithm with a sparse
# cohort and with 2 clusters, OSAFL under every registry scenario on the
# dense and the sparse path, and sketched
_MLP = dict(model="mlp", dataset=2, num_clients=16, rounds=3,
            capacity=(16, 32), seed=3)
_SPARSE = dict(cohort_size=8, participation=0.5)
_SCENARIOS = ["churn(p_away=0.3)", "flash_crowd(period=2,scale=3)",
              "quiet(scale=0.5)", "radius_step(at=1,factor=1.67)",
              "device_classes", "cluster_churn(rate=0.3)",
              "pareto_select(alpha=1.5)"]
_ALGS = ["osafl", "fedavg", "fedprox", "fednova", "afa_cd", "feddisco"]
NEW_KNOBS = (
    [(a, dict(_SPARSE)) for a in _ALGS]
    + [(a, dict(num_clusters=2)) for a in _ALGS]
    + [("osafl", dict(scenario=sc)) for sc in _SCENARIOS]
    + [("osafl", dict(_SPARSE, scenario=sc,
                      num_clusters=2 if "cluster" in sc else 0))
       for sc in _SCENARIOS]
    + [("osafl", dict(score_sketch_dim=64)),
       ("osafl", dict(_SPARSE, num_clusters=2, request_backend="stacked"))])


@pytest.mark.parametrize("alg,kw", NEW_KNOBS,
                         ids=[f"{a}-{i}" for i, (a, _) in
                              enumerate(NEW_KNOBS)])
def test_new_knobs_run_matches_cpu_run(cuda, alg, kw):
    """Cohorts, clusters, scenarios and sketches: the same seeded run on
    the card and the CPU, participants exact, ``test_loss`` within 1e-4;
    ``scored_reduce`` launched K + 1 times a round with K > 1 clusters,
    once without, never when sketched or for a baseline."""
    from repro_torch.harness import ExperimentConfig, run
    xc = ExperimentConfig(**_MLP, **kw)
    before = sr.scored_reduce.launches
    gpu = run(alg, xc, eval_samples=64)
    K = xc.num_clusters
    per_round = (0 if alg != "osafl" or xc.score_sketch_dim
                 else K + 1 if K > 1 else 1)
    assert sr.scored_reduce.launches - before == xc.rounds * per_round
    cpu = run(alg, xc, eval_samples=64, device="cpu")
    assert len(gpu) == len(cpu) == xc.rounds
    for g, c in zip(gpu, cpu):
        assert g["participants"] == c["participants"]
        assert abs(g["test_loss"] - c["test_loss"]) <= 1e-4 * abs(
            c["test_loss"])


@pytest.mark.parametrize("U", [32, 8])
def test_scored_reduce_at_the_cluster_shapes(cuda, U):
    """The FCN's cluster-block (32, N) and tier-2 (8, N) shapes of the
    K=8 hierarchy, f32, and a contiguous row block of a larger buffer."""
    from repro_torch.core.flatten import make_codec
    from repro_torch.models.small import init_small
    N = make_codec(init_small(0, "fcn", "cpu")).n
    gen = torch.Generator(device=cuda).manual_seed(U)
    buf = torch.randn((2 * U, N), generator=gen, device=cuda)
    for d in (buf[:U], buf[U:]):
        mean = d.mean(0)
        dots, norms, msq = sr.scored_reduce(d, mean)
        pd, pn, pm = sr.scored_reduce_plain(d, mean)
        torch.testing.assert_close(norms, pn, rtol=1e-4, atol=0)
        torch.testing.assert_close(msq, pm, rtol=1e-4, atol=0)
        assert bool(((dots - pd).abs() <= 1e-4 * torch.sqrt(pn * pm)).all())


def test_sketch_signs_on_card_are_the_cpu_signs(cuda):
    from repro_torch.core.scores import sketch_signs, sketch_stacked
    key = [0, 7]
    assert torch.equal(sketch_signs(key, 0, 10_007, "cuda").cpu(),
                       sketch_signs(key, 0, 10_007, "cpu"))
    d = torch.randn((5, 10_007))
    torch.testing.assert_close(sketch_stacked(d.cuda(), key, 256).cpu(),
                               sketch_stacked(d, key, 256),
                               rtol=1e-5, atol=1e-4)


def test_sparse_hierarchical_resume_on_card_is_bit_exact(cuda, tmp_path):
    from repro_torch.checkpoint import diff_snapshots, load_run_state
    from repro_torch.harness import (ExperimentConfig, checkpoint_path,
                                     run)
    xc = ExperimentConfig(**dict(_MLP, rounds=4), **_SPARSE, num_clusters=2,
                          request_backend="stacked",
                          scenario="cluster_churn(rate=0.3)")
    full = run("osafl", xc, eval_samples=64, save_every_k=4,
               checkpoint_dir=tmp_path / "a")
    run("osafl", dataclasses.replace(xc, rounds=2), eval_samples=64,
        save_every_k=2, checkpoint_dir=tmp_path / "b")
    resumed = run("osafl", xc, eval_samples=64, save_every_k=2,
                  checkpoint_dir=tmp_path / "b",
                  resume_from=checkpoint_path(tmp_path / "b", 2))
    keys = ("test_loss", "test_acc", "participants")
    assert [[h[k] for k in keys] for h in full] == [
        [h[k] for k in keys] for h in resumed]
    assert not diff_snapshots(
        load_run_state(checkpoint_path(tmp_path / "a", 4)),
        load_run_state(checkpoint_path(tmp_path / "b", 4)))


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


# -- the fused round under CUDA-graph replay, and serving -------------------

FUSED = dict(model="mlp", dataset=2, num_clients=8, rounds=4,
             capacity=(12, 24), arrivals=4, batch=8, seed=5,
             request_backend="stacked", round_backend="fused",
             rounds_per_dispatch=2)


def _fused_engine(device, **change):
    from repro_torch.harness import ExperimentConfig, build_fused_engine
    xc = ExperimentConfig(**dict(FUSED, **change))
    eng, s = build_fused_engine("osafl", xc, 64, device=device)
    return eng, s, eng.init_carry(s.server, s.sbuf, s.rstream, 0)


@pytest.mark.parametrize("change", [
    dict(resource_backend="f32"), dict(resource_backend="x64"),
    dict(resource_backend="f32", score_sketch_dim=16),
    dict(model="fcn", dataset=1, num_clients=4, resource_backend="f32"),
    dict(model="lstm", resource_backend="x64", rounds=3,
         rounds_per_dispatch=3),
], ids=["mlp-f32", "mlp-x64", "mlp-sketched", "fcn-f32", "lstm-x64"])
def test_fused_run_matches_cpu_run(cuda, change):
    from repro_torch.harness import ExperimentConfig, run
    xc = ExperimentConfig(**dict(FUSED, **change))
    before = sr.scored_reduce.launches
    gpu = run("osafl", xc, eval_samples=64)
    want = 0 if xc.score_sketch_dim else xc.rounds
    assert sr.scored_reduce.launches == before + want
    cpu = run("osafl", xc, eval_samples=64, device="cpu")
    for g, c in zip(gpu, cpu):
        assert g["participants"] == c["participants"]
        assert abs(g["test_loss"] - c["test_loss"]) <= 1e-4 * abs(
            c["test_loss"])


def test_fused_segments_are_invariant_under_replay(cuda):
    eng, _, carry = _fused_engine(cuda, resource_backend="f32")
    _, full = eng.run_segment(carry, 4)
    eng2, _, c2 = _fused_engine(cuda, resource_backend="f32")
    parts = [eng2.run_segment(c2, k)[1] for k in (2, 1, 1)]
    for k in ("test_loss", "participants", "lam_use"):
        assert torch.equal(full[k], torch.cat([p[k] for p in parts])), k
    assert torch.equal(carry.w, c2.w)
    assert torch.equal(carry.d_buffer, c2.d_buffer)
    assert [c["length"] for c in eng2.capture_log] == [2, 1]


def test_fused_replay_parity_on_card(cuda):
    """The dispatch round's components on the card, fed the fused engine's
    draws (x64 solve), give the replayed segment bit for bit."""
    import numpy as np
    from repro_torch.core import round_fused as rf
    from repro_torch.core.client import make_vmapped_local_train
    from repro_torch.core.resource import pathloss_linear
    from repro_torch.core.resource_stacked import (ChannelBatch,
                                                   optimize_clients_batched)
    from repro_torch.models.small import small_loss
    eng, _, carry = _fused_engine(cuda, resource_backend="x64")
    _, outs = eng.run_segment(carry, 2)
    _, s, _ = _fused_engine(cuda, resource_backend="x64")
    local_step = make_vmapped_local_train(s.grad_fn, s.fl.local_lr,
                                          s.fl.kappa_max)
    xi = pathloss_linear(s.sysb.distance)
    losses = []
    for t in range(2):
        dr = rf.round_draws(eng.spec, torch.tensor(t, device=cuda))
        counts = rf.draw_counts(dr.arrivals, eng.p_ac).cpu().numpy()
        s.rstream._noise = lambda L, noise=dr.noise: noise
        s.rstream._to_device = lambda noise: noise
        s.sbuf.stage(*s.rstream.draw(counts, 2, 4))
        s.sbuf.commit()
        gamma = 10.0 ** (rf.draw_shadowing_db(dr.normals).double() / 10.0)
        dec = optimize_clients_batched(
            s.net, s.sysb, ChannelBatch(xi=xi, gamma=gamma.cpu().numpy()),
            s.n_params, backend="x64", device=cuda)
        st = s.sbuf.state
        slots = rf.draw_slots(dr.slots, st.size, st.head, st.cap)
        d, _ = local_step(s.server.params, s.sbuf.gather(slots.cpu().numpy()),
                          torch.as_tensor(dec.kappa, device=cuda))
        s.server.round_stacked(s.codec.flatten_stacked(d), dec.kappa >= 1)
        losses.append(float(small_loss(s.server.params, s.test_batch,
                                       s.model)[0]))
    assert outs["test_loss"].tolist() == losses
    assert torch.equal(carry.w, s.server.w)
    assert torch.equal(carry.d_buffer, s.server.d_buffer)
    assert torch.equal(carry.buf.x, s.sbuf.state.x)
    assert np.array_equal(outs["lam_use"][-1].numpy(),
                          np.asarray(s.server.last_scores, np.float32))


def test_counter_draws_on_card_are_the_cpu_draws(cuda):
    from repro_torch.core import round_fused as rf
    eng, _, _ = _fused_engine("cpu")
    for t in (0, 5, 2 ** 33 + 3):
        a = rf.round_draws(eng.spec, torch.tensor(t))
        b = rf.round_draws(eng.spec, torch.tensor(t, device=cuda))
        for x, y in zip((a.arrivals, a.normals, a.slots, *a.noise),
                        (b.arrivals, b.normals, b.slots, *b.noise)):
            assert torch.equal(x, y.cpu())


def test_warm_segment_is_one_graph_launch(cuda):
    from torch.profiler import ProfilerActivity, profile
    eng, _, carry = _fused_engine(cuda, resource_backend="f32")
    eng.run_segment(carry, 2)                 # capture
    before = sr.scored_reduce.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run_segment(carry, 2)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert names.count("cudaGraphLaunch") == 1
    assert names.count("cudaLaunchKernel") == 0
    assert sr.scored_reduce.launches == before + 2
    assert [c["launches"] for c in eng.capture_log] == [2]


def test_serving_on_card_matches_cpu(cuda, tmp_path):
    import numpy as np
    from repro_torch.checkpoint import save_run_state_v2
    from repro_torch.core.flatten import make_codec
    from repro_torch.launch.serve import ModelServer, make_request_batch
    from repro_torch.models.small import init_small
    for model, dataset in (("mlp", 2), ("fcn", 1)):
        w = make_codec(init_small(1, model, "cpu")).flatten(
            init_small(1, model, "cpu"))
        d = tmp_path / model
        save_run_state_v2(d / "round_00002",
                          {"config": {"model": model},
                           "server": {"w": w.numpy()}, "next_round": 2})
        x = make_request_batch(np.random.default_rng(0), 16, dataset)
        with ModelServer(d, device=cuda) as gpu, \
                ModelServer(d, claim=False, device="cpu") as cpu:
            assert gpu.poll() and cpu.poll()
            np.testing.assert_allclose(gpu.score(x), cpu.score(x),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_params", [18_000, 381_284, 1_118_500,
                                      3_900_000])
def test_f32_solve_decisions_on_card_are_the_cpu_decisions(cuda, n_params):
    """The card's transcendental functions round otherwise than the CPU's;
    the f32 solve's knife-edge slacks keep its kappas and feasibility the
    CPU's (and x64's) at the paper's cohort."""
    import numpy as np
    from repro_torch.core import resource as tres
    from repro_torch.core import resource_stacked as trs
    net = tres.NetworkConfig()
    rng = np.random.default_rng(0)
    sysb = trs.stack_clients(tres.make_clients(rng, 256))
    for _ in range(4):
        chb = trs.sample_channels(rng, sysb)
        got = trs.optimize_clients_batched(net, sysb, chb, n_params,
                                           backend="f32", device=cuda)
        want = trs.optimize_clients_batched(net, sysb, chb, n_params,
                                            backend="f32", device="cpu")
        np.testing.assert_array_equal(got.kappa, want.kappa)
        np.testing.assert_array_equal(got.feasible, want.feasible)


# -- the flash backward and the training path --------------------------------

# (B, H, Hkv, S, D): the training shape, S of one key, ragged S over the
# f32 and the three bf16 buckets, a 7:1 group; for the ordered dq of the
# Hopper route, eight key tiles of an 8:1 group at a ragged S, and
# h2o-danube's D = 120 (a ragged bucket of 128)
BWD_SHAPES = [(2, 20, 20, 1024, 128), (1, 7, 1, 1, 128), (2, 14, 2, 130, 40),
              (1, 4, 4, 77, 64), (2, 4, 2, 300, 128), (1, 8, 2, 130, 256),
              (1, 16, 2, 1000, 128), (2, 8, 8, 777, 120)]


# the error's Frobenius norm over the gradient's own
FRO_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _grads_close(got, want, dtype):
    """Each gradient on its own: its largest error within FLASH_TOL of its
    own largest magnitude, the Frobenius norm of its error within FRO_TOL
    of its own. With one key, dS = P (dp - delta) cancels to rounding
    noise in dq and dk, so at S = 1 both are taken over the largest among
    dq, dk and dv instead."""
    want = [w.float() for w in want]
    one_key = want[0].shape[-2] == 1
    top = max(float(w.abs().max()) for w in want)
    top_fro = max(float(w.norm()) for w in want)
    for g, w in zip(got, want):
        e = g.float() - w
        largest, fro = ((top, top_fro) if one_key
                        else (float(w.abs().max()), float(w.norm())))
        assert float(e.abs().max()) <= FLASH_TOL[dtype] * largest
        assert float(e.norm()) <= FRO_TOL[dtype] * fro


def _bwd_inputs(cuda, B, H, Hkv, S, D, dtype, causal, seed=0):
    q, k, v = _qkv(cuda, B, H, Hkv, S, D, dtype, seed=seed)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(seed + 1), device=cuda).to(dtype)
    lse = torch.empty((B, H, S), device=cuda)
    o = fa.flash_attention_bhsd(q, k, v, causal=causal, lse=lse)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_matches_plain_version(cuda, shape, dtype, causal):
    """Each of dq, dk, dv on its own (``_grads_close``); the forward's
    log-sum-exp within 1e-4 of the plain one's."""
    q, k, v, o, lse, do = _bwd_inputs(cuda, *shape, dtype, causal)
    _, plain_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                            return_lse=True)
    torch.testing.assert_close(lse, plain_lse, rtol=0, atol=1e-4)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    want = fa.flash_attention_plain_bwd(q, k, v, o, lse, do, causal=causal)
    for g, x in zip(got, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
    _grads_close(got, want, dtype)


def test_flash_backward_on_model_layout_views(cuda):
    """``ops.flash_attention``'s autograd on the training path's bf16
    model-layout tensors, read and written through strides, against the
    plain forward and backward on the same inputs."""
    B, H, S, D = 8, 20, 256, 128
    bhsd = _qkv(cuda, B, H, H, S, D, torch.bfloat16, seed=5)
    bhsd.append(torch.randn((B, H, S, D), device=cuda).to(torch.bfloat16))
    q, k, v, do = (x.transpose(1, 2).contiguous() for x in bhsd)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    ops.flash_attention(qg, kg, vg).backward(do)
    bq, bk, bv, bdo = (x.transpose(1, 2) for x in (q, k, v, do))
    o, lse = fa.flash_attention_plain(bq, bk, bv, return_lse=True)
    want = fa.flash_attention_plain_bwd(bq, bk, bv, o, lse, bdo)
    _grads_close([x.grad.transpose(1, 2) for x in (qg, kg, vg)], want,
                 torch.bfloat16)


@pytest.mark.parametrize("shape,dtype,causal", [
    ((2, 14, 2, 300, 128), torch.bfloat16, True),
    ((1, 16, 2, 1000, 128), torch.bfloat16, True),    # 8 key tiles in turn
    ((1, 16, 2, 1000, 128), torch.bfloat16, False),
    ((2, 8, 8, 777, 120), torch.bfloat16, True),
    ((1, 8, 2, 130, 256), torch.bfloat16, True),      # the mma.sync route
    ((2, 14, 2, 300, 128), torch.float32, True)])     # the f32 route
def test_flash_backward_is_deterministic(cuda, shape, dtype, causal):
    """Three runs give the same bits: the Hopper route adds dq's partial
    sums in a fixed order of turns, the others own each output."""
    q, k, v, o, lse, do = _bwd_inputs(cuda, *shape, dtype, causal, seed=3)
    a = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for _ in range(2):
        b = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("shape", [(1, 16, 2, 1000, 128), (1, 4, 4, 77, 64),
                                   (1, 8, 2, 130, 256)])
def test_flash_backward_phases_run_apart(cuda, shape):
    """The C entry point's phases (preprocess, main kernel, dq) launched
    one at a time, as chip_smoke.py times them, give the whole backward's
    bits, with the turns zeroed before the main kernel."""
    q, k, v, o, lse, do = _bwd_inputs(cuda, *shape, torch.bfloat16, True)
    want = fa.flash_attention_bwd(q, k, v, o, lse, do)
    got = [torch.empty_like(x) for x in (q, k, v)]
    scratch = fa._bwd_scratch(q)
    for phase in fa.BWD_PHASES.values():
        if scratch["turns"] is not None:
            scratch["turns"].zero_()
        fa._launch_bwd(q, k, v, o, lse, do, *got, scratch, True,
                       shape[-1] ** -0.5, phase)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("shape,dtype,short", [
    ((1, 16, 2, 1000, 128), torch.bfloat16, "delta"),
    ((1, 16, 2, 1000, 128), torch.bfloat16, "dq_accum"),
    ((2, 8, 8, 777, 120), torch.bfloat16, "turns"),
    ((1, 4, 4, 77, 64), torch.bfloat16, "dq_accum"),
    ((1, 8, 2, 130, 256), torch.bfloat16, "delta"),
    ((2, 14, 2, 300, 128), torch.float32, "delta")])
def test_flash_backward_refuses_short_scratch(cuda, shape, dtype, short):
    """The C entry point holds the scratch layout too: one element short
    of any buffer its route uses, it launches nothing and says why."""
    q, k, v, o, lse, do = _bwd_inputs(cuda, *shape, dtype, True)
    scratch = fa._bwd_scratch(q)
    scratch[short] = scratch[short].flatten()[:-1]
    got = [torch.empty_like(x) for x in (q, k, v)]
    with pytest.raises(RuntimeError, match="scratch given is smaller"):
        fa._launch_bwd(q, k, v, o, lse, do, *got, scratch, True,
                       shape[-1] ** -0.5, 7)


def test_flash_autograd_on_the_card_launches_both_kernels(cuda):
    """``ops.flash_attention`` on model-layout views: one forward and one
    backward launch, gradients as the plain path's on the CPU."""
    q, k, v = (x.transpose(1, 2).contiguous().requires_grad_()
               for x in _qkv(cuda, 2, 14, 2, 70, 64, torch.float32, seed=4))
    do = torch.randn(q.shape, device=cuda)
    before = (fa.flash_attention_bhsd.launches,
              fa.flash_attention_bwd.launches)
    ops.flash_attention(q, k, v).backward(do)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bhsd.launches,
            fa.flash_attention_bwd.launches) == (before[0] + 1,
                                                 before[1] + 1)
    cq, ck, cv = (x.detach().cpu().requires_grad_() for x in (q, k, v))
    ops.flash_attention(cq, ck, cv).backward(do.cpu())
    for x, c in zip((q, k, v), (cq, ck, cv)):
        torch.testing.assert_close(x.grad.cpu(), c.grad, rtol=2e-5,
                                   atol=2e-5)


def test_flash_backward_refuses_what_it_cannot_take(cuda):
    q, k, v, o, lse, do = _bwd_inputs(cuda, 1, 4, 2, 16, 64, torch.float32,
                                      True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_bwd(*(x.double() for x in (q, k, v, o)),
                               lse.double(), do.double())
    strided = torch.randn((1, 4, 16, 128), device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fa.flash_attention_bwd(q, k, v, o, lse, strided)
    with pytest.raises(ValueError, match="contiguous lse"):
        fa.flash_attention_bwd(q, k, v, o,
                               lse.transpose(1, 2).contiguous()
                               .transpose(1, 2), do)


@pytest.mark.parametrize("engine", ["recompute", "exact_tp"])
def test_train_step_on_card_matches_cpu(cuda, engine):
    """One step of a reduced float32 qwen1.5-4b from the same weights and
    batch on the card and on the CPU, within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import pod
    from repro_torch.core.flatten import tree_get, tree_map, tree_paths
    from repro_torch.data.synthetic import learnable_sequence_batch
    from repro_torch.models.transformer import init_model
    cfg = dataclasses.replace(get_config("qwen1.5-4b").reduced(),
                              dtype="float32")
    fl = FLConfig(kappa_max=1, local_lr=0.1, num_clients=2)
    host = init_model(torch.Generator().manual_seed(0), cfg)
    batch = learnable_sequence_batch(torch.Generator().manual_seed(1), cfg,
                                     4, 64)
    if engine == "recompute":
        batch = {k: x.reshape(2, 2, -1) for k, x in batch.items()}
        make = lambda: pod.make_recompute_train_step(cfg, fl, None, 2)  # noqa: E731
    else:
        make = lambda: pod.make_tp_train_step(cfg, fl)  # noqa: E731
    before = fa.flash_attention_bwd.launches
    got, gm = make()(tree_map(lambda t: t.to(cuda), host),
                     {k: x.to(cuda) for k, x in batch.items()})
    assert fa.flash_attention_bwd.launches > before
    want, wm = make()(host, batch)
    for k in wm:
        assert abs(float(gm[k]) - float(wm[k])) <= 1e-4 * abs(float(wm[k]))
    for path in tree_paths(want):
        w = tree_get(want, path)
        torch.testing.assert_close(tree_get(got, path).cpu(), w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


# -- the FL harness's pod engine ----------------------------------------------

POD_SMALL = dict(model="mlp", dataset=2, num_clients=8, rounds=3,
                 capacity=(12, 24), arrivals=4, batch=8, seed=5)


@pytest.mark.parametrize("alg", ["osafl", "fedavg"])
@pytest.mark.parametrize("engine", ["exact_tp", "recompute", "stale",
                                    "fedavg"])
@pytest.mark.parametrize("backend", ["python", "stacked"])
def test_pod_run_on_card_matches_cpu(cuda, alg, engine, backend):
    """The pod engine on the card against the CPU within the 1e-4 rule,
    ``scored_reduce`` launched once an OSAFL round (also on the
    unscored-step flavours: the stacked server scores) and never for
    FedAvg."""
    from repro_torch.harness import ExperimentConfig, run
    from repro_torch.launch.mesh import make_host_mesh
    xc = ExperimentConfig(**POD_SMALL, request_backend=backend)
    before = sr.scored_reduce.launches
    gpu = run(alg, xc, eval_samples=64, mesh=make_host_mesh(),
              pod_engine=engine)
    want = xc.rounds if alg == "osafl" else 0
    assert sr.scored_reduce.launches == before + want
    cpu = run(alg, xc, eval_samples=64, device="cpu", mesh=make_host_mesh(),
              pod_engine=engine)
    for g, c in zip(gpu, cpu):
        assert g["participants"] == c["participants"]
        assert abs(g["test_loss"] - c["test_loss"]) <= 1e-4 * abs(
            c["test_loss"])


def test_pod_resume_on_card_is_bit_exact(cuda, tmp_path):
    from repro_torch.harness import ExperimentConfig, checkpoint_path, run
    from repro_torch.launch.mesh import make_host_mesh
    xc = ExperimentConfig(**dict(POD_SMALL, rounds=4))
    straight = run("osafl", xc, eval_samples=64, mesh=make_host_mesh(),
                   save_every_k=2, checkpoint_dir=tmp_path)
    resumed = run("osafl", xc, eval_samples=64, mesh=make_host_mesh(),
                  resume_from=checkpoint_path(tmp_path, 2))
    keys = ("round", "test_loss", "test_acc", "participants")
    assert ([{k: h[k] for k in keys} for h in resumed]
            == [{k: h[k] for k in keys} for h in straight])
