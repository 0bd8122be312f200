"""The transformer zoo's training path of the port against the JAX package
on the CPU: the pod engines' steps (``repro_torch.core.pod``) against the
reference's on a one-device mesh ``jax.make_mesh((1, 1), ("data",
"model"))``, online mode's one-client-at-a-time step on a zoo model with
the caller's batch function, the layouts one card refuses, the
optimizers, the synthetic batches, the trainer ``repro_torch.launch.train``
and the h2o-danube-3-4b config.

Both packages start from the reference's weights (``params_from_numpy``)
and take the same numpy batches; new parameters and metrics agree to rtol
1e-4 (f32 sums in another order), each parameter leaf with an absolute
floor of 1e-4 of its largest magnitude. The key bias ``bk`` is the
exception: its gradient is zero in exact arithmetic (one vector added to
every key moves no softmax), so from its zero start it holds only the
remainders of that cancellation, and it takes the floor of its sibling
``bq``. The stale engine's count-sketch signs are the reference's
``PRNGKey(17)`` ones (``core.scores.sketch_signs_int8`` replaced).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.configs.base import EncoderConfig, FLConfig
from repro_torch.core import pod, scores
from repro_torch.core.flatten import tree_get, tree_map, tree_paths
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train
from repro_torch.launch.mesh import (HostMesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import transformer
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401

RTOL = 1e-4
METRICS = ("loss", "lambda_mean", "lambda_min", "lambda_max")
SKETCH = 64           # the stale engine's sketch width in these tests


@pytest.fixture(scope="module")
def mesh(reference):
    return jax.make_mesh((1, 1), ("data", "model"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's intra-op threads held at 1 while this module runs: the test
    suite runs several files at once on a few cores, where more threads
    only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(reference, arch="qwen1.5-4b", seed=0):
    jc = dataclasses.replace(reference.configs.get_config(arch).reduced(),
                             dtype="float32")
    tc = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    w = to_numpy_tree(reference.transformer.init_model(
        jax.random.PRNGKey(seed), jc))
    return jc, tc, w, transformer.params_from_numpy(w, tc, device="cpu")


def _batch(vocab, shape, seed):
    tok = np.random.default_rng(seed).integers(0, vocab, size=shape[:-1]
                                               + (shape[-1] + 1,))
    return {"tokens": tok[..., :-1].astype(np.int32),
            "labels": tok[..., 1:].astype(np.int32)}


def _reference_signs(tree, k):
    """The reference's sketch_tree signs: leaf i (sorted-key order) draws
    rademacher(fold_in(PRNGKey(17), i)) over its length padded to k."""
    key = jax.random.PRNGKey(17)
    out = []
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        n = leaf.size
        s = jax.random.rademacher(jax.random.fold_in(key, i),
                                  (n + (-n) % k,), jnp.float32)
        out.append(np.array(s[:n]))
    return out


def _params_close(got, want, rtol=RTOL):
    want = to_numpy_tree(want)
    assert tree_paths(got) == tree_paths(want)
    for path in tree_paths(want):
        w = tree_get(want, path)
        floor = tree_get(want, path[:-1] + ("bq",)) if path[-1] == "bk" else w
        np.testing.assert_allclose(tree_get(got, path).numpy(), w, rtol=rtol,
                                   atol=rtol * np.abs(floor).max(),
                                   err_msg=str(path))


def _metrics_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)


def _eager(reference, monkeypatch, step, cfg):
    """The reference's recompute step with its score arithmetic run op by
    op. Jitted on the CPU, its lambdas lie 7e-4 from the float64 cosines
    of its own per-client gradients (0.84604 against 0.84532 on the first
    step below: XLA's f32 reductions over the 1.6M-element trees); eager
    they lie within 2e-5, and the port's within 1e-7. The model's loss,
    whose gradients are not at fault, stays compiled (the reference's own
    ``loss_fn`` under ``jax.jit``), which spares a compile per primitive."""
    loss = reference.pod.loss_fn
    compiled = jax.jit(lambda p, b: loss(p, b, cfg))

    def loss_fn(p, b, c):
        assert c is cfg
        with jax.disable_jit(False):
            return compiled(p, b)
    monkeypatch.setattr(reference.pod, "loss_fn", loss_fn)

    def run(*args):
        with jax.disable_jit():
            return step(*args)
    return run


def _steps(reference, mesh, engine, fl, jc, tc, U, monkeypatch=None):
    """The reference's step (jitted; recompute's eager where a
    ``monkeypatch`` is given) and the port's, for ``engine``."""
    R, T = reference.pod, pod
    jfl = reference.base.FLConfig(**dataclasses.asdict(fl))
    if engine == "exact_tp":
        return (jax.jit(R.make_tp_train_step(jc, jfl, mesh)),
                T.make_tp_train_step(tc, fl))
    if engine == "exact_tp_sketch":
        return (jax.jit(R.make_tp_train_step(jc, jfl, mesh,
                                             sketch_dim=SKETCH)),
                T.make_tp_train_step(tc, fl, sketch_dim=SKETCH))
    if engine == "recompute":
        step = R.make_recompute_train_step(jc, jfl, mesh, U)
        return (jax.jit(step) if monkeypatch is None
                else _eager(reference, monkeypatch, step, jc),
                T.make_recompute_train_step(tc, fl, None, U))
    if engine == "fedavg":
        return (jax.jit(R.make_fedavg_train_step(jc, jfl, mesh)),
                T.make_fedavg_train_step(tc, fl))
    raise ValueError(engine)


@pytest.mark.parametrize("engine", ["exact_tp", "exact_tp_sketch",
                                    "recompute", "fedavg"])
def test_engine_steps_match_reference(reference, mesh, monkeypatch, engine):
    """Two steps of exact_tp and fedavg, one of exact_tp with sketched
    scores and one of recompute (whose reference runs eagerly) from the
    same weights and batches; the scored engines see two clients of two
    sequences (recompute) or the one client row (exact_tp)."""
    jc, tc, w, tp = _model(reference)
    U = 2
    fl = FLConfig(kappa_max=1, local_lr=0.1, global_lr=1.0, num_clients=U)
    jstep, tstep = _steps(reference, mesh, engine, fl, jc, tc, U,
                          monkeypatch)
    jp = w
    for t in range(2 if engine in ("exact_tp", "fedavg") else 1):
        shape = (U, 2, 16) if engine == "recompute" else (4, 16)
        b = _batch(jc.vocab_size, shape, seed=10 + t)
        jp, jm = jstep(jp, {k: jnp.asarray(x) for k, x in b.items()})
        tp, tm = tstep(tp, {k: torch.from_numpy(x) for k, x in b.items()})
        _params_close(tp, jp)
        _metrics_close(tm, jm)
    if engine != "fedavg":
        assert set(tm) == set(METRICS)
        assert (fl.chi - 1) / (fl.chi + 1) <= float(tm["lambda_min"]) \
            <= float(tm["lambda_max"]) <= 1 + 1e-6


def test_stale_steps_match_reference(reference, mesh, monkeypatch):
    """Round t weighted by round t-1's lambdas (ones at first), each round's
    lambdas from its 1024-dim count sketches under the reference's signs."""
    jc, tc, w, tp = _model(reference, seed=1)
    U = 2
    fl = FLConfig(kappa_max=1, local_lr=0.1, global_lr=1.0, num_clients=U)
    jfl = reference.base.FLConfig(**dataclasses.asdict(fl))
    jstep = jax.jit(reference.pod.make_stale_score_train_step(
        jc, jfl, mesh, U))
    signs = _reference_signs(w, 1024)
    monkeypatch.setattr(scores, "sketch_signs_int8",
                        lambda key, i, n, device="cpu":
                        torch.from_numpy(signs[i]).to(device))
    tstep = pod.make_stale_score_train_step(tc, fl, None, U)
    jp, jlam = w, jnp.ones((U,), jnp.float32)
    tlam = torch.ones((U,))
    for t in range(3):
        b = _batch(jc.vocab_size, (U, 2, 16), seed=20 + t)
        jp, jlam, jm = jstep(jp, jlam, {k: jnp.asarray(x)
                                        for k, x in b.items()})
        tp, tlam, tm = tstep(tp, tlam, {k: torch.from_numpy(x)
                                        for k, x in b.items()})
        _params_close(tp, jp)
        _metrics_close(tm, jm)
        np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), rtol=RTOL)


def test_recompute_accumulates_in_bf16_on_request(reference, mesh,
                                                  monkeypatch):
    """``REPRO_ACCUM_BF16=1``: both packages sum the clients' gradients in
    bf16; the updates agree to the repo's bf16 tolerance (2e-2 of their
    largest magnitude: a bf16 ulp is 2**-8)."""
    monkeypatch.setenv("REPRO_ACCUM_BF16", "1")
    jc, tc, w, tp = _model(reference, seed=2)
    fl = FLConfig(kappa_max=1, local_lr=0.1, num_clients=2)
    jstep, tstep = _steps(reference, mesh, "recompute", fl, jc, tc, 2)
    b = _batch(jc.vocab_size, (2, 2, 16), seed=30)
    jp, jm = jstep(w, {k: jnp.asarray(x) for k, x in b.items()})
    new, tm = tstep(tp, {k: torch.from_numpy(x) for k, x in b.items()})
    jp = to_numpy_tree(jp)
    for path in tree_paths(w):
        want = tree_get(jp, path) - tree_get(w, path)
        got = (tree_get(new, path) - tree_get(tp, path)).numpy()
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max(), path
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=RTOL)


def test_tp_microbatches_average_their_gradients(reference, mesh):
    """``kappa_max`` > 1 splits the row's batch into microbatches."""
    jc, tc, w, tp = _model(reference, seed=3)
    fl = FLConfig(kappa_max=2, local_lr=0.1, num_clients=1)
    jfl = reference.base.FLConfig(**dataclasses.asdict(fl))
    b = _batch(jc.vocab_size, (4, 16), seed=40)
    jp, jm = jax.jit(reference.pod.make_tp_train_step(jc, jfl, mesh))(
        w, {k: jnp.asarray(x) for k, x in b.items()})
    tp, tm = pod.make_tp_train_step(tc, fl)(
        tp, {k: torch.from_numpy(x) for k, x in b.items()})
    _params_close(tp, jp)
    _metrics_close(tm, jm)


def test_what_one_card_does_not_run_raises():
    """One client row runs, stationary and online; a mesh of two rows
    needs a torch.distributed group of two ranks (``ValueError`` without
    one); a 'model' axis or the production mesh raise naming ROADMAP A7;
    a layout that is not a mesh raises ``TypeError``."""
    cfg = get_config("qwen1.5-4b").reduced()
    fl = FLConfig(kappa_max=1)
    one = make_host_mesh()
    assert pod.num_pod_clients() == 1
    assert pod.num_pod_clients(one) == 1
    with pytest.raises(TypeError, match="make_host_mesh"):
        pod.make_tp_train_step(cfg, fl, mesh=4)
    two = HostMesh(np.full((2, 1), None, dtype=object))
    assert pod.num_pod_clients(two) == 2
    for make in (lambda m, **kw: pod.make_tp_train_step(cfg, fl, m, **kw),
                 lambda m, **kw: pod.make_fedavg_train_step(cfg, fl, m, **kw),
                 lambda m, **kw: pod.make_recompute_train_step(cfg, fl, m, 2,
                                                               **kw),
                 lambda m, **kw: pod.make_stale_score_train_step(cfg, fl, m,
                                                                 2, **kw)):
        for kw in ({}, dict(batch_fn=pod.make_pod_batch_fn())):
            with pytest.raises(ValueError, match="torch.distributed"):
                make(two, **kw)
        assert callable(make(one, batch_fn=pod.make_pod_batch_fn()))
    for refused in (lambda: make_host_mesh(model_parallel=2),
                    make_production_mesh):
        with pytest.raises(NotImplementedError, match="A7"):
            refused()


def test_online_scan_form_trains_a_zoo_model_with_the_default_gradient(
        reference, mesh):
    """The recompute factory's online step on a reduced qwen1.5-4b with the
    caller's batch function (rows of tokens and labels gathered from each
    client's own storage) and no ``grad_fn``: the gradient of the zoo's
    ``loss_fn``, one client at a time, against the reference's scan."""
    jc, tc, w, tp = _model(reference, seed=5)
    fl = FLConfig(kappa_max=2, local_lr=0.1, num_clients=2)
    jfl = reference.base.FLConfig(**dataclasses.asdict(fl))
    rng = np.random.default_rng(6)
    tok = rng.integers(0, tc.vocab_size, size=(2, 6, 17)).astype(np.int32)
    slots = rng.integers(0, 6, size=(2, 2, 2))
    kappas = np.array([2, 1])

    def rows(xp):
        def batch_fn(bx, by, sl):
            uu = xp.arange(bx.shape[0]).reshape(-1, 1, 1)
            return {"tokens": bx[uu, sl], "labels": by[uu, sl]}
        return batch_fn
    jd, jw = jax.jit(reference.pod.make_recompute_train_step(
        jc, jfl, mesh, 2, batch_fn=rows(jnp)))(
            w, jnp.asarray(tok[..., :-1]), jnp.asarray(tok[..., 1:]),
            jnp.asarray(slots), jnp.asarray(kappas))
    td, tw = pod.make_recompute_train_step(
        tc, fl, make_host_mesh(), 2, batch_fn=rows(torch))(
            tp, torch.from_numpy(tok[..., :-1]),
            torch.from_numpy(tok[..., 1:]), torch.from_numpy(slots),
            torch.from_numpy(kappas))
    _params_close(tw, jw)
    _params_close(td, jd)


# -- optimizers --------------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
            "b": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("name,kw", [("sgd", dict(lr=0.1)),
                                     ("sgd", dict(lr=0.1, momentum=0.9)),
                                     ("adam", dict(lr=1e-2))])
def test_optimizers_match_reference(reference, name, kw):
    jopt = getattr(reference.optim, name)(**kw)
    topt = getattr(optim, name)(**kw)
    jparams = _tree(0)
    tparams = tree_map(torch.from_numpy, _tree(0))
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    assert tree_paths(tstate) == tree_paths(to_numpy_tree(jstate))
    for t in range(3):
        g = _tree(10 + t)
        jupd, jstate = jopt.update(g, jstate, jparams)
        tupd, tstate = topt.update(tree_map(torch.from_numpy, g), tstate,
                                   tparams)
        jparams = reference.optim.apply_updates(jparams, jupd)
        tparams = optim.apply_updates(tparams, tupd)
        for path in tree_paths(jparams):
            np.testing.assert_allclose(tree_get(tparams, path).numpy(),
                                       np.asarray(tree_get(jparams, path)),
                                       rtol=1e-6, atol=1e-7)
        for path in tree_paths(to_numpy_tree(jstate)):
            np.testing.assert_allclose(
                tree_get(tstate, path).numpy(),
                np.asarray(tree_get(jstate, path)), rtol=1e-6, atol=1e-7)
    if name == "adam":
        assert tstate["t"].dtype == torch.int32 and int(tstate["t"]) == 3


# -- synthetic batches -------------------------------------------------------

def test_learnable_batch_is_the_reference_batch_at_its_phases(reference):
    jc = reference.configs.get_config("qwen1.5-4b").reduced()
    tc = get_config("qwen1.5-4b").reduced()
    key = jax.random.PRNGKey(5)
    want = reference.synthetic.learnable_sequence_batch(key, jc, 6, 20)
    phase = np.array(jax.random.randint(key, (6, 1), 0, 8))
    got = synthetic.learnable_sequence_batch(None, tc, 6, 20, phase=phase)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the port's own draw: every phase of the period, labels one ahead
    drawn = synthetic.learnable_sequence_batch(
        torch.Generator().manual_seed(0), tc, 256, 12)
    assert set(drawn["tokens"][:, 0].tolist()) == set(range(8))
    np.testing.assert_array_equal(drawn["labels"][:, :-1].numpy(),
                                  drawn["tokens"][:, 1:].numpy())


def test_train_batches_have_the_reference_shapes(reference):
    jc = reference.configs.get_config("deepseek-coder-33b").reduced()
    tc = get_config("deepseek-coder-33b").reduced()
    want = reference.synthetic.train_batch_shapes(jc, 3, 7)
    got = synthetic.train_batch_shapes(tc, 3, 7)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.int32 == torch.from_numpy(
            np.zeros(0, want[k].dtype)).dtype
    b = synthetic.make_train_batch(torch.Generator().manual_seed(1), tc, 3, 7)
    assert b["tokens"].shape == (3, 7) and b["tokens"].dtype == torch.int32
    assert int(b["tokens"].max()) < tc.vocab_size
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    # an encoder config adds the frames, as in the reference (since the
    # encoder family is ported): bf16 specs, f32 draws, f32 zeros
    enc = dataclasses.replace(tc, encoder=EncoderConfig())
    jenc = dataclasses.replace(jc, encoder=reference.base.EncoderConfig())
    spec = reference.synthetic.train_batch_shapes(jenc, 2, 4)["frames"]
    for fn, dtype in ((synthetic.train_batch_shapes, torch.bfloat16),
                      (lambda *a: synthetic.make_train_batch(
                          torch.Generator(), *a), torch.float32),
                      (lambda *a: synthetic.learnable_sequence_batch(
                          torch.Generator(), *a), torch.float32)):
        frames = fn(enc, 2, 4)["frames"]
        assert tuple(frames.shape) == spec.shape == (2, 1500, tc.d_model)
        assert frames.dtype == dtype


# -- the trainer -------------------------------------------------------------

@pytest.mark.parametrize("engine", train.ENGINES)
def test_trainer_runs_every_engine_on_the_cpu(reference, tmp_path, engine):
    """Three steps of the learnable task: the loss falls, the metrics are
    the reference's names plus ``step_s``, no kernel launches on the CPU;
    the checkpoint is one the reference's ``checkpoint.restore`` reads."""
    launches = (fa.flash_attention_bhsd.launches,
                fa.flash_attention_bwd.launches)
    ckpt = tmp_path / "params"
    params, hist = train.run("qwen1.5-4b", steps=3, engine=engine, seq=32,
                             num_clients=2, device="cpu", ckpt=str(ckpt),
                             log_every=10)
    assert (fa.flash_attention_bhsd.launches,
            fa.flash_attention_bwd.launches) == launches
    names = ("loss",) if engine == "fedavg" else METRICS
    assert [set(h) for h in hist] == [set(names) | {"step_s"}] * 3
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(np.isfinite(h["loss"]) and h["step_s"] > 0 for h in hist)
    like = reference.transformer.init_model(
        jax.random.PRNGKey(0),
        reference.configs.get_config("qwen1.5-4b").reduced())
    back = to_numpy_tree(reference.checkpoint.restore(str(ckpt), like))
    for path in tree_paths(back):
        np.testing.assert_array_equal(tree_get(back, path),
                                      tree_get(params, path).numpy())
    assert reference.checkpoint.load_metadata(str(ckpt))["step"] == 3


def test_trainer_cli_and_device_rule(monkeypatch, capsys):
    train.main(["--device", "cpu", "--steps", "2", "--engine", "stale",
                "--num-clients", "2", "--seq", "16", "--batch", "4"])
    out = capsys.readouterr().out
    assert "engine=stale" in out and "step    1" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run("qwen1.5-4b", steps=1)
    with pytest.raises(ValueError, match="unknown engine"):
        train.run("qwen1.5-4b", steps=1, engine="sketch", device="cpu")


# -- h2o-danube-3-4b ---------------------------------------------------------

def test_h2o_danube_config_and_gradients_match_reference(reference,
                                                         monkeypatch):
    """The config as the reference's, and its sliding-window attention
    (``_sdpa``, differentiated by torch) through ``loss_fn``'s gradients
    over more positions than the reduced window of 64."""
    monkeypatch.delenv("REPRO_USE_FLASH", raising=False)
    j, t = reference.configs.get_config("h2o-danube-3-4b"), \
        get_config("h2o-danube-3-4b")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    jc, tc, w, tp = _model(reference, "h2o-danube-3-4b", seed=4)
    b = _batch(jc.vocab_size, (2, 80), seed=50)
    fl = FLConfig(kappa_max=1, local_lr=0.1, num_clients=1)
    jfl = reference.base.FLConfig(**dataclasses.asdict(fl))
    before = fa.flash_attention_bhsd.launches
    jp, jm = jax.jit(reference.pod.make_fedavg_train_step(jc, jfl, None))(
        w, {k: jnp.asarray(x) for k, x in b.items()})
    tp, tm = pod.make_fedavg_train_step(tc, fl)(
        tp, {k: torch.from_numpy(x) for k, x in b.items()})
    assert fa.flash_attention_bhsd.launches == before
    _params_close(tp, jp)
    _metrics_close(tm, jm)
