"""Train-while-serve (``repro_torch/launch/serve.py``) over the streaming
checkpoint layer, on the CPU; the reference's ``tests/test_serve.py``
contract:

  * every server layout the port writes is scorable (the loop servers'
    ``params``, the stacked and two-tier servers' ``w``, the sparse
    cohort's ``inner``);
  * only committed snapshots are mapped;
  * staleness is monotone and logged;
  * a handle pinned before a reload scores the same logits after it (a
    reload builds new tensors and writes into none that is mapped);
  * claims close the race between retention and a reload;
  * a reference snapshot served by the port gives the reference
    ``ModelServer``'s logits;
  * a live fused trainer in a thread is followed by ``serve_loop`` to its
    last round, within its own bound.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro_torch import checkpoint
from repro_torch.checkpoint import (CheckpointError, prune_checkpoints,
                                    save_run_state_v2, streaming)
from repro_torch.configs.base import FLConfig
from repro_torch.core.baselines import make_server
from repro_torch.core.flatten import make_codec
from repro_torch.harness import ExperimentConfig, run
from repro_torch.launch.serve import (ModelServer, extract_global_model,
                                      make_request_batch, serve_loop)
from repro_torch.models.small import init_small, small_forward
from test_torch_oracle import reference  # noqa: F401

_CODEC = make_codec(init_small(0, "mlp", "cpu"))


def _snap(d, r: int, scale: float = 1.0):
    """A committed RunState-shaped snapshot whose flat weights are
    deterministic in (round, scale)."""
    w = scale * (r + 1) * _CODEC.flatten(init_small(1, "mlp", "cpu"))
    p = d / f"round_{r:05d}"
    save_run_state_v2(p, {"config": {"model": "mlp", "dataset": 2},
                          "server": {"w": w.numpy()}, "next_round": r})
    return p


@pytest.mark.parametrize("layout", ["loop", "stacked", "two-tier",
                                    "sparse", "sparse two-tier"])
def test_extract_global_model_layouts(layout):
    """Each server's own ``state_dict`` gives back its global model."""
    params = init_small(3, "mlp", "cpu")
    engine = "loop" if layout == "loop" else "stacked"
    fl = FLConfig(num_clients=8, engine=engine,
                  num_clusters=2 if "two-tier" in layout else 0,
                  cohort_size=4 if "sparse" in layout else 0)
    server = make_server(params, fl, 8, device="cpu")
    snap = {"config": {"model": "mlp"}, "next_round": 4,
            "server": server.state_dict()}
    model, got, rnd = extract_global_model(snap, device="cpu")
    assert model == "mlp" and rnd == 4
    assert torch.equal(_CODEC.flatten(got), _CODEC.flatten(params))
    for leaf in jax.tree.leaves(got):           # new tensors, not views
        assert all(leaf.data_ptr() != p.data_ptr()
                   for p in jax.tree.leaves(params))


def test_extract_refuses_what_is_not_a_run_state():
    w = _CODEC.flatten(init_small(3, "mlp", "cpu")).numpy()
    base = {"config": {"model": "mlp"}, "next_round": 4}
    with pytest.raises(CheckpointError, match="neither"):
        extract_global_model({**base, "server": {"weights": w}}, "cpu")
    with pytest.raises(CheckpointError, match="RunState"):
        extract_global_model({"x": 1}, "cpu")
    with pytest.raises(CheckpointError, match="unknown model"):
        extract_global_model({**base, "config": {"model": "nope"},
                              "server": {"w": w}}, "cpu")


def test_server_maps_only_committed_snapshots(tmp_path):
    _snap(tmp_path, 1)
    # a newer but uncommitted directory: a write in flight, or a crash's
    partial = tmp_path / "round_00002"
    partial.mkdir()
    (partial / "a00000.s00.npy").write_bytes(b"garbage")
    with ModelServer(tmp_path, device="cpu") as server:
        assert server.poll()
        assert server.mapped_round == 1
        assert not server.poll()
        assert server.mapped_round == 1 and server.failed_loads == 0
        _snap(tmp_path, 2)                # the write completes
        assert server.poll()
        assert server.mapped_round == 2
    assert not list(tmp_path.glob("SERVING-*"))   # close() drops the claim


def test_staleness_monotone_and_logged(tmp_path):
    for r in (1, 2, 3):
        _snap(tmp_path, r)
    with ModelServer(tmp_path, device="cpu") as server:
        server.poll()                     # straight to the newest
        assert server.mapped_round == 3 and server.rounds_behind == 0
        for r in (4, 5):
            _snap(tmp_path, r)
        server.poll()
        assert server.mapped_round == 5
        log = server.stats()["reloads"]
        assert [e["round"] for e in log] == [3, 5]
        assert log[0]["behind"] == 0
        assert log[1]["behind"] == 2


def test_staleness_counts_rounds_behind_before_the_swap(tmp_path,
                                                       monkeypatch):
    """A committed round the server has not loaded yet shows as
    ``rounds_behind`` on the poll that sees it."""
    _snap(tmp_path, 1)
    with ModelServer(tmp_path, device="cpu") as server:
        server.poll()
        _snap(tmp_path, 4)
        monkeypatch.setattr(checkpoint, "is_committed", lambda p: False)
        assert not server.poll()          # seen, not loaded
        assert server.rounds_behind == 3 and server.mapped_round == 1


def test_hot_reload_does_not_change_pinned_outputs(tmp_path):
    _snap(tmp_path, 1, scale=1.0)
    x = make_request_batch(np.random.default_rng(0), 8, 2)
    with ModelServer(tmp_path, device="cpu") as server:
        server.poll()
        handle = server.pin()
        before = handle.score(x)
        pinned = [t.clone() for t in jax.tree.leaves(handle._params)]
        _snap(tmp_path, 2, scale=-3.0)    # very different weights
        assert server.poll()              # swap while the handle is live
        after_pinned = handle.score(x)
        after_server = server.score(x)
    np.testing.assert_array_equal(before, after_pinned)
    assert all(torch.equal(a, b) for a, b in
               zip(pinned, jax.tree.leaves(handle._params)))
    assert handle.round == 1
    assert not np.array_equal(before, after_server)


def test_prune_vs_reload_race_is_closed_by_claims(tmp_path):
    _snap(tmp_path, 1)
    with ModelServer(tmp_path, device="cpu") as server:
        server.poll()
        for r in (2, 3):
            _snap(tmp_path, r)
        prune_checkpoints(tmp_path, keep_last=1)
        # the mapped snapshot survived the prune (claimed), still scorable
        assert (tmp_path / "round_00001" / streaming.COMMIT_NAME).exists()
        server.score(make_request_batch(np.random.default_rng(0), 4, 2))
        assert server.poll()
        assert server.mapped_round == 3 and server.failed_loads == 0
        prune_checkpoints(tmp_path, keep_last=1)
        assert not (tmp_path / "round_00001").exists()
        assert (tmp_path / "round_00003" / streaming.COMMIT_NAME).exists()


def test_a_load_that_fails_is_counted_and_retried(tmp_path, monkeypatch):
    _snap(tmp_path, 1)
    with ModelServer(tmp_path, device="cpu") as server:
        real = checkpoint.load_run_state

        def pruned(path):
            raise FileNotFoundError(f"{path} was pruned")
        monkeypatch.setattr(checkpoint, "load_run_state", pruned)
        assert not server.poll()
        assert server.failed_loads == 1 and "pruned" in server.last_error
        assert server.mapped is None
        monkeypatch.setattr(checkpoint, "load_run_state", real)
        assert server.poll() and server.mapped_round == 1


def test_poll_on_empty_and_pin_before_map(tmp_path):
    with ModelServer(tmp_path / "nothing", device="cpu") as server:
        assert not server.poll()
        with pytest.raises(RuntimeError, match="no model mapped"):
            server.pin()


def test_reference_snapshot_served_as_the_reference_serves_it(
        reference, tmp_path):
    """A snapshot the reference wrote, served by both packages' servers:
    the same logits within 1e-5."""
    jparams = reference.small.init_small(jax.random.PRNGKey(7), "mlp")
    w = np.asarray(reference.flatten.make_codec(jparams).flatten(jparams))
    reference.checkpoint.save_run_state_v2(
        tmp_path / "round_00003",
        {"config": {"model": "mlp", "dataset": 2},
         "server": {"w": w.astype(np.float32)}, "next_round": 3})
    x = make_request_batch(np.random.default_rng(1), 16, 2)
    with reference.serve.ModelServer(tmp_path, claim=False) as jserver:
        assert jserver.poll()
        want = jserver.score(x)
    with ModelServer(tmp_path, claim=False, device="cpu") as server:
        assert server.poll() and server.mapped_round == 3
        got = server.score(x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


LIVE = ExperimentConfig(model="mlp", dataset=2, num_clients=8, rounds=4,
                        capacity=(12, 24), arrivals=4, batch=8, seed=5,
                        request_backend="stacked", round_backend="fused",
                        resource_backend="f32", rounds_per_dispatch=2)


def test_serve_loop_follows_live_fused_trainer_thread(tmp_path):
    """A fused run in a thread writes async-v2 snapshots every round while
    ``serve_loop`` polls, scores and reloads to the last round, within
    its own 60 s bound; the last snapshot's logits are the trainer's."""
    ckpt = tmp_path / "ckpt"
    result = {}

    def train():
        try:
            result["history"] = run("osafl", LIVE, eval_samples=32,
                                    device="cpu", save_every_k=1,
                                    checkpoint_dir=ckpt)
        except BaseException as e:        # reported by the main thread
            result["error"] = e
    trainer = threading.Thread(target=train, daemon=True)
    trainer.start()
    try:
        stats = serve_loop(ckpt, until_round=LIVE.rounds, poll_s=0.02,
                           batch=8, dataset=2, timeout_s=60.0, device="cpu")
    finally:
        trainer.join(timeout=60.0)
    assert not trainer.is_alive()
    assert "error" not in result, result.get("error")
    assert len(result["history"]) == LIVE.rounds
    assert stats["mapped_round"] == LIVE.rounds
    assert stats["failed_loads"] == 0, stats["last_error"]
    assert stats["mapped_rounds"] == sorted(set(stats["mapped_rounds"]))
    assert stats["batches"] > 0 and stats["requests_scored"] > 0
    assert len(stats["score_s"]) == stats["batches"]
    snap = checkpoint.load_run_state(ckpt / f"round_{LIVE.rounds:05d}")
    x = make_request_batch(np.random.default_rng(2), 8, 2)
    with ModelServer(ckpt, claim=False, device="cpu") as server:
        server.poll()
        got = server.score(x)
    want = small_forward(_CODEC.unflatten(torch.as_tensor(
        snap["server"]["w"])), torch.as_tensor(x), "mlp").numpy()
    np.testing.assert_array_equal(got, want)


def test_fused_snapshot_serves_the_fused_weights(tmp_path):
    """The snapshot a fused run writes at its last round holds the weights
    a direct engine segment ends with."""
    from repro_torch.harness import build_fused_engine
    run("osafl", LIVE, eval_samples=32, device="cpu", save_every_k=2,
        checkpoint_dir=tmp_path)
    eng, s = build_fused_engine("osafl", LIVE, 32, device="cpu")
    carry = eng.init_carry(s.server, s.sbuf, s.rstream, 0)
    eng.run_segment(carry, 2)
    eng.run_segment(carry, 2)
    _, params, rnd = extract_global_model(
        checkpoint.load_run_state(tmp_path / "round_00004"), "cpu")
    assert rnd == 4
    assert torch.equal(_CODEC.flatten(params), carry.w)
