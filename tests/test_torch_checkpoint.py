"""The port's RunState checkpoints (``repro_torch/checkpoint``) and their
harness wiring, on the CPU.

  * The reference's codec cases that need no mesh, on torch tensors: v2
    round trips of adversarial trees, v1 and v2 loading to one tree, FIFO
    wrap-around buffer states, retention (keep-last, claimed, in-flight),
    a torn write at every shard offset, corrupt artifacts, a missing
    commit marker, a truncated npz.
  * The async writer owns what it was given: a snapshot submitted before
    a round that writes the buffers in place still holds the submitted
    state.
  * Resume within the port is bit-exact: the stacked engine (python and
    stacked requests, async v2 and blocking v1) and the loop engine, for
    OSAFL and FedNova.
  * Snapshots cross the packages: a reference snapshot (python streams;
    stacked and loop engines) resumes in the port within rtol 1e-4 of the
    reference's straight run with the same participants, and a port
    snapshot resumes in the reference within rtol 1e-4 of the port's
    straight run (from the reference's weights).
  * Errors: a reference stacked-stream snapshot is refused naming
    ``streams/key``; a run-shape mismatch names the field.
  * Sparse cohorts, clusters and sketches: sparse, hierarchical and
    sparse-hierarchical runs and a sketched one resume bit-exactly (the
    sketched one with the same signs); flat and hierarchical snapshots
    refuse each other with the reference's ``CheckpointError``s; cohort
    snapshots cross the packages with python requests.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro_torch.harness.experiments as tex
from repro_torch import checkpoint
from repro_torch.checkpoint import (CheckpointError, committed_snapshots,
                                    diff_snapshots, latest_checkpoint,
                                    load_run_state, prune_checkpoints,
                                    save_run_state, save_run_state_v2,
                                    streaming, write_claim, clear_claim)
from repro_torch.configs.base import FLConfig
from repro_torch.core.baselines import make_server
from repro_torch.core.buffer_stacked import StackedOnlineBuffer
from repro_torch.core.flatten import tree_get, tree_map, tree_paths
from repro_torch.core.osafl import ClientUpdate
from repro_torch.harness import (ExperimentConfig, checkpoint_path,
                                 resume_smoke_config, run)
from repro_torch.models.small import init_small, params_from_numpy
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401

from _hyp import given, settings, st

_DTYPES = (np.float32, np.float64, np.float16, np.int64, np.int32,
           np.int8, np.uint32, np.bool_)
_SHAPES = ((), (0,), (1,), (5,), (3, 4), (2, 0, 3))


def _rand_leaf(rng):
    roll = rng.random()
    if roll < 0.65:
        dtype = _DTYPES[rng.integers(len(_DTYPES))]
        shape = _SHAPES[rng.integers(len(_SHAPES))]
        raw = (rng.integers(0, 2, shape) if dtype is np.bool_
               else rng.integers(-7, 120, shape)).astype(dtype)
        return torch.from_numpy(raw) if rng.random() < 0.5 else raw
    if roll < 0.8:
        return [None, "osafl", int(rng.integers(100)), float(rng.random()),
                True, 2 ** 97 + 13][rng.integers(6)]
    return None


def _rand_tree(rng, depth=0):
    out = {}
    for i in range(int(rng.integers(2, 6))):
        key = f"k{i}"
        if depth < 2 and rng.random() < 0.3:
            out[key] = (_rand_tree(rng, depth + 1) if rng.random() < 0.6
                        else [_rand_leaf(rng)
                              for _ in range(int(rng.integers(3)))])
        else:
            out[key] = _rand_leaf(rng)
    return out


def _as_numpy(tree):
    """The tree as a load returns it: tensors become numpy arrays."""
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_numpy(v) for v in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_v2_roundtrip_adversarial_trees(seed):
    import tempfile
    state = _rand_tree(np.random.default_rng(seed))
    with tempfile.TemporaryDirectory(ignore_cleanup_errors=True) as td:
        save_run_state_v2(Path(td) / "round_00001", state,
                          metadata={"seed": seed})
        out = load_run_state(Path(td) / "round_00001")
    diffs = diff_snapshots(_as_numpy(state), out, skip=())
    assert not diffs, diffs


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_v1_and_v2_load_to_identical_trees(seed):
    import tempfile
    state = _rand_tree(np.random.default_rng(seed))
    with tempfile.TemporaryDirectory(ignore_cleanup_errors=True) as td:
        save_run_state(Path(td) / "v1" / "round_00001", state)
        save_run_state_v2(Path(td) / "v2" / "round_00001", state)
        from_v1 = load_run_state(Path(td) / "v1" / "round_00001")
        from_v2 = load_run_state(Path(td) / "v2" / "round_00001")
        assert latest_checkpoint(Path(td) / "v1") is not None
        assert latest_checkpoint(Path(td) / "v2") is not None
    diffs = diff_snapshots(from_v1, from_v2, skip=())
    assert not diffs, diffs


@settings(max_examples=15, deadline=None)
@given(st.integers(2, 9), st.lists(st.integers(0, 12), min_size=1,
                                   max_size=6), st.integers(0, 6))
def test_v2_roundtrip_fifo_wraparound_buffer_states(cap, bursts, tail):
    """Wrap-around FIFO states (heads past the capacity boundary,
    over-capacity commits, an uncommitted staged tail) survive the layout
    and restore into a fresh buffer that continues in lockstep."""
    import tempfile
    C = 7
    caps = np.array([cap, max(cap - 1, 2)])
    kw = dict(stage_capacity=14, dtype=np.int64, device="cpu")
    sbuf = StackedOnlineBuffer.create(caps, (2,), C, **kw)
    counter = 0
    for n in bursts:
        counts = (n, (2 * n + 1) % 13)
        A = int(max(max(counts), 1))
        xs = np.zeros((2, A, 2), np.int64)
        ys = np.zeros((2, A), np.int64)
        for u, cnt in enumerate(counts):
            xs[u, :cnt, 0] = np.arange(counter, counter + cnt)
            ys[u, :cnt] = np.arange(counter, counter + cnt) % C
            counter += cnt
        sbuf.stage(xs, ys, np.asarray(counts))
        sbuf.commit()
    if tail:
        xs = np.full((2, tail, 2), counter, np.int64)
        sbuf.stage(xs, np.zeros((2, tail), np.int64),
                   np.asarray((tail, tail // 2)))
    with tempfile.TemporaryDirectory(ignore_cleanup_errors=True) as td:
        save_run_state_v2(Path(td) / "round_00001",
                          {"buffer": sbuf.state_dict()})
        loaded = load_run_state(Path(td) / "round_00001")
    # the reference's dtypes on disk: int64 leaves are stored as int32
    assert loaded["buffer"]["x"].dtype == loaded["buffer"]["y"].dtype \
        == np.int32
    sbuf2 = StackedOnlineBuffer.create(caps, (2,), C, **kw)
    sbuf2.load_state_dict(loaded["buffer"])
    diffs = diff_snapshots(sbuf.state_dict(), sbuf2.state_dict(), skip=())
    assert not diffs, diffs
    sbuf.commit()
    sbuf2.commit()
    for u in range(2):
        for a, b in zip(sbuf.dataset(u), sbuf2.dataset(u)):
            assert np.array_equal(a, b)


def test_buffer_snapshot_refuses_other_shapes_and_dtypes():
    sbuf = StackedOnlineBuffer.create([3, 4], (2,), 7, stage_capacity=4,
                                      device="cpu")
    sd = sbuf.state_dict()
    other = StackedOnlineBuffer.create([3, 5], (2,), 7, stage_capacity=4,
                                       device="cpu")
    with pytest.raises(CheckpointError, match="'x' has shape"):
        other.load_state_dict(sd)
    with pytest.raises(CheckpointError, match="'y' has dtype float32"):
        sbuf.load_state_dict(dict(sd, y=np.zeros((2, 4), np.float32)))
    with pytest.raises(CheckpointError, match="missing keys: head"):
        sbuf.load_state_dict({k: v for k, v in sd.items() if k != "head"})


# -- retention ---------------------------------------------------------------

def _snap(d: Path, r: int) -> Path:
    p = d / f"round_{r:05d}"
    save_run_state_v2(p, {"r": torch.tensor(r)}, metadata={"round": r})
    return p


def test_prune_keeps_newest_k_committed(tmp_path):
    for r in range(1, 6):
        _snap(tmp_path, r)
    removed = prune_checkpoints(tmp_path, keep_last=2)
    assert sorted(p.name for p in removed) == [
        "round_00001", "round_00002", "round_00003"]
    assert [p.name for p in committed_snapshots(tmp_path)] == [
        "round_00004", "round_00005"]
    assert prune_checkpoints(tmp_path, keep_last=2) == []
    with pytest.raises(ValueError):
        prune_checkpoints(tmp_path, keep_last=0)


def test_prune_never_deletes_claimed_snapshot(tmp_path):
    snaps = [_snap(tmp_path, r) for r in range(1, 5)]
    write_claim(tmp_path, "srv1", [snaps[1]])
    prune_checkpoints(tmp_path, keep_last=1)
    assert [p.name for p in committed_snapshots(tmp_path)] == [
        "round_00002", "round_00004"]
    assert load_run_state(snaps[1])["r"] == 2
    write_claim(tmp_path, "srv1", [snaps[3]])
    prune_checkpoints(tmp_path, keep_last=1)
    assert [p.name for p in committed_snapshots(tmp_path)] == [
        "round_00004"]
    clear_claim(tmp_path, "srv1")
    assert not list(tmp_path.glob("SERVING-*"))


def test_prune_spares_in_flight_write_sweeps_crashed_leftovers(tmp_path):
    for r in (3, 4):
        _snap(tmp_path, r)
    for name in ("round_00001", "round_00005"):   # crashed / in flight
        (tmp_path / name).mkdir()
        (tmp_path / name / "a00000.s00.npy").write_bytes(b"partial")
    prune_checkpoints(tmp_path, keep_last=1)
    assert sorted(p.name for p in tmp_path.glob("round_*")) == [
        "round_00004", "round_00005"]
    assert latest_checkpoint(tmp_path).name == "round_00004"


# -- crashes and corruption ---------------------------------------------------

def _round_state(r: int) -> dict:
    rng = np.random.default_rng(1000 + r)
    return {
        "config": {"model": "mlp", "dataset": 2},
        "server": {"w": torch.from_numpy(
            rng.standard_normal(257).astype(np.float32)),
            "step": np.array(r, dtype=np.int64)},
        "buffer": {"x": rng.standard_normal((8, 16)).astype(np.float32),
                   "count": np.array(r % 5, dtype=np.int32),
                   "mask": torch.from_numpy(rng.integers(0, 2, 24)
                                            .astype(bool)),
                   "ids": rng.integers(-4, 4, 10).astype(np.int8)},
        "next_round": int(r),
    }


def test_torn_write_at_every_shard_offset_is_invisible(tmp_path,
                                                       monkeypatch):
    state = _round_state(7)
    save_run_state_v2(tmp_path / "ref" / "round_00007", state)
    nshards = len(list((tmp_path / "ref" / "round_00007").glob("*.npy")))
    assert nshards >= 5
    for k in range(nshards):
        d = tmp_path / f"torn{k:02d}"
        calls = {"n": 0}

        def hook():
            calls["n"] += 1
            if calls["n"] > k:
                raise KeyboardInterrupt   # die after k+1 shard files

        monkeypatch.setattr(streaming, "_POST_SHARD_HOOK", hook)
        with pytest.raises(KeyboardInterrupt):
            save_run_state_v2(d / "round_00001", state)
        monkeypatch.setattr(streaming, "_POST_SHARD_HOOK", None)
        assert len(list((d / "round_00001").glob("*.npy"))) == k + 1
        assert not checkpoint.is_committed(d / "round_00001")
        assert latest_checkpoint(d) is None
        with pytest.raises(CheckpointError, match="commit marker"):
            load_run_state(d / "round_00001")


def _committed(tmp_path, r=3) -> Path:
    d = tmp_path / f"round_{r:05d}"
    save_run_state_v2(d, _round_state(r), metadata={"round": r})
    return d


def _a_shard(d: Path) -> str:
    man = json.loads((d / streaming.MANIFEST_NAME).read_text())
    for ent in man["arrays"].values():
        for sh in ent["shards"]:
            if sh["nbytes"] > 128:
                return sh["file"]
    raise AssertionError("no big shard in manifest")


def _truncate_shard(d):
    f = d / _a_shard(d)
    f.write_bytes(f.read_bytes()[:-7])
    return f.name, "truncated"


def _flip_byte(d):
    f = d / _a_shard(d)
    raw = bytearray(f.read_bytes())
    raw[-3] ^= 0x40
    f.write_bytes(bytes(raw))
    return f.name, "crc32"


def _delete_shard(d):
    f = d / _a_shard(d)
    f.unlink()
    return f.name, "missing"


def _swap_shard_across_saves(d):
    other = _committed(d.parent / "other", r=4)
    name = _a_shard(d)
    (d / name).write_bytes((other / name).read_bytes())
    return name, "crc32"


def _garble_manifest(d):
    f = d / streaming.MANIFEST_NAME
    f.write_text(f.read_text()[:-40] + "}")
    return f.name, "does not hash"


def _garble_commit(d):
    f = d / streaming.COMMIT_NAME
    f.write_text("{\"format_version\": 2, \"save_")
    return f.name, "corrupt commit marker"


def _mismatched_save_id(d):
    f = d / streaming.COMMIT_NAME
    commit = json.loads(f.read_text())
    commit["save_id"] = "0" * 32
    f.write_text(json.dumps(commit))
    return Path(d).name, "different saves"


@pytest.mark.parametrize("mutate", [
    _truncate_shard, _flip_byte, _delete_shard, _swap_shard_across_saves,
    _garble_manifest, _garble_commit, _mismatched_save_id,
], ids=lambda m: m.__name__.lstrip("_"))
def test_corrupt_artifact_raises_checkpoint_error_naming_it(tmp_path,
                                                            mutate):
    d = _committed(tmp_path)
    load_run_state(d)
    name, reason = mutate(d)
    with pytest.raises(CheckpointError) as exc:
        load_run_state(d)
    assert name in str(exc.value) and reason in str(exc.value)


def test_missing_commit_marker_is_invisible_and_truncated_npz_raises(
        tmp_path):
    d = _committed(tmp_path)
    (d / streaming.COMMIT_NAME).unlink()
    assert latest_checkpoint(tmp_path) is None
    with pytest.raises(CheckpointError, match="commit marker"):
        load_run_state(d)
    stem = tmp_path / "v1" / "round_00002"
    save_run_state(stem, _round_state(2), metadata={"round": 2})
    npz = stem.with_suffix(".npz")
    npz.write_bytes(npz.read_bytes()[:200])
    with pytest.raises(CheckpointError, match="corrupt or truncated") as exc:
        load_run_state(stem)
    assert npz.name in str(exc.value)


def test_params_save_restore_and_version_guard(tmp_path):
    p = init_small(0, "mlp", "cpu")
    checkpoint.save(tmp_path / "p", p, step=3, metadata={"note": "x"})
    back = checkpoint.restore(tmp_path / "p", p)
    assert all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(p),
        torch.utils._pytree.tree_leaves(back)))
    assert checkpoint.load_metadata(tmp_path / "p")["step"] == 3
    bad = tree_map(lambda t: t.double(), p)
    with pytest.raises(CheckpointError, match="dtype mismatch"):
        checkpoint.restore(tmp_path / "p", bad)
    meta = json.loads((tmp_path / "p.meta.json").read_text())
    (tmp_path / "p.meta.json").write_text(json.dumps(
        dict(meta, format_version=99)))
    with pytest.raises(CheckpointError, match="format_version 99"):
        checkpoint.restore(tmp_path / "p", p)


def test_validate_cohort_shapes_names_each_dimension(reference):
    sd = {"user_slot": np.zeros(8, np.int32), "slot_user": np.zeros(4)}
    checkpoint.validate_cohort_shapes(sd, 8, 4)
    for args, match in (((16, 4), "U=8"), ((8, 2), "C=4"),
                        ((8, 4), "slot_user")):
        bad = sd if match != "slot_user" else {"user_slot": sd["user_slot"]}
        with pytest.raises(CheckpointError, match=match) as got:
            checkpoint.validate_cohort_shapes(bad, *args)
        with pytest.raises(reference.checkpoint.CheckpointError) as want:
            reference.checkpoint.validate_cohort_shapes(bad, *args)
        assert str(got.value) == str(want.value)


# -- the async writer owns its snapshot ----------------------------------------

def test_async_snapshot_is_unaffected_by_later_in_place_writes(
        tmp_path, monkeypatch):
    """Submit the server's and the buffer's state, hold the writer back,
    run a round that writes the (U, N) buffer and the FIFO storage in
    place, let the writer go: the files hold the submitted state."""
    U = 4
    srv = make_server(init_small(0, "mlp", "cpu"),
                      FLConfig(engine="stacked", num_clients=U), U,
                      device="cpu")
    sbuf = StackedOnlineBuffer.create([3, 4, 5, 6], (10,), 100,
                                      stage_capacity=8, dtype=np.int64,
                                      device="cpu")
    rng = np.random.default_rng(0)
    srv.round_stacked(torch.randn(U, srv.codec.n), np.ones(U, bool))
    sbuf.stage(rng.integers(0, 100, (U, 8, 10)),
               rng.integers(0, 100, (U, 8)), np.full(U, 8))
    sbuf.commit()
    want = _as_numpy({"server": {k: (v.clone() if torch.is_tensor(v)
                                     else np.copy(v))
                                 for k, v in srv.state_dict().items()},
                      "buffer": {k: (v.clone() if torch.is_tensor(v)
                                     else v)
                                 for k, v in sbuf.state_dict().items()}})
    gate = threading.Event()
    write = streaming._write_v2

    def held_write(*args):
        assert gate.wait(60)
        write(*args)
    monkeypatch.setattr(streaming, "_write_v2", held_write)
    writer = checkpoint.AsyncCheckpointWriter()
    writer.submit(tmp_path / "round_00001",
                  {"server": srv.state_dict(), "buffer": sbuf.state_dict()})
    assert writer.held_bytes > 0
    # a round: every buffer row and the FIFO storage written in place
    d_buffer = srv.d_buffer
    srv.round_stacked(torch.randn(U, srv.codec.n), np.ones(U, bool))
    assert srv.d_buffer is d_buffer
    sbuf.stage(rng.integers(0, 100, (U, 8, 10)),
               rng.integers(0, 100, (U, 8)), np.full(U, 8))
    sbuf.commit()
    assert not torch.equal(srv.d_buffer, torch.from_numpy(
        want["server"]["d_buffer"]))
    gate.set()
    writer.close()
    assert writer.held_bytes == 0
    assert writer.peak_held_bytes == writer.stats[0]["bytes"]
    assert writer.stats[0]["write_s"] >= 0
    got = load_run_state(tmp_path / "round_00001")
    diffs = diff_snapshots(want, got, skip=())
    assert not diffs, diffs


def test_async_writer_reraises_a_failed_write(tmp_path, monkeypatch):
    def broken(*args):
        raise OSError("disk full")
    monkeypatch.setattr(streaming, "_write_v2", broken)
    writer = checkpoint.AsyncCheckpointWriter()
    writer.submit(tmp_path / "round_00001", {"a": np.zeros(3)})
    with pytest.raises(CheckpointError, match="disk full"):
        writer.close()


# -- resume within the port ------------------------------------------------------

def _cfg(rounds, **kw):
    return dataclasses.replace(resume_smoke_config(rounds), **kw)


@pytest.mark.parametrize("engine,alg,backend,asynchronous", [
    ("stacked", "osafl", "python", True),
    ("stacked", "osafl", "stacked", True),
    ("stacked", "fednova", "stacked", False),
    ("stacked", "fednova", "python", True),
    ("loop", "osafl", "python", False),
    ("loop", "fednova", "python", False),
])
def test_resume_is_bit_exact(tmp_path, engine, alg, backend, asynchronous):
    """Run 4 rounds straight, and 2 + save + resume + 2: the histories and
    the final snapshots (weights, contribution buffers, FIFO state and
    staging, scores, Generator positions, stream state) are identical."""
    rounds, half = 4, 2

    def cfg(r):
        return _cfg(r, engine=engine, request_backend=backend)
    kw = dict(eval_samples=64, device="cpu", checkpoint_async=asynchronous)
    da, db = tmp_path / "full", tmp_path / "split"
    full = run(alg, cfg(rounds), save_every_k=rounds, checkpoint_dir=da,
               **kw)
    run(alg, cfg(half), save_every_k=half, checkpoint_dir=db, **kw)
    resumed = run(alg, cfg(rounds), save_every_k=half, checkpoint_dir=db,
                  resume_from=checkpoint_path(db, half), keep_last=1, **kw)
    assert [h["round"] for h in resumed] == list(range(rounds))
    for a, b in zip(full, resumed):
        for k in ("round", "test_loss", "test_acc", "participants"):
            assert a[k] == b[k], (k, a, b)
    assert [p.name for p in committed_snapshots(db)] == ["round_00004"]
    sa = load_run_state(checkpoint_path(da, rounds))
    sb = load_run_state(checkpoint_path(db, rounds))
    layout = "v2" if engine == "stacked" and asynchronous else "v1"
    assert checkpoint_path(da, rounds).is_dir() == (layout == "v2")
    diffs = diff_snapshots(sa, sb)
    assert not diffs, diffs
    assert sa["engine"] == engine and sa["next_round"] == rounds


@pytest.mark.parametrize("kw", [
    dict(cohort_size=4, participation=0.5),
    dict(num_clusters=2),
    dict(cohort_size=4, participation=0.5, num_clusters=2,
         request_backend="stacked", scenario="cluster_churn(rate=0.3)"),
    dict(cohort_size=6, num_clusters=2, scenario="churn(p_away=0.5)"),
    dict(score_sketch_dim=16),
], ids=["sparse", "hier", "sparse-hier-stacked", "sparse-hier-churn",
        "sketched"])
@pytest.mark.parametrize("alg", ["osafl", "fednova"])
def test_cohort_cluster_and_sketch_resume_is_bit_exact(tmp_path, kw, alg):
    """4 rounds straight against 2 + save + resume + 2: histories and final
    snapshots (the slot pools, per-user tables, cluster carries and the
    ``sketch_key`` the signs are drawn from) identical."""
    kwa = dict(eval_samples=64, device="cpu")
    da, db = tmp_path / "full", tmp_path / "split"
    full = run(alg, _cfg(4, **kw), save_every_k=4, checkpoint_dir=da, **kwa)
    run(alg, _cfg(2, **kw), save_every_k=2, checkpoint_dir=db, **kwa)
    resumed = run(alg, _cfg(4, **kw), save_every_k=2, checkpoint_dir=db,
                  resume_from=checkpoint_path(db, 2), **kwa)
    keys = ("round", "test_loss", "test_acc", "participants")
    assert [[h[k] for k in keys] for h in full] == [
        [h[k] for k in keys] for h in resumed]
    sa = load_run_state(checkpoint_path(da, 4))
    diffs = diff_snapshots(sa, load_run_state(checkpoint_path(db, 4)))
    assert not diffs, diffs
    server = sa["server"]
    if kw.get("cohort_size"):
        assert {"inner", "pool", "tables"} <= set(server)
        assert ("pools" in server["pool"]) == bool(kw.get("num_clusters"))
        server = server["inner"]
    if alg == "osafl":
        np.testing.assert_array_equal(server["sketch_key"], [0, 5])
        assert ("clam_prev" in server) == bool(kw.get("num_clusters"))


def _sparse_pair(reference, K):
    fl = dict(num_clients=8, local_lr=0.1, global_lr=1.0, algorithm="osafl",
              engine="stacked", cohort_size=4, num_clusters=K)
    w = {"a": np.arange(6, dtype=np.float32)}
    return (make_server({"a": torch.as_tensor(w["a"])}, FLConfig(**fl), 8,
                        device="cpu"),
            reference.baselines.make_server(
                {"a": jax.numpy.asarray(w["a"])},
                reference.base.FLConfig(**fl), 8))


def test_flat_and_hierarchical_snapshots_refuse_each_other(reference):
    """The reference's ``CheckpointError``s, word for word: a flat pool into
    a clustered run, a clustered pool into a flat one, a dense server's
    snapshot into a sparse run, a dense flat server's into a two-tier one."""
    flat_t, flat_j = _sparse_pair(reference, 0)
    hier_t, hier_j = _sparse_pair(reference, 2)
    dense_fl = dict(num_clients=4, algorithm="osafl", engine="stacked")
    dense = make_server({"a": torch.zeros(6)}, FLConfig(**dense_fl), 4,
                        device="cpu")
    cases = [(hier_t, hier_j, flat_t.state_dict(), flat_j.state_dict()),
             (flat_t, flat_j, hier_t.state_dict(), hier_j.state_dict()),
             (flat_t, flat_j, dense.state_dict(), dense.state_dict())]
    for got_srv, want_srv, got_sd, want_sd in cases:
        with pytest.raises(reference.checkpoint.CheckpointError) as want:
            want_srv.load_state_dict(want_sd)
        with pytest.raises(CheckpointError) as got:
            got_srv.load_state_dict(got_sd)
        assert str(got.value) == str(want.value)
    two_tier = make_server({"a": torch.zeros(6)}, FLConfig(
        **dense_fl, num_clusters=2), 4, device="cpu")
    jtwo = reference.baselines.make_server(
        {"a": jax.numpy.zeros(6)},
        reference.base.FLConfig(**dense_fl, num_clusters=2), 4)
    with pytest.raises(reference.checkpoint.CheckpointError) as want:
        jtwo.load_state_dict(dense.state_dict())
    with pytest.raises(CheckpointError) as got:
        two_tier.load_state_dict(dense.state_dict())
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("direction", ["reference-to-port",
                                       "port-to-reference"])
@pytest.mark.parametrize("K", [0, 2])
def test_cohort_snapshot_crosses_the_packages(reference, monkeypatch,
                                              tmp_path, direction, K):
    """A sparse (and sparse-hierarchical) snapshot written by one package,
    with python requests, resumes in the other: rounds 2-3 within 1e-4 of
    the writer's straight run, participants exact."""
    xc_kw = dict(model="mlp", dataset=2, num_clients=8, rounds=4,
                 capacity=(12, 24), arrivals=4, batch=8, seed=5,
                 cohort_size=4, participation=0.5, num_clusters=K)
    R = reference.harness
    if direction == "reference-to-port":
        want = R.run("osafl", R.ExperimentConfig(**xc_kw), eval_samples=64,
                     save_every_k=2, checkpoint_dir=tmp_path)
        got = run("osafl", ExperimentConfig(**xc_kw), eval_samples=64,
                  device="cpu", resume_from=checkpoint_path(tmp_path, 2))
    else:
        _reference_weights(reference, monkeypatch, "mlp", 5)
        want = run("osafl", ExperimentConfig(**xc_kw), eval_samples=64,
                   device="cpu", save_every_k=2, checkpoint_dir=tmp_path)
        got = R.run("osafl", R.ExperimentConfig(**xc_kw), eval_samples=64,
                    resume_from=checkpoint_path(tmp_path, 2))
    assert [h["round"] for h in got] == [0, 1, 2, 3]
    for g, w in zip(got[2:], want[2:]):
        assert g["participants"] == w["participants"]
        np.testing.assert_allclose(g["test_loss"], w["test_loss"],
                                   rtol=1e-4)
    assert any(g["participants"] for g in got[2:])


def test_run_shape_mismatch_names_the_field(tmp_path):
    xc = _cfg(2)
    run("osafl", xc, eval_samples=64, device="cpu", save_every_k=2,
        checkpoint_dir=tmp_path)
    ck = checkpoint_path(tmp_path, 2)
    with pytest.raises(CheckpointError, match="request_backend"):
        run("osafl", _cfg(3, request_backend="stacked"), eval_samples=64,
            device="cpu", resume_from=ck)
    with pytest.raises(CheckpointError, match=r"alg \('osafl' vs 'fedavg'"):
        run("fedavg", _cfg(3), eval_samples=64, device="cpu", resume_from=ck)
    with pytest.raises(CheckpointError, match="already holds 2 rounds"):
        run("osafl", _cfg(1), eval_samples=64, device="cpu", resume_from=ck)
    with pytest.raises(ValueError, match="passed together"):
        run("osafl", xc, device="cpu", save_every_k=2)


# -- across the packages ----------------------------------------------------------

def _reference_weights(reference, monkeypatch, model, seed):
    w0 = to_numpy_tree(reference.small.init_small(jax.random.PRNGKey(seed),
                                                  model))
    monkeypatch.setattr(tex, "init_small",
                        lambda seed, name, device: params_from_numpy(
                            name, w0, device))


@pytest.mark.parametrize("engine", ["stacked", "loop"])
def test_reference_snapshot_resumes_in_the_port(reference, monkeypatch,
                                                tmp_path, engine):
    xc_kw = dict(model="mlp", dataset=2, num_clients=8, rounds=4,
                 capacity=(12, 24), arrivals=4, batch=8, seed=5,
                 engine=engine)
    R = reference.harness
    want = R.run("osafl", R.ExperimentConfig(**xc_kw), eval_samples=64,
                 save_every_k=2, checkpoint_dir=tmp_path)
    # the port's own weights: everything a round reads comes from the
    # snapshot
    got = run("osafl", ExperimentConfig(**xc_kw), eval_samples=64,
              device="cpu", resume_from=checkpoint_path(tmp_path, 2))
    assert [h["round"] for h in got] == [0, 1, 2, 3]
    for g, w in zip(got[2:], want[2:]):
        assert g["participants"] == w["participants"]
        np.testing.assert_allclose(g["test_loss"], w["test_loss"],
                                   rtol=1e-4)
    assert any(g["participants"] for g in got[2:])


@pytest.mark.parametrize("engine", ["stacked", "loop"])
def test_port_snapshot_resumes_in_the_reference(reference, monkeypatch,
                                                tmp_path, engine):
    xc_kw = dict(model="mlp", dataset=2, num_clients=8, rounds=4,
                 capacity=(12, 24), arrivals=4, batch=8, seed=5,
                 engine=engine)
    R = reference.harness
    # the port's straight run from the reference's weights, a snapshot at
    # round 2; the reference resumes it and must go on as the port does
    _reference_weights(reference, monkeypatch, "mlp", 5)
    want = run("osafl", ExperimentConfig(**xc_kw), eval_samples=64,
               device="cpu", save_every_k=2, checkpoint_dir=tmp_path)
    snap = reference.checkpoint.load_run_state(checkpoint_path(tmp_path, 2))
    if engine == "stacked":
        assert snap["buffer"]["y"].dtype == np.int32
        np.testing.assert_array_equal(
            snap["server"]["sketch_key"],
            np.asarray(jax.random.PRNGKey(5)))
    got = R.run("osafl", R.ExperimentConfig(**xc_kw), eval_samples=64,
                resume_from=checkpoint_path(tmp_path, 2))
    assert [h["round"] for h in got] == [0, 1, 2, 3]
    for g, w in zip(got[2:], want[2:]):
        assert g["participants"] == w["participants"]
        np.testing.assert_allclose(g["test_loss"], w["test_loss"],
                                   rtol=1e-4)
    assert any(g["participants"] for g in got[2:])


def test_reference_stacked_stream_snapshot_is_refused(reference, tmp_path):
    """A stacked-request snapshot whose stream state is the reference's
    (its threefry key under ``streams/key``) cannot resume in the port."""
    xc_kw = dict(model="mlp", dataset=2, num_clients=4, rounds=1,
                 capacity=(12, 24), arrivals=4, batch=8, seed=5,
                 request_backend="stacked")
    run("osafl", ExperimentConfig(**xc_kw), eval_samples=16, device="cpu",
        save_every_k=1, checkpoint_dir=tmp_path / "port",
        checkpoint_async=False)
    snap = load_run_state(checkpoint_path(tmp_path / "port", 1))
    jcat, jstreams = reference.video_caching.make_population(5, 4)
    jst = reference.video_caching_stacked.StackedRequestStream.from_streams(
        jcat, jstreams, seed=5)
    snap["streams"] = {k: np.asarray(v) for k, v in
                       jst.state_dict().items()}
    assert snap["streams"]["key"].dtype == np.uint32
    save_run_state(checkpoint_path(tmp_path, 1), snap)
    with pytest.raises(CheckpointError, match="streams/key") as err:
        run("osafl", ExperimentConfig(**dict(xc_kw, rounds=2)),
            eval_samples=16, device="cpu",
            resume_from=checkpoint_path(tmp_path, 1))
    assert "threefry" in str(err.value)


# -- the servers' state_dicts, key for key ------------------------------------

def _assert_same_layout(got, want, path="s"):
    """Same keys, list lengths, dtypes and shapes; values within 1e-5."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_same_layout(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_layout(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("engine", ["loop", "stacked"])
@pytest.mark.parametrize("alg", ["osafl", "fedavg", "fedprox", "fednova",
                                 "afa_cd", "feddisco"])
def test_server_state_dicts_cross_the_packages(reference, tmp_path, engine,
                                               alg):
    """After two rounds of the same updates, each server's snapshot has the
    reference's layout (keys, dtypes, shapes; values within 1e-5), and a
    snapshot of either package loaded into the other's fresh server gives
    the same next round."""
    from test_torch_loop import _jax, _np_tree, _torch, _updates
    U = 5
    rng = np.random.default_rng(11)
    w0 = _np_tree(rng)
    kw = dict(num_clients=U, local_lr=0.1, global_lr=2.0, algorithm=alg,
              engine=engine)
    RB = reference.baselines

    def servers():
        return (RB.make_server(_jax(w0), reference.base.FLConfig(**kw), U,
                               seed=3),
                make_server(_torch(w0), FLConfig(**kw), U, seed=3,
                            device="cpu"))

    def one_round(jsrv, tsrv):
        ups = _updates(rng, U, jsrv.params
                       if getattr(tsrv, "buffers_hold_weights", False)
                       else None)
        want = jsrv.round([reference.osafl.ClientUpdate(u, _jax(d), k, n, h)
                           for u, d, k, n, h in ups])
        got = tsrv.round([ClientUpdate(u, _torch(d), k, n, h)
                          for u, d, k, n, h in ups])
        for p in tree_paths(got):
            np.testing.assert_allclose(
                tree_get(got, p).numpy(),
                np.asarray(tree_get(to_numpy_tree(want), p)), rtol=0,
                atol=1e-5, err_msg=".".join(p))

    jsrv, tsrv = servers()
    for _ in range(2):
        one_round(jsrv, tsrv)
    save_run_state_v2(tmp_path / "j", {"server": jsrv.state_dict()})
    save_run_state_v2(tmp_path / "t", {"server": tsrv.state_dict()})
    jsd = load_run_state(tmp_path / "j")["server"]
    tsd = reference.checkpoint.load_run_state(tmp_path / "t")["server"]
    _assert_same_layout(tsd, jsd)
    j2, t2 = servers()
    j2.load_state_dict(tsd)         # the port's snapshot in the reference
    t2.load_state_dict(jsd)         # the reference's snapshot in the port
    state = rng.bit_generator.state
    one_round(jsrv, t2)
    rng.bit_generator.state = state
    one_round(j2, tsrv)
