"""Streaming run-state snapshots (``run_state/v2``) and retention (the port
of ``repro/checkpoint/streaming.py``).

A v2 snapshot is a directory:

    round_00006/
      a00000.s00.npy ... a00042.s00.npy   one file per array leaf
      manifest.json                       tree skeleton + shard table
      COMMIT.json                         commit marker, written last

  * Each array leaf is one ``.npy`` file (the port holds no mesh, so every
    leaf is one shard covering the whole array; the reference's multi-shard
    snapshots still load). The bytes are ``np.save``'s, written straight
    to the file while their crc32 is taken, so a 3.9 GB leaf is never
    held twice in memory.
  * ``manifest.json`` carries the JSON tree skeleton (the v1 codec's
    ``__array__`` markers) and, per leaf, the dtype, shape and every
    shard's file name, index extents, byte length and crc32.
  * ``COMMIT.json`` (save id + the manifest's sha256) is written atomically
    last: a snapshot is complete or invisible. Readers refuse a missing or
    garbled marker, a manifest that does not hash to the committed sha and
    any shard whose length or crc does not match, naming the artifact.

``AsyncCheckpointWriter`` writes on a background thread. Its ``submit``
runs on the round loop and encodes the state tree into host numpy arrays
it owns: the port's round writes its buffers in place (the (U, N)
contribution buffer, the FIFO storage and staging), so a snapshot must not
hold views of them. A tensor on the card is copied to the host there, in
the order of the card's work; the file writes stay off the round loop.
At most ``queue_size`` snapshots are held on the host at once (``submit``
waits for the oldest to be written when one more would exceed it);
``held_bytes``/``peak_held_bytes`` say how much they hold. ``close()`` is
the drain barrier and re-raises the first failed write.
``BlockingCheckpointWriter`` is the synchronous v1 writer
(``checkpoint_async=False`` and the loop engine).

Retention: ``prune_checkpoints(dir, keep_last)`` deletes all but the newest
``keep_last`` committed snapshots, never one named by a ``SERVING-*.json``
claim file (``write_claim``) and never the writer's in-flight directory.
"""
from __future__ import annotations

import hashlib
import io
import json
import queue
import re
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.run_state import (CheckpointError, _decode,
                                              _encode, _npz_path,
                                              atomic_write, check_version,
                                              find_sidecar, save_run_state)

V2_FORMAT = 2
MANIFEST_NAME = "manifest.json"
COMMIT_NAME = "COMMIT.json"
CLAIM_PREFIX = "SERVING-"

# test seam: called after each shard file hits disk (the crash tests die
# inside it); never set in production code
_POST_SHARD_HOOK = None


def _stem(path) -> Path:
    """Snapshot paths are given as stems (``.../round_00006``); tolerate the
    v1 ``.npz``-suffixed form so both layouts share call sites."""
    return Path(str(path).removesuffix(".npz"))


# ---------------------------------------------------------------------------
# v2 write
# ---------------------------------------------------------------------------

class _CrcWriter:
    """File-like sink that writes through to ``f`` and keeps the crc32 and
    the length of everything written."""

    def __init__(self, f):
        self.f, self.crc, self.nbytes = f, 0, 0

    def write(self, b) -> int:
        self.crc = zlib.crc32(b, self.crc)
        self.nbytes += len(b)
        return self.f.write(b)


def _write_npy(fname: Path, data: np.ndarray) -> Tuple[int, int]:
    """``np.save``'s bytes of ``data`` into ``fname``; returns (crc32,
    byte length)."""
    # NB: np.ascontiguousarray promotes 0-d to 1-d; guard on ndim
    arr = np.ascontiguousarray(data) if data.ndim else data
    with open(fname, "wb") as f:
        sink = _CrcWriter(f)
        np.lib.format.write_array(sink, arr, allow_pickle=False)
    return sink.crc & 0xFFFFFFFF, sink.nbytes


def _write_v2(path, tree, arrays: Dict[str, np.ndarray],
              metadata: dict) -> None:
    """Write one committed v2 snapshot directory from host arrays.
    Overwriting an existing snapshot unlinks its commit marker first, so a
    crash mid-rewrite can never leave a stale marker beside new files."""
    d = _stem(path)
    d.mkdir(parents=True, exist_ok=True)
    (d / COMMIT_NAME).unlink(missing_ok=True)
    (d / MANIFEST_NAME).unlink(missing_ok=True)
    for old in d.glob("*.npy"):
        old.unlink()
    save_id = f"{np.random.SeedSequence().entropy:032x}"
    entries = {}
    for i, (key, data) in enumerate(arrays.items()):
        fname = f"a{i:05d}.s00.npy"
        crc, nbytes = _write_npy(d / fname, data)
        if _POST_SHARD_HOOK is not None:
            _POST_SHARD_HOOK()
        shape = [int(n) for n in data.shape]
        entries[key] = {"dtype": str(data.dtype), "shape": shape,
                        "shards": [{"file": fname,
                                    "index": [[0, n] for n in shape],
                                    "crc32": crc, "nbytes": nbytes}]}
    manifest = {"format_version": V2_FORMAT, "kind": "run_state",
                "save_id": save_id, "tree": tree, "metadata": metadata,
                "arrays": entries}
    mbytes = json.dumps(manifest).encode()
    atomic_write(d / MANIFEST_NAME, lambda t: t.write_bytes(mbytes))
    atomic_write(d / COMMIT_NAME, lambda t: t.write_text(json.dumps(
        {"format_version": V2_FORMAT, "save_id": save_id,
         "manifest_sha256": hashlib.sha256(mbytes).hexdigest()})))


def save_run_state_v2(path, state, metadata: dict = None) -> None:
    """Synchronous v2 save: the same tree contract as ``save_run_state``,
    the directory layout on disk."""
    arrays: Dict[str, Any] = {}
    tree = _encode(state, arrays, "s")
    _write_v2(path, tree, arrays, dict(metadata or {}))


# ---------------------------------------------------------------------------
# v2 read
# ---------------------------------------------------------------------------

def read_manifest(path) -> dict:
    """The committed manifest of a v2 snapshot directory: requires the
    commit marker, verifies the manifest hashes to the committed sha and
    that both sides name the same save. Raises ``CheckpointError`` naming
    the bad artifact."""
    d = _stem(path)
    commit_p = d / COMMIT_NAME
    if not commit_p.exists():
        raise CheckpointError(
            f"snapshot {d} has no commit marker {COMMIT_NAME} — the write "
            "never completed (crashed writer?); refusing a partial restore")
    try:
        commit = json.loads(commit_p.read_text())
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointError(
            f"corrupt commit marker {commit_p}: {e}") from e
    man_p = d / MANIFEST_NAME
    if not man_p.exists():
        raise CheckpointError(f"snapshot manifest {man_p} not found")
    mbytes = man_p.read_bytes()
    sha = hashlib.sha256(mbytes).hexdigest()
    if sha != commit.get("manifest_sha256"):
        raise CheckpointError(
            f"snapshot manifest {man_p} does not hash to the committed "
            f"sha256 (torn overwrite or corruption)")
    manifest = json.loads(mbytes)
    check_version(manifest, d, expect_kind="run_state")
    if manifest.get("save_id") != commit.get("save_id"):
        raise CheckpointError(
            f"snapshot {d} is torn: manifest and commit marker come from "
            "different saves")
    return manifest


def _parse_npy(payload: bytearray) -> np.ndarray:
    """The array of an ``.npy`` payload, as a view of ``payload`` where the
    layout allows (no second copy of a large leaf)."""
    fmt = np.lib.format
    head = io.BytesIO(bytes(memoryview(payload)[:1 << 20]))
    version = fmt.read_magic(head)
    if version not in ((1, 0), (2, 0)):
        return np.load(io.BytesIO(payload), allow_pickle=False)
    read = (fmt.read_array_header_1_0 if version == (1, 0)
            else fmt.read_array_header_2_0)
    shape, fortran, dtype = read(head)
    count = int(np.prod(shape, dtype=np.int64))
    offset = head.tell()
    if dtype.hasobject or len(payload) - offset != count * dtype.itemsize:
        raise ValueError(f"header says {dtype}{shape}, payload holds "
                         f"{len(payload) - offset} bytes")
    if count == 0:
        return np.empty(shape, dtype)
    arr = np.frombuffer(payload, dtype, count=count, offset=offset)
    return arr.reshape(shape, order="F" if fortran else "C")


def _read_leaf(d: Path, key: str, ent: dict) -> np.ndarray:
    dtype = np.dtype(ent["dtype"])
    shape = tuple(int(n) for n in ent["shape"])
    pieces = []
    for shard in ent["shards"]:
        f = d / shard["file"]
        if not f.exists():
            raise CheckpointError(
                f"snapshot {d} array {key!r}: shard file {f.name} is "
                "missing")
        payload = bytearray(f.stat().st_size)
        with open(f, "rb") as fh:
            got = fh.readinto(payload)
        if got != int(shard["nbytes"]) or len(payload) != got:
            raise CheckpointError(
                f"snapshot {d} array {key!r}: shard file {f.name} is "
                f"truncated ({got} of {shard['nbytes']} bytes)")
        if (zlib.crc32(payload) & 0xFFFFFFFF) != int(shard["crc32"]):
            raise CheckpointError(
                f"snapshot {d} array {key!r}: shard file {f.name} fails "
                "its crc32 check (corrupt or from a different save)")
        try:
            arr = _parse_npy(payload)
        except Exception as e:
            raise CheckpointError(
                f"snapshot {d} array {key!r}: shard file {f.name} is not "
                f"a readable npy: {e}") from e
        idx = tuple((int(a), int(b)) for a, b in shard["index"])
        want = tuple(b - a for a, b in idx)
        if arr.shape != want or arr.dtype != dtype:
            raise CheckpointError(
                f"snapshot {d} array {key!r}: shard file {f.name} holds "
                f"{arr.dtype}{arr.shape}, manifest says {dtype}{want}")
        pieces.append((idx, arr))
    if len(pieces) == 1 and pieces[0][0] == tuple((0, n) for n in shape):
        return pieces[0][1]          # one shard holds the whole leaf
    full = np.empty(shape, dtype)
    count = 0
    for idx, arr in pieces:
        full[tuple(slice(a, b) for a, b in idx)] = arr
        count += int(arr.size) if shape else 1
    if count != (int(full.size) if shape else 1):
        raise CheckpointError(
            f"snapshot {d} array {key!r}: shards cover {count} of "
            f"{full.size} elements (incomplete manifest)")
    return full


def load_run_state_v2(path):
    """Reassemble a committed v2 snapshot into nested plain structures.
    Every shard is length- and crc-verified; arrays come back as whole host
    arrays, which ``load_state_dict`` moves to the run's device."""
    d = _stem(path)
    manifest = read_manifest(d)
    data = {key: _read_leaf(d, key, ent)
            for key, ent in manifest["arrays"].items()}
    return _decode(manifest["tree"], data)


# ---------------------------------------------------------------------------
# snapshot directory scanning / retention
# ---------------------------------------------------------------------------

_ROUND_RE = re.compile(r"round_(\d+)$")


def snapshot_round(path) -> Optional[int]:
    """Round number encoded in a harness snapshot name, else None."""
    m = _ROUND_RE.search(_stem(path).name)
    return int(m.group(1)) if m else None


def is_committed(path) -> bool:
    """Cheap commit probe: a v2 directory with marker + manifest, or a v1
    npz + sidecar pair. (Deep validation happens at load.)"""
    stem = _stem(path)
    if stem.is_dir():
        return (stem / COMMIT_NAME).exists() and \
            (stem / MANIFEST_NAME).exists()
    return _npz_path(stem).exists() and find_sidecar(stem) is not None


def _snapshot_stems(checkpoint_dir) -> List[Tuple[Path, int]]:
    """All ``round_*`` snapshot stems in a checkpoint dir (committed or
    not), sorted by round."""
    seen: Dict[Path, int] = {}
    for p in Path(checkpoint_dir).glob("round_*"):
        stem = Path(str(p).removesuffix(".meta.json").removesuffix(".npz"))
        r = snapshot_round(stem)
        if r is not None:
            seen[stem] = r
    return sorted(seen.items(), key=lambda kv: (kv[1], kv[0].name))


def committed_snapshots(checkpoint_dir) -> List[Path]:
    """Stems of all committed snapshots in a dir, oldest round first."""
    return [s for s, _ in _snapshot_stems(checkpoint_dir)
            if is_committed(s)]


def latest_checkpoint(checkpoint_dir) -> Optional[Path]:
    """Stem of the newest committed snapshot, or None; uncommitted
    directories (in-flight or crashed writes) are invisible here."""
    snaps = committed_snapshots(checkpoint_dir)
    return snaps[-1] if snaps else None


def delete_snapshot(path) -> None:
    """Remove one snapshot. v2: the commit marker goes first (the snapshot
    turns invisible atomically), then the directory; v1: npz before
    sidecar, so a concurrent reader fails loudly."""
    stem = _stem(path)
    if stem.is_dir():
        (stem / COMMIT_NAME).unlink(missing_ok=True)
        shutil.rmtree(stem, ignore_errors=True)
    else:
        _npz_path(stem).unlink(missing_ok=True)
        mp = find_sidecar(stem)
        if mp is not None:
            mp.unlink(missing_ok=True)


def write_claim(checkpoint_dir, token: str, snapshots) -> Path:
    """Publish a claim file naming snapshots in use: ``prune_checkpoints``
    never deletes a claimed snapshot."""
    d = Path(checkpoint_dir)
    d.mkdir(parents=True, exist_ok=True)
    names = sorted({_stem(s).name for s in snapshots if s is not None})
    p = d / f"{CLAIM_PREFIX}{token}.json"
    atomic_write(p, lambda t: t.write_text(json.dumps(
        {"token": token, "snapshots": names})))
    return p


def clear_claim(checkpoint_dir, token: str) -> None:
    (Path(checkpoint_dir) / f"{CLAIM_PREFIX}{token}.json").unlink(
        missing_ok=True)


def claimed_names(checkpoint_dir) -> set:
    """Snapshot names named by any claim file (unparsable claim files are
    skipped: a torn claim must not wedge retention forever)."""
    out = set()
    for p in Path(checkpoint_dir).glob(f"{CLAIM_PREFIX}*.json"):
        try:
            doc = json.loads(p.read_text())
        except (json.JSONDecodeError, OSError):
            continue
        out.update(str(n) for n in doc.get("snapshots", []))
    return out


def prune_checkpoints(checkpoint_dir, keep_last: int,
                      protect=()) -> List[Path]:
    """Delete all but the newest ``keep_last`` committed snapshots; returns
    the deleted stems. Never deletes (a) the newest committed snapshot,
    (b) anything named by a ``SERVING-*`` claim file or ``protect``, or
    (c) an uncommitted snapshot at/after the newest committed round (the
    writer's in-flight directory). Older uncommitted leftovers (crashed
    writes) are swept."""
    if not isinstance(keep_last, int) or keep_last < 1:
        raise ValueError(f"keep_last must be a positive int, got "
                         f"{keep_last!r}")
    d = Path(checkpoint_dir)
    if not d.is_dir():
        return []
    stems = _snapshot_stems(d)
    committed = [(s, r) for s, r in stems if is_committed(s)]
    if not committed:
        return []
    newest_round = committed[-1][1]
    keep = {s.name for s, _ in committed[-keep_last:]}
    keep |= claimed_names(d)
    keep |= {_stem(p).name for p in protect}
    removed = []
    for s, r in stems:
        if s.name in keep:
            continue
        if not is_committed(s) and r >= newest_round:
            continue
        delete_snapshot(s)
        removed.append(s)
    return removed


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

class BlockingCheckpointWriter:
    """The synchronous v1 save behind the writers' interface: the
    ``checkpoint_async=False`` path and the loop engine's."""

    def __init__(self, keep_last: int = None):
        self.keep_last = keep_last

    def submit(self, path, state, metadata: dict = None) -> None:
        save_run_state(path, state, metadata=metadata)
        if self.keep_last:
            prune_checkpoints(_stem(path).parent, self.keep_last)

    def drain(self) -> None:
        pass

    def close(self) -> None:
        pass

    def shutdown(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.close() if et is None else self.shutdown()
        return False


class AsyncCheckpointWriter:
    """Background v2 snapshot writer.

    ``submit`` runs on the round loop: it waits while ``queue_size``
    snapshots are already held on the host, encodes the state into host
    arrays it owns (tensors on the card are copied to the host there) and
    queues them. The worker thread writes the directory, commits it and
    prunes. ``stats`` holds one row per snapshot: ``path``, ``bytes`` (its
    arrays), ``submit_s`` (how long ``submit`` held the round loop) and,
    once written, ``write_s`` (from the end of ``submit`` to the commit).

    A failed write is re-raised on the next ``submit``/``drain``/``close``;
    ``close()`` is the harness's drain barrier at exit. ``shutdown()`` is
    the ``finally``-safe variant (never raises)."""

    def __init__(self, keep_last: int = None, queue_size: int = 2):
        self.keep_last = keep_last
        self.queue_size = int(queue_size)
        self.stats: List[dict] = []
        self.held_bytes = 0
        self.peak_held_bytes = 0
        self._slots = threading.BoundedSemaphore(self.queue_size)
        self._lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._worker, name="ckpt-writer", daemon=True)
        self._thread.start()

    # -- round-loop side -----------------------------------------------------
    def submit(self, path, state, metadata: dict = None) -> None:
        self._raise_pending()
        if self._closed:
            raise CheckpointError("submit() on a closed checkpoint writer")
        t0 = time.perf_counter()
        self._slots.acquire()
        try:
            arrays: Dict[str, Any] = {}
            tree = _encode(state, arrays, "s", copy_host=True)
        except BaseException:
            self._slots.release()
            raise
        nbytes = sum(int(a.nbytes) for a in arrays.values())
        with self._lock:
            self.held_bytes += nbytes
            self.peak_held_bytes = max(self.peak_held_bytes,
                                       self.held_bytes)
        row = {"path": str(path), "bytes": nbytes,
               "submit_s": time.perf_counter() - t0}
        self.stats.append(row)
        self._q.put((_stem(path), tree, arrays, dict(metadata or {}), row,
                     time.perf_counter()))

    def drain(self) -> None:
        """Block until every submitted snapshot is committed (or failed)."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain barrier: waits for all pending writes, stops the worker,
        re-raises the first write failure."""
        self._stop()
        self._raise_pending()

    def shutdown(self) -> None:
        """``finally``-safe close: the same drain, swallowing write errors
        so it never masks an exception already unwinding the harness."""
        self._stop()

    def _stop(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.close() if et is None else self.shutdown()
        return False

    # -- worker side ---------------------------------------------------------
    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                path, tree, arrays, metadata, row, t_queued = item
                try:
                    _write_v2(path, tree, arrays, metadata)
                    row["write_s"] = time.perf_counter() - t_queued
                    if self.keep_last:
                        prune_checkpoints(path.parent, self.keep_last)
                finally:
                    with self._lock:
                        self.held_bytes -= row["bytes"]
                    del arrays, item
                    self._slots.release()
            except BaseException as e:           # surfaced at the barrier
                if self._err is None:
                    self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            if isinstance(err, CheckpointError):
                raise err
            raise CheckpointError(
                f"async checkpoint write failed: {err}") from err
