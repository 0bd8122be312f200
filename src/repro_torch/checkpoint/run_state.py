"""Versioned on-disk snapshots of nested run state (the port of
``repro/checkpoint/run_state.py``).

A run's state is a nested tree of dicts, lists, scalars, None, numpy
arrays and torch tensors: FIFO buffers, staged arrivals, the servers'
contribution buffers, scores, staleness flags and the numpy Generator
streams. The tree codec puts every array leaf under its tree path and the
rest of the skeleton (including the Generators' arbitrary-precision words)
into JSON with ``{"__array__": <key>}`` markers. Two layouts share it:

  * v1 (``save_run_state`` here): one ``.npz`` plus a ``.meta.json``
    sidecar, both written atomically and tied by a shared save id;
  * v2 (``checkpoint/streaming.py``): a snapshot directory of ``.npy``
    files, a manifest and a commit marker written last.

``load_run_state`` reads both. The files are the reference's, byte for
byte in layout, so a snapshot written by either package loads in the
other. Torch tensors are stored as numpy arrays of the same dtype; a
tensor on the card is copied to the host when the tree is encoded.

Every sidecar carries ``format_version`` and ``kind``; a future or unknown
format, a torn pair, a truncated archive or a mismatched structure raises
``CheckpointError`` naming the artifact, never a silent cast.
"""
from __future__ import annotations

import copy
import json
import os
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# newest readable snapshot format; v1 saves stamp V1_FORMAT so snapshots they
# write stay readable by readers of v1 only
FORMAT_VERSION = 2
V1_FORMAT = 1
_ARRAY_KEY = "__array__"


class CheckpointError(RuntimeError):
    """A checkpoint could not be read/written against the live structures."""


def validate_cohort_shapes(sd: dict, num_users: int, capacity: int) -> None:
    """Validate a slot-pool snapshot against a live run's U and C
    independently: ``user_slot`` is per registered user (length U) and
    ``slot_user`` per pool slot (length C). Each mismatch raises
    ``CheckpointError`` naming the dimension."""
    missing = sorted(k for k in ("user_slot", "slot_user") if k not in sd)
    if missing:
        raise CheckpointError(
            "cohort snapshot is missing the slot-map keys: "
            + ", ".join(missing))
    u = int(np.asarray(sd["user_slot"]).shape[0])
    c = int(np.asarray(sd["slot_user"]).shape[0])
    if u != int(num_users):
        raise CheckpointError(
            f"cohort snapshot covers U={u} registered users; the live run "
            f"has U={num_users} (per-user tables cannot be re-indexed)")
    if c != int(capacity):
        raise CheckpointError(
            f"cohort snapshot has slot-pool capacity C={c}; the live run "
            f"has C={capacity} (slot-resident state cannot be re-packed)")


# ---------------------------------------------------------------------------
# np.random.Generator streams
# ---------------------------------------------------------------------------

def generator_state(rng: np.random.Generator) -> dict:
    """JSON-able snapshot of a Generator's exact stream position."""
    return copy.deepcopy(rng.bit_generator.state)


def set_generator_state(rng: np.random.Generator, state: dict) -> None:
    """Restore a stream snapshot taken by ``generator_state``."""
    rng.bit_generator.state = copy.deepcopy(state)


# ---------------------------------------------------------------------------
# nested-tree codec
# ---------------------------------------------------------------------------

def _host_array(obj, path: str, copy_host: bool) -> np.ndarray:
    """An array leaf as a numpy array the caller may keep. A tensor on the
    card is copied to the host (``.cpu()`` waits for the work queued before
    it on the current stream, so the copy holds the state as of the call).
    A host tensor's ``.numpy()`` and a numpy array share memory with live
    state that the round loop writes in place, so ``copy_host`` copies
    them."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        elif copy_host:
            t = t.clone()
        try:
            return t.numpy()
        except TypeError as e:
            raise CheckpointError(
                f"cannot serialize a {t.dtype} tensor at {path!r}: {e}"
            ) from e
    if copy_host and isinstance(obj, np.ndarray):
        return obj.copy()
    return np.asarray(obj)


def _encode(obj, arrays: Dict[str, Any], path: str,
            copy_host: bool = False):
    """Nested state -> JSON skeleton, array leaves moved into ``arrays`` as
    host numpy arrays (see ``_host_array``; ``copy_host`` is the async
    writer's: what it holds must not change when the round loop goes on)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, (torch.Tensor, np.ndarray)) or (
            hasattr(obj, "__array__") and hasattr(obj, "dtype")):
        arrays[path] = _host_array(obj, path, copy_host)
        return {_ARRAY_KEY: path}
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str) or k == _ARRAY_KEY:
                raise CheckpointError(
                    f"state dict key {k!r} at {path!r} is not serializable "
                    f"(keys must be strings, {_ARRAY_KEY!r} is reserved)")
            out[k] = _encode(v, arrays, f"{path}/{k}", copy_host)
        return out
    if isinstance(obj, (list, tuple)):
        return [_encode(v, arrays, f"{path}/{i}", copy_host)
                for i, v in enumerate(obj)]
    raise CheckpointError(
        f"cannot serialize {type(obj).__name__} at {path!r}")


def _decode(node, data):
    if isinstance(node, dict):
        if set(node) == {_ARRAY_KEY}:
            key = node[_ARRAY_KEY]
            if key not in data:
                raise CheckpointError(
                    f"sidecar references array {key!r} which is missing "
                    "from the npz archive (torn or mismatched save?)")
            return data[key]
        return {k: _decode(v, data) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode(v, data) for v in node]
    return node


# ---------------------------------------------------------------------------
# on-disk format
# ---------------------------------------------------------------------------

def _npz_path(path) -> Path:
    p = str(path)
    return Path(p if p.endswith(".npz") else p + ".npz")


def meta_path(path) -> Path:
    """Canonical sidecar location; ``ckpt`` and ``ckpt.npz`` resolve to the
    same file."""
    p = str(path)
    if p.endswith(".npz"):
        p = p[:-4]
    return Path(p + ".meta.json")


def find_sidecar(path) -> Optional[Path]:
    """The existing sidecar for ``path``, or None: the stem-based location
    first, then the legacy ``<file>.npz.meta.json`` spot."""
    legacy = Path(str(_npz_path(path)) + ".meta.json")
    for mp in (meta_path(path), legacy):
        if mp.exists():
            return mp
    return None


def parse_sidecar(mp: Path) -> dict:
    """Parse an already-located sidecar file."""
    try:
        return json.loads(mp.read_text())
    except json.JSONDecodeError as e:
        raise CheckpointError(f"corrupt checkpoint sidecar {mp}: {e}") from e


def read_sidecar(path) -> dict:
    """The ``.meta.json`` sidecar dict, or CheckpointError if absent/corrupt."""
    mp = find_sidecar(path)
    if mp is None:
        raise CheckpointError(
            f"checkpoint sidecar {meta_path(path)} not found — was this "
            "checkpoint written by checkpoint.save/save_run_state?")
    return parse_sidecar(mp)


def atomic_write(target: Path, writer) -> None:
    """Write via a temp file + ``os.replace`` so an interrupted save never
    tears ``target``. ``writer`` receives the temp path; for npz targets the
    temp name keeps the '.npz' suffix so ``np.savez`` doesn't append one."""
    tmp = target.with_name(".tmp." + target.name)
    try:
        writer(tmp)
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)


def check_version(meta: dict, path, expect_kind: str = None) -> None:
    """Reject future/unknown snapshot formats instead of reinterpreting."""
    ver = meta.get("format_version", 0)
    if not isinstance(ver, int) or ver > FORMAT_VERSION:
        raise CheckpointError(
            f"checkpoint {path} has format_version {ver!r}; this build "
            f"reads versions <= {FORMAT_VERSION} — refusing to reinterpret "
            "a future snapshot format")
    kind = meta.get("kind", "params")
    if expect_kind is not None and kind != expect_kind:
        raise CheckpointError(
            f"checkpoint {path} holds a {kind!r} snapshot, expected "
            f"{expect_kind!r}")
    if expect_kind == "run_state" and ver < 1:
        raise CheckpointError(
            f"checkpoint {path} predates the run_state format "
            f"(format_version {ver!r})")


_SAVE_ID_KEY = "__save_id__"


def save_run_state(path, state, metadata: dict = None) -> None:
    """Write a nested run-state tree as ``path[.npz]`` + ``.meta.json``.
    Each file is written atomically and the pair carries a shared random
    save id, so an overwrite interrupted between the two replaces cannot
    publish a new array file beside a stale sidecar."""
    arrays: Dict[str, Any] = {}
    tree = _encode(state, arrays, "s")
    save_id = f"{np.random.SeedSequence().entropy:032x}"
    arrays[_SAVE_ID_KEY] = np.asarray(save_id)
    npz = _npz_path(path)
    npz.parent.mkdir(parents=True, exist_ok=True)
    atomic_write(npz, lambda tmp: np.savez(tmp, **arrays))
    atomic_write(meta_path(path), lambda tmp: tmp.write_text(json.dumps(
        {"format_version": V1_FORMAT, "kind": "run_state",
         "save_id": save_id, "tree": tree, "metadata": metadata or {}})))


def load_run_state(path):
    """Read a run-state snapshot back into nested plain structures (dicts,
    lists, scalars, numpy arrays). A snapshot directory is the v2 layout
    (``checkpoint/streaming.py``), a ``.npz`` + sidecar pair is v1. A
    mismatched pair, a truncated archive or a corrupt file raises
    ``CheckpointError`` naming it."""
    if Path(str(path).removesuffix(".npz")).is_dir():
        from repro_torch.checkpoint import streaming
        return streaming.load_run_state_v2(path)
    meta = read_sidecar(path)
    check_version(meta, path, expect_kind="run_state")
    npz = _npz_path(path)
    if not npz.exists():
        raise CheckpointError(f"checkpoint array file {npz} not found")
    try:
        with np.load(npz) as data:
            data = dict(data.items())
    except (zipfile.BadZipFile, ValueError, OSError, EOFError) as e:
        raise CheckpointError(
            f"checkpoint array file {npz} is corrupt or truncated: "
            f"{e}") from e
    sid = meta.get("save_id")
    got = data.pop(_SAVE_ID_KEY, None)
    # a snapshot from before save ids has one on neither side; any
    # single-sided or mismatched id means the pair mixes two saves
    if (sid is None) != (got is None) or (sid is not None
                                          and str(got) != sid):
        raise CheckpointError(
            f"checkpoint {path} is torn: the array file and the sidecar "
            "come from different saves (interrupted overwrite?)")
    return _decode(meta["tree"], data)


def diff_snapshots(a, b, path: str = "s",
                   skip: Tuple[str, ...] = ("round_s", "request_gen_s"),
                   ) -> List[str]:
    """Bit-exact recursive comparison of two loaded snapshot trees; returns
    difference descriptions (an empty list: identical). ``skip`` names dict
    keys excluded everywhere, by default the wall-clock timings."""
    out: List[str] = []
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            if k in skip:
                continue
            if k not in a or k not in b:
                out.append(f"{path}/{k}: present on one side only")
            else:
                out += diff_snapshots(a[k], b[k], f"{path}/{k}", skip)
    elif isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            out.append(f"{path}: length {len(a)} != {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            out += diff_snapshots(x, y, f"{path}/{i}", skip)
    elif hasattr(a, "dtype") or hasattr(b, "dtype"):
        if not (hasattr(a, "dtype") and hasattr(b, "dtype")):
            out.append(f"{path}: type {type(a).__name__} != "
                       f"{type(b).__name__}")
        else:
            aa, bb = _host_array(a, path, False), _host_array(b, path, False)
            if aa.dtype != bb.dtype:
                out.append(f"{path}: dtype {aa.dtype} != {bb.dtype}")
            elif aa.shape != bb.shape:
                out.append(f"{path}: shape {aa.shape} != {bb.shape}")
            elif not np.array_equal(aa, bb, equal_nan=True):
                out.append(f"{path}: array values differ")
    elif type(a) is not type(b):
        out.append(f"{path}: type {type(a).__name__} != {type(b).__name__}")
    elif a != b:
        out.append(f"{path}: {a!r} != {b!r}")
    return out
