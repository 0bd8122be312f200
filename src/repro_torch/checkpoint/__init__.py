"""Checkpointing: parameter trees and full online-run state (the port of
``repro/checkpoint``).

Two layers, one on-disk convention (``<path>[.npz]`` + ``<path>.meta.json``):

  * parameter helpers (``save`` / ``restore`` / ``load_metadata``): an npz
    keyed by each leaf's ``/``-joined tree path;
  * run-state snapshots (``run_state.py``: v1; ``streaming.py``: v2 and the
    writers): versioned nested-tree snapshots of everything a long online
    FL run accumulates. The harness wiring lives in
    ``repro_torch/harness/experiments.py`` (``save_every_k`` /
    ``resume_from``).

The files are the reference's, so snapshots move between the two packages.
Structure or version mismatches raise ``CheckpointError`` naming the keys
or dtypes, never a bare ``assert`` or a silent cast.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint.run_state import (FORMAT_VERSION, V1_FORMAT,
                                              CheckpointError, _host_array,
                                              _npz_path, atomic_write,
                                              check_version, diff_snapshots,
                                              find_sidecar, generator_state,
                                              load_run_state, meta_path,
                                              parse_sidecar, read_sidecar,
                                              save_run_state,
                                              set_generator_state,
                                              validate_cohort_shapes)
from repro_torch.checkpoint.streaming import (AsyncCheckpointWriter,
                                              BlockingCheckpointWriter,
                                              clear_claim,
                                              committed_snapshots,
                                              delete_snapshot, is_committed,
                                              latest_checkpoint,
                                              load_run_state_v2,
                                              prune_checkpoints,
                                              save_run_state_v2,
                                              snapshot_round, write_claim)

__all__ = [
    "AsyncCheckpointWriter", "BlockingCheckpointWriter", "CheckpointError",
    "FORMAT_VERSION", "V1_FORMAT", "clear_claim", "committed_snapshots",
    "delete_snapshot", "diff_snapshots", "generator_state", "is_committed",
    "latest_checkpoint", "load_metadata", "load_run_state",
    "load_run_state_v2", "prune_checkpoints", "restore", "save",
    "save_run_state", "save_run_state_v2", "set_generator_state",
    "snapshot_round", "validate_cohort_shapes", "write_claim",
]


def _leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict/list tree, in the order jax's
    tree flattening visits them (sorted dict keys, list order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _rebuild(like, fn, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, fn, f"{prefix}/{i}" if prefix
                                   else str(i)) for i, v in enumerate(like))
    return fn(prefix, like)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def save(path, params, step: int = 0, metadata: dict = None):
    """Write a parameter tree (nested dicts of tensors or arrays) as an npz
    keyed by leaf path, plus its sidecar."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {k: _host_array(v, k, False) for k, v in _leaves(params)}
    atomic_write(_npz_path(path), lambda tmp: np.savez(tmp, **flat))
    atomic_write(meta_path(path), lambda tmp: tmp.write_text(
        json.dumps({"format_version": V1_FORMAT, "kind": "params",
                    "step": step, **(metadata or {})})))


def restore(path, like):
    """Restore into the structure of ``like`` (a parameter tree). Tensor
    leaves of ``like`` come back as tensors on their device, others as
    numpy arrays. Raises ``CheckpointError`` naming missing/extra keys or
    dtype mismatches, and refuses future snapshot-format versions (legacy
    sidecar-less checkpoints still load)."""
    sidecar = find_sidecar(path)
    if sidecar is not None:
        check_version(parse_sidecar(sidecar), path)
    npz = _npz_path(path)
    if not npz.exists():
        raise CheckpointError(f"checkpoint array file {npz} not found")
    data = np.load(npz)
    want = dict(_leaves(like))
    missing = sorted(set(want) - set(data.files))
    extra = sorted(set(data.files) - set(want))
    if missing or extra:
        raise CheckpointError(
            f"checkpoint {path} does not match the target structure: "
            f"missing keys {missing or '[]'}, extra keys {extra or '[]'}")
    bad_dtype = [f"{k}: checkpoint {data[k].dtype} != target {_np_dtype(v)}"
                 for k, v in want.items() if data[k].dtype != _np_dtype(v)]
    if bad_dtype:
        raise CheckpointError(
            f"checkpoint {path} dtype mismatch: " + "; ".join(bad_dtype))

    def leaf(key, ref):
        if isinstance(ref, torch.Tensor):
            return torch.as_tensor(data[key], device=ref.device)
        return data[key]
    return _rebuild(like, leaf)


def load_metadata(path) -> dict:
    """The checkpoint's sidecar metadata; ``CheckpointError`` (naming the
    path) when the sidecar is absent."""
    meta = read_sidecar(path)
    check_version(meta, path)
    return meta
