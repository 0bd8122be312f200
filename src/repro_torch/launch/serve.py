"""Train-while-serve: score requests with the newest committed global FL
model while a run keeps training (the port of ``repro/launch/serve.py``).

The paper's deployment is a live wireless video-caching system: clients
train online while the current global predictor answers cache-decision
requests. This module closes that loop over the snapshots a harness run
writes (``checkpoint/streaming.py``):

  * ``ModelServer`` polls a checkpoint directory, maps the newest
    committed snapshot (a snapshot without its commit marker, in flight or
    torn, is invisible to ``latest_checkpoint``) and swaps the model in
    without disturbing requests being scored: ``pin()`` returns a handle
    that holds the mapped parameters. A reload builds a new parameter tree
    and never writes into a mapped one, so a handle pinned before a
    reload scores the same logits after it (torch tensors can be written
    in place; jax arrays, the reference's, cannot).
  * Staleness: ``rounds_behind`` (the newest committed round minus the
    mapped one) is updated on every poll, and each reload logs how far
    behind the server was when it swapped (``stats()["reloads"]``).
  * The race between retention and a reload is closed by claim files:
    before loading, the server names the snapshot it has mapped and the
    one it is about to read in ``SERVING-<token>.json``, which
    ``prune_checkpoints`` skips. A prune that raced the claim is caught by
    checking the commit marker again after claiming, and by the loader's
    checks; the server then tries again at the next poll.

Snapshots of both packages are served: the loop servers' ``params``
tree, the stacked and two-tier servers' flat ``w`` and the sparse-cohort
server's ``inner`` one. Scoring runs on the CUDA device unless the caller
passes ``device="cpu"``.

``serve_loop`` scores synthetic request batches against the server while a
trainer (another thread or process) writes snapshots::

    PYTHONPATH=src python -m repro_torch.launch.serve --checkpoint-dir \\
        experiments/run1/ckpt --until-round 20
"""
from __future__ import annotations

import argparse
import functools
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.checkpoint import CheckpointError
from repro_torch.core.flatten import make_codec, tree_map
from repro_torch.data.online import dataset_layout
from repro_torch.device import owned_tensor, resolve_device
from repro_torch.models.small import (NUM_CLASSES, REGISTRY, init_small,
                                      small_forward)


@functools.lru_cache(maxsize=None)
def _codec(model: str):
    """The flat codec of ``model``'s parameter layout."""
    return make_codec(init_small(0, model, "cpu"))


def extract_global_model(snap: dict, device=None):
    """(model name, parameter tree on ``device``, next round) of a loaded
    RunState snapshot, for every server layout: the loop servers store a
    ``params`` tree, the stacked and two-tier servers a flat ``w`` (put
    back into a tree through the model's codec), and the sparse-cohort
    server nests its width-C server under ``server.inner``. The tree is
    new: no tensor of it is shared with the snapshot."""
    try:
        sv = snap["server"]
        model = str(snap["config"]["model"])
        rnd = int(snap["next_round"])
    except (KeyError, TypeError) as e:
        raise CheckpointError(
            f"snapshot is not a harness RunState (missing {e})") from e
    if isinstance(sv, dict) and "inner" in sv:
        sv = sv["inner"]
    if model not in REGISTRY:
        raise CheckpointError(f"snapshot names unknown model {model!r}")
    dev = resolve_device(device)
    if isinstance(sv, dict) and "params" in sv:
        params = tree_map(lambda a: owned_tensor(a, dev, torch.float32),
                          sv["params"])
    elif isinstance(sv, dict) and "w" in sv:
        params = _codec(model).unflatten(
            owned_tensor(sv["w"], dev, torch.float32))
    else:
        raise CheckpointError(
            "snapshot server state has neither 'params' nor 'w'")
    return model, params, rnd


class ScoringHandle:
    """One mapped model, pinned: ``score`` always runs the parameters the
    handle was pinned with, even if the owning ``ModelServer`` reloads
    mid-batch. Pin one per request batch."""

    def __init__(self, model: str, params, round_: int,
                 device: torch.device):
        self._model = model
        self._params = params
        self.round = round_
        self.device = device

    def score(self, x) -> np.ndarray:
        """(B, ...) request features -> (B, NUM_CLASSES) logits."""
        with torch.no_grad():
            xt = torch.as_tensor(np.asarray(x), device=self.device)
            return small_forward(self._params, xt, self._model).cpu().numpy()


class ModelServer:
    """Hot-reloading model server over a checkpoint directory.

    ``poll()`` is the one state transition: find the newest committed
    snapshot, claim it, load it, swap. ``pin`` and ``score`` read the
    mapped model. A load that fails to a race (the snapshot pruned between
    the scan and the read) or to a bad artifact is counted and tried again
    at the next poll, never fatal, and never maps part of a model: the
    loader checks the commit marker, the manifest's hash and every shard's
    crc before it returns anything."""

    def __init__(self, checkpoint_dir, claim: bool = True, device=None):
        self.dir = Path(checkpoint_dir)
        self.device = resolve_device(device)
        self._claim = bool(claim)
        self._token = (f"{os.getpid()}-"
                       f"{np.random.SeedSequence().entropy % 16**8:08x}")
        self._params = None
        self.model: Optional[str] = None
        self.mapped: Optional[str] = None     # snapshot name now mapped
        self.mapped_round = -1
        self.rounds_behind = 0
        self.reloads = 0
        self.failed_loads = 0
        self.last_error: Optional[str] = None
        self._reload_log = []

    # -- polling / hot reload ------------------------------------------------
    def poll(self) -> bool:
        """Map the newest committed snapshot if it is newer than the mapped
        one. Returns True if and only if a reload happened."""
        latest = checkpoint.latest_checkpoint(self.dir)
        if latest is None:
            return False
        latest_round = checkpoint.snapshot_round(latest)
        if latest_round is None:
            latest_round = self.mapped_round
        if self.mapped is not None:
            self.rounds_behind = max(latest_round - self.mapped_round, 0)
        if latest.name == self.mapped:
            return False
        # claim before load: name the mapped snapshot (still serving pinned
        # batches) and the target, then check again that the target is
        # committed; a prune that raced the scan loses here
        if self._claim:
            checkpoint.write_claim(self.dir, self._token,
                                   [self.mapped, latest.name])
        if not checkpoint.is_committed(latest):
            self._unclaim_target()
            return False
        t0 = time.perf_counter()
        try:
            snap = checkpoint.load_run_state(latest)
            model, params, rnd = extract_global_model(snap, self.device)
        except (CheckpointError, FileNotFoundError) as e:
            # raced a prune or met a bad artifact: keep the mapped model
            self.failed_loads += 1
            self.last_error = str(e)
            self._unclaim_target()
            return False
        behind = rnd - self.mapped_round if self.mapped is not None else 0
        # the swap is a rebind to the new tree: pinned handles keep theirs
        self._params = params
        self.model = model
        self.mapped = latest.name
        self.mapped_round = rnd
        self.rounds_behind = 0
        self.reloads += 1
        self._reload_log.append({"round": rnd, "behind": int(behind),
                                 "reload_s": time.perf_counter() - t0})
        if self._claim:
            checkpoint.write_claim(self.dir, self._token, [self.mapped])
        return True

    def _unclaim_target(self) -> None:
        if self._claim:
            if self.mapped is not None:
                checkpoint.write_claim(self.dir, self._token, [self.mapped])
            else:
                checkpoint.clear_claim(self.dir, self._token)

    # -- scoring -------------------------------------------------------------
    def pin(self) -> ScoringHandle:
        """Pin the mapped model for one request batch."""
        if self._params is None:
            raise RuntimeError(
                "no model mapped yet — poll() until a committed snapshot "
                f"appears under {self.dir}")
        return ScoringHandle(self.model, self._params, self.mapped_round,
                             self.device)

    def score(self, x) -> np.ndarray:
        """One-shot scoring on the mapped model."""
        return self.pin().score(x)

    # -- bookkeeping ---------------------------------------------------------
    def stats(self) -> dict:
        return {"mapped": self.mapped, "mapped_round": self.mapped_round,
                "rounds_behind": self.rounds_behind,
                "reloads": list(self._reload_log),
                "failed_loads": self.failed_loads,
                "last_error": self.last_error}

    def close(self) -> None:
        checkpoint.clear_claim(self.dir, self._token)

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.close()
        return False


def make_request_batch(rng: np.random.Generator, batch: int, dataset: int
                       ) -> np.ndarray:
    """Synthetic request features in the dataset's layout (Dataset-1:
    normal feature rows; Dataset-2: content-id sequences)."""
    feat_shape, dtype = dataset_layout(dataset)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.integers(0, NUM_CLASSES,
                            (batch,) + feat_shape).astype(dtype)
    return rng.standard_normal((batch,) + feat_shape).astype(dtype)


def serve_loop(checkpoint_dir, *, until_round: int = None,
               duration_s: float = None, poll_s: float = 0.1,
               batch: int = 32, dataset: int = 2, seed: int = 0,
               timeout_s: float = 120.0, verbose: bool = False,
               device=None) -> dict:
    """Score synthetic request batches against the hot-reloading server
    until the mapped model reaches ``until_round`` (or ``duration_s``
    passes). Each batch is scored on a pinned handle; the server polls
    between batches. Returns the serving stats and traffic counters, with
    ``score_s``, the seconds each batch took to score."""
    rng = np.random.default_rng(seed)
    deadline = time.monotonic() + (duration_s if duration_s is not None
                                   else timeout_s)
    batches = scored = 0
    mapped_rounds, score_s = [], []
    with ModelServer(checkpoint_dir, device=device) as server:
        while True:
            reloaded = server.poll()
            if reloaded:
                mapped_rounds.append(server.mapped_round)
                if verbose:
                    print(f"serve: mapped round {server.mapped_round} "
                          f"({server.rounds_behind} behind at swap)")
            if server.mapped is not None:
                handle = server.pin()
                x = make_request_batch(rng, batch, dataset)
                t0 = time.perf_counter()
                out = handle.score(x)
                score_s.append(time.perf_counter() - t0)
                batches += 1
                scored += out.shape[0]
            if until_round is not None and \
                    server.mapped_round >= until_round:
                break
            if time.monotonic() >= deadline:
                if until_round is not None:
                    raise TimeoutError(
                        f"serve_loop: model never reached round "
                        f"{until_round} (mapped {server.mapped_round}) "
                        f"within {timeout_s}s")
                break
            time.sleep(poll_s)
        stats = server.stats()
    stats.update(batches=batches, requests_scored=scored,
                 mapped_rounds=mapped_rounds, score_s=score_s)
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve the latest committed FL model from a checkpoint "
        "directory, hot-reloading as training publishes new rounds.")
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--until-round", type=int, default=None,
                    help="exit once this round is mapped")
    ap.add_argument("--duration-s", type=float, default=None,
                    help="serve for a fixed wall-clock window instead")
    ap.add_argument("--poll-s", type=float, default=0.1)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dataset", type=int, default=2, choices=(1, 2))
    ap.add_argument("--timeout-s", type=float, default=120.0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to score on the CPU (default: the CUDA "
                    "device)")
    args = ap.parse_args(argv)
    stats = serve_loop(args.checkpoint_dir, until_round=args.until_round,
                       duration_s=args.duration_s, poll_s=args.poll_s,
                       batch=args.batch, dataset=args.dataset,
                       timeout_s=args.timeout_s, verbose=True,
                       device=args.device)
    print(f"served {stats['requests_scored']} requests over "
          f"{stats['batches']} batches; {len(stats['reloads'])} reloads, "
          f"final round {stats['mapped_round']}")
    return stats


if __name__ == "__main__":
    main()
