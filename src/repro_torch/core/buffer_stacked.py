"""Stacked time-varying FIFO client datasets (paper Section II-A).

All U clients' bounded datasets live in one (U, D, ...) device tensor
(D = the largest capacity) with per-client capacity/head/size pointers.
Arrivals are staged during the round and committed FIFO at the round
boundary by one scatter, the closed form of ``repro/core/buffer.py``'s
sequential insert loop:

  * staged sample j lands in slot ``(head + size + j) mod cap``;
  * of an over-capacity commit only the last ``cap`` staged samples
    survive, so the rest are dropped and no slot is written twice;
  * ``size`` becomes ``min(size + n, cap)`` and ``head`` advances by the
    overflow ``max(size + n - cap, 0)``.

A sparse-cohort admission reassigns rows to new clients (``reset_rows``).
The reference is ``repro/core/buffer_stacked.py`` without the mesh.
Labels and Dataset-2 features are int64 here; the reference's JAX arrays
hold them as int32 (``canonicalize_dtype(np.int64)`` with x64 off), with
the same values. A ``state_dict`` is written in the reference's dtypes, so
snapshots move between the packages, and ``load_state_dict`` converts
only that documented int32 -> int64 pair.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import owned_tensor, resolve_device


class BufState(NamedTuple):
    """Device state of all U buffers."""
    x: torch.Tensor          # (U, D, *feat) feature storage
    y: torch.Tensor          # (U, D) labels
    cap: torch.Tensor        # (U,) int32 per-client capacity D_u
    size: torch.Tensor       # (U,) int32
    head: torch.Tensor       # (U,) int32 FIFO eviction pointer
    staged_x: torch.Tensor   # (U, S, *feat) within-round staging
    staged_y: torch.Tensor   # (U, S)
    staged_n: torch.Tensor   # (U,) int32


# the reference's stored dtype of an int64 leaf (its x64-off JAX arrays)
_SNAPSHOT_DTYPES = {torch.int64: np.int32}


@dataclass
class StackedOnlineBuffer:
    state: BufState
    num_classes: int
    last_hist: Optional[np.ndarray] = None    # the shift-proxy memory

    @classmethod
    def create(cls, capacities, feature_shape: tuple, num_classes: int,
               stage_capacity: Optional[int] = None, dtype=np.float32,
               label_dtype=np.int64, depth: Optional[int] = None,
               device=None) -> "StackedOnlineBuffer":
        """``depth`` overrides the storage depth D (default: the largest
        capacity)."""
        dev = resolve_device(device)
        caps = np.asarray(capacities, np.int32)
        U, D = caps.shape[0], int(depth if depth is not None else caps.max())
        if int(caps.max()) > D:
            raise ValueError(
                f"storage depth {D} is smaller than the largest initial "
                f"capacity {int(caps.max())}")
        S = int(stage_capacity) if stage_capacity else D
        feat = tuple(feature_shape)
        xdt = torch.from_numpy(np.zeros(0, dtype)).dtype
        ydt = torch.from_numpy(np.zeros(0, label_dtype)).dtype
        i32 = dict(dtype=torch.int32, device=dev)
        state = BufState(
            x=torch.zeros((U, D) + feat, dtype=xdt, device=dev),
            y=torch.zeros((U, D), dtype=ydt, device=dev),
            cap=torch.as_tensor(caps, **i32),
            size=torch.zeros(U, **i32),
            head=torch.zeros(U, **i32),
            staged_x=torch.zeros((U, S) + feat, dtype=xdt, device=dev),
            staged_y=torch.zeros((U, S), dtype=ydt, device=dev),
            staged_n=torch.zeros(U, **i32))
        return cls(state=state, num_classes=num_classes)

    @property
    def device(self) -> torch.device:
        return self.state.y.device

    # -- staging (within-round arrivals go to the temp buffer) ---------------
    def stage(self, x_new, y_new, counts) -> None:
        """x_new (U, A, *feat) / y_new (U, A) padded rows; counts (U,) valid
        prefixes. Total staged per client must fit the stage capacity."""
        st = self.state
        counts = np.asarray(counts)
        S = st.staged_y.shape[1]
        staged = st.staged_n.cpu().numpy() + counts
        if staged.max(initial=0) > S:
            raise ValueError(f"staged {int(staged.max())} > stage_capacity "
                             f"{S}; raise stage_capacity at create()")
        dev = self.device
        x_new = torch.as_tensor(x_new, device=dev).to(st.staged_x.dtype)
        y_new = torch.as_tensor(y_new, device=dev).to(st.staged_y.dtype)
        cnt = torch.as_tensor(counts, dtype=torch.int32, device=dev)
        U, A = y_new.shape
        j = torch.arange(A, dtype=torch.int32, device=dev)
        valid = j[None, :] < cnt[:, None]
        pos = (st.staged_n[:, None] + j[None, :])[valid].long()
        uu = torch.arange(U, device=dev)[:, None].expand(U, A)[valid]
        st.staged_x[uu, pos] = x_new[valid]
        st.staged_y[uu, pos] = y_new[valid]
        self.state = st._replace(staged_n=st.staged_n + cnt)

    def commit(self) -> int:
        """Apply staged arrivals FIFO. Returns the cohort's #ingested."""
        st = self.state
        U, S = st.staged_y.shape
        n, c, h, s = st.staged_n, st.cap, st.head, st.size
        total = int(n.sum())
        j = torch.arange(S, dtype=torch.int32, device=self.device)
        # keep only the last cap staged samples; they land in distinct slots
        keep = (j[None, :] < n[:, None]) & (j[None, :] >= (n - c)[:, None])
        slot = (((h + s)[:, None] + j[None, :]) % c[:, None])[keep].long()
        uu = torch.arange(U, device=self.device)[:, None].expand(U, S)[keep]
        st.x[uu, slot] = st.staged_x[keep]
        st.y[uu, slot] = st.staged_y[keep]
        self.state = st._replace(
            size=torch.minimum(s + n, c),
            head=(h + torch.clamp(s + n - c, min=0)) % c,
            staged_n=torch.zeros_like(n))
        return total

    # -- slot reassignment (sparse-cohort admissions) ------------------------
    def reset_rows(self, rows, capacities) -> None:
        """Reassign storage rows to new clients (a slot-pool admission,
        ``core/cohort.py``): each row's capacity becomes the incoming
        client's D_u and its FIFO window and staging empty out. The storage
        is reused: the evicted client's samples are dead (size 0 masks
        them from the live window, the histograms and the slot sampling)
        and are overwritten as the new resident's arrivals land. The four
        (U,) pointer tensors are replaced, not written in place, so a
        snapshot taken before keeps its values."""
        rows = np.asarray(rows, np.int64).ravel()
        if rows.size == 0:
            return
        caps = np.asarray(capacities, np.int32).ravel()
        if caps.shape != rows.shape:
            raise ValueError(
                f"reset_rows needs one capacity per row (got {rows.size} "
                f"rows, {caps.size} capacities)")
        D = int(self.state.y.shape[1])
        if caps.min(initial=1) < 1 or caps.max(initial=0) > D:
            raise ValueError(
                f"reassigned capacities must lie in [1, {D}] (the allocated "
                f"storage depth); got [{caps.min()}, {caps.max()}]")
        st = self.state
        idx = torch.as_tensor(rows, device=self.device)
        zero = torch.zeros(rows.size, dtype=torch.int32, device=self.device)
        self.state = st._replace(
            cap=st.cap.index_copy(0, idx, torch.as_tensor(
                caps, device=self.device)),
            size=st.size.index_copy(0, idx, zero),
            head=st.head.index_copy(0, idx, zero),
            staged_n=st.staged_n.index_copy(0, idx, zero))

    # -- views ----------------------------------------------------------------
    @property
    def sizes(self) -> np.ndarray:
        return self.state.size.cpu().numpy()

    @property
    def heads(self) -> np.ndarray:
        return self.state.head.cpu().numpy()

    @property
    def capacities(self) -> np.ndarray:
        return self.state.cap.cpu().numpy()

    def dataset(self, u: int) -> Tuple[np.ndarray, np.ndarray]:
        """Client u's live samples in FIFO order."""
        h, s, c = (int(self.heads[u]), int(self.sizes[u]),
                   int(self.capacities[u]))
        idx = (h + np.arange(s)) % c
        return (self.state.x[u].cpu().numpy()[idx],
                self.state.y[u].cpu().numpy()[idx])

    def label_histograms(self) -> np.ndarray:
        """(U, C) normalized label histograms over each live window."""
        st = self.state
        D = st.y.shape[1]
        p = torch.arange(D, dtype=torch.int32, device=self.device)[None, :]
        c, h, s = st.cap[:, None], st.head[:, None], st.size[:, None]
        live = (p < c) & (((p - h) % c) < s)
        onehot = torch.nn.functional.one_hot(st.y.long(),
                                             self.num_classes).float()
        hist = torch.sum(onehot * live[..., None], dim=1)
        hist = hist / torch.clamp(hist.sum(dim=1, keepdim=True), min=1.0)
        return hist.cpu().numpy()

    # -- batch sampling -------------------------------------------------------
    def sample_slots(self, rng: np.random.Generator, sample_shape: tuple
                     ) -> np.ndarray:
        """(U, *sample_shape) storage slots, uniform over each client's live
        window (empty buffers fall back to slot head). Consumes ``rng``
        exactly as the reference does."""
        size = np.maximum(self.sizes, 1)
        U = size.shape[0]
        lead = (U,) + (1,) * len(sample_shape)
        j = rng.integers(0, size.reshape(lead),
                         size=(U,) + tuple(sample_shape))
        return (self.heads.reshape(lead) + j) % self.capacities.reshape(lead)

    def gather(self, slots: np.ndarray) -> dict:
        """Gather sampled slots -> batch tree {x, y} with leaves
        (U, *sample_shape, ...) for the vmapped local trainer."""
        U = slots.shape[0]
        uu = torch.arange(U, device=self.device).reshape(
            (U,) + (1,) * (slots.ndim - 1))
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        return {"x": self.state.x[uu, idx], "y": self.state.y[uu, idx]}

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """Full snapshot under the reference's keys: storage, per-client
        capacity/head/size pointers, staged-but-uncommitted arrivals and
        the shift-proxy memory, everything a bit-identical mid-stream
        resume needs. The leaves are the live tensors (a writer copies
        them), int64 ones as int32 copies, the reference's dtype."""
        out = {}
        for k, t in self.state._asdict().items():
            dt = _SNAPSHOT_DTYPES.get(t.dtype)
            out[k] = t if dt is None else t.cpu().numpy().astype(dt)
        out["num_classes"] = int(self.num_classes)
        out["last_hist"] = self.last_hist
        return out

    def load_state_dict(self, sd: dict) -> None:
        """Restore a ``state_dict`` snapshot (full overwrite; staged
        arrivals resume where they were). Each array is checked against
        the live buffer's shape and dtype: a snapshot fits only the cohort
        shape it came from. An int32 leaf loads into an int64 one (the
        reference's stored dtype); any other dtype mismatch raises."""
        from repro_torch.checkpoint.run_state import CheckpointError
        cur = self.state._asdict()
        missing = sorted(set(cur) - set(sd))
        if missing:
            raise CheckpointError(
                "buffer snapshot is missing keys: " + ", ".join(missing))
        loaded = {}
        for k, want in cur.items():
            got = np.asarray(sd[k])
            if tuple(got.shape) != tuple(want.shape):
                raise CheckpointError(
                    f"buffer snapshot {k!r} has shape {tuple(got.shape)}; "
                    f"the live buffer expects {tuple(want.shape)}")
            want_np = torch.empty(0, dtype=want.dtype).numpy().dtype
            if got.dtype != want_np and got.dtype != _SNAPSHOT_DTYPES.get(
                    want.dtype):
                raise CheckpointError(
                    f"buffer snapshot {k!r} has dtype {got.dtype}; the live "
                    f"buffer expects {want_np}")
            # an owned copy: the round writes the storage in place
            loaded[k] = owned_tensor(got.astype(want_np, copy=False),
                                     self.device)
        self.state = BufState(**loaded)
        self.num_classes = int(sd["num_classes"])
        lh = sd["last_hist"]
        self.last_hist = None if lh is None else np.asarray(lh)
