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

A sparse-cohort admission reassigns rows to new clients (``reset_rows``,
over client rows on each rank's own block).

Over a mesh of R > 1 client rows (``create(..., mesh=)`` or ``shard``),
one process per row, the (U, D, *feat) storage and every (U, ...) leaf
hold only this rank's U / R rows. ``stage`` takes the whole cohort's
arrivals (every rank draws them all) and keeps its rows; stage and commit
stay row-local. ``sizes``, ``heads``, ``capacities`` and
``label_histograms()`` give the whole (U,) answer on every rank through
an ``all_gather``, so ``sample_slots`` draws the host RNG as one process
does and returns every client's slots; ``gather`` and the pod steps read
this rank's rows of them. ``state_dict`` gives this rank's rows (marked
``RowShard``) and ``load_state_dict`` takes them.
``stage_in_place`` and ``commit_in_place`` are the fixed-shape forms of
``stage`` and ``commit`` that the fused round's CUDA graphs hold (the
reference's ``_stage_impl`` and ``_commit_impl``, written in place).
The reference is ``repro/core/buffer_stacked.py`` without the mesh.
Labels and Dataset-2 features are int64 here; the reference's JAX arrays
hold them as int32 (``canonicalize_dtype(np.int64)`` with x64 off), with
the same values. A ``state_dict`` is written in the reference's dtypes, so
snapshots move between the packages, and ``load_state_dict`` converts
only that documented int32 -> int64 pair.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.shmap import client_sharding, row_cat
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


def _feature_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (U, W) mask broadcast over the feature dims of a (U, W, ...)
    block."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _scatter_rows(store: torch.Tensor, slot: torch.Tensor, write,
                  src: torch.Tensor, fresh: torch.Tensor) -> None:
    """``store[u, slot[u, j]] = fresh[u, src[u, j]]`` where ``write[u]``,
    else each row keeps its own value, in fixed shapes: the duplicate
    indices of a row all carry one value, so the scatter's order does not
    matter."""
    U, W = slot.shape
    uu = torch.arange(U, device=store.device)[:, None].expand(U, W)
    val = torch.where(_feature_mask(write[:, None], store),
                      fresh[uu, src].to(store.dtype), store[uu, slot])
    store[uu, slot] = val


def stage_in_place(st: BufState, x_new, y_new, counts) -> torch.Tensor:
    """``StackedOnlineBuffer.stage`` for a captured CUDA graph: the same
    staged values, written into ``st``'s own tensors with no host read and
    no data-dependent shape. A padding column rewrites its row's last
    arrival (or, in a row with none, keeps the slot's value), in the
    reference's place of a dropped scatter index. Returns a 0-d overflow
    flag (more staged than the stage capacity) for the caller to read after
    the segment, where ``stage`` raises at once."""
    S = st.staged_y.shape[1]
    A = y_new.shape[1]
    cnt = counts.to(torch.int64)
    j = torch.arange(A, device=cnt.device)[None, :]
    src = torch.where(j < cnt[:, None], j, (cnt - 1).clamp(min=0)[:, None])
    pos = (st.staged_n.to(torch.int64)[:, None] + src).clamp(max=S - 1)
    live = cnt > 0
    _scatter_rows(st.staged_x, pos, live, src, x_new)
    _scatter_rows(st.staged_y, pos, live, src, y_new)
    overflow = torch.any(st.staged_n.to(torch.int64) + cnt > S)
    st.staged_n.add_(cnt.to(st.staged_n.dtype))
    return overflow


def commit_in_place(st: BufState) -> None:
    """``StackedOnlineBuffer.commit`` for a captured CUDA graph: the same
    FIFO commit, into ``st``'s own tensors. A staged sample that is not
    kept rewrites its row's last kept one (or, in a row with nothing
    staged, keeps the slot's value)."""
    S = st.staged_y.shape[1]
    n, c = st.staged_n.to(torch.int64), st.cap.to(torch.int64)
    h, s = st.head.to(torch.int64), st.size.to(torch.int64)
    j = torch.arange(S, device=n.device)[None, :]
    # keep only the last cap staged samples; they land in distinct slots
    keep = (j < n[:, None]) & (j >= (n - c)[:, None])
    src = torch.where(keep, j, (n - 1).clamp(min=0)[:, None])
    slot = ((h + s)[:, None] + src) % c[:, None]
    live = n > 0
    _scatter_rows(st.x, slot, live, src, st.staged_x)
    _scatter_rows(st.y, slot, live, src, st.staged_y)
    st.size.copy_(torch.minimum(s + n, c))
    st.head.copy_((h + torch.clamp(s + n - c, min=0)) % c)
    st.staged_n.zero_()


@dataclass
class StackedOnlineBuffer:
    state: BufState
    num_classes: int
    last_hist: Optional[np.ndarray] = None    # the shift-proxy memory
    mesh: Optional[object] = None             # set by shard(); None: all rows
    rows: Tuple[int, int, int] = field(default=None, repr=False)

    @classmethod
    def create(cls, capacities, feature_shape: tuple, num_classes: int,
               stage_capacity: Optional[int] = None, dtype=np.float32,
               label_dtype=np.int64, depth: Optional[int] = None,
               device=None, mesh=None) -> "StackedOnlineBuffer":
        """``depth`` overrides the storage depth D (default: the largest
        capacity). With ``mesh``, only this rank's rows are allocated
        (``shard``)."""
        dev = resolve_device(device)
        caps = np.asarray(capacities, np.int32)
        U, D = caps.shape[0], int(depth if depth is not None else caps.max())
        lo, hi = (0, U) if mesh is None else client_sharding(mesh).bounds(U)
        caps, whole, U = caps[lo:hi], U, hi - lo
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
        buf = cls(state=state, num_classes=num_classes)
        if mesh is not None:
            buf.mesh, buf.rows = mesh, (lo, hi, whole)
        return buf

    def shard(self, mesh) -> "StackedOnlineBuffer":
        """Keep only this rank's rows of every (U, ...) leaf (copies, so
        the whole arrays can go); U must be a multiple of the mesh's client
        rows. Returns ``self``."""
        U = int(self.state.y.shape[0])
        lo, hi = client_sharding(mesh).bounds(U)
        self.state = BufState(*(t[lo:hi].clone() for t in self.state))
        self.mesh, self.rows = mesh, (lo, hi, U)
        return self

    @property
    def device(self) -> torch.device:
        return self.state.y.device

    def _mine(self, x):
        """This rank's rows of a whole-cohort (U, ...) array."""
        return x if self.rows is None else x[self.rows[0]:self.rows[1]]

    # -- staging (within-round arrivals go to the temp buffer) ---------------
    def stage(self, x_new, y_new, counts) -> None:
        """x_new (U, A, *feat) / y_new (U, A) padded rows; counts (U,) valid
        prefixes. Total staged per client must fit the stage capacity."""
        st = self.state
        x_new, y_new = self._mine(x_new), self._mine(y_new)
        counts = self._mine(np.asarray(counts))
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
        """Apply staged arrivals FIFO. Returns the #ingested of the
        buffer's rows (over client rows, this rank's: commit is
        row-local)."""
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
        snapshot taken before keeps its values. ``rows`` are whole-cohort
        indices: over client rows each rank resets those of its own block
        and ignores the others."""
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
        if self.rows is not None:
            lo, hi, _ = self.rows
            mine = (rows >= lo) & (rows < hi)
            rows, caps = rows[mine] - lo, caps[mine]
            if rows.size == 0:
                return
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
    def _pointers(self) -> np.ndarray:
        """(3, U) capacities, heads and sizes of the whole cohort."""
        st = self.state
        return row_cat(torch.stack([st.cap, st.head, st.size], dim=1),
                       self.mesh).T.cpu().numpy()

    @property
    def sizes(self) -> np.ndarray:
        return self._pointers()[2]

    @property
    def heads(self) -> np.ndarray:
        return self._pointers()[1]

    @property
    def capacities(self) -> np.ndarray:
        return self._pointers()[0]

    def dataset(self, u: int) -> Tuple[np.ndarray, np.ndarray]:
        """Client u's live samples in FIFO order (over client rows, u must
        be one of this rank's)."""
        if self.rows is not None:
            lo, hi, _ = self.rows
            if not lo <= u < hi:
                raise IndexError(f"client {u} lives on another rank (this "
                                 f"rank holds clients {lo}:{hi})")
            u -= lo
        st = self.state
        h, s, c = int(st.head[u]), int(st.size[u]), int(st.cap[u])
        idx = (h + np.arange(s)) % c
        return (st.x[u].cpu().numpy()[idx], st.y[u].cpu().numpy()[idx])

    def label_histograms(self) -> np.ndarray:
        """(U, C) normalized label histograms over each live window (the
        whole cohort's on every rank)."""
        st = self.state
        D = st.y.shape[1]
        p = torch.arange(D, dtype=torch.int32, device=self.device)[None, :]
        c, h, s = st.cap[:, None], st.head[:, None], st.size[:, None]
        live = (p < c) & (((p - h) % c) < s)
        onehot = torch.nn.functional.one_hot(st.y.long(),
                                             self.num_classes).float()
        hist = torch.sum(onehot * live[..., None], dim=1)
        hist = hist / torch.clamp(hist.sum(dim=1, keepdim=True), min=1.0)
        return row_cat(hist, self.mesh).cpu().numpy()

    # -- batch sampling -------------------------------------------------------
    def sample_slots(self, rng: np.random.Generator, sample_shape: tuple
                     ) -> np.ndarray:
        """(U, *sample_shape) storage slots, uniform over each client's live
        window (empty buffers fall back to slot head). Consumes ``rng``
        exactly as the reference does (over client rows every rank draws
        every client's slots)."""
        cap, head, size = self._pointers()
        size = np.maximum(size, 1)
        U = size.shape[0]
        lead = (U,) + (1,) * len(sample_shape)
        j = rng.integers(0, size.reshape(lead),
                         size=(U,) + tuple(sample_shape))
        return (head.reshape(lead) + j) % cap.reshape(lead)

    def gather(self, slots: np.ndarray) -> dict:
        """Gather sampled slots -> batch tree {x, y} with leaves
        (U, *sample_shape, ...) for the vmapped local trainer (over client
        rows, this rank's rows of them)."""
        slots = self._mine(slots)
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
        them), int64 ones as int32 copies, the reference's dtype; over
        client rows, this rank's rows of them as ``RowShard``s."""
        from repro_torch.checkpoint.run_state import row_leaf
        lo, _, whole = self.rows or (0, 0, int(self.state.y.shape[0]))
        out = {}
        for k, t in self.state._asdict().items():
            dt = _SNAPSHOT_DTYPES.get(t.dtype)
            out[k] = row_leaf(t if dt is None
                              else t.cpu().numpy().astype(dt), lo, whole)
        out["num_classes"] = int(self.num_classes)
        out["last_hist"] = self.last_hist
        return out

    def load_state_dict(self, sd: dict) -> None:
        """Restore a ``state_dict`` snapshot (full overwrite; staged
        arrivals resume where they were). Each array is checked against
        the live buffer's shape and dtype: a snapshot fits only the cohort
        shape it came from. An int32 leaf loads into an int64 one (the
        reference's stored dtype); any other dtype mismatch raises. Over
        client rows a leaf may hold the whole cohort or this rank's rows."""
        from repro_torch.checkpoint.run_state import CheckpointError, own_rows
        cur = self.state._asdict()
        missing = sorted(set(cur) - set(sd))
        if missing:
            raise CheckpointError(
                "buffer snapshot is missing keys: " + ", ".join(missing))
        loaded = {}
        for k, want in cur.items():
            got = np.asarray(sd[k])
            if self.rows is not None:
                got = own_rows(got, *self.rows)
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
