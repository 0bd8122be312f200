"""Sparse-cohort server state: a fixed-capacity pool of active slots in
front of the stacked servers (``repro/core/cohort.py``).

The dense engines hold a (U, N) contribution buffer and (U, D, ...) FIFO
datasets for every registered user. This module decouples the registered
population U from the round's width C:

  * ``SlotPool``: a host-side bijection between resident user ids and the
    C pool slots (``user_slot``/``slot_user`` int32 maps, FIFO eviction
    clocks). Everything round-dense (contribution rows, FIFO datasets, the
    local-SGD batch) is slot-indexed and C wide.
  * ``CohortTables``: the per-user (U,) tables (scores, the stale-score
    carry, participation flags) on the run's device.
  * ``SparseCohortServer``: a width-C stacked server (the unchanged
    ``StackedOSAFLServer``/``STACKED_SERVERS`` classes, or their two-tier
    counterparts of ``core/hierarchy.py``) behind the pool. Each round the
    inner server runs its round on the (C, N) slot buffer and the results
    are copied back into the per-user tables; at admission the carried
    per-user state is gathered into the slot and the slot's contribution
    row is reset to the algorithm's refresh value (``init_row``). A slot's
    contribution row and dataset are lost when its user is evicted.

With ``cohort_size = U`` the pool is the identity map, the inner server is
the dense stacked server, and the harness draws its host RNG in the dense
order, so runs are bit-exact against the dense engines for every
algorithm. With C < U the width-C aggregation renormalizes the weights
over the sampled cohort (Dinh et al.'s partial-participation rule).

Over a mesh of R > 1 client rows (``mesh=``, one process per row, as the
pod engine runs) the inner width-C server lies on the row block: each
rank holds C/R slots of its contribution buffer (under the hierarchy,
K/R whole cluster blocks). The pool stays on the host and whole on every
rank, since every rank draws the whole cohort from the same host RNG.
``CohortTables`` split over the ranks by user, rank r holding users
``[r*U/R, (r+1)*U/R)``: an admission brings the seated users' values to
every rank in one ``all_gather`` (``shmap.row_take``) and each rank writes
the newly seated slots of its own block; after a round each rank writes
back the users it owns, from the whole (C,) participation flags, which
one ``row_cat`` a round gathers. The non-OSAFL sticky metadata (sizes,
kappas, histograms) is host numpy and whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint.run_state import (CheckpointError, own_rows,
                                              row_leaf,
                                              validate_cohort_shapes)
from repro_torch.configs.base import FLConfig
from repro_torch.core.baselines import STACKED_SERVERS
from repro_torch.core.osafl import StackedOSAFLServer
from repro_torch.core.shmap import (client_rows, client_sharding, row_cat,
                                    row_take)
from repro_torch.device import owned_tensor, resolve_device


def sample_participants(rng: np.random.Generator, num_users: int, m: int,
                        weights: Optional[np.ndarray] = None,
                        available: Optional[np.ndarray] = None) -> np.ndarray:
    """The round-active participant set (sorted user ids).

    With neither ``weights`` nor ``available`` this is exactly
    ``np.sort(rng.choice(U, size=m, replace=False))``. ``weights`` (U,) are
    relative sampling weights (Pareto-biased selection), ``available`` (U,)
    masks departed users out (churn); when fewer than ``m`` users remain
    the sample shrinks to the available count, possibly to none."""
    if weights is None and available is None:
        return np.sort(rng.choice(num_users, size=m, replace=False))
    w = (np.ones(num_users, np.float64) if weights is None
         else np.asarray(weights, np.float64).copy())
    if w.shape != (num_users,):
        raise ValueError(
            f"selection weights must have shape ({num_users},), "
            f"got {w.shape}")
    if (w < 0).any():
        raise ValueError("selection weights must be non-negative")
    if available is not None:
        w[~np.asarray(available, bool)] = 0.0
    eligible = int(np.count_nonzero(w))
    m = min(int(m), eligible)
    if m == 0:
        return np.empty(0, np.int64)
    return np.sort(rng.choice(num_users, size=m, replace=False,
                              p=w / w.sum()))


class AdmitResult(NamedTuple):
    """Outcome of ``SlotPool.admit``: per requested user its slot, whether
    the user was newly seated by this call (its slot state must be
    initialized), and which residents were evicted to make room."""
    slots: np.ndarray       # (k,) int32, aligned with the admitted users
    newly: np.ndarray       # (k,) bool
    evicted: np.ndarray     # (m,) int32 user ids displaced by this call


class SlotPool:
    """Host-side user <-> slot bijection with FIFO eviction.

    ``user_slot`` (U,) maps user -> slot (-1: not resident); ``slot_user``
    (C,) maps slot -> user (-1: free). ``admit_seq[s]`` is the tick slot
    s's resident was seated (-1: free) and ``free_seq[s]`` the tick it was
    freed (-1: occupied); fresh slots are pre-freed in index order, so the
    first admissions fill 0..C-1 left to right (at C = U the identity
    map). Eviction takes the oldest-seated resident not being admitted by
    the same call; freed slots are reused oldest-freed first."""

    def __init__(self, num_users: int, capacity: int):
        if not 1 <= capacity <= num_users:
            raise ValueError(
                f"slot-pool capacity must satisfy 1 <= C <= U "
                f"(got C={capacity}, U={num_users})")
        self.U = int(num_users)
        self.C = int(capacity)
        self.user_slot = np.full(self.U, -1, np.int32)
        self.slot_user = np.full(self.C, -1, np.int32)
        self.admit_seq = np.full(self.C, -1, np.int64)
        self.free_seq = np.arange(self.C, dtype=np.int64)
        self._clock = self.C

    @property
    def cohort(self) -> np.ndarray:
        """(C,) slot -> user id (-1: free slot)."""
        return self.slot_user.copy()

    @property
    def occupancy(self) -> int:
        return int((self.slot_user >= 0).sum())

    def resident(self, users) -> np.ndarray:
        return self.user_slot[np.asarray(users, np.int64)] >= 0

    def admit(self, users) -> AdmitResult:
        users = np.asarray(users, np.int64).ravel()
        if users.size:
            if users.min() < 0 or users.max() >= self.U:
                raise ValueError(
                    f"user ids must be in [0, {self.U}); got range "
                    f"[{users.min()}, {users.max()}]")
            if np.unique(users).size != users.size:
                raise ValueError("duplicate user ids in one admit() call")
        if users.size > self.C:
            raise ValueError(
                f"cannot admit {users.size} users into {self.C} slots")
        protected = set(users.tolist())
        slots = np.empty(users.size, np.int32)
        newly = np.zeros(users.size, bool)
        evicted = []
        for i, u in enumerate(users.tolist()):
            s = int(self.user_slot[u])
            if s < 0:
                free = np.flatnonzero(self.free_seq >= 0)
                if free.size:
                    s = int(free[np.argmin(self.free_seq[free])])
                else:
                    occ = [int(c) for c in np.flatnonzero(self.admit_seq >= 0)
                           if int(self.slot_user[c]) not in protected]
                    s = min(occ, key=lambda c: self.admit_seq[c])
                    ev = int(self.slot_user[s])
                    self.user_slot[ev] = -1
                    evicted.append(ev)
                self.slot_user[s] = u
                self.user_slot[u] = s
                self.admit_seq[s] = self._clock
                self.free_seq[s] = -1
                self._clock += 1
                newly[i] = True
            slots[i] = s
        return AdmitResult(slots=slots, newly=newly,
                           evicted=np.asarray(evicted, np.int32))

    def evict(self, users) -> np.ndarray:
        """Free the given users' slots (non-residents are ignored). Returns
        the freed slot indices."""
        freed = []
        for u in np.asarray(users, np.int64).ravel().tolist():
            s = int(self.user_slot[u])
            if s < 0:
                continue
            self.user_slot[u] = -1
            self.slot_user[s] = -1
            self.admit_seq[s] = -1
            self.free_seq[s] = self._clock
            self._clock += 1
            freed.append(s)
        return np.asarray(freed, np.int32)

    def check(self) -> None:
        """Raise ``ValueError`` unless the two maps are a bijection on the
        residents and the clock tables mark exactly the occupied and the
        free slots."""
        occ = np.flatnonzero(self.slot_user >= 0)
        res = np.flatnonzero(self.user_slot >= 0)
        if occ.size != res.size:
            raise ValueError(
                f"slot pool leak: {occ.size} occupied slots vs "
                f"{res.size} resident users")
        for s in occ.tolist():
            u = int(self.slot_user[s])
            if int(self.user_slot[u]) != s:
                raise ValueError(
                    f"slot aliasing: slot {s} holds user {u} but "
                    f"user_slot[{u}] = {int(self.user_slot[u])}")
        if ((self.admit_seq >= 0) != (self.slot_user >= 0)).any():
            raise ValueError("admit_seq marks do not match occupied slots")
        if ((self.free_seq >= 0) != (self.slot_user < 0)).any():
            raise ValueError("free_seq marks do not match free slots")
        live = np.concatenate([self.admit_seq[self.admit_seq >= 0],
                               self.free_seq[self.free_seq >= 0]])
        if live.size and live.max(initial=-1) >= self._clock:
            raise ValueError("clock table entry ahead of the pool clock")

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        return {"user_slot": self.user_slot.copy(),
                "slot_user": self.slot_user.copy(),
                "admit_seq": self.admit_seq.copy(),
                "free_seq": self.free_seq.copy(),
                "clock": np.int64(self._clock)}

    def load_state_dict(self, sd: dict) -> None:
        validate_cohort_shapes(sd, self.U, self.C)
        self.user_slot = np.asarray(sd["user_slot"], np.int32).copy()
        self.slot_user = np.asarray(sd["slot_user"], np.int32).copy()
        self.admit_seq = np.asarray(sd["admit_seq"], np.int64).copy()
        self.free_seq = np.asarray(sd["free_seq"], np.int64).copy()
        self._clock = int(sd["clock"])
        self.check()


class CohortTables:
    """Per-user (U,) tables on one device. ``gather`` pulls cohort rows
    into (C,) slot vectors (copies); ``scatter`` writes slot results back
    in place. With the ``mesh`` of R > 1 client rows each rank holds users
    ``[r*U/R, (r+1)*U/R)`` of every table (the reference's tables split
    over the client axes): ``gather`` returns every requested value on
    every rank, through one ``all_gather`` for all tables, and ``scatter``
    writes only the users this rank owns."""

    def __init__(self, num_users: int, tables: dict, device=None,
                 mesh=None):
        self.U = int(num_users)
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and self.U % client_rows(mesh):
            raise ValueError(
                f"user-table length {self.U} is not divisible by the mesh's "
                f"{client_rows(mesh)} client rows")
        self.rows = ((0, self.U) if mesh is None
                     else client_sharding(mesh).bounds(self.U))
        lo, hi = self.rows
        self._tables = {k: torch.as_tensor(np.asarray(v)[lo:hi],
                                           device=self.device)
                        for k, v in tables.items()}

    def keys(self):
        return self._tables.keys()

    def __getitem__(self, k):
        """This rank's rows of table ``k`` (all U without a mesh)."""
        return self._tables[k]

    def gather(self, users) -> dict:
        users = np.asarray(users, np.int64).ravel()
        lo, hi = self.rows
        if (lo, hi) == (0, self.U):
            idx = torch.as_tensor(users, device=self.device)
            return {k: v.index_select(0, idx)
                    for k, v in self._tables.items()}
        # each rank reads the users it owns (row 0 stands in for the
        # others) and every table's bytes travel in one gather
        n = users.size
        idx = torch.as_tensor(np.where((users >= lo) & (users < hi),
                                       users - lo, 0), device=self.device)
        local = [v.index_select(0, idx).reshape(n, -1)
                 for v in self._tables.values()]
        packed = torch.cat([t.view(torch.uint8) for t in local], dim=1)
        whole = row_take(packed, users // (hi - lo), self.mesh)
        out, at = {}, 0
        for (k, v), t in zip(self._tables.items(), local):
            width = t.shape[1] * t.element_size()
            out[k] = whole[:, at:at + width].clone(
                memory_format=torch.contiguous_format).view(v.dtype).reshape(
                    (n,) + tuple(v.shape[1:]))
            at += width
        return out

    def scatter(self, users, values: dict) -> None:
        """Write ``values`` (each aligned with ``users``) into the tables:
        over client rows, the entries of the users this rank owns."""
        users = np.asarray(users, np.int64).ravel()
        lo, hi = self.rows
        mine = np.flatnonzero((users >= lo) & (users < hi))
        whole = mine.size == users.size
        idx = torch.as_tensor(users[mine] - lo, device=self.device)
        sel = torch.as_tensor(mine, device=self.device)
        for k, val in values.items():
            t = self._tables[k]
            v = torch.as_tensor(val, device=t.device).to(t.dtype)
            t.index_copy_(0, idx, v if whole else v.index_select(0, sel))

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """The live tables (a writer copies them: ``scatter`` writes in
        place); over client rows this rank's rows, marked ``RowShard``."""
        return {k: row_leaf(v, self.rows[0], self.U)
                for k, v in self._tables.items()}

    def load_state_dict(self, sd: dict) -> None:
        """Restore the tables from a snapshot's whole leaves or, over
        client rows, from this rank's rows of them."""
        missing = sorted(set(self._tables) - set(sd))
        if missing:
            raise CheckpointError(
                "cohort-table snapshot is missing keys: "
                + ", ".join(missing))
        for k, cur in self._tables.items():
            got = own_rows(sd[k], *self.rows, self.U)
            if tuple(got.shape) != tuple(cur.shape):
                raise CheckpointError(
                    f"cohort table {k!r} has snapshot shape "
                    f"{tuple(got.shape)}; the live run expects "
                    f"{tuple(cur.shape)}")
            self._tables[k] = owned_tensor(got, self.device, cur.dtype)


class SparseCohortServer:
    """``SlotPool`` and ``CohortTables`` around an unchanged width-C stacked
    server (see the module docstring). ``round_stacked`` forwards to the
    inner server, whose round takes (C, N) updates and a (C,) active mask,
    both slot-indexed, and then copies the per-slot results back into the
    per-user tables, so an eviction needs no write of its own. With
    ``mesh`` the inner server and the tables lie over its client rows
    (module docstring)."""

    def __init__(self, params, fl: FLConfig, num_users: int, seed: int = 0,
                 capacity: Optional[int] = None, device=None, mesh=None):
        capacity = int(fl.cohort_size if capacity is None else capacity)
        if not 1 <= capacity <= num_users:
            raise ValueError(
                f"cohort_size must satisfy 1 <= C <= num_clients "
                f"(got C={capacity}, num_clients={num_users})")
        dev = self.device = resolve_device(device)
        self.fl = fl
        self.U = int(num_users)
        self.C = capacity
        self.mesh = mesh
        # this rank's block of the C slots (all of them without a mesh)
        self.slots = ((0, capacity) if mesh is None
                      else client_sharding(mesh).bounds(capacity))
        self.K = int(fl.num_clusters)
        self.is_osafl = fl.algorithm == "osafl"
        inner_fl = dataclasses.replace(fl, num_clients=capacity,
                                       cohort_size=0, participation=1.0)
        if self.K >= 1:
            # K per-cluster slot blocks in front of the two-tier inner
            # server, whose round splits its buffer into the same K blocks
            from repro_torch.core.hierarchy import (ClusterSlotPool,
                                                    contiguous_clusters,
                                                    make_hier_server)
            self.assign = contiguous_clusters(self.U, self.K)
            if capacity % self.K:
                raise ValueError(
                    f"num_clusters must divide cohort_size "
                    f"(got K={self.K}, C={capacity})")
            self.inner = make_hier_server(params, inner_fl, capacity,
                                          seed=seed, device=dev, mesh=mesh)
            self.pool = ClusterSlotPool(self.U, capacity, self.assign,
                                        self.K)
        elif self.is_osafl:
            self.assign = None
            self.inner = StackedOSAFLServer(params, inner_fl, capacity,
                                            seed=seed, device=dev, mesh=mesh)
            self.pool = SlotPool(num_users, capacity)
        elif fl.algorithm in STACKED_SERVERS:
            self.assign = None
            self.inner = STACKED_SERVERS[fl.algorithm](
                params, inner_fl, capacity, seed=seed, device=dev, mesh=mesh)
            self.pool = SlotPool(num_users, capacity)
        else:
            raise ValueError(f"unknown algorithm {fl.algorithm!r}")
        tables = {"participated": np.zeros(self.U, bool)}
        if self.is_osafl:
            tables["scores"] = np.ones(self.U, np.float32)
            tables["lam_prev"] = np.ones(self.U, np.float32)
        self.tables = CohortTables(self.U, tables, device=dev, mesh=mesh)
        if not self.is_osafl:
            # sticky per-user metadata, on the host like the inner servers'
            self.sizes = np.ones(self.U)
            self.kappas = np.ones(self.U)
            self.hists: Optional[np.ndarray] = None
            self.has_hist = np.zeros(self.U, bool)

    # -- delegated views -----------------------------------------------------
    @property
    def params(self):
        return self.inner.params

    @property
    def w(self):
        return self.inner.w

    @property
    def codec(self):
        return self.inner.codec

    @property
    def alphas(self):
        return self.inner.alphas

    @property
    def cohort(self) -> np.ndarray:
        """(C,) slot -> user map of the current residents."""
        return self.pool.cohort

    @property
    def last_scores(self) -> np.ndarray:
        """Per-user (U,) scores (OSAFL): the carried score table (over
        client rows gathered from every rank, so every rank reads it)."""
        if not self.is_osafl:
            raise AttributeError("last_scores is OSAFL-only")
        return row_cat(self.tables["scores"], self.mesh).cpu().numpy()

    # -- admission -----------------------------------------------------------
    def initial_residents(self) -> np.ndarray:
        """The users seated before round 0: the first C ids on the flat
        pool; under the hierarchy the first C/K members of each cluster, so
        every block starts full (both ``arange(C)`` at K=1)."""
        if self.K < 1:
            return np.arange(self.C, dtype=np.int64)
        B = self.C // self.K
        return np.concatenate([
            np.flatnonzero(self.assign == k)[:B] for k in range(self.K)])

    def apply_cluster_moves(self, users, dest):
        """Move ``users`` to clusters ``dest`` (scenario membership churn).
        Residents among the movers leave their old block and are re-seated
        in the new one at once: their carried tables follow them, their
        slot's contribution row and FIFO dataset reset. A user named twice
        takes the last destination. Returns ``(moved_residents,
        AdmitResult or None)``; the caller resets the same slots of its
        dataset buffer, as after any admission."""
        if self.K < 1:
            raise ValueError(
                "cluster moves require a hierarchical run (num_clusters>=1)")
        users = np.asarray(users, np.int64).ravel()
        dest = np.asarray(dest, np.int64).ravel()
        if users.size:
            _, first_rev = np.unique(users[::-1], return_index=True)
            keep = np.sort(users.size - 1 - first_rev)
            users, dest = users[keep], dest[keep]
        moved = self.pool.reassign(users, dest)
        if moved.size == 0:
            return moved, None
        return moved, self.admit(moved)

    def admit(self, users) -> AdmitResult:
        """Seat ``users`` (FIFO-evicting as needed) and load each newly
        seated slot: the carried per-user state is gathered from the
        tables and the contribution row is reset to ``init_row`` in place
        (the evicted resident's row is lost). Over client rows each rank
        resets the newly seated slots of its own block and writes the
        whole-width state (the score carry, ``last_scores``) for all of
        them. The caller resets the same slots of its dataset buffer
        (``StackedOnlineBuffer.reset_rows``)."""
        res = self.pool.admit(users)
        ns = res.slots[res.newly]
        if ns.size == 0:
            return res
        nu = np.asarray(users, np.int64).ravel()[res.newly]
        g = self.tables.gather(nu)
        inner = self.inner
        lo, hi = self.slots
        mine = np.flatnonzero((ns >= lo) & (ns < hi))
        idx = torch.as_tensor(ns[mine].astype(np.int64) - lo,
                              device=self.device)
        rows = inner.init_row()[None, :].expand(mine.size, -1)
        if self.is_osafl:
            sel = torch.as_tensor(mine, device=self.device)
            inner.d_buffer.index_copy_(0, idx, rows)
            inner.participated = inner.participated.index_copy(
                0, idx, g["participated"].index_select(0, sel))
            inner._lam_prev = inner._lam_prev.index_copy(
                0, torch.as_tensor(ns.astype(np.int64), device=self.device),
                g["lam_prev"])
            ls = np.array(inner.last_scores)
            ls[ns] = g["scores"].cpu().numpy()
            inner.last_scores = ls
        else:
            inner.buffer.index_copy_(0, idx, rows)
            inner.participated[ns] = g["participated"].cpu().numpy()
            inner.sizes[ns] = self.sizes[nu]
            inner.kappas[ns] = self.kappas[nu]
            if self.hists is not None:
                if inner.hists is None:
                    inner.hists = np.zeros((self.C, self.hists.shape[1]))
                inner.hists[ns] = self.hists[nu]
            inner.has_hist[ns] = self.has_hist[nu]
        return res

    # -- the round -----------------------------------------------------------
    def round_stacked(self, d_new, active, **meta):
        """Slot-indexed round: ``d_new`` (C, N) (over client rows this
        rank's (C/R, N) block), ``active`` (C,) and the algorithm's
        metadata keywords, all in slot order. Runs the inner
        round unchanged, then copies the per-slot results back into the
        per-user tables."""
        out = self.inner.round_stacked(d_new, active, **meta)
        self._write_back()
        return out

    def _write_back(self) -> None:
        cohort = self.pool.slot_user
        vs = np.flatnonzero(cohort >= 0)
        if vs.size == 0:
            return
        cu = cohort[vs]
        inner = self.inner
        if self.is_osafl:
            # the whole (C,) flags: one gather a round over client rows
            part = row_cat(inner.participated, self.mesh)
            idx = torch.as_tensor(vs.astype(np.int64), device=self.device)
            self.tables.scatter(cu, {
                "participated": part.index_select(0, idx),
                "scores": np.asarray(inner.last_scores, np.float32)[vs],
                "lam_prev": inner._lam_prev.index_select(0, idx)})
        else:
            self.tables.scatter(cu, {
                "participated": np.asarray(inner.participated)[vs]})
            self.sizes[cu] = inner.sizes[vs]
            self.kappas[cu] = inner.kappas[vs]
            if inner.hists is not None:
                if self.hists is None:
                    self.hists = np.zeros((self.U, inner.hists.shape[1]))
                self.hists[cu] = inner.hists[vs]
            self.has_hist[cu] = inner.has_hist[vs]

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """The width-C inner server (the slot-resident state), the slot
        map and the per-user tables, under the reference's keys."""
        sd = {"inner": self.inner.state_dict(),
              "pool": self.pool.state_dict(),
              "tables": self.tables.state_dict()}
        if not self.is_osafl:
            sd["user_meta"] = {"sizes": self.sizes.copy(),
                               "kappas": self.kappas.copy(),
                               "hists": (None if self.hists is None
                                         else self.hists.copy()),
                               "has_hist": self.has_hist.copy()}
        return sd

    def load_state_dict(self, sd: dict) -> None:
        missing = sorted(k for k in ("inner", "pool", "tables")
                         if k not in sd)
        if missing:
            raise CheckpointError(
                "not a sparse-cohort snapshot (missing "
                + ", ".join(missing)
                + "); dense-engine snapshots cannot restore into a "
                "cohort_size>0 run")
        if self.K >= 1:
            if "pools" not in sd["pool"]:
                raise CheckpointError(
                    "snapshot slot pool is flat (no per-cluster pools); it "
                    "cannot restore into a num_clusters"
                    f"={self.K} hierarchical run")
        else:
            if "pools" in sd["pool"]:
                raise CheckpointError(
                    "snapshot slot pool is hierarchical (per-cluster "
                    "pools); it cannot restore into a flat "
                    "(num_clusters=0) run")
            validate_cohort_shapes(sd["pool"], self.U, self.C)
        self.pool.load_state_dict(sd["pool"])
        self.inner.load_state_dict(sd["inner"])
        self.tables.load_state_dict(sd["tables"])
        if not self.is_osafl:
            meta = sd["user_meta"]
            self.sizes = np.asarray(meta["sizes"], float).copy()
            self.kappas = np.asarray(meta["kappas"], float).copy()
            self.hists = (None if meta["hists"] is None
                          else np.asarray(meta["hists"], float).copy())
            self.has_hist = np.asarray(meta["has_hist"], bool).copy()
