"""Hierarchical edge-cluster aggregation (``repro/core/hierarchy.py``).

The registered population is split into K edge clusters (Zhou et al.,
"Towards Scalable Wireless Federated Learning", 2310.05076). Each cluster
runs the flat server's scored reduction on its own slots (its mean, the
eq. 19-21 scores through ``scored_reduce``, its scored partial aggregate)
and the server combines the K cluster aggregates with cluster-level
weights from the same eq. 19-21 machinery.

Layout: clusters are contiguous slot blocks. The width-C stacked buffer
splits into K blocks of B = C/K consecutive slots; cluster k owns slots
[k*B, (k+1)*B). On the dense path the user -> cluster map is the static
contiguous partition (``u // (U/K)``), so user rows already sit in their
cluster's block; on the sparse-cohort path ``ClusterSlotPool`` keeps K
per-cluster ``SlotPool``s so that a cluster's residents stay contiguous.
Each block is a contiguous row view of the buffer, which the kernel reads
in place: a round launches it K times for the blocks and once more for the
(K, N) aggregates when K > 1.

Anchors: ``num_clusters=1`` runs exactly the flat round's operations on
the whole buffer, and the combine takes its exact limit (one aggregate's
cosine with itself is 1, so the step is the aggregate), so K=1 is bit for
bit the flat round for all six algorithms. The per-cluster score carry
(``clam_prev``) is part of the server's ``state_dict``, so a K > 1 run
resumes bit for bit.

Membership can move (the ``cluster_churn`` scenario): a resident mover is
evicted from its old block and re-seated in the new one; its slot's
contribution row and FIFO dataset reset, its per-user carries follow it.
The per-cluster carry stays with the block (the edge server).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.run_state import CheckpointError
from repro_torch.configs.base import FLConfig
from repro_torch.core.baselines import STACKED_SERVERS
from repro_torch.core.cohort import AdmitResult, SlotPool, sample_participants
from repro_torch.core.osafl import (StackedOSAFLServer, make_scores_fn,
                                    write_back)
from repro_torch.device import owned_tensor


def contiguous_clusters(num_users: int, num_clusters: int) -> np.ndarray:
    """The static user -> cluster map: K equal contiguous ranges (K must
    divide U)."""
    U, K = int(num_users), int(num_clusters)
    if K < 1 or U % K:
        raise ValueError(
            f"num_clusters must be >= 1 and divide the population "
            f"(got K={K}, U={U})")
    return (np.arange(U, dtype=np.int32) // (U // K)).astype(np.int32)


def sample_participants_clustered(rng: np.random.Generator,
                                  assign: np.ndarray, num_clusters: int,
                                  m: int, block: int,
                                  weights: Optional[np.ndarray] = None,
                                  available: Optional[np.ndarray] = None
                                  ) -> np.ndarray:
    """Stratified round-active sampling over the live cluster map: each
    cluster draws ``ceil(m * n_k / U)`` of its members (capped by its
    ``block`` of slots and its eligible members) through
    ``sample_participants``, in cluster order. At K <= 1 this calls
    ``sample_participants`` with the same arguments, so it draws the host
    RNG exactly as the flat path does."""
    if num_clusters <= 1:
        return sample_participants(rng, int(assign.shape[0]), m,
                                   weights=weights, available=available)
    U = int(assign.shape[0])
    picked = []
    for k in range(int(num_clusters)):
        members = np.flatnonzero(assign == k)
        if members.size == 0:
            continue
        m_k = min(int(block), int(members.size),
                  int(np.ceil(m * members.size / U)))
        w_k = None if weights is None else np.asarray(weights)[members]
        a_k = None if available is None else np.asarray(available)[members]
        idx = sample_participants(rng, int(members.size), m_k,
                                  weights=w_k, available=a_k)
        picked.append(members[idx])
    if not picked:
        return np.empty(0, np.int64)
    return np.sort(np.concatenate(picked))


class ClusterSlotPool:
    """K per-cluster ``SlotPool``s behind the flat pool's interface.

    Cluster k owns the global slot block [k*B, (k+1)*B) with B = C/K;
    users route to the sub-pool of their current cluster (``assign``,
    shared with the owning ``SparseCohortServer`` and changed only by
    ``reassign``). At K=1 this is one ``SlotPool(U, C)``, slot for slot."""

    def __init__(self, num_users: int, capacity: int, assign: np.ndarray,
                 num_clusters: int):
        U, C, K = int(num_users), int(capacity), int(num_clusters)
        if K < 1 or C % K:
            raise ValueError(
                f"num_clusters must be >= 1 and divide cohort_size "
                f"(got K={K}, C={C})")
        assign = np.asarray(assign, np.int32)
        if assign.shape != (U,):
            raise ValueError(
                f"cluster map must have shape ({U},), got {assign.shape}")
        self.U, self.C, self.K = U, C, K
        self.B = C // K
        self.assign = assign                      # shared, changed in place
        self.pools = [SlotPool(U, self.B) for _ in range(K)]

    # -- flat-pool interface -------------------------------------------------
    @property
    def user_slot(self) -> np.ndarray:
        """(U,) user -> global slot (-1: not resident)."""
        us = np.full(self.U, -1, np.int32)
        for k, p in enumerate(self.pools):
            r = p.user_slot >= 0
            us[r] = p.user_slot[r] + k * self.B
        return us

    @property
    def slot_user(self) -> np.ndarray:
        """(C,) global slot -> user (-1: free)."""
        return np.concatenate([p.slot_user for p in self.pools])

    @property
    def cohort(self) -> np.ndarray:
        return self.slot_user

    @property
    def occupancy(self) -> int:
        return sum(p.occupancy for p in self.pools)

    def resident(self, users) -> np.ndarray:
        return self.user_slot[np.asarray(users, np.int64)] >= 0

    def admit(self, users) -> AdmitResult:
        """Route each user to its cluster's sub-pool; the slots come back as
        global indices in the input's order."""
        users = np.asarray(users, np.int64).ravel()
        if users.size and (users.min() < 0 or users.max() >= self.U):
            raise ValueError(
                f"user ids must be in [0, {self.U}); got range "
                f"[{users.min()}, {users.max()}]")
        slots = np.empty(users.size, np.int32)
        newly = np.zeros(users.size, bool)
        evicted = []
        ks = self.assign[users] if users.size else np.empty(0, np.int32)
        for k in range(self.K):
            pos = np.flatnonzero(ks == k)
            if pos.size == 0:
                continue
            res = self.pools[k].admit(users[pos])
            slots[pos] = res.slots + k * self.B
            newly[pos] = res.newly
            if res.evicted.size:
                evicted.append(res.evicted)
        return AdmitResult(
            slots=slots, newly=newly,
            evicted=(np.concatenate(evicted).astype(np.int32)
                     if evicted else np.empty(0, np.int32)))

    def evict(self, users) -> np.ndarray:
        """Free the users' slots in their current clusters' sub-pools
        (non-residents are ignored). Returns the freed global slots."""
        users = np.asarray(users, np.int64).ravel()
        freed = []
        for k in range(self.K):
            sub = users[self.assign[users] == k]
            f = self.pools[k].evict(sub)
            if f.size:
                freed.append(f + k * self.B)
        return (np.concatenate(freed).astype(np.int32) if freed
                else np.empty(0, np.int32))

    def reassign(self, users, dest) -> np.ndarray:
        """Move users to new clusters: evict the movers from their old
        blocks (while ``assign`` still routes there), then rewrite the map.
        Returns the movers that were resident, for the caller to re-seat."""
        users = np.asarray(users, np.int64).ravel()
        dest = np.asarray(dest, np.int64).ravel()
        if users.shape != dest.shape:
            raise ValueError("users and dest cluster ids must align")
        if dest.size and (dest.min() < 0 or dest.max() >= self.K):
            raise ValueError(
                f"destination clusters must be in [0, {self.K})")
        moving = dest != self.assign[users]
        users, dest = users[moving], dest[moving]
        was_res = self.resident(users)
        self.evict(users[was_res])
        self.assign[users] = dest.astype(np.int32)
        return users[was_res]

    def check(self) -> None:
        for k, p in enumerate(self.pools):
            p.check()
            res = np.flatnonzero(p.user_slot >= 0)
            stray = res[self.assign[res] != k]
            if stray.size:
                raise ValueError(
                    f"users {stray.tolist()} resident in cluster {k}'s "
                    f"block but assigned to clusters "
                    f"{self.assign[stray].tolist()}")

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        return {"assign": self.assign.copy(),
                "num_clusters": np.int64(self.K),
                "pools": [p.state_dict() for p in self.pools]}

    def load_state_dict(self, sd: dict) -> None:
        if int(sd.get("num_clusters", -1)) != self.K:
            raise CheckpointError(
                f"snapshot slot pool has num_clusters="
                f"{sd.get('num_clusters')!r}; the run expects K={self.K}")
        assign = np.asarray(sd["assign"], np.int32)
        if assign.shape != (self.U,):
            raise CheckpointError(
                f"snapshot cluster map has shape {assign.shape}; the run "
                f"registers U={self.U} users")
        pools = sd["pools"]
        if len(pools) != self.K:
            raise CheckpointError(
                f"snapshot holds {len(pools)} cluster pools; the run "
                f"expects {self.K}")
        self.assign[:] = assign
        for p, psd in zip(self.pools, pools):
            p.load_state_dict(psd)
        self.check()


def make_hier_round_body(fl: FLConfig, num_clusters: int):
    """The two-tier OSAFL round as one function

        rnd(w, buf, part_prev, lam_prev, clam_prev, d_new, active, alphas,
            key=None) -> (w, buf, part, lam_use, lam, clam_use, clam)

    Tier 1 (edge): the flat round's in-place write-back and refresh, then
    each cluster block ``buf[k*B:(k+1)*B]`` (a contiguous row view) is
    scored against its own mean, one ``scored_reduce`` launch per block,
    and forms its scored partial aggregate ``g_k = (alpha*lam)_k @ buf_k``.
    Tier 2 (server): the (K, N) aggregates are scored by the same
    machinery (one more launch) and combined, ``step = clam_use @ g``;
    ``clam_prev`` is the cluster-level stale-score carry. At K=1 the body
    runs exactly the flat round's operations on the whole buffer and the
    step is the single aggregate (its cosine with itself is 1)."""
    K = int(num_clusters)
    if K < 1:
        raise ValueError(f"num_clusters must be >= 1, got {K}")
    scores_of = make_scores_fn(fl)

    def rnd(w, buf, part_prev, lam_prev, clam_prev, d_new, active, alphas,
            key=None):
        part = write_back(fl, w, buf, part_prev, d_new, active)
        if K == 1:
            lam = scores_of(buf, key)
            lam_use = lam_prev if fl.stale_scores else lam
            clam = torch.ones(1, dtype=torch.float32, device=buf.device)
            clam_use = clam_prev if fl.stale_scores else clam
            step = (alphas * lam_use) @ buf
        else:
            B = buf.shape[0] // K
            blk = [slice(k * B, (k + 1) * B) for k in range(K)]
            lam = torch.cat([scores_of(buf[b], key) for b in blk])
            lam_use = lam_prev if fl.stale_scores else lam
            # each edge's scored partial aggregate, what it sends upstream
            g = torch.stack([(alphas[b] * lam_use[b]) @ buf[b] for b in blk])
            clam = scores_of(g, key)
            clam_use = clam_prev if fl.stale_scores else clam
            step = clam_use @ g
        w = w - fl.global_lr * fl.local_lr * step
        return w, buf, part, lam_use, lam, clam_use, clam

    return rnd


def _check_width(fl: FLConfig, width: int) -> int:
    K = int(fl.num_clusters)
    if K < 1 or width % K:
        raise ValueError(
            f"num_clusters must be >= 1 and divide the stacked width "
            f"(got K={K}, width={width})")
    return K


class HierStackedOSAFLServer(StackedOSAFLServer):
    """``StackedOSAFLServer`` with the two-tier round: the same state plus
    the (K,) cluster-level score carry ``clam_prev`` (in the snapshots) and
    the round's cluster scores in ``last_cluster_scores``. Rows are in
    cluster-block order (slot ``k*B + i`` belongs to cluster k)."""

    def __init__(self, params, fl: FLConfig, num_clients: int,
                 alphas=None, seed: int = 0, device=None):
        K = _check_width(fl, num_clients)
        super().__init__(params, fl, num_clients, alphas=alphas, seed=seed,
                         device=device)
        self.K = K
        self._clam_prev = torch.ones(K, dtype=torch.float32,
                                     device=self.w.device)
        self.last_cluster_scores = np.ones(K)
        self._round_fn = make_hier_round_body(fl, K)

    def round_stacked(self, d_new, active) -> torch.Tensor:
        active = torch.as_tensor(np.asarray(active, bool),
                                 device=self.w.device)
        (self.w, self.d_buffer, self.participated, lam_use, self._lam_prev,
         clam_use, self._clam_prev) = self._round_fn(
            self.w, self.d_buffer, self.participated, self._lam_prev,
            self._clam_prev, d_new, active, self.alphas, self._sketch_key)
        self.last_scores = lam_use.cpu().numpy()
        self.last_cluster_scores = clam_use.cpu().numpy()
        return self.w

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        sd = super().state_dict()
        sd["clam_prev"] = self._clam_prev
        return sd

    def load_state_dict(self, sd: dict) -> None:
        if sd.get("clam_prev") is None:
            raise CheckpointError(
                "snapshot has no cluster-score carry (clam_prev) — it was "
                "not written by a hierarchical (num_clusters>0) run")
        super().load_state_dict(sd)
        self._clam_prev = owned_tensor(sd["clam_prev"], self.w.device)
        self.last_cluster_scores = self._clam_prev.cpu().numpy()


def _hier_baseline(base):
    """Two-tier variant of a stacked baseline: the flat aggregation
    ``ws @ buffer`` becomes per-cluster partial aggregates summed at the
    server. Every weighting rule composes unchanged (the blocked sum is the
    same linear combination, re-associated); at K=1 it is the flat
    product itself."""

    class Hier(base):
        def __init__(self, params, fl: FLConfig, num_clients: int,
                     seed: int = 0, device=None):
            K = _check_width(fl, num_clients)
            super().__init__(params, fl, num_clients, seed=seed,
                             device=device)
            self.K = K

        def cluster_aggregates(self, ws) -> torch.Tensor:
            """(K, N) per-cluster partial aggregates under weights ``ws``,
            what the edge tier would send to the server."""
            B = self.buffer.shape[0] // self.K
            w32 = torch.as_tensor(np.asarray(ws), dtype=torch.float32,
                                  device=self.buffer.device)
            return torch.stack([
                w32[k * B:(k + 1) * B] @ self.buffer[k * B:(k + 1) * B]
                for k in range(self.K)])

        def _weighted(self, ws) -> torch.Tensor:
            if self.K == 1:
                return super()._weighted(ws)
            return torch.sum(self.cluster_aggregates(ws), dim=0)

    Hier.__name__ = "Hier" + base.__name__
    Hier.__qualname__ = Hier.__name__
    return Hier


HIER_SERVERS = {alg: _hier_baseline(cls)
                for alg, cls in STACKED_SERVERS.items()}


def make_hier_server(params, fl: FLConfig, num_clients: int, seed: int = 0,
                     device=None):
    """The two-tier counterpart of ``baselines.make_server``'s stacked
    branch; ``num_clients`` is the stacked width (U dense, C as the
    sparse cohort's inner server)."""
    if fl.algorithm == "osafl":
        return HierStackedOSAFLServer(params, fl, num_clients, seed=seed,
                                      device=device)
    if fl.algorithm in HIER_SERVERS:
        return HIER_SERVERS[fl.algorithm](params, fl, num_clients,
                                          seed=seed, device=device)
    raise ValueError(f"unknown algorithm {fl.algorithm!r}")
