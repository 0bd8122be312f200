"""The five baseline servers (paper Algorithms 6-10) and server
construction (``repro/core/baselines.py``).

  M-FedAvg   (Alg. 6):  w^{t+1} = (1/U) sum_u w[u]
  M-FedProx  (Alg. 7):  FedAvg aggregation; the proximal term is the
                         clients' (core/client.py)
  M-FedNova  (Alg. 8):  w^{t+1} = w^t - eta * tau~ * (sum_u p_u k_u) *
                                   sum_u (p_u k_u / sum p k) d[u]
  M-AFA-CD   (Alg. 9):  w^{t+1} = w^t - eta_g * (1/U) sum_u d[u]
  M-FedDisco (Alg. 10): w^{t+1} = sum_u alpha_u w[u],
                         alpha_u = ReLU(p_u - a*disco_u + b) / sum(...)

Two forms of each, as in the reference. The loop servers (``SERVERS``)
keep one parameter tree per client and a list of the last ``ClientUpdate``
each client sent; nothing in them writes in place, since every slot starts
as one shared tree. The stacked servers (``STACKED_SERVERS``) keep one
(U, N) float32 buffer on the device, plus the sticky per-client metadata
(data sizes, kappas, label histograms) in float64 numpy arrays on the
host: a client's last reported value sticks while it sits a round out.
Both compute the aggregation weights on the host in float64, as the
reference does; a stacked round aggregates with one (U,) @ (U, N)
product (their two-tier forms, ``core/hierarchy.py``, one per cluster
block). Their ``state_dict``s are the reference's, key for key.
``make_server`` also builds the sparse-cohort server (``core/cohort.py``).

Over a mesh of R > 1 client rows (``mesh=``, one process per row) a
stacked server's buffer holds this rank's rows; the host metadata stays
whole (U,) on every rank, fed from the buffer's gathered sizes and
histograms, so FedNova's and FedDisco's weights are computed whole and
sliced. The aggregation is each rank's product over its rows, summed
across ranks in rank order (``core/shmap.row_sum``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.run_state import own_rows, row_leaf
from repro_torch.configs.base import FLConfig
from repro_torch.core.flatten import (FlatCodec, make_codec, scatter_updates,
                                      tree_map)
from repro_torch.core.osafl import (ClientUpdate, OSAFLServer,
                                    StackedOSAFLServer, _tree_to)
from repro_torch.core.scores import (tree_add, tree_scale, tree_sub,
                                     tree_zeros_like)
from repro_torch.core.shmap import client_sharding, row_sum
from repro_torch.device import owned_tensor, resolve_device


class _BufferedServer:
    """Per-client contribution trees plus the staleness rules: a client
    that never took part holds the global weights (weight-averaging
    servers, an averaging no-op) or the refresh of a gradient buffer (w/eta
    under the literal init, zeros otherwise)."""

    buffers_hold_weights = True      # False => buffers hold normalized grads d

    def __init__(self, params, fl: FLConfig, num_clients: int,
                 seed: int = 0, device=None):
        dev = self.device = resolve_device(device)
        self.params = tree_map(lambda x: x.to(dev), params)
        self.fl = fl
        self.U = num_clients
        self.participated = np.zeros(num_clients, bool)
        self.buffer: List = [self._refresh()] * num_clients
        self.meta: List[Optional[ClientUpdate]] = [None] * num_clients

    def _refresh(self):
        if self.buffers_hold_weights:
            return self.params
        if self.fl.literal_init_buffer:
            return tree_scale(self.params, 1.0 / self.fl.local_lr)
        return tree_zeros_like(self.params)

    def _ingest(self, updates: Sequence[ClientUpdate]):
        for up in updates:
            self.buffer[up.uid] = up.d
            self.participated[up.uid] = True
            self.meta[up.uid] = up
        refresh = self._refresh()
        for u in np.flatnonzero(~self.participated):
            self.buffer[u] = refresh

    def _mean(self, items, ws):
        out = tree_zeros_like(self.params)
        for it, w in zip(items, ws):
            out = tree_add(out, tree_scale(it, float(w)))
        return out

    def _sizes(self) -> np.ndarray:
        return np.array([m.data_size if m else 1 for m in self.meta], float)

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """Params, contribution trees, participation flags and the sticky
        per-client metadata; only the scalar fields of ``meta`` are kept
        (its buffered tree is never read back)."""
        meta = [None if m is None else
                {"uid": int(m.uid), "kappa": int(m.kappa),
                 "data_size": int(m.data_size), "label_hist": m.label_hist}
                for m in self.meta]
        return {"params": self.params, "buffer": list(self.buffer),
                "participated": self.participated, "meta": meta}

    def load_state_dict(self, sd: dict) -> None:
        self.params = _tree_to(sd["params"], self.device)
        self.buffer = [_tree_to(b, self.device) for b in sd["buffer"]]
        self.participated = np.asarray(sd["participated"], bool).copy()
        self.meta = [None if m is None else ClientUpdate(
            uid=int(m["uid"]), d=None, kappa=int(m["kappa"]),
            data_size=int(m["data_size"]),
            label_hist=(None if m["label_hist"] is None
                        else np.asarray(m["label_hist"])))
            for m in sd["meta"]]


class FedAvgServer(_BufferedServer):
    def round(self, updates: Sequence[ClientUpdate]):
        self._ingest(updates)
        self.params = self._mean(self.buffer, np.full(self.U, 1.0 / self.U))
        return self.params


class FedProxServer(FedAvgServer):
    """Aggregation identical to FedAvg; clients add the proximal term."""


class FedNovaServer(_BufferedServer):
    buffers_hold_weights = False

    def round(self, updates: Sequence[ClientUpdate]):
        self._ingest(updates)
        sizes = self._sizes()
        p = sizes / sizes.sum()
        kap = np.array([m.kappa if m else 1 for m in self.meta], float)
        pk = p * kap
        tau_eff = self.fl.fednova_slowdown * pk.sum()
        w = self.fl.local_lr * tau_eff * pk / pk.sum()
        self.params = tree_sub(self.params, self._mean(self.buffer, w))
        return self.params


class AFACDServer(_BufferedServer):
    buffers_hold_weights = False

    def round(self, updates: Sequence[ClientUpdate]):
        self._ingest(updates)
        w = np.full(self.U, self.fl.global_lr * self.fl.local_lr / self.U)
        self.params = tree_sub(self.params, self._mean(self.buffer, w))
        return self.params


class FedDiscoServer(_BufferedServer):
    def round(self, updates: Sequence[ClientUpdate]):
        self._ingest(updates)
        sizes = self._sizes()
        p = sizes / sizes.sum()
        disco = np.zeros(self.U)
        for u, m in enumerate(self.meta):
            h = m.label_hist if m is not None else None
            if h is not None:
                uniform = np.full_like(h, 1.0 / len(h))
                disco[u] = float(np.linalg.norm(h - uniform))
        a, b = self.fl.feddisco_a, self.fl.feddisco_b
        alpha = np.maximum(p - a * disco + b, 0.0)
        alpha = alpha / max(alpha.sum(), 1e-12)
        self.params = self._mean(self.buffer, alpha)
        return self.params


class _StackedBufferedServer:
    """One (U, N) f32 buffer plus the sticky per-client metadata arrays.
    ``round_stacked(d_new, active)`` writes the active rows back, refreshes
    the rows of clients that never took part (``init_row``) and sets the
    new flat weights ``w`` (``_aggregate``); ``round(updates)`` does the
    same from the loop servers' list of ``ClientUpdate``s."""

    buffers_hold_weights = True      # False => buffers hold normalized grads d

    def __init__(self, params, fl: FLConfig, num_clients: int,
                 seed: int = 0, device=None, mesh=None):
        dev = resolve_device(device)
        self.fl = fl
        self.U = num_clients
        self.mesh = mesh
        self.rows = (0, num_clients) if mesh is None else \
            client_sharding(mesh).bounds(num_clients)
        self.codec: FlatCodec = make_codec(params)
        self.w = self.codec.flatten(params).to(dev)
        self.participated = np.zeros(num_clients, bool)
        self.buffer = self.init_row()[None, :].repeat(
            self.rows[1] - self.rows[0], 1)
        self.sizes = np.ones(num_clients)        # loop default: size 1
        self.kappas = np.ones(num_clients)
        self.hists = None                        # lazily sized (U, C)
        self.has_hist = np.zeros(num_clients, bool)

    @property
    def params(self) -> dict:
        return self.codec.unflatten(self.w)

    def init_row(self) -> torch.Tensor:
        """The (N,) value of a slot with no live contribution: the current
        global weights for weight-averaging servers (an averaging no-op),
        w/eta under the literal init or zeros for gradient buffers."""
        if self.buffers_hold_weights:
            return self.w
        return (self.w / self.fl.local_lr if self.fl.literal_init_buffer
                else torch.zeros_like(self.w))

    def _ingest(self, updates: Sequence[ClientUpdate]) -> None:
        """Scatter the updates into the buffer and merge their metadata:
        the last update a client sent sticks (loop ``meta`` semantics)."""
        d_new, active = scatter_updates(self.codec, updates, self.U,
                                        device=self.w.device)
        for up in updates:
            self.sizes[up.uid] = up.data_size
            self.kappas[up.uid] = up.kappa
            if up.label_hist is not None:
                if self.hists is None:
                    self.hists = np.zeros((self.U, len(up.label_hist)))
                self.hists[up.uid] = up.label_hist
                self.has_hist[up.uid] = True
        self._ingest_stacked(d_new[self.rows[0]:self.rows[1]], active)

    def round(self, updates: Sequence[ClientUpdate]) -> dict:
        self._ingest(updates)
        self._aggregate()
        return self.params

    def round_stacked(self, d_new: torch.Tensor, active) -> torch.Tensor:
        self._ingest_stacked(d_new, active)
        self._aggregate()
        return self.w

    def _ingest_stacked(self, d_new: torch.Tensor, active) -> None:
        """Write back the active rows and refresh the never-participated
        ones, in place: at U=256 clients of the FCN the buffer is 3.9 GB.
        ``d_new`` holds the buffer's rows, ``active`` the whole cohort."""
        active = np.asarray(active, bool)
        self.participated |= active
        lo, hi = self.rows
        dev = self.buffer.device
        rows = torch.as_tensor(np.flatnonzero(active[lo:hi]), device=dev)
        self.buffer.index_copy_(0, rows, d_new.index_select(0, rows))
        stale = torch.as_tensor(np.flatnonzero(~self.participated[lo:hi]),
                                device=dev)
        self.buffer.index_copy_(
            0, stale, self.init_row()[None, :].expand(stale.numel(), -1))

    def _weighted(self, ws) -> torch.Tensor:
        """``ws @ buffer`` for whole-cohort (U,) weights ``ws``: this
        rank's rows' product, summed over the client rows."""
        lo, hi = self.rows
        return row_sum(torch.as_tensor(
            np.asarray(ws)[lo:hi], dtype=torch.float32,
            device=self.buffer.device) @ self.buffer, self.mesh)

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """The flat weights, the (U, N) buffer, participation flags and the
        sticky metadata arrays. The leaves are live: the round writes the
        buffer and the metadata in place, so a writer copies them."""
        return {"w": self.w,
                "buffer": row_leaf(self.buffer, self.rows[0], self.U),
                "participated": self.participated,
                "sizes": self.sizes, "kappas": self.kappas,
                "hists": self.hists, "has_hist": self.has_hist}

    def load_state_dict(self, sd: dict) -> None:
        dev = self.w.device
        self.w = owned_tensor(sd["w"], dev)
        self.buffer = owned_tensor(own_rows(sd["buffer"], *self.rows,
                                            self.U), dev)
        self.participated = np.array(sd["participated"], bool)
        self.sizes = np.array(sd["sizes"], float)
        self.kappas = np.array(sd["kappas"], float)
        self.hists = (None if sd["hists"] is None
                      else np.array(sd["hists"], float))
        self.has_hist = np.array(sd["has_hist"], bool)


class StackedFedAvgServer(_StackedBufferedServer):
    def _aggregate(self) -> None:
        self.w = self._weighted(np.full(self.U, 1.0 / self.U))


class StackedFedProxServer(StackedFedAvgServer):
    """Aggregation identical to FedAvg; clients add the proximal term."""


class StackedFedNovaServer(_StackedBufferedServer):
    buffers_hold_weights = False

    def _nova_weights(self) -> np.ndarray:
        p = self.sizes / self.sizes.sum()
        pk = p * self.kappas
        tau_eff = self.fl.fednova_slowdown * pk.sum()
        return self.fl.local_lr * tau_eff * pk / pk.sum()

    def round_stacked(self, d_new, active, sizes=None, kappas=None):
        # metadata merges for ACTIVE clients only: inactive slots keep their
        # last-seen values (the loop engine's meta semantics)
        act = np.asarray(active, bool)
        if sizes is not None:
            self.sizes = np.where(act, np.asarray(sizes, float), self.sizes)
        if kappas is not None:
            self.kappas = np.where(act, np.asarray(kappas, float),
                                   self.kappas)
        self._ingest_stacked(d_new, active)
        self._aggregate()
        return self.w

    def _aggregate(self) -> None:
        self.w = self.w - self._weighted(self._nova_weights())


class StackedAFACDServer(_StackedBufferedServer):
    buffers_hold_weights = False

    def _aggregate(self) -> None:
        lr = self.fl.global_lr * self.fl.local_lr
        self.w = self.w - self._weighted(np.full(self.U, lr / self.U))


class StackedFedDiscoServer(_StackedBufferedServer):
    def _disco_weights(self) -> np.ndarray:
        p = self.sizes / self.sizes.sum()
        disco = np.zeros(self.U)
        if self.hists is not None:
            h = self.hists
            uniform = np.full_like(h, 1.0 / h.shape[1])
            disco = np.where(self.has_hist,
                             np.linalg.norm(h - uniform, axis=1), 0.0)
        alpha = np.maximum(p - self.fl.feddisco_a * disco
                           + self.fl.feddisco_b, 0.0)
        return alpha / max(alpha.sum(), 1e-12)

    def round_stacked(self, d_new, active, sizes=None, hists=None):
        act = np.asarray(active, bool)
        if sizes is not None:
            self.sizes = np.where(act, np.asarray(sizes, float), self.sizes)
        if hists is not None:
            hists = np.asarray(hists, float)
            if self.hists is None:
                self.hists = np.zeros_like(hists)
            self.hists = np.where(act[:, None], hists, self.hists)
            self.has_hist |= act
        self._ingest_stacked(d_new, active)
        self._aggregate()
        return self.w

    def _aggregate(self) -> None:
        self.w = self._weighted(self._disco_weights())


STACKED_SERVERS = {
    "fedavg": StackedFedAvgServer,
    "fedprox": StackedFedProxServer,
    "fednova": StackedFedNovaServer,
    "afa_cd": StackedAFACDServer,
    "feddisco": StackedFedDiscoServer,
}

SERVERS = {
    "fedavg": FedAvgServer,
    "fedprox": FedProxServer,
    "fednova": FedNovaServer,
    "afa_cd": AFACDServer,
    "feddisco": FedDiscoServer,
}


def make_server(params, fl: FLConfig, num_clients: int, seed: int = 0,
                device=None, mesh=None):
    """The server of ``fl.algorithm`` on ``fl.engine``, as the reference's
    ``make_server`` picks it (without a mesh): with ``cohort_size > 0`` the
    sparse-cohort server (``core/cohort.py``, stacked engine only); on
    ``"stacked"`` the two-tier servers of ``core/hierarchy.py`` when
    ``num_clusters >= 1``, else ``StackedOSAFLServer`` or one of
    ``STACKED_SERVERS``; on ``"loop"``, ``OSAFLServer`` or one of
    ``SERVERS``. Any other engine raises: the pod harness's servers are
    the stacked ones (its ``FLConfig`` says ``engine="stacked"``), and the
    reference's ``make_server`` hands an ``engine="pod"`` config the loop
    servers, which no harness asks for. ``mesh`` lays a stacked server's
    buffer over its client rows: the flat and the two-tier servers' (U, N)
    buffer, and the sparse-cohort server's width-C inner server and
    per-user tables."""
    if fl.engine not in ("stacked", "loop"):
        raise NotImplementedError(
            f"not ported to repro_torch yet: engine={fl.engine!r} (ported: "
            "the stacked and loop servers)")
    if fl.cohort_size:
        from repro_torch.core.cohort import SparseCohortServer
        if fl.engine != "stacked":
            raise ValueError(
                "cohort_size>0 needs the stacked engine (the loop servers "
                f"are dense per-user oracles; got engine={fl.engine!r})")
        return SparseCohortServer(params, fl, num_clients, seed=seed,
                                  device=device, mesh=mesh)
    if fl.engine == "stacked":
        if fl.num_clusters >= 1:
            from repro_torch.core.hierarchy import make_hier_server
            return make_hier_server(params, fl, num_clients, seed=seed,
                                    device=device, mesh=mesh)
        servers = {"osafl": StackedOSAFLServer, **STACKED_SERVERS}
    else:
        if fl.num_clusters >= 1:
            raise ValueError(
                "num_clusters>=1 needs the stacked engine (the loop servers "
                f"are flat per-user oracles; got engine={fl.engine!r})")
        servers = {"osafl": OSAFLServer, **SERVERS}
    if mesh is not None and fl.engine == "stacked":
        return servers[fl.algorithm](params, fl, num_clients, seed=seed,
                                     device=device, mesh=mesh)
    return servers[fl.algorithm](params, fl, num_clients, seed=seed,
                                 device=device)
