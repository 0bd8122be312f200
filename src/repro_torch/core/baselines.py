"""The five baseline servers on the (U, N) stacked buffer, and server
construction (``repro/core/baselines.py``: ``_StackedBufferedServer`` and
its subclasses, ``STACKED_SERVERS`` and ``make_server``).

Each server keeps one (U, N) float32 buffer on the device, plus sticky
per-client metadata (data sizes, kappas, label histograms) in float64
numpy arrays on the host: a client's last reported value sticks while it
sits a round out. The aggregation weights are computed on the host in
float64, as the reference computes them, and each round aggregates with
one (U,) @ (U, N) product. The list-of-``ClientUpdate`` ``round()``, the
loop servers, ``state_dict`` and the sparse cohort and cluster tiers are
not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.flatten import FlatCodec, make_codec
from repro_torch.core.osafl import StackedOSAFLServer
from repro_torch.device import resolve_device


class _StackedBufferedServer:
    """One (U, N) f32 buffer plus the sticky per-client metadata arrays.
    ``round_stacked(d_new, active)`` writes the active rows back, refreshes
    the rows of clients that never took part (``init_row``) and sets the
    new flat weights ``w``."""

    buffers_hold_weights = True      # False => buffers hold normalized grads d

    def __init__(self, params, fl: FLConfig, num_clients: int, device=None):
        dev = resolve_device(device)
        self.fl = fl
        self.U = num_clients
        self.codec: FlatCodec = make_codec(params)
        self.w = self.codec.flatten(params).to(dev)
        self.participated = np.zeros(num_clients, bool)
        self.buffer = self.init_row()[None, :].repeat(num_clients, 1)
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

    def _ingest_stacked(self, d_new: torch.Tensor, active) -> None:
        """Write back the active rows and refresh the never-participated
        ones, in place: at U=256 clients of the FCN the buffer is 3.9 GB."""
        active = np.asarray(active, bool)
        self.participated |= active
        dev = self.buffer.device
        rows = torch.as_tensor(np.flatnonzero(active), device=dev)
        self.buffer.index_copy_(0, rows, d_new.index_select(0, rows))
        stale = torch.as_tensor(np.flatnonzero(~self.participated),
                                device=dev)
        self.buffer.index_copy_(
            0, stale, self.init_row()[None, :].expand(stale.numel(), -1))

    def _weighted(self, ws) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ws), dtype=torch.float32,
                               device=self.buffer.device) @ self.buffer


class StackedFedAvgServer(_StackedBufferedServer):
    def round_stacked(self, d_new: torch.Tensor, active) -> torch.Tensor:
        self._ingest_stacked(d_new, active)
        self.w = self._weighted(np.full(self.U, 1.0 / self.U))
        return self.w


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
        self.w = self.w - self._weighted(self._nova_weights())
        return self.w


class StackedAFACDServer(_StackedBufferedServer):
    buffers_hold_weights = False

    def round_stacked(self, d_new, active) -> torch.Tensor:
        self._ingest_stacked(d_new, active)
        lr = self.fl.global_lr * self.fl.local_lr
        self.w = self.w - self._weighted(np.full(self.U, lr / self.U))
        return self.w


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
        self.w = self._weighted(self._disco_weights())
        return self.w


STACKED_SERVERS = {
    "fedavg": StackedFedAvgServer,
    "fedprox": StackedFedProxServer,
    "fednova": StackedFedNovaServer,
    "afa_cd": StackedAFACDServer,
    "feddisco": StackedFedDiscoServer,
}


def make_server(params, fl: FLConfig, num_clients: int, device=None):
    """The dense stacked server of ``fl.algorithm``: ``StackedOSAFLServer``
    or one of ``STACKED_SERVERS``. The loop servers, the sparse cohort pool
    and the cluster tier raise until they are ported."""
    missing = []
    if fl.engine != "stacked":
        missing.append(f"engine={fl.engine!r}")
    if fl.cohort_size:
        missing.append(f"cohort_size={fl.cohort_size}")
    if fl.num_clusters >= 1:
        missing.append(f"num_clusters={fl.num_clusters}")
    if missing:
        raise NotImplementedError(
            "not ported to repro_torch yet: " + ", ".join(missing)
            + " (ported: the dense stacked servers)")
    if fl.algorithm == "osafl":
        return StackedOSAFLServer(params, fl, num_clients, device=device)
    return STACKED_SERVERS[fl.algorithm](params, fl, num_clients,
                                         device=device)
