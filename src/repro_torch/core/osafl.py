"""OSAFL server (paper Algorithm 2), two ways: ``OSAFLServer`` keeps each
client's contribution as a parameter tree and loops over clients (the
paper-faithful oracle); ``StackedOSAFLServer`` keeps it as one row of a
(U, N) float32 buffer.

Participating clients overwrite their slot; slots of clients that never
took part are refreshed (to zero, or to w^t/eta under Algorithm 2's literal
init). Scores lambda_u = (chi + cos(d_u, mean)) / (chi + 1) (eqs. 19-21)
are computed on the buffer, and the global model takes the scored SGD step
(eq. 17): w <- w - eta~ * eta * sum_u alpha_u lambda_u d[u].
``repro/core/osafl.py`` is the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.flatten import (FlatCodec, make_codec, scatter_updates,
                                      tree_map)
from repro_torch.core.scores import (lambda_scores, tree_add, tree_scale,
                                     tree_sub, tree_zeros_like)
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import scored_reduce_reference
from repro_torch.kernels.scored_reduce import scored_reduce


def _refuse_sketches(fl: FLConfig) -> None:
    if fl.score_sketch_dim:
        raise NotImplementedError(
            "score_sketch_dim > 0 is not ported to repro_torch yet (ROADMAP "
            "A6): the reference draws its sketch signs from jax's threefry")


def make_stacked_round_body(fl: FLConfig):
    """The stacked OSAFL round as one function

        rnd(w, buf, part_prev, lam_prev, d_new, active, alphas)
            -> (w, buf, part, lam_use, lam)

    ``buf`` is updated in place and returned: at U=256 clients of the FCN it
    is 3.9 GB, and rewriting only the rows that change saves a second copy
    and its traffic. Scores go through the CUDA kernel (``score_backend=
    "kernel"``, which takes its plain version for CPU tensors) or the
    plain-torch oracle (``"reference"``); the mean and the final weighted sum
    are plain torch ops, as the reference leaves them outside its kernel."""
    _refuse_sketches(fl)
    if fl.score_backend == "kernel":
        reduce = scored_reduce
    elif fl.score_backend == "reference":
        reduce = scored_reduce_reference
    else:
        raise ValueError(f"unknown score_backend {fl.score_backend!r} "
                         "(expected 'kernel' or 'reference')")

    def rnd(w, buf, part_prev, lam_prev, d_new, active, alphas):
        part = part_prev | active
        rows = torch.nonzero(active).squeeze(1)
        buf.index_copy_(0, rows, d_new.index_select(0, rows))
        # Algorithm 2 line 17: refresh never-participated slots
        stale = torch.nonzero(~part).squeeze(1)
        if fl.literal_init_buffer:
            refresh = (w / fl.local_lr)[None, :].expand(stale.numel(), -1)
            buf.index_copy_(0, stale, refresh)
        else:
            buf.index_fill_(0, stale, 0.0)
        mean = torch.mean(buf, dim=0)
        dots, norms, msq = reduce(buf, mean)
        cos = dots / torch.clamp(torch.sqrt(norms) * torch.sqrt(msq),
                                 min=1e-12)
        lam = (fl.chi + cos) / (fl.chi + 1.0)
        # stale_scores: weight THIS round's buffer with the PREVIOUS
        # round's scores
        lam_use = lam_prev if fl.stale_scores else lam
        step = (alphas * lam_use) @ buf
        w = w - fl.global_lr * fl.local_lr * step
        return w, buf, part, lam_use, lam

    return rnd


@dataclass
class ClientUpdate:
    uid: int
    d: object                        # normalized accumulated gradient tree
    kappa: int
    data_size: int = 0
    label_hist: Optional[np.ndarray] = None   # only consumed by M-FedDisco


class OSAFLServer:
    """Paper-faithful per-client Algorithm 2 on parameter trees. It is the
    independent implementation the stacked server and its kernel are held
    against, so it scores with ``scores.lambda_scores`` and never with
    ``scored_reduce``. Every slot starts as one shared tree, so nothing here
    writes in place."""

    def __init__(self, params, fl: FLConfig, num_clients: int,
                 alphas: Optional[np.ndarray] = None, device=None):
        _refuse_sketches(fl)
        dev = resolve_device(device)
        self.params = tree_map(lambda x: x.to(dev), params)
        self.fl = fl
        self.U = num_clients
        self.alphas = (np.full(num_clients, 1.0 / num_clients)
                       if alphas is None else alphas)
        self.d_buffer: List = [self._refresh()] * num_clients
        self.participated = np.zeros(num_clients, bool)
        self.last_scores = np.ones(num_clients)

    def _refresh(self):
        """Algorithm 2 lines 1 and 17: the slot of a client that never took
        part holds w/eta under the literal init, zeros otherwise."""
        if self.fl.literal_init_buffer:
            return tree_scale(self.params, 1.0 / self.fl.local_lr)
        return tree_zeros_like(self.params)

    def round(self, updates: Sequence[ClientUpdate]) -> dict:
        fl = self.fl
        for up in updates:
            self.d_buffer[up.uid] = up.d
            self.participated[up.uid] = True
        refresh = self._refresh()
        for u in np.flatnonzero(~self.participated):
            self.d_buffer[u] = refresh
        lam = lambda_scores(self.d_buffer, fl.chi)
        if fl.stale_scores:
            # weight THIS round's updates with the PREVIOUS round's scores
            # (lam becomes next round's)
            lam, self._lam_next = getattr(self, "_lam_next",
                                          np.ones(self.U)), lam
        self.last_scores = lam
        step = tree_zeros_like(self.params)
        for u in range(self.U):
            w = float(self.alphas[u] * lam[u])
            step = tree_add(step, tree_scale(self.d_buffer[u], w))
        lr = fl.global_lr * fl.local_lr
        self.params = tree_sub(self.params, tree_scale(step, lr))
        return self.params


class StackedOSAFLServer:
    """Algorithm 2 on a (U, N) contribution buffer. ``round_stacked(d_new,
    active)`` takes a dense (U, N) update matrix (from
    ``client.make_vmapped_local_train``) and a participation mask;
    ``round(updates)`` takes the loop server's list of ``ClientUpdate``s."""

    def __init__(self, params, fl: FLConfig, num_clients: int,
                 alphas: Optional[np.ndarray] = None, device=None):
        dev = resolve_device(device)
        self.fl = fl
        self.U = num_clients
        self.codec: FlatCodec = make_codec(params)
        self.alphas = torch.as_tensor(
            np.full(num_clients, 1.0 / num_clients) if alphas is None
            else alphas, dtype=torch.float32, device=dev)
        self.w = self.codec.flatten(params).to(dev)
        self.d_buffer = self.init_row()[None, :].repeat(num_clients, 1)
        self.participated = torch.zeros(num_clients, dtype=torch.bool,
                                        device=dev)
        self.last_scores = np.ones(num_clients)
        self._lam_prev = torch.ones(num_clients, dtype=torch.float32,
                                    device=dev)
        self._round_fn = make_stacked_round_body(fl)

    @property
    def params(self) -> dict:
        return self.codec.unflatten(self.w)

    def init_row(self) -> torch.Tensor:
        """The (N,) value of a slot holding no live contribution: w/eta
        under the literal init, zeros otherwise."""
        return (self.w / self.fl.local_lr if self.fl.literal_init_buffer
                else torch.zeros_like(self.w))

    def round_stacked(self, d_new: torch.Tensor, active) -> torch.Tensor:
        """d_new: (U, N) f32 update matrix; active: (U,) bool mask. Returns
        the new flat global weights (``.params`` gives the tree view)."""
        active = torch.as_tensor(np.asarray(active, bool),
                                 device=self.w.device)
        (self.w, self.d_buffer, self.participated, lam_use,
         self._lam_prev) = self._round_fn(
            self.w, self.d_buffer, self.participated, self._lam_prev,
            d_new, active, self.alphas)
        self.last_scores = lam_use.cpu().numpy()
        return self.w

    def round(self, updates: Sequence[ClientUpdate]) -> dict:
        d_new, active = scatter_updates(self.codec, updates, self.U,
                                        device=self.w.device)
        self.round_stacked(d_new, active)
        return self.params
