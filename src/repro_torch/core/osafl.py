"""OSAFL server (paper Algorithm 2), stacked: every client's contribution is
one row of a (U, N) float32 buffer.

Participating clients overwrite their row; rows of clients that never took
part are refreshed (to zero, or to w^t/eta under Algorithm 2's literal
init). Scores lambda_u = (chi + cos(d_u, mean)) / (chi + 1) (eqs. 19-21)
are computed on the buffer, and the global model takes the scored SGD step
(eq. 17): w <- w - eta~ * eta * sum_u alpha_u lambda_u d[u].
``repro/core/osafl.py`` is the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.flatten import FlatCodec, make_codec
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import scored_reduce_reference
from repro_torch.kernels.scored_reduce import scored_reduce


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
    if fl.score_sketch_dim:
        raise NotImplementedError(
            "score_sketch_dim > 0 is not ported to repro_torch yet: the "
            "reference draws its sketch signs from jax's threefry")
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


class StackedOSAFLServer:
    """Algorithm 2 on a (U, N) contribution buffer. ``round_stacked(d_new,
    active)`` takes a dense (U, N) update matrix (from
    ``client.make_vmapped_local_train``) and a participation mask."""

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
