"""OSAFL server (paper Algorithm 2), two ways: ``OSAFLServer`` keeps each
client's contribution as a parameter tree and loops over clients (the
paper-faithful oracle); ``StackedOSAFLServer`` keeps it as one row of a
(U, N) float32 buffer.

Participating clients overwrite their slot; slots of clients that never
took part are refreshed (to zero, or to w^t/eta under Algorithm 2's literal
init). Scores lambda_u = (chi + cos(d_u, mean)) / (chi + 1) (eqs. 19-21)
are computed on the buffer, and the global model takes the scored SGD step
(eq. 17): w <- w - eta~ * eta * sum_u alpha_u lambda_u d[u]. With
``score_sketch_dim > 0`` the scores are computed on k-dim count-sketches
of the contributions, whose signs come from the server's ``sketch_key``
(``seed_key``, ``scores.sketch_signs_int8``).
``repro/core/osafl.py`` is the reference. Both servers' ``state_dict``s
are the reference's, key for key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.flatten import (FlatCodec, make_codec, scatter_updates,
                                      tree_map)
from repro_torch.core.scores import (lambda_scores, lambda_scores_sketched,
                                     sketch_stacked, sketch_tree, tree_add,
                                     tree_scale, tree_sub, tree_zeros_like)
from repro_torch.device import owned_tensor, resolve_device
from repro_torch.kernels.ref import scored_reduce_reference
from repro_torch.kernels.scored_reduce import scored_reduce


def seed_key(seed: int) -> np.ndarray:
    """The (2,) uint32 words of ``seed``, high word first: what the
    reference's servers hold as ``sketch_key`` (its default ``PRNGKey(seed)``
    for a seed below 2**32). The sketched scores draw their signs from it
    (``scores.sketch_signs_int8``); it never advances, so every round flips the
    same signs, and a snapshot that restores it continues them."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], np.uint32)


def _tree_to(tree, dev):
    return tree_map(lambda a: owned_tensor(a, dev), tree)


def _check_sketch_dim(fl: FLConfig) -> None:
    if fl.score_sketch_dim < 0:
        raise ValueError(f"score_sketch_dim must be >= 0 (0 = exact "
                         f"scores), got {fl.score_sketch_dim}")


def make_scores_fn(fl: FLConfig):
    """``scores_of(rows, key)``: the eq. 19-21 lambda scores of a (n, N)
    row block against its own mean, the stacked round's scoring. Exact
    scores reduce through the CUDA kernel (``score_backend="kernel"``,
    which takes its plain version for CPU tensors) or the plain-torch
    oracle (``"reference"``); with ``score_sketch_dim > 0`` the rows are
    count-sketched first under ``key`` and nothing launches the kernel."""
    _check_sketch_dim(fl)
    if fl.score_backend == "kernel":
        reduce = scored_reduce
    elif fl.score_backend == "reference":
        reduce = scored_reduce_reference
    else:
        raise ValueError(f"unknown score_backend {fl.score_backend!r} "
                         "(expected 'kernel' or 'reference')")

    def scores_of(rows, key):
        if fl.score_sketch_dim:
            sk = sketch_stacked(rows, key, fl.score_sketch_dim)
            mean = torch.mean(sk, dim=0)
            dots = sk @ mean
            norms = torch.sum(sk * sk, dim=1)
            msq = torch.sum(mean * mean)
        else:
            mean = torch.mean(rows, dim=0)
            dots, norms, msq = reduce(rows, mean)
        cos = dots / torch.clamp(torch.sqrt(norms) * torch.sqrt(msq),
                                 min=1e-12)
        return (fl.chi + cos) / (fl.chi + 1.0)

    return scores_of


def write_back(fl: FLConfig, w, buf, part_prev, d_new, active):
    """Algorithm 2's buffer update, in place: the active rows take their
    new updates and the slots of clients that never took part are
    refreshed (line 17). Returns the new participation mask."""
    part = part_prev | active
    rows = torch.nonzero(active).squeeze(1)
    buf.index_copy_(0, rows, d_new.index_select(0, rows))
    stale = torch.nonzero(~part).squeeze(1)
    if fl.literal_init_buffer:
        refresh = (w / fl.local_lr)[None, :].expand(stale.numel(), -1)
        buf.index_copy_(0, stale, refresh)
    else:
        buf.index_fill_(0, stale, 0.0)
    return part


def write_back_masked(fl: FLConfig, w, buf, part_prev, d_new, active):
    """``write_back`` in fixed shapes and without a host read, for a
    captured CUDA graph: two masked passes over ``buf``, each written into
    ``buf`` itself, so no second (U, N) tensor is made. The
    values are ``write_back``'s: each row is copied from ``d_new``, from the
    refresh row or from itself."""
    part = part_prev | active
    torch.where(active[:, None], d_new, buf, out=buf)
    stale = (~part)[:, None]
    if fl.literal_init_buffer:
        torch.where(stale, (w / fl.local_lr)[None, :], buf, out=buf)
    else:
        buf.masked_fill_(stale, 0.0)
    return part


def make_stacked_round_body(fl: FLConfig, fixed_shape: bool = False):
    """The stacked OSAFL round as one function

        rnd(w, buf, part_prev, lam_prev, d_new, active, alphas, key=None)
            -> (w, buf, part, lam_use, lam)

    ``buf`` is updated in place and returned: at U=256 clients of the FCN it
    is 3.9 GB, and rewriting only the rows that change saves a second copy
    and its traffic. Scores come from ``make_scores_fn`` (the CUDA kernel,
    the plain-torch oracle, or the sketch under ``key``, the server's
    ``sketch_key``); the mean and the final weighted sum are plain torch
    ops, as the reference leaves them outside its kernel. ``fixed_shape``
    takes ``write_back_masked`` (the fused round's, which a CUDA graph can
    hold) for ``write_back``."""
    scores_of = make_scores_fn(fl)
    update = write_back_masked if fixed_shape else write_back

    def rnd(w, buf, part_prev, lam_prev, d_new, active, alphas, key=None):
        part = update(fl, w, buf, part_prev, d_new, active)
        lam = scores_of(buf, key)
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
                 alphas: Optional[np.ndarray] = None, seed: int = 0,
                 device=None):
        _check_sketch_dim(fl)
        dev = self.device = resolve_device(device)
        self.params = tree_map(lambda x: x.to(dev), params)
        self.fl = fl
        self.U = num_clients
        self.alphas = (np.full(num_clients, 1.0 / num_clients)
                       if alphas is None else alphas)
        self.d_buffer: List = [self._refresh()] * num_clients
        self.participated = np.zeros(num_clients, bool)
        self.last_scores = np.ones(num_clients)
        self._sketch_key = seed_key(seed)

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
        if fl.score_sketch_dim:
            sk = torch.stack([sketch_tree(d, self._sketch_key,
                                          fl.score_sketch_dim)
                              for d in self.d_buffer])
            lam = lambda_scores_sketched(sk, fl.chi)
        else:
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

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """Everything a round mutates: params, the per-client contribution
        trees, participation flags, the scores and the stale-score carry."""
        return {"params": self.params,
                "d_buffer": list(self.d_buffer),
                "participated": self.participated,
                "last_scores": np.asarray(self.last_scores),
                "lam_next": getattr(self, "_lam_next", None),
                "sketch_key": self._sketch_key}

    def load_state_dict(self, sd: dict) -> None:
        self.params = _tree_to(sd["params"], self.device)
        self.d_buffer = [_tree_to(d, self.device) for d in sd["d_buffer"]]
        self.participated = np.asarray(sd["participated"], bool).copy()
        self.last_scores = np.asarray(sd["last_scores"])
        if sd.get("lam_next") is not None:
            self._lam_next = np.asarray(sd["lam_next"])
        else:
            self.__dict__.pop("_lam_next", None)
        self._sketch_key = np.asarray(sd["sketch_key"])


class StackedOSAFLServer:
    """Algorithm 2 on a (U, N) contribution buffer. ``round_stacked(d_new,
    active)`` takes a dense (U, N) update matrix (from
    ``client.make_vmapped_local_train``) and a participation mask;
    ``round(updates)`` takes the loop server's list of ``ClientUpdate``s."""

    def __init__(self, params, fl: FLConfig, num_clients: int,
                 alphas: Optional[np.ndarray] = None, seed: int = 0,
                 device=None):
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
        self._sketch_key = seed_key(seed)
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
            d_new, active, self.alphas, self._sketch_key)
        self.last_scores = lam_use.cpu().numpy()
        return self.w

    def round(self, updates: Sequence[ClientUpdate]) -> dict:
        d_new, active = scatter_updates(self.codec, updates, self.U,
                                        device=self.w.device)
        self.round_stacked(d_new, active)
        return self.params

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """The global weights, the (U, N) contribution buffer, participation
        flags and both score vectors (current and stale carry). The leaves
        are the live tensors; the round writes ``d_buffer`` in place, so a
        writer must copy them before the next round (both writers do)."""
        return {"w": self.w, "d_buffer": self.d_buffer,
                "participated": self.participated,
                "last_scores": np.asarray(self.last_scores),
                "lam_prev": self._lam_prev,
                "sketch_key": self._sketch_key}

    def load_state_dict(self, sd: dict) -> None:
        dev = self.w.device
        self.w = owned_tensor(sd["w"], dev)
        self.d_buffer = owned_tensor(sd["d_buffer"], dev)
        self.participated = owned_tensor(
            np.asarray(sd["participated"], bool), dev)
        self.last_scores = np.asarray(sd["last_scores"])
        self._lam_prev = owned_tensor(sd["lam_prev"], dev)
        self._sketch_key = np.asarray(sd["sketch_key"])
