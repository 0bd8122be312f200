"""The fused online OSAFL round: ``rounds_per_dispatch`` rounds as one
segment, which on the card is one captured CUDA graph replayed once (the
port of ``repro/core/round_fused.py``, whose segment is one XLA
executable).

A round of the segment (``FusedEngine._round``) follows the reference's
round body step by step:

  1. arrivals: Binomial(E_u, p_ac) counts as E_u summed Bernoulli draws
     (``draw_counts``), and their samples from the stacked Gumbel-max
     request model at warm-up 0 (``_draw_block``; ``init_carry`` refuses a
     cold request window);
  2. the FIFO stage and commit (``stage_in_place``, ``commit_in_place``);
  3. this round's kappas from a resource solve run ahead of the rounds
     (``_solve_segment``): it depends on the per-round draws only, never on
     the model or the buffer;
  4. batch slots uniform over each client's live window (``draw_slots``)
     and the masked, vmapped kappa_u-step local SGD of the whole cohort;
  5. the scored server round (eqs. 19-21, ``make_stacked_round_body`` with
     its fixed-shape buffer update; the score reduction is the CUDA kernel
     on the card, or the sketch with ``score_sketch_dim > 0``);
  6. the evaluation, one row of the segment's outputs.

Draws. The reference keys every draw on ``fold_in(base_key, t)`` with the
absolute round t. Its threefry bits cannot be had in torch, so the port's
draws are Philox-4x32-10 (the counter-based generator of cuRAND and
torch, ``src/repro_torch/core/philox.py``), written in int64 tensor ops
with 32-bit masks: each 32-bit word is a pure function of (seed, absolute
round, draw stream, lane), with no generator state. Graph replays,
segment splits and resumes therefore consume the same numbers, and the
CPU and the card compute the same bits. Uniforms take a word's top 24
bits; the Gumbel and normal transforms run in float64 and are rounded to
float32, so that an ulp between the CPU's ``log`` and the card's almost
never survives. ``round_draws`` is the one
function that makes a round's draws; a test can replace it with the
reference's own. The draws match the reference's in distribution, and fed
the reference's draws the round matches its rounds.

The solve runs once per round on (U,) lanes, all rounds ahead of the
first. The reference batches it over (rounds x U) lanes, which is exact
lane by lane in XLA; torch's CPU kernels compute a tensor's vectorized
body and its scalar tail with different code, so a lane's bits there
depend on its position, and a per-round call keeps the dispatch round's
shapes (and its bits).

On the card, ``run_segment`` replays a CUDA graph captured per segment
length over one fixed carry: every graph updates the carry's tensors in
place, so any graph can follow any other, and the lengths share one memory
pool (no tensor of the pool outlives its capture). Before the first
capture the kernel library is built and loaded and one round runs eagerly
on a throwaway copy of the carry, on a side stream, to initialize what a
capture cannot (the cuBLAS workspaces, the sketch signs, the solver's
constants); that round scores with the plain reduction, so the kernel's
launch count stays the number of kernels the card ran. The count of a
captured launch is taken off at capture and added at every replay. A
carry on the CPU runs the same rounds eagerly. There is no fallback: a
failed capture raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.buffer_stacked import (BufState, commit_in_place,
                                             stage_in_place)
from repro_torch.core.client import make_vmapped_local_train
from repro_torch.core.osafl import make_stacked_round_body
from repro_torch.core.philox import MASK32 as _MASK32
from repro_torch.core.philox import philox4x32
from repro_torch.core.resource import NetworkConfig, pathloss_linear
from repro_torch.core.resource_stacked import (BACKEND_DTYPES,
                                               RESOURCE_BACKENDS,
                                               ClientSystemBatch,
                                               ResourceSolveError,
                                               make_solver_core)
from repro_torch.data.video_caching import FILES_PER_GENRE, G_GENRES
from repro_torch.data.video_caching_stacked import (StreamConsts,
                                                    StreamState, _draw_block,
                                                    warmup_deficit)
from repro_torch.device import resolve_device
from repro_torch.kernels import scored_reduce as sr
from repro_torch.models.small import small_loss

# decorrelates the fused round's draws from every other consumer of the run
# seed (model init, the request stream's own 0x726571 lineage)
ROUND_KEY_TAG = 0x0f5afe

_U24 = 2.0 ** -24


def fused_base_key(seed: int) -> Tuple[int, int]:
    """The two 32-bit Philox key words of a run seed."""
    words = np.random.SeedSequence([int(seed), ROUND_KEY_TAG]).generate_state(
        2, np.uint32)
    return int(words[0]), int(words[1])


def counter_words(key, t: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """``n`` 32-bit words (int64) of draw stream ``stream`` at absolute
    round ``t`` (a 0-d integer tensor on the words' device): the Philox
    outputs of counters (lane block, stream, t low, t high) in order."""
    blocks = -(-n // 4)
    lane = torch.arange(blocks, dtype=torch.int64, device=t.device)
    t = t.to(torch.int64)
    ctr = (lane, torch.full_like(lane, stream), (t & _MASK32).expand(blocks),
           (t >> 32).expand(blocks))
    return torch.stack(philox4x32(ctr, key), dim=1).reshape(-1)[:n]


def uniform(words: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) from the top 24 bits of each word."""
    return (words >> 8).to(torch.float32) * _U24


def _open_uniform64(words: torch.Tensor) -> torch.Tensor:
    """float64 uniforms in (0, 1): the top 24 bits and a half."""
    return ((words >> 8).to(torch.float64) + 0.5) * _U24


def gumbel(words: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) draws, computed in float64 and rounded to float32."""
    return (-torch.log(-torch.log(_open_uniform64(words)))).to(torch.float32)


def normal(words: torch.Tensor) -> torch.Tensor:
    """N(0, 1) draws by Box-Muller, one from each pair of words, computed
    in float64 and rounded to float32."""
    u = _open_uniform64(words).view(-1, 2)
    r = torch.sqrt(-2.0 * torch.log(u[:, 0]))
    return (r * torch.cos(2.0 * np.pi * u[:, 1])).to(torch.float32)


class DrawSpec(NamedTuple):
    """What fixes the shapes of a round's draws."""
    key: Tuple[int, int]
    num_users: int
    width: int                # arrivals E_u: the request block's steps
    kappa_max: int
    batch: int
    topk: int


class RoundDraws(NamedTuple):
    """One round's randomness: the arrival uniforms (U, E), the shadowing
    normals (U,), the slot uniforms (U, kappa_max, B) and the request
    model's ``(u_br, gum_genre, gum_rank, gum_top)`` noise."""
    arrivals: torch.Tensor
    normals: torch.Tensor
    slots: torch.Tensor
    noise: Tuple[torch.Tensor, ...]


# draw streams of a round (the counters' second word)
_ARRIVALS, _SHADOW, _SLOTS, _BRANCH, _GENRE, _RANK, _TOP = range(7)


def round_draws(spec: DrawSpec, t: torch.Tensor) -> RoundDraws:
    """Round ``t``'s draws (``t`` a 0-d integer tensor on the run's
    device), each stream from its own Philox counters."""
    U, E = spec.num_users, spec.width

    def words(stream, *shape):
        return counter_words(spec.key, t, stream,
                             int(np.prod(shape))).view(shape)
    return RoundDraws(
        arrivals=uniform(words(_ARRIVALS, U, E)),
        normals=normal(words(_SHADOW, 2 * U)),
        slots=uniform(words(_SLOTS, U, spec.kappa_max, spec.batch)),
        noise=(uniform(words(_BRANCH, E, U)),
               gumbel(words(_GENRE, E, U, G_GENRES)),
               gumbel(words(_RANK, E, U, FILES_PER_GENRE)),
               gumbel(words(_TOP, E, U, spec.topk))))


def draw_counts(u: torch.Tensor, p_ac: torch.Tensor) -> torch.Tensor:
    """Binomial(E, p_ac[u]) arrival counts from (U, E) uniforms ``u``: the
    reference's ``sum(u < p_ac)``."""
    return torch.sum(u < p_ac[:, None], dim=1)


def draw_shadowing_db(normals: torch.Tensor,
                      shadow_sigma_db: float = 8.0) -> torch.Tensor:
    """Per-client log-normal shadowing in dB from (U,) standard normals."""
    return normals * shadow_sigma_db


def draw_slots(u: torch.Tensor, size, head, cap) -> torch.Tensor:
    """(U, *sample_shape) storage slots uniform over each client's live FIFO
    window from uniforms ``u`` of that shape: ``(head + min(floor(u *
    max(size, 1)), max(size, 1) - 1)) % cap`` (an empty buffer gives its
    head)."""
    lead = (u.shape[0],) + (1,) * (u.dim() - 1)
    sz = torch.clamp(size, min=1).reshape(lead)
    j = torch.minimum(torch.floor(u * sz).to(torch.int64), sz - 1)
    return (head.reshape(lead) + j) % cap.reshape(lead)


class FusedCarry(NamedTuple):
    """Everything a round mutates, as device tensors that a segment updates
    in place: the server state (flat weights, (U, N) contribution buffer,
    participation flags, stale-score carry), the FIFO buffer, the request
    model's Markov state and the absolute round that keys the draws."""
    w: torch.Tensor
    d_buffer: torch.Tensor
    participated: torch.Tensor
    lam_prev: torch.Tensor
    buf: BufState
    stream: StreamState
    t: torch.Tensor              # () int64 absolute round index


@dataclasses.dataclass
class CapturedSegment:
    """One captured segment length: its graph, its static outputs, the
    kernel launches one replay makes and the seconds the capture took."""
    graph: object
    outs: dict
    launches: int
    capture_s: float


def _clone_carry(carry: FusedCarry) -> FusedCarry:
    return FusedCarry(*[type(f)(*[x.clone() for x in f])
                        if isinstance(f, tuple) else f.clone()
                        for f in carry])


def _copy_fields(dst: tuple, src: tuple) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


class FusedEngine:
    """Runs segments of the fused online OSAFL round over the run's state.

    Construction takes only core and data-layer objects; the harness
    (``repro_torch/harness/experiments.py``) adapts its setup. The fused
    body is the OSAFL scored round over the stacked request stream, dense,
    so ``fl.algorithm`` must be ``"osafl"``, ``fl.request_backend``
    ``"stacked"`` and ``fl.cohort_size`` 0."""

    def __init__(self, *, fl: FLConfig, codec, model: str,
                 consts: StreamConsts, topk: int, dataset: int,
                 arrivals: int, batch: int, p_ac, sysb: ClientSystemBatch,
                 net: NetworkConfig, n_params: int, test_batch, alphas,
                 sketch_key, seed: int, use_resource_opt: bool = True,
                 resource_backend: str = "f32", device=None):
        if fl.algorithm != "osafl":
            raise ValueError(
                "the fused round implements the OSAFL scored round only "
                f"(got algorithm={fl.algorithm!r}); run other algorithms "
                "with round_backend='dispatch'")
        if fl.request_backend != "stacked":
            raise ValueError(
                "the fused round draws requests with the stacked Gumbel "
                "sampler; set request_backend='stacked' "
                f"(got {fl.request_backend!r})")
        if fl.cohort_size:
            raise ValueError(
                "the fused round is dense-only: its carry bakes slot index "
                "== user id into one static program, which the sparse "
                "slot-pool engine (core/cohort.py) breaks by design; run "
                "cohort_size>0 with round_backend='dispatch' (a slot-"
                "indexed fused carry is a scoped ROADMAP follow-up)")
        if resource_backend not in RESOURCE_BACKENDS:
            raise ValueError(f"unknown resource backend {resource_backend!r} "
                             f"(expected one of {RESOURCE_BACKENDS})")
        # the device with its index, as the carry's tensors name it
        dev = self.device = torch.empty(0, device=resolve_device(
            device)).device
        self.fl = fl
        self.codec = codec
        self.model = model
        self.consts = consts
        self.topk = int(topk)
        self.dataset = int(dataset)
        self.arrivals = int(arrivals)
        self.batch = int(batch)
        self.use_resource_opt = bool(use_resource_opt)
        self.resource_backend = resource_backend
        self.p_ac = torch.as_tensor(np.asarray(p_ac, np.float32), device=dev)
        self.test_batch = test_batch
        self.alphas = alphas
        self.sketch_key = sketch_key
        self.n_params = int(n_params)
        U = self.p_ac.shape[0]
        self.spec = DrawSpec(fused_base_key(seed), U, self.arrivals,
                             fl.kappa_max, self.batch, self.topk)
        # the solve's constant columns live in the solve dtype up front
        sdt = BACKEND_DTYPES[resource_backend]
        self._sys_cols = tuple(
            torch.as_tensor(np.asarray(a, np.float64)).to(dev).to(sdt)
            for a in (sysb.c, sysb.s, sysb.f_max, sysb.p_max, sysb.e_bd))
        self._xi = torch.as_tensor(np.asarray(
            pathloss_linear(sysb.distance), np.float64)).to(dev).to(sdt)
        self._solve = make_solver_core(net, resource_backend, device=dev)
        self._local = make_vmapped_local_train(
            torch.func.grad(lambda p, b: small_loss(p, b, model)[0]),
            fl.local_lr, fl.kappa_max)
        self._server_round = make_stacked_round_body(fl, fixed_shape=True)
        # the warm-up round's: the same round with the plain reduction
        self._server_round_plain = make_stacked_round_body(
            dataclasses.replace(fl, score_backend="reference"),
            fixed_shape=True)
        self._graphs: dict = {}
        self._bound = None            # the carry the graphs were captured on
        self._pool = None
        # one {length, capture_s, warm_up_s, launches} per capture
        self.capture_log = []

    # -- the fused round -----------------------------------------------------
    def _solve_segment(self, normals) -> tuple:
        """Every round's kappas (in the solve dtype) and its ``bad_solve``
        flag (a feasible lane with a non-finite decision), from each
        round's shadowing normals."""
        sdt = BACKEND_DTYPES[self.resource_backend]
        U = self.p_ac.shape[0]
        if not self.use_resource_opt:
            kap = torch.full((U,), float(self.fl.kappa_max), dtype=sdt,
                             device=self.device)
            no = torch.zeros((), dtype=torch.bool, device=self.device)
            return [kap] * len(normals), [no] * len(normals)
        kaps, bads = [], []
        for nrm in normals:
            gamma = 10.0 ** (draw_shadowing_db(nrm).to(sdt) / 10.0)
            kap, f, p, feas, _, _ = self._solve(*self._sys_cols, self._xi,
                                                gamma, self.n_params)
            bad = feas & ~(torch.isfinite(kap) & torch.isfinite(f)
                           & torch.isfinite(p))
            kaps.append(kap)
            bads.append(torch.any(bad))
        return kaps, bads

    def _round(self, carry: FusedCarry, draws: RoundDraws, kap,
               server_round) -> dict:
        """One round on ``carry``, in place; returns its output row."""
        # 1. arrivals: counts and the Gumbel-max samples at warm-up 0
        counts = draw_counts(draws.arrivals, self.p_ac)
        stream, xs, ys = _draw_block(self.consts, carry.stream, counts,
                                     self.arrivals, 0, self.dataset,
                                     self.topk, draws.noise)
        _copy_fields(carry.stream, stream)
        # 2. FIFO stage and commit
        buf = carry.buf
        overflow = stage_in_place(buf, xs, ys, counts)
        commit_in_place(buf)
        del xs, ys
        # 3. this round's kappas (solved ahead of the rounds)
        kappas = kap.to(torch.int64)
        active = kappas >= 1
        # 4. masked kappa_u-step local SGD over the whole cohort
        slots = draw_slots(draws.slots, buf.size, buf.head, buf.cap)
        uu = torch.arange(slots.shape[0], device=slots.device)[:, None, None]
        d, _ = self._local(self.codec.unflatten(carry.w),
                           {"x": buf.x[uu, slots], "y": buf.y[uu, slots]},
                           kappas)
        upd = self.codec.flatten_stacked(d)
        del d
        # 5. eqs. 19-21 scored aggregation (d_buffer is written in place)
        w, _, part, lam_use, lam = server_round(
            carry.w, carry.d_buffer, carry.participated, carry.lam_prev,
            upd, active, self.alphas, self.sketch_key)
        del upd
        row = {"lam_use": lam_use.to(torch.float32).clone()}
        carry.w.copy_(w)
        carry.participated.copy_(part)
        carry.lam_prev.copy_(lam)
        # 6. eval of the new global model
        loss, m = small_loss(self.codec.unflatten(carry.w), self.test_batch,
                             self.model)
        row.update(test_loss=loss.to(torch.float32),
                   test_acc=m["accuracy"].to(torch.float32),
                   participants=torch.sum(active), overflow=overflow)
        return row

    def _segment(self, carry: FusedCarry, outs: dict,
                 server_round=None) -> None:
        """``len`` rounds from ``carry.t`` on, in place, each writing its
        row of ``outs``."""
        server_round = server_round or self._server_round
        k = outs["test_loss"].shape[0]
        draws = [round_draws(self.spec, carry.t + i) for i in range(k)]
        kaps, bads = self._solve_segment([d.normals for d in draws])
        for i in range(k):
            row = self._round(carry, draws[i], kaps[i], server_round)
            row["bad_solve"] = bads[i]
            for name, v in row.items():
                outs[name][i].copy_(v)
        carry.t.add_(k)

    def _new_outs(self, length: int) -> dict:
        dev, U = self.device, self.p_ac.shape[0]
        f32 = dict(dtype=torch.float32, device=dev)
        return {"test_loss": torch.zeros(length, **f32),
                "test_acc": torch.zeros(length, **f32),
                "participants": torch.zeros(length, dtype=torch.int64,
                                            device=dev),
                "lam_use": torch.zeros((length, U), **f32),
                "bad_solve": torch.zeros(length, dtype=torch.bool,
                                         device=dev),
                "overflow": torch.zeros(length, dtype=torch.bool,
                                        device=dev)}

    # -- CUDA graphs ---------------------------------------------------------
    def _warm_up(self, carry: FusedCarry) -> None:
        """Before the first capture: the kernel library built and loaded,
        and one eager round on a throwaway copy of the carry, on a side
        stream, through the plain score reduction."""
        if self.fl.score_backend == "kernel" and not self.fl.score_sketch_dim:
            sr.prepare(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            scratch = _clone_carry(carry)
            self._segment(scratch, self._new_outs(1),
                          self._server_round_plain)
            del scratch
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)

    def _capture(self, carry: FusedCarry, length: int) -> CapturedSegment:
        warm_up_s = 0.0
        if self._bound is not carry:
            if not self.capture_log:
                t0 = time.perf_counter()
                self._warm_up(carry)
                warm_up_s = time.perf_counter() - t0
            self.release()
            self._bound = carry
        outs = self._new_outs(length)
        graph = torch.cuda.CUDAGraph()
        before = sr.scored_reduce.launches
        t0 = time.perf_counter()
        try:
            # thread-local: another thread (a model server) may use the
            # card while this one captures
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                self._segment(carry, outs)
        finally:
            # the capture recorded the launches; the card runs them at replay
            launches = sr.scored_reduce.launches - before
            sr.scored_reduce.launches = before
        if self._pool is None:
            self._pool = graph.pool()
        seg = CapturedSegment(graph, outs, launches,
                              time.perf_counter() - t0)
        self._graphs[length] = seg
        self.capture_log.append({"length": length,
                                 "capture_s": seg.capture_s,
                                 "warm_up_s": warm_up_s,
                                 "launches": launches})
        return seg

    def release(self) -> None:
        """Drop the captured graphs, their memory pool and the bound carry
        (``capture_log`` stays); a later segment captures again."""
        self._graphs.clear()
        self._bound = None
        self._pool = None

    # -- public API ----------------------------------------------------------
    def init_carry(self, server, sbuf, rstream, t: int) -> FusedCarry:
        """The harness's mutable state as the carry at absolute round ``t``:
        the server's, the buffer's and the stream's own tensors, which the
        segments then update in place. Refuses a cold request window (the
        in-segment draw runs at warm-up 0)."""
        deficit = warmup_deficit(rstream.state, self.dataset)
        if deficit:
            raise ValueError(
                f"fused rounds need a warm cohort window (worst-case warmup "
                f"deficit is {deficit}); fill the FIFO buffers before "
                "entering the fused engine")
        return FusedCarry(
            w=server.w, d_buffer=server.d_buffer,
            participated=server.participated, lam_prev=server._lam_prev,
            buf=sbuf.state, stream=rstream.state,
            t=torch.tensor(int(t), dtype=torch.int64, device=self.device))

    def run_segment(self, carry: FusedCarry, length: int):
        """Run ``length`` rounds on ``carry`` (updated in place and returned)
        and return ``(carry, outs)``, ``outs`` a dict of per-round output
        columns on the host. On the card the segment is one replay of the
        graph captured for ``length`` on this carry (captured at first
        use)."""
        if length < 1:
            raise ValueError(f"segment length must be >= 1, got {length}")
        length = int(length)
        if carry.t.device.type != "cuda":
            outs = self._new_outs(length)
            self._segment(carry, outs)
            return carry, outs
        seg = self._graphs.get(length) if self._bound is carry else None
        if seg is None:
            seg = self._capture(carry, length)
        seg.graph.replay()
        sr.scored_reduce.launches += seg.launches
        return carry, {k: v.cpu() for k, v in seg.outs.items()}

    @staticmethod
    def check_outputs(outs: dict) -> None:
        """Raise ``ResourceSolveError`` if any round's solve lost a feasible
        lane to non-finite kappa/f/p (knife-edge configurations; the
        device counterpart of ``resource_stacked._check_finite``), and
        ``ValueError`` if a round staged more arrivals than the stage
        capacity holds."""
        bad = np.asarray(outs["bad_solve"])
        if bad.any():
            rounds = np.flatnonzero(bad)
            raise ResourceSolveError(
                "fused resource solve produced non-finite kappa/f/p on "
                f"feasible clients in segment round(s) {rounds.tolist()}; "
                "for tight-deadline/knife-edge configurations run "
                "resource_backend='x64'")
        over = np.asarray(outs.get("overflow", False))
        if over.any():
            raise ValueError(
                "fused round staged more arrivals than the stage capacity "
                f"in segment round(s) {np.flatnonzero(over).tolist()}; "
                "raise stage_capacity at create()")

    def write_back(self, carry: FusedCarry, outs: dict, server, sbuf,
                   rstream) -> None:
        """Rebind the harness's mutable objects to a segment-final carry,
        so checkpointing and evaluation see the state the dispatch round
        would hold after the same rounds."""
        server.w = carry.w
        server.d_buffer = carry.d_buffer
        server.participated = carry.participated
        server._lam_prev = carry.lam_prev
        server.last_scores = np.asarray(outs["lam_use"][-1])
        sbuf.state = carry.buf
        rstream.state = carry.stream
