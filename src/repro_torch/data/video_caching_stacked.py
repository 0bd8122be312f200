"""Batched Gumbel-max request model: all U users advance per slot at once
(Algorithm 5 at cohort scale), on the run's device. The port of
``repro/data/video_caching_stacked.py``.

``data/video_caching.py`` is the per-user oracle: every decision of
Algorithm 5 is an ``rng.choice(p=pmf)`` over a small categorical. Here each
becomes the Gumbel-max trick, ``argmax(log p_i + G_i)`` with ``G_i`` iid
Gumbel(0, 1), which is exactly ``Cat(p)``; masking a logit to -inf drops
that entry and re-normalizes the rest. So the whole branch structure is a
handful of masked ``(U, .)`` argmaxes a step:

  * first request (``genre < 0``): genre = argmax over ``log pref_u``;
  * exploit (``u <= eps_u``): the raw within-genre cosine sims with the
    current file masked out, restricted to their top-K by ``torch.topk``
    (the softmax is a monotone map, so ``argmax(sims + G)`` samples it);
  * explore: genre = argmax over ``log pref_u`` with the current genre
    masked;
  * Zipf rank (first/explore): argmax over the log Zipf-Mandelbrot pmf,
    mapped through the genre's popularity order.

One draw of ``width`` samples per user runs ``L = width + warmup`` such
steps (``warmup`` is the cohort's largest unfilled-window deficit, read
off the state until the cohort is warm and 0 after), with a per-user
``emitted < counts`` mask so that a user stops once it has its samples.
The steps emit (slot, request id) pairs; one scatter afterwards assembles
the padded ``(U, width, 3168)`` / ``(U, width, SEQ_LEN)`` blocks of
``data/online.py``'s layout, which ``StackedOnlineBuffer.stage`` takes.

The randomness of a block is drawn before its steps, as in the reference,
but by the port's own lineage: ``_noise`` draws the four tensors (a
``(L, U)`` uniform and ``(L, U, G)``, ``(L, U, P)``, ``(L, U, topk)``
Gumbels) from a CPU ``torch.Generator`` seeded from the run seed and a
fixed tag, and they reach the device in one copy; the pure
``_draw_block`` consumes them. So one seed gives the same stream on the
CPU and on the card. The stream matches the reference in distribution
(chi-squared tests per branch), not bit for bit: jax's threefry lineage is
not replayed. Fed the same noise, ``_draw_block`` gives the reference's
blocks and states bit for bit. ``log_pref`` and ``log_zipf`` are computed
on the host once, for the same card-equals-CPU reason.

``state_dict`` holds the generator's state (a uint8 tensor under
``"key"``, where the reference holds a threefry key) and the Markov state,
in the reference's dtypes (int32, bool); labels and Dataset-2 histories
come out as int64, the port's buffer dtypes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.data.video_caching import (F_FILES, FILES_PER_GENRE,
                                            G_GENRES, GENRE_FEAT_DIM, SEQ_LEN,
                                            Catalog, RequestStream,
                                            zipf_mandelbrot_pmf)
from repro_torch.device import resolve_device

NOISE_TAG = 0x726571         # "req": the stream's seed tag (as the reference)


class StreamConsts(NamedTuple):
    """Per-population constants on the device (catalog + user parameters)."""
    feat50: torch.Tensor      # (F, 3072) f32 catalog features / 50
    own_sims: torch.Tensor    # (F, 20) f32 sims of each file vs its genre
    popularity: torch.Tensor  # (G, 20) int64 Zipf rank -> in-genre index
    pref: torch.Tensor        # (U, G) f32 Dirichlet genre preferences
    log_pref: torch.Tensor    # (U, G) f32 log preferences (genre logits)
    eps: torch.Tensor         # (U,) f32 exploitation probabilities
    log_zipf: torch.Tensor    # (20,) f32 log Zipf-Mandelbrot pmf


class StreamState(NamedTuple):
    """What a draw advances. The Dataset-1 feature carry is a function of
    ``file`` (the oracle's ``_last_feat == dataset1_sample(.., _file)``),
    so only its flag is kept."""
    genre: torch.Tensor       # (U,) int64 Markov genre, -1 before the first
    file: torch.Tensor        # (U,) int64 Markov global file id, -1 at first
    has_last: torch.Tensor    # (U,) bool: a Dataset-1 window carry exists
    hist: torch.Tensor        # (U, SEQ_LEN) int64 Dataset-2 ring, newest last
    hist_len: torch.Tensor    # (U,) int64 valid suffix of hist


def _features_for(consts: StreamConsts, fids: torch.Tensor) -> torch.Tensor:
    """Vectorized ``dataset1_sample``: (U, W) request ids -> (U, W, 3168)
    rows (content feature/50, genre prefs, within-genre sims, genre
    feature/G, eps)."""
    U, W = fids.shape
    g = torch.div(fids, FILES_PER_GENRE, rounding_mode="floor").float()
    return torch.cat([
        consts.feat50[fids],
        consts.pref[:, None, :].expand(U, W, G_GENRES),
        consts.own_sims[fids],
        (g[..., None] / G_GENRES).expand(U, W, GENRE_FEAT_DIM),
        consts.eps[:, None, None].expand(U, W, 1),
    ], dim=-1)


def _draw_block(consts: StreamConsts, state: StreamState,
                counts: torch.Tensor, width: int, warmup: int, dataset: int,
                topk: int, noise: Tuple[torch.Tensor, ...]):
    """Advance the cohort until every user u has emitted ``counts[u]``
    samples (``counts[u] <= width``) and return ``(state, x, y)`` with
    padded (U, width, ...) blocks. ``noise`` is the block's
    ``(u_br, gum_genre, gum_rank, gum_top)`` with leading axis
    ``L = width + warmup``, on the state's device."""
    U = counts.shape[0]
    dev = counts.device
    G, P = G_GENRES, FILES_PER_GENRE
    L = width + warmup
    g_ids = torch.arange(G, device=dev)[None, :]
    p_ids = torch.arange(P, device=dev)[None, :]
    u_br, gum_genre, gum_rank, gum_top = noise
    if u_br.shape != (L, U):
        raise ValueError(f"noise for {tuple(u_br.shape)} steps x users, "
                         f"the block needs ({L}, {U})")
    neg_inf = torch.tensor(float("-inf"), device=dev)
    genre, file_, has_last = state.genre, state.file, state.has_last
    hist, hist_len = state.hist, state.hist_len
    emitted = torch.zeros(U, dtype=torch.int64, device=dev)
    slots, fids, payload = [], [], []
    for t in range(L):
        active = emitted < counts                 # still owes samples
        first = genre < 0
        exploit = (~first) & (u_br[t] <= consts.eps)
        explore = (~first) & ~exploit

        # genre: Cat(pref) for first requests; explore masks the current
        # genre (the oracle's re-normalization over the other G-1 genres)
        glog = torch.where(explore[:, None] & (g_ids == genre[:, None]),
                           neg_inf, consts.log_pref)
        g_draw = torch.argmax(glog + gum_genre[t], dim=1)

        # Zipf-Mandelbrot rank through the genre's popularity order
        rank = torch.argmax(consts.log_zipf[None, :] + gum_rank[t], dim=1)
        f_zipf = g_draw * P + consts.popularity[g_draw, rank]

        # exploit: top-K of the within-genre sims, current file masked out;
        # argmax(sims + gumbel) over that set is the oracle's re-normalized
        # top-K softmax draw
        f_safe = torch.clamp(file_, min=0)
        sims = torch.where(p_ids == (f_safe % P)[:, None], neg_inf,
                           consts.own_sims[f_safe])
        top_v, top_i = torch.topk(sims, topk, dim=1)
        kwin = torch.argmax(top_v + gum_top[t], dim=1)
        f_exploit = torch.clamp(genre, min=0) * P + torch.gather(
            top_i, 1, kwin[:, None])[:, 0]

        f_new = torch.where(exploit, f_exploit, f_zipf)
        prev_file = file_
        genre = torch.where(active, torch.div(f_new, P,
                                              rounding_mode="floor"), genre)
        file_ = torch.where(active, f_new, file_)

        if dataset == 1:
            # sliding window: the previous request's feature predicts f_new
            emit = active & has_last
            payload.append(prev_file)
            has_last = has_last | active
        else:
            # history ring: the SEQ_LEN requests before f_new predict f_new
            emit = active & (hist_len >= SEQ_LEN)
            payload.append(hist)
            pushed = torch.cat([hist[:, 1:], f_new[:, None]], dim=1)
            hist = torch.where(active[:, None], pushed, hist)
            hist_len = torch.where(active, torch.clamp(hist_len + 1,
                                                       max=SEQ_LEN), hist_len)
        slots.append(torch.where(emit, emitted, width))
        fids.append(f_new)
        emitted = emitted + emit

    # assemble the padded blocks in one pass: each (u, slot < width) pair is
    # written by exactly one step and only slots < counts[u] are emitted;
    # slot == width is the discard column
    uu = torch.arange(U, device=dev)[None, :].expand(L, U)
    slots = torch.stack(slots)
    out_y = torch.zeros((U, width + 1), dtype=torch.int64, device=dev)
    out_y[uu, slots] = torch.stack(fids)
    if dataset == 1:
        prev = torch.zeros((U, width + 1), dtype=torch.int64, device=dev)
        prev[uu, slots] = torch.stack(payload)
        prev = prev[:, :width]
        # _features_for builds garbage rows from the prev=0 padding slots;
        # this mask (alone) zeroes them
        valid = torch.arange(width, device=dev)[None, :] < counts[:, None]
        out_x = torch.where(valid[..., None], _features_for(consts, prev),
                            0.0)
    else:
        out_x = torch.zeros((U, width + 1, SEQ_LEN), dtype=torch.int64,
                            device=dev)
        out_x[uu, slots] = torch.stack(payload)
        out_x = out_x[:, :width]
    new_state = StreamState(genre, file_, has_last, hist, hist_len)
    return new_state, out_x, out_y[:, :width]


def warmup_deficit(state: StreamState, dataset: int) -> int:
    """The most warm-up requests any user still owes before it can emit a
    sample (0 once the cohort is warm). A host read of the device state."""
    if dataset == 1:
        return 0 if bool(state.has_last.all()) else 1
    return max(0, SEQ_LEN - int(state.hist_len.min()))


def stream_generator(seed: int) -> torch.Generator:
    """The stream's CPU generator: seeded from the run seed and a fixed
    tag, so its draws are decorrelated from other consumers of the seed."""
    words = np.random.SeedSequence([int(seed), NOISE_TAG]).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed(
        int(words[0]) << 32 | int(words[1]))


# the reference's dtypes of the state in a snapshot
_STATE_DTYPES = {"genre": np.int32, "file": np.int32, "has_last": np.bool_,
                 "hist": np.int32, "hist_len": np.int32}


@dataclass
class StackedRequestStream:
    """Whole-cohort request stream on one device: the vectorized twin of U
    ``RequestStream``s, drawing every user's next slot at once."""
    consts: StreamConsts
    state: StreamState
    topk: int
    generator: torch.Generator
    seed: int = 0
    # per-dataset host cache of "the warm-up deficit reached 0": the deficit
    # never grows, so once warm the per-draw device read is skipped; reset
    # whenever the state is replaced
    _warm: dict = field(default_factory=dict)

    @classmethod
    def from_streams(cls, cat: Catalog, streams: List[RequestStream],
                     seed: int = 0, device=None) -> "StackedRequestStream":
        """Import a scalar population mid-stream: the user parameters become
        (U, ...) constants on ``device`` and each user's Markov state and
        window carries seed the state. Only the RNG lineage differs (one
        torch generator from ``seed`` instead of U PCG64 streams)."""
        dev = resolve_device(device)
        users = [s.user for s in streams]
        U = len(users)
        if U == 0:
            raise ValueError("empty population")
        topk = min(int(users[0].topk), FILES_PER_GENRE - 1)
        gamma, q = users[0].gamma, users[0].q
        for u in users:
            if (u.topk, u.gamma, u.q) != (users[0].topk, gamma, q):
                raise ValueError("stacked stream needs homogeneous "
                                 "topk/gamma/q across the cohort")
        own = cat.cos_sim.reshape(F_FILES, G_GENRES, FILES_PER_GENRE)[
            np.arange(F_FILES), np.arange(F_FILES) // FILES_PER_GENRE]
        pref = torch.from_numpy(
            np.stack([u.genre_pref for u in users]).astype(np.float32))
        zipf = torch.from_numpy(np.asarray(
            zipf_mandelbrot_pmf(FILES_PER_GENRE, gamma, q), np.float32))

        def put(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype).to(dev)
        consts = StreamConsts(
            feat50=put(cat.features / np.float32(50.0)),
            own_sims=put(own.astype(np.float32)),
            popularity=put(cat.popularity, torch.int64),
            pref=put(pref), log_pref=put(torch.log(pref)),
            eps=put(np.array([u.eps for u in users], np.float32)),
            log_zipf=put(torch.log(zipf)))
        hist = np.zeros((U, SEQ_LEN), np.int64)
        hist_len = np.zeros(U, np.int64)
        for i, s in enumerate(streams):
            h = s._history[-SEQ_LEN:]
            if h:
                hist[i, SEQ_LEN - len(h):] = h
                hist_len[i] = len(h)
        state = StreamState(
            genre=put([u._genre for u in users], torch.int64),
            file=put([u._file for u in users], torch.int64),
            has_last=put([s._last_feat is not None for s in streams],
                         torch.bool),
            hist=put(hist), hist_len=put(hist_len))
        return cls(consts=consts, state=state, topk=topk,
                   generator=stream_generator(seed), seed=int(seed))

    @property
    def num_users(self) -> int:
        return int(self.state.genre.shape[0])

    @property
    def device(self) -> torch.device:
        return self.state.genre.device

    # -- drawing -------------------------------------------------------------
    def _noise(self, L: int) -> Tuple[torch.Tensor, ...]:
        """A block's randomness on the host, from the stream's generator:
        the ``(L, U)`` branch uniform and the ``(L, U, G)``, ``(L, U, P)``
        and ``(L, U, topk)`` Gumbels, float32."""
        U, gen = self.num_users, self.generator
        tiny = torch.finfo(torch.float32).tiny

        def gumbel(*shape):
            u = torch.rand(shape, generator=gen).clamp_(min=tiny)
            return -torch.log(-torch.log(u))
        return (torch.rand((L, U), generator=gen),
                gumbel(L, U, G_GENRES), gumbel(L, U, FILES_PER_GENRE),
                gumbel(L, U, self.topk))

    def _to_device(self, noise) -> Tuple[torch.Tensor, ...]:
        """The block's noise on the stream's device, in one copy."""
        if self.device.type == "cpu":
            return tuple(noise)
        flat = torch.cat([n.reshape(-1) for n in noise]).to(self.device)
        return tuple(part.view(n.shape) for part, n in zip(
            torch.split(flat, [n.numel() for n in noise]), noise))

    def _draw(self, counts, width: int, dataset: int
              ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
        counts = np.asarray(counts)
        width = int(width)
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        if counts.shape != (self.num_users,):
            raise ValueError(f"counts shape {counts.shape} != "
                             f"({self.num_users},)")
        if counts.max(initial=0) > width:
            raise ValueError(f"max arrivals {int(counts.max())} > pad "
                             f"width {width}")
        warmup = (0 if self._warm.get(dataset)
                  else warmup_deficit(self.state, dataset))
        self._warm[dataset] = warmup == 0
        noise = self._to_device(self._noise(width + warmup))
        self.state, xs, ys = _draw_block(
            self.consts, self.state,
            torch.as_tensor(counts, dtype=torch.int64, device=self.device),
            width, warmup, dataset, self.topk, noise)
        return xs, ys, counts.astype(np.int32)

    def draw_dataset1(self, counts, width: int):
        """counts[u] fresh Dataset-1 samples per user, padded to
        ``(U, width, 3168)`` / ``(U, width)``, and the (U,) valid counts:
        the ``StackedOnlineBuffer.stage`` argument layout."""
        return self._draw(counts, width, 1)

    def draw_dataset2(self, counts, width: int):
        """Dataset-2 twin: ``(U, width, SEQ_LEN)`` histories -> next ids."""
        return self._draw(counts, width, 2)

    def draw(self, counts, dataset: int, width: int):
        """Dispatch on the dataset id the harness configs carry."""
        return self._draw(counts, width, 1 if dataset == 1 else 2)

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """Everything a draw mutates, under the reference's keys: the
        generator's state (``"key"``, uint8) and the per-user Markov state
        and window carries in the reference's dtypes. The constants are
        rebuilt from the population seed."""
        st = self.state
        sd = {"key": self.generator.get_state()}
        for k, dt in _STATE_DTYPES.items():
            sd[k] = getattr(st, k).cpu().numpy().astype(dt)
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """Restore a ``state_dict`` snapshot. A snapshot of the reference's
        stacked stream holds a threefry key under ``"key"``; its lineage
        cannot continue on a torch generator, so it is refused."""
        from repro_torch.checkpoint.run_state import CheckpointError
        key = np.asarray(sd["key"])
        want = self.generator.get_state()
        if key.dtype != np.uint8 or key.shape != tuple(want.shape):
            raise CheckpointError(
                f"stacked request stream snapshot: streams/key holds "
                f"{key.dtype}{key.shape}, not the port's torch generator "
                f"state (uint8{tuple(want.shape)}); a snapshot of the JAX "
                "reference's stacked stream carries a threefry key whose "
                "lineage the port cannot continue (resume it in the "
                "reference, or snapshot with request_backend='python')")
        fields = {}
        for k, dt in _STATE_DTYPES.items():
            got = np.asarray(sd[k])
            ref = getattr(self.state, k)
            if got.dtype != dt or got.shape != tuple(ref.shape):
                raise CheckpointError(
                    f"stacked request stream snapshot {k!r} has "
                    f"{got.dtype}{got.shape}; the live stream expects "
                    f"{np.dtype(dt)}{tuple(ref.shape)}")
            fields[k] = torch.as_tensor(got).to(ref.dtype).to(self.device)
        self.generator.set_state(torch.as_tensor(key))
        self.state = StreamState(**fields)
        self._warm = {}                 # the restored state may be colder
