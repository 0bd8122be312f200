"""Synthetic video-caching datasets (paper Section V-A1, Appendix D).

A numpy copy of ``repro/data/video_caching.py``, the per-user request
model: with the same seed it draws the same streams bit for bit, and its
``state_dict`` snapshots are the reference's.

Content request model (Algorithm 5): F=100 files in G=5 genres (20 each).
A user picks a genre by its Dirichlet(0.3) genre preference, then a file by
the Zipf-Mandelbrot pmf over the genre's random popularity order. Subsequent
requests exploit (probability eps_u in [0.4, 0.9]): re-normalized softmax over
cosine similarities of the top-K most-similar files; or explore: new genre +
Zipf-Mandelbrot.

Dataset-1 sample (3168 features): [flattened 3x32x32 content feature (3072),
genre preferences (5), cosine sims to the 20 genre files (20), genre feature
(70), exploitation prob (1)]; label = g*20 + f. Sliding window: feature of
request i-1 predicts label of request i.

Dataset-2 sample: last L=10 content IDs -> next content ID.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

F_FILES = 100
G_GENRES = 5
FILES_PER_GENRE = F_FILES // G_GENRES
FEAT_DIM = 3 * 32 * 32
GENRE_FEAT_DIM = 70
SEQ_LEN = 10


@dataclass
class Catalog:
    """Global content catalog: per-file features, per-genre popularity order."""
    features: np.ndarray           # (F, 3072)
    popularity: np.ndarray         # (G, files_per_genre) rank -> file index
    cos_sim: np.ndarray            # (F, F) within-genre cosine similarities

    @classmethod
    def create(cls, rng: np.random.Generator) -> "Catalog":
        feats = rng.normal(size=(F_FILES, FEAT_DIM)).astype(np.float32)
        pop = np.stack([rng.permutation(FILES_PER_GENRE)
                        for _ in range(G_GENRES)])
        norm = feats / np.linalg.norm(feats, axis=1, keepdims=True)
        cos = norm @ norm.T
        return cls(feats, pop, cos)


@lru_cache(maxsize=None)
def _zipf_mandelbrot_cached(n: int, gamma: float, q: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = 1.0 / (ranks + q) ** gamma
    pmf = w / w.sum()
    pmf.setflags(write=False)       # shared across all users — keep immutable
    return pmf


def zipf_mandelbrot_pmf(n: int, gamma: float = 1.2, q: float = 2.0
                        ) -> np.ndarray:
    """Zipf-Mandelbrot popularity pmf over ranks 1..n. The pmf only depends
    on (n, gamma, q), which are population-wide constants, so it is computed
    once and shared (read-only) — every first/explore draw used to rebuild
    it. The stacked sampler caches the log-pmf the same way at build time."""
    return _zipf_mandelbrot_cached(int(n), float(gamma), float(q))


@dataclass
class UserModel:
    """One user's request process (Algorithm 5)."""
    genre_pref: np.ndarray         # (G,)
    eps: float                     # exploitation probability
    p_ac: float                    # arrival probability per slot
    topk: int
    gamma: float = 1.2
    q: float = 2.0
    _genre: int = -1
    _file: int = -1                # global file id

    @classmethod
    def create(cls, rng: np.random.Generator, topk: int) -> "UserModel":
        return cls(genre_pref=rng.dirichlet(0.3 * np.ones(G_GENRES)),
                   eps=rng.uniform(0.4, 0.9),
                   p_ac=rng.uniform(0.3, 0.8),
                   topk=topk)

    def _zipf_request(self, rng, cat: Catalog, genre: int) -> int:
        pmf = zipf_mandelbrot_pmf(FILES_PER_GENRE, self.gamma, self.q)
        rank = rng.choice(FILES_PER_GENRE, p=pmf)
        return genre * FILES_PER_GENRE + cat.popularity[genre][rank]

    def next_request(self, rng: np.random.Generator, cat: Catalog) -> int:
        if self._genre < 0:                       # first request
            g = rng.choice(G_GENRES, p=self.genre_pref)
            f = self._zipf_request(rng, cat, g)
        elif rng.uniform() <= self.eps:           # exploit: similar content
            g = self._genre
            lo = g * FILES_PER_GENRE
            members = np.arange(lo, lo + FILES_PER_GENRE)
            members = members[members != self._file]
            sims = cat.cos_sim[self._file, members]
            probs = np.exp(sims - sims.max())
            probs /= probs.sum()
            order = np.argsort(-probs)[:self.topk]
            p_top = probs[order] / probs[order].sum()
            f = int(members[order[rng.choice(len(order), p=p_top)]])
        else:                                     # explore: new genre
            others = [gg for gg in range(G_GENRES) if gg != self._genre]
            pref = self.genre_pref[others]
            pref = pref / pref.sum()
            g = int(others[rng.choice(len(others), p=pref)])
            f = self._zipf_request(rng, cat, g)
        self._genre, self._file = f // FILES_PER_GENRE, f
        return f


def genre_feature(genre: int) -> np.ndarray:
    return np.full((GENRE_FEAT_DIM,), float(genre), np.float32)


def dataset1_sample(cat: Catalog, user: UserModel, fid: int) -> np.ndarray:
    """3168-dim Dataset-1 feature vector for one request."""
    g = fid // FILES_PER_GENRE
    lo = g * FILES_PER_GENRE
    sims = cat.cos_sim[fid, lo:lo + FILES_PER_GENRE].astype(np.float32)
    return np.concatenate([
        cat.features[fid] / 50.0,                # scale down raw features
        user.genre_pref.astype(np.float32),
        sims,
        genre_feature(g) / G_GENRES,
        np.array([user.eps], np.float32),
    ])


D1_DIM = FEAT_DIM + G_GENRES + FILES_PER_GENRE + GENRE_FEAT_DIM + 1  # 3168


@dataclass
class RequestStream:
    """Stateful per-user request stream producing (feature, label) pairs with
    the paper's sliding-window construction: sample i = (x_{i-1}, y_i)."""
    cat: Catalog
    user: UserModel
    rng: np.random.Generator
    _last_feat: Optional[np.ndarray] = None
    _history: List[int] = field(default_factory=list)

    def draw_dataset1(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        xs, ys = [], []
        while len(xs) < n:
            fid = self.user.next_request(self.rng, self.cat)
            feat = dataset1_sample(self.cat, self.user, fid)
            if self._last_feat is not None:
                xs.append(self._last_feat)
                ys.append(fid)
            self._last_feat = feat
        return np.stack(xs), np.array(ys, np.int64)

    def draw_dataset2(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        xs, ys = [], []
        while len(xs) < n:
            fid = self.user.next_request(self.rng, self.cat)
            self._history.append(fid)
            if len(self._history) > SEQ_LEN:
                xs.append(np.array(self._history[-SEQ_LEN - 1:-1], np.int64))
                ys.append(fid)
        return np.stack(xs), np.array(ys, np.int64)

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """Everything a draw mutates: the stream's Generator position, the
        sliding-window feature/history carry and the user's Markov state
        (the reference's keys). The catalog and the static user fields are
        rebuilt from the population seed. Only the last SEQ_LEN+1 history
        entries are ever read by a draw, so only those are kept."""
        from repro_torch.checkpoint.run_state import generator_state
        return {"rng": generator_state(self.rng),
                "last_feat": self._last_feat,
                "history": [int(h) for h in self._history[-SEQ_LEN - 1:]],
                "genre": int(self.user._genre),
                "file": int(self.user._file)}

    def load_state_dict(self, sd: dict) -> None:
        from repro_torch.checkpoint.run_state import set_generator_state
        set_generator_state(self.rng, sd["rng"])
        lf = sd["last_feat"]
        self._last_feat = None if lf is None else np.asarray(lf, np.float32)
        self._history = [int(h) for h in sd["history"]]
        self.user._genre = int(sd["genre"])
        self.user._file = int(sd["file"])


def make_population(seed: int, num_users: int, topk: int = 1
                    ) -> Tuple[Catalog, List[RequestStream]]:
    rng = np.random.default_rng(seed)
    cat = Catalog.create(rng)
    streams = [RequestStream(cat, UserModel.create(rng, topk),
                             np.random.default_rng(seed * 977 + u + 1))
               for u in range(num_users)]
    return cat, streams
