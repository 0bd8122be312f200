"""Time-varying FIFO client datasets (paper Section II-A), one client at a
time on the host (``repro/core/buffer.py``).

Each client stores at most D_u samples. Between global rounds up to E_u new
samples arrive; each of the E_u arrival slots is an independent
Bernoulli(p_ac) trial, so the number of arrivals is Binomial(E_u, p_ac).
Arrivals are staged and the dataset is updated once, FIFO, right before the
next round. The centralized genie pools these buffers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass
class OnlineBuffer:
    capacity: int                     # D_u
    x: np.ndarray                     # (capacity, ...) feature storage
    y: np.ndarray                     # (capacity,) labels
    num_classes: int = 0
    size: int = 0
    head: int = 0                     # FIFO eviction pointer (oldest sample)
    _staged_x: list = field(default_factory=list)
    _staged_y: list = field(default_factory=list)
    last_hist: Optional[np.ndarray] = None

    @classmethod
    def create(cls, capacity: int, feature_shape: tuple, num_classes: int,
               dtype=np.float32, label_dtype=np.int64) -> "OnlineBuffer":
        return cls(capacity=capacity,
                   x=np.zeros((capacity,) + tuple(feature_shape), dtype),
                   y=np.zeros((capacity,), label_dtype),
                   num_classes=num_classes)

    # -- staging (within-round arrivals go to the temp buffer) --------------
    def stage(self, x_new: np.ndarray, y_new: np.ndarray) -> None:
        for xi, yi in zip(x_new, y_new):
            self._staged_x.append(xi)
            self._staged_y.append(yi)

    def commit(self) -> int:
        """Apply staged arrivals FIFO at the round boundary. Returns
        #ingested."""
        n = len(self._staged_x)
        for xi, yi in zip(self._staged_x, self._staged_y):
            self._insert(xi, yi)
        self._staged_x, self._staged_y = [], []
        return n

    def _insert(self, xi, yi) -> None:
        if self.size < self.capacity:
            idx = (self.head + self.size) % self.capacity
            self.size += 1
        else:
            idx = self.head                       # overwrite oldest
            self.head = (self.head + 1) % self.capacity
        self.x[idx] = xi
        self.y[idx] = yi

    # -- views ---------------------------------------------------------------
    def dataset(self) -> Tuple[np.ndarray, np.ndarray]:
        idx = (self.head + np.arange(self.size)) % self.capacity
        return self.x[idx], self.y[idx]

    def label_histogram(self) -> np.ndarray:
        _, y = self.dataset()
        h = np.bincount(y, minlength=self.num_classes).astype(np.float64)
        return h / max(h.sum(), 1)

    def distribution_shift(self) -> float:
        """Empirical proxy for Phi_u^t (Definition 1): squared L2 distance
        between the label distributions of consecutive rounds."""
        h = self.label_histogram()
        shift = (0.0 if self.last_hist is None
                 else float(np.sum((h - self.last_hist) ** 2)))
        self.last_hist = h
        return shift

    def sample_batch(self, rng: np.random.Generator, batch: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        x, y = self.dataset()
        idx = rng.integers(0, len(y), size=batch)
        return x[idx], y[idx]

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """Full snapshot under the reference's keys: storage, FIFO pointers,
        staged-but-uncommitted arrivals and the shift-proxy memory."""
        feat = self.x.shape[1:]
        return {
            "capacity": int(self.capacity),
            "x": self.x, "y": self.y,
            "size": int(self.size), "head": int(self.head),
            "staged_x": (np.stack(self._staged_x).astype(self.x.dtype)
                         if self._staged_x
                         else np.zeros((0,) + feat, self.x.dtype)),
            "staged_y": np.asarray(self._staged_y, self.y.dtype),
            "num_classes": int(self.num_classes),
            "last_hist": self.last_hist,
        }

    def load_state_dict(self, sd: dict) -> None:
        """Restore a ``state_dict`` snapshot (full overwrite)."""
        self.capacity = int(sd["capacity"])
        self.x = np.array(sd["x"])
        self.y = np.array(sd["y"])
        self.size = int(sd["size"])
        self.head = int(sd["head"])
        self._staged_x = [np.array(r) for r in sd["staged_x"]]
        self._staged_y = list(np.asarray(sd["staged_y"]))
        self.num_classes = int(sd["num_classes"])
        lh = sd["last_hist"]
        self.last_hist = None if lh is None else np.asarray(lh)


def binomial_arrivals(rng: np.random.Generator, e_u: int, p_ac: float) -> int:
    """Number of new samples between two rounds: Binomial(E_u, p_ac)."""
    return int(rng.binomial(e_u, p_ac))
