"""Host-side bridge from the per-user request streams to the stacked online
pipeline (``request_backend="python"``): arrival samples are drawn per user
from ``video_caching.RequestStream`` and packed into the (U, A, ...) layout
that ``StackedOnlineBuffer.stage`` takes. Arrival counts are the paper's
Binomial(E_u, p_ac). A numpy copy of ``repro/data/online.py``. With
``request_backend="stacked"`` the samples come in this layout from
``video_caching_stacked.StackedRequestStream`` instead.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.video_caching import D1_DIM, SEQ_LEN, RequestStream


def dataset_layout(dataset: int) -> Tuple[tuple, type]:
    """(feature_shape, feature_dtype) of the two paper datasets."""
    if dataset == 1:
        return (D1_DIM,), np.float32
    return (SEQ_LEN,), np.int64


def binomial_arrivals_batched(rng: np.random.Generator, e_u: int,
                              p_ac: np.ndarray) -> np.ndarray:
    """(U,) new-sample counts between two rounds: Binomial(E_u, p_ac_u)."""
    return rng.binomial(e_u, np.asarray(p_ac))


def pad_arrival_batch(samples: Sequence[Optional[Tuple[np.ndarray,
                                                       np.ndarray]]],
                      width: int, dataset: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack per-client (x_u, y_u) pairs (or None) into padded (U, width, ...)
    feature/label arrays plus the (U,) valid-prefix counts."""
    feat, dtype = dataset_layout(dataset)
    U = len(samples)
    xs = np.zeros((U, width) + feat, dtype)
    ys = np.zeros((U, width), np.int64)
    counts = np.zeros(U, np.int32)
    for u, sample in enumerate(samples):
        if sample is None:
            continue
        x, y = sample
        n = len(y)
        if n > width:
            raise ValueError(f"client {u}: {n} arrivals > pad width {width}")
        xs[u, :n], ys[u, :n], counts[u] = x, y, n
    return xs, ys, counts


def draw_arrival_batch(streams: List[RequestStream], counts: np.ndarray,
                       dataset: int, width: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Draw ``counts[u]`` fresh requests from every client's stream and pad
    to ``width`` (default: the largest count)."""
    counts = np.asarray(counts)
    samples = [
        (s.draw_dataset1(int(n)) if dataset == 1 else s.draw_dataset2(int(n)))
        if n else None
        for s, n in zip(streams, counts)]
    return pad_arrival_batch(samples, int(width or max(counts.max(), 1)),
                             dataset)


def streams_state_dict(streams: List[RequestStream]) -> list:
    """Cohort snapshot of every per-user request stream (Generator
    positions and sliding-window carries), for the RunState checkpoint."""
    return [s.state_dict() for s in streams]


def load_streams_state(streams: List[RequestStream], states: list) -> None:
    """Restore a ``streams_state_dict`` snapshot onto a freshly built
    population (same seed; only the mutable state is overwritten)."""
    from repro_torch.checkpoint.run_state import CheckpointError
    if len(states) != len(streams):
        raise CheckpointError(
            f"snapshot holds {len(states)} request streams, the live cohort "
            f"has {len(streams)}")
    for s, sd in zip(streams, states):
        s.load_state_dict(sd)
