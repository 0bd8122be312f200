"""The named wireless-world perturbations (``repro/scenarios/library.py``,
copied): client churn, flash-crowd request spikes, quiet hours, a
cell-radius step, heterogeneous device classes (Han et al., 2308.03521),
edge-cluster membership churn and Pareto-biased partial participation
(Dinh et al., 1910.13067). Specs compose with ``+``:

    churn(p_away=0.3)+flash_crowd(period=8,scale=3)

Each hook draws the same numbers as the reference's for the same seed,
round and population (``tests/test_torch_scenarios.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Type

import numpy as np

from repro_torch.scenarios.base import Perturbation

REGISTRY: Dict[str, Type[Perturbation]] = {}


def register(name: str):
    def deco(cls):
        cls.name = name
        REGISTRY[name] = cls
        return cls
    return deco


@register("churn")
class Churn(Perturbation):
    """Client departures/rejoins on a per-user duty cycle.

    A ``p_away`` fraction of users (drawn at bind) churns: each cycles
    through a ``period``-round window with a private phase and an away span
    of ``away`` rounds per cycle, during which the user is unavailable — it
    generates no arrivals, cannot be sampled round-active, and is masked out
    of aggregation. The schedule is pure in (seed, t), so departures and
    rejoins replay identically across engines and resume."""

    def __init__(self, p_away: float = 0.3, period: int = 6, away: int = 2):
        if not 0.0 <= p_away <= 1.0:
            raise ValueError(f"p_away must lie in [0, 1] (got {p_away})")
        if period < 2 or not 1 <= away < period:
            raise ValueError(
                f"need period >= 2 and 1 <= away < period "
                f"(got period={period}, away={away})")
        self.p_away = float(p_away)
        self.period = int(period)
        self.away = int(away)

    def bind(self, rng, num_users):
        self._churns = rng.random(num_users) < self.p_away
        self._phase = rng.integers(0, self.period, num_users)

    def available(self, rng, t, num_users):
        pos = (t + self._phase) % self.period
        return ~(self._churns & (pos < self.away))


@register("flash_crowd")
class FlashCrowd(Perturbation):
    """Request spikes: every ``period`` rounds the Binomial arrival budget
    E_u is multiplied by ``scale`` for ``duty`` consecutive rounds (the
    staging width is sized by ``scale`` at setup). Off-spike rounds are
    untouched."""

    def __init__(self, period: int = 8, duty: int = 2, scale: int = 3):
        if period < 1 or not 1 <= duty <= period:
            raise ValueError(
                f"need period >= 1 and 1 <= duty <= period "
                f"(got period={period}, duty={duty})")
        if int(scale) != scale or scale < 1:
            raise ValueError(f"scale must be an integer >= 1 (got {scale})")
        self.period = int(period)
        self.duty = int(duty)
        self.scale = int(scale)
        self.arrival_width_scale = int(scale)

    def arrivals(self, rng, t, e_u, p_ac):
        if t % self.period >= self.duty:
            return None
        return np.multiply(e_u, self.scale), p_ac


@register("quiet")
class Quiet(Perturbation):
    """Constant arrival-rate damping: every user's activity probability
    p_ac is scaled by ``scale`` in [0, 1]. ``quiet(scale=0.0)`` freezes the
    datasets entirely — the static-world half of Fig. 1."""

    def __init__(self, scale: float = 0.5):
        if not 0.0 <= scale <= 1.0:
            raise ValueError(f"scale must lie in [0, 1] (got {scale})")
        self.scale = float(scale)

    def arrivals(self, rng, t, e_u, p_ac):
        return e_u, np.asarray(p_ac) * self.scale


@register("radius_step")
class RadiusStep(Perturbation):
    """Non-stationary channel regime: from round ``at`` on, every client's
    distance to the BS is multiplied by ``factor`` (a cell-radius step —
    e.g. ``factor≈1.67`` turns the default 600 m cell into Fig. 3's 1 km
    straggler regime mid-run). Compose two steps for a step-up/step-down
    schedule."""

    def __init__(self, at: int = 0, factor: float = 2.0):
        if at < 0:
            raise ValueError(f"at must be >= 0 (got {at})")
        if not (math.isfinite(factor) and factor > 0):
            raise ValueError(f"factor must be finite and > 0 (got {factor})")
        self.at = int(at)
        self.factor = float(factor)

    def system(self, rng, t, sysb):
        if t < self.at:
            return None
        return dataclasses.replace(sysb,
                                   distance=sysb.distance * self.factor)


@register("device_classes")
class DeviceClasses(Perturbation):
    """Heterogeneous device classes: a ``weak_frac`` fraction of users
    (drawn at bind) is a *weak* class whose compute ceiling ``f_max``,
    transmit ceiling ``p_max`` and FIFO storage capacity D_u are scaled by
    ``f``/``p``/``cap`` (the heterogeneity axes of Han et al., 2308.03521).
    Static — applied once at setup to the resource-config rows and buffer
    capacities."""

    def __init__(self, weak_frac: float = 0.5, f: float = 0.5,
                 p: float = 0.5, cap: float = 0.5):
        if not 0.0 <= weak_frac <= 1.0:
            raise ValueError(
                f"weak_frac must lie in [0, 1] (got {weak_frac})")
        for name, v in (("f", f), ("p", p), ("cap", cap)):
            if not 0.0 < v <= 1.0:
                raise ValueError(f"{name} must lie in (0, 1] (got {v})")
        self.weak_frac = float(weak_frac)
        self.f = float(f)
        self.p = float(p)
        self.cap = float(cap)

    def bind(self, rng, num_users):
        self._weak = rng.random(num_users) < self.weak_frac

    def init_capacities(self, rng, caps):
        scale = np.where(self._weak[:len(caps)], self.cap, 1.0)
        return np.maximum((caps * scale).astype(caps.dtype), 4)

    def init_system(self, rng, sysb):
        w = self._weak[:len(sysb.f_max)]
        return dataclasses.replace(
            sysb,
            f_max=sysb.f_max * np.where(w, self.f, 1.0),
            p_max=sysb.p_max * np.where(w, self.p, 1.0))


@register("cluster_churn")
class ClusterChurn(Perturbation):
    """Edge-cluster membership churn (hierarchical runs, ``num_clusters``
    > 1): every ``period`` rounds an expected ``rate`` fraction of users is
    reassigned to a uniformly drawn cluster (a same-cluster draw is a
    no-op — real handovers are a subset of draws). Movers that are
    slot-resident migrate blocks immediately: carried score tables follow
    them, slot-resident contribution rows and FIFO datasets reset (see
    ``core/hierarchy.py``). Pure in (seed, t) like every hook, so the live
    cluster map at round t replays identically across resume. No effect on
    flat or K=1 runs (the hook returns None)."""

    moves_clusters = True

    def __init__(self, rate: float = 0.05, period: int = 1):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must lie in [0, 1] (got {rate})")
        if period < 1:
            raise ValueError(f"period must be >= 1 (got {period})")
        self.rate = float(rate)
        self.period = int(period)

    def cluster_moves(self, rng, t, num_users, num_clusters):
        if num_clusters <= 1 or t % self.period:
            return None
        users = np.flatnonzero(rng.random(num_users) < self.rate)
        if users.size == 0:
            return None
        dest = rng.integers(0, num_clusters, users.size)
        return users, dest


@register("pareto_select")
class ParetoSelect(Perturbation):
    """Pareto-biased client selection (SNIPPETS.md Snippet 1): per-user
    participation-sampling weights drawn once from a Pareto(``alpha``)
    distribution, so a heavy-tailed few are sampled round-active far more
    often. Requires the slot-pool engine's participation sampling
    (``cohort_size`` > 0, ``participation`` < 1) to have an effect — on the
    dense path every client already participates."""

    def __init__(self, alpha: float = 1.5):
        if not (math.isfinite(alpha) and alpha > 0):
            raise ValueError(f"alpha must be finite and > 0 (got {alpha})")
        self.alpha = float(alpha)

    def bind(self, rng, num_users):
        self._w = rng.pareto(self.alpha, num_users) + 1.0

    def selection_weights(self, rng, t, num_users):
        return self._w
