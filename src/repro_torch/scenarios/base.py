"""Composable wireless-world scenarios (``repro/scenarios/base.py``; numpy
only, a copy of the reference's so that the port imports nothing of it).

A scenario is a pure, seeded schedule of per-round perturbations that the
stacked harness (``repro_torch/harness/experiments.py``) applies at
explicit hook points:

  * setup hooks (once, before round 0): the per-client storage capacities
    (``init_capacities``) and the static resource rows ``f_max``,
    ``p_max``, distances (``init_system``);
  * round hooks (every round t): the arrival process (``arrivals``: E_u
    and p_ac, e.g. flash crowds), the round's resource rows (``system``:
    e.g. a cell-radius step), client availability (``available``: churn),
    the participation-sampling bias (``selection_weights``) and, on
    hierarchical runs, cluster membership moves (``cluster_moves``).

Every hook draws from a ``np.random.Generator`` derived only from (scenario
seed, hook id, round, perturbation index), never from the harness's host
RNG, and keeps no state across rounds outside ``bind`` (re-run identically
at resume). So a round's perturbations are a pure function of (spec, seed,
t), checkpoints need no scenario state, and a hook that does not fire
returns ``None`` and leaves the harness's own path untouched: the empty
scenario ``"null"`` is bit for bit the run without one.

Scenarios compose with ``+``: arrival, system and capacity transforms
chain, availability masks AND, selection weights multiply, cluster moves
concatenate. The named perturbations are in ``scenarios/library.py``.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

# hook ids salting the per-(round, hook) RNG streams — stable across versions
# or the reference's streams and the port's part ways
_H_BIND = 0
_H_CAPS = 1
_H_SYS0 = 2
_H_ARRIVALS = 3
_H_SYSTEM = 4
_H_AVAILABLE = 5
_H_SELECT = 6
_H_CLUSTER = 7
_SALT = 0x05AF1


class Perturbation:
    """One composable wireless-world perturbation. Every hook defaults to
    "does not fire" (``None``); subclasses override a subset. Hooks must be
    pure in the supplied ``rng`` (see module docstring)."""

    #: registry key; set by ``scenarios.library.register``
    name: str = "perturbation"
    #: integer factor by which the scenario can inflate a round's arrival
    #: count above the base E_u — sizes the staging width, fixed at setup
    arrival_width_scale: int = 1

    def bind(self, rng: np.random.Generator, num_users: int) -> None:
        """One-time per-run draws (per-user phases, class assignment, ...).
        Re-run identically at resume; only ``rng``/``num_users`` may feed
        the cached state."""

    # -- setup hooks --------------------------------------------------------
    def init_capacities(self, rng, caps: np.ndarray) -> Optional[np.ndarray]:
        """Transform the per-client FIFO capacities D_u. None = unchanged."""
        return None

    def init_system(self, rng, sysb) -> Optional[object]:
        """Transform the static ``ClientSystemBatch`` rows. None = unchanged."""
        return None

    # -- round hooks --------------------------------------------------------
    def arrivals(self, rng, t: int, e_u, p_ac: np.ndarray
                 ) -> Optional[Tuple[object, np.ndarray]]:
        """Transform the round's arrival process ``(E_u, p_ac)``; ``e_u`` may
        be a scalar or per-client array. None = unchanged."""
        return None

    def system(self, rng, t: int, sysb) -> Optional[object]:
        """Transform this round's ``ClientSystemBatch``. None = unchanged."""
        return None

    def available(self, rng, t: int, num_users: int) -> Optional[np.ndarray]:
        """(U,) bool availability mask (False = departed this round).
        None = everyone available."""
        return None

    def selection_weights(self, rng, t: int, num_users: int
                          ) -> Optional[np.ndarray]:
        """(U,) nonnegative participation-sampling weights. None = uniform."""
        return None

    def cluster_moves(self, rng, t: int, num_users: int, num_clusters: int
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Edge-cluster membership churn for round t (hierarchical runs
        only): ``(users, dest_clusters)`` reassignments, or None = the
        cluster map is unchanged this round."""
        return None

    def __repr__(self):
        return f"{type(self).__name__}()"


class Scenario:
    """An ordered composition of perturbations under one seed (see module
    docstring for the purity/composition contract). Harness-facing: the
    ``setup_*``/``round_*`` methods apply every perturbation in order and
    return ``None`` when no perturbation fired, so the caller can keep its
    unscenarioed code path untouched."""

    def __init__(self, perturbations: Sequence[Perturbation] = (),
                 seed: int = 0, spec: str = "null"):
        self.perturbations: Tuple[Perturbation, ...] = tuple(perturbations)
        self.seed = int(seed)
        self.spec = spec
        self._bound_users: Optional[int] = None

    @property
    def is_null(self) -> bool:
        return not self.perturbations

    def __repr__(self):
        return f"Scenario({self.spec!r}, seed={self.seed})"

    # -- pure RNG derivation -------------------------------------------------
    def _rng(self, hook: int, t: int, i: int) -> np.random.Generator:
        """Generator for (hook, round, perturbation-index) — pure in the
        scenario seed; the harness host RNG is never consumed."""
        return np.random.default_rng([_SALT, self.seed, hook, t, i])

    # -- binding -------------------------------------------------------------
    def bind(self, num_users: int) -> "Scenario":
        """Run every perturbation's one-time draws for a U-user population.
        Idempotent for a fixed U (resume calls it again)."""
        if self._bound_users not in (None, int(num_users)):
            raise ValueError(
                f"scenario already bound to U={self._bound_users}, "
                f"cannot rebind to U={num_users}")
        for i, p in enumerate(self.perturbations):
            p.bind(self._rng(_H_BIND, 0, i), int(num_users))
        self._bound_users = int(num_users)
        return self

    def _check_bound(self):
        if self.perturbations and self._bound_users is None:
            raise RuntimeError(
                "scenario hooks called before bind(num_users)")

    # -- setup hooks ---------------------------------------------------------
    def arrival_width(self, base: int) -> int:
        """Static staging width covering every round's worst-case arrivals."""
        w = int(base)
        for p in self.perturbations:
            w *= int(p.arrival_width_scale)
        return w

    def setup_capacities(self, caps: np.ndarray) -> np.ndarray:
        self._check_bound()
        for i, p in enumerate(self.perturbations):
            out = p.init_capacities(self._rng(_H_CAPS, 0, i), caps)
            if out is not None:
                caps = np.asarray(out)
        return caps

    def setup_system(self, sysb):
        self._check_bound()
        for i, p in enumerate(self.perturbations):
            out = p.init_system(self._rng(_H_SYS0, 0, i), sysb)
            if out is not None:
                sysb = out
        return sysb

    # -- round hooks ---------------------------------------------------------
    def round_arrivals(self, t: int, e_u, p_ac: np.ndarray):
        """(E_u, p_ac) for round t — the inputs unchanged (same objects)
        when no perturbation fires."""
        self._check_bound()
        for i, p in enumerate(self.perturbations):
            out = p.arrivals(self._rng(_H_ARRIVALS, t, i), t, e_u, p_ac)
            if out is not None:
                e_u, p_ac = out
        return e_u, p_ac

    def round_system(self, t: int, sysb):
        self._check_bound()
        for i, p in enumerate(self.perturbations):
            out = p.system(self._rng(_H_SYSTEM, t, i), t, sysb)
            if out is not None:
                sysb = out
        return sysb

    def round_available(self, t: int, num_users: int) -> Optional[np.ndarray]:
        """AND of every perturbation's availability mask; None if none fired."""
        self._check_bound()
        mask = None
        for i, p in enumerate(self.perturbations):
            out = p.available(self._rng(_H_AVAILABLE, t, i), t, num_users)
            if out is not None:
                out = np.asarray(out, bool)
                mask = out if mask is None else (mask & out)
        return mask

    def round_selection_weights(self, t: int, num_users: int
                                ) -> Optional[np.ndarray]:
        """Product of every perturbation's selection weights; None if none
        fired."""
        self._check_bound()
        w = None
        for i, p in enumerate(self.perturbations):
            out = p.selection_weights(self._rng(_H_SELECT, t, i), t,
                                      num_users)
            if out is not None:
                out = np.asarray(out, np.float64)
                if (out < 0).any():
                    raise ValueError(
                        f"{p.name}: selection weights must be nonnegative")
                w = out if w is None else (w * out)
        return w

    @property
    def moves_clusters(self) -> bool:
        """True when any perturbation can rewrite the cluster map — the
        hierarchical harness only runs the churn hook (and the admission
        resets it implies) when this is set, keeping static-map runs on the
        unperturbed path."""
        return any(getattr(p, "moves_clusters", False)
                   for p in self.perturbations)

    def round_cluster_moves(self, t: int, num_users: int, num_clusters: int
                            ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Concatenation of every perturbation's cluster reassignments (in
        composition order — later terms win on a user moved twice, matching
        sequential application); None if none fired."""
        self._check_bound()
        users, dest = None, None
        for i, p in enumerate(self.perturbations):
            out = p.cluster_moves(self._rng(_H_CLUSTER, t, i), t,
                                  num_users, num_clusters)
            if out is not None:
                u = np.asarray(out[0], np.int64)
                d = np.asarray(out[1], np.int64)
                users = u if users is None else np.concatenate([users, u])
                dest = d if dest is None else np.concatenate([dest, d])
        if users is None:
            return None
        return users, dest


# ---------------------------------------------------------------------------
# spec DSL:  name(k=v, ...) + name2(...) + ...   |  "null"  |  ""
# ---------------------------------------------------------------------------

_TERM = re.compile(r"^\s*([a-z_][a-z0-9_]*)\s*(?:\((.*)\))?\s*$", re.S)


def _parse_kwargs(body: str, term: str) -> dict:
    if not body or not body.strip():
        return {}
    kwargs = {}
    for part in body.split(","):
        if not part.strip():
            continue
        if "=" not in part:
            raise ValueError(
                f"scenario term {term!r}: arguments must be k=v pairs "
                f"(got {part.strip()!r})")
        k, v = part.split("=", 1)
        try:
            kwargs[k.strip()] = ast.literal_eval(v.strip())
        except (ValueError, SyntaxError) as e:
            raise ValueError(
                f"scenario term {term!r}: cannot parse value {v.strip()!r} "
                f"for {k.strip()!r}") from e
    return kwargs


def parse_scenario(spec: Optional[str], seed: int = 0) -> Optional[Scenario]:
    """Parse a scenario spec string into a ``Scenario``.

    ``""``/None -> ``None`` (no scenario — the harness takes its historical
    code path with no scenario plumbing at all). ``"null"`` -> the empty
    scenario (same trajectory, but routed through the hook plumbing — the
    parity probe). Otherwise ``+``-separated registry terms, e.g.
    ``"churn(p_away=0.3)+flash_crowd(period=8,scale=3)"``; constructor
    kwargs are Python literals. ``seed`` feeds every scenario RNG stream
    (the harnesses pass the experiment seed).
    """
    if not spec:
        return None
    spec = spec.strip()
    if spec == "null":
        return Scenario((), seed=seed, spec="null")
    from repro_torch.scenarios.library import REGISTRY
    perts: List[Perturbation] = []
    for term in spec.split("+"):
        m = _TERM.match(term)
        if not m:
            raise ValueError(f"malformed scenario term {term!r} in {spec!r}")
        name, body = m.group(1), m.group(2)
        if name == "null":
            raise ValueError(
                "'null' cannot be composed with other scenario terms")
        if name not in REGISTRY:
            raise ValueError(
                f"unknown scenario {name!r} (known: "
                + ", ".join(sorted(REGISTRY)) + ")")
        try:
            perts.append(REGISTRY[name](**_parse_kwargs(body, term)))
        except TypeError as e:
            raise ValueError(f"scenario term {term.strip()!r}: {e}") from e
    return Scenario(perts, seed=seed, spec=spec)
