"""The experiment-configuration compatibility matrix.

``RULES`` is the reference's matrix (``repro/harness/compat.py``), copied
rule for rule in its order. ``PORT_RULES`` then rejects, in the same
uniform form, what the port does not run yet: the pod engine, the fused
round and a mesh. ``resolve()`` evaluates both lists in order and
raises on the first match:

    invalid experiment configuration [rule-key]: why
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

ENGINES = ("auto", "loop", "stacked", "pod", "centralized")
POD_ENGINES = ("exact_tp", "recompute", "stale", "fedavg")
ALL_ALGS = ("osafl", "fedavg", "fedprox", "fednova", "afa_cd", "feddisco")

_ENGINE_NOUN = {"loop": "the loop oracle (run_experiment)",
                "centralized": "the centralized genie (run_centralized_sgd)"}


class ExperimentConfigError(ValueError):
    """An ``ExperimentConfig``/algorithm combination outside the implemented
    grid, named by the matrix rule that rejected it."""

    def __init__(self, key: str, why: str):
        self.key = key
        super().__init__(f"invalid experiment configuration [{key}]: {why}")


@dataclasses.dataclass(frozen=True)
class ResolvedPlan:
    """The validated engine/backend combination a run will execute.
    ``scn`` is the parsed (unbound) scenario, carried so callers do not
    parse it again; plans compare without it."""
    alg: str
    engine: str                 # loop | stacked | pod | centralized (resolved)
    request_backend: str
    round_backend: str
    resource_backend: str
    pod_engine: Optional[str]   # pod engine flavor; None off the pod path
    cohort_size: int
    participation: float
    num_clusters: int
    num_clients: int
    scenario: str
    mesh: bool = False          # a mesh was passed
    scn: object = dataclasses.field(repr=False, compare=False, default=None)

    def describe(self) -> str:
        """One log line naming the resolved combination — the smoke tools
        and ``launch/dryrun.py --online`` print it so a CI failure names the
        lane's actual configuration."""
        bits = [f"engine={self.engine}"]
        if self.pod_engine:
            bits.append(f"pod_engine={self.pod_engine}")
        bits += [f"alg={self.alg}",
                 f"request={self.request_backend}",
                 f"round={self.round_backend}",
                 f"resource={self.resource_backend}"]
        if self.cohort_size:
            bits.append(f"cohort={self.cohort_size}/{self.num_clients}")
        if self.participation != 1.0:
            bits.append(f"participation={self.participation}")
        if self.num_clusters:
            bits.append(f"clusters={self.num_clusters}")
        if self.scenario:
            bits.append(f"scenario={self.scenario!r}")
        return " ".join(bits)


class Rule(NamedTuple):
    key: str
    bad: Callable[["ResolvedPlan"], bool]     # True = reject
    why: Callable[["ResolvedPlan"], str]


def _oracle(p: ResolvedPlan) -> str:
    return _ENGINE_NOUN.get(p.engine, p.engine)


#: The compatibility matrix, in rejection-priority order. Evaluated against
#: the *resolved* plan (engine "auto" already picked), first match raises.
RULES = (
    Rule("engine",
         lambda p: p.engine not in ENGINES[1:],
         lambda p: f"unknown engine {p.engine!r} "
                   f"(expected one of {ENGINES[1:]})"),
    Rule("algorithm",
         lambda p: p.engine != "centralized" and p.alg not in ALL_ALGS,
         lambda p: f"unknown algorithm {p.alg!r} "
                   f"(expected one of {ALL_ALGS})"),
    Rule("request-backend",
         lambda p: p.request_backend not in ("python", "stacked"),
         lambda p: f"unknown request_backend {p.request_backend!r} "
                   "(expected 'python' or 'stacked')"),
    Rule("round-backend",
         lambda p: p.round_backend not in ("dispatch", "fused"),
         lambda p: f"unknown round_backend {p.round_backend!r} "
                   "(expected 'dispatch' or 'fused')"),
    Rule("resource-backend",
         lambda p: p.resource_backend not in ("x64", "f32"),
         lambda p: f"unknown resource backend {p.resource_backend!r} "
                   "(expected 'x64' or 'f32')"),
    Rule("pod-engine",
         lambda p: p.engine == "pod" and p.pod_engine not in POD_ENGINES,
         lambda p: f"unknown pod_engine {p.pod_engine!r} "
                   f"(expected one of {POD_ENGINES})"),
    Rule("cohort-size",
         lambda p: p.cohort_size
         and not 1 <= p.cohort_size <= p.num_clients,
         lambda p: f"cohort_size must satisfy 1 <= C <= num_clients "
                   f"(got C={p.cohort_size}, "
                   f"num_clients={p.num_clients})"),
    Rule("participation",
         lambda p: not 0.0 < p.participation <= 1.0,
         lambda p: f"participation must lie in (0, 1] "
                   f"(got {p.participation})"),
    Rule("participation-pool",
         lambda p: p.participation < 1.0 and not p.cohort_size,
         lambda p: "participation sampling needs the slot-pool engine: set "
                   "cohort_size (cohort_size=num_clients keeps every user "
                   "resident and only samples the round-active subset)"),
    Rule("num-clusters",
         lambda p: p.num_clusters < 0,
         lambda p: f"num_clusters must be >= 0 (got {p.num_clusters})"),
    Rule("oracle-requests",
         lambda p: p.engine in ("loop", "centralized")
         and p.request_backend != "python",
         lambda p: f"{_oracle(p)} draws from the per-client oracle streams "
                   "and only supports request_backend='python'; the stacked "
                   "Gumbel sampler needs the stacked or pod engine "
                   f"(got {p.request_backend!r})"),
    Rule("oracle-cohort",
         lambda p: p.engine == "loop" and p.cohort_size > 0,
         lambda p: f"{_oracle(p)} is the dense per-client oracle; the "
                   "sparse slot-pool engine (cohort_size/participation) "
                   "needs the stacked or pod engine"),
    Rule("fused-engine",
         lambda p: p.round_backend == "fused" and p.engine != "stacked",
         lambda p: "the fused one-dispatch round runs on the stacked "
                   "engine only; the loop and pod harnesses need "
                   f"round_backend='dispatch' (got engine={p.engine!r})"),
    Rule("rounds-per-dispatch", lambda p: False, lambda p: ""),  # run-time
    Rule("fused-alg",
         lambda p: p.round_backend == "fused" and p.alg != "osafl",
         lambda p: "the fused round implements the OSAFL scored round only "
                   f"(got algorithm={p.alg!r}); run other algorithms with "
                   "round_backend='dispatch'"),
    Rule("fused-requests",
         lambda p: p.round_backend == "fused"
         and p.request_backend != "stacked",
         lambda p: "the fused round draws requests with the stacked Gumbel "
                   "sampler; set request_backend='stacked' "
                   f"(got {p.request_backend!r})"),
    Rule("fused-cohort",
         lambda p: p.round_backend == "fused" and p.cohort_size > 0,
         lambda p: "the fused round is dense-only; run cohort_size>0 with "
                   "round_backend='dispatch' (see core/round_fused.py and "
                   "the ROADMAP hierarchical-aggregation follow-up)"),
    Rule("fused-hierarchy",
         lambda p: p.round_backend == "fused" and p.num_clusters >= 1,
         lambda p: "the fused round aggregates single-tier; run "
                   "num_clusters>=1 with round_backend='dispatch' "
                   "(core/hierarchy.py)"),
    Rule("hier-engine",
         lambda p: p.num_clusters >= 1
         and p.engine in ("loop", "centralized"),
         lambda p: "num_clusters>=1 needs the stacked or pod engine (the "
                   "two-tier round bodies are stacked-buffer ops; got "
                   f"engine={p.engine!r})"),
    Rule("hier-population",
         lambda p: p.num_clusters >= 1
         and p.num_clients % p.num_clusters != 0,
         lambda p: f"num_clusters must divide num_clients (got "
                   f"K={p.num_clusters}, num_clients={p.num_clients}); "
                   "clusters are equal contiguous population blocks"),
    Rule("hier-cohort",
         lambda p: p.num_clusters >= 1 and p.cohort_size
         and p.cohort_size % p.num_clusters != 0,
         lambda p: f"num_clusters must divide cohort_size (got "
                   f"K={p.num_clusters}, C={p.cohort_size}); each cluster "
                   "owns an equal contiguous slot block"),
    Rule("scenario-engine",
         lambda p: p.scn is not None and not p.scn.is_null
         and p.engine in ("loop", "centralized"),
         lambda p: f"{_oracle(p)} does not apply scenario perturbations "
                   f"(got scenario={p.scenario!r}); run scenarios on the "
                   "stacked or pod engine with round_backend='dispatch'"),
    Rule("scenario-fused",
         lambda p: p.round_backend == "fused"
         and p.scn is not None and not p.scn.is_null,
         lambda p: "the fused round does not apply scenario perturbations "
                   f"(got scenario={p.scenario!r}); run scenarios with "
                   "round_backend='dispatch'"),
    Rule("cluster-churn",
         lambda p: p.scn is not None
         and getattr(p.scn, "moves_clusters", False)
         and p.num_clusters > 1 and not p.cohort_size,
         lambda p: "cluster membership churn needs the slot-pool engine: "
                   "set cohort_size>0 so a mover can re-seat in its new "
                   "cluster's slot block (the dense buffer has no "
                   "user->slot indirection)"),
)


def _not_ported(what: str) -> str:
    return (f"{what} is not ported to repro_torch yet (the port runs every "
            "algorithm on the stacked dispatch round, engine 'stacked' or "
            "'auto', with the sparse cohort, the cluster tier, scenarios and "
            "sketched scores, on the per-client loop oracle, engine 'loop', "
            "and the centralized genie: round_backend='dispatch', either "
            "request and resource backend, checkpoints, no mesh)")


#: What the port does not run yet, checked after ``RULES``.
PORT_RULES = (
    Rule("port-engine",
         lambda p: p.engine not in ("stacked", "loop", "centralized"),
         lambda p: _not_ported(f"engine={p.engine!r}")),
    Rule("port-round-backend",
         lambda p: p.round_backend != "dispatch",
         lambda p: _not_ported(f"round_backend={p.round_backend!r}")),
    Rule("port-mesh",
         lambda p: p.mesh,
         lambda p: _not_ported("a mesh")),
)


def resolve(alg: str, xc, mesh=None,
            pod_engine: Optional[str] = None) -> ResolvedPlan:
    """Validate ``(alg, xc)`` against ``RULES`` and ``PORT_RULES`` and
    return the resolved plan. ``engine="auto"`` resolves to ``"pod"`` when a
    mesh is passed and ``"stacked"`` otherwise (``alg="centralized"`` forces
    the genie). Raises ``ExperimentConfigError`` on the first matching
    rule; a malformed scenario spec raises ``ValueError`` first, as
    ``parse_scenario`` words it."""
    from repro_torch.scenarios import parse_scenario
    engine = xc.engine
    if engine == "auto":
        if alg == "centralized":
            engine = "centralized"
        else:
            engine = "pod" if mesh is not None else "stacked"
    scn = parse_scenario(xc.scenario, seed=xc.seed)
    plan = ResolvedPlan(
        alg=alg, engine=engine,
        request_backend=xc.request_backend,
        round_backend=xc.round_backend,
        resource_backend=xc.resource_backend,
        pod_engine=(pod_engine if pod_engine is not None
                    else getattr(xc, "pod_engine", "exact_tp"))
        if engine == "pod" else None,
        cohort_size=int(xc.cohort_size),
        participation=float(xc.participation),
        num_clusters=int(getattr(xc, "num_clusters", 0)),
        num_clients=int(xc.num_clients),
        scenario=xc.scenario, mesh=mesh is not None, scn=scn)
    for rule in RULES + PORT_RULES:
        if rule.key == "rounds-per-dispatch":
            # placeholder in the reference's order: rpd is checked here
            if (plan.round_backend == "fused"
                    and int(xc.rounds_per_dispatch) < 1):
                raise ExperimentConfigError(
                    rule.key, "rounds_per_dispatch must be >= 1, got "
                    f"{xc.rounds_per_dispatch}")
            continue
        if rule.bad(plan):
            raise ExperimentConfigError(rule.key, rule.why(plan))
    return plan
