"""Run configurations: ``FLConfig`` (the server round) and
``ExperimentConfig`` (one harness run), copied field for field from
``repro/configs/base.py`` and ``repro/harness/experiments.py`` so a config
means the same thing in both packages."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning round configuration (paper Section II/III)."""
    num_clients: int = 16
    kappa_max: int = 5                # κ: max local SGD steps
    local_lr: float = 0.1             # η
    global_lr: float = 1.0            # η̃
    chi: float = 1.0                  # χ score shift control (eq. 21)
    algorithm: str = "osafl"          # osafl|fedavg|fedprox|fednova|afa_cd|feddisco
    fedprox_mu: float = 0.9
    fednova_slowdown: float = 0.1
    feddisco_a: float = 0.2
    feddisco_b: float = 0.1
    score_sketch_dim: int = 0         # 0 = exact scores (paper); >0 = sketched
    stale_scores: bool = False        # weight round t with round t-1 scores
    engine: str = "loop"              # loop | stacked
    score_backend: str = "kernel"     # kernel (CUDA scored_reduce) |
                                      # reference (plain torch, kernels/ref.py)
    request_backend: str = "python"   # recorded here; applied by the harness
    round_backend: str = "dispatch"   # recorded here; applied by the harness
    cohort_size: int = 0              # C: sparse slot pool (0 = dense)
    participation: float = 1.0        # round-active fraction of the pool
    num_clusters: int = 0             # K: hierarchical edge clusters (0 = flat)
    scenario: str = ""                # recorded here; applied by the harness
    resource_backend: str = "x64"     # x64 (float64 solve) | f32 (log domain)
    literal_init_buffer: bool = False # Algorithm 2's literal d[u]=w^t/eta for
                                      # never-participated clients


@dataclass
class ExperimentConfig:
    """One harness run (``repro_torch.harness.run``). Every field and default
    of the reference's ``ExperimentConfig``; ``harness/compat.py`` says which
    values the port runs so far."""
    model: str = "fcn"
    dataset: int = 1                  # 1 | 2
    num_clients: int = 12
    rounds: int = 25
    capacity: tuple = (80, 160)       # D_u range (reduced from paper 320-640)
    arrivals: int = 8                 # E_u (paper: ceil(32 p_u))
    local_lr: float = 0.1
    global_lr: float = 16.0
    batch: int = 16
    topk: int = 1                     # K (request-model randomness)
    seed: int = 0
    use_resource_opt: bool = True
    engine: str = "auto"              # auto|loop|stacked|pod|centralized
    pod_engine: str = "exact_tp"
    request_backend: str = "python"   # python | stacked
    round_backend: str = "dispatch"   # dispatch | fused
    resource_backend: str = "x64"     # x64 | f32
    rounds_per_dispatch: int = 1
    cohort_size: int = 0
    participation: float = 1.0
    num_clusters: int = 0
    cell_radius_m: float = 600.0
    scenario: str = ""

    def validate(self, alg: str = "osafl", mesh=None):
        """Check this config against ``repro_torch.harness.compat.RULES``
        and return the resolved plan; raises ``ExperimentConfigError``."""
        from repro_torch.harness.compat import resolve
        return resolve(alg, self, mesh=mesh)
