"""The port's experiment harness: ``run(alg, xc)`` and its snapshot paths
(``experiments.py``), the configuration compatibility matrix
(``compat.py``) and the reference's deprecated ``run_*`` entry points, as
thin shims over ``run``."""
from repro_torch.configs.base import ExperimentConfig
from repro_torch.harness.compat import (ALL_ALGS, ENGINES, POD_ENGINES,
                                        ExperimentConfigError, ResolvedPlan,
                                        resolve)
from repro_torch.harness.experiments import (MODEL_PARAMS,
                                             build_fused_engine,
                                             checkpoint_path,
                                             resume_smoke_config, run,
                                             run_centralized_sgd,
                                             run_experiment,
                                             run_pod_online_experiment,
                                             run_vectorized_experiment)

__all__ = ["ALL_ALGS", "ENGINES", "POD_ENGINES", "MODEL_PARAMS",
           "ExperimentConfig", "ExperimentConfigError", "ResolvedPlan",
           "build_fused_engine", "checkpoint_path", "resolve",
           "resume_smoke_config", "run", "run_centralized_sgd",
           "run_experiment", "run_pod_online_experiment",
           "run_vectorized_experiment"]
