"""The port's experiment harness: ``run(alg, xc)`` and its snapshot paths
(``experiments.py``) and the configuration compatibility matrix
(``compat.py``)."""
from repro_torch.configs.base import ExperimentConfig
from repro_torch.harness.compat import (ALL_ALGS, ENGINES, POD_ENGINES,
                                        ExperimentConfigError, ResolvedPlan,
                                        resolve)
from repro_torch.harness.experiments import (MODEL_PARAMS,
                                             build_fused_engine,
                                             checkpoint_path,
                                             resume_smoke_config, run)

__all__ = ["ALL_ALGS", "ENGINES", "POD_ENGINES", "MODEL_PARAMS",
           "ExperimentConfig", "ExperimentConfigError", "ResolvedPlan",
           "build_fused_engine", "checkpoint_path", "resolve",
           "resume_smoke_config", "run"]
