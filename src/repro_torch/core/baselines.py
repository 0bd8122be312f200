"""Server construction (``repro/core/baselines.py::make_server``). Only the
dense stacked OSAFL server is ported; the five baselines, the sparse cohort
pool and the cluster tier raise until they are."""
from __future__ import annotations

from repro_torch.configs.base import FLConfig
from repro_torch.core.osafl import StackedOSAFLServer


def make_server(params, fl: FLConfig, num_clients: int, device=None):
    missing = []
    if fl.algorithm != "osafl":
        missing.append(f"algorithm={fl.algorithm!r}")
    if fl.engine != "stacked":
        missing.append(f"engine={fl.engine!r}")
    if fl.cohort_size:
        missing.append(f"cohort_size={fl.cohort_size}")
    if fl.num_clusters >= 1:
        missing.append(f"num_clusters={fl.num_clusters}")
    if missing:
        raise NotImplementedError(
            "not ported to repro_torch yet: " + ", ".join(missing)
            + " (ported: the dense stacked OSAFL server)")
    return StackedOSAFLServer(params, fl, num_clients, device=device)
