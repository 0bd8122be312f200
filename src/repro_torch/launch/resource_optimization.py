"""The paper's per-client wireless resource optimizer, standalone
(``examples/resource_optimization.py``).

Reproduces the Fig. 3 mechanism: as the model payload grows, more clients
become stragglers (problem (5) infeasible), and feasible clients trade
local SGD steps against upload energy. The solve is host numpy, as in the
reference: nothing here runs on a device.

    PYTHONPATH=src python -m repro_torch.launch.resource_optimization
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.resource import (NetworkConfig, make_clients,
                                       optimize_round)

PAYLOADS = ((430_000, "LSTM 0.4M"), (740_000, "SqzNet 0.7M"),
            (1_100_000, "CNN 1.1M"), (3_900_000, "FCN 3.9M"))
CLIENTS, DETAIL = 30, 8


def run() -> dict:
    """One round of the solve for each payload of ``PAYLOADS`` over
    ``CLIENTS`` clients, then the FCN payload's decisions for the first
    ``DETAIL``, drawing one generator in the reference's order. Returns
    ``{"payloads": [{"name", "stragglers", "mean_kappa",
    "mean_power_mw"}], "detail": [ResourceDecision]}``."""
    rng = np.random.default_rng(0)
    net = NetworkConfig()
    clients = make_clients(rng, CLIENTS)
    rows = []
    for n_params, name in PAYLOADS:
        dec = optimize_round(rng, net, clients, n_params)
        feas = [d for d in dec if d.feasible]
        kappas = [d.kappa for d in feas]
        powers = [d.p * 1e3 for d in feas]
        rows.append({"name": name, "stragglers": CLIENTS - len(feas),
                     "mean_kappa": np.mean(kappas) if kappas else 0,
                     "mean_power_mw": np.mean(powers) if powers else 0})
    detail = optimize_round(rng, net, clients[:DETAIL], 3_900_000)
    return {"payloads": rows, "detail": detail}


def main() -> None:
    res = run()
    print(f"{'payload':>12} {'stragglers':>11} {'kappa':>18} "
          f"{'P tx (mW)':>12}")
    for r in res["payloads"]:
        print(f"{r['name']:>12} {r['stragglers']:>8}/{CLIENTS} "
              f"{r['mean_kappa']:>10.2f} (max 5) "
              f"{r['mean_power_mw']:>10.1f}")
    print("\nper-client detail (FCN payload):")
    for i, d in enumerate(res["detail"]):
        status = (f"kappa={d.kappa} f={d.f / 1e9:.2f}GHz p={d.p * 1e3:.1f}mW "
                  f"t={d.t_total:.1f}s e={d.e_total:.2f}J"
                  if d.feasible else "STRAGGLER (problem (5) infeasible)")
        print(f"  client {i}: {status}")


if __name__ == "__main__":
    main()
