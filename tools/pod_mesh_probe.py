"""``chip_smoke.py``'s phase 6j alone on one CUDA card, with the runs it
holds its ranks to, and the reading the phase leaves out for time: OSAFL
on exact_tp over two gloo ranks at the paper's ``global_lr=16``.

    python3 tools/pod_mesh_probe.py

Builds ``scored_reduce``, runs the FL main path (phase 5), the same run
with its weights moved one ulp, the stacked run at ``global_lr=1`` and
the grid's FedAvg run, then ``pod_mesh_phase`` (its gates, per-rank
rounds, collectives and the kernel at (128, N)), then two gloo ranks at
``global_lr=16``. Prints, as one JSON line, each round's ``test_loss`` gap
of the two ranks to phase 5's run beside that of the one-ulp control: a
sum split over client rows rounds like a one-ulp change of the weights,
which three rounds at 16 amplify (``tests/test_torch_precision.py``).
Exits non-zero without a card or when a gate fails.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels.build import build
    cs.card()
    build(("scored_reduce",))
    main_run = cs.fl_run("main path", "osafl", cs.MAIN_RUN, cs.MAIN_EVAL)
    with cs._one_ulp_moved_weights():
        ulp = cs.fl_run("main path, weights moved one ulp", "osafl",
                        cs.MAIN_RUN, cs.MAIN_EVAL)
    lr1 = cs.fl_run("stacked global_lr=1", "osafl", cs.POD_LR1,
                    cs.MAIN_EVAL)
    grid = [cs.fl_run("grid fedavg", "fedavg", dict(cs.MAIN_RUN, rounds=2),
                      cs.GRID_EVAL)]
    t0 = time.perf_counter()
    cs.pod_mesh_phase(main_run, {"runs": {"stacked global_lr=1": lr1}},
                      grid)
    cs.say(f"phase 6j: {time.perf_counter() - t0:.1f} s")
    sixteen, _ = cs.mesh_ranks(cs.MESH_RANKS, "gloo", (
        ("osafl exact_tp", "osafl", "exact_tp", cs.MAIN_RUN),))
    ranks = sixteen["osafl exact_tp"]
    cs.say("global_lr=16 " + json.dumps({
        "two ranks vs stacked": cs._loss_gaps(ranks[0], main_run),
        "stacked one-ulp vs stacked": cs._loss_gaps(ulp, main_run),
        "participants equal": cs._same_rounds(ranks[0], main_run,
                                              tol=float("inf")),
        "every rank's rounds the same": ranks[1]["rounds"]
        == ranks[0]["rounds"],
        "own_round_s": [[x["round_s"] for x in r["own_rounds"]]
                        for r in ranks]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
