"""``chip_smoke.py``'s phase 11 alone on one CUDA card, and phase 9's
training leg of the same families on four gloo ranks.

    python3 tools/family_tp_probe.py

Builds the flash kernels, runs phase 11's two gloo ranks (zamba2-2.7b at
12 layers, llama-3.2-vision-11b at 5, whisper-medium and xlstm-350m whole,
at full width on a (1, 2) mesh) and ``family_phase`` (one process on the
same weights, the gates, the flash kernels at the local-head shapes);
then four gloo ranks on the card train reduced zamba2-2.7b and
whisper-medium for ``TP_MOE_STEPS`` exact_tp steps on (2, 2) against
(2, 1) (``_tp_leg``) under phase 9's gates. Prints each part's seconds
and gates; exits non-zero without a card or when a gate fails.
"""
from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _leg_rank(proc: int, port: int, out: str) -> None:
    """One of the four ranks of the training leg: every family of
    ``TP_FAMILY_TRAIN`` in turn; writes its rows into ``out``."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=cs.TP_RANKS, rank=proc)
    try:
        mesh = make_host_mesh(model_parallel=2, device="cuda:0")
        row = {"col": mesh.col, "legs": {
            arch: cs._tp_leg(mesh, "cuda:0", arch, layers)
            for arch, layers in cs.TP_FAMILY_TRAIN}}
    finally:
        dist.destroy_process_group()
    (Path(out) / f"leg{proc}.json").write_text(json.dumps(row))


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch.multiprocessing as mp

    import chip_smoke as cs
    from repro_torch.kernels.build import build
    cs.card()
    build(("flash_attention", "flash_attention_bwd"))
    t0 = time.perf_counter()
    group = cs.join_tp_ranks(cs.start_tp_ranks("family"))
    cs.say(f"phase 11 ranks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    family = cs.family_phase(group)
    cs.say(f"phase 11 one process: {time.perf_counter() - t0:.1f} s")
    cs.say("family kernels " + json.dumps(family["kernels"]))
    out = Path(tempfile.mkdtemp(prefix="family_tp_probe_"))
    t0 = time.perf_counter()
    ctx = mp.start_processes(_leg_rank, args=(cs._free_port(), str(out)),
                             nprocs=cs.TP_RANKS, join=False,
                             start_method="spawn")
    while not ctx.join():
        pass
    rows = [json.loads((out / f"leg{r}.json").read_text())
            for r in range(cs.TP_RANKS)]
    gates = {}
    for arch, layers in cs.TP_FAMILY_TRAIN:
        gates.update(cs._leg_gates([r["legs"][arch] for r in rows],
                                   [r["col"] for r in rows], arch, layers))
    cs.say(f"training leg: {time.perf_counter() - t0:.1f} s "
           + json.dumps({"gates": gates, "ranks": rows}))
    if not all(gates.values()):
        raise AssertionError(f"the training leg's gates failed: {gates}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
