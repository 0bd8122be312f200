"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: its name and power limit (nvidia-smi) and torch's view;
  2. the build: every CUDA kernel of the port, compiled in parallel;
  3. the kernels: each kernel against its plain PyTorch version on the card
     at the main path's shapes and at ragged ones, with times (CUDA events)
     beside the least time the card could take and one PyTorch library
     call that computes the same function;
  4. a small run on the card against the same run on the CPU (whose plain
     path the CPU tests tie to the JAX reference);
  5. the main path: ``repro_torch.harness.run("osafl", ...)`` on the FCN at
     the paper's U=256 clients, with every kernel's launch count reset just
     before and read just after;
  6. a breakdown of a main-path round by stage.
The line before the last is one JSON object with every kernel's numbers;
the last line is the result. Exits non-zero, with no result, when there is
no CUDA card or the port's sources are not beside this file.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

MAIN_U, MAIN_N = 256, 3_821_156     # FCN contribution buffer at U=256
MAIN_RUN = dict(model="fcn", dataset=1, num_clients=MAIN_U,
                capacity=(320, 640), arrivals=8, batch=16, rounds=3, seed=0)
MAIN_EVAL = 512
# norms/mean_sq: the reference kernel test's rtol; dots: the same factor
# times sqrt(norms * mean_sq), the size of the terms a dot sums
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def say(*parts) -> None:
    print(*parts, flush=True)


def card() -> tuple:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    say(f"card: {smi}")
    say(f"torch: {torch.__version__} cuda {torch.version.cuda} device "
        f"{name} count {torch.cuda.device_count()}; matmul tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    return name, smi


def build() -> None:
    from repro_torch.kernels.build import KERNELS
    from repro_torch.kernels.build import build as build_kernels
    t0 = time.perf_counter()
    out = build_kernels(KERNELS)
    say(f"build: {len(out)} kernel(s) in {time.perf_counter() - t0:.3f} s")
    for name, info in out.items():
        say(f"  {name}: {info['seconds']:.3f} s -> {info['path'].name}")
        for line in info["log"].splitlines():
            if "ptxas info" in line and ("registers" in line
                                         or "Compiling" in line):
                say(f"    {line.strip()}")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_scored_reduce(U: int, N: int, dtype, timed: bool) -> dict:
    from repro_torch.kernels import scored_reduce as sr
    gen = torch.Generator(device="cuda").manual_seed(U * 7919 + N)
    d = torch.randn((U, N), generator=gen, device="cuda").to(dtype)
    mean = d.float().mean(0)
    dots, norms, msq = sr.scored_reduce(d, mean)
    pd, pn, pm = sr.scored_reduce_plain(d, mean)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    scale = torch.sqrt(pn * pm)
    err = {"dots": float((dots - pd).abs().max()),
           "norms": float((norms - pn).abs().max()),
           "mean_sq": float((msq - pm).abs())}
    ok = (bool(((dots - pd).abs() <= tol * scale).all())
          and bool(((norms - pn).abs() <= tol * pn.abs()).all())
          and bool((msq - pm).abs() <= tol * pm.abs()))
    again = sr.scored_reduce(d, mean)
    same = all(torch.equal(a, b) for a, b in zip((dots, norms, msq), again))
    row = {"U": U, "N": N, "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "tol": tol, "ok": ok, "bitwise_repeat": same}
    if timed:
        row["ms"] = time_ms(lambda: sr.scored_reduce(d, mean), 30)
        row["plain_ms"] = time_ms(
            lambda: sr.scored_reduce_plain(d, mean), 10)
        df = d.float() if dtype != torch.float32 else d
        row["library_ms"] = time_ms(
            lambda: (torch.mv(df, mean),
                     torch.linalg.vector_norm(df, dim=1) ** 2,
                     torch.dot(mean, mean)), 10)
        t_bytes = sr.bound_bytes(d) / HBM_BYTES_PER_S * 1e3
        t_ops = sr.bound_flops(d) / F32_FLOPS_PER_S * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["gb_per_s"] = sr.bound_bytes(d) / row["ms"] / 1e6
    say("scored_reduce " + json.dumps(row))
    if not (ok and same):
        raise AssertionError(f"scored_reduce disagrees with its plain "
                             f"version or is not repeatable: {row}")
    return row


def kernels_phase() -> dict:
    rows = [check_scored_reduce(MAIN_U, MAIN_N, torch.float32, timed=True)]
    torch.cuda.empty_cache()
    rows.append(check_scored_reduce(MAIN_U, MAIN_N, torch.bfloat16,
                                    timed=True))
    torch.cuda.empty_cache()
    for U, N in ((16, 18_404), (1, 17), (3, 131), (17, 4_099)):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_scored_reduce(U, N, dtype, timed=False))
    return {"main": rows[0], "rows": rows}


def small_run_phase() -> None:
    from repro_torch.harness import ExperimentConfig, run
    xc = ExperimentConfig(model="mlp", dataset=2, num_clients=16, rounds=3,
                          capacity=(16, 32), seed=3)
    gpu = run("osafl", xc, eval_samples=64)
    cpu = run("osafl", xc, eval_samples=64, device="cpu")
    for g, c in zip(gpu, cpu):
        say(f"small run round {g['round']}: cuda loss {g['test_loss']:.6f} "
            f"cpu loss {c['test_loss']:.6f} participants "
            f"{g['participants']}/{c['participants']}")
        if (g["participants"] != c["participants"]
                or abs(g["test_loss"] - c["test_loss"])
                > 1e-4 * abs(c["test_loss"])):
            raise AssertionError("the run on the card drifted from the CPU "
                                 f"run: {g} vs {c}")


def main_path_phase() -> tuple:
    from repro_torch.harness import ExperimentConfig, run
    from repro_torch.kernels import scored_reduce as sr
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    xc = ExperimentConfig(**MAIN_RUN)
    t0 = time.perf_counter()
    sr.scored_reduce.launches = 0
    hist = run("osafl", xc, eval_samples=MAIN_EVAL)
    launches = {"scored_reduce": sr.scored_reduce.launches}
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for h in hist:
        say(f"main path round {h['round']}: test_loss {h['test_loss']:.6f} "
            f"test_acc {h['test_acc']:.4f} participants "
            f"{h['participants']} round_s {h['round_s']:.6f} "
            f"request_gen_s {h['request_gen_s']:.6f}")
    say(f"main path: {json.dumps(MAIN_RUN)} eval_samples {MAIN_EVAL}; "
        f"wall {wall:.3f} s (setup included); max_memory_allocated "
        f"{peak} B; launches {json.dumps(launches)}")
    finite = all(h["test_loss"] == h["test_loss"]
                 and abs(h["test_loss"]) != float("inf") for h in hist)
    if not finite:
        raise AssertionError(f"non-finite loss on the main path: {hist}")
    if not any(h["participants"] for h in hist):
        raise AssertionError("no round of the main path had participants")
    if launches["scored_reduce"] != xc.rounds:
        raise AssertionError(f"scored_reduce launched "
                             f"{launches['scored_reduce']} times in "
                             f"{xc.rounds} rounds")
    return hist, launches


def breakdown_phase(rounds: int = 2) -> None:
    """Where a main-path round's time goes: the stages of the harness's
    round (``repro_torch.harness.experiments._run_stacked``) in its order,
    each ended by a synchronize so that stages cannot overlap, plus the
    resource solve on the CPU for comparison. A separate run after the
    main path; its launches are not counted."""
    import numpy as np
    from repro_torch.core.client import make_vmapped_local_train
    from repro_torch.core.resource_stacked import optimize_round_batched
    from repro_torch.data.online import (binomial_arrivals_batched,
                                         draw_arrival_batch)
    from repro_torch.harness import ExperimentConfig
    from repro_torch.harness.experiments import _stacked_setup
    from repro_torch.models.small import small_loss
    dev = torch.device("cuda")
    xc = ExperimentConfig(**MAIN_RUN)
    s = _stacked_setup("osafl", xc, MAIN_EVAL, dev)
    step = make_vmapped_local_train(s.grad_fn, s.fl.local_lr,
                                    s.fl.kappa_max)

    def lap() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    for t in range(rounds):
        marks = [("start", lap())]
        counts = binomial_arrivals_batched(s.rng, xc.arrivals, s.p_ac)
        arrivals = draw_arrival_batch(s.streams, counts, xc.dataset,
                                      width=xc.arrivals)
        marks.append(("requests", lap()))
        s.sbuf.stage(*arrivals)
        s.sbuf.commit()
        marks.append(("fifo_commit", lap()))
        kappas = optimize_round_batched(s.rng, s.net, s.sysb, s.n_params,
                                        device=dev).kappa
        marks.append(("resource_solve", lap()))
        active = kappas >= 1
        slots = s.sbuf.sample_slots(s.rng, (s.fl.kappa_max, xc.batch))
        batch = s.sbuf.gather(slots)
        marks.append(("slots_gather", lap()))
        d, _ = step(s.server.params, batch,
                    torch.as_tensor(kappas, device=dev))
        upd = s.codec.flatten_stacked(d)
        del d, batch
        marks.append(("local_sgd", lap()))
        s.server.round_stacked(upd, active)
        del upd
        marks.append(("server_round", lap()))
        float(small_loss(s.server.params, s.test_batch, s.model)[0])
        marks.append(("eval", lap()))
        stages = {name: marks[i + 1][1] - marks[i][1]
                  for i, (name, _) in enumerate(marks[1:])}
        stages["total"] = marks[-1][1] - marks[0][1]
        t0 = time.perf_counter()
        optimize_round_batched(np.random.default_rng(t), s.net, s.sysb,
                               s.n_params, device="cpu")
        stages["resource_solve_on_cpu"] = time.perf_counter() - t0
        say(f"breakdown round {t} (s): {json.dumps(stages)}")


def main() -> int:
    name, smi = card()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    build()
    kern = kernels_phase()
    small_run_phase()
    _, launches = main_path_phase()
    breakdown_phase()
    m = kern["main"]
    line = {"kernels": [{
        "name": "scored_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scored_reduce.cu",
        "replaces": "src/repro/kernels/scored_reduce.py:32",
        "launches": launches["scored_reduce"],
        "max_abs_err": max(m["max_abs_err"].values()),
        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m["library_ms"]}]}
    say(smi)                        # the card's name and power limit
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
