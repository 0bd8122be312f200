"""End to end: the paper's pipeline at a ~100M-parameter scale
(``examples/train_fl_video_caching.py``).

A ~100M-parameter transformer (an h2o-danube-3 family member, shrunk) is
trained with OSAFL's pod-engine step (``make_tp_train_step`` on the one
client row of ``make_host_mesh()``) on a learnable next-token task, with
the wireless resource optimizer budgeting a round of the paper's clients
every 20 steps; the weights are saved with ``checkpoint.save`` at the
end. The config keeps the family's ``sliding_window`` (512), so its
attention takes ``models/attention._sdpa``'s windowed mask, not the flash
kernel, which has no windowed variant (ROADMAP.md B2).

    PYTHONPATH=src python -m repro_torch.launch.train_fl_video_caching \\
        [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core.pod import make_tp_train_step
from repro_torch.core.resource import (NetworkConfig, make_clients,
                                       optimize_round)
from repro_torch.data.synthetic import learnable_sequence_batch
from repro_torch.device import clock, resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import init_model, param_count

WIRELESS_EVERY = 20


def build_100m_config() -> ModelConfig:
    """~100M params from the danube-3 family (the same block structure)."""
    base = get_config("h2o-danube-3-4b")
    return dataclasses.replace(
        base, n_layers=8, d_model=768, n_heads=12, n_kv_heads=4,
        d_ff=2048, vocab_size=32_000, sliding_window=512)


def run(*, steps: int = 200, batch: int = 8, seq: int = 128, ckpt=None,
        cfg: ModelConfig = None, device=None, verbose: bool = True) -> dict:
    """Train ``cfg`` (default ``build_100m_config()``) for ``steps`` steps
    on ``device`` (``None``: the CUDA device) from weights drawn with seed
    0; save them to ``ckpt`` when given. Returns ``{"params",
    "param_count", "history", "wireless", "lines"}``: ``history`` one row
    a step (the step's metrics and ``step_s``, ending in a synchronize on
    the card), ``wireless`` the resource rounds (step, kappas,
    stragglers), ``lines`` what was printed."""
    dev = resolve_device(device)
    cfg = build_100m_config() if cfg is None else cfg
    mesh = make_host_mesh(device=dev)
    fl = FLConfig(kappa_max=1, local_lr=0.05, global_lr=1.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_model(gen, cfg)
    lines = []

    def say(line):
        lines.append(line)
        if verbose:
            print(line)
    n = param_count(params)
    say(f"model: {n / 1e6:.1f}M params")

    # wireless resource budgeting: how many microbatches this round affords
    rng = np.random.default_rng(0)
    net = NetworkConfig()
    clients = make_clients(rng, 8, cell_radius_m=500.0)
    # uplink payload: at 100M raw params every client misses the deadline
    # (the paper's Fig. 3 effect taken to its limit), so the round is
    # budgeted for an 8-bit-quantized, 4x-sparsified payload, the
    # compression regime the paper cites ([30]-[34]) for models this size
    n_params = n // 32

    step = make_tp_train_step(cfg, fl, mesh)
    history, wireless = [], []
    t0 = time.perf_counter()
    for t in range(steps):
        b = learnable_sequence_batch(gen, cfg, batch, seq)
        s0 = clock(dev)
        params, metrics = step(params, b)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_s"] = clock(dev) - s0
        history.append(metrics)
        if t % WIRELESS_EVERY == 0 or t == steps - 1:
            decisions = optimize_round(rng, net, clients, n_params)
            kappas = [d.kappa for d in decisions]
            stragglers = sum(1 for d in decisions if not d.feasible)
            wireless.append({"step": t, "kappas": kappas,
                             "stragglers": stragglers})
            say(f"step {t:4d} loss={metrics['loss']:.4f} "
                f"lambda={metrics['lambda_mean']:.3f} "
                f"| wireless round: kappas={kappas} "
                f"stragglers={stragglers}/8")
    say(f"trained {steps} steps in {time.perf_counter() - t0:.1f}s")
    if ckpt is not None:
        checkpoint.save(ckpt, params, step=steps)
        say(f"checkpoint -> {ckpt}")
    return {"params": params, "param_count": n, "history": history,
            "wireless": wireless, "lines": lines}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "fl_100m.npz"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    run(steps=args.steps, batch=args.batch, seq=args.seq, ckpt=args.ckpt,
        device=args.device)


if __name__ == "__main__":
    main()
