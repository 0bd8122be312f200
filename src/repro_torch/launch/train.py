"""Config-driven trainer (``repro/launch/train.py``): runs the pod-scale
OSAFL engines on the host mesh, one client row per process.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
      --steps 50 --engine exact_tp [--sketch 64] [--ckpt out.npz]

``--device cpu`` runs on the CPU; without it the run needs a CUDA card.
Over R client rows start R processes, one a card, each of which joins
the process group first:

  torchrun --nproc-per-node R -m repro_torch.launch.train ... --distributed

(``--distributed`` calls ``init_process_group`` with NCCL on the cards,
gloo with ``--device cpu``). Every rank draws the whole batch from the
same seed and trains on its block; rank 0 prints and writes ``--ckpt``.
``--full`` takes the full config (40 layers of qwen1.5-4b do not fit one
card's memory with ``recompute``'s five parameter-sized trees; a caller
cuts depth with ``dataclasses.replace`` and ``run(cfg=...)``).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core.pod import (make_fedavg_train_step,
                                  make_recompute_train_step,
                                  make_stale_score_train_step,
                                  make_tp_train_step, num_pod_clients)
from repro_torch.core.shmap import client_sharding, use_mesh
from repro_torch.data.synthetic import (learnable_sequence_batch,
                                        make_train_batch)
from repro_torch.device import clock, resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import init_model, param_count

ENGINES = ("exact_tp", "recompute", "stale", "fedavg")


def run(arch: str, *, reduced=True, steps=20, engine="exact_tp", sketch=0,
        batch=8, seq=64, lr=0.1, global_lr=1.0, num_clients=None,
        learnable=True, ckpt=None, log_every=5, seed=0, device=None,
        cfg: ModelConfig = None):
    """Train ``arch`` (or ``cfg``, which replaces it) for ``steps`` steps
    from weights drawn with ``seed``; returns ``(params, history)``, each
    entry of ``history`` the step's metrics plus ``step_s`` (wall seconds,
    ending in a synchronize on the card). The mesh is ``make_host_mesh``'s:
    one client row per rank of the process group (one with none);
    ``num_clients`` (of recompute and stale) defaults to its rows."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; known: {ENGINES}")
    mesh = make_host_mesh(device=device)
    dev = resolve_device(mesh.device if device is None else device)
    if cfg is None:
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced()
    rows = num_pod_clients(mesh)
    fl = FLConfig(kappa_max=1, local_lr=lr, global_lr=global_lr,
                  num_clients=num_clients or rows,
                  score_sketch_dim=sketch)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    params = init_model(gen, cfg)
    lead = mesh.row == 0
    if lead:
        print(f"{cfg.name}: {param_count(params) / 1e6:.1f}M params, "
              f"device={dev}, client rows={rows}, engine={engine}")

    with use_mesh(mesh):
        if engine == "exact_tp":
            step = make_tp_train_step(cfg, fl, mesh, sketch_dim=sketch)
        elif engine == "recompute":
            step = make_recompute_train_step(cfg, fl, mesh, fl.num_clients)
        elif engine == "stale":
            step = make_stale_score_train_step(cfg, fl, mesh,
                                               fl.num_clients)
        else:
            step = make_fedavg_train_step(cfg, fl, mesh)
    lam = torch.ones((fl.num_clients,), dtype=torch.float32, device=dev)
    draw = learnable_sequence_batch if learnable else make_train_batch
    history = []
    for t in range(steps):
        b = draw(gen, cfg, batch, seq)
        if engine in ("recompute", "stale"):
            b = {k: x.reshape((fl.num_clients, -1) + tuple(x.shape[1:]))
                 for k, x in b.items()}
        # every rank drew the whole batch; it trains on its block
        b = {k: client_sharding(mesh, x.dim()).block(x)
             for k, x in b.items()}
        t0 = clock(dev)
        if engine == "stale":
            params, lam, metrics = step(params, lam, b)
        else:
            params, metrics = step(params, b)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_s"] = clock(dev) - t0
        history.append(metrics)
        if lead and (t % log_every == 0 or t == steps - 1):
            lam_m = metrics.get("lambda_mean")
            print(f"step {t:4d} loss={metrics['loss']:.4f}"
                  + (f" lambda={lam_m:.4f}" if lam_m is not None else "")
                  + f" ({metrics['step_s']:.2f}s)")
    if ckpt and lead:
        checkpoint.save(ckpt, params, step=steps)
        print(f"saved checkpoint -> {ckpt}")
    return params, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-reduced) config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--engine", default="exact_tp", choices=list(ENGINES))
    ap.add_argument("--sketch", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--num-clients", type=int, default=None,
                    help="clients of recompute and stale (default: the "
                         "mesh's client rows)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group torchrun describes (one "
                         "client row per process)")
    args = ap.parse_args(argv)
    if args.distributed:
        import os

        import torch.distributed as dist
        if args.device != "cpu":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
    run(args.arch, reduced=not args.full, steps=args.steps,
        engine=args.engine, sketch=args.sketch, batch=args.batch,
        seq=args.seq, lr=args.lr, num_clients=args.num_clients,
        ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
