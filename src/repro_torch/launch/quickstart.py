"""Quickstart: OSAFL through the list API (``examples/quickstart.py``).

Four wireless clients with time-varying FIFO datasets train the paper's FCN
on the video-caching task; the server weights their normalized updates by
the online cosine-similarity score (paper eq. 35). Each round, each client
draws its Binomial arrivals, takes kappa_u ~ U{1..4} local SGD steps
(``local_train``) and hands its ``ClientUpdate`` to ``OSAFLServer.round``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import (ClientUpdate, OnlineBuffer, OSAFLServer,
                              binomial_arrivals, local_train)
from repro_torch.data import D1_DIM, make_population
from repro_torch.device import resolve_device
from repro_torch.models import init_small, small_loss


U, CAPACITY = 4, 80


def run(*, rounds: int = 15, device=None) -> list:
    """The quickstart's rounds on ``device`` (``None``: the CUDA device);
    returns one row a round: ``round``, ``loss`` and ``acc`` of the global
    model on the clients' current datasets, and the server's ``scores``
    (what the script prints)."""
    dev = resolve_device(device)
    # data: each client has a FIFO buffer fed by its own request stream
    _, streams = make_population(seed=0, num_users=U)
    buffers = []
    for s in streams:
        buf = OnlineBuffer.create(CAPACITY, (D1_DIM,), 100)
        buf.stage(*s.draw_dataset1(CAPACITY))
        buf.commit()
        buffers.append(buf)

    # model and server
    fl = FLConfig(num_clients=U, local_lr=0.05, global_lr=2.0,
                  algorithm="osafl")
    server = OSAFLServer(init_small(0, "fcn", dev), fl, U, device=dev)
    grad_fn = torch.func.grad(lambda p, b: small_loss(p, b, "fcn")[0])
    rng = np.random.default_rng(0)

    rows = []
    for t in range(rounds):
        updates = []
        for u in range(U):
            # new samples arrive Binomial(E_u, p_ac); FIFO evicts the oldest
            n = binomial_arrivals(rng, 8, streams[u].user.p_ac)
            if n:
                buffers[u].stage(*streams[u].draw_dataset1(n))
            buffers[u].commit()
            # kappa_u local SGD steps -> normalized accumulated gradient d_u
            kappa = int(rng.integers(1, 5))
            d, _ = local_train(server.params, grad_fn, buffers[u], kappa,
                               fl.local_lr, batch_size=16, rng=rng)
            updates.append(ClientUpdate(u, d, kappa))
        server.round(updates)

        xs, ys = zip(*[b.dataset() for b in buffers])
        batch = {"x": torch.as_tensor(np.concatenate(xs), device=dev),
                 "y": torch.as_tensor(np.concatenate(ys), device=dev)}
        loss, m = small_loss(server.params, batch, "fcn")
        rows.append({"round": t, "loss": float(loss),
                     "acc": float(m["accuracy"]),
                     "scores": np.array(server.last_scores, dtype=float)})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    for r in run(rounds=args.rounds, device=args.device):
        print(f"round {r['round']:2d}  loss={r['loss']:.3f} "
              f"acc={r['acc']:.3f}  scores={np.round(r['scores'], 3)}")


if __name__ == "__main__":
    main()
