"""Why the pod engine's recompute flavour rounds unlike the vmapped one, on
one CUDA card.

    python3 tools/pod_rounding_probe.py

recompute runs local SGD one client at a time; exact_tp, stale, fedavg and
the stacked engine run the whole cohort under ``torch.func.vmap``. At the
FL main path's shapes (the FCN's three layers, U=256 clients, batch 16)
this prints, as one JSON line, the largest absolute difference between:

  * the shared-weight product of the first SGD step, one (U*B, K) @ (K, N)
    GEMM under vmap, and the same rows as U (B, K) @ (K, N) GEMMs;
  * the per-client-weight products of later steps, one batched GEMM
    (``torch.bmm`` and vmap) over U clients, and U single GEMMs;
  * vmap over one client and that client's single GEMM;
  * a backward-shaped product, (U*B, N) @ (N, K) against U (B, N) @ (N, K);

then, on random data and the FCN's seeded weights, each of 7 clients'
``d_u`` after kappa_max = 5 masked SGD steps, vmapped over all U clients
against the same client alone. Exits non-zero without a card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
U, B, KAPPA = 256, 16, 5
LAYERS = ((3168, 1024), (1024, 512), (512, 100))     # the FCN's (K, N)


def gemm_gaps(dev, gen) -> dict:
    out = {}
    for K, N in LAYERS:
        x = torch.randn((U, B, K), generator=gen, device=dev)
        w = torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
        wu = torch.randn((U, K, N), generator=gen, device=dev) / K ** 0.5
        g = torch.randn((U, B, N), generator=gen, device=dev)
        shared = (x.reshape(U * B, K) @ w).reshape(U, B, N)
        single = torch.stack([x[u] @ w for u in range(U)])
        single_u = torch.stack([x[u] @ wu[u] for u in range(U)])
        vmapped = torch.func.vmap(lambda a, b: a @ b)(x, wu)
        one = torch.func.vmap(lambda a, b: a @ b)(x[:1], wu[:1])
        back = (g.reshape(U * B, N) @ w.t()).reshape(U, B, K)
        back_single = torch.stack([g[u] @ w.t() for u in range(U)])
        out[f"{K}x{N}"] = {
            "shared_vs_single": float((shared - single).abs().max()),
            "bmm_vs_single": float((torch.bmm(x, wu) - single_u).abs().max()),
            "vmap_vs_single": float((vmapped - single_u).abs().max()),
            "vmap_of_one_vs_single": float((one[0] - single_u[0]).abs().max()),
            "backward_shared_vs_single": float((back - back_single).abs()
                                               .max())}
    return out


def client_gaps(dev, gen) -> list:
    from repro_torch.core.client import make_local_train_body
    from repro_torch.models.small import init_small, small_loss
    params = init_small(0, "fcn", dev)
    grad = torch.func.grad(lambda p, b: small_loss(p, b, "fcn")[0])
    body = make_local_train_body(grad, 0.1, KAPPA)
    xb = torch.randn((U, KAPPA, B, LAYERS[0][0]), generator=gen, device=dev)
    yb = torch.randint(0, 100, (U, KAPPA, B), generator=gen, device=dev)
    kappas = torch.randint(0, KAPPA + 1, (U,), generator=gen, device=dev)
    vd, _ = torch.func.vmap(body, in_dims=(None, 0, 0))(
        params, {"x": xb, "y": yb}, kappas)
    gaps = []
    for u in range(0, U, 37):
        d, _ = body(params, {"x": xb[u], "y": yb[u]}, kappas[u])
        gaps.append({"client": u, "kappa": int(kappas[u]),
                     "d_max_abs_gap": max(
                         float((d[k][p] - vd[k][p][u]).abs().max())
                         for k in d for p in d[k])})
    return gaps


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "gemm": gemm_gaps(dev, gen),
                      "clients": client_gaps(dev, gen)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
