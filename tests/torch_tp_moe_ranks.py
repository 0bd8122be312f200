"""What each rank of ``tests/test_torch_tp_moe.py``'s process groups runs:
the port's MoE decoders (arctic-480b, deepseek-v3-671b) tensor- and
expert-parallel over a 'model' axis, one process a (row, column) device,
on the CPU under gloo, started by ``torch_tp_ranks.spawn(...,
job=run_cases)``. This module imports torch and the port only (the ranks
never load JAX).
"""
from __future__ import annotations

import numpy as np
import torch

from torch_tp_ranks import DECODE_STEPS, FL, SKETCH_DIM, _np, _tree_np

DECODE_PROMPT = 4        # the prompt's first tokens, fed through decode


class _Routes:
    """The expert ids of every ``moe.route`` call while open, in call
    order (numpy (T, k) arrays)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.ids, self._plain = [], moe.route

        def recorded(*args, **kwargs):
            out = self._plain(*args, **kwargs)
            self.ids.append(out[2].detach().numpy().copy())
            return out
        moe.route = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._plain


def run_cases(payload: dict, M: int) -> dict:
    """Every case of ``payload["cases"]`` on this rank's mesh (R x M over
    the running group, or one process with M = 1 and no group): the
    forward's logits and aux loss (with labels: the routers' and MTP's),
    the routes it took, the loss and its gradient (this rank's shards),
    one step of exact_tp (exact and sketched) and fedavg from the same
    weights, the greedy prefill token, ``DECODE_STEPS`` greedy decode
    steps after the prompt's first ``DECODE_PROMPT`` tokens and the latent
    or kv cache they leave; each row takes
    its block of the batch. Also whether ``sharding.init_shards`` gives
    this rank the shards of ``init_model``'s whole tree."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import pod
    from repro_torch.core.flatten import tree_get, tree_paths
    from repro_torch.core.shmap import client_sharding
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    torch.set_num_threads(1)
    mesh = make_host_mesh(model_parallel=M, device="cpu")
    out = {"row": mesh.row, "col": mesh.col, "rank": mesh.rank,
           "shape": mesh.shape}
    for case in payload["cases"]:
        cfg = case["cfg"]
        params = T.params_from_numpy(case["weights"], cfg, device="cpu",
                                     mesh=mesh)
        blk = client_sharding(mesh, 2)
        batch = {k: blk.block(torch.from_numpy(v))
                 for k, v in case["batch"].items()}
        res = {}
        with torch.no_grad(), _Routes() as routes:
            logits, aux = T.forward(params, batch, cfg, mesh)
        res["logits"], res["aux"] = _np(logits), _np(aux)
        res["routes"] = routes.ids
        loss, grads = pod._loss_and_grad(params, batch, cfg, mesh)
        res["loss"], res["grads"] = _np(loss), _tree_np(grads)
        fl = FLConfig(num_clients=mesh.shape["data"], **FL)
        for name, step in (
                ("exact_tp", pod.make_tp_train_step(cfg, fl, mesh)),
                ("exact_tp_sketch", pod.make_tp_train_step(
                    cfg, fl, mesh, sketch_dim=SKETCH_DIM)),
                ("fedavg", pod.make_fedavg_train_step(cfg, fl, mesh))):
            new, metrics = step(params, batch)
            res[name] = {"params": _tree_np(new),
                         "metrics": {k: float(v) for k, v in
                                     metrics.items()}}
        prompt = batch["tokens"]
        with torch.no_grad():
            res["prefill"] = _np(pod.make_prefill_step(cfg, mesh)(
                params, {"tokens": prompt}))
            prompt = prompt[:, :DECODE_PROMPT]
            B, S = prompt.shape
            cache = T.init_cache(cfg, B, S + DECODE_STEPS, device="cpu",
                                 dtype=torch.float32, mesh=mesh)
            serve = pod.make_serve_step(cfg, mesh)
            tokens = []
            for pos in range(S + DECODE_STEPS - 1):
                tok = prompt[:, pos:pos + 1] if pos < S else tok
                tok, cache = serve(params, cache, tok, pos)
                if pos >= S - 1:
                    tokens.append(_np(tok))
        res["decode"] = np.concatenate(tokens, axis=1)
        res["cache"] = _tree_np(cache)
        if M > 1:
            gen = torch.Generator().manual_seed(case["seed"])
            drawn = sharding.init_shards(gen, cfg, mesh)
            whole = T.init_model(torch.Generator().manual_seed(
                case["seed"]), cfg)
            cut = sharding.shard_params(whole, mesh)
            res["init_shards_equal"] = tree_paths(drawn) == tree_paths(
                cut) and all(torch.equal(tree_get(drawn, p), tree_get(cut, p))
                             for p in tree_paths(cut))
        out[case["name"]] = res
    return out
