"""What each rank of ``tests/test_torch_tp_ssm.py``'s process groups runs:
the port's recurrent and cross-attention families (zamba2-2.7b,
xlstm-350m, whisper-medium, llama-3.2-vision-11b) tensor-parallel over a
'model' axis, one process a (row, column) device, on the CPU under gloo,
started by ``torch_tp_ranks.spawn(..., job=run_cases)``. This module
imports torch and the port only (the ranks never load JAX).
"""
from __future__ import annotations

import numpy as np
import torch

from torch_tp_ranks import DECODE_STEPS, FL, SKETCH_DIM, _np, _tree_np

DECODE_PROMPT = 4        # the prompt's first tokens, fed through decode


def memory_inputs(batch: dict) -> dict:
    """The batch's memory inputs (whisper's frames, the patches)."""
    return {k: v for k, v in batch.items() if k in ("frames", "patches")}


def run_cases(payload: dict, M: int) -> dict:
    """Every case of ``payload["cases"]`` on this rank's mesh (R x M over
    the running group, or one process with M = 1 and no group): the
    forward's logits, the loss and its gradient (this rank's shards), one
    step of exact_tp (exact and sketched) and fedavg from the same
    weights, the greedy prefill token, ``DECODE_STEPS`` greedy decode
    steps after the prompt's first ``DECODE_PROMPT`` tokens and the cache
    they leave (this column's part of it); each row takes its block of
    the batch. With ``case["init_shards"]``, also whether
    ``sharding.init_shards`` gives this rank the shards of
    ``init_model``'s whole tree."""
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
        batch = {k: client_sharding(mesh, v.ndim).block(torch.from_numpy(v))
                 for k, v in case["batch"].items()}
        res = {}
        with torch.no_grad():
            logits, _ = T.forward(params, batch, cfg, mesh)
        res["logits"] = _np(logits)
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
        mem = memory_inputs(batch)
        with torch.no_grad():
            res["prefill"] = _np(pod.make_prefill_step(cfg, mesh)(
                params, {"tokens": batch["tokens"], **mem}))
            memory = T.memory_of(params, mem, cfg, mesh)
            prompt = batch["tokens"][:, :DECODE_PROMPT]
            B, S = prompt.shape
            cache = T.init_cache(cfg, B, S + DECODE_STEPS, device="cpu",
                                 dtype=torch.float32, mesh=mesh)
            serve = pod.make_serve_step(cfg, mesh)
            tokens = []
            for pos in range(S + DECODE_STEPS - 1):
                tok = prompt[:, pos:pos + 1] if pos < S else tok
                tok, cache = serve(params, cache, tok, pos, memory)
                if pos >= S - 1:
                    tokens.append(_np(tok))
        res["decode"] = np.concatenate(tokens, axis=1)
        res["cache"] = _tree_np(cache)
        if M > 1 and case.get("init_shards"):
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
