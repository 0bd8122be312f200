"""Dry run on the production meshes (``repro/launch/dryrun.py``): trace one
step of every (architecture x input shape) as rank 0 of the (16, 16) or
(2, 16, 16) mesh and record its per-device FLOPs, traffic, collectives and
peak memory for the roofline.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b \\
      --shape train_4k [--multipod] [--engine exact_tp|fedavg] \\
      [--sketch K] [--remat] [--kappa K] [--out experiments/dryrun]

The reference lowers and compiles the step with XLA. Here "lower and
compile" is a trace: a process group of 256 (512) ranks on PyTorch's
``fake`` backend (``torch.testing._internal.distributed.fake_pg``), whose
collectives move nothing, and rank 0's step run on fake tensors of its
shards (``FakeTensorMode``: shapes and dtypes, no storage, no arithmetic).
FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``, traffic from
``launch/op_analysis.OpCounter``, the collectives from
``core/shmap.record_collectives`` and the peak memory from
``torch.distributed._tools.mem_tracker.MemTracker``. Attention on fake CPU
tensors takes the flash wrapper's plain version, so the FLOPs and traffic
are the materialised-score path, as the reference's XLA baseline is;
``memory_s_flash_projected`` removes the score-shaped traffic. The
roofline uses one H100 SXM's data-sheet peaks (989 TFLOP/s dense bf16,
3.35 TB/s HBM, NVLink 4 at 450 GB/s a direction): the port's card, not the
reference's v5e.

The port runs every family tensor-parallel (the MoE decoders also
expert-parallel): exact_tp and fedavg on the tp rules, and prefill on
them under every engine, as the reference places prefill weights by the
tp rules even for recompute. The FSDP regime of recompute and stale
(training and decode of the >100B MoE archs by default) is ROADMAP.md
A7's second half, and a combo that needs it writes a record that says so
(``skipped``, as ``benchmarks/roofline.py`` reads it).

Online pod mode (``--online``) instead *executes* ``repro_torch.harness.
run`` on the pod engine for every pod engine on a ('pod', 'data') mesh of
P x D ranks, asserting finite losses and that the per-round history
schema matches the stacked engine's; start the ranks with torchrun:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \\
      -m repro_torch.launch.dryrun --online --pod 2 --data 4 --rounds 3 \\
      --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import INPUT_SHAPE_BY_NAME, TRANSFORMER_ARCHS
from repro_torch.configs import get_config
from repro_torch.configs.base import FLConfig, InputShape, ModelConfig
from repro_torch.core.flatten import (tree_from_leaves, tree_get, tree_map,
                                      tree_paths)
from repro_torch.core.shmap import (client_rows, grouped,
                                    record_collectives)
from repro_torch.data.synthetic import train_batch_shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import (OpCounter, add_collectives,
                                            top_collectives, top_traffic)
from repro_torch.launch.sharding import local_shard, param_spec

# one H100 SXM (NVIDIA data sheet, dense, at its 700 W limit)
PEAK_FLOPS = 989e12          # bf16 FLOP/s
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s a direction (NVLink 4: 900 GB/s both)

# >100B MoE archs need FSDP (replicas can't fit TP-only) -> recompute engine
FSDP_ARCHS = {"deepseek-v3-671b", "arctic-480b"}


def default_engine(arch: str) -> str:
    return "recompute" if arch in FSDP_ARCHS else "exact_tp"


def abstract_params(cfg: ModelConfig):
    """The parameter tree as meta tensors (shapes and dtypes only)."""
    from repro_torch.models.transformer import init_model
    return init_model(None, cfg)


def input_specs(arch: str, shape_name: str):
    """Meta-tensor stand-ins for every model input of this combo:
    ``(cfg, shape, params, inputs)``; decode's ``inputs`` hold the cache,
    the (B, 1) tokens, the position and the memory (whisper's frames or
    the vision decoder's patches, else None)."""
    from repro_torch.models.transformer import init_cache
    cfg = get_config(arch)
    shp = INPUT_SHAPE_BY_NAME[shape_name]
    params = abstract_params(cfg)
    if shp.kind == "train":
        return cfg, shp, params, train_batch_shapes(cfg, shp.global_batch,
                                                    shp.seq_len)
    if shp.kind == "prefill":
        seq = shp.seq_len
        if cfg.encoder is not None:
            seq = min(seq, cfg.encoder.max_decoder_len)
        batch = train_batch_shapes(cfg, shp.global_batch, seq)
        batch.pop("labels")
        return cfg, shp, params, batch
    cache = init_cache(cfg, shp.global_batch, shp.seq_len, device="meta")
    tokens = torch.empty((shp.global_batch, 1), dtype=torch.int32,
                         device="meta")
    memory = None
    if cfg.encoder is not None:
        memory = torch.empty((shp.global_batch, cfg.encoder.n_frames,
                              cfg.d_model), dtype=torch.bfloat16,
                             device="meta")
    if cfg.vision is not None:
        memory = torch.empty((shp.global_batch, cfg.vision.n_patches,
                              cfg.d_model), dtype=torch.bfloat16,
                             device="meta")
    return cfg, shp, params, {"cache": cache, "tokens": tokens,
                              "pos": shp.seq_len - 1, "memory": memory}


def skip_reason(cfg: ModelConfig, shp: InputShape) -> str | None:
    if shp.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention architecture: 500k decode cache is unbounded; "
                "skipped per DESIGN.md long_500k applicability table")
    return None


def _not_ported(cfg: ModelConfig, engine: str,
                shp: InputShape) -> str | None:
    """Why the port cannot trace this combo on the production mesh yet.
    Prefill places its weights by the tp rules under every engine (the
    reference's ``fsdp = engine == "recompute" and kind != "prefill"``)."""
    if engine not in ("exact_tp", "fedavg") and shp.kind != "prefill":
        return (f"engine {engine!r} runs with FSDP in the reference "
                "(ROADMAP.md A7's second half, its FSDP item: recompute "
                "and stale on (R, M) meshes)")
    return None


def model_flops(cfg: ModelConfig, shp: InputShape) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE), D = tokens/step."""
    n_active = active_params(cfg)
    if shp.kind == "train":
        d = shp.global_batch * shp.seq_len
        return 6.0 * n_active * d
    if shp.kind == "prefill":
        seq = shp.seq_len
        if cfg.encoder is not None:
            seq = min(seq, cfg.encoder.max_decoder_len)
        return 2.0 * n_active * shp.global_batch * seq
    return 2.0 * n_active * shp.global_batch          # decode: 1 token


def total_params(cfg: ModelConfig) -> int:
    params = abstract_params(cfg)
    return sum(int(np.prod(tree_get(params, p).shape))
               for p in tree_paths(params))


def active_params(cfg: ModelConfig) -> float:
    """Parameters touched per token (MoE: top_k of num_experts experts)."""
    params = abstract_params(cfg)
    total = 0.0
    for path in tree_paths(params):
        n = float(np.prod(tree_get(params, path).shape))
        if cfg.moe and "moe" in path and path[-1] in ("w_gate", "w_up",
                                                       "w_down"):
            n *= cfg.moe.top_k / cfg.moe.num_experts
        total += n
    return total


@contextlib.contextmanager
def fake_group(world_size: int):
    """A process group of ``world_size`` ranks on PyTorch's ``fake``
    backend, this process rank 0, destroyed on exit. Refused while
    another group runs."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if grouped():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "one is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _row_block(t: torch.Tensor, rows: int, dim: int = 0) -> tuple:
    """Rank 0's rows of a leading (batch) dimension split over the client
    rows where it divides, else the whole dimension (the reference's
    replication where the divisibility check fails)."""
    shape = list(t.shape)
    if shape[dim] % rows == 0:
        shape[dim] //= rows
    return tuple(shape)


def _trace_step(cfg, shp, params, inputs, mesh, engine, fl, sketch) -> dict:
    """Rank 0's step on fake tensors: its analysis, log and peak bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import pod
    from repro_torch.core.scores import _signs_cached
    from repro_torch.models.transformer import init_cache
    rows = client_rows(mesh)
    paths = tree_paths(params)
    shard_shapes = [(tuple(local_shard(
        tree_get(params, p), param_spec(p, tree_get(params, p), mesh=mesh),
        mesh, rank=0).shape), tree_get(params, p).dtype) for p in paths]
    seq = shp.seq_len if shp.kind in ("train", "prefill") else 0
    counter = OpCounter(seq)
    tracker = MemTracker()
    try:
        with FakeTensorMode(), tracker:
            # the inputs are made before the counters start: the step's
            # traffic and FLOPs, its peak memory with the inputs in it
            local = tree_from_leaves(paths, [
                torch.empty(s, dtype=d) for s, d in shard_shapes])
            if shp.kind == "decode":
                B = _row_block(inputs["tokens"], rows)[0]
                cache = tree_map(lambda t: torch.zeros(t.shape,
                                                       dtype=t.dtype),
                                 init_cache(cfg, B, shp.seq_len,
                                            device="meta", mesh=mesh))
                args = (local, cache, torch.zeros((B, 1), dtype=torch.int32),
                        inputs["pos"])
                if inputs["memory"] is not None:
                    args += (torch.zeros(_row_block(inputs["memory"], rows),
                                         dtype=inputs["memory"].dtype),)
                step = pod.make_serve_step(cfg, mesh)
            else:
                batch = {k: torch.zeros(_row_block(v, rows), dtype=v.dtype)
                         for k, v in inputs.items()}
                args = (local, batch)
                if shp.kind == "prefill":
                    step = pod.make_prefill_step(cfg, mesh)
                elif engine == "exact_tp":
                    step = pod.make_tp_train_step(cfg, fl, mesh,
                                                  sketch_dim=sketch)
                else:
                    step = pod.make_fedavg_train_step(cfg, fl, mesh)
            arg_bytes = sum(t.nbytes for t in _tensors(args))
            with FlopCounterMode(display=False) as flops, counter, \
                    record_collectives() as log:
                out = step(*args)
            out_bytes = sum(t.nbytes for t in _tensors(out))
    finally:
        _signs_cached.cache_clear()   # no fake signs outlive the trace
    snap = tracker.get_tracker_snapshot("peak")
    peak = max(v.get("Total", 0) for v in snap.values()) if snap else 0
    analysis = add_collectives(counter.analysis, log)
    analysis.flops = float(flops.get_total_flops())
    return {"analysis": analysis, "counter": counter, "log": log,
            "argument_bytes": int(arg_bytes), "output_bytes": int(out_bytes),
            "peak_bytes": int(peak)}


def _tensors(x) -> list:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
                engine: str | None = None, sketch: int = 0,
                remat: bool = False, kappa: int = 1,
                fl: FLConfig | None = None):
    """Trace one combo's step as rank 0 of the production mesh on the fake
    backend. Returns ``(trace, meta)``; ``trace`` is None for a skipped
    combo, whose ``meta`` says why."""
    cfg, shp, params, inputs = input_specs(arch, shape_name)
    if remat:
        cfg = dataclasses.replace(cfg, remat=True)
    reason = skip_reason(cfg, shp)
    if reason:
        return None, {"arch": arch, "shape": shape_name, "skipped": reason}
    engine = engine or default_engine(arch)
    reason = _not_ported(cfg, engine, shp)
    if reason:
        return None, {"arch": arch, "shape": shape_name, "engine": engine,
                      "skipped": reason}
    n_ranks = 512 if multi_pod else 256
    t0 = time.time()
    with fake_group(n_ranks):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        fl = fl or FLConfig(kappa_max=kappa, num_clients=client_rows(mesh))
        trace = _trace_step(cfg, shp, params, inputs, mesh, engine, fl,
                            sketch)
        mesh_shape = dict(mesh.shape)
    meta = {"arch": arch, "shape": shape_name, "engine": engine,
            "multi_pod": multi_pod, "sketch": sketch,
            "compile_s": time.time() - t0, "mesh": mesh_shape}
    return trace, meta


def roofline(trace: dict, meta: dict, cfg: ModelConfig,
             shp: InputShape) -> dict:
    n_chips = 512 if meta["multi_pod"] else 256
    analysis = trace["analysis"]
    per_dev_flops = analysis.flops
    global_flops = per_dev_flops * n_chips
    per_dev_coll = analysis.total_collective_bytes
    per_dev_traffic = analysis.traffic_bytes
    compute_s = global_flops / (n_chips * PEAK_FLOPS)
    memory_s = per_dev_traffic / HBM_BW
    collective_s = per_dev_coll / NVLINK_BW
    # flash projection: the fused kernel keeps the (seq x seq) scores on
    # chip; reported beside the materialised-score baseline, never instead
    memory_s_flash = (per_dev_traffic - analysis.score_traffic_bytes) / HBM_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shp)
    temp = max(trace["peak_bytes"] - trace["argument_bytes"], 0)
    return {
        **meta,
        "n_chips": n_chips,
        "per_device": {
            **analysis.as_dict(),
            "memory": {
                "argument_bytes": trace["argument_bytes"],
                "output_bytes": trace["output_bytes"],
                "temp_bytes": temp,
                "peak_bytes": trace["peak_bytes"],
            },
            "top_collectives": top_collectives(trace["log"], 8),
            "top_traffic": top_traffic(trace["counter"], 8),
        },
        "roofline": {**terms, "dominant": dominant,
                     "memory_s_flash_projected": memory_s_flash,
                     "score_traffic_bytes": analysis.score_traffic_bytes,
                     "step_time_lower_bound_s": max(terms.values())},
        "model_flops": mf,
        "useful_flops_ratio": mf / max(global_flops, 1.0),
        "total_params": total_params(cfg),
        "active_params": active_params(cfg),
    }


def run_one(arch, shape_name, *, multi_pod=False, engine=None, sketch=0,
            remat=False, kappa=1, out_dir="experiments/dryrun",
            verbose=True):
    trace, meta = lower_combo(arch, shape_name, multi_pod=multi_pod,
                              engine=engine, sketch=sketch, remat=remat,
                              kappa=kappa)
    meta["remat"] = remat
    meta["kappa"] = kappa
    if trace is None:
        rec = meta
    else:
        rec = roofline(trace, meta, get_config(arch),
                       INPUT_SHAPE_BY_NAME[shape_name])
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    suffix = "multipod" if multi_pod else "pod"
    if engine:
        suffix += f"_{engine}"
    if sketch:
        suffix += f"_sketch{sketch}"
    if remat:
        suffix += "_remat"
    if kappa > 1:
        suffix += f"_kappa{kappa}"
    fn = out / f"{arch}__{shape_name}__{suffix}.json"
    fn.write_text(json.dumps(rec, indent=2, default=float))
    if verbose:
        rl = rec.get("roofline")
        if rl:
            print(f"{arch} x {shape_name} [{suffix}]: "
                  f"dominant={rl['dominant']} "
                  f"compute={rl['compute_s']:.4f}s "
                  f"memory={rl['memory_s']:.4f}s "
                  f"collective={rl['collective_s']:.4f}s")
        else:
            print(f"{arch} x {shape_name}: SKIPPED — {rec['skipped']}")
    return rec


def run_online(*, pod: int, data: int | None, rounds: int, clients: int,
               model: str, out_dir: str, engines=None, device=None) -> list:
    """Execute the online pod harness for every engine flavour on a
    ('pod', 'data') mesh of ``pod`` x ``data`` ranks of the running
    process group (``data`` defaults to its size over ``pod``). Raises
    SystemExit(1) on any non-finite loss or history-schema mismatch;
    returns the per-engine records, which rank 0 writes as one JSON into
    ``out_dir``."""
    import torch.distributed as dist

    from repro_torch.harness import (POD_ENGINES, ExperimentConfig,
                                     resolve, run)
    from repro_torch.launch.mesh import make_mesh
    ranks = dist.get_world_size() if grouped() else 1
    data = data or max(ranks // pod, 1)
    mesh = make_mesh((pod, data), ("pod", "data"), device)
    rank0 = mesh.rank == 0
    xc = ExperimentConfig(model=model, dataset=2, num_clients=clients,
                          rounds=rounds, capacity=(12, 24), arrivals=4,
                          batch=8, seed=5, request_backend="stacked")
    schema = set(run("osafl", dataclasses.replace(xc, rounds=1),
                     eval_samples=64, device=mesh.device)[0])
    records, failures = [], []
    for engine in (engines or POD_ENGINES):
        alg = "fedavg" if engine == "fedavg" else "osafl"
        if rank0:
            print("plan:", resolve(alg, xc, mesh=mesh,
                                   pod_engine=engine).describe())
        t0 = time.time()
        hist = run(alg, xc, eval_samples=64, mesh=mesh, pod_engine=engine)
        losses = [h["test_loss"] for h in hist]
        if not all(np.isfinite(losses)):
            failures.append(f"{engine}: non-finite losses {losses}")
        bad = [i for i, h in enumerate(hist) if set(h) != schema]
        if bad:
            failures.append(f"{engine}: history schema mismatch at rounds "
                            f"{bad} (want {sorted(schema)})")
        records.append({"engine": engine, "alg": alg, "history": hist,
                        "wall_s": time.time() - t0})
        if rank0:
            print(f"online {engine:10s} [{alg}] losses "
                  + " ".join(f"{l:.4f}" for l in losses)
                  + f" ({records[-1]['wall_s']:.1f}s)")
    fn = Path(out_dir) / f"online__{model}__U{clients}__{pod}x{data}.json"
    if rank0:
        fn.parent.mkdir(parents=True, exist_ok=True)
        fn.write_text(json.dumps({
            "mesh": {"pod": pod, "data": data}, "clients": clients,
            "rounds": rounds, "model": model, "records": records},
            indent=2, default=float))
    if failures:
        for f in failures:
            print("FAIL", f)
        raise SystemExit(1)
    if rank0:
        print(f"online pod dryrun OK: {len(records)} engines x {rounds} "
              f"rounds on a {pod}x{data} ('pod','data') mesh -> {fn}")
    return records


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--engine", default=None)
    ap.add_argument("--sketch", type=int, default=0)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--kappa", type=int, default=1)
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--online", action="store_true",
                    help="run the online pod harness (real tensors, one "
                         "rank a device of a ('pod', 'data') mesh) instead "
                         "of the traced sweep")
    ap.add_argument("--pod", type=int, default=2)
    ap.add_argument("--data", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--model", default="mlp")
    ap.add_argument("--device", default=None,
                    help="online mode: each rank's device (default "
                         "cuda:LOCAL_RANK); 'cpu' with the gloo backend")
    args = ap.parse_args()
    if args.online:
        import torch.distributed as dist
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
        try:
            run_online(pod=args.pod, data=args.data, rounds=args.rounds,
                       clients=args.clients, model=args.model,
                       out_dir=args.out, device=args.device)
        finally:
            dist.destroy_process_group()
        return
    archs = TRANSFORMER_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPE_BY_NAME) if args.shape == "all" else [args.shape]
    for a in archs:
        for s in shapes:
            t0 = time.time()
            try:
                run_one(a, s, multi_pod=args.multipod, engine=args.engine,
                        sketch=args.sketch, remat=args.remat,
                        kappa=args.kappa, out_dir=args.out)
            except Exception as e:
                import traceback
                print(f"FAIL {a} x {s}: {type(e).__name__}: {e}")
                traceback.print_exc()
            print(f"  ({time.time() - t0:.1f}s)")


if __name__ == "__main__":
    main()
