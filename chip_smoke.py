"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: its name and power limit (nvidia-smi) and torch's view;
  2. the build: every CUDA kernel of the port, compiled in parallel;
  3. the kernels: each kernel against its plain PyTorch version on the card
     at its path's shapes and at ragged ones, with times (CUDA events)
     beside the least time the card could take and one PyTorch library
     call that computes the same function; flash attention is timed twice
     at the prefill shape, on contiguous inputs and on the model's strided
     (B, S, H, D) views;
  4. small runs on the card against the same runs on the CPU (whose plain
     paths the CPU tests tie to the JAX reference): the harness with each
     of the six algorithms and the genie on the MLP, OSAFL on the CNN,
     SqueezeNet and LSTM, and the loop engine with the six algorithms on
     the MLP and OSAFL on the CNN; the CNN's and SqueezeNet's gradients
     on one batch in full f32 (and, as a control the check must see, with
     cuDNN's TF32 on); and a reduced deepseek-coder-33b (7:1 head groups
     kept) through prefill and decode;
  5. the FL main path: ``repro_torch.harness.run("osafl", ...)`` on the FCN
     at the paper's U=256 clients, with the kernels' launch counts reset
     just before and read just after;
  5b. the list API at full width: one round of real ``ClientUpdate``s of
     the FCN at U=256 from ``local_train`` on the card, fed to each loop
     server and to its stacked counterpart's ``round(updates)``, for the
     six algorithms, from the same weights;
  5c. the loop engine at full width: ``run("osafl", engine="loop")`` on the
     main path's configuration, 2 rounds;
  6. a breakdown of an FL main-path round by stage;
  6b. the paper's comparison grid at its widths and U=256, depth cut to 2-3
     rounds: the five baselines and the genie on the FCN (Dataset-1; OSAFL
     there is the main path's run), and OSAFL on the CNN, SqueezeNet
     (Dataset-1) and LSTM (Dataset-2, Table IV's recipe), each run with the
     launch counts reset just before and read just after;
  6c. determinism: the grid's CNN and SqueezeNet runs again, which must
     repeat bit for bit, in turns with the same runs with cuDNN free to
     pick its algorithms (the harness's hold bypassed), a control that
     times what the hold costs;
  7. the serving path: deepseek-coder-33b at full width (d_model 7168,
     56/8 heads, head_dim 128), depth cut to 8 layers, random weights from
     a seed: ``make_prefill_step`` on 4 x 4096-token prompts, then
     ``serve_decode.run`` (batch 8, 32-token prompts, 32 decode steps,
     4096-position cache), launch counts reset just before and read just
     after; a profile of one prefill call by kernel; then the flash
     prefill against the KV-cache decode path on one prompt.
Convolutions run in full f32 and deterministic inside every harness run
(cuDNN's TF32 and benchmarking are held off and restored after). The line
before the last is one JSON object with every kernel's numbers
("launches" from the kernel's own main path, "launches_by_path" from
every path); the last line is the result. Exits non-zero, with no result,
when there is no CUDA card or the port's sources are not beside this
file.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

MAIN_U = 256                        # the paper's cohort
MAIN_RUN = dict(model="fcn", dataset=1, num_clients=MAIN_U,
                capacity=(320, 640), arrivals=8, batch=16, rounds=3, seed=0)
MAIN_EVAL = 512
# scored_reduce on the FL main path and the grid's other OSAFL paths: the
# (U, N) buffers of the FCN, CNN, SqueezeNet and LSTM at U=256, N from each
# model's codec (the CNN's and the LSTM's N are not multiples of 8)
SCORED_MODELS = ("fcn", "cnn", "squeezenet", "lstm")
# the paper's comparison grid (benchmarks/table2_dataset1.py: every
# algorithm and the genie over fcn and cnn on Dataset-1; table4_dataset2.py
# :33-36: lstm on Dataset-2) at U=256, depth cut to 2 (FCN) or 3 rounds;
# OSAFL on the FCN is the FL main path's run
ALGS = ("osafl", "fedavg", "fedprox", "fednova", "afa_cd", "feddisco",
        "centralized")
GRID_D1 = dict(dataset=1, num_clients=MAIN_U, capacity=(320, 640),
               arrivals=8, batch=16, seed=0)
GRID_RUNS = (
    [(alg, dict(GRID_D1, model="fcn", rounds=2)) for alg in ALGS[1:]]
    + [("osafl", dict(GRID_D1, model=m, rounds=3))
       for m in ("cnn", "squeezenet")]
    + [("osafl", dict(GRID_D1, model="lstm", dataset=2, local_lr=0.2,
                      global_lr=20.0, rounds=3))])
GRID_EVAL = 512
# small runs, card against CPU: every algorithm and the genie on the MLP;
# OSAFL on the three other models. The CNN and SqueezeNet take global_lr=1:
# at the default 16 a one-ulp change of their weights moves a later
# round's loss by more than the 1e-4 gate (tests/test_torch_precision.py).
SMALL_MLP = dict(model="mlp", dataset=2, num_clients=16, rounds=3,
                 capacity=(16, 32), seed=3)
SMALL_CONV = dict(dataset=1, num_clients=4, rounds=2, capacity=(16, 32),
                  global_lr=1.0, seed=3)
SMALL_RUNS = (
    [(alg, SMALL_MLP) for alg in ALGS]
    + [("osafl", dict(SMALL_CONV, model=m)) for m in ("cnn", "squeezenet")]
    + [("osafl", dict(model="lstm", dataset=2, num_clients=8, rounds=3,
                      capacity=(16, 32), seed=3))]
    # the loop engine: every algorithm on the MLP, OSAFL on the CNN
    + [(alg, dict(SMALL_MLP, engine="loop")) for alg in ALGS[:-1]]
    + [("osafl", dict(SMALL_CONV, model="cnn", engine="loop"))])
# the list API and the loop engine at full width: the main path's FCN
# configuration (the loop engine's run cut to 2 rounds)
LOOP_RUN = dict(MAIN_RUN, rounds=2, engine="loop")
LIST_TOL = 1e-5         # tests/test_stacked_engine.py's loop-against-stacked
# The gate's loss cannot see cuDNN's TF32 at global_lr=1 (about 1e-5 from
# the CPU on an NVIDIA H100): the CNN's and SqueezeNet's gradients on
# one batch are held to the CPU's within GRAD_TOL (relative L2) in full f32,
# and must miss it with TF32 on
GRAD_TOL = 1e-5
# norms/mean_sq: the reference kernel test's rtol; dots: the same factor
# times sqrt(norms * mean_sq), the size of the terms a dot sums
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}

# flash attention: the serving path's prefill (B, H, Hkv, S, D), bf16,
# causal, timed on contiguous (B, H, S, D) inputs and on the model's
# (B, S, H, D) views; ragged and small shapes: S of one key, S ending
# mid-tile above one tile, D = 40 (filled to the 64 bucket), D = 256 (the
# mma.sync kernel); tests/test_kernels.py:26's tolerances
FLASH_MAIN = (4, 56, 8, 4096, 128)
FLASH_SHAPES = ((1, 7, 1, 1, 128), (2, 14, 2, 77, 64), (1, 4, 4, 130, 64),
                (2, 56, 8, 24, 128), (1, 8, 2, 512, 128), (2, 14, 2, 300, 128),
                (2, 14, 2, 130, 40), (1, 8, 2, 130, 256))
# the kernels of csrc/flash_attention.cu, by symbol (prefill_breakdown)
FLASH_SYMBOLS = ("flash_bf16_wgmma_kernel", "flash_bf16_kernel",
                 "flash_f32_kernel")
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the serving path: deepseek-coder-33b, depth cut 62 -> 8 (f32 weights of
# all 62 layers are 133 GB, more than the card holds)
SERVE_LAYERS = 8
SERVE_PREFILL = dict(batch=4, seq=4096)
SERVE_DECODE = dict(batch=8, prompt_len=32, decode_steps=32, cache_len=4096,
                    seed=1)
LOGIT_TOL = 2e-2                 # bf16 (tests/test_kernels.py:26)


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
        f"{torch.backends.cuda.matmul.allow_tf32}; cudnn tf32 "
        f"{torch.backends.cudnn.allow_tf32} (held off inside harness runs)")
    return name, smi


def build() -> None:
    from repro_torch.kernels.build import KERNELS
    from repro_torch.kernels.build import build as build_kernels
    t0 = time.perf_counter()
    out = build_kernels(KERNELS)
    say(f"build: {len(out)} kernel(s) in {time.perf_counter() - t0:.3f} s")
    for name, info in out.items():
        say(f"  {name}: {info['seconds']:.3f} s -> {info['path'].name}")
        # ptxas per kernel: registers and shared memory, the stack and
        # spill line under "Function properties", and any warning (a
        # serialised wgmma among them)
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "Compiling", "spill",
                                       "Function properties", "arning")):
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


def buffer_n(model: str) -> int:
    """N of a model's (U, N) contribution buffer: its codec's length."""
    from repro_torch.core.flatten import make_codec
    from repro_torch.models.small import init_small
    return make_codec(init_small(0, model, "cpu")).n


def kernels_phase() -> dict:
    n = {model: buffer_n(model) for model in SCORED_MODELS}
    rows = [check_scored_reduce(MAIN_U, n["fcn"], torch.float32, timed=True)]
    torch.cuda.empty_cache()
    rows.append(check_scored_reduce(MAIN_U, n["fcn"], torch.bfloat16,
                                    timed=True))
    torch.cuda.empty_cache()
    # the grid's other OSAFL paths: f32 timed, bf16 checked
    grid = {}
    for model in SCORED_MODELS[1:]:
        grid[model] = check_scored_reduce(MAIN_U, n[model], torch.float32,
                                          timed=True)
        rows.append(grid[model])
        rows.append(check_scored_reduce(MAIN_U, n[model], torch.bfloat16,
                                        timed=False))
        torch.cuda.empty_cache()
    for U, N in ((16, 18_404), (1, 17), (3, 131), (17, 4_099)):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_scored_reduce(U, N, dtype, timed=False))
    return {"main": rows[0], "grid": grid, "rows": rows}


def check_flash(shape, dtype, causal: bool, timed: bool,
                model_layout: bool = False) -> dict:
    """The kernel against its plain version on one draw. With
    ``model_layout`` the inputs are (B, S, H, D) tensors that go through
    ``ops.flash_attention`` as the model calls it (strided (B, H, S, D)
    views, no copies); the plain version and the library call take the same
    views."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    B, H, Hkv, S, D = shape
    gen = torch.Generator(device="cuda").manual_seed(S * 131 + H * 7 + D)
    if model_layout:
        qm = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        km = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
        vm = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
        q, k, v = (x.transpose(1, 2) for x in (qm, km, vm))

        def kernel():
            return ops.flash_attention(qm, km, vm, causal=causal).transpose(1, 2)
    else:
        q = torch.randn((B, H, S, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").to(dtype)

        def kernel():
            return fa.flash_attention_bhsd(q, k, v, causal=causal)
    out = kernel()
    plain = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    err = float((out.float() - plain.float()).abs().max())
    ok = torch.allclose(out.float(), plain.float(), atol=tol, rtol=tol)
    same = torch.equal(out, kernel())
    del plain
    row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
           "causal": causal, "layout": "BSHD views" if model_layout
           else "BHSD", "max_abs_err": err, "tol": tol, "ok": ok,
           "bitwise_repeat": same}
    if timed:
        flops = fa.bound_flops(q, k, causal=causal)
        nbytes = fa.bound_bytes(q, k, v)
        row["ms"] = time_ms(kernel, 20)
        row["plain_ms"] = time_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=causal), 2,
            warmup=1)
        row["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=D ** -0.5, enable_gqa=True),
            5)
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
        t_ops = flops / peak * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        row["bound_ms"] = max(t_ops, t_bytes)
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["tflop_per_s"] = flops / row["ms"] / 1e9
    say("flash_attention " + json.dumps(row))
    if not (ok and same):
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version or is not repeatable: {row}")
    return row


def flash_phase() -> dict:
    main = check_flash(FLASH_MAIN, torch.bfloat16, causal=True, timed=True)
    torch.cuda.empty_cache()
    main["model_layout"] = check_flash(FLASH_MAIN, torch.bfloat16,
                                       causal=True, timed=True,
                                       model_layout=True)
    torch.cuda.empty_cache()
    for shape in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                check_flash(shape, dtype, causal, timed=False)
    return main


def _close_tokens(a_logits, b_logits, tol: float) -> bool:
    """Greedy tokens agree wherever b's top-2 gap exceeds ``tol``."""
    top2 = torch.topk(b_logits.float(), 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > tol
    same = torch.argmax(a_logits, -1) == torch.argmax(b_logits, -1)
    return bool((same | ~clear).all())


def small_transformer_phase() -> None:
    """Reduced deepseek-coder-33b with its 7:1 head groups (14 over 2,
    d_model 448), the same imported weights on the card and on the CPU:
    ``make_prefill_step`` on a prompt, then 8 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_map
    from repro_torch.core.pod import make_prefill_step
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("deepseek-coder-33b").reduced(),
                              n_heads=14, n_kv_heads=2, d_model=448)
    host = T.init_model(torch.Generator().manual_seed(5), cfg)
    tree = tree_map(lambda t: t.numpy(), host)
    B, S, steps = 2, 24, 8
    prompt = torch.randint(0, cfg.vocab_size, (B, S + steps),
                           generator=torch.Generator().manual_seed(6))
    res = {}
    for dev in ("cuda", "cpu"):
        params = T.params_from_numpy(tree, cfg, device=dev)
        tok = prompt.to(dev)
        with torch.inference_mode():
            logits, _ = T.forward(params, {"tokens": tok[:, :S]}, cfg)
            nxt = make_prefill_step(cfg)(params, {"tokens": tok[:, :S]})
            # the prompt into the cache, then 8 steps (teacher-forced, so
            # both devices see the same tokens)
            cache = T.init_cache(cfg, B, S + steps, device=dev)
            dec = []
            for i in range(S + steps):
                dl, cache = T.decode_step(params, cache, tok[:, i:i + 1], i,
                                          cfg)
                if i >= S:
                    dec.append(dl[:, -1].float().cpu())
        res[dev] = (logits.float().cpu(), nxt.cpu(), torch.stack(dec, 1))
    (gl, gn, gd), (cl, cn, cd) = res["cuda"], res["cpu"]
    err = {"prefill_logits": float((gl - cl).abs().max()),
           "decode_logits": float((gd - cd).abs().max())}
    ok = (torch.allclose(gl, cl, atol=LOGIT_TOL, rtol=LOGIT_TOL)
          and torch.allclose(gd, cd, atol=LOGIT_TOL, rtol=LOGIT_TOL)
          and _close_tokens(gl[:, -1], cl[:, -1], LOGIT_TOL)
          and _close_tokens(gd, cd, LOGIT_TOL)
          and bool(torch.isfinite(gl).all() and torch.isfinite(gd).all()))
    say(f"small transformer (reduced deepseek-coder-33b, 14/2 heads, "
        f"d_model 448, bf16): cuda vs cpu max abs err {json.dumps(err)} "
        f"(tol {LOGIT_TOL}); prefill next tokens {gn.tolist()} / "
        f"{cn.tolist()}")
    if not ok:
        raise AssertionError("the transformer on the card drifted from the "
                             f"CPU run: {err}")


def scored_launches(alg: str, xc) -> int:
    """``scored_reduce`` launches a run should make: one a round of the
    stacked OSAFL server, none in the loop oracle (whose scores are the
    independent implementation the kernel is held against), a baseline or
    the genie."""
    return xc.rounds if alg == "osafl" and xc.engine != "loop" else 0


def small_run_phase() -> dict:
    """Each small run on the card and on the CPU with the same seed (native
    weights drawn on the host, so both start from the same numbers):
    participants exact, ``test_loss`` within rtol 1e-4, ``scored_reduce``
    launched as ``scored_launches`` says. Returns the loop runs' launches."""
    from repro_torch.harness import ExperimentConfig, run
    from repro_torch.kernels import scored_reduce as sr
    loop_launches = {}
    for alg, kw in SMALL_RUNS:
        xc = ExperimentConfig(**kw)
        sr.scored_reduce.launches = 0
        gpu = run(alg, xc, eval_samples=64)
        launches = sr.scored_reduce.launches
        if launches != scored_launches(alg, xc):
            raise AssertionError(f"small run {alg} {kw}: scored_reduce "
                                 f"launched {launches} times")
        if xc.engine == "loop":
            loop_launches[f"{alg} {kw['model']}"] = launches
        cpu = run(alg, xc, eval_samples=64, device="cpu")
        for g, c in zip(gpu, cpu):
            say(f"small run {alg} {kw['model']} {xc.engine} round "
                f"{g['round']}: cuda "
                f"loss {g['test_loss']:.6f} cpu loss {c['test_loss']:.6f} "
                f"rel {abs(g['test_loss'] / c['test_loss'] - 1):.2e} "
                f"participants {g.get('participants')}/"
                f"{c.get('participants')}")
            if (g.get("participants") != c.get("participants")
                    or abs(g["test_loss"] - c["test_loss"])
                    > 1e-4 * abs(c["test_loss"])):
                raise AssertionError("the run on the card drifted from the "
                                     f"CPU run: {alg} {kw}: {g} vs {c}")
        if len(gpu) != len(cpu) or len(gpu) != xc.rounds:
            raise AssertionError(f"{alg} {kw}: {len(gpu)} rounds on the "
                                 f"card, {len(cpu)} on the CPU")
    return loop_launches


def conv_grads(model: str, device: str) -> tuple:
    """Gradient (flat, float64 on the host) and loss of ``model``'s seeded
    weights on the eval batch of the CNN's and SqueezeNet's small run."""
    from repro_torch.harness import ExperimentConfig
    from repro_torch.harness.experiments import _stacked_setup
    from repro_torch.models.small import init_small, small_loss
    kw = next(kw for alg, kw in SMALL_RUNS if kw["model"] == model)
    xc = ExperimentConfig(**kw)
    batch = _stacked_setup("osafl", xc, 64, torch.device(device)).test_batch
    grads, loss = torch.func.grad_and_value(
        lambda p: small_loss(p, batch, model)[0])(
            init_small(xc.seed, model, device))
    leaves = torch.utils._pytree.tree_leaves(grads)
    return (torch.cat([g.reshape(-1).double().cpu() for g in leaves]),
            float(loss))


def conv_precision_phase() -> None:
    """The CNN's and SqueezeNet's gradients on the card against the CPU's:
    within GRAD_TOL (relative L2) with convolutions in full f32, as a run
    holds them (``full_f32_convolutions``, entered with the caller's TF32
    on), and past it with cuDNN's TF32 on, which shows the check sees it."""
    from repro_torch.device import full_f32_convolutions
    before = torch.backends.cudnn.allow_tf32
    try:
        for model in ("cnn", "squeezenet"):
            cpu, cpu_loss = conv_grads(model, "cpu")
            torch.backends.cudnn.allow_tf32 = True
            with full_f32_convolutions():
                f32, f32_loss = conv_grads(model, "cuda")
            tf32, tf32_loss = conv_grads(model, "cuda")
            row = {"model": model, "grad_tol": GRAD_TOL}
            for name, g, loss in (("f32", f32, f32_loss),
                                  ("tf32", tf32, tf32_loss)):
                row[name] = {"grad_rel_l2": float((g - cpu).norm()
                                                  / cpu.norm()),
                             "loss_rel": abs(loss / cpu_loss - 1)}
            say("convolution precision " + json.dumps(row))
            if not row["f32"]["grad_rel_l2"] <= GRAD_TOL:
                raise AssertionError(f"{model}: full-f32 gradients on the "
                                     f"card drifted from the CPU's: {row}")
            if not row["tf32"]["grad_rel_l2"] > GRAD_TOL:
                raise AssertionError(f"{model}: the gradient check cannot "
                                     f"see TF32: {row}")
    finally:
        torch.backends.cudnn.allow_tf32 = before


def fl_run(label: str, alg: str, kw: dict, eval_samples: int) -> dict:
    """One ``repro_torch.harness.run`` on the card with the launch counts
    reset just before and read just after; prints its rounds, wall time,
    peak memory and launches as one JSON line. Gates: ``scored_reduce``
    launched as ``scored_launches`` says (once a round of stacked OSAFL)
    and nothing launches flash attention; finite losses for every round; some
    participants (but in the genie, which has none)."""
    from repro_torch.harness import ExperimentConfig, run
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import scored_reduce as sr
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    xc = ExperimentConfig(**kw)
    t0 = time.perf_counter()
    sr.scored_reduce.launches = 0
    fa.flash_attention_bhsd.launches = 0
    hist = run(alg, xc, eval_samples=eval_samples)
    launches = {"scored_reduce": sr.scored_reduce.launches,
                "flash_attention": fa.flash_attention_bhsd.launches}
    wall = time.perf_counter() - t0
    row = {"alg": alg, "config": kw, "eval_samples": eval_samples,
           "wall_s": wall, "launches": launches,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "rounds": [{k: h.get(k) for k in (
               "round", "test_loss", "test_acc", "participants",
               "round_s", "request_gen_s")} for h in hist]}
    say(f"{label} " + json.dumps(row))
    want = scored_launches(alg, xc)
    if launches != {"scored_reduce": want, "flash_attention": 0}:
        raise AssertionError(f"{label} {alg} {kw['model']}: launches "
                             f"{launches}, expected scored_reduce {want}")
    if len(hist) != xc.rounds or not all(
            math.isfinite(h["test_loss"]) for h in hist):
        raise AssertionError(f"{label} {alg} {kw['model']}: non-finite or "
                             f"missing rounds: {hist}")
    if alg != "centralized" and not any(h["participants"] for h in hist):
        raise AssertionError(f"{label} {alg} {kw['model']}: no round had "
                             "participants")
    return row


def list_api_phase() -> dict:
    """One round of real ``ClientUpdate``s at full width (``LOOP_RUN``: the
    FCN, U=256): each client's arrivals, the scalar resource solve and
    ``local_train`` on the card, drawn as the loop engine's first round
    draws them; then the same list through each loop server and through
    its stacked counterpart's ``round(updates)``, both from the same
    weights. Gates: weights within LIST_TOL, OSAFL's scores within
    LIST_TOL, ``scored_reduce`` launched once by the stacked OSAFL round
    and by no other, flash attention by none. Prints each server round's
    synchronized time; returns each round's launches."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.baselines import make_server
    from repro_torch.core.client import local_train
    from repro_torch.core.flatten import tree_get, tree_paths
    from repro_torch.core.osafl import ClientUpdate
    from repro_torch.core.resource import (NetworkConfig, make_clients,
                                           optimize_round)
    from repro_torch.harness import MODEL_PARAMS, ExperimentConfig
    from repro_torch.harness.experiments import _arrive, _client_setup
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import scored_reduce as sr
    from repro_torch.models.small import init_small, small_loss
    dev = torch.device("cuda")
    xc = ExperimentConfig(**LOOP_RUN)
    U = xc.num_clients
    streams, rng, bufs, _ = _client_setup(xc, MAIN_EVAL, dev)
    w0 = init_small(xc.seed, xc.model, dev)
    clients = make_clients(rng, U, cell_radius_m=xc.cell_radius_m)
    grad_fn = torch.func.grad(lambda p, b: small_loss(p, b, xc.model)[0])
    t0 = _clock()
    decisions = optimize_round(rng, NetworkConfig(), clients,
                               MODEL_PARAMS[xc.model])
    solve_s = _clock() - t0
    ups = {"d": [], "w": []}
    for c in range(U):
        _arrive(rng, streams, bufs, xc, c)
        kappa = decisions[c].kappa
        if kappa < 1:
            continue                          # straggler
        d, w = local_train(w0, grad_fn, bufs[c], kappa, xc.local_lr,
                           xc.batch, rng)
        for key, tree in (("d", d), ("w", w)):
            ups[key].append(ClientUpdate(
                c, tree, kappa, data_size=bufs[c].size,
                label_hist=bufs[c].label_histogram()))
    train_s = _clock() - solve_s - t0
    out = {"config": LOOP_RUN, "updates": len(ups["d"]),
           "resource_solve_s": solve_s, "arrivals_local_train_s": train_s,
           "rounds": []}
    for alg in ALGS[:-1]:
        fl = FLConfig(num_clients=U, local_lr=xc.local_lr,
                      global_lr=(xc.global_lr if alg in ("osafl", "afa_cd")
                                 else 1.0), algorithm=alg)
        upd = ups["d" if alg in ("osafl", "fednova", "afa_cd") else "w"]
        row, got = {"alg": alg}, {}
        for engine in ("loop", "stacked"):
            srv = make_server(w0, dataclasses.replace(fl, engine=engine), U,
                              device=dev)
            sr.scored_reduce.launches = 0
            fa.flash_attention_bhsd.launches = 0
            t0 = _clock()
            params = srv.round(upd)
            row[f"{engine}_s"] = _clock() - t0
            row[f"{engine}_launches"] = {
                "scored_reduce": sr.scored_reduce.launches,
                "flash_attention": fa.flash_attention_bhsd.launches}
            got[engine] = (params, getattr(srv, "last_scores", None))
            del srv, params
            torch.cuda.empty_cache()
        (lp, ls), (sp, ss) = got["loop"], got["stacked"]
        row["max_abs_err"] = max(
            float((tree_get(lp, p) - tree_get(sp, p)).abs().max())
            for p in tree_paths(lp))
        if alg == "osafl":
            row["scores_max_abs_err"] = float(abs(ls - ss).max())
        del got, lp, sp
        say("list api " + json.dumps(row))
        want = 1 if alg == "osafl" else 0
        none = {"scored_reduce": 0, "flash_attention": 0}
        if (row["loop_launches"] != none or row["stacked_launches"]
                != dict(none, scored_reduce=want)):
            raise AssertionError(f"list api {alg}: launches {row}")
        if not (row["max_abs_err"] <= LIST_TOL
                and row.get("scores_max_abs_err", 0.0) <= LIST_TOL):
            raise AssertionError(f"list api {alg}: the stacked round "
                                 f"drifted from the loop server's: {row}")
        out["rounds"].append(row)
    say("list api setup " + json.dumps({k: v for k, v in out.items()
                                        if k != "rounds"}))
    if not 0 < out["updates"] < U:
        raise AssertionError(f"list api: {out['updates']} updates of {U} "
                             "clients, expected some and some stragglers")
    return out


def breakdown_phase(run_kw: dict, rounds: int = 2) -> None:
    """Where an OSAFL round's time goes: the stages of the harness's
    round (``repro_torch.harness.experiments._run_stacked``) in its order,
    each ended by a synchronize so that stages cannot overlap, plus the
    resource solve on the CPU for comparison; convolutions in full f32 and
    deterministic, as in a run. A separate run after the main path; its
    launches are not counted."""
    import numpy as np
    from repro_torch.core.client import make_vmapped_local_train
    from repro_torch.core.resource_stacked import optimize_round_batched
    from repro_torch.data.online import (binomial_arrivals_batched,
                                         draw_arrival_batch)
    from repro_torch.harness import ExperimentConfig
    from repro_torch.harness.experiments import _stacked_setup
    from repro_torch.device import (deterministic_convolutions,
                                    full_f32_convolutions)
    from repro_torch.models.small import small_loss
    dev = torch.device("cuda")
    xc = ExperimentConfig(**run_kw)
    s = _stacked_setup("osafl", xc, MAIN_EVAL, dev)
    step = make_vmapped_local_train(s.grad_fn, s.fl.local_lr,
                                    s.fl.kappa_max)

    def lap() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    with full_f32_convolutions(), deterministic_convolutions():
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
            say(f"breakdown {xc.model} round {t} (s): {json.dumps(stages)}")


def grid_phase(main: dict) -> list:
    """The paper's comparison grid at full width: the FL main path's run
    (``main``, OSAFL on the FCN) and ``GRID_RUNS``, each through
    ``fl_run``."""
    return [main] + [fl_run("grid run", alg, kw, GRID_EVAL)
                     for alg, kw in GRID_RUNS]


def determinism_phase(grid: list) -> list:
    """The grid's CNN and SqueezeNet runs again with the same seed: their
    ``test_loss``, ``test_acc`` and ``participants`` must repeat bit for
    bit. Around the rerun, the same run with cuDNN free to pick
    nondeterministic algorithms (the harness's
    ``deterministic_convolutions`` bypassed), so held and free runs
    alternate: the free runs' ``round_s`` beside the held runs' is what
    the hold costs; they are printed, not gated. Returns the reruns' and
    the free runs' rows."""
    import contextlib

    import repro_torch.harness.experiments as tex
    keys = ("test_loss", "test_acc", "participants")

    def free(first: dict) -> dict:
        held = tex.deterministic_convolutions
        tex.deterministic_convolutions = contextlib.nullcontext
        try:
            return fl_run("determinism control (cuDNN free)", first["alg"],
                          first["config"], GRID_EVAL)
        finally:
            tex.deterministic_convolutions = held

    rows = []
    for first in grid:
        if first["config"]["model"] not in ("cnn", "squeezenet"):
            continue
        before = free(first)
        again = fl_run("determinism rerun", first["alg"], first["config"],
                       GRID_EVAL)
        after = free(first)
        same = ([[r[k] for k in keys] for r in first["rounds"]]
                == [[r[k] for k in keys] for r in again["rounds"]])
        say("determinism " + json.dumps({
            "model": first["config"]["model"], "bit_identical": same,
            "round_s": {name: [r["round_s"] for r in x["rounds"]]
                        for name, x in (("held", first), ("free", before),
                                        ("held_again", again),
                                        ("free_again", after))}}))
        if not same:
            raise AssertionError(f"{first['config']['model']}: the same "
                                 "seed gave another history on the card")
        rows += [before, again, after]
    return rows


def _clock() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def forward_vs_decode(params, cfg, prompt, cache_dtype, exact=None) -> dict:
    """Last-position logits of ``forward`` (the flash path) against those
    of sequential ``decode_step``s over a cache (``_sdpa``), same prompt.
    ``exact``, the f32 run's forward logits, measures how far each path
    is from it; the run's own forward logits are returned under
    ``"logits"``."""
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import init_gqa_cache
    B, S = prompt.shape
    with torch.inference_mode():
        lf, _ = T.forward(params, {"tokens": prompt}, cfg)
        cache = {"dense": init_gqa_cache(cfg, B, S, dtype=cache_dtype,
                                         device=prompt.device,
                                         lead=(cfg.n_layers,))}
        for i in range(S):
            ld, cache = T.decode_step(params, cache, prompt[:, i:i + 1], i,
                                      cfg)
    a, b = lf[:, -1].float(), ld[:, -1].float()
    out = {"compute": cfg.dtype,
           "cache": str(cache_dtype).replace("torch.", ""),
           "max_abs_err": float((a - b).abs().max()),
           "mean_abs_logit": float(b.abs().mean()),
           "finite": bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
           "allclose": torch.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL),
           "tokens_agree": _close_tokens(a, b, LOGIT_TOL)}
    if exact is not None:
        out["forward_vs_f32_max_abs"] = float((a - exact).abs().max())
        out["decode_vs_f32_max_abs"] = float((b - exact).abs().max())
    return out, a


def prefill_breakdown(prefill, params, tokens) -> dict:
    """Device time of one prefill call by kernel (torch.profiler), grouped
    into the flash kernel, matrix products and everything else."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0)
        if us > 0 and ev.device_type.name == "CUDA":
            kernels.append((ev.key, us / 1e3, ev.count))
    groups = {"flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms, _ in kernels:
        low = name.lower()
        if any(sym in low for sym in FLASH_SYMBOLS):
            groups["flash_attention"] += ms
        elif any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass",
                                    "sm90_")):     # cuBLAS's kernel names
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {"device_ms": sum(groups.values()), "by_group_ms": groups,
            "top_kernels": [{"name": n[:80], "ms": ms, "count": c}
                            for n, ms, c in top]}


def serving_phase() -> dict:
    """deepseek-coder-33b at full width, 8 layers, seeded random weights on
    the card: prefill, then batched decode, then flash against the cache."""
    from repro_torch.configs import get_config
    from repro_torch.core.pod import make_prefill_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import scored_reduce as sr
    from repro_torch.launch import serve_decode
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("deepseek-coder-33b"),
                              n_layers=SERVE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = _clock()
    params = T.init_model(gen, cfg)
    init_s = _clock() - t0
    n_params = T.param_count(params)
    B, S = SERVE_PREFILL["batch"], SERVE_PREFILL["seq"]
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    prefill = make_prefill_step(cfg)

    fa.flash_attention_bhsd.launches = 0
    sr.scored_reduce.launches = 0
    prefill_s, per_call = [], []
    with torch.inference_mode():
        for _ in range(2):                 # the first call warms up cuBLAS
            before = fa.flash_attention_bhsd.launches
            t0 = _clock()
            nxt = prefill(params, {"tokens": tokens})
            prefill_s.append(_clock() - t0)
            per_call.append(fa.flash_attention_bhsd.launches - before)
    launches = {"flash_attention": fa.flash_attention_bhsd.launches,
                "scored_reduce": sr.scored_reduce.launches}
    breakdown = prefill_breakdown(prefill, params, tokens)
    breakdown["busy_share_of_timed_call"] = (breakdown["device_ms"] / 1e3
                                             / prefill_s[-1])
    prompt = tokens[:2, :SERVE_DECODE["prompt_len"]]
    del tokens
    gate, exact = forward_vs_decode(
        params, dataclasses.replace(cfg, dtype="float32"), prompt,
        torch.float32)
    checks = [gate, forward_vs_decode(params, cfg, prompt, torch.bfloat16,
                                      exact)[0]]
    del params
    torch.cuda.empty_cache()
    # the second leg of the path (the checks above launch too, so the
    # counts restart here)
    fa.flash_attention_bhsd.launches = 0
    sr.scored_reduce.launches = 0
    dec = serve_decode.run(cfg, **SERVE_DECODE)
    launches["flash_attention"] += fa.flash_attention_bhsd.launches
    launches["scored_reduce"] += sr.scored_reduce.launches
    peak = torch.cuda.max_memory_allocated()
    nb, npl, nd = (SERVE_DECODE["batch"], SERVE_DECODE["prompt_len"],
                   SERVE_DECODE["decode_steps"])
    out = {"config": f"{cfg.name} n_layers={cfg.n_layers} d_model="
                     f"{cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
                     f"head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
                     f"vocab={cfg.vocab_size}",
           "params": n_params, "init_s": init_s,
           "prefill": {"batch": B, "seq": S, "seconds": prefill_s,
                       "tokens_per_s": [B * S / t for t in prefill_s],
                       "flash_launches_per_call": per_call},
           "decode": {**SERVE_DECODE, "prefill_s": dec["prefill_s"],
                      "decode_s": dec["decode_s"],
                      "prefill_tokens_per_s": nb * npl / dec["prefill_s"],
                      "decode_tokens_per_s": nb * nd / dec["decode_s"]},
           "max_memory_allocated": peak, "launches": launches,
           "prefill_breakdown": breakdown, "forward_vs_decode": checks}
    say("serving path " + json.dumps(out))
    toks = dec["tokens"]
    if per_call != [cfg.n_layers] * len(per_call):
        raise AssertionError(f"flash_attention launched {per_call} times per "
                             f"prefill call, not {cfg.n_layers}")
    if not (bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all())
            and toks.shape == (nb, nd)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())):
        raise AssertionError("the serving path gave tokens outside the "
                             "vocabulary")
    # the gate: f32 compute with an f32 cache, where the two paths differ
    # only in their order of sums. In bf16 the cache path's _sdpa rounds
    # its logits to bf16 (as the reference's does), so the bf16 row is
    # printed beside it with each path's distance from the f32 logits.
    if not (gate["finite"] and gate["allclose"] and gate["tokens_agree"]
            and checks[1]["finite"]):
        raise AssertionError(f"forward (flash) and decode (cache) disagree: "
                             f"{checks}")
    return out


def main() -> int:
    name, smi = card()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    build()
    kern = kernels_phase()
    flash = flash_phase()
    small_loop = small_run_phase()
    small_transformer_phase()
    conv_precision_phase()
    main = fl_run("main path", "osafl", MAIN_RUN, MAIN_EVAL)
    list_api = list_api_phase()
    loop = fl_run("loop engine", "osafl", LOOP_RUN, MAIN_EVAL)
    breakdown_phase(MAIN_RUN)
    grid = grid_phase(main)
    determinism = determinism_phase(grid)
    for alg, kw in GRID_RUNS:
        if kw["model"] != "fcn":
            breakdown_phase(kw)
    serving = serving_phase()
    m = kern["main"]
    # each path's own counts, each read after a reset: the FL main path,
    # every run of the grid (the main path's among them) and its
    # determinism reruns, the loop engine at full width and its small runs,
    # each server round of the list API, and the serving path; "launches"
    # is the count of the kernel's own main path
    by_path = {k: {"fl_main": main["launches"][k],
                   "grid": {f"{g['alg']} {g['config']['model']}":
                            g["launches"][k] for g in grid},
                   "determinism": [g["launches"][k] for g in determinism],
                   "loop_fl": loop["launches"][k],
                   "list_api": {f"{r['alg']} {e}": r[f"{e}_launches"][k]
                                for r in list_api["rounds"]
                                for e in ("loop", "stacked")},
                   "serving": serving["launches"][k]}
               for k in ("scored_reduce", "flash_attention")}
    by_path["scored_reduce"]["loop_small"] = small_loop
    line = {"kernels": [{
        "name": "scored_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scored_reduce.cu",
        "replaces": "src/repro/kernels/scored_reduce.py:32",
        "launches": main["launches"]["scored_reduce"],
        "launches_by_path": by_path["scored_reduce"],
        "max_abs_err": max(m["max_abs_err"].values()),
        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m["library_ms"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "launches": serving["launches"]["flash_attention"],
        "launches_by_path": by_path["flash_attention"],
        "max_abs_err": flash["max_abs_err"], "ms": flash["ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"]}]}
    say(smi)                        # the card's name and power limit
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
