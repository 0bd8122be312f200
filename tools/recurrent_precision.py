"""How far the recurrent families' bf16 paths lie from f32 at full width,
in the JAX reference and in the PyTorch port, on the same weights, on the
CPU.

    PYTHONPATH=src python tools/recurrent_precision.py [--arch ARCH ...]
        [--zamba-groups 1] [--batch 2] [--seq 512] [--threads 4]

For each architecture (xlstm-350m at full width and depth; zamba2-2.7b at
full width with its depth cut to ``--zamba-groups`` groups of 6 Mamba2
layers, each followed by the shared attention block): the weights come from
the reference's ``init_model`` (``PRNGKey(0)``) and go into the port with
``params_from_numpy``. Each package then runs, over the same ``--batch`` x
``--seq`` tokens (512 is a multiple of both chunk sizes, 64 and 256, and
twice the mLSTM's, so both chunked forms run): ``forward`` in f32 and in
bf16 compute, and ``decode_step`` token by token in bf16 compute with bf16
KV caches (the recurrent states are f32 in both). It prints one JSON line
per architecture with, for each package,

  bf16_vs_f32           max |bf16 forward - f32 forward| over every logit
  decode_vs_f32         max |bf16 decode  - f32 forward|
  bf16_fwd_vs_decode    max |bf16 forward - bf16 decode|
  *_last                the same at the last position alone (the numbers
                        ``chip_smoke.py``'s phase 7c prints)

beside ``port / reference`` for each, and the port's f32 forward against
the reference's. The tests hold the port's bf16 to the reference's own
distance with a quarter's headroom (``BF16_HEADROOM`` in
``tests/test_torch_ssm_models.py``); ``within_headroom`` applies that rule
here. The attention of zamba2's shared block takes ``_sdpa`` in the
reference (``REPRO_USE_FLASH`` unset) and the port's flash wrapper, whose
plain version runs on the CPU.

This imports both packages, runs on the CPU only, and is not part of the
tests: each architecture takes ~6.5 GB of host memory and 6-8 minutes
(both packages, 8 CPU cores).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import resource
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

HEADROOM = 1.25          # tests/test_torch_ssm_models.py's BF16_HEADROOM


def _reference():
    """The reference's modules, importable on a jax without
    ``jax.experimental.enable_x64`` (the tests' oracle context)."""
    import importlib
    from test_torch_oracle import reference_importable
    ctx = reference_importable()
    ctx.__enter__()
    return (importlib.import_module("repro.configs"),
            importlib.import_module("repro.models.transformer"))


def _config(configs, arch: str, groups: int):
    cfg = configs.get_config(arch)
    if cfg.hybrid is not None:
        cfg = dataclasses.replace(
            cfg, n_layers=groups * cfg.hybrid.shared_attn_every)
    return cfg


def _run_reference(jt, jc, w, tokens) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    out = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(jc, dtype=dtype)
        fwd = jax.jit(lambda p, t, c=c: jt.forward(p, {"tokens": t}, c)[0])
        out[f"fwd_{dtype}"] = np.asarray(
            fwd(w, jnp.asarray(tokens)).astype(jnp.float32))
    c = dataclasses.replace(jc, dtype="bfloat16")
    B, S = tokens.shape
    cache = jt.init_cache(c, B, S)
    step = jax.jit(lambda p, ca, t, i: jt.decode_step(p, ca, t, i, c))
    logits = []
    for i in range(S):
        lg, cache = step(w, cache, jnp.asarray(tokens[:, i:i + 1]),
                         jnp.int32(i))
        logits.append(np.asarray(lg.astype(jnp.float32)))
    out["dec_bfloat16"] = np.concatenate(logits, axis=1)
    return out


def _run_port(tc, tp, tokens) -> dict:
    import numpy as np
    import torch
    from repro_torch.models import transformer
    out = {}
    t = torch.from_numpy(tokens)
    with torch.inference_mode():
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(tc, dtype=dtype)
            out[f"fwd_{dtype}"] = transformer.forward(
                tp, {"tokens": t}, c)[0].float().numpy()
        c = dataclasses.replace(tc, dtype="bfloat16")
        B, S = tokens.shape
        cache = transformer.init_cache(c, B, S, device="cpu",
                                       dtype=torch.bfloat16)
        logits = []
        for i in range(S):
            lg, cache = transformer.decode_step(tp, cache, t[:, i:i + 1], i,
                                                c)
            logits.append(lg.float().numpy())
    out["dec_bfloat16"] = np.concatenate(logits, axis=1)
    return out


def _distances(r: dict) -> dict:
    import numpy as np

    def gap(a, b, last=False):
        if last:
            a, b = a[:, -1], b[:, -1]
        return float(np.abs(a - b).max())
    f32, bf, dec = r["fwd_float32"], r["fwd_bfloat16"], r["dec_bfloat16"]
    out = {}
    for last in (False, True):
        sfx = "_last" if last else ""
        out["bf16_vs_f32" + sfx] = gap(bf, f32, last)
        out["decode_vs_f32" + sfx] = gap(dec, f32, last)
        out["bf16_fwd_vs_decode" + sfx] = gap(bf, dec, last)
    out["mean_abs_f32_logit"] = float(np.abs(f32).mean())
    return out


def measure(arch: str, groups: int, batch: int, seq: int) -> dict:
    import jax
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    os.environ.pop("REPRO_USE_FLASH", None)
    configs, jt = _reference()
    jc = _config(configs, arch, groups)
    tc = get_config(arch)
    if tc.hybrid is not None:
        tc = dataclasses.replace(tc, n_layers=jc.n_layers)
    t0 = time.perf_counter()
    w = jax.jit(lambda: jt.init_model(jax.random.PRNGKey(0), jc))()
    w = jax.tree.map(np.asarray, w)
    tp = transformer.params_from_numpy(w, tc, device="cpu")
    init_s = time.perf_counter() - t0
    tokens = np.random.default_rng(0).integers(
        0, jc.vocab_size, size=(batch, seq)).astype(np.int32)
    t0 = time.perf_counter()
    ref = _run_reference(jt, jc, w, tokens)
    ref_s = time.perf_counter() - t0
    del w
    t0 = time.perf_counter()
    port = _run_port(tc, tp, tokens)
    port_s = time.perf_counter() - t0
    rd, pd = _distances(ref), _distances(port)
    ratio = {k: pd[k] / rd[k] for k in rd if rd[k] > 0}
    return {
        "arch": arch, "n_layers": jc.n_layers, "d_model": jc.d_model,
        "params": transformer.param_count(tp), "batch": batch, "seq": seq,
        "reference": rd, "port": pd, "port_over_reference": ratio,
        "port_f32_vs_reference_f32": float(np.abs(
            port["fwd_float32"] - ref["fwd_float32"]).max()),
        "within_headroom": all(
            pd[k] <= HEADROOM * rd[k]
            for k in ("bf16_vs_f32", "decode_vs_f32", "bf16_fwd_vs_decode")),
        "seconds": {"init": init_s, "reference": ref_s, "port": port_s},
        "max_rss_gb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+",
                    default=["xlstm-350m", "zamba2-2.7b"])
    ap.add_argument("--zamba-groups", type=int, default=1)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    import torch
    torch.set_num_threads(args.threads)
    ok = True
    for arch in args.arch:
        row = measure(arch, args.zamba_groups, args.batch, args.seq)
        print(json.dumps(row), flush=True)
        ok &= row["within_headroom"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
