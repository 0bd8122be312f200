"""Where the recurrent families' serving time goes on the host, on one
CUDA card.

    python3 tools/recurrent_probe.py

For zamba2-2.7b and xlstm-350m at full width and depth (seeded random f32
weights, bf16 compute, as ``chip_smoke.py``'s phase 7c serves them): one
decode step of batch 8 over a 4096-position cache, its wall time (the
mean of ten steps ending in a synchronize) beside its device time and
launches from a profile of one step; for xlstm-350m also one 4 x 4096
prefill call under the profiler, with the seconds the profiled call takes
and the seconds each way of summing its device events by kernel takes:
``key_averages()`` (which builds the whole event tree first) and the raw
device events that ``chip_smoke.device_breakdown`` sums. Prints one JSON
line per model. Exits non-zero without a card.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
DECODE = dict(batch=8, cache_len=4096, warm=3, steps=10)
PREFILL = dict(batch=4, seq=4096)


def _sync_s() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def profiled(fn) -> dict:
    """One call of ``fn`` under the profiler (host and device activity):
    its seconds, then the seconds of each way to sum its device events."""
    from torch.profiler import ProfilerActivity, profile
    t0 = _sync_s()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    raw_ms, launches = 0.0, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name == "CUDA" and not ev.is_user_annotation():
            raw_ms += ev.duration_ns() / 1e6
            launches += 1
    t2 = time.perf_counter()
    return {"profiled_call_s": t1 - t0, "raw_events_s": t2 - t1,
            "device_ms": raw_ms, "launches": launches, "_prof": prof}


def key_averages_s(prof) -> dict:
    t0 = time.perf_counter()
    ms = sum(getattr(ev, "self_device_time_total", 0) / 1e3
             for ev in prof.key_averages()
             if ev.device_type.name == "CUDA")
    return {"key_averages_s": time.perf_counter() - t0,
            "key_averages_device_ms": ms}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("recurrent_probe: no CUDA card is available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.pod import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    for arch in ("zamba2-2.7b", "xlstm-350m"):
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = T.init_model(gen, cfg)
        row = {"config": arch, "card": torch.cuda.get_device_name(0)}
        B, L = DECODE["batch"], DECODE["cache_len"]
        cache = T.init_cache(cfg, B, L, device="cuda")
        serve = make_serve_step(cfg)
        tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                            device="cuda")
        with torch.inference_mode():
            for i in range(DECODE["warm"]):
                tok, cache = serve(params, cache, tok, i)
            t0 = _sync_s()
            for i in range(DECODE["steps"]):
                tok, cache = serve(params, cache, tok, DECODE["warm"] + i)
            row["decode_step_wall_ms"] = (_sync_s() - t0) / DECODE[
                "steps"] * 1e3
            step = profiled(lambda: serve(params, cache, tok, 32))
            step.pop("_prof")
            row["decode_step_profile"] = step
            del cache
            if cfg.ssm.kind == "xlstm":
                tokens = torch.randint(
                    0, cfg.vocab_size, (PREFILL["batch"], PREFILL["seq"]),
                    generator=gen, device="cuda")
                prefill = make_prefill_step(cfg)
                prefill(params, {"tokens": tokens})           # warm-up
                call = profiled(lambda: prefill(params, {"tokens": tokens}))
                call.update(key_averages_s(call.pop("_prof")))
                row["prefill_profile"] = call
        print(json.dumps(row), flush=True)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
