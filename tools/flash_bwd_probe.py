"""Where the Hopper flash-attention backward's time goes, on one CUDA card.

    python3 tools/flash_bwd_probe.py

Builds three copies of ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
with ``build.py``'s nvcc flags, into ``build/flash_bwd_probe/``: the kernel
as it is; ``no_turns``, whose dQ writer adds its partial sums without
waiting for its turn (the order of the adds, and so dq's bits, may change);
and ``no_dq_adds``, whose writer neither waits nor adds (dq is wrong). The
probes only bound what the ordered dQ accumulation costs. The main kernel
(``bwd_bf16_wgmma_kernel``, launched alone through the C entry point's
phase 2, its turn counters zeroed before each run) is timed with CUDA
events at the serving path's prefill shape (B=4, H=56, Hkv=8, S=4096,
D=128, bf16, causal), in turns (kernel, probes, probes reversed, kernel,
twice over); the preprocess and the dq conversion are timed once each;
ptxas's register and spill report of the kernel (D=128) is printed for each
build. Exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (4, 56, 8, 4096, 128)
_WAIT = "      if (seen != turn) wait_turn(p.turns + ws_tile(it), turn);\n"
_ADD = ("      if (turn == 0) {\n"
        "        bulk_store(dst, sdq, L::dq_bytes);\n"
        "      } else {\n"
        "        bulk_reduce_add(dst, sdq, L::dq_bytes);\n"
        "      }\n")
# name -> (text in the source, its replacement), each text found once
PATCHES = {
    "no_turns": [(_WAIT, "      (void)seen;\n")],
    "no_dq_adds": [(_WAIT, "      (void)seen;\n"),
                   (_ADD, "      (void)dst;\n")],
}


def build_all(out_dir: Path) -> dict:
    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, _nvcc
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("kernel", *PATCHES):
        text = src
        for old, new in PATCHES.get(name, ()):
            if text.count(old) != 1:
                raise SystemExit(f"flash_bwd_probe: patch {name} no longer "
                                 f"matches the source: {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"flash_bwd_probe: nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if ("Function properties" in line
                    and "bwd_bf16_wgmma_kernelILi128" in line):
                print(f"{name}: {lines[i + 1].strip()}; "
                      f"{lines[i + 2].split(':', 1)[-1].strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def time_ms(fn, iters: int = 10) -> float:
    fn()
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_probe: no CUDA card is available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as fa
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    libs = {k: fa.bind_bwd(v) for k, v in
            build_all(ROOT / "build" / "flash_bwd_probe").items()}
    B, H, Hkv, S, D = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, do = (torch.randn((B, H, S, D), generator=gen, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((B, Hkv, S, D), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    lse = torch.empty((B, H, S), device="cuda")
    o = fa.flash_attention_bhsd(q, k, v, lse=lse)
    out = [torch.empty_like(x) for x in (q, k, v)]
    scratch = fa._bwd_scratch(q)
    scale = D ** -0.5

    def launch(phase):
        if phase == fa.BWD_PHASES["main"]:
            scratch["turns"].zero_()
        fa._launch_bwd(q, k, v, o, lse, do, *out, scratch, True, scale,
                       phase)
    fa._bwd_library = lambda: libs["kernel"]        # the shipped source
    launch(7)
    fill = time_ms(lambda: scratch["turns"].zero_())
    print(f"preprocess: {time_ms(lambda: launch(1)):.4f} ms; dq conversion: "
          f"{time_ms(lambda: launch(4)):.4f} ms; turn counters' fill "
          f"{fill:.4f} ms (taken off the main kernel's times below)",
          flush=True)
    times = {name: [] for name in libs}
    order = list(libs) + list(libs)[::-1]
    for name in order * 2:
        fa._bwd_library = lambda lib=libs[name]: lib
        times[name].append(time_ms(lambda: launch(2)) - fill)
    flops = fa.bound_flops_bwd(q, k)
    for name, ms in times.items():
        med = statistics.median(ms)
        print(f"main kernel, {name}: median {med:.4f} ms, min {min(ms):.4f} "
              f"ms, {flops / med / 1e9:.1f} TFLOP/s; all "
              f"{[round(x, 4) for x in ms]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
