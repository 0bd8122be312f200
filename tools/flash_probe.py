"""Where the Hopper flash-attention kernel's time goes, on one CUDA card.

    python3 tools/flash_probe.py [--shape B,H,Hkv,S,D] [--dv DV]

Builds four copies of ``src/repro_torch/kernels/csrc/flash_attention.cu``
with ``build.py``'s nvcc flags, into ``build/flash_probe/``: the kernel as
it is; ``no_softmax``, whose consumers skip the softmax (P is the raw
scores: no max, no sum, no rescale); ``no_loads``, whose producer stops
loading k and v once the ring is full (the consumers reuse stale tiles);
and ``head_major``, the kernel with its blocks in the order before kv-head
ordering ((b, h) fastest, then the query tiles from the longest). The
first two probes give wrong outputs on purpose: they only bound what the
softmax and the loads cost; ``head_major`` computes the same function. Each is timed with CUDA events at the serving
path's prefill shape (B=4, H=56, Hkv=8, S=4096, D=128, bf16, causal) or
the one given, v of head dim ``--dv`` (D by default; MLA's prefill is
``--shape 4,128,128,4096,192 --dv 128``), in turns (kernel, probes, probes
reversed, kernel, twice over), beside ``scaled_dot_product_attention`` on
the same tensors; ptxas's register and spill report of the Hopper
kernel's instantiation that the shape runs is printed for each. Last, the kernel and the library
call without the causal mask, twice the work in blocks of twice the length:
if the kernel lost time per block (launch, prologue, epilogue), its rate
would rise there. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (4, 56, 8, 4096, 128)
# name -> (text in the source, its replacement), each text found once
PATCHES = {
    "no_softmax": [
        ("                                         float& a_hi) {\n",
         "                                         float& a_hi) {\n"
         "    a_lo = a_hi = 1.f;\n    return;\n"),
        ("void rescale(float (&o)[N], float a_lo, float a_hi) {\n",
         "void rescale(float (&o)[N], float a_lo, float a_hi) {\n  return;\n"),
    ],
    "no_loads": [
        ("        if (it >= kWsStages) mbar_wait(k_empty + 8 * s, freed);\n",
         "        if (it >= kWsStages) {\n"
         "          mbar_wait(k_empty + 8 * s, freed);\n"
         "          mbar_arrive(k_full + 8 * s);\n"
         "          mbar_wait(v_empty + 8 * s, freed);\n"
         "          mbar_arrive(v_full + 8 * s);\n"
         "          continue;\n"
         "        }\n"),
    ],
    "head_major": [
        ("  const int per_kv = p.nq * p.group;\n"
         "  const int bk = blockIdx.x / per_kv, rest = blockIdx.x % per_kv;\n"
         "  const int b = bk / p.Hkv, hk = bk % p.Hkv, h = hk * p.group + "
         "rest % p.group;\n"
         "  const int q0 = (p.nq - 1 - rest / p.group) * kWsBM;\n",
         "  const int heads = gridDim.x / p.nq;  // B * H\n"
         "  const int b = blockIdx.x % heads / p.H, h = blockIdx.x % heads % "
         "p.H;\n"
         "  const int hk = h / p.group;\n"
         "  const int q0 = (p.nq - 1 - static_cast<int>(blockIdx.x / heads))"
         " * kWsBM;\n"),
    ],
}


def bucket(D: int, Dv: int) -> tuple:
    """The Hopper kernel's (DQK, DV) instantiation for bf16 (D, Dv <= 128),
    as ``flash_attention_launch`` picks it."""
    if D <= 64:
        return 64, 64
    return (128 if D <= 128 else 192 if D <= 192 else 256), 128


def build_all(out_dir: Path, symbol: str) -> dict:
    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, _nvcc
    src = (CSRC / "flash_attention.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("kernel", *PATCHES):
        text = src
        for old, new in PATCHES.get(name, ()):
            if text.count(old) != 1:
                raise SystemExit(f"flash_probe: patch {name} no longer "
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
            raise SystemExit(f"flash_probe: nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Function properties" in line and symbol in line:
                print(f"{name}: {lines[i + 1].strip()}; "
                      f"{lines[i + 2].split(':', 1)[-1].strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def time_ms(fn, iters: int = 20) -> float:
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
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--shape", default=",".join(map(str, SHAPE)),
                      help="B,H,Hkv,S,D (default: the prefill shape)")
    args.add_argument("--dv", type=int, default=None,
                      help="v's head dim (default: D)")
    args = args.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_probe: no CUDA card is available")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    B, H, Hkv, S, D = map(int, args.shape.split(","))
    Dv = D if args.dv is None else args.dv
    if Dv > 128:
        raise SystemExit("flash_probe: the Hopper kernel takes Dv <= 128")
    dqk, dv = bucket(D, Dv)
    libs = {k: fa.bind(v) for k, v in build_all(
        ROOT / "build" / "flash_probe",
        f"flash_bf16_wgmma_kernelILi{dqk}ELi{dv}E").items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
               for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, Dv)))
    fa._library = lambda: libs["kernel"]        # the shipped source
    # one kv head and its query group, 512 keys
    G = H // Hkv
    small = (q[:1, :G, :512], k[:1, :1, :512], v[:1, :1, :512])
    plain = fa.flash_attention_plain(*small)
    got = fa.flash_attention_bhsd(*small)
    err = float((got.float() - plain.float()).abs().max())
    print(f"shape {(B, H, Hkv, S, D)}, Dv {Dv}: the kernel <{dqk}, {dv}>; "
          f"vs plain at (1, {G}, 1, {min(S, 512)}, {D}): max abs err {err}")
    if err > 2e-2:
        raise SystemExit("flash_probe: the kernel disagrees with its plain "
                         "version")
    times = {name: [] for name in libs}
    order = list(libs) + list(libs)[::-1]
    for name in order * 2:
        fa._library = lambda lib=libs[name]: lib
        times[name].append(time_ms(lambda: fa.flash_attention_bhsd(q, k, v)))
    library = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=H != Hkv))
    flops = fa.bound_flops(q, k, v)
    for name, ms in times.items():
        med = statistics.median(ms)
        print(f"{name}: median {med:.4f} ms, min {min(ms):.4f} ms, "
              f"{flops / med / 1e9:.1f} TFLOP/s; all "
              f"{[round(x, 4) for x in ms]}", flush=True)
    print(f"scaled_dot_product_attention: {library:.4f} ms, "
          f"{flops / library / 1e9:.1f} TFLOP/s")
    fa._library = lambda: libs["kernel"]
    full = fa.bound_flops(q, k, v, causal=False)
    for name, fn in (("kernel", lambda: fa.flash_attention_bhsd(
            q, k, v, causal=False)), ("scaled_dot_product_attention",
                                      lambda: F.scaled_dot_product_attention(
                                          q, k, v, enable_gqa=H != Hkv))):
        ms = [time_ms(fn) for _ in range(2)]
        print(f"not causal, {name}: {[round(x, 4) for x in ms]} ms, "
              f"{full / min(ms) / 1e9:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
