"""The forward flash kernels of this checkout against another build of the
same source file, bit for bit, on one CUDA card.

    python3 tools/flash_build_compare.py OTHER_ROOT

OTHER_ROOT is another checkout of the repository, for example the parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists. Both ``src/repro_torch/kernels/csrc/flash_attention.cu`` are built
with ``build.py``'s nvcc flags into ``build/flash_compare/`` (ptxas's
report of each Hopper-kernel instantiation is printed) and run on the same
inputs: every shape of ``chip_smoke.FLASH_SHAPES`` with D <= 128 (the
Hopper kernel's <64, 64> and <128, 128> in bf16, the CUDA-core kernel in
f32), both dtypes, causal and not, on contiguous (B, H, S, D) tensors and
on the model's strided (B, S, H, D) views, each with the log-sum-exp
written. A build whose C entry point takes one head dim (no ``Dv``
argument) is called without it. Prints one line per comparison and exits
non-zero unless every output and log-sum-exp is equal bit for bit, or
without a card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("src/repro_torch/kernels/csrc/flash_attention.cu")


def build_both(other: Path, out_dir: Path) -> dict:
    """{"this", "other"}: (the loaded library, whether it takes Dv)."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, root in (("this", ROOT), ("other", other)):
        cu = root / SOURCE
        so = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(cu.parent), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so, "int D, int Dv" in cu.read_text())
    libs = {}
    for name, (proc, so, has_dv) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"flash_build_compare: nvcc failed on {name}:"
                             f"\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Function properties" in line and "wgmma_kernel" in line:
                print(f"{name}: {line.split('for ')[-1][-60:]}: "
                      f"{lines[i + 1].strip()}; "
                      f"{lines[i + 2].split(':', 1)[-1].strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.flash_attention_launch.argtypes = [
            ctypes.c_int, *[ctypes.c_void_p] * 5,
            ctypes.POINTER(ctypes.c_longlong),
            *[ctypes.c_int] * (6 if has_dv else 5),
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.flash_attention_launch.restype = ctypes.c_int
        libs[name] = (lib, has_dv)
    return libs


def launch(lib, has_dv: bool, q, k, v, causal: bool):
    """One launch on (B, H, S, D) views; returns (out, lse)."""
    B, H, S, D = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, S), device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(st for x in (q, k, v, out) for st in x.stride()[:3]))
    dims = (B, H, k.shape[1], S, D) + ((v.shape[-1],) if has_dv else ())
    err = lib.flash_attention_launch(
        {torch.float32: 0, torch.bfloat16: 1}[q.dtype], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), strides,
        *dims, D ** -0.5, int(causal),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"flash_build_compare: launch failed ({err})")
    return out, lse


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    other = Path(sys.argv[1]).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("flash_build_compare: no CUDA card is available")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import FLASH_SHAPES
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    libs = build_both(other, ROOT / "build" / "flash_compare")
    differ = 0
    for B, H, Hkv, S, D in (s for s in FLASH_SHAPES if s[-1] <= 128):
        gen = torch.Generator(device="cuda").manual_seed(S * 131 + H + D)
        base = [torch.randn(shape, generator=gen, device="cuda")
                for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]
        for dtype in (torch.float32, torch.bfloat16):
            model = [x.to(dtype) for x in base]
            views = {"BSHD views": [x.transpose(1, 2) for x in model],
                     "BHSD": [x.transpose(1, 2).contiguous() for x in model]}
            for layout, (q, k, v) in views.items():
                for causal in (True, False):
                    a, b = (launch(*libs[n], q, k, v, causal)
                            for n in ("this", "other"))
                    torch.cuda.synchronize()
                    same = [torch.equal(x, y) for x, y in zip(a, b)]
                    differ += not all(same)
                    print(f"{(B, H, Hkv, S, D)} {str(dtype)[6:]} {layout} "
                          f"causal={causal}: output "
                          f"{'equal' if same[0] else 'DIFFERS'}, lse "
                          f"{'equal' if same[1] else 'DIFFERS'}", flush=True)
    print(f"flash_build_compare: {differ} comparison(s) differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
