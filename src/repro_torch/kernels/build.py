"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``<checkout>/build/``
(listed in ``.gitignore``), named by a hash of its source and of every
header under ``csrc/`` (``*.cuh``, which the sources share), so an edit of
either rebuilds it. The build happens at first use; ``build()`` starts
one ``nvcc`` per source, all at once. ptxas's report (registers, spills)
is kept beside each library as ``lib<name>-<hash>.log``, so a cached build
returns it as a fresh one does. Libraries are loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("scored_reduce", "flash_attention", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc was not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA kernels need "
                       "the CUDA toolkit to build")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every named kernel that is not built yet, all in parallel.
    Returns ``{name: {"path", "seconds", "log"}}`` (``log`` holds ptxas's
    register and shared-memory report, read back from beside the library
    when it was built before; ``seconds`` is 0 then); raises on a failed
    compile. A library without its report is built again."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        path = library_path(name)
        if path.exists() and path.with_suffix(".log").exists():
            out[name] = {"path": path, "seconds": 0.0,
                         "log": path.with_suffix(".log").read_text()}
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name} "
                               f"(exit {proc.returncode}):\n{log}")
        tmp_log = tmp.with_suffix(f".log{os.getpid()}")
        tmp_log.write_text(log)
        os.replace(tmp, path)       # atomic: concurrent builders are safe
        os.replace(tmp_log, path.with_suffix(".log"))   # the report last
        out[name] = {"path": path, "seconds": time.perf_counter() - t0,
                     "log": log}
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built kernel library ``name``, compiling it on first use."""
    return ctypes.CDLL(str(build((name,))[name]["path"]))
