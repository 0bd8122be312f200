"""The JAX reference as an oracle for the port's tests.

``reference`` (a module-scoped fixture) imports the reference modules the
port's tests compare against. With jax releases that dropped
``jax.experimental.enable_x64``, ``repro.core`` cannot import; the fixture
then aliases the name to ``jax.enable_x64(True)`` for as long as the test
module runs, and on teardown removes the alias and forgets every ``repro``
module imported under it. Nothing is patched at import time, so the
collection of the JAX package's own test files is unchanged.

The file also holds the port's entry-point device rule and its import
guard: no file of ``src/repro_torch/`` and not ``chip_smoke.py`` imports
jax, jaxlib or the JAX package, and the port imports with them blocked.
"""
import ast
import contextlib
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest
import torch

_REFERENCE_MODULES = (
    "repro.checkpoint",
    "repro.configs", "repro.configs.base", "repro.core.baselines",
    "repro.core.buffer", "repro.core.buffer_stacked",
    "repro.core.client", "repro.core.flatten", "repro.core.osafl",
    "repro.core.pod", "repro.core.resource", "repro.core.resource_stacked",
    "repro.core.scores",
    "repro.data.online", "repro.data.video_caching",
    "repro.data.video_caching_stacked", "repro.harness",
    "repro.kernels.ops", "repro.kernels.ref", "repro.kernels.scored_reduce",
    "repro.models.attention", "repro.models.layers", "repro.models.small",
    "repro.models.transformer",
    "repro.core.cohort", "repro.core.hierarchy",
    "repro.scenarios", "repro.scenarios.base", "repro.scenarios.library",
    "repro.core.round_fused", "repro.launch.serve",
    "repro.optim", "repro.data.synthetic",
    "repro.core.convergence", "repro.core.shmap", "repro.launch.mesh",
)


@contextlib.contextmanager
def reference_importable():
    """Make ``repro.core`` importable on this jax for the duration."""
    alias = not hasattr(jax.experimental, "enable_x64")
    before = set(sys.modules)
    if alias:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    try:
        yield
    finally:
        if alias:
            del jax.experimental.enable_x64
            for name in set(sys.modules) - before:
                if name == "repro" or name.startswith("repro."):
                    del sys.modules[name]


@pytest.fixture(scope="module")
def reference():
    """Namespace of reference modules: ``reference.osafl`` is
    ``repro.core.osafl`` and so on (the last dotted component; where two
    share it, the later one takes its last two joined by ``_``:
    ``reference.base`` is ``repro.configs.base``, ``reference.
    scenarios_base`` is ``repro.scenarios.base``)."""
    import importlib
    with reference_importable():
        mods = {}
        for name in _REFERENCE_MODULES:
            key = name.rsplit(".", 1)[-1]
            if key in mods:
                key = "_".join(name.rsplit(".", 2)[-2:])
            mods[key] = importlib.import_module(name)
        yield types.SimpleNamespace(**mods)


def to_numpy_tree(tree):
    """A JAX parameter tree as nested dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def run_both(reference, monkeypatch, alg, kw, eval_samples=32,
             rtol=1e-4):
    """``alg`` under the config ``kw`` through the reference's
    ``harness.run`` and the port's on the CPU, the port started from the
    reference's initial weights (it cannot draw threefry ones); asserts
    the same rounds with the same participants and ``test_loss`` within
    ``rtol``, and returns both histories."""
    import jax
    import repro_torch.harness.experiments as tex
    from repro_torch.harness import ExperimentConfig, run
    from repro_torch.models.small import params_from_numpy
    want = reference.harness.run(
        alg, reference.harness.ExperimentConfig(**kw),
        eval_samples=eval_samples)
    seed = kw.get("seed", 0)
    w0 = to_numpy_tree(reference.small.init_small(
        jax.random.PRNGKey(seed), kw["model"]))
    monkeypatch.setattr(tex, "init_small",
                        lambda seed, name, device: params_from_numpy(
                            name, w0, device))
    got = run(alg, ExperimentConfig(**kw), eval_samples=eval_samples,
              device="cpu")
    assert len(got) == len(want) == kw["rounds"]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["round"] == w["round"]
        assert g["participants"] == w["participants"]
        np.testing.assert_allclose(g["test_loss"], w["test_loss"],
                                   rtol=rtol)
    return got, want


# -- tests of the port's entry-point device rule --------------------------

def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    from repro_torch.harness import ExperimentConfig, run
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("osafl", ExperimentConfig(model="mlp", dataset=2, num_clients=2,
                                      rounds=1, capacity=(8, 9)),
            eval_samples=8)


def test_explicit_cpu_device_is_honoured():
    from repro_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")


def test_reference_fixture_restores_jax(reference):
    # inside the fixture the reference imports; the alias is the fixture's
    assert hasattr(reference.resource_stacked, "optimize_round_batched")


# -- the port stands alone: no jax, nothing of the JAX package --------------

_ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_sources():
    return sorted((_ROOT / "src" / "repro_torch").rglob("*.py")) + [
        _ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_sources_import_no_jax_and_nothing_of_the_reference():
    bad = [f"{p.relative_to(_ROOT)}:{line} imports {root}"
           for p in _port_sources() for root, line in _imported_roots(p)
           if root in _FORBIDDEN]
    assert not bad, bad
    assert len(_port_sources()) > 20


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n")
    env = {**os.environ, "PYTHONPATH": str(_ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 20
