"""The JAX reference as an oracle for the port's tests.

``reference`` (a module-scoped fixture) imports the reference modules the
port's tests compare against. With jax releases that dropped
``jax.experimental.enable_x64``, ``repro.core`` cannot import; the fixture
then aliases the name to ``jax.enable_x64(True)`` for as long as the test
module runs, and on teardown removes the alias and forgets every ``repro``
module imported under it. Nothing is patched at import time, so the
collection of the JAX package's own test files is unchanged.
"""
import contextlib
import sys
import types

import jax
import jax.experimental
import numpy as np
import pytest
import torch

_REFERENCE_MODULES = (
    "repro.configs.base", "repro.core.buffer_stacked", "repro.core.client",
    "repro.core.flatten", "repro.core.osafl", "repro.core.resource",
    "repro.core.resource_stacked", "repro.data.online",
    "repro.data.video_caching", "repro.harness", "repro.kernels.ref",
    "repro.kernels.scored_reduce", "repro.models.small",
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
    ``repro.core.osafl`` and so on (the last dotted component)."""
    import importlib
    with reference_importable():
        mods = {name.rsplit(".", 1)[-1]: importlib.import_module(name)
                for name in _REFERENCE_MODULES}
        yield types.SimpleNamespace(**mods)


def to_numpy_tree(tree):
    """A JAX parameter tree as nested dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


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
