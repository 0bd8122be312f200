"""The dry run (``repro_torch.launch.dryrun``) against the reference's
``repro/launch/dryrun.py`` on the CPU: ``total_params``,
``active_params``, ``model_flops`` and ``skip_reason`` for every
architecture and input shape (the reference counts on ``jax.eval_shape``
trees, the port on meta tensors; cached per config, which changes no
number); one dense combo traced as rank 0 of the (16, 16) production mesh
on PyTorch's fake process-group backend, whose record has the reference's
keys, a ``useful_flops_ratio`` in (0.01, 1] and the model axis's
collectives; the MoE decoders at full width with their depth cut
(deepseek-v3-671b's prefill under its default engine, arctic-480b's
exact_tp training step), traced the same way, and so are whisper-medium's
prefill and zamba2-2.7b's decode steps (32k, and 500k: it is
sub-quadratic); the records of combos outside the tensor-parallel slice;
and ``run_online`` on two gloo ranks of a ('pod', 'data') mesh."""
import dataclasses
import functools
import importlib
import json
import os

import jax
import numpy as np
import pytest

from repro_torch.configs import (INPUT_SHAPE_BY_NAME, INPUT_SHAPES,
                                 TRANSFORMER_ARCHS, get_config)
from repro_torch.launch import dryrun
from test_torch_oracle import reference  # noqa: F401
import torch_pod_mesh_ranks
import torch_tp_ranks


@pytest.fixture(scope="module")
def ref_dryrun(reference):
    """The reference's dryrun module. Importing it sets XLA_FLAGS for a
    512-device host platform when unset; the variable is restored at once
    (this process's jax is already up) so no later process sees it. Its
    ``abstract_params`` is cached per config for the module's run."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        mod = importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    plain = mod.abstract_params
    mod.abstract_params = functools.lru_cache(maxsize=None)(plain)
    yield mod
    mod.abstract_params = plain


@pytest.fixture(scope="module")
def port_counts():
    """The port's abstract params cached per config, as the reference's."""
    plain = dryrun.abstract_params
    dryrun.abstract_params = functools.lru_cache(maxsize=None)(plain)
    yield
    dryrun.abstract_params = plain


def test_input_shapes_are_the_references(reference):
    assert [dataclasses.asdict(s) for s in INPUT_SHAPES] == [
        dataclasses.asdict(s) for s in reference.base.INPUT_SHAPES]
    assert list(INPUT_SHAPE_BY_NAME) == list(
        reference.base.INPUT_SHAPE_BY_NAME)
    assert TRANSFORMER_ARCHS == reference.configs.TRANSFORMER_ARCHS


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_parameter_counts_and_model_flops_are_the_references(
        ref_dryrun, port_counts, reference, arch):
    cfg, jcfg = get_config(arch), reference.configs.get_config(arch)
    assert dryrun.total_params(cfg) == ref_dryrun.total_params(jcfg)
    assert dryrun.active_params(cfg) == ref_dryrun.active_params(jcfg)
    assert dryrun.default_engine(arch) == ref_dryrun.default_engine(arch)
    for shp, jshp in zip(INPUT_SHAPES, reference.base.INPUT_SHAPES):
        assert dryrun.model_flops(cfg, shp) == ref_dryrun.model_flops(
            jcfg, jshp), shp.name
        assert dryrun.skip_reason(cfg, shp) == ref_dryrun.skip_reason(
            jcfg, jshp), shp.name


@pytest.fixture(scope="module")
def dense_record(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    return dryrun.run_one("qwen1.5-4b", "decode_32k", out_dir=out,
                          verbose=False), out


def test_a_dense_combo_traces_on_the_fake_production_mesh(dense_record):
    """qwen1.5-4b's decode step on (16, 16): 16 columns split each head
    inside it (2560 / 16 = 160 columns), so every column gathers q, k and
    v and runs every head; its logits are vocab-split (151,936 / 16)."""
    rec, out = dense_record
    for key in ("per_device", "roofline", "model_flops",
                "useful_flops_ratio", "total_params", "active_params"):
        assert key in rec, key
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert rec["n_chips"] == 256
    assert 0.01 < rec["useful_flops_ratio"] <= 1.0
    per = rec["per_device"]
    assert per["flops"] > 0 and per["traffic_bytes"] > 0
    assert per["memory"]["peak_bytes"] >= per["memory"]["argument_bytes"] > 0
    # every layer's MLP and attention sum over the model axis, the vocab's
    # greedy token is gathered, and q, k, v are gathered each layer
    cfg = get_config("qwen1.5-4b")
    assert per["collective_counts"]["all-reduce"] >= 2 * cfg.n_layers
    assert per["collective_counts"]["all-gather"] >= 3 * cfg.n_layers
    rl = rec["roofline"]
    assert rl["step_time_lower_bound_s"] == max(
        rl["compute_s"], rl["memory_s"], rl["collective_s"])
    assert rl["dominant"] in ("compute_s", "memory_s", "collective_s")
    saved = json.loads((out / "qwen1.5-4b__decode_32k__pod.json").read_text())
    assert saved["useful_flops_ratio"] == rec["useful_flops_ratio"]


# the MoE decoders' depth cut for their traced records: deepseek-v3's 3
# dense layers and one MoE layer, arctic's first two (MoE) layers
MOE_DEPTH = {"deepseek-v3-671b": 4, "arctic-480b": 2}


@pytest.mark.parametrize("arch, shape, engine", (
    ("deepseek-v3-671b", "prefill_32k", None),
    ("arctic-480b", "train_4k", "exact_tp")))
def test_moe_decoders_trace_at_full_width(monkeypatch, tmp_path, arch,
                                          shape, engine):
    """Full width, depth cut to ``MOE_DEPTH``, as rank 0 of (16, 16): the
    prefill under the default engine (recompute: prefill places its
    weights by the tp rules under every engine) and exact_tp's training
    step. Each layer's experts, attention and MLP sum over the model
    axis; the record has the reference's keys and a useful-FLOPs ratio in
    (0.01, 1]."""
    def cut(name):
        cfg = get_config(name)
        return dataclasses.replace(cfg, n_layers=MOE_DEPTH.get(
            name, cfg.n_layers))
    monkeypatch.setattr(dryrun, "get_config", cut)
    rec = dryrun.run_one(arch, shape, engine=engine, out_dir=tmp_path,
                         verbose=False)
    assert "skipped" not in rec
    assert rec["engine"] == (engine or "recompute")
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert 0.01 < rec["useful_flops_ratio"] <= 1.0
    per = rec["per_device"]
    assert per["flops"] > 0 and per["traffic_bytes"] > 0
    assert per["memory"]["peak_bytes"] >= per["memory"]["argument_bytes"] > 0
    # every layer's attention and experts (the MoE layers) or MLP sum over
    # the model axis, forward only in prefill and twice with training
    n = MOE_DEPTH[arch]
    assert per["collective_counts"]["all-reduce"] >= 2 * n
    assert rec["total_params"] == dryrun.total_params(cut(arch))


@pytest.mark.parametrize("arch", ("arctic-480b", "deepseek-v3-671b"))
@pytest.mark.parametrize("shape", ("train_4k", "decode_32k"))
def test_moe_default_engine_waits_on_fsdp(tmp_path, arch, shape):
    """The >100B MoE archs train and decode under recompute by default,
    which places their weights by the FSDP rules: a record naming A7's
    FSDP item, no trace."""
    rec = dryrun.run_one(arch, shape, out_dir=tmp_path, verbose=False)
    assert rec["engine"] == "recompute"
    assert "A7" in rec["skipped"] and "FSDP" in rec["skipped"]
    assert "roofline" not in rec


# the recurrent and cross-attention families' depth cut for their traced
# records: one group of zamba2's 6 Mamba2 layers and its shared block;
# whisper's 2 encoder and 2 decoder blocks
FAMILY_DEPTH = {"zamba2-2.7b": dict(n_layers=6),
                "whisper-medium": dict(n_layers=2)}


def _family_cut(name):
    cfg = get_config(name)
    kw = dict(FAMILY_DEPTH.get(name, {}))
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder,
                                            n_layers=kw["n_layers"])
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("arch, shape", (
    ("whisper-medium", "prefill_32k"), ("zamba2-2.7b", "decode_32k"),
    ("zamba2-2.7b", "long_500k")))
def test_recurrent_and_cross_families_trace_at_full_width(monkeypatch,
                                                          tmp_path, arch,
                                                          shape):
    """Full width, depth cut to ``FAMILY_DEPTH``, as rank 0 of (16, 16)
    under the default engine (exact_tp): whisper's prefill of 448 tokens
    over 1,500 frames and zamba2's decode step (its local Mamba2 heads and
    kv heads), each layer's attention, Mamba2 block and MLP summing over
    the model axis. The record has a useful-FLOPs ratio in (0.01, 1];
    the 500k decode's is only held to (0, 1]: its batch of one sequence
    is whole on all 16 rows, whose useful FLOPs are that one sequence's
    (0.0055 at full depth)."""
    monkeypatch.setattr(dryrun, "get_config", _family_cut)
    rec = dryrun.run_one(arch, shape, out_dir=tmp_path, verbose=False)
    assert "skipped" not in rec
    assert rec["engine"] == "exact_tp"
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert 0.0 < rec["useful_flops_ratio"] <= 1.0
    if shape != "long_500k":
        assert rec["useful_flops_ratio"] > 0.01
    per = rec["per_device"]
    assert per["flops"] > 0 and per["traffic_bytes"] > 0
    assert per["memory"]["peak_bytes"] >= per["memory"]["argument_bytes"] > 0
    n = _family_cut(arch).n_layers
    assert per["collective_counts"]["all-reduce"] >= 2 * n
    assert rec["total_params"] == dryrun.total_params(_family_cut(arch))


def test_combos_outside_the_slice_write_what_they_need(tmp_path):
    """MoE (recompute on FSDP by default, training and decode), and the
    500k decode of a full-attention arch: a record saying why, no
    trace."""
    for arch, shape, word in (("arctic-480b", "train_4k", "A7"),
                              ("deepseek-v3-671b", "decode_32k", "A7"),
                              ("qwen1.5-4b", "train_4k", "A7"),
                              ("deepseek-coder-33b", "long_500k",
                               "unbounded")):
        engine = "recompute" if arch == "qwen1.5-4b" else None
        rec = dryrun.run_one(arch, shape, engine=engine, out_dir=tmp_path,
                             verbose=False)
        assert word in rec["skipped"], (arch, shape)
        assert "roofline" not in rec


def test_run_online_on_two_gloo_ranks(tmp_path):
    payload = dict(pod=2, data=1, rounds=2, clients=4, model="mlp",
                   out_dir=str(tmp_path / "json"),
                   engines=("exact_tp", "fedavg"))
    results, _ = torch_pod_mesh_ranks.spawn(torch_tp_ranks.online_job, 2,
                                            payload, tmp_path)
    for records in results:
        assert [r["engine"] for r in records] == ["exact_tp", "fedavg"]
        for r in records:
            assert len(r["history"]) == 2
            assert all(np.isfinite(h["test_loss"]) for h in r["history"])
    # both ranks hold the same model: the same histories
    for a, b in zip(*results):
        assert [h["test_loss"] for h in a["history"]] == [
            h["test_loss"] for h in b["history"]]
    saved = json.loads((tmp_path / "json" / "online__mlp__U4__2x1.json")
                       .read_text())
    assert saved["mesh"] == {"pod": 2, "data": 1}
