"""The three FL examples of the port (``repro_torch.launch.quickstart``,
``resource_optimization`` and ``train_fl_video_caching``) on the CPU at a
reduced size, against the reference's scripts in ``examples/`` where their
draws are the port's:

  * ``resource_optimization``: host numpy both sides; the port's printout
    equals the reference script's, character for character.
  * ``quickstart``: the reference script's loop (cut to 2 rounds, from the
    same weights) ends on the same loss and scores (rtol 1e-4, the run-level
    rule: one round's scores agree to 1e-6, ``test_torch_loop.py``); the
    port's loss falls and its scores lie in [0, 1] (to 1e-6: the u=1 edge).
  * ``train_fl_video_caching``: the reference's ~100M config, field for
    field; on a reduced config the loss falls, the wireless rounds every 20
    steps equal the reference's solve on the same generator, and the saved
    checkpoint restores the trained weights.
"""
import dataclasses
import runpy
from pathlib import Path

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.core.flatten import tree_get, tree_paths
from repro_torch.launch import (quickstart, resource_optimization,
                                train_fl_video_caching)
from repro_torch.models.small import params_from_numpy
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def test_resource_optimization_prints_the_reference_table(reference,
                                                          capsys):
    runpy.run_path(str(EXAMPLES / "resource_optimization.py"),
                   run_name="__main__")
    want = capsys.readouterr().out
    resource_optimization.main()
    got = capsys.readouterr().out
    assert got == want
    assert "STRAGGLER" in got and "FCN 3.9M" in got


def test_quickstart_matches_the_reference_loop(reference, monkeypatch,
                                               capsys):
    import jax
    rounds = 2
    w0 = to_numpy_tree(reference.small.init_small(jax.random.PRNGKey(0),
                                                  "fcn"))
    src = (EXAMPLES / "quickstart.py").read_text()
    cut = "U, ROUNDS, CAPACITY = 4, 15, 80"
    assert cut in src
    ns = {"__name__": "quickstart_reference"}
    exec(compile(src.replace(cut, f"U, ROUNDS, CAPACITY = 4, {rounds}, 80"),
                 "examples/quickstart.py", "exec"), ns)
    capsys.readouterr()
    monkeypatch.setattr(quickstart, "init_small",
                        lambda seed, name, device: params_from_numpy(
                            name, w0, device))
    rows = quickstart.run(rounds=rounds, device="cpu")
    assert [r["round"] for r in rows] == list(range(rounds))
    np.testing.assert_allclose(rows[-1]["loss"], float(ns["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(rows[-1]["scores"], ns["server"].last_scores,
                               rtol=1e-4)
    assert rows[-1]["loss"] < rows[0]["loss"]
    for r in rows:
        assert np.all((r["scores"] >= 0) & (r["scores"] <= 1 + 1e-6))


def test_quickstart_main_prints_each_round(capsys):
    quickstart.main(["--rounds", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[:2] for line in out] == [["round", "0"],
                                                 ["round", "1"]]


def test_the_100m_config_is_the_reference_example_s(reference):
    ns = runpy.run_path(str(EXAMPLES / "train_fl_video_caching.py"),
                        run_name="train_fl_video_caching_reference")
    want = dataclasses.asdict(ns["build_100m_config"]())
    got = dataclasses.asdict(train_fl_video_caching.build_100m_config())
    for k in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "sliding_window", "head_dim", "arch_type",
              "attention", "dtype", "param_dtype", "name"):
        assert got[k] == want[k], k
    # the window keeps the example's attention on _sdpa's masked path
    assert got["sliding_window"] > 0


def test_100m_example_trains_budgets_and_saves_on_the_cpu(reference,
                                                          tmp_path):
    cfg = dataclasses.replace(
        train_fl_video_caching.build_100m_config().reduced(),
        sliding_window=16)
    ckpt = tmp_path / "fl.npz"
    res = train_fl_video_caching.run(steps=21, batch=4, seq=32, cfg=cfg,
                                     ckpt=ckpt, device="cpu", verbose=False)
    losses = [h["loss"] for h in res["history"]]
    assert len(losses) == 21 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert [w["step"] for w in res["wireless"]] == [0, 20]
    # the reference's solve on the same generator and payload
    R = reference.resource
    rng = np.random.default_rng(0)
    net = R.NetworkConfig()
    clients = R.make_clients(rng, 8, cell_radius_m=500.0)
    for w in res["wireless"]:
        dec = R.optimize_round(rng, net, clients, res["param_count"] // 32)
        assert w["kappas"] == [d.kappa for d in dec]
        assert w["stragglers"] == sum(1 for d in dec if not d.feasible)
    back = checkpoint.restore(ckpt, res["params"])
    for p in tree_paths(res["params"]):
        assert torch.equal(tree_get(back, p), tree_get(res["params"], p))
    assert res["lines"][-1].startswith("checkpoint -> ")
