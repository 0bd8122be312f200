"""How far one-ulp changes of the initial weights move a run's test loss,
which decides the learning rate at which two float32 implementations of
the same run (the port and the JAX package, or the card and the CPU) can
be held to the 1e-4 rule on ``test_loss``.

Each case runs ``repro_torch.harness.run("osafl", ...)`` on the CPU once
from the model's seeded weights, then ``TRIALS`` times from the same
weights with a random half of their entries moved up by one ulp, and
prints the largest relative change of each round's ``test_loss`` as one
JSON line (``pytest -s`` shows it). The CNN and SqueezeNet keep such
changes under the rule at ``global_lr=1`` and amplify them past it at
OSAFL's default of 16, so their run-level checks run at 1.
"""
import json

import pytest
import torch

import repro_torch.harness.experiments as tex
from repro_torch.core.flatten import tree_map
from repro_torch.harness import ExperimentConfig, run

RULE = 1e-4
TRIALS = 4
SMALL = dict(dataset=1, num_clients=4, rounds=3, capacity=(16, 32),
             local_lr=0.1)


@pytest.mark.parametrize("global_lr", [1.0, 16.0])
@pytest.mark.parametrize("model", ["cnn", "squeezenet"])
def test_one_ulp_moves_conv_runs_past_the_rule_only_at_paper_rate(
        monkeypatch, model, global_lr):
    xc = ExperimentConfig(model=model, global_lr=global_lr, **SMALL)
    base = run("osafl", xc, eval_samples=64, device="cpu")
    seeded = tex.init_small
    worst = [0.0] * xc.rounds
    for k in range(TRIALS):
        gen = torch.Generator().manual_seed(k)

        def moved(seed, name, device):
            up = torch.tensor(float("inf"))
            return tree_map(lambda w: torch.where(
                torch.rand(w.shape, generator=gen) < 0.5,
                torch.nextafter(w, up), w), seeded(seed, name, device))
        monkeypatch.setattr(tex, "init_small", moved)
        got = run("osafl", xc, eval_samples=64, device="cpu")
        worst = [max(w, abs(g["test_loss"] / b["test_loss"] - 1))
                 for w, g, b in zip(worst, got, base)]
    print(json.dumps({"model": model, "global_lr": global_lr,
                      "test_loss": [b["test_loss"] for b in base],
                      "max_rel_change_per_round": worst}))
    if global_lr == 1.0:
        assert max(worst) < RULE
    else:
        assert max(worst) > RULE
