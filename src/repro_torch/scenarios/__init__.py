"""Composable wireless-world scenario layer (``repro/scenarios/``).

``parse_scenario(spec, seed)`` turns a ``+``-composed spec (e.g.
``"churn(p_away=0.3)+flash_crowd(scale=3)"``) into a ``Scenario`` whose
pure, seeded per-round hooks the stacked harness applies; ``REGISTRY``
maps the named perturbations. ``scenarios/base.py`` has the hook and
purity contract, ``scenarios/library.py`` the perturbations.
"""
from repro_torch.scenarios.base import Perturbation, Scenario, parse_scenario
from repro_torch.scenarios.library import REGISTRY

__all__ = ["Perturbation", "Scenario", "parse_scenario", "REGISTRY"]
