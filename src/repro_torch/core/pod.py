"""Serving steps of the transformer zoo (``repro/core/pod.py``:
``make_serve_step``, ``make_prefill_step``). The pod training engines are
not ported yet (ROADMAP.md queue A)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import decode_step, forward


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One KV-cache decode step: (params, cache, tokens (B, 1), pos) ->
    (next tokens (B, 1) int32, cache), greedy."""
    def serve_step(params, cache, tokens, pos):
        logits, new_cache = decode_step(params, cache, tokens, pos, cfg)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], new_cache
    return serve_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """The prompt's forward: (params, {"tokens": (B, S)}) -> the greedy next
    token (B,) int32."""
    def prefill(params, batch):
        logits, _ = forward(params, batch, cfg)
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    return prefill
