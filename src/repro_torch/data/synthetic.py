"""Synthetic token batches for the transformer zoo's training path
(``repro/data/synthetic.py``, the decoder families).

Draws come from an explicit ``torch.Generator`` on the batch's device, so
they equal the reference's (threefry) only in distribution;
``learnable_sequence_batch`` is the reference's batch exactly when given
the same phases. The encoder (whisper) and vision (llama-3.2-vision)
branches raise ``NotImplementedError``: those families are not ported.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig


def _decoder_only(cfg: ModelConfig) -> None:
    if cfg.encoder is not None or cfg.vision is not None:
        raise NotImplementedError(
            f"{cfg.name}: synthetic frames and patches belong to the encoder "
            f"and vision families, which repro_torch does not port yet "
            f"(ROADMAP.md queue A)")


def train_batch_shapes(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    """One training batch as meta tensors: the shapes and dtypes only."""
    _decoder_only(cfg)
    return {name: torch.empty((batch, seq), dtype=torch.int32, device="meta")
            for name in ("tokens", "labels")}


def make_train_batch(gen: torch.Generator, cfg: ModelConfig, batch: int,
                     seq: int) -> Dict:
    """Uniform random tokens (batch, seq + 1) on ``gen``'s device, with
    next-token labels."""
    _decoder_only(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                           device=gen.device, dtype=torch.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def learnable_sequence_batch(gen: torch.Generator, cfg: ModelConfig,
                             batch: int, seq: int, phase=None) -> Dict:
    """A learnable task (periodic token sequences) so smoke training can
    show that the loss falls: row b counts up from ``phase[b]`` modulo
    min(8, vocab - 1). ``phase`` (batch, 1) is drawn from ``gen`` unless
    given."""
    _decoder_only(cfg)
    period = min(8, cfg.vocab_size - 1)
    if phase is None:
        phase = torch.randint(0, period, (batch, 1), generator=gen,
                              device=gen.device, dtype=torch.int32)
    phase = torch.as_tensor(phase, dtype=torch.int32)
    pos = torch.arange(seq + 1, device=phase.device, dtype=torch.int32)
    tokens = (phase + pos[None, :]) % period
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
