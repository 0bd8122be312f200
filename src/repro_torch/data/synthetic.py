"""Synthetic batches for the transformer zoo's training path
(``repro/data/synthetic.py``): tokens and next-token labels, and the
stubbed frontends' inputs, whisper's frame embeddings (B, n_frames,
d_model) and the vision decoder's patch embeddings (B, n_patches,
d_vision).

Draws come from an explicit ``torch.Generator`` on the batch's device, so
they equal the reference's (threefry) only in distribution;
``learnable_sequence_batch`` is the reference's batch exactly when given
the same phases (its frames and patches are zeros).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig


def _memory_shapes(cfg: ModelConfig, batch: int) -> Dict:
    """{name: shape} of the frames (whisper) and patches (vision)."""
    out = {}
    if cfg.encoder is not None:
        out["frames"] = (batch, cfg.encoder.n_frames, cfg.d_model)
    if cfg.vision is not None:
        out["patches"] = (batch, cfg.vision.n_patches, cfg.vision.d_vision)
    return out


def train_batch_shapes(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    """One training batch as meta tensors: the shapes and dtypes only
    (frames and patches in bf16, as the reference's specs)."""
    specs = {name: torch.empty((batch, seq), dtype=torch.int32,
                               device="meta")
             for name in ("tokens", "labels")}
    for name, shape in _memory_shapes(cfg, batch).items():
        specs[name] = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    return specs


def make_train_batch(gen: torch.Generator, cfg: ModelConfig, batch: int,
                     seq: int) -> Dict:
    """Uniform random tokens (batch, seq + 1) on ``gen``'s device, with
    next-token labels; frames and patches 0.02 N(0, 1) in f32, drawn after
    the tokens."""
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                           device=gen.device, dtype=torch.int32)
    out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    for name, shape in _memory_shapes(cfg, batch).items():
        out[name] = 0.02 * torch.randn(shape, generator=gen,
                                       device=gen.device)
    return out


def learnable_sequence_batch(gen: torch.Generator, cfg: ModelConfig,
                             batch: int, seq: int, phase=None) -> Dict:
    """A learnable task (periodic token sequences) so smoke training can
    show that the loss falls: row b counts up from ``phase[b]`` modulo
    min(8, vocab - 1). ``phase`` (batch, 1) is drawn from ``gen`` unless
    given. Frames and patches are f32 zeros."""
    period = min(8, cfg.vocab_size - 1)
    if phase is None:
        phase = torch.randint(0, period, (batch, 1), generator=gen,
                              device=gen.device, dtype=torch.int32)
    phase = torch.as_tensor(phase, dtype=torch.int32)
    pos = torch.arange(seq + 1, device=phase.device, dtype=torch.int32)
    tokens = (phase + pos[None, :]) % period
    out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    for name, shape in _memory_shapes(cfg, batch).items():
        out[name] = torch.zeros(shape, device=phase.device)
    return out
