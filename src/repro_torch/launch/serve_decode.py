"""Serve a model of the zoo with batched requests: prefill, then cached
decode (``examples/serve_decode.py``'s ``run``, whose default architecture
is zamba2-2.7b): the dense and MoE decoders over KV caches, zamba2 over
its Mamba2 states and its shared block's KV caches, xLSTM over its mLSTM
and sLSTM states, whisper over its decoder's KV caches and the encoder's
output, the vision decoder over its self-attention layers' KV caches and
the projected patches.

As in the reference, whisper's memory is ``whisper_encode`` of random
frame embeddings (0.02 N(0, 1), (batch, n_frames, d_model)) and its cache
holds at most ``max_decoder_len`` positions; the vision decoder's memory
is random patch embeddings (0.02 N(0, 1), (batch, n_patches, d_vision))
times ``vision_proj``, both in bf16 whatever the compute dtype. The prompt
is prefilled by sequential decode steps (cache-exact), then
``decode_steps`` tokens are decoded greedily. The config is passed in, so
a caller can cut depth with ``dataclasses.replace(cfg, n_layers=...)``:

    from repro_torch.configs import get_config
    from repro_torch.launch.serve_decode import run
    res = run(get_config("zamba2-2.7b").reduced(), device="cpu")
    res = run(get_config("whisper-medium").reduced(), device="cpu")
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pod import make_serve_step
from repro_torch.device import clock, resolve_device
from repro_torch.models.transformer import (init_cache, init_model,
                                            whisper_encode)


def _memory(params, cfg: ModelConfig, batch: int, gen: torch.Generator):
    """The memory the reference example builds (None without one)."""
    dev = gen.device
    if cfg.encoder is not None:
        frames = 0.02 * torch.randn((batch, cfg.encoder.n_frames,
                                     cfg.d_model), generator=gen, device=dev)
        return whisper_encode(params, frames, cfg)
    if cfg.vision is not None:
        patches = 0.02 * torch.randn((batch, cfg.vision.n_patches,
                                      cfg.vision.d_vision), generator=gen,
                                     device=dev)
        return patches.bfloat16() @ params["vision_proj"].bfloat16()
    return None


def run(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 32,
        decode_steps: int = 16, cache_len: int = 128, seed: int = 0,
        device=None) -> dict:
    """Weights, the memory's inputs and a random prompt from ``seed``;
    returns {"prompt" (B, prompt_len), "tokens" (B, decode_steps) int32,
    "memory" (the encoder's output or the projected patches; None for
    the other families), "memory_s", "prefill_s", "decode_s"}. Times end
    in a synchronize on the card."""
    if prompt_len < 1 or prompt_len + decode_steps > cache_len:
        raise ValueError(f"need 1 <= prompt_len and prompt_len + "
                         f"decode_steps <= cache_len; got {prompt_len}, "
                         f"{decode_steps}, {cache_len}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    params = init_model(gen, cfg)
    with torch.inference_mode():
        t0 = clock(dev)
        memory = _memory(params, cfg, batch, gen)
        memory_s = clock(dev) - t0
    cache = init_cache(cfg, batch, cache_len, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    serve = make_serve_step(cfg)
    with torch.inference_mode():
        t0 = clock(dev)
        for i in range(prompt_len):
            nxt, cache = serve(params, cache, prompt[:, i:i + 1], i, memory)
        prefill_s = clock(dev) - t0
        out = []
        tok = nxt
        t0 = clock(dev)
        for i in range(decode_steps):
            tok, cache = serve(params, cache, tok, prompt_len + i, memory)
            out.append(tok)
        decode_s = clock(dev) - t0
    tokens = (torch.cat(out, dim=1) if out else
              torch.empty((batch, 0), dtype=torch.int32, device=dev))
    return {"prompt": prompt, "tokens": tokens, "memory": memory,
            "memory_s": memory_s, "prefill_s": prefill_s,
            "decode_s": decode_s}
