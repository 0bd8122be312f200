"""Serve a decoder of the zoo with batched requests: prefill, then cached
decode (``examples/serve_decode.py``'s ``run``, whose default architecture
is zamba2-2.7b): the dense and MoE decoders over KV caches, zamba2 over
its Mamba2 states and its shared block's KV caches, xLSTM over its mLSTM
and sLSTM states; whisper's encoder path is not ported.

As in the reference, the prompt is prefilled by sequential decode steps
(cache-exact), then ``decode_steps`` tokens are decoded greedily. The
config is passed in, so a caller can cut depth with
``dataclasses.replace(cfg, n_layers=...)``:

    from repro_torch.configs import get_config
    from repro_torch.launch.serve_decode import run
    res = run(get_config("zamba2-2.7b").reduced(), device="cpu")
    res = run(get_config("deepseek-v3-671b").reduced(), device="cpu")
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pod import make_serve_step
from repro_torch.device import clock, resolve_device
from repro_torch.models.transformer import init_cache, init_model


def run(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 32,
        decode_steps: int = 16, cache_len: int = 128, seed: int = 0,
        device=None) -> dict:
    """Weights and a random prompt from ``seed``; returns {"prompt" (B,
    prompt_len), "tokens" (B, decode_steps) int32, "prefill_s",
    "decode_s"}. Times end in a synchronize on the card."""
    if prompt_len < 1 or prompt_len + decode_steps > cache_len:
        raise ValueError(f"need 1 <= prompt_len and prompt_len + "
                         f"decode_steps <= cache_len; got {prompt_len}, "
                         f"{decode_steps}, {cache_len}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    params = init_model(gen, cfg)
    cache = init_cache(cfg, batch, cache_len, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    serve = make_serve_step(cfg)
    with torch.inference_mode():
        t0 = clock(dev)
        for i in range(prompt_len):
            nxt, cache = serve(params, cache, prompt[:, i:i + 1], i)
        prefill_s = clock(dev) - t0
        out = []
        tok = nxt
        t0 = clock(dev)
        for i in range(decode_steps):
            tok, cache = serve(params, cache, tok, prompt_len + i)
            out.append(tok)
        decode_s = clock(dev) - t0
    tokens = (torch.cat(out, dim=1) if out else
              torch.empty((batch, 0), dtype=torch.int32, device=dev))
    return {"prompt": prompt, "tokens": tokens, "prefill_s": prefill_s,
            "decode_s": decode_s}
