"""Model assembly for the dense decoders of the transformer zoo
(``repro/models/transformer.py``, dense family): deepseek-coder, nemotron-4,
qwen1.5 and any ``ModelConfig`` of the same kind (full or sliding-window
GQA, optional qkv bias, swiglu/relu2/gelu MLP). MoE, MLA, MTP and the
hybrid, xLSTM, audio and vision families raise ``NotImplementedError``.

Layers are stacked as in the reference: every leaf of ``dense_layers`` has
a leading (n_layers,) axis, so reference weights carry over leaf by leaf
(``params_from_numpy``); ``_scan_blocks`` is a Python loop over that axis.
``loss_fn`` is differentiable (the flash kernel has a backward); with
``cfg.remat`` each layer of a training forward is recomputed in the
backward (``torch.utils.checkpoint``), as the reference's ``_maybe_remat``.
Public API:

  init_model(gen, cfg)                           -> params
  forward(params, batch, cfg)                    -> (logits, aux_loss)
  loss_fn(params, batch, cfg)                    -> (loss, metrics)
  init_cache(cfg, batch, length, device)         -> cache
  decode_step(params, cache, tokens, pos, cfg)   -> (logits, cache)
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.flatten import tree_get, tree_map, tree_paths
from repro_torch.device import resolve_device
from repro_torch.models.attention import gqa_fwd, init_gqa, init_gqa_cache
from repro_torch.models.layers import (dense_init, embed, init_embedding,
                                       init_mlp, init_rmsnorm, mlp_fwd,
                                       rmsnorm, unembed)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _check_dense(cfg: ModelConfig) -> None:
    unported = [name for name, on in (
        ("moe", cfg.moe is not None), ("mla", cfg.attention == "mla"),
        ("mtp", cfg.mtp_depth > 0), ("ssm", cfg.ssm is not None),
        ("hybrid", cfg.hybrid is not None),
        ("encoder", cfg.encoder is not None),
        ("vision", cfg.vision is not None)) if on]
    if unported or cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: repro_torch runs the dense GQA decoders only; "
            f"{unported or [cfg.attention]} are not ported yet (ROADMAP.md "
            f"queue A lists what is left)")


# ---------------------------------------------------------------------------
# Transformer block (self-attention + MLP)
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ModelConfig, *, d_ff: int = 0, dtype=None,
               lead: tuple = ()):
    """One block's parameters, each leaf with the leading axes ``lead``
    (``(n_layers,)`` for the stacked trunk)."""
    dtype = dtype or _pdtype(cfg)
    return {"ln1": init_rmsnorm(gen, cfg.d_model, dtype, lead),
            "attn": init_gqa(gen, cfg, dtype, lead),
            "ln2": init_rmsnorm(gen, cfg.d_model, dtype, lead),
            "mlp": init_mlp(gen, cfg, d_ff or cfg.d_ff, dtype, lead)}


def block_fwd(p, x, cfg: ModelConfig, positions, *, cache=None,
              cache_pos=None, causal: bool = True, rope: bool = True):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    h, new_cache = gqa_fwd(p["attn"], h, cfg, positions, cache=cache,
                           cache_pos=cache_pos, causal=causal, rope=rope)
    x = x + h
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp_fwd(p["mlp"], h, cfg.mlp), new_cache


def _remat(cfg: ModelConfig) -> bool:
    """Whether training recomputes each layer in the backward
    (``cfg.remat``). The reference's ``REPRO_REMAT_POLICY=dots`` (keep the
    matmul outputs) has no torch counterpart and is refused rather than
    silently recomputing everything."""
    if not cfg.remat:
        return False
    if os.environ.get("REPRO_REMAT_POLICY", "") == "dots":
        raise NotImplementedError(
            "REPRO_REMAT_POLICY=dots (save the matmul outputs) has no "
            "counterpart in torch.utils.checkpoint; unset it to recompute "
            "whole layers")
    return True


def _scan_blocks(stack, x, cfg, positions, *, caches=None, cache_pos=None,
                 causal=True, rope=True):
    """Run the stacked blocks in order; threads the caches if given (each
    layer's cache is a view into the stacked one, written in place). A
    training forward (no caches) under ``cfg.remat`` checkpoints each
    layer."""
    n = stack["ln1"]["scale"].shape[0]
    remat = caches is None and _remat(cfg)
    # one view per layer, no copies. Unbind's backward stacks the layers'
    # gradients once; a view per index would give each its own zeroed
    # whole-stack gradient to scatter into and add up (at qwen1.5-4b's
    # width with 8 layers, on an H100: 112 fills, and the adds, among the
    # 35 ms of a 184 ms fedavg step spent in fills and adds)
    layers = tree_map(lambda t: t.unbind(0), stack)
    for i in range(n):
        layer = tree_map(lambda ts: ts[i], layers)
        if remat:
            x = checkpoint(_block_out, layer, x, cfg, positions, causal,
                           rope, use_reentrant=False)
            continue
        cache = None if caches is None else tree_map(lambda t: t[i], caches)
        x, _ = block_fwd(layer, x, cfg, positions, cache=cache,
                         cache_pos=cache_pos, causal=causal, rope=rope)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), caches


def _block_out(layer, x, cfg, positions, causal, rope):
    return block_fwd(layer, x, cfg, positions, causal=causal, rope=rope)[0]


def _block_cache(cfg: ModelConfig, batch: int, length: int, device,
                 lead: tuple = ()):
    return init_gqa_cache(cfg, batch, length, device=device, lead=lead)


def _stacked_cache(cfg, n, batch, length, device):
    return _block_cache(cfg, batch, length, device, lead=(n,))


# ---------------------------------------------------------------------------
# Dense decoder
# ---------------------------------------------------------------------------

def _init_decoder(gen, cfg: ModelConfig):
    pd = _pdtype(cfg)
    params: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, pd),
        "final_norm": init_rmsnorm(gen, cfg.d_model, pd),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype=pd)
    params["dense_layers"] = init_block(gen, cfg, lead=(cfg.n_layers,))
    return params


def _decoder_trunk(params, x, cfg, positions, caches=None, cache_pos=None):
    x, aux, nc = _scan_blocks(params["dense_layers"], x, cfg, positions,
                              caches=caches["dense"] if caches else None,
                              cache_pos=cache_pos)
    return x, aux, {"dense": nc}


def _logits(params, x, cfg):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return x @ params["lm_head"].to(x.dtype)


# ===========================================================================
# Public API
# ===========================================================================

def init_model(gen, cfg: ModelConfig):
    """Parameters of ``cfg`` drawn from ``gen`` on its device (``gen=None``:
    meta tensors, the layout only)."""
    _check_dense(cfg)
    return _init_decoder(gen, cfg)


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """The reference's parameter tree (nested dicts of numpy arrays) as the
    port's parameters on ``device``. Every leaf must have the shape and the
    dtype (``cfg.param_dtype``) that ``init_model`` gives it."""
    template = init_model(None, cfg)
    want, got = tree_paths(template), tree_paths(tree)
    if want != got:
        raise ValueError(f"{cfg.name} parameters need leaves {want}, got "
                         f"{got}")
    np_dtype = np.dtype(cfg.param_dtype)
    for path in want:
        a, leaf = tree_get(template, path), tree_get(tree, path)
        if tuple(a.shape) != np.shape(leaf) or np.asarray(leaf).dtype != np_dtype:
            raise ValueError(
                f"{cfg.name} leaf {'.'.join(path)} is {np.shape(leaf)} "
                f"{np.asarray(leaf).dtype}, expected {tuple(a.shape)} "
                f"{np_dtype}")
    dev = resolve_device(device)
    return tree_map(lambda a: torch.as_tensor(np.array(a), device=dev), tree)


def forward(params, batch, cfg: ModelConfig):
    """Training / prefill forward. batch: tokens (B, S)."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens, _cdtype(cfg))
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x, aux, _ = _decoder_trunk(params, x, cfg, positions)
    return _logits(params, x, cfg), aux


def _ce(logits, labels, mask=None):
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def loss_fn(params, batch, cfg: ModelConfig):
    logits, aux = forward(params, batch, cfg)
    loss = _ce(logits, batch["labels"]) + aux
    acc = torch.mean((torch.argmax(logits, -1) == batch["labels"]).float())
    return loss, {"loss": loss, "aux": aux, "accuracy": acc}


# --- decode -----------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, length: int, device=None):
    _check_dense(cfg)
    return {"dense": _stacked_cache(cfg, cfg.n_layers, batch, length,
                                    resolve_device(device))}


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """tokens: (B, 1); pos: int — the current write index. Writes the step's
    keys and values into ``cache`` in place. Returns (logits (B,1,V), cache)."""
    _check_dense(cfg)
    B = tokens.shape[0]
    x = embed(params["embed"], tokens, _cdtype(cfg))
    positions = torch.full((B, 1), int(pos), device=tokens.device)
    x, _, nc = _decoder_trunk(params, x, cfg, positions, caches=cache,
                              cache_pos=pos)
    return _logits(params, x, cfg), nc


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
