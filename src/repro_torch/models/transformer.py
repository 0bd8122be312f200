"""Model assembly for the dense and MoE decoders of the transformer zoo
(``repro/models/transformer.py``, the dense/MoE decoder family):
deepseek-coder, nemotron-4, qwen1.5, h2o-danube-3 (full or sliding-window
GQA, optional qkv bias, swiglu/relu2/gelu MLP), arctic (MoE with a dense
residual MLP) and deepseek-v3 (MLA, dense first layers, MoE with a shared
expert, multi-token prediction). The hybrid, xLSTM, audio and vision
families raise ``NotImplementedError``.

Layers are stacked as in the reference: every leaf of ``dense_layers`` and
``moe_layers`` has a leading (n_layers,) axis, so reference weights carry
over leaf by leaf (``params_from_numpy``, float32 or bfloat16 trees);
``_scan_blocks`` is a Python loop over that axis and sums the MoE layers'
auxiliary losses. ``loss_fn`` is differentiable (the flash kernel has a
backward) and adds the MTP loss when the config has one; with
``cfg.remat`` each layer of a training forward is recomputed in the
backward (``torch.utils.checkpoint``), as the reference's ``_maybe_remat``.
Public API:

  init_model(gen, cfg)                           -> params
  forward(params, batch, cfg)                    -> (logits, aux_loss)
  loss_fn(params, batch, cfg)                    -> (loss, metrics)
  init_cache(cfg, batch, length, device, dtype)  -> cache
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
from repro_torch.models.attention import (gqa_fwd, init_gqa, init_gqa_cache,
                                          init_mla, init_mla_cache, mla_fwd)
from repro_torch.models.layers import (dense_init, embed, init_embedding,
                                       init_mlp, init_rmsnorm, mlp_fwd,
                                       rmsnorm, unembed)
from repro_torch.models.moe import init_moe, moe_fwd

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _check_ported(cfg: ModelConfig) -> None:
    """Refuse the families the port does not run yet."""
    unported = [name for name, on in (
        ("ssm", cfg.ssm is not None), ("hybrid", cfg.hybrid is not None),
        ("encoder", cfg.encoder is not None),
        ("vision", cfg.vision is not None)) if on]
    if unported or cfg.attention not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: repro_torch runs the dense and MoE decoders only; "
            f"{unported or [cfg.attention]} are not ported yet (ROADMAP.md "
            f"queue A lists what is left)")


# ---------------------------------------------------------------------------
# Transformer block (self-attention [GQA | MLA] + [MoE | MLP])
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ModelConfig, *, use_moe: bool = False,
               d_ff: int = 0, dtype=None, lead: tuple = ()):
    """One block's parameters, each leaf with the leading axes ``lead``
    (``(n_layers,)`` for the stacked trunk)."""
    dtype = dtype or _pdtype(cfg)
    init_attn = init_mla if cfg.attention == "mla" else init_gqa
    p = {"ln1": init_rmsnorm(gen, cfg.d_model, dtype, lead),
         "attn": init_attn(gen, cfg, dtype, lead),
         "ln2": init_rmsnorm(gen, cfg.d_model, dtype, lead)}
    if use_moe:
        p["moe"] = init_moe(gen, cfg, dtype, lead)
    else:
        p["mlp"] = init_mlp(gen, cfg, d_ff or cfg.d_ff, dtype, lead)
    return p


def block_fwd(p, x, cfg: ModelConfig, positions, *, use_moe: bool = False,
              cache=None, cache_pos=None, causal: bool = True,
              rope: bool = True):
    """-> (x, cache, aux): the block's output, its cache (written in place)
    and its MoE auxiliary loss (an f32 zero without MoE)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.attention == "mla":
        h, new_cache = mla_fwd(p["attn"], h, cfg, positions, cache=cache,
                               cache_pos=cache_pos)
    else:
        h, new_cache = gqa_fwd(p["attn"], h, cfg, positions, cache=cache,
                               cache_pos=cache_pos, causal=causal, rope=rope)
    x = x + h
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if use_moe:
        h, aux = moe_fwd(p["moe"], h, cfg)
    else:
        h = mlp_fwd(p["mlp"], h, cfg.mlp)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, new_cache, aux


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


def _scan_blocks(stack, x, cfg, positions, *, use_moe=False, caches=None,
                 cache_pos=None, causal=True, rope=True):
    """Run the stacked blocks in order; threads the caches if given (each
    layer's cache is a view into the stacked one, written in place) and
    sums the layers' auxiliary losses. A training forward (no caches)
    under ``cfg.remat`` checkpoints each layer, its aux loss included."""
    n = stack["ln1"]["scale"].shape[0]
    remat = caches is None and _remat(cfg)
    # one view per layer, no copies. Unbind's backward stacks the layers'
    # gradients once; a view per index would give each its own zeroed
    # whole-stack gradient to scatter into and add up (at qwen1.5-4b's
    # width with 8 layers, on an H100: 112 fills, and the adds, among the
    # 35 ms of a 184 ms fedavg step spent in fills and adds)
    layers = tree_map(lambda t: t.unbind(0), stack)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        layer = tree_map(lambda ts: ts[i], layers)
        if remat:
            x, a = checkpoint(_block_out, layer, x, cfg, positions, use_moe,
                              causal, rope, use_reentrant=False)
        else:
            cache = (None if caches is None
                     else tree_map(lambda t: t[i], caches))
            x, _, a = block_fwd(layer, x, cfg, positions, use_moe=use_moe,
                                cache=cache, cache_pos=cache_pos,
                                causal=causal, rope=rope)
        aux = aux + a
    return x, aux, caches


def _block_out(layer, x, cfg, positions, use_moe, causal, rope):
    x, _, aux = block_fwd(layer, x, cfg, positions, use_moe=use_moe,
                          causal=causal, rope=rope)
    return x, aux


def _stacked_cache(cfg, n, batch, length, device, dtype):
    init = init_mla_cache if cfg.attention == "mla" else init_gqa_cache
    return init(cfg, batch, length, dtype=dtype, device=device, lead=(n,))


def _n_dense(cfg: ModelConfig) -> int:
    """The dense layers ahead of the MoE ones (all layers without MoE)."""
    return cfg.moe.first_dense_layers if cfg.moe else cfg.n_layers


# ---------------------------------------------------------------------------
# Dense / MoE decoder (incl. deepseek-v3, arctic)
# ---------------------------------------------------------------------------

def _init_decoder(gen, cfg: ModelConfig):
    pd = _pdtype(cfg)
    moe_cfg = cfg.moe
    n_dense = _n_dense(cfg)
    params: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, pd),
        "final_norm": init_rmsnorm(gen, cfg.d_model, pd),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype=pd)
    d_ff_dense = (moe_cfg.d_ff_dense or cfg.d_ff) if moe_cfg else cfg.d_ff
    if n_dense:
        params["dense_layers"] = init_block(gen, cfg, d_ff=d_ff_dense,
                                            lead=(n_dense,))
    if cfg.n_layers - n_dense:
        params["moe_layers"] = init_block(gen, cfg, use_moe=True,
                                          lead=(cfg.n_layers - n_dense,))
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": dense_init(gen, (2 * cfg.d_model, cfg.d_model), dtype=pd),
            "ln_h": init_rmsnorm(gen, cfg.d_model, pd),
            "ln_e": init_rmsnorm(gen, cfg.d_model, pd),
            "block": init_block(gen, cfg, d_ff=d_ff_dense),
        }
    return params


def _decoder_trunk(params, x, cfg, positions, caches=None, cache_pos=None):
    n_dense = _n_dense(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = {}
    for name, n, use_moe in (("dense", n_dense, False),
                             ("moe", cfg.n_layers - n_dense, True)):
        if not n:
            continue
        x, a, nc = _scan_blocks(params[f"{name}_layers"], x, cfg, positions,
                                use_moe=use_moe,
                                caches=caches[name] if caches else None,
                                cache_pos=cache_pos)
        aux = aux + a
        new_caches[name] = nc
    return x, aux, new_caches


def _logits(params, x, cfg):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return x @ params["lm_head"].to(x.dtype)


def _mtp_loss(params, h, batch, cfg, positions, weight: float = 0.1):
    """DeepSeek-V3 multi-token prediction: predict token t+2 from
    (h_t, emb(token_{t+1})) through one extra block."""
    p = params["mtp"]
    tokens, labels = batch["tokens"], batch["labels"]
    nxt = torch.roll(tokens, -1, dims=1)
    e = embed(params["embed"], nxt, h.dtype)
    z = torch.cat([rmsnorm(p["ln_h"], h, cfg.norm_eps),
                   rmsnorm(p["ln_e"], e, cfg.norm_eps)], dim=-1)
    z = z @ p["proj"].to(h.dtype)
    z, _, _ = block_fwd(p["block"], z, cfg, positions)
    logits = _logits(params, z, cfg)
    tgt = torch.roll(labels, -1, dims=1)
    S = tokens.shape[1]
    mask = (torch.arange(S, device=h.device) < S - 2)[None, :]
    return weight * _ce(logits, tgt, mask)


# ===========================================================================
# Public API
# ===========================================================================

def init_model(gen, cfg: ModelConfig):
    """Parameters of ``cfg`` drawn from ``gen`` on its device (``gen=None``:
    meta tensors, the layout only)."""
    _check_ported(cfg)
    return _init_decoder(gen, cfg)


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """The reference's parameter tree (nested dicts of numpy arrays) as the
    port's parameters on ``device``. Every leaf must have the shape and the
    dtype (``cfg.param_dtype``) that ``init_model`` gives it. A bfloat16
    leaf (``ml_dtypes``' dtype, which numpy names ``bfloat16``) is carried
    by its bits, so this needs no ``ml_dtypes``."""
    template = init_model(None, cfg)
    want, got = tree_paths(template), tree_paths(tree)
    if want != got:
        raise ValueError(f"{cfg.name} parameters need leaves {want}, got "
                         f"{got}")
    for path in want:
        a, leaf = tree_get(template, path), np.asarray(tree_get(tree, path))
        if tuple(a.shape) != leaf.shape or leaf.dtype.name != cfg.param_dtype:
            raise ValueError(
                f"{cfg.name} leaf {'.'.join(path)} is {leaf.shape} "
                f"{leaf.dtype.name}, expected {tuple(a.shape)} "
                f"{cfg.param_dtype}")
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_tensor(np.asarray(a), dev), tree)


def _leaf_tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16))
        return bits.view(torch.bfloat16).to(device, copy=True)
    return torch.as_tensor(np.array(a), device=device)


def forward(params, batch, cfg: ModelConfig):
    """Training / prefill forward. batch: tokens (B, S) [+ labels (B, S),
    which add the MTP loss to the aux loss where the config has MTP]."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens, _cdtype(cfg))
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x, aux, _ = _decoder_trunk(params, x, cfg, positions)
    if cfg.mtp_depth and "labels" in batch:
        aux = aux + _mtp_loss(params, x, batch, cfg, positions)
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

def init_cache(cfg: ModelConfig, batch: int, length: int, device=None,
               dtype=torch.bfloat16):
    """Zeroed KV caches of the dense and MoE stacks (GQA or MLA latent
    caches, by the config's attention) in ``dtype``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    n_dense = _n_dense(cfg)
    out = {}
    for name, n in (("dense", n_dense), ("moe", cfg.n_layers - n_dense)):
        if n:
            out[name] = _stacked_cache(cfg, n, batch, length, dev, dtype)
    return out


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """tokens: (B, 1); pos: int — the current write index. Writes the step's
    keys and values into ``cache`` in place. Returns (logits (B,1,V), cache)."""
    _check_ported(cfg)
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
