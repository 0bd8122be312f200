"""Model assembly for the transformer zoo (``repro/models/transformer.py``):
the dense and MoE decoders, deepseek-coder, nemotron-4, qwen1.5,
h2o-danube-3 (full or sliding-window GQA, optional qkv bias,
swiglu/relu2/gelu MLP), arctic (MoE with a dense residual MLP) and
deepseek-v3 (MLA, dense first layers, MoE with a shared expert, multi-token
prediction); the hybrid zamba2 (Mamba2 layers in groups, one shared
attention block applied after each group with the same weights and its own
KV cache per group); xLSTM (groups of mLSTM blocks, each followed by an
sLSTM block); whisper (an encoder of non-causal blocks over precomputed
frame embeddings with sinusoidal positions, then decoder blocks of causal
self-attention, cross-attention over the encoder's output and an MLP); and
the vision decoder llama-3.2-vision (groups of self-attention layers, each
followed by a cross layer over the projected patch embeddings whose
attention and MLP outputs pass through tanh gates).

Layers are stacked as in the reference: every leaf of ``dense_layers`` and
``moe_layers`` has a leading (n_layers,) axis, zamba2's ``mamba_layers``
(n_groups, every) axes, xLSTM's ``mlstm_layers`` (n_groups, n_m) and
``slstm_layers`` (n_groups,), whisper's ``enc_layers`` and ``dec_layers``
(n_layers,), the vision decoder's ``self_layers`` (n_groups,
cross_attn_every - 1) and ``cross_layers`` (n_groups,), so reference
weights carry over leaf by leaf
(``params_from_numpy``, float32 or bfloat16 trees); ``_scan_blocks`` is a
Python loop over that axis and sums the MoE layers' auxiliary losses, and
the other trunks are loops over their layers and groups. ``loss_fn`` is
differentiable (the flash kernel has a backward) and adds the MTP loss
when the config has one; with ``cfg.remat`` each layer of a training
forward is recomputed in the backward (``torch.utils.checkpoint``), as the
reference's ``_maybe_remat``.

Tensor parallelism (every family): given a ``mesh`` whose 'model' axis
has M > 1 columns, one rank a column, ``forward``, ``loss_fn``,
``init_cache``, ``decode_step`` and ``memory_of`` run on this rank's
shards of the parameters (``launch/sharding.py``'s tp rules): the
embedding split over d_model and its columns gathered, the MLP, GQA,
cross-attention and MLA Megatron-style (column-split in, row-split out,
one model-axis sum each), the MoE layers expert-parallel
(``moe.moe_fwd``), the Mamba2 and mLSTM blocks on each column's heads and
sLSTM on every head (``models/ssm.py``), the vision decoder's
``vision_proj`` by column with the projected patches gathered, the
logits split over the vocabulary with a vocab-parallel cross-entropy
(MTP's masked one too). The norms, the router, the tanh gates and MTP's
``proj`` stay whole on every column, and ``core/shmap``'s autograd
crossings make their gradients the same on all columns: each gradient is
summed over the columns once, where the columns start to differ. A
stacked leaf the rules split along its layer axis (the shared expert and
the dense residual where the MoE layers divide by M) is gathered whole at
use.

Public API:

  init_model(gen, cfg)                           -> params
  forward(params, batch, cfg, mesh=None)         -> (logits, aux_loss)
  loss_fn(params, batch, cfg, mesh=None)         -> (loss, metrics)
  init_cache(cfg, batch, length, device, dtype, mesh=None) -> cache
  decode_step(params, cache, tokens, pos, cfg, memory=None, mesh=None)
                                                 -> (logits, cache)
  argmax_logits(logits, cfg, mesh=None)          -> greedy tokens
  whisper_encode(params, frames, cfg, mesh=None) -> memory
  memory_of(params, batch, cfg, mesh=None)       -> memory or None
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.flatten import tree_get, tree_map, tree_paths
from repro_torch.core.shmap import model_axis, model_columns
from repro_torch.device import resolve_device
from repro_torch.models.attention import (cross_attn_fwd, gqa_fwd,
                                          init_cross_attn, init_gqa,
                                          init_gqa_cache, init_mla,
                                          init_mla_cache, mla_fwd)
from repro_torch.models.layers import (dense_init, embed, init_embedding,
                                       init_mlp, init_rmsnorm, mlp_fwd,
                                       rmsnorm, unembed)
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.moe import init_moe, moe_fwd

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _family(cfg: ModelConfig) -> str:
    """The reference's dispatch order: the encoder (whisper), the hybrid
    (zamba2), xLSTM, the vision decoder, else the dense/MoE decoder."""
    if cfg.encoder is not None:
        return "encoder"
    if cfg.hybrid is not None:
        return "hybrid"
    if cfg.ssm is not None and cfg.ssm.kind == "xlstm":
        return "xlstm"
    if cfg.vision is not None:
        return "vision"
    return "decoder"


def _check_ported(cfg: ModelConfig, mesh=None):
    """Refuse attention kinds other than GQA and MLA outside xLSTM (which
    has none): the reference builds no other. Returns the mesh's
    ``ModelAxis`` (None with one model column)."""
    if _family(cfg) != "xlstm" and cfg.attention not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: attention {cfg.attention!r} outside xLSTM is not "
            f"a kind the reference builds; repro_torch runs GQA and MLA "
            f"(ROADMAP.md queue A)")
    return model_axis(mesh)


def _split_over(tp, width: int):
    """``tp`` where the rules split a dimension of ``width`` over its
    columns, else None (the leaf stays whole)."""
    return tp if tp is not None and width % tp.size == 0 else None


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
              rope: bool = True, d_ff: int = 0, tp=None):
    """-> (x, cache, aux): the block's output, its cache (written in place)
    and its MoE auxiliary loss (an f32 zero without MoE). ``d_ff``: the
    dense MLP's width, as ``init_block`` took it (the decoders' dense
    width by default). ``tp``: the model axis its attention, MLP and
    experts are split over (the norms stay whole)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.attention == "mla":
        h, new_cache = mla_fwd(p["attn"], h, cfg, positions, cache=cache,
                               cache_pos=cache_pos, tp=tp)
    else:
        h, new_cache = gqa_fwd(p["attn"], h, cfg, positions, cache=cache,
                               cache_pos=cache_pos, causal=causal, rope=rope,
                               tp=tp)
    x = x + h
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if use_moe:
        h, aux = moe_fwd(p["moe"], h, cfg, tp=tp)
    else:
        h = mlp_fwd(p["mlp"], h, cfg.mlp,
                    tp=_split_over(tp, d_ff or _dense_ff(cfg)))
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
                 cache_pos=None, causal=True, rope=True, tp=None):
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
    if tp is not None:
        stack = _gather_layers(stack, n, tp)
    layers = tree_map(lambda t: t.unbind(0), stack)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        layer = tree_map(lambda ts: ts[i], layers)
        if remat:
            x, a = checkpoint(_block_out, layer, x, cfg, positions, use_moe,
                              causal, rope, tp, use_reentrant=False)
        else:
            cache = (None if caches is None
                     else tree_map(lambda t: t[i], caches))
            x, _, a = block_fwd(layer, x, cfg, positions, use_moe=use_moe,
                                cache=cache, cache_pos=cache_pos,
                                causal=causal, rope=rope, tp=tp)
        aux = aux + a
    return x, aux, caches


def _gather_layers(stack, n: int, tp):
    """The stack with each leaf the rules split along its layer axis (a
    leading dimension of n / M, not n: the shared expert and the dense
    residual, whose stacked 3-d leaves take the expert rule) gathered
    whole. Every column computes the same with it, so each gets its own
    layers' whole gradient back."""
    return tree_map(lambda t: t if t.shape[0] == n else tp.gather(t, dim=0),
                    stack)


def _block_out(layer, x, cfg, positions, use_moe, causal, rope, tp=None,
               d_ff: int = 0):
    x, _, aux = block_fwd(layer, x, cfg, positions, use_moe=use_moe,
                          causal=causal, rope=rope, d_ff=d_ff, tp=tp)
    return x, aux


def _stacked_cache(cfg, n, batch, length, device, dtype,
                   model_parallel: int = 1):
    """The KV caches of ``n`` stacked layers (a tuple: several leading
    axes)."""
    lead = n if isinstance(n, tuple) else (n,)
    if cfg.attention == "mla":
        return init_mla_cache(cfg, batch, length, dtype=dtype, device=device,
                              lead=lead)
    return init_gqa_cache(cfg, batch, length, dtype=dtype, device=device,
                          lead=lead, model_parallel=model_parallel)


def _dense_ff(cfg: ModelConfig) -> int:
    """The d_ff of a decoder's dense blocks (its dense layers and MTP's
    block): the MoE config's ``d_ff_dense`` where it sets one (deepseek-v3's
    18,432 beside its experts' 2,048), else ``cfg.d_ff``."""
    moe_cfg = cfg.moe
    return (moe_cfg.d_ff_dense or cfg.d_ff) if moe_cfg else cfg.d_ff


def _n_dense(cfg: ModelConfig) -> int:
    """The dense layers ahead of the MoE ones (all layers without MoE)."""
    return cfg.moe.first_dense_layers if cfg.moe else cfg.n_layers


# ---------------------------------------------------------------------------
# Dense / MoE decoder (incl. deepseek-v3, arctic)
# ---------------------------------------------------------------------------

def _init_decoder(gen, cfg: ModelConfig):
    pd = _pdtype(cfg)
    n_dense = _n_dense(cfg)
    params: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, pd),
        "final_norm": init_rmsnorm(gen, cfg.d_model, pd),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype=pd)
    d_ff_dense = _dense_ff(cfg)
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


def _decoder_trunk(params, x, cfg, positions, caches=None, cache_pos=None,
                   tp=None):
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
                                cache_pos=cache_pos, tp=tp)
        aux = aux + a
        new_caches[name] = nc
    return x, aux, new_caches


def _logits(params, x, cfg, tp=None):
    """The final norm and the head. Under ``tp`` a vocab-split ``lm_head``
    gives this column's (..., V / M) logits (``vocab_split``); a tied,
    d-split table gives every column the whole vocabulary's, model-summed
    (no zoo config ties its embeddings)."""
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, _split_over(tp, cfg.d_model))
    if vocab_split(cfg, tp):
        x = tp.copy_in(x)
    return x @ params["lm_head"].to(x.dtype)


def vocab_split(cfg: ModelConfig, tp) -> bool:
    """Whether the logits under ``tp`` are each column's part of the
    vocabulary (an untied ``lm_head`` whose vocabulary the rules split)."""
    return (not cfg.tie_embeddings
            and _split_over(tp, cfg.vocab_size) is not None)


def _mtp_loss(params, h, batch, cfg, positions, weight: float = 0.1,
              tp=None):
    """DeepSeek-V3 multi-token prediction: predict token t+2 from
    (h_t, emb(token_{t+1})) through one extra block. Under ``tp``: the
    d-split embedding gathered, ``proj`` whole, the block split as a
    dense block, and the vocab-parallel cross-entropy under the mask."""
    p = params["mtp"]
    tokens, labels = batch["tokens"], batch["labels"]
    nxt = torch.roll(tokens, -1, dims=1)
    e = embed(params["embed"], nxt, h.dtype, _split_over(tp, cfg.d_model))
    z = torch.cat([rmsnorm(p["ln_h"], h, cfg.norm_eps),
                   rmsnorm(p["ln_e"], e, cfg.norm_eps)], dim=-1)
    z = z @ p["proj"].to(h.dtype)
    z, _, _ = block_fwd(p["block"], z, cfg, positions, tp=tp)
    logits = _logits(params, z, cfg, tp)
    tgt = torch.roll(labels, -1, dims=1)
    S = tokens.shape[1]
    mask = (torch.arange(S, device=h.device) < S - 2)[None, :]
    if vocab_split(cfg, tp):
        return weight * _ce_vocab_parallel(logits, tgt, tp, mask)
    return weight * _ce(logits, tgt, mask)


# ===========================================================================
# Hybrid (zamba2): Mamba2 backbone + shared attention block
# ===========================================================================

def _layers(stack, n_lead: int) -> list:
    """One parameter tree per layer of a stack with ``n_lead`` leading
    axes, in order: views from one unbind per leaf (a backward stacks each
    leaf's gradient once, as in ``_scan_blocks``)."""
    flat = tree_map(lambda t: t.flatten(0, n_lead - 1).unbind(0), stack)
    n = len(tree_get(flat, tree_paths(flat)[0]))
    return [tree_map(lambda ts: ts[i], flat) for i in range(n)]


def _apply(fn, remat: bool, *args):
    """``fn(*args)``, recomputed in the backward under ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _init_zamba(gen, cfg: ModelConfig):
    pd = _pdtype(cfg)
    every = cfg.hybrid.shared_attn_every
    lead = (cfg.n_layers // every, every)
    params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, pd),
        "final_norm": init_rmsnorm(gen, cfg.d_model, pd),
        "mamba_layers": {"ln": init_rmsnorm(gen, cfg.d_model, pd, lead),
                         "m": ssm_lib.init_mamba(gen, cfg, pd, lead)},
        "shared_block": init_block(gen, cfg,
                                   d_ff=cfg.hybrid.shared_block_d_ff),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype=pd)
    return params


def _mamba_layer(lp, x, cfg, tp=None):
    hn = rmsnorm(lp["ln"], x, cfg.norm_eps)
    return x + ssm_lib.mamba_fwd(lp["m"], hn, cfg, tp)


def _zamba_trunk(params, x, cfg, positions, caches=None, cache_pos=None,
                 tp=None):
    """Each group's Mamba2 layers, then the shared block (the same weights
    after every group, its MLP ``shared_block_d_ff`` wide; with caches,
    group g's own KV cache)."""
    every = cfg.hybrid.shared_attn_every
    d_ff = cfg.hybrid.shared_block_d_ff
    remat = caches is None and _remat(cfg)
    for j, lp in enumerate(_layers(params["mamba_layers"], 2)):
        g, i = divmod(j, every)
        if caches is None:
            x = _apply(_mamba_layer, remat, lp, x, cfg, tp)
        else:
            hn = rmsnorm(lp["ln"], x, cfg.norm_eps)
            y, _ = ssm_lib.mamba_decode_step(
                lp["m"], hn, tree_map(lambda t: t[g, i], caches["mamba"]),
                cfg, tp)
            x = x + y
        if i < every - 1:
            continue
        if remat:
            x, _ = checkpoint(_block_out, params["shared_block"], x, cfg,
                              positions, False, True, True, tp, d_ff,
                              use_reentrant=False)
        else:
            cache = (None if caches is None
                     else tree_map(lambda t: t[g], caches["attn"]))
            x, _, _ = block_fwd(params["shared_block"], x, cfg, positions,
                                cache=cache, cache_pos=cache_pos, d_ff=d_ff,
                                tp=tp)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), caches


# ===========================================================================
# xLSTM: groups of mLSTM blocks, each followed by an sLSTM block
# ===========================================================================

def _xlstm_groups(cfg: ModelConfig) -> tuple:
    """(n_groups, n_m), the reference's arithmetic: with ``slstm_every``
    set, max(1, n_layers // slstm_every) groups of slstm_every - 1 mLSTM
    blocks and one sLSTM block each (the reduced config's 2 layers give 7 +
    1 blocks); else one group of n_layers mLSTM blocks."""
    every = cfg.ssm.slstm_every
    if not every:
        return 1, cfg.n_layers
    return max(1, cfg.n_layers // every), every - 1


def _init_xlstm(gen, cfg: ModelConfig):
    pd = _pdtype(cfg)
    n_groups, n_m = _xlstm_groups(cfg)
    params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, pd),
        "final_norm": init_rmsnorm(gen, cfg.d_model, pd),
        "mlstm_layers": {
            "ln": init_rmsnorm(gen, cfg.d_model, pd, (n_groups, n_m)),
            "m": ssm_lib.init_mlstm(gen, cfg, pd, (n_groups, n_m))},
    }
    if cfg.ssm.slstm_every:
        params["slstm_layers"] = {
            "ln": init_rmsnorm(gen, cfg.d_model, pd, (n_groups,)),
            "s": ssm_lib.init_slstm(gen, cfg, pd, (n_groups,))}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype=pd)
    return params


def _mlstm_layer(lp, x, cfg, tp=None):
    return x + ssm_lib.mlstm_fwd(lp["m"], rmsnorm(lp["ln"], x, cfg.norm_eps),
                                 cfg, tp)


def _slstm_layer(lp, x, cfg, tp=None):
    hn = rmsnorm(lp["ln"], x, cfg.norm_eps)
    return x + ssm_lib.slstm_fwd(lp["s"], hn, cfg, tp=tp)[0]


def _xlstm_trunk(params, x, cfg, positions, caches=None, cache_pos=None,
                 tp=None):
    n_groups, n_m = params["mlstm_layers"]["ln"]["scale"].shape[:2]
    remat = caches is None and _remat(cfg)
    m_layers = _layers(params["mlstm_layers"], 2)
    s_layers = (_layers(params["slstm_layers"], 1)
                if "slstm_layers" in params else None)
    for g in range(n_groups):
        for i in range(n_m):
            lp = m_layers[g * n_m + i]
            if caches is None:
                x = _apply(_mlstm_layer, remat, lp, x, cfg, tp)
            else:
                hn = rmsnorm(lp["ln"], x, cfg.norm_eps)
                y, _ = ssm_lib.mlstm_decode_step(
                    lp["m"], hn,
                    tree_map(lambda t: t[g, i], caches["mlstm"]), cfg, tp)
                x = x + y
        if s_layers is None:
            continue
        lp = s_layers[g]
        if caches is None:
            x = _apply(_slstm_layer, remat, lp, x, cfg, tp)
        else:
            hn = rmsnorm(lp["ln"], x, cfg.norm_eps)
            y, _ = ssm_lib.slstm_decode_step(
                lp["s"], hn, tree_map(lambda t: t[g], caches["slstm"]), cfg,
                tp)
            x = x + y
    return x, torch.zeros((), dtype=torch.float32, device=x.device), caches


# ===========================================================================
# VLM (llama-3.2-vision): interleaved gated cross-attention layers
# ===========================================================================

def _vlm_groups(cfg: ModelConfig) -> tuple:
    """(n_groups, n_self): n_layers // cross_attn_every groups of
    cross_attn_every - 1 self-attention layers and one cross layer each."""
    every = cfg.vision.cross_attn_every
    return cfg.n_layers // every, every - 1


def _init_vlm(gen, cfg: ModelConfig):
    pd = _pdtype(cfg)
    n_groups, n_self = _vlm_groups(cfg)
    params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, pd),
        "final_norm": init_rmsnorm(gen, cfg.d_model, pd),
        "vision_proj": dense_init(gen, (cfg.vision.d_vision, cfg.d_model),
                                  dtype=pd),
        "self_layers": init_block(gen, cfg, lead=(n_groups, n_self)),
        "cross_layers": _init_cross_block(gen, cfg, pd, lead=(n_groups,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype=pd)
    return params


def _init_cross_block(gen, cfg, pd, lead: tuple = ()):
    """A gated cross-attention layer; both tanh gates start at zero, as in
    the reference, so at init the layer passes its input through."""
    device = "meta" if gen is None else gen.device
    return {
        "ln1": init_rmsnorm(gen, cfg.d_model, pd, lead),
        "xattn": init_cross_attn(gen, cfg, cfg.d_model, pd, lead),
        "gate_attn": torch.zeros(lead, dtype=pd, device=device),
        "ln2": init_rmsnorm(gen, cfg.d_model, pd, lead),
        "mlp": init_mlp(gen, cfg, cfg.d_ff, pd, lead),
        "gate_mlp": torch.zeros(lead, dtype=pd, device=device),
    }


def _cross_block_fwd(p, x, memory, cfg, tp=None):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    h = cross_attn_fwd(p["xattn"], h, memory, cfg, tp)
    x = x + torch.tanh(p["gate_attn"].to(h.dtype)) * h
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    h = mlp_fwd(p["mlp"], h, cfg.mlp, tp=_split_over(tp, cfg.d_ff))
    return x + torch.tanh(p["gate_mlp"].to(h.dtype)) * h


def _vlm_trunk(params, x, cfg, positions, memory, caches=None,
               cache_pos=None, tp=None):
    """Each group's self-attention layers (the stack's (n_groups, n_self)
    axes in order; with caches, each layer's own KV cache), then the
    group's cross layer over ``memory``."""
    n_groups, n_self = params["self_layers"]["ln1"]["scale"].shape[:2]
    remat = caches is None and _remat(cfg)
    self_layers = _layers(params["self_layers"], 2)
    cross_layers = _layers(params["cross_layers"], 1)
    for g in range(n_groups):
        for i in range(n_self):
            lp = self_layers[g * n_self + i]
            if caches is None:
                x, _ = _apply(_block_out, remat, lp, x, cfg, positions,
                              False, True, True, tp)
            else:
                x, _, _ = block_fwd(
                    lp, x, cfg, positions,
                    cache=tree_map(lambda t: t[g, i], caches["self"]),
                    cache_pos=cache_pos, tp=tp)
        x = _apply(_cross_block_fwd, remat, cross_layers[g], x, memory, cfg,
                   tp)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), caches


# ===========================================================================
# Encoder-decoder audio (whisper)
# ===========================================================================

def _init_whisper(gen, cfg: ModelConfig):
    pd = _pdtype(cfg)
    params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, pd),
        "final_norm": init_rmsnorm(gen, cfg.d_model, pd),
        "enc_layers": init_block(gen, cfg, lead=(cfg.encoder.n_layers,)),
        "enc_norm": init_rmsnorm(gen, cfg.d_model, pd),
        "dec_layers": _init_decdec_block(gen, cfg, pd,
                                         lead=(cfg.n_layers,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype=pd)
    return params


def _init_decdec_block(gen, cfg, pd, lead: tuple = ()):
    """A decoder block: causal self-attention, cross-attention over the
    encoder's output, MLP."""
    return {
        "ln1": init_rmsnorm(gen, cfg.d_model, pd, lead),
        "attn": init_gqa(gen, cfg, pd, lead),
        "ln_x": init_rmsnorm(gen, cfg.d_model, pd, lead),
        "xattn": init_cross_attn(gen, cfg, cfg.d_model, pd, lead),
        "ln2": init_rmsnorm(gen, cfg.d_model, pd, lead),
        "mlp": init_mlp(gen, cfg, cfg.d_ff, pd, lead),
    }


def _decdec_block_fwd(p, x, memory, cfg, positions, cache=None,
                      cache_pos=None, tp=None):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    h, nc = gqa_fwd(p["attn"], h, cfg, positions, cache=cache,
                    cache_pos=cache_pos, causal=True, tp=tp)
    x = x + h
    h = rmsnorm(p["ln_x"], x, cfg.norm_eps)
    x = x + cross_attn_fwd(p["xattn"], h, memory, cfg, tp)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp_fwd(p["mlp"], h, cfg.mlp,
                       tp=_split_over(tp, cfg.d_ff)), nc


def _decdec_out(p, x, memory, cfg, positions, tp=None):
    return _decdec_block_fwd(p, x, memory, cfg, positions, tp=tp)[0]


def _sinusoid(n: int, d: int, dtype, device=None) -> torch.Tensor:
    pos = torch.arange(n, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=device), 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def whisper_encode(params, frames, cfg: ModelConfig, mesh=None):
    """frames: (B, F, d_model) precomputed conv/mel embeddings (the
    frontend is stubbed, as in the reference) -> the encoder's output (B,
    F, d_model) in the compute dtype. Full, non-causal self-attention
    without RoPE (``_sdpa``), sinusoidal positions added to the frames. On
    a ``mesh`` with a 'model' axis, from this rank's shards: the output is
    whole on every column."""
    B, F, _ = frames.shape
    cd = _cdtype(cfg)
    x = frames.to(cd) + _sinusoid(F, cfg.d_model, cd, frames.device)
    positions = torch.arange(F, device=frames.device).expand(B, F)
    x, _, _ = _scan_blocks(params["enc_layers"], x, cfg, positions,
                           causal=False, rope=False, tp=model_axis(mesh))
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _whisper_trunk(params, x, cfg, positions, memory, caches=None,
                   cache_pos=None, tp=None):
    """The decoder blocks over the encoder's output ``memory``; with
    caches, each block's own self-attention KV cache."""
    remat = caches is None and _remat(cfg)
    for i, lp in enumerate(_layers(params["dec_layers"], 1)):
        if caches is None:
            x = _apply(_decdec_out, remat, lp, x, memory, cfg, positions, tp)
        else:
            x, _ = _decdec_block_fwd(
                lp, x, memory, cfg, positions,
                cache=tree_map(lambda t: t[i], caches["self"]),
                cache_pos=cache_pos, tp=tp)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), caches


_INITS = {"decoder": _init_decoder, "hybrid": _init_zamba,
          "xlstm": _init_xlstm, "vision": _init_vlm,
          "encoder": _init_whisper}
_TRUNKS = {"decoder": _decoder_trunk, "hybrid": _zamba_trunk,
           "xlstm": _xlstm_trunk, "vision": _vlm_trunk,
           "encoder": _whisper_trunk}
# the families whose trunk attends to a memory (frames, patches)
_MEMORY = ("encoder", "vision")


# ===========================================================================
# Public API
# ===========================================================================

def init_model(gen, cfg: ModelConfig):
    """Parameters of ``cfg`` drawn from ``gen`` on its device (``gen=None``:
    meta tensors, the layout only)."""
    _check_ported(cfg)
    return _INITS[_family(cfg)](gen, cfg)


def params_from_numpy(tree, cfg: ModelConfig, device=None, mesh=None):
    """The reference's parameter tree (nested dicts of numpy arrays) as the
    port's parameters on ``device``. Every leaf must have the shape and the
    dtype (``cfg.param_dtype``) that ``init_model`` gives it. A bfloat16
    leaf (``ml_dtypes``' dtype, which numpy names ``bfloat16``) is carried
    by its bits, so this needs no ``ml_dtypes``. With ``mesh``, each leaf
    is this rank's shard of it (``launch/sharding``'s tp rules)."""
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
    if mesh is None:
        return tree_map(lambda a: _leaf_tensor(np.asarray(a), dev), tree)
    from repro_torch.launch.sharding import local_shard, param_shardings
    specs = param_shardings(template, mesh)
    return tree_map(lambda a, s: local_shard(
        _leaf_tensor(np.asarray(a), "cpu"), s.spec,
        mesh).clone(memory_format=torch.contiguous_format).to(dev),
        tree, specs)


def _leaf_tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16))
        return bits.view(torch.bfloat16).to(device, copy=True)
    return torch.as_tensor(np.array(a), device=device)


def memory_of(params, batch, cfg: ModelConfig, mesh=None):
    """The memory the decoder attends to, as ``forward`` builds it: whisper
    encodes ``batch["frames"]`` (B, n_frames, d_model); the vision decoder
    projects ``batch["patches"]`` (B, n_patches, d_vision) in the compute
    dtype. None for the other families. On a ``mesh`` with a 'model' axis,
    from this rank's shards, whole on every column: a column-split
    ``vision_proj``'s outputs are gathered plain (each cross-attention's
    ``copy_in`` on the memory sums its gradient over the columns)."""
    family = _family(cfg)
    if family == "encoder":
        return whisper_encode(params, batch["frames"], cfg, mesh)
    if family == "vision":
        cd = _cdtype(cfg)
        m = batch["patches"].to(cd) @ params["vision_proj"].to(cd)
        tp = model_axis(mesh)
        return m if m.shape[-1] == cfg.d_model else tp.gather(m)
    return None


def _memory_arg(family: str, memory) -> tuple:
    """The trunk's memory argument: (memory,) for whisper and the vision
    decoder, () for the other families."""
    if family not in _MEMORY:
        return ()
    if memory is None:
        raise ValueError(f"the {family} family attends to a memory: pass "
                         f"frames or patches to forward, memory= to "
                         f"decode_step")
    return (memory,)


def forward(params, batch, cfg: ModelConfig, mesh=None):
    """Training / prefill forward. batch: tokens (B, S) [+ labels (B, S),
    which add the MTP loss to the aux loss where the config has MTP;
    whisper's frames (B, n_frames, d_model), the vision decoder's patches
    (B, n_patches, d_vision)]. On a ``mesh`` with a 'model' axis of M > 1
    columns, ``params`` are this rank's shards
    (``launch/sharding.shard_params``, ``params_from_numpy(..., mesh=)``)
    and the logits this column's V / M of the vocabulary
    (``vocab_split``)."""
    tp = _check_ported(cfg, mesh)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens, _cdtype(cfg),
              _split_over(tp, cfg.d_model))
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    family = _family(cfg)
    x, aux, _ = _TRUNKS[family](
        params, x, cfg, positions,
        *_memory_arg(family, memory_of(params, batch, cfg, mesh)), tp=tp)
    if family == "decoder" and cfg.mtp_depth and "labels" in batch:
        aux = aux + _mtp_loss(params, x, batch, cfg, positions, tp=tp)
    return _logits(params, x, cfg, tp), aux


def _ce(logits, labels, mask=None):
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def _vocab_part(logits, labels, tp) -> tuple:
    """This column's offset into the vocabulary, the labels inside its
    part (shifted to it) and where they are."""
    width = logits.shape[-1]
    local = labels.long() - tp.index * width
    inside = (local >= 0) & (local < width)
    return local.clamp(0, width - 1), inside


def _ce_vocab_parallel(logits, labels, tp, mask=None):
    """``_ce`` over vocab-split logits without gathering them: the max,
    the sum of exponentials and the label's logit, each a model-axis
    collective over (B, S) numbers; the gradient stays on each column's
    own logits. ``mask``: the masked mean, as ``_ce``'s."""
    lf = logits.float()
    m = tp.max(lf.detach().amax(dim=-1))
    sum_exp = tp.reduce_out(torch.exp(lf - m[..., None]).sum(dim=-1))
    local, inside = _vocab_part(lf, labels, tp)
    picked = torch.gather(lf, -1, local[..., None])[..., 0]
    label_logit = tp.reduce_out(torch.where(inside, picked,
                                            torch.zeros_like(picked)))
    nll = torch.log(sum_exp) + m - label_logit
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def argmax_logits(logits, cfg: ModelConfig, mesh=None):
    """``torch.argmax(logits, -1)`` of the logits ``forward`` or
    ``decode_step`` gave on ``mesh``: over vocab-split logits, each
    column's first maximum and its index are gathered and the first
    column holding the largest wins (the whole vocabulary's first
    maximum)."""
    tp = model_axis(mesh)
    if not vocab_split(cfg, tp):
        return torch.argmax(logits, -1)
    vals, idx = logits.max(dim=-1)
    vals = torch.stack(tp.parts(vals, "all-gather"))
    idx = torch.stack(tp.parts(idx + tp.index * logits.shape[-1],
                               "all-gather"))
    best = torch.argmax(vals, dim=0, keepdim=True)
    return torch.gather(idx, 0, best)[0]


def loss_fn(params, batch, cfg: ModelConfig, mesh=None):
    """Cross-entropy (+ the aux loss) and the metrics; on a ``mesh`` with
    a 'model' axis, of this rank's shards, the vocab-parallel
    cross-entropy (no column gathers the logits)."""
    logits, aux = forward(params, batch, cfg, mesh)
    tp = model_axis(mesh)
    if vocab_split(cfg, tp):
        ce = _ce_vocab_parallel(logits, batch["labels"], tp)
    else:
        ce = _ce(logits, batch["labels"])
    loss = ce + aux
    acc = torch.mean((argmax_logits(logits.detach(), cfg, mesh)
                      == batch["labels"]).float())
    return loss, {"loss": loss, "aux": aux, "accuracy": acc}


# --- decode -----------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, length: int, device=None,
               dtype=torch.bfloat16, mesh=None):
    """Zeroed KV caches of the dense and MoE stacks (GQA or MLA latent
    caches, by the config's attention) in ``dtype``. zamba2: the Mamba2
    layers' conv windows and states, (n_groups, every) stacks in f32, and
    the shared block's KV cache of each group in ``dtype``; xLSTM: the
    mLSTM and sLSTM states, f32 (m at -1e9). The recurrent states are f32
    whatever ``dtype`` is, as in the reference. whisper: each decoder
    block's KV cache, of min(length, max_decoder_len) positions; the
    vision decoder: each self-attention layer's, stacked (n_groups,
    cross_attn_every - 1). Cross-attention keeps no cache: each step
    projects the memory again, as in the reference.

    On a ``mesh`` with a 'model' axis of M columns, each rank's cache
    holds what its column runs: the GQA caches its local kv heads where
    the heads split whole over the columns (``attention.tp_split``), else
    every head; MLA's latent cache whole; Mamba2's state its local heads
    and its conv window their x channels beside the whole B and C
    (``ssm.mamba_local``), mLSTM's C, n and m its local heads
    (``ssm.heads_local``) and its conv window whole, sLSTM's states whole.
    The reference splits caches only by batch
    (``repro/launch/sharding.py::cache_shardings``) and leaves the heads
    to XLA, so this local-head layout is the port's own."""
    _check_ported(cfg, mesh)
    dev = resolve_device(device)
    family = _family(cfg)
    M = model_columns(mesh)
    if family == "encoder":
        L = min(length, cfg.encoder.max_decoder_len)
        return {"self": _stacked_cache(cfg, cfg.n_layers, batch, L, dev,
                                       dtype, M)}
    if family == "vision":
        return {"self": _stacked_cache(cfg, _vlm_groups(cfg), batch, length,
                                       dev, dtype, M)}
    if family == "hybrid":
        every = cfg.hybrid.shared_attn_every
        n_groups = cfg.n_layers // every
        return {"mamba": ssm_lib.init_mamba_cache(
                    cfg, batch, device=dev, lead=(n_groups, every),
                    model_parallel=M),
                "attn": _stacked_cache(cfg, n_groups, batch, length, dev,
                                       dtype, M)}
    if family == "xlstm":
        n_groups, n_m = _xlstm_groups(cfg)
        out = {"mlstm": ssm_lib.init_mlstm_cache(cfg, batch, device=dev,
                                                 lead=(n_groups, n_m),
                                                 model_parallel=M)}
        if cfg.ssm.slstm_every:
            out["slstm"] = ssm_lib.init_slstm_cache(cfg, batch, device=dev,
                                                    lead=(n_groups,))
        return out
    n_dense = _n_dense(cfg)
    out = {}
    for name, n in (("dense", n_dense), ("moe", cfg.n_layers - n_dense)):
        if n:
            out[name] = _stacked_cache(cfg, n, batch, length, dev, dtype, M)
    return out


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, memory=None,
                mesh=None):
    """tokens: (B, 1); pos: int — the current write index; ``memory``: the
    encoder's output or the projected patches (``memory_of``), for whisper
    and the vision decoder. Writes the step's keys and values (and the
    recurrent states) into ``cache`` in place. whisper writes at
    min(pos, max_decoder_len - 1) while its RoPE positions run on, as in
    the reference. Returns (logits (B,1,V), cache); on a ``mesh`` with a
    'model' axis, this rank's shards and cache, and its (B, 1, V / M)
    part of the logits (``vocab_split``)."""
    tp = _check_ported(cfg, mesh)
    B = tokens.shape[0]
    x = embed(params["embed"], tokens, _cdtype(cfg),
              _split_over(tp, cfg.d_model))
    positions = torch.full((B, 1), int(pos), device=tokens.device)
    family = _family(cfg)
    cache_pos = (min(int(pos), cfg.encoder.max_decoder_len - 1)
                 if family == "encoder" else pos)
    x, _, nc = _TRUNKS[family](params, x, cfg, positions,
                               *_memory_arg(family, memory), caches=cache,
                               cache_pos=cache_pos, tp=tp)
    return _logits(params, x, cfg, tp), nc


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
