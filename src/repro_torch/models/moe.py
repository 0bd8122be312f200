"""Mixture-of-Experts layer with capacity-based sort dispatch
(``repro/models/moe.py``), as plain functions on tensors.

  1. router: softmax of f32 logits, top-k, renormalised gates;
  2. dispatch: the token-expert assignments sorted by expert id (stable),
     dropped beyond a fixed per-expert capacity C = _capacity(T, k, E) ->
     gather (E, C, d);
  3. batched expert products (E, C, d) x (E, d, f) (``torch.bmm``);
  4. combine: each token's gated expert outputs added back.

DeepSeek-V3's shared experts and Arctic's dense residual MLP run beside the
MoE branch. Returns the Switch-style load-balance auxiliary loss.

Where the reference's rules are only implicit, the port states them so the
card gives the CPU reference's answer, deterministically:

- top-k ties go to the lower expert index (``jax.lax.top_k``), through a
  stable descending sort (``torch.topk`` promises no order on CUDA);
- an expert that receives more than C assignments ends with slot 0 empty
  (token T, gate 0): the reference's scatter sends every dropped assignment
  to slot (e, 0), and on the CPU its last write, a drop, wins. The port
  writes the kept assignments to their slots (no two to one slot; the
  dropped ones go to a spare column that is cut off) and then empties slot
  0 of each overfull expert;
- the combine adds each token's k expert outputs in ascending expert order
  in the compute dtype, starting from zero, as the reference's scatter-add
  does on the CPU, by gathers: no atomics, so reruns repeat bit for bit.

Which assignments are dropped depends on the whole batch, so a prompt's
forward and its token-by-token decode route alike only when nothing is
dropped (the tests raise ``capacity_factor`` for that comparison).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, init_mlp, mlp_fwd


def init_moe(gen, cfg: ModelConfig, dtype=torch.float32, lead: tuple = ()):
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    p = {"router": dense_init(gen, (*lead, d, E), dtype=dtype),
         "w_gate": dense_init(gen, (*lead, E, d, f), dtype=dtype),
         "w_up": dense_init(gen, (*lead, E, d, f), dtype=dtype),
         "w_down": dense_init(gen, (*lead, E, f, d), dtype=dtype)}
    if m.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, f * m.num_shared_experts, dtype,
                               lead)
    if m.dense_residual_d_ff:
        p["dense_residual"] = init_mlp(gen, cfg, m.dense_residual_d_ff,
                                       dtype, lead)
    return p


def _capacity(T: int, k: int, E: int, factor: float) -> int:
    c = int((T * k / E) * factor) + 1
    return min(max(8, c), T)  # floor for tiny smokes, never exceed all tokens


def route(router, xt, k: int):
    """Router of tokens ``xt`` (T, d): (probs (T, E) f32, gates (T, k) f32
    renormalised, expert ids (T, k)), the top k by probability with ties
    to the lower index. The logits are computed in ``xt``'s dtype."""
    logits = (xt @ router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[:, :k], ids[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_ids


def _counts(flat_e, E: int):
    """Each expert's assignment count (E,) int64. A scatter into a fixed
    (E,) shape, not ``torch.bincount``, whose output size depends on the
    data (a traced step on fake tensors cannot size it)."""
    return torch.zeros(E, dtype=torch.int64, device=flat_e.device
                       ).scatter_add_(0, flat_e, torch.ones_like(flat_e))


def dispatch(expert_ids, gate_vals, E: int, C: int):
    """The (E, C) token table (T = empty) and f32 gate table of the sort
    dispatch, each expert's assignment count (E,), and each assignment's
    slot ``e * C + c`` in the tables, (T, k) in ascending expert order per
    token, ``E * C`` where the assignment was dropped."""
    T, k = expert_ids.shape
    dev = expert_ids.device
    flat_e = expert_ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // k                           # the token of each assignment
    group_start = torch.searchsorted(se, torch.arange(E, device=dev))
    pos = torch.arange(T * k, device=dev) - group_start[se]
    count = _counts(flat_e, E)
    keep = pos < C
    # kept assignments to their slots, dropped ones to a spare column C
    # (discarded; its duplicate writes are never read)
    col = torch.where(keep, pos, C)
    token_table = torch.full((E, C + 1), T, dtype=torch.int64, device=dev)
    token_table[se, col] = st
    gate_table = torch.zeros((E, C + 1), dtype=torch.float32, device=dev)
    gate_table[se, col] = gate_vals.reshape(-1)[order]
    # an overfull expert loses its slot 0, as the reference's last write
    over = count > C
    token_table[:, 0] = torch.where(over, T, token_table[:, 0])
    gate_table[:, 0] = torch.where(over, 0.0, gate_table[:, 0])
    # each assignment's slot, back in token order
    pos_flat = torch.empty_like(pos)
    pos_flat[order] = pos
    lost = (pos_flat >= C) | ((pos_flat == 0) & over[flat_e])
    slot = torch.where(lost, E * C, flat_e * C + pos_flat).reshape(T, k)
    slot = torch.gather(slot, 1, torch.argsort(expert_ids, dim=1))
    return token_table[:, :C], gate_table[:, :C], count, slot


def dispatch_stats(params, x, cfg: ModelConfig) -> dict:
    """What ``moe_fwd`` would route for ``x`` (B, S, d): the capacity C,
    the tokens T, the largest expert count, the assignments dropped beyond
    C and the assignments lost to an emptied slot 0 (0-dim tensors)."""
    m = cfg.moe
    T = x.shape[0] * x.shape[1]
    E = m.num_experts
    C = _capacity(T, m.top_k, E, m.capacity_factor)
    _, _, ids = route(params["router"], x.reshape(T, -1), m.top_k)
    count = _counts(ids.reshape(-1), E)
    return {"capacity": C, "tokens": T, "max_count": count.max(),
            "over_capacity": torch.clamp(count - C, min=0).sum(),
            "slot0_emptied": (count > C).sum()}


def moe_fwd(params, x, cfg: ModelConfig, tp=None):
    """x: (B, S, d) -> (y, aux_loss).

    ``tp`` (a ``core/shmap.ModelAxis``): expert parallelism where E
    divides by M (the rules' ``_MOE_EXPERT``: each column holds E / M
    experts of each stacked ``w_gate``/``w_up``/``w_down``). Every column
    routes the whole batch (the router is whole: the same top-k, capacity
    and tables, so the same drops), runs its E / M experts' rows of the
    tables and combines its part; the parts are model-summed, in rank
    order, which is ascending expert order. The experts' input crosses in through ``copy_in`` (the
    columns' partial input gradients summed) and the local gate rows come
    out of the whole gate table through ``split`` (the columns' gate
    gradients concatenated back), so the router's path, computed whole on
    every column, receives its whole gradient once. The aux loss is
    added once, never summed. The shared expert and the dense residual
    run whole on every column and are added after the sum. Where E does
    not divide by M the experts are whole and every column runs all of
    them, with nothing summed."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    T = B * S
    dt = x.dtype
    xt = x.reshape(T, d)

    probs, gate_vals, expert_ids = route(params["router"], xt, k)
    C = _capacity(T, k, E, m.capacity_factor)
    token_table, gate_table, count, slot = dispatch(expert_ids, gate_vals,
                                                    E, C)
    # load-balance aux loss (Switch): E * sum_e mean_frac_e * mean_prob_e
    frac = count.float() / (T * k)
    aux = m.router_aux_coef * E * torch.sum(frac * probs.mean(0))

    split = tp is not None and E % tp.size == 0
    if split:
        n = E // tp.size
        lo = tp.index * n
        xt_in = tp.copy_in(xt)
        token_table = token_table[lo:lo + n]
        gate_table = tp.split(gate_table, dim=0)
        # this column's slots from 0; another column's and dropped ones
        # to the zero row n * C
        local = slot - lo * C
        slot = torch.where((local >= 0) & (local < n * C), local, n * C)
    else:
        n, xt_in = E, xt

    xt_pad = torch.cat([xt_in, xt_in.new_zeros((1, d))])  # row T = zeros
    xe = xt_pad[token_table]                               # (n, C, d)

    gate = torch.bmm(xe, params["w_gate"].to(dt))
    up = torch.bmm(xe, params["w_up"].to(dt))
    ye = torch.bmm(F.silu(gate) * up, params["w_down"].to(dt))   # (n, C, d)

    # combine: row n * C of the gated outputs is zeros (a dropped slot)
    yg = (ye * gate_table[..., None].to(dt)).reshape(n * C, d)
    yg = torch.cat([yg, yg.new_zeros((1, d))])
    y = torch.zeros((T, d), dtype=dt, device=x.device)
    for j in range(k):
        y = y + yg[slot[:, j]]
    if split:
        y = tp.reduce_out(y)
    y = y.reshape(B, S, d)

    if m.num_shared_experts:
        y = y + mlp_fwd(params["shared"], x, "swiglu")
    if m.dense_residual_d_ff:
        y = y + mlp_fwd(params["dense_residual"], x, "swiglu")
    return y, aux
