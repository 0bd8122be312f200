"""Per-device FLOP, traffic and collective accounting of one traced step:
the port's counterpart of ``repro/launch/hlo_analysis.py``.

The reference parses the compiled HLO of a step on the production mesh.
The port has no HLO: its dry run (``launch/dryrun.py``) runs rank 0's step
on fake tensors over PyTorch's ``fake`` process-group backend, and this
module watches it op by op:

  * flops            the FLOPs of each aten op, as
                     ``torch.utils.flop_counter.FlopCounterMode`` counts
                     them (matrix products, convolutions, attention),
  * traffic_bytes    each op's operand and result bytes (an HBM traffic
                     proxy at op granularity, as the reference's is at
                     fusion granularity; views and metadata ops move
                     nothing and are left out),
  * score_traffic_bytes
                     the traffic of ops touching a (seq x seq) score-shaped
                     tensor (two dims equal to a sequence length of 2048 or
                     more): what a fused flash kernel keeps on chip,
  * collective_bytes / collective_counts
                     by kind, from ``core/shmap.record_collectives``: each
                     collective the step called, with the bytes it gathers
                     on this rank ("all-reduce" for the rank-ordered sums,
                     which gather every part, "all-gather" for the
                     concatenations).

All numbers are per device (rank 0's); multiply by the rank count for mesh
totals. The HLO text parser (``parse_module``, ``shape_bytes``,
``while_trip_counts``, ``dispatch_report``) has no counterpart: there is
no HLO, and the fused engine's single dispatch is checked on the card by
its ``cudaGraphLaunch`` count instead.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ops that move no data (views, metadata, aliasing): the reference's
# parameter, bitcast, get-tuple-element and tuple
_NO_TRAFFIC = {
    "view", "_unsafe_view", "reshape", "t", "transpose", "permute",
    "expand", "unsqueeze", "squeeze", "select", "slice", "narrow",
    "as_strided", "alias", "detach", "lift_fresh", "empty", "empty_like",
    "empty_strided", "new_empty", "unbind", "split", "split_with_sizes",
    "chunk", "view_as", "_reshape_alias", "unfold", "diagonal",
}


@dataclass
class Analysis:
    flops: float = 0.0
    collective_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    collective_counts: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    traffic_bytes: float = 0.0
    # traffic of (seq x seq) score-shaped tensors: what a fused flash
    # attention kernel keeps on chip (see the dry run's flash projection)
    score_traffic_bytes: float = 0.0
    seq_len: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def as_dict(self) -> dict:
        return {"flops": self.flops,
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "total_collective_bytes": self.total_collective_bytes,
                "traffic_bytes": self.traffic_bytes}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if torch.is_tensor(t) else 0


def _is_score_shaped(t, seq_len: int) -> bool:
    if seq_len < 2048 or not torch.is_tensor(t):
        return False
    return sum(1 for d in t.shape if d == seq_len) >= 2


class OpCounter(TorchDispatchMode):
    """A dispatch mode that adds each aten op's operand and result bytes
    to an ``Analysis`` (its score-shaped share apart) and keeps the bytes
    by (op, result shape) for ``top_traffic``. Enter it inside the fake
    tensor mode so it sees the ops the step runs."""

    def __init__(self, seq_len: int = 0):
        super().__init__()
        self.analysis = Analysis(seq_len=seq_len)
        self.by_op: Dict[tuple, list] = defaultdict(lambda: [0.0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _NO_TRAFFIC or func.namespace != "aten":
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if torch.is_tensor(t)]
        outs = [t for t in tree_flatten(out)[0] if torch.is_tensor(t)]
        b = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        a = self.analysis
        a.traffic_bytes += b
        if any(_is_score_shaped(t, a.seq_len) for t in ins + outs):
            a.score_traffic_bytes += b
        shape = tuple(outs[0].shape) if outs else ()
        row = self.by_op[(name, shape)]
        row[0] += b
        row[1] += 1
        return out


def add_collectives(analysis: Analysis, log: list) -> Analysis:
    """Fold a ``shmap.record_collectives`` log into ``analysis``."""
    for entry in log:
        analysis.collective_bytes[entry["kind"]] += entry["bytes"]
        analysis.collective_counts[entry["kind"]] += 1
    return analysis


def top_collectives(log: list, n: int = 12) -> list:
    """The n largest collectives of a ``shmap.record_collectives`` log by
    bytes, calls of one kind, axis and size counted together."""
    acc: Dict[tuple, list] = defaultdict(lambda: [0.0, 0])
    for e in log:
        row = acc[(e["kind"], e["axis"], e["bytes"])]
        row[0] += e["bytes"]
        row[1] += 1
    out = [{"kind": k, "axis": ax, "bytes": total, "count": count,
            "bytes_per_call": each}
           for (k, ax, each), (total, count) in acc.items()]
    out.sort(key=lambda r: -r["bytes"])
    return out[:n]


def top_traffic(counter: OpCounter, n: int = 12) -> list:
    """The n largest traffic entries of a traced step (operand and result
    bytes, summed over the calls of one op with one result shape)."""
    out = [{"op": name, "shape": list(shape), "bytes": total, "count": count}
           for (name, shape), (total, count) in counter.by_op.items()]
    out.sort(key=lambda r: -r["bytes"])
    return out[:n]
