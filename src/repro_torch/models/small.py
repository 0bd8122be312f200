"""The paper's evaluation models in PyTorch (``repro/models/small.py``).

Parameters are nested dicts of tensors in the reference's layout: a dense
layer holds ``w`` (in, out) and ``b`` (out,) and computes ``x @ w + b``, so
reference weights import unchanged (``params_from_numpy``) and the flat
codec lines rows up with the reference's. ``fcn`` (Dataset-1) and ``mlp``
(Dataset-2, beyond-paper, cheap) are ported; ``cnn``, ``squeezenet`` and
``lstm`` are not yet.

Native init draws from a ``torch.Generator`` seeded with the run seed; it
cannot reproduce the reference's threefry numbers, so parity checks import
the reference's weights instead.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.flatten import tree_map, tree_paths, tree_get
from repro_torch.device import resolve_device

NUM_CLASSES = 100
D1_FEATURES = 3168
SEQ_LEN = 10


def dense_init(gen: torch.Generator, shape, scale: float = 0.02
               ) -> torch.Tensor:
    return scale * torch.randn(shape, generator=gen, dtype=torch.float32)


def _linear(gen, din, dout):
    return {"w": dense_init(gen, (din, dout), scale=(2.0 / din) ** 0.5),
            "b": torch.zeros(dout)}


def _apply_linear(p, x):
    return x @ p["w"] + p["b"]


# --- FCN (Dataset-1) ---------------------------------------------------------

def init_fcn(gen):
    return {"l1": _linear(gen, D1_FEATURES, 1024),
            "l2": _linear(gen, 1024, 512),
            "l3": _linear(gen, 512, NUM_CLASSES)}


def fcn_forward(params, x):
    h = torch.relu(_apply_linear(params["l1"], x))
    h = torch.relu(_apply_linear(params["l2"], h))
    return _apply_linear(params["l3"], h)


# --- MLP (Dataset-2; beyond-paper) -------------------------------------------

def init_mlp(gen):
    return {"embed": dense_init(gen, (NUM_CLASSES, 16)),
            "l1": _linear(gen, SEQ_LEN * 16, 64),
            "head": _linear(gen, 64, NUM_CLASSES)}


def mlp_forward(params, x):
    """x: (B, L) integer content ids."""
    h = params["embed"][x.long()]
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(_apply_linear(params["l1"], h))
    return _apply_linear(params["head"], h)


REGISTRY = {
    "fcn": (init_fcn, fcn_forward),
    "mlp": (init_mlp, mlp_forward),
}


def _entry(name: str):
    if name not in REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported to repro_torch yet (ported: "
            f"{sorted(REGISTRY)})")
    return REGISTRY[name]


def init_small(seed: int, name: str, device=None) -> dict:
    """Native init of model ``name`` from ``seed``, on ``device``."""
    gen = torch.Generator().manual_seed(int(seed))
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), _entry(name)[0](gen))


def params_from_numpy(name: str, tree, device=None) -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays) as the
    port's parameters on ``device``; checked leaf by leaf against the
    model's layout."""
    template = _entry(name)[0](torch.Generator().manual_seed(0))
    want, got = tree_paths(template), tree_paths(tree)
    if want != got:
        raise ValueError(f"{name} parameters need leaves {want}, got {got}")
    for p in want:
        a, b = tuple(tree_get(template, p).shape), np.shape(tree_get(tree, p))
        if a != b:
            raise ValueError(f"{name} leaf {'.'.join(p)} has shape {b}, "
                             f"expected {a}")
    dev = resolve_device(device)
    return tree_map(lambda a: torch.as_tensor(np.array(a, np.float32),
                                              device=dev), tree)


def small_forward(params, x, name: str):
    return _entry(name)[1](params, x)


def small_loss(params, batch, name: str):
    logits = small_forward(params, batch["x"], name)
    labels = batch["y"].long()
    logp = F.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.gather(logp, -1, labels[:, None]))
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"loss": loss, "accuracy": acc}
