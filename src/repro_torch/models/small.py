"""The paper's evaluation models in PyTorch (``repro/models/small.py``):
``fcn``, ``cnn`` and ``squeezenet`` on Dataset-1 (3168 features: a
flattened 32x32x3 NHWC image and 96 side features), ``lstm`` on Dataset-2
(the last 10 content ids), and ``mlp`` (Dataset-2, beyond-paper, cheap).

Parameters are nested dicts of tensors in the reference's layout: a dense
layer holds ``w`` (in, out) and ``b`` (out,) and computes ``x @ w + b``, a
convolution ``w`` in HWIO (k, k, cin, cout), an LSTM layer ``wx`` (din,
4 dh), ``wh`` (dh, 4 dh) and one bias, gates in the order i, f, g, o. So
reference weights import unchanged (``params_from_numpy``) and the flat
codec lines rows up with the reference's. The convolutions run in NCHW
inside the forward; the image features that feed a dense layer are put
back in the reference's NHWC order first. ``nn.LSTM`` is not used: its
weight layout and two biases differ, and it has no ``torch.func.vmap``
rule for per-client weights.

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
IMG = (32, 32, 3)
SIDE = D1_FEATURES - 3072
SEQ_LEN = 10


def dense_init(gen: torch.Generator, shape, scale: float = 0.02
               ) -> torch.Tensor:
    return scale * torch.randn(shape, generator=gen, dtype=torch.float32)


def _linear(gen, din, dout):
    return {"w": dense_init(gen, (din, dout), scale=(2.0 / din) ** 0.5),
            "b": torch.zeros(dout)}


def _apply_linear(p, x):
    return x @ p["w"] + p["b"]


def _conv(gen, k, cin, cout):
    return {"w": dense_init(gen, (k, k, cin, cout),
                            scale=(2.0 / (k * k * cin)) ** 0.5),
            "b": torch.zeros(cout)}


def _apply_conv(p, x):
    """Stride-1 "SAME" convolution of an NCHW map (odd k)."""
    k = p["w"].shape[0]
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=k // 2)


def _maxpool(x):
    return F.max_pool2d(x, 2, 2)


def _split_image(x):
    """Dataset-1 rows -> (NCHW image, side features)."""
    img = x[:, :3072].reshape(x.shape[0], *IMG).permute(0, 3, 1, 2)
    return img, x[:, 3072:]


# --- FCN (Dataset-1) ---------------------------------------------------------

def init_fcn(gen):
    return {"l1": _linear(gen, D1_FEATURES, 1024),
            "l2": _linear(gen, 1024, 512),
            "l3": _linear(gen, 512, NUM_CLASSES)}


def fcn_forward(params, x):
    h = torch.relu(_apply_linear(params["l1"], x))
    h = torch.relu(_apply_linear(params["l2"], h))
    return _apply_linear(params["l3"], h)


# --- CNN (Dataset-1) ---------------------------------------------------------

def init_cnn(gen):
    return {"c1": _conv(gen, 3, 3, 32), "c2": _conv(gen, 3, 32, 64),
            "f1": _linear(gen, 8 * 8 * 64 + SIDE, 256),
            "f2": _linear(gen, 256, NUM_CLASSES)}


def cnn_forward(params, x):
    img, side = _split_image(x)
    h = _maxpool(torch.relu(_apply_conv(params["c1"], img)))
    h = _maxpool(torch.relu(_apply_conv(params["c2"], h)))
    # f1's 4096 image rows are in the reference's (H, W, C) order
    h = torch.cat([h.permute(0, 2, 3, 1).reshape(h.shape[0], -1), side], -1)
    h = torch.relu(_apply_linear(params["f1"], h))
    return _apply_linear(params["f2"], h)


# --- SqueezeNet1-style (Dataset-1) -------------------------------------------

def _fire(gen, cin, squeeze, expand):
    return {"s": _conv(gen, 1, cin, squeeze),
            "e1": _conv(gen, 1, squeeze, expand),
            "e3": _conv(gen, 3, squeeze, expand)}


def _apply_fire(p, x):
    s = torch.relu(_apply_conv(p["s"], x))
    return torch.cat([torch.relu(_apply_conv(p["e1"], s)),
                      torch.relu(_apply_conv(p["e3"], s))], dim=1)


def init_squeezenet(gen):
    return {"c1": _conv(gen, 3, 3, 64),
            "fire1": _fire(gen, 64, 16, 64),
            "fire2": _fire(gen, 128, 16, 64),
            "fire3": _fire(gen, 128, 32, 128),
            "head": _conv(gen, 1, 256, NUM_CLASSES),
            "side": _linear(gen, SIDE, NUM_CLASSES)}


def squeezenet_forward(params, x):
    img, side = _split_image(x)
    h = _maxpool(torch.relu(_apply_conv(params["c1"], img)))     # 64x16x16
    h = _apply_fire(params["fire1"], h)
    h = _maxpool(_apply_fire(params["fire2"], h))                 # 128x8x8
    h = _apply_fire(params["fire3"], h)                           # 256x8x8
    h = _apply_conv(params["head"], h)                            # Cx8x8
    return h.mean(dim=(2, 3)) + _apply_linear(params["side"], side)


# --- LSTM (Dataset-2) --------------------------------------------------------

def _lstm_layer(gen, din, dh):
    return {"wx": dense_init(gen, (din, 4 * dh), scale=(1.0 / din) ** 0.5),
            "wh": dense_init(gen, (dh, 4 * dh), scale=(1.0 / dh) ** 0.5),
            "b": torch.zeros(4 * dh)}


def _apply_lstm(p, xs):
    """xs: (B, L, din) -> (B, L, dh)."""
    B, L = xs.shape[:2]
    dh = p["wh"].shape[0]
    xw = xs @ p["wx"]                    # every step's input product at once
    h = c = xs.new_zeros((B, dh))
    hs = []
    for t in range(L):
        gates = xw[:, t] + h @ p["wh"] + p["b"]
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def init_lstm(gen):
    return {"embed": dense_init(gen, (NUM_CLASSES, 64)),
            "l1": _lstm_layer(gen, 64, 128),
            "l2": _lstm_layer(gen, 128, 128),
            "l3": _lstm_layer(gen, 128, 128),
            "head": _linear(gen, 128, NUM_CLASSES)}


def lstm_forward(params, x):
    """x: (B, L) integer content ids."""
    h = params["embed"][x.long()]
    for layer in ("l1", "l2", "l3"):
        h = _apply_lstm(params[layer], h)
    return _apply_linear(params["head"], h[:, -1])


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
    "cnn": (init_cnn, cnn_forward),
    "squeezenet": (init_squeezenet, squeezenet_forward),
    "lstm": (init_lstm, lstm_forward),
    "mlp": (init_mlp, mlp_forward),
}


def _entry(name: str):
    if name not in REGISTRY:
        raise KeyError(f"unknown model {name!r} (known: {sorted(REGISTRY)})")
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
