"""Flat codec, paper models and whole-cohort local SGD of the port against
the JAX reference on the same (imported) weights and batches."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.client import make_vmapped_local_train
from repro_torch.core.flatten import make_codec, tree_map
from repro_torch.models import small
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401

D2_VOCAB = 100
MODELS = ["fcn", "cnn", "squeezenet", "lstm", "mlp"]
# A ReLU whose pre-activation lies within rounding of zero, or a max-pool
# window within rounding of a tie, switches a gradient path on or off; so
# two float32 implementations of the convolutional models can differ there
# by far more than their rounding (on SqueezeNet's weights and batch below,
# one ReLU of fire3 comes out on the other side of zero in the port). Their
# gradient-based checks run both packages in float64, at the same
# tolerances; their forward checks stay in float32.
GRAD_F64 = ("cnn", "squeezenet")


@contextlib.contextmanager
def _grad_precision(name):
    """(numpy dtype, torch dtype) of a model's gradient checks, with the
    reference in 64-bit mode for the float64 ones."""
    if name not in GRAD_F64:
        yield np.float32, torch.float32
        return
    with jax.experimental.enable_x64():
        yield np.float64, torch.float64


def _cast(b, dt):
    """A batch with float features in ``dt`` (Dataset-2 ids stay ints)."""
    return {k: v.astype(dt) if v.dtype.kind == "f" else v
            for k, v in b.items()}


def _batch(name, B, rng):
    if name in ("fcn", "cnn", "squeezenet"):
        x = rng.normal(size=(B, small.D1_FEATURES)).astype(np.float32)
    else:
        x = rng.integers(0, D2_VOCAB, size=(B, small.SEQ_LEN))
    return {"x": x, "y": rng.integers(0, small.NUM_CLASSES, size=B)}


def _weights(reference, name, seed=0):
    return to_numpy_tree(reference.small.init_small(jax.random.PRNGKey(seed),
                                                    name))


def _port_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


@pytest.mark.parametrize("name", MODELS)
def test_codec_rows_match_reference_exactly(reference, name):
    w = _weights(reference, name)
    p = small.params_from_numpy(name, w, device="cpu")
    codec = make_codec(p)
    jcodec = reference.flatten.make_codec(jax.tree.map(jnp.asarray, w))
    assert codec.n == jcodec.n
    assert codec.shapes == jcodec.shapes and codec.offsets == jcodec.offsets
    row = codec.flatten(p).numpy()
    np.testing.assert_array_equal(row, np.asarray(jcodec.flatten(w)))
    back = codec.unflatten(torch.from_numpy(row))
    for path in codec.paths:
        a, b = back, p
        for k in path:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # stacked rows are the per-client rows
    stacked = tree_map(lambda t: torch.stack([t, 2 * t, -t]), p)
    mat = codec.flatten_stacked(stacked).numpy()
    np.testing.assert_array_equal(mat, np.stack([row, 2 * row, -row]))
    np.testing.assert_array_equal(
        codec.flatten_stacked(codec.unflatten_stacked(torch.from_numpy(mat)))
        .numpy(), mat)


def test_params_from_numpy_checks_the_layout(reference):
    w = _weights(reference, "mlp")
    w["l1"]["w"] = w["l1"]["w"][:, :3]
    with pytest.raises(ValueError, match="shape"):
        small.params_from_numpy("mlp", w, device="cpu")
    with pytest.raises(KeyError, match="resnet"):
        small.init_small(0, "resnet", device="cpu")


@pytest.mark.parametrize("name", MODELS)
def test_logits_loss_and_grads_match_reference(reference, name):
    rng = np.random.default_rng(1)
    w = _weights(reference, name)
    b = _batch(name, 12, rng)
    p = small.params_from_numpy(name, w, device="cpu")
    jw = jax.tree.map(jnp.asarray, w)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    # f32 products summed in another order: 1e-5 relative
    np.testing.assert_allclose(
        small.small_forward(p, _port_batch(b)["x"], name).numpy(),
        np.asarray(reference.small.small_forward(jw, jb["x"], name)),
        rtol=1e-5, atol=1e-5)
    loss, m = small.small_loss(p, _port_batch(b), name)
    jloss, jm = reference.small.small_loss(jw, jb, name)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert float(m["accuracy"]) == float(jm["accuracy"])
    with _grad_precision(name) as (ndt, tdt):
        b = _cast(b, ndt)
        g = torch.func.grad(lambda q, bb: small.small_loss(q, bb, name)[0])(
            tree_map(lambda t: t.to(tdt), p), _port_batch(b))
        jg = jax.grad(
            lambda q, bb: reference.small.small_loss(q, bb, name)[0])(
            jax.tree.map(lambda a: jnp.asarray(a, ndt), w),
            {k: jnp.asarray(v) for k, v in b.items()})
    for path in make_codec(p).paths:
        a, e = g, jg
        for k in path:
            a, e = a[k], e[k]
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("name,prox_mu", [
    ("mlp", 0.0), ("mlp", 0.9), ("fcn", 0.0), ("cnn", 0.0), ("cnn", 0.9),
    ("squeezenet", 0.0), ("squeezenet", 0.9), ("lstm", 0.0), ("lstm", 0.9)])
def test_vmapped_local_train_matches_reference(reference, name, prox_mu):
    rng = np.random.default_rng(2)
    kappa_max, B, lr = 5, 4, 0.1
    kappas = np.array([0, 1, 3, kappa_max])         # straggler .. full
    U = kappas.size
    w = _weights(reference, name)
    flat = [_batch(name, kappa_max * B, rng) for _ in range(U)]
    batches = {k: np.stack([f[k].reshape((kappa_max, B) + f[k].shape[1:])
                            for f in flat]) for k in ("x", "y")}
    jgrad = jax.grad(lambda q, bb: reference.small.small_loss(q, bb, name)[0])
    tgrad = torch.func.grad(lambda q, bb: small.small_loss(q, bb, name)[0])
    p = small.params_from_numpy(name, w, device="cpu")
    codec = make_codec(p)
    jcodec = reference.flatten.make_codec(jax.tree.map(jnp.asarray, w))
    with _grad_precision(name) as (ndt, tdt):
        batches = _cast(batches, ndt)
        jd, jw = reference.client.make_vmapped_local_train(
            jgrad, lr, kappa_max, prox_mu=prox_mu)(
            jax.tree.map(lambda a: jnp.asarray(a, ndt), w),
            {k: jnp.asarray(v) for k, v in batches.items()},
            jnp.asarray(kappas))
        td, tw = make_vmapped_local_train(
            tgrad, lr, kappa_max, prox_mu=prox_mu)(
            tree_map(lambda t: t.to(tdt), p), _port_batch(batches),
            torch.as_tensor(kappas))
        d, dj = codec.flatten_stacked(td).numpy(), np.asarray(
            jcodec.flatten_stacked(jd))
        ww, wj = codec.flatten_stacked(tw).numpy(), np.asarray(
            jcodec.flatten_stacked(jw))
    assert not d[0].any()                       # kappa = 0: d_u = 0 exactly
    np.testing.assert_array_equal(ww[0], wj[0])  # and w_u = w^0
    # weights to 1e-5; d = dw / (lr * kappa) scales their error by up to 10
    np.testing.assert_allclose(ww, wj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d, dj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["paper-fcn", "paper-cnn", "paper-squeezenet",
                                  "paper-lstm"])
def test_paper_configs_match_reference(reference, arch):
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(reference.configs.get_config(arch)))


def test_cnn_reads_the_image_in_nhwc_order():
    """f1's image rows are (H, W, C): a pixel's channels are adjacent."""
    p = small.init_small(0, "cnn", device="cpu")
    x = torch.zeros(1, small.D1_FEATURES)
    x[0, 0] = 1.0          # pixel (0, 0), channel 0 in the NHWC flattening
    img, side = small._split_image(x)
    assert img.shape == (1, 3, 32, 32) and side.shape == (1, small.SIDE)
    assert img[0, 0, 0, 0] == 1.0 and img.sum() == 1.0
    x = torch.zeros(1, small.D1_FEATURES)
    x[0, 1] = 1.0          # the same pixel, channel 1
    assert small._split_image(x)[0][0, 1, 0, 0] == 1.0
    assert small.small_forward(p, x, "cnn").shape == (1, small.NUM_CLASSES)
