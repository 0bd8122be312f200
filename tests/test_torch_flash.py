"""The port's flash attention on the CPU: its wrapper and plain version
against the JAX package's oracle ``repro.kernels.ref.mha_reference`` (the
Pallas kernel itself does not run on this jax: ``pl.load`` is gone), the
model-layout wrapper, the input checks, and the bound the chip smoke run
divides by. The CUDA kernel is held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

# tests/test_kernels.py's shapes, a 7:1 group and ragged S
SHAPES = [(2, 4, 4, 128, 64), (1, 8, 2, 256, 64), (2, 4, 1, 128, 128),
          (1, 2, 2, 512, 32), (1, 14, 2, 1, 32), (1, 14, 2, 77, 32),
          (1, 14, 2, 130, 32)]
# q/k head dim D and v head dim Dv apart (B, H, Hkv, S, D, Dv): MLA's
# 192/128 at a ragged S (the Hopper kernel's <192, 128> on the card), a
# ragged pair in a 4:1 group, and Dv below a 64 bucket
DV_SHAPES = [(1, 4, 4, 77, 192, 128), (2, 8, 2, 130, 136, 72),
             (1, 4, 2, 64, 64, 40)]
# tests/test_kernels.py:26
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, H, Hkv, S, D, dtype, seed=0, Dv=None):
    """One f32 numpy draw, cast to ``dtype`` by each framework (bf16 values
    are then bit-identical in both); v's head dim is ``Dv`` (default D)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, H, S, D), (B, Hkv, S, D),
                          (B, Hkv, S, D if Dv is None else Dv))]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


@pytest.mark.parametrize("B,H,Hkv,S,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_mha_reference(B, H, Hkv, S, D, dtype, causal):
    (jq, jk, jv), (q, k, v) = _inputs(B, H, Hkv, S, D, dtype)
    expect = np.asarray(jref.mha_reference(jq, jk, jv, causal=causal),
                        np.float32)
    launches = fa.flash_attention_bhsd.launches
    got = fa.flash_attention_bhsd(q, k, v, causal=causal)
    assert fa.flash_attention_bhsd.launches == launches   # CPU: plain
    plain = fa.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), expect, atol=tol,
                               rtol=tol)
    # the port's copy of the oracle is the JAX one
    np.testing.assert_allclose(
        ref.mha_reference(q, k, v, causal=causal).float().numpy(), expect,
        atol=tol, rtol=tol)


@pytest.mark.parametrize("B,H,Hkv,S,D,Dv", DV_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_with_two_head_dims_matches_mha_reference(B, H, Hkv, S, D, Dv,
                                                        dtype, causal):
    """v of head dim Dv < D as it is, no padding: the output is (B, H, S,
    Dv), the scale D ** -0.5, through ``flash_attention_bhsd`` (the plain
    version on the CPU) and the model-layout ``ops.flash_attention``."""
    (jq, jk, jv), (q, k, v) = _inputs(B, H, Hkv, S, D, dtype, seed=D + Dv,
                                      Dv=Dv)
    expect = np.asarray(jref.mha_reference(jq, jk, jv, causal=causal),
                        np.float32)
    assert expect.shape == (B, H, S, Dv)
    launches = fa.flash_attention_bhsd.launches
    got = fa.flash_attention_bhsd(q, k, v, causal=causal)
    assert fa.flash_attention_bhsd.launches == launches   # CPU: plain
    assert got.dtype == q.dtype and got.shape == (B, H, S, Dv)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), expect, atol=tol,
                               rtol=tol)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
    assert out.is_contiguous() and out.shape == (B, S, H, Dv)
    torch.testing.assert_close(out.transpose(1, 2), got, rtol=0, atol=0)
    given = torch.empty((B, H, S, Dv), dtype=q.dtype)
    assert fa.flash_attention_bhsd(q, k, v, causal=causal, out=given) is given
    torch.testing.assert_close(given, got, rtol=0, atol=0)


@pytest.mark.parametrize("scale", [None, 0.3])
def test_model_layout_wrapper_matches_reference(scale):
    (jq, jk, jv), (q, k, v) = _inputs(2, 14, 2, 40, 16, "float32", seed=4)
    expect = jref.mha_reference(jq, jk, jv, causal=True, scale=scale)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, scale=scale)
    assert out.is_contiguous() and out.shape == (2, 40, 14, 16)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(),
                               np.asarray(expect), atol=2e-5, rtol=2e-5)


def test_masked_rows_follow_the_kernel_contract():
    # one key: every query row attends to it alone, so o == v everywhere
    q = torch.randn(1, 4, 1, 8)
    k = torch.randn(1, 2, 1, 8)
    v = torch.randn(1, 2, 1, 8)
    out = fa.flash_attention_bhsd(q, k, v)
    torch.testing.assert_close(out, v.repeat_interleave(2, dim=1))


@pytest.mark.parametrize("q_shape,kv_shape,dtype,match", [
    ((2, 4, 16), (2, 4, 16), torch.float32, "needs q"),
    ((1, 6, 16, 32), (1, 4, 16, 32), torch.float32, "multiple of Hkv"),
    ((1, 4, 16, 32), (1, 2, 15, 32), torch.float32, "multiple of Hkv"),
    ((1, 4, 16, 12), (1, 2, 16, 12), torch.float32, "multiple of 8"),
    ((1, 4, 16, 264), (1, 2, 16, 264), torch.float32, "multiple of 8"),
    ((1, 4, 0, 32), (1, 2, 0, 32), torch.float32, "S >= 1"),
    ((1, 4, 16, 32), (1, 2, 16, 32), torch.float16, "float32 or bfloat16"),
    # a (k, v) pair of shapes: v's head dim above D, or not a multiple of 8
    ((1, 4, 16, 32), ((1, 2, 16, 32), (1, 2, 16, 40)), torch.float32,
     "8 <= Dv <= D"),
    ((1, 4, 16, 32), ((1, 2, 16, 32), (1, 2, 16, 20)), torch.float32,
     "8 <= Dv <= D"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(q_shape, kv_shape,
                                                       dtype, match):
    """``kv_shape`` is the shape of k and v, or a (k, v) pair of shapes."""
    q = torch.zeros(q_shape, dtype=dtype)
    k_shape, v_shape = (kv_shape if isinstance(kv_shape[0], tuple)
                        else (kv_shape, kv_shape))
    k = torch.zeros(k_shape, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        fa.flash_attention_bhsd(q, k, torch.zeros(v_shape, dtype=dtype))


def test_wrapper_rejects_mixed_dtypes():
    q = torch.zeros((1, 4, 8, 32))
    k = torch.zeros((1, 2, 8, 32), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="of one dtype"):
        fa.flash_attention_bhsd(q, k, k)


@pytest.mark.parametrize("make,ok", [
    (lambda: torch.zeros(1, 4, 8, 32), True),
    (lambda: torch.zeros(1, 8, 4, 32).transpose(1, 2), True),   # model layout
    (lambda: torch.zeros(1, 4, 8, 64)[..., ::2], False),        # strided D
    (lambda: torch.zeros(1, 4, 8, 33)[..., :32], False),        # odd row
    (lambda: torch.zeros(2 * 4 * 8 * 32 + 1)[1:].view(2, 4, 8, 32), False),
])
def test_kernel_layout_check(make, ok):
    x = make()
    if ok:
        fa._check_layout("q", x)
    else:
        with pytest.raises(ValueError, match="16-byte aligned rows"):
            fa._check_layout("q", x)


# deepseek-coder-33b's prefill: B=4, S=4096, H=56, Hkv=8, D=128, bf16; the
# model passes (B, S, H, D) views as (B, H, S, D)
_Q_MODEL = ((4, 56, 4096, 128), (4096 * 56 * 128, 128, 56 * 128, 1))
_KV_MODEL = ((4, 8, 4096, 128), (4096 * 8 * 128, 128, 8 * 128, 1))


@pytest.mark.parametrize("shape,stride,dtype,match", [
    (*_Q_MODEL, torch.bfloat16, None),
    (*_KV_MODEL, torch.bfloat16, None),
    ((4, 56, 4096, 128), (56 * 4096 * 128, 4096 * 128, 128, 1),
     torch.bfloat16, None),                                  # contiguous
    ((2, 1, 1, 128), (2 ** 39 - 8, 128, 128, 1), torch.bfloat16, None),
    ((2, 1, 1, 128), (2 ** 39, 128, 128, 1), torch.bfloat16, "2\\*\\*40"),
    ((2, 1, 1, 128), (2 ** 38, 128, 128, 1), torch.float32, "2\\*\\*40"),
    ((1, 2, 2, 128), (512, 128, 2 ** 41, 1), torch.bfloat16, "2\\*\\*40"),
    ((4, 56, 4096, 128), (4096 * 56 * 132, 132, 56 * 132 + 4, 1),
     torch.bfloat16, "16-byte aligned rows"),                # odd row pitch
    ((4, 56, 4096, 128), (4096 * 56 * 128, 128, 56 * 128, 2),
     torch.bfloat16, "16-byte aligned rows"),                # strided D
])
def test_kernel_layout_check_at_model_width(shape, stride, dtype, match):
    x = torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    if match is None:
        fa._check_layout("q", x)
    else:
        with pytest.raises(ValueError, match=match):
            fa._check_layout("q", x)


def test_bound_at_the_prefill_shape():
    # B=4, S=4096, H=56, Hkv=8, D=128, bf16, causal (chip_smoke.py)
    q = torch.empty((4, 56, 4096, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((4, 8, 4096, 128), dtype=torch.bfloat16, device="meta")
    assert fa.bound_flops(q, k, k, causal=True) == 4 * 4 * 56 * 128 * (
        4096 * 4097 // 2) == 962_307_555_328
    assert fa.bound_flops(q, k, k, causal=False) == (4 * 4 * 56 * 128
                                                     * 4096 ** 2)
    assert fa.bound_bytes(q, k, k) == 2 * (2 * 4 * 56 + 2 * 4 * 8) \
        * 4096 * 128 == 536_870_912
    # 962 GFLOP at 989 TFLOP/s outweighs 0.54 GB at 3.35 TB/s
    assert (fa.bound_flops(q, k, k) / 989e12
            > fa.bound_bytes(q, k, k) / 3.35e12)


def test_bound_at_the_mla_prefill_shape():
    # deepseek-v3's MLA prefill (chip_smoke.py): B=4, S=4096, H=Hkv=128,
    # q/k head dim 192, v head dim 128, bf16, causal: products of depth 192
    # (q k^T) and 128 (p v) over S(S+1)/2 pairs; o written at 128 columns
    q = torch.empty((4, 128, 4096, 192), dtype=torch.bfloat16, device="meta")
    v = torch.empty((4, 128, 4096, 128), dtype=torch.bfloat16, device="meta")
    flops = fa.bound_flops(q, q, v)
    assert flops == 2 * 4 * 128 * (4096 * 4097 // 2) * (192 + 128) \
        == 2_749_450_158_080
    assert fa.bound_bytes(q, q, v) == 2 * 4 * 128 * 4096 * (2 * 192 + 2 * 128)
    assert round(flops / 989e12 * 1e3, 3) == 2.780
    # padding v to 192 would count (192 + 192) / (192 + 128) = 1.2x
    assert fa.bound_flops(q, q, q) * 5 == flops * 6
