"""The port's CUDA kernels on the card: each against its plain version, and
the launch counts that show the main path went through them. Skipped where
there is no card. Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.kernels import scored_reduce as sr

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


# norms and mean_sq: the reference kernel test's rtol; dots relative to
# sqrt(norms * mean_sq), the size of the terms they sum
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("U,N", [(1, 17), (3, 131), (17, 4099),
                                 (16, 18_404), (64, 1_000_003)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scored_reduce_matches_plain_version(cuda, U, N, dtype):
    gen = torch.Generator(device=cuda).manual_seed(U * N)
    d = torch.randn((U, N), generator=gen, device=cuda).to(dtype)
    mean = d.float().mean(0)
    before = sr.scored_reduce.launches
    dots, norms, msq = sr.scored_reduce(d, mean)
    torch.cuda.synchronize()
    assert sr.scored_reduce.launches == before + 1
    pd, pn, pm = sr.scored_reduce_plain(d, mean)
    tol = TOL[dtype]
    torch.testing.assert_close(norms, pn, rtol=tol, atol=0)
    torch.testing.assert_close(msq, pm, rtol=tol, atol=0)
    scale = torch.sqrt(pn * pm)
    assert bool(((dots - pd).abs() <= tol * scale + 1e-30).all())


def test_scored_reduce_is_deterministic(cuda):
    d = torch.randn((33, 70_001), device=cuda)
    mean = d.mean(0)
    a = sr.scored_reduce(d, mean)
    b = sr.scored_reduce(d, mean)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_scored_reduce_rejects_strided_input(cuda):
    d = torch.randn((8, 64), device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        sr.scored_reduce(d, torch.zeros(32, device=cuda))


def test_harness_round_launches_the_kernel_once(cuda):
    from repro_torch.harness import ExperimentConfig, run
    before = sr.scored_reduce.launches
    hist = run("osafl", ExperimentConfig(model="mlp", dataset=2,
                                         num_clients=16, rounds=2,
                                         capacity=(16, 32)),
               eval_samples=64)
    assert sr.scored_reduce.launches == before + 2
    assert all(torch.isfinite(torch.tensor(h["test_loss"])) for h in hist)
