"""The port's CUDA kernels on the card: built from csrc/, launched through
their wrappers and held against their plain PyTorch versions.  Marked
``cuda``; each test skips where no CUDA device is visible (decided inside
the fixture, never at import).  On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerance: rtol 1e-4, atol 1e-5 (the kernel contracts a*b+c into FMAs and
computes expf its own way, so each step rounds differently from the plain
version; chip_smoke.py holds the serving-size run to the same bound)."""

import numpy as np
import pytest
import torch

from vihds_tpu_torch.ops import fused_ode

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible")
    from vihds_tpu_torch.utils import resolve_device

    return resolve_device("cuda")


def _inputs(device, B=5, K=37, T=86, seed=0):
    """Constants in the dr_constant_icml prior's range (log-normal draws
    around the spec's medians), a zero-ish initial state, the 86-point grid."""
    rng = np.random.default_rng(seed)

    def ln(mu, sigma):
        return np.exp(mu + sigma * rng.standard_normal((B, K))).astype(np.float32)

    c = {
        "r": ln(0.0, 0.25), "K": ln(1.0, 0.7), "tlag": ln(0.0, 0.7), "rc": ln(0.0, 2.0),
        "a530": ln(-5.0, 2.0), "a480": ln(-5.0, 2.0), "drfp": ln(-2.0, 1.5),
        "dyfp": ln(-2.0, 1.5), "dcfp": ln(-2.0, 1.5), "dR": ln(-2.0, 1.0), "dS": ln(-2.0, 1.0),
        "e76": ln(-3.0, 1.0), "e81": ln(-3.0, 1.0), "aCFP": ln(0.0, 2.0), "aYFP": ln(0.0, 2.0),
        "KGR_76": ln(2.0, 3.0), "KGS_76": ln(-2.0, 3.0), "KGR_81": ln(-2.0, 3.0),
        "KGS_81": ln(2.0, 3.0), "aR": ln(1.0, 1.0), "aS": ln(1.0, 1.0),
        "fracLuxR": rng.uniform(0, 1, (B, K)).astype(np.float32),
        "fracLasR": rng.uniform(0, 1, (B, K)).astype(np.float32),
    }
    c["r"] = np.clip(c["r"], 0, 4)
    c["K"] = np.clip(c["K"], 0, 4)
    y0 = np.zeros((B, K, 8), np.float32)
    y0[..., 0] = 0.002
    times = np.linspace(0.0, 20.0, T).astype(np.float32)
    return (
        {k: torch.as_tensor(v, device=device) for k, v in c.items()},
        torch.as_tensor(y0, device=device),
        torch.as_tensor(times, device=device),
    )


@pytest.mark.parametrize("method", ["midpoint", "modeuler", "rk4"])
def test_dr_fwd_kernel_matches_plain(cuda, method):
    c, y0, times = _inputs(cuda)
    before = fused_ode.dr_constant_simulate.launches
    got = fused_ode.dr_constant_simulate(c, y0, times, method)
    torch.cuda.synchronize()
    assert fused_ode.dr_constant_simulate.launches == before + 1
    ref = fused_ode.dr_constant_simulate_plain(c, y0, times, method)
    assert got.shape == ref.shape == (86, 5, 37, 8)
    assert torch.isfinite(ref).all()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


def test_dr_fwd_refuses_grad(cuda):
    c, y0, times = _inputs(cuda)
    c["r"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_ode.dr_constant_simulate(c, y0, times)
