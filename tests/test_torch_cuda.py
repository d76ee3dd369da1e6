"""The port's CUDA kernels on the card (the forward and backward kernels of
the dr, dr_prec, relay, relay_prec, degrader and degrader_prec kinds and of
the black-box ODE): built
from csrc/, launched through their wrappers and held against their plain
PyTorch versions.  Marked
``cuda``; each test skips where no CUDA device is visible (decided inside
the fixture, never at import).  On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerance of the forward: rtol 1e-4, atol 1e-5 (the kernel contracts a*b+c
into FMAs and computes expf its own way, so each step rounds differently
from the plain version; chip_smoke.py holds the serving-size run to the same
bound); the relay and degrader kinds' C6 / C12, and degrader_prec's
precision states, are held against each trajectory's largest magnitude
(``chip_smoke.states_ok``).  The backward's is stated at
``_assert_cotangents_close``."""

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


def _assert_cotangents_close(got, ref):
    """A backward output [n, R] against its float64 reference, by the rule
    chip_smoke.py states for dr_bwd: every constant's (or state's) row on
    its own, within 1e-4 normwise and 1e-3 at the 99th percentile of its
    elements' relative errors."""
    import chip_smoke

    got, ref = got.cpu(), ref.double().cpu()
    assert torch.isfinite(ref).all()
    norm, rel = chip_smoke.cotangent_readings(got, ref)
    assert chip_smoke.cotangents_ok(got, ref), (float(norm.max()), float(rel.max()))


@pytest.mark.parametrize("method", ["midpoint", "modeuler", "rk4"])
def test_dr_bwd_kernel_matches_plain(cuda, method):
    c, y0, times = _inputs(cuda)
    packed, y0_cols = fused_ode._pack(c, y0)
    traj = fused_ode._integrate_cuda(packed, y0_cols, times, method)
    g = torch.as_tensor(
        np.random.default_rng(1).standard_normal(tuple(traj.shape)).astype(np.float32), device=cuda
    )
    before = fused_ode.dr_bwd.launches
    dc, dy0 = fused_ode.dr_bwd(packed, times, traj, g, method)
    torch.cuda.synchronize()
    assert fused_ode.dr_bwd.launches == before + 1
    ref_dc, ref_dy0 = fused_ode._integrate_plain_bwd(
        packed.double(), times.double(), traj.double(), g.double(), method
    )
    assert dc.shape == ref_dc.shape == (23, 5 * 37) and dy0.shape == (8, 5 * 37)
    _assert_cotangents_close(dc, ref_dc)
    _assert_cotangents_close(dy0, ref_dy0)


def test_dr_autograd_function_matches_float64_autograd(cuda):
    """Gradcheck-style: the autograd Function on the card (dr_fwd forward,
    dr_bwd backward, float32) against torch.autograd through the plain
    version in float64 on the CPU, for a weighted sum of the trajectory."""
    c, y0, times = _inputs(cuda)
    w = np.random.default_rng(2).standard_normal((86, 5, 37, 8))
    leaves = {k: v.clone().requires_grad_(True) for k, v in c.items()}
    y0_leaf = y0.clone().requires_grad_(True)
    fwd0, bwd0 = fused_ode.dr_constant_simulate.launches, fused_ode.dr_bwd.launches
    sol = fused_ode.dr_constant_simulate(leaves, y0_leaf, times, "midpoint")
    (sol * torch.as_tensor(w, dtype=torch.float32, device=cuda)).sum().backward()
    torch.cuda.synchronize()
    assert fused_ode.dr_constant_simulate.launches == fwd0 + 1
    assert fused_ode.dr_bwd.launches == bwd0 + 1

    ref_leaves = {k: v.detach().cpu().double().requires_grad_(True) for k, v in c.items()}
    ref_y0 = y0.detach().cpu().double().requires_grad_(True)
    ref = fused_ode.dr_constant_simulate_plain(ref_leaves, ref_y0, times.cpu().double(), "midpoint")
    (ref * torch.as_tensor(w)).sum().backward()
    got_dc = torch.stack([leaves[k].grad.reshape(-1) for k in fused_ode.DR_CONST_NAMES])
    ref_dc = torch.stack([ref_leaves[k].grad.reshape(-1) for k in fused_ode.DR_CONST_NAMES])
    _assert_cotangents_close(got_dc, ref_dc)
    _assert_cotangents_close(y0_leaf.grad.reshape(-1, 8).t(), ref_y0.grad.reshape(-1, 8).t())


def _prec_operands(device, seed=0, B=5, K=37):
    """dr_prec operands: ``_inputs``' constants, 4 precision states started
    at e^6 ~ 400, and seeded weights of the precision nets' [8, 10] matrix in
    their xavier range."""
    c, y0, times = _inputs(device, B=B, K=K, seed=seed)
    rng = np.random.default_rng(seed + 10)
    prec0 = np.exp(6.0 + 2.0 * rng.standard_normal(tuple(y0.shape[:2]) + (4,)))
    y0 = torch.cat([y0, torch.as_tensor(prec0, dtype=torch.float32, device=device)], dim=-1)
    wmat = torch.as_tensor(rng.uniform(-0.68, 0.68, fused_ode.WMAT_SHAPE), dtype=torch.float32,
                           device=device)
    packed, y0_cols = fused_ode._pack(c, y0, "dr_prec")
    return c, y0, wmat, packed, y0_cols, times


@pytest.mark.parametrize("method", ["midpoint", "modeuler", "rk4"])
def test_dr_prec_fwd_kernel_matches_plain(cuda, method):
    """Each state group to its own tolerance, as chip_smoke.py phase 3."""
    import chip_smoke

    _, _, wmat, packed, y0_cols, times = _prec_operands(cuda)
    before = fused_ode.dr_constant_precisions_simulate.launches
    got = fused_ode._integrate_prec_cuda(wmat, packed, y0_cols, times, method)
    torch.cuda.synchronize()
    assert fused_ode.dr_constant_precisions_simulate.launches == before + 1
    ref = fused_ode._integrate_prec_plain(wmat, packed, y0_cols, times, method)
    assert got.shape == ref.shape == (86, 12, 5 * 37) and torch.isfinite(ref).all()
    torch.testing.assert_close(got[:, :8], ref[:, :8], rtol=chip_smoke.KERNEL_RTOL,
                               atol=chip_smoke.KERNEL_ATOL)
    torch.testing.assert_close(got[:, 8:], ref[:, 8:], rtol=chip_smoke.PREC_RTOL,
                               atol=chip_smoke.PREC_ATOL)


@pytest.mark.parametrize("method", ["midpoint", "modeuler", "rk4"])
@pytest.mark.parametrize("B, K", [(5, 37), (5, 4), (8, 32)])
def test_dr_prec_bwd_kernel_matches_plain(cuda, B, K, method):
    """dc and dy0 per constant and state row, dW per row of the weight
    matrix, each against the plain sweep in float64; and the weight
    cotangent is the same bit for bit from run to run.  At R = 185 (five
    full 32-row blocks and a ragged one), below one block (20) and at eight
    full blocks (256)."""
    _, _, wmat, packed, y0_cols, times = _prec_operands(cuda, B=B, K=K)
    traj = fused_ode._integrate_prec_cuda(wmat, packed, y0_cols, times, method)
    g = torch.as_tensor(
        np.random.default_rng(1).standard_normal(tuple(traj.shape)).astype(np.float32), device=cuda
    )
    before = fused_ode.dr_prec_bwd.launches
    dw, dc, dy0 = fused_ode.dr_prec_bwd(wmat, packed, times, traj, g, method)
    torch.cuda.synchronize()
    assert fused_ode.dr_prec_bwd.launches == before + 1
    ref_dw, ref_dc, ref_dy0 = fused_ode._integrate_prec_plain_bwd(
        wmat.double(), packed.double(), times.double(), traj.double(), g.double(), method
    )
    assert dw.shape == fused_ode.WMAT_SHAPE and dc.shape == (23, B * K)
    assert dy0.shape == (12, B * K)
    _assert_cotangents_close(torch.cat([dc, dy0]), torch.cat([ref_dc, ref_dy0]))
    _assert_cotangents_close(dw, ref_dw)
    assert torch.equal(dw, fused_ode.dr_prec_bwd(wmat, packed, times, traj, g, method)[0])


def test_dr_prec_autograd_function_matches_float64_autograd(cuda):
    """The autograd Function on the card (dr_prec_fwd forward, dr_prec_bwd
    backward) against torch.autograd through the plain version in float64
    on the CPU: the constants, y0 and the precision nets' four leaves."""
    c, y0, wmat, _, _, times = _prec_operands(cuda)
    pp = {"prod": {"w": wmat[:4, 1:].t().contiguous(), "b": wmat[:4, 0].contiguous()},
          "degr": {"w": wmat[4:, 1:].t().contiguous(), "b": wmat[4:, 0].contiguous()}}
    w = np.random.default_rng(2).standard_normal((86, 5, 37, 12))

    def run(leaves, pp_leaves, y0_leaf, t, weights, sim):
        sol = sim(leaves, pp_leaves, y0_leaf, t, "midpoint")
        (sol * weights).sum().backward()

    leaves = {k: v.clone().requires_grad_(True) for k, v in c.items()}
    pp_leaves = {n: {k: v.clone().requires_grad_(True) for k, v in d.items()}
                 for n, d in pp.items()}
    y0_leaf = y0.clone().requires_grad_(True)
    fwd0, bwd0 = fused_ode.dr_constant_precisions_simulate.launches, fused_ode.dr_prec_bwd.launches
    run(leaves, pp_leaves, y0_leaf, times, torch.as_tensor(w, dtype=torch.float32, device=cuda),
        fused_ode.dr_constant_precisions_simulate)
    torch.cuda.synchronize()
    assert fused_ode.dr_constant_precisions_simulate.launches == fwd0 + 1
    assert fused_ode.dr_prec_bwd.launches == bwd0 + 1

    ref_leaves = {k: v.detach().cpu().double().requires_grad_(True) for k, v in c.items()}
    ref_pp = {n: {k: v.detach().cpu().double().requires_grad_(True) for k, v in d.items()}
              for n, d in pp.items()}
    ref_y0 = y0.detach().cpu().double().requires_grad_(True)
    run(ref_leaves, ref_pp, ref_y0, times.cpu().double(), torch.as_tensor(w),
        fused_ode.dr_constant_precisions_simulate_plain)
    got_dc = torch.stack([leaves[k].grad.reshape(-1) for k in fused_ode.DR_CONST_NAMES])
    ref_dc = torch.stack([ref_leaves[k].grad.reshape(-1) for k in fused_ode.DR_CONST_NAMES])
    _assert_cotangents_close(got_dc, ref_dc)
    _assert_cotangents_close(y0_leaf.grad.reshape(-1, 12).t(), ref_y0.grad.reshape(-1, 12).t())

    def dw(p):  # the leaves' gradients as the rows of the [8, 10] weight matrix
        return torch.cat([torch.cat([p[n]["b"].grad[:, None], p[n]["w"].grad.t()], dim=1)
                          for n in ("prod", "degr")])

    _assert_cotangents_close(dw(pp_leaves), dw(ref_pp))


def test_dr_prec_kernels_refuse_wrong_operands(cuda):
    """The wrappers raise on an operand of the wrong shape, type or device
    before anything is launched."""
    _, _, wmat, packed, y0_cols, times = _prec_operands(cuda)
    before = fused_ode.dr_constant_precisions_simulate.launches
    with pytest.raises(ValueError, match="weights has shape"):
        fused_ode._integrate_prec_cuda(wmat[:, :9].contiguous(), packed, y0_cols, times,
                                       "midpoint")
    with pytest.raises(ValueError, match="y0 has shape"):
        fused_ode._integrate_prec_cuda(wmat, packed, y0_cols[:8].contiguous(), times, "midpoint")
    with pytest.raises(TypeError, match="float32"):
        fused_ode._integrate_prec_cuda(wmat.double(), packed, y0_cols, times, "midpoint")
    with pytest.raises(ValueError, match="must be on a CUDA device"):
        fused_ode._integrate_prec_cuda(wmat.cpu(), packed, y0_cols, times, "midpoint")
    traj = fused_ode._integrate_prec_cuda(wmat, packed, y0_cols, times, "midpoint")
    with pytest.raises(ValueError, match="cotangent has shape"):
        fused_ode.dr_prec_bwd(wmat, packed, times, traj, traj[:, :8].contiguous(), "midpoint")
    assert fused_ode.dr_constant_precisions_simulate.launches == before + 1


def _train_on_card(device, tmp_path, experiment, extra):
    import os

    from vihds_tpu_torch import run_xval
    from vihds_tpu_torch.config import Config, Trainer

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = run_xval.create_parser(True).parse_args(
        [os.path.join(repo, "specs", "dr_constant_one.yaml"), "--experiment", experiment,
         "--test_epoch", "2", "--train_samples", "8", "--test_samples", "8", "--seed", "0"] + extra
    )
    settings = Config(args)
    settings.params.solver = "pallas_midpoint"
    settings.trainer = Trainer(args, log_dir=str(tmp_path / experiment))
    os.makedirs(settings.trainer.tb_log_dir)
    return run_xval.run_on_split(args, settings, device=device)[2]


def test_resume_on_the_card_follows_the_uninterrupted_run(cuda, tmp_path):
    """Checkpoint and resume through the kernel route on the card: Adam's
    state, the CUDA generator's state and the params come back, and the
    resumed run ends at the uninterrupted run's params (within float32
    rounding: cuDNN's convolution backward may sum in another order from
    run to run)."""
    from vihds_tpu_torch.training import param_leaves

    whole = _train_on_card(cuda, tmp_path, "whole", ["--epochs", "2"])
    first = _train_on_card(cuda, tmp_path, "first", ["--epochs", "1", "--checkpoint_epoch", "1"])
    bwd0 = fused_ode.dr_bwd.launches
    resumed = _train_on_card(cuda, tmp_path, "resumed",
                             ["--epochs", "2", "--resume_from", first.ckpt_dir])
    assert fused_ode.dr_bwd.launches - bwd0 == resumed.steps_per_epoch
    for a, b in zip(param_leaves(whole.final_params), param_leaves(resumed.final_params)):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


# ----------------------------------------------------- the relay / degrader kinds
NEW_KINDS = ["relay", "relay_prec", "degrader", "degrader_prec"]


def _kind_operands(device, kind, K=5):
    """The kind's operands from its spec's model at K samples (chip_smoke's
    ``kind_inputs``: theta from the prior, the model's seeded precision
    nets)."""
    import chip_smoke

    return chip_smoke.kind_inputs(device, kind, K, 0)


@pytest.mark.parametrize("method", ["midpoint", "modeuler", "rk4"])
@pytest.mark.parametrize("kind", ["dr"] + NEW_KINDS + ["dr_prec"])
@pytest.mark.parametrize("R", [180, 20, 256])
def test_kind_fwd_kernel_matches_plain(cuda, R, kind, method):
    """Each state group to its own tolerance, as chip_smoke.py phase 3, at R
    = 180 (K = 5; a ragged last 32-row block), below one block (R = 20) and
    at R = 256 (whole 32-row blocks, the plain and the _prec kinds' alike);
    every kind's forward also gives the same trajectory bit for bit from run
    to run."""
    import chip_smoke

    k = fused_ode.KINDS[kind]
    _, _, _, wmat, packed, y0_cols, times = _kind_operands(cuda, kind, K=-(-max(R, 180) // 36))
    packed, y0_cols = packed[:, :R].contiguous(), y0_cols[:, :R].contiguous()
    counter = fused_ode.COUNTERS[k.fwd]
    before = counter.launches
    got = fused_ode.kind_fwd(kind, wmat, packed, y0_cols, times, method)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = fused_ode._plain_fwd(kind, wmat, packed, y0_cols, times, method)
    assert got.shape == ref.shape == (times.shape[0], k.n_states, R)
    assert torch.isfinite(ref).all()
    rel, ok = chip_smoke.states_ok(got.movedim(1, -1), ref.movedim(1, -1), kind)
    assert ok, rel
    assert torch.equal(got, fused_ode.kind_fwd(kind, wmat, packed, y0_cols, times, method))


@pytest.mark.parametrize("method", ["midpoint", "modeuler", "rk4"])
@pytest.mark.parametrize("kind", NEW_KINDS)
@pytest.mark.parametrize("R", [180, 20, 256])
def test_kind_bwd_kernel_matches_plain(cuda, R, kind, method):
    """dc and dy0 per constant and state row, dW per row of the weight
    matrix, each against the plain sweep in float64; a _prec kind's weight
    cotangent is the same bit for bit from run to run.  At R = 180 (K = 5:
    five full 32-row blocks and a ragged one) and at eight full blocks (R =
    256).  Below one block (R = 20: the first rows of the R = 180 operands,
    launched on their own) the checks are exact: dc and dy0 equal those rows
    of the R = 180 launch, which is held to float64 as above, and dW equals
    that of one full block whose rows from R on have a zero cotangent (such
    rows add exact zeros, as rows past the edge must).  With 20 samples the
    float64 rule's 99th percentile is a row's largest error, which the plain
    float32 sweep itself misses on the K = 1 draw of relay_prec's rk4
    operands."""
    k = fused_ode.KINDS[kind]
    n = max(R, 180)
    _, _, _, wmat, packed, y0_cols, times = _kind_operands(cuda, kind, K=-(-n // 36))
    packed, y0_cols = packed[:, :n].contiguous(), y0_cols[:, :n].contiguous()
    traj = fused_ode.kind_fwd(kind, wmat, packed, y0_cols, times, method)
    g = torch.as_tensor(
        np.random.default_rng(1).standard_normal(tuple(traj.shape)).astype(np.float32), device=cuda
    )

    def rows(x, m):  # the first m sample rows of a [..., R] operand
        return x[..., :m].contiguous()

    counter = fused_ode.COUNTERS[k.bwd]
    before = counter.launches
    dw, dc, dy0 = fused_ode.kind_bwd(kind, wmat, rows(packed, R), times, rows(traj, R),
                                     rows(g, R), method)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert dc.shape == (len(k.names), R) and dy0.shape == (k.n_states, R)
    if R < n:
        sub = dw, dc, dy0
        dw, dc, dy0 = fused_ode.kind_bwd(kind, wmat, packed, times, traj, g, method)
        assert torch.equal(sub[1], dc[:, :R]) and torch.equal(sub[2], dy0[:, :R])
        if k.prec:
            g_block = rows(g, 32)
            g_block[..., R:] = 0.0
            block = fused_ode.kind_bwd(kind, wmat, rows(packed, 32), times, rows(traj, 32), g_block,
                                       method)
            assert torch.equal(sub[0], block[0])
    ref_dw, ref_dc, ref_dy0 = fused_ode._plain_bwd(
        kind, wmat.double() if k.prec else None, packed.double(), times.double(), traj.double(),
        g.double(), method)
    _assert_cotangents_close(torch.cat([dc, dy0]), torch.cat([ref_dc, ref_dy0]))
    if k.prec:
        assert dw.shape == k.wmat_shape
        _assert_cotangents_close(dw, ref_dw)
        assert torch.equal(dw, fused_ode.kind_bwd(kind, wmat, packed, times, traj, g, method)[0])
    else:
        assert dw is None


def _mostly_zero(g, seed=3):
    """A training step's kind of trajectory cotangent: whole sample rows
    exactly zero (about four in five, and row 0 always), and in the others
    zero outside the observed species 0..3.  Returns (g, the zero rows'
    mask)."""
    R = g.shape[-1]
    zero = np.random.default_rng(seed).random(R) < 0.8
    zero[0] = True
    g = g.clone()
    g[:, 4:] = 0.0
    g[..., torch.as_tensor(zero, device=g.device)] = 0.0
    return g, torch.as_tensor(zero, device=g.device)


@pytest.mark.parametrize("method", ["midpoint", "modeuler", "rk4"])
@pytest.mark.parametrize("kind", ["dr"] + NEW_KINDS + ["dr_prec"])
@pytest.mark.parametrize("R", [180, 20, 256])
def test_bwd_kernel_on_a_mostly_zero_cotangent(cuda, R, kind, method):
    """Each backward kernel on a cotangent that is mostly exact zeros, as a
    training step's is (the kernels divide a zero numerator by skipping the
    division, dr_common.cuh's div0): dc, dy0 and dW held to the plain sweep
    in float64 as on a dense cotangent (at R = 20, below one block, exactly:
    those rows of the R = 180 launch, and for dW a 32-row block whose last
    rows carry a zero cotangent, as test_kind_bwd_kernel_matches_plain
    holds them); on the zero rows dc and dy0 equal the plain float32
    sweep's bit for bit, signed zeros included; two runs give the same
    outputs bit for bit."""
    k = fused_ode.KINDS[kind]
    n = max(R, 180)
    _, _, _, wmat, packed, y0_cols, times = _kind_operands(cuda, kind, K=-(-n // 36))
    packed, y0_cols = packed[:, :n].contiguous(), y0_cols[:, :n].contiguous()
    traj = fused_ode.kind_fwd(kind, wmat, packed, y0_cols, times, method)
    g, zero = _mostly_zero(torch.as_tensor(
        np.random.default_rng(1).standard_normal(tuple(traj.shape)).astype(np.float32),
        device=cuda))

    def rows(x, m):  # the first m sample rows of a [..., R] operand
        return x[..., :m].contiguous()

    counter = fused_ode.COUNTERS[k.bwd]
    before = counter.launches
    got = fused_ode.kind_bwd(kind, wmat, rows(packed, R), times, rows(traj, R), rows(g, R), method)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    again = fused_ode.kind_bwd(kind, wmat, rows(packed, R), times, rows(traj, R), rows(g, R),
                               method)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    dw, dc, dy0 = got
    plain = fused_ode._plain_bwd(kind, wmat, rows(packed, R), times, rows(traj, R), rows(g, R),
                                 method)
    for a, b in ((dc, plain[1]), (dy0, plain[2])):
        a, b = a[:, zero[:R]], b[:, zero[:R]]
        assert torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b))
    if R < n:
        dw, dc, dy0 = fused_ode.kind_bwd(kind, wmat, packed, times, traj, g, method)
        assert torch.equal(got[1], dc[:, :R]) and torch.equal(got[2], dy0[:, :R])
        if k.prec:
            g_block = rows(g, 32)
            g_block[..., R:] = 0.0
            block = fused_ode.kind_bwd(kind, wmat, rows(packed, 32), times, rows(traj, 32),
                                       g_block, method)
            assert torch.equal(got[0], block[0])
    ref_dw, ref_dc, ref_dy0 = fused_ode._plain_bwd(
        kind, wmat.double() if k.prec else None, packed.double(), times.double(), traj.double(),
        g.double(), method)
    _assert_cotangents_close(torch.cat([dc, dy0]), torch.cat([ref_dc, ref_dy0]))
    if k.prec:
        _assert_cotangents_close(dw, ref_dw)


@pytest.mark.parametrize("kind", NEW_KINDS)
def test_kind_autograd_function_matches_float64_autograd(cuda, kind):
    """The kind's wrapper on the card (forward and backward kernels,
    float32) against torch.autograd through its plain version in float64 on
    the CPU: the constants, y0 and, for a _prec kind, the precision nets'
    four leaves."""
    k = fused_ode.KINDS[kind]
    c, pp, y0, _, _, _, times = _kind_operands(cuda, kind)
    w = np.random.default_rng(2).standard_normal((times.shape[0],) + tuple(y0.shape))

    def leaves(dev, dtype):
        cl = {n: c[n].detach().to(dev, dtype).broadcast_to(y0.shape[:2]).clone()
              .requires_grad_(True) for n in k.names}
        pl = ({n: {l: v.detach().to(dev, dtype).clone().requires_grad_(True)
                   for l, v in d.items()} for n, d in pp.items()} if k.prec else None)
        return cl, pl, y0.detach().to(dev, dtype).clone().requires_grad_(True)

    got = leaves(cuda, torch.float32)
    ref = leaves("cpu", torch.float64)
    counts = [fused_ode.COUNTERS[n].launches for n in (k.fwd, k.bwd)]
    for (cl, pl, yl), sim, dev, dtype in ((got, fused_ode.simulate_kind, cuda, torch.float32),
                                          (ref, fused_ode._simulate_plain, "cpu", torch.float64)):
        if sim is fused_ode.simulate_kind:
            sol = sim(kind, cl, yl, times.to(dev, dtype), "midpoint", pl)
        else:
            sol = sim(kind, cl, pl, yl, times.to(dev, dtype), "midpoint")
        (sol * torch.as_tensor(w, dtype=dtype, device=dev)).sum().backward()
    torch.cuda.synchronize()
    assert [fused_ode.COUNTERS[n].launches for n in (k.fwd, k.bwd)] == [c + 1 for c in counts]
    S = k.n_states
    _assert_cotangents_close(torch.stack([got[0][n].grad.reshape(-1) for n in k.names]),
                             torch.stack([ref[0][n].grad.reshape(-1) for n in k.names]))
    _assert_cotangents_close(got[2].grad.reshape(-1, S).t(), ref[2].grad.reshape(-1, S).t())
    if k.prec:
        def dw(p):  # the leaves' gradients as the rows of the weight matrix
            return torch.cat([torch.cat([p[n]["b"].grad[:, None], p[n]["w"].grad.t()], dim=1)
                              for n in ("prod", "degr")])

        _assert_cotangents_close(dw(got[1]), dw(ref[1]))


# ------------------------------------------------------------- the black-box kernels
def _bb_operands(device, K=5, seed=0):
    """dr_blackbox_icml's kernel operands at K samples (chip_smoke's
    ``blackbox_inputs``: theta from the prior, the model's seeded nets)."""
    import chip_smoke

    return chip_smoke.blackbox_inputs(device, K, seed)


@pytest.mark.parametrize("method", ["midpoint", "modeuler", "rk4"])
@pytest.mark.parametrize("R", [180, 20, 256])
def test_blackbox_fwd_kernel_matches_plain(cuda, R, method):
    """Each state group (observed, latent, precisions) to the species'
    tolerance, as chip_smoke.py phase 3, and the same trajectory bit for bit
    from run to run.  At R = 180 (B = 36 x K = 5: five full 32-row blocks and
    a ragged one), below one block (20 x 1) and at eight full blocks (32 x
    8)."""
    import chip_smoke
    from vihds_tpu_torch.ops import fused_blackbox as fb

    K = -(-R // 36)
    params, consts, y0, _, _, _, times, _ = _bb_operands(cuda, K=K)
    consts, y0 = consts[:R // K], y0[:R // K]
    before = fb.blackbox_simulate.launches
    got = fb.blackbox_simulate(params, consts, y0, times, fb.KERNEL_N_STATES, method)
    torch.cuda.synchronize()
    assert fb.blackbox_simulate.launches == before + 1
    ref = fb.blackbox_simulate_plain(params, consts, y0, times, fb.KERNEL_N_STATES, method)
    assert got.shape == ref.shape == (times.shape[0], R // K, K, fb.KERNEL_N_STATES + fb.N_PREC)
    assert torch.isfinite(ref).all()
    rel, ok = chip_smoke.bb_states_ok(got, ref)
    assert ok, rel
    again = fb.blackbox_simulate(params, consts, y0, times, fb.KERNEL_N_STATES, method)
    assert torch.equal(got, again)


def _assert_blackbox_cotangents_close(got, ref, shapes):
    """The black-box backward's outputs (dW packed, dc, dy0) against a
    float64 sweep ``ref`` by chip_smoke.py's rule for it: each constant's
    and state's row and each weight leaf within the limits of
    ``_assert_cotangents_close``."""
    import chip_smoke

    def cpu(x):
        return x.cpu() if torch.is_tensor(x) else [t.cpu() for t in x]

    norm, rel, ok = chip_smoke.bb_cotangent_readings(*cpu(got), tuple(cpu(x) for x in ref),
                                                     shapes)
    assert ok, (float(norm.max()), float(rel.max()))


@pytest.mark.parametrize("method", ["midpoint", "modeuler", "rk4"])
@pytest.mark.parametrize("R", [180, 20, 256])
def test_blackbox_bwd_kernel_matches_plain(cuda, R, method):
    """dc and dy0 per constant and state row and each weight leaf against
    the plain sweep in float64; dW the same bit for bit from run to run.  At
    R = 180 (K = 5: five full 32-row blocks and a masked one), below one
    block, and at eight full blocks."""
    import chip_smoke
    from vihds_tpu_torch.ops import fused_blackbox as fb

    NS = fb.KERNEL_N_STATES
    _, _, _, wflat, packed, y0_cols, times, shapes = _bb_operands(cuda, K=-(-R // 36))
    packed, y0_cols = packed[:, :R].contiguous(), y0_cols[:, :R].contiguous()
    traj = fb.blackbox_fwd(wflat, packed, y0_cols, times, shapes, NS, method)
    g = torch.as_tensor(
        np.random.default_rng(1).standard_normal(tuple(traj.shape)).astype(np.float32), device=cuda
    )
    before = fb.blackbox_bwd.launches
    dw, dc, dy0 = fb.blackbox_bwd(wflat, packed, times, traj, g, shapes, NS, method)
    torch.cuda.synchronize()
    assert fb.blackbox_bwd.launches == before + 1
    # the float64 sweep on the plain float32 sweep's relu masks, as phase 3
    ref = chip_smoke.bb_references(fb._split(wflat, shapes), packed, times, traj, g, NS,
                                   method)[1]
    assert dc.shape == (fb.KERNEL_N_CONST, R) and dy0.shape == (NS + fb.N_PREC, R)
    assert dw.shape == (fb.KERNEL_N_W,)
    _assert_blackbox_cotangents_close((dw, dc, dy0), ref, shapes)
    assert torch.equal(dw, fb.blackbox_bwd(wflat, packed, times, traj, g, shapes, NS, method)[0])


def test_blackbox_autograd_function_matches_float64_autograd(cuda):
    """``blackbox_simulate`` on the card (both kernels, float32) against
    torch.autograd through its plain version in float64 on the CPU: the 12
    weight leaves, the constants and y0."""
    from vihds_tpu_torch.ops import fused_blackbox as fb

    params, consts, y0, _, _, _, times = _bb_operands(cuda)[:7]
    w = np.random.default_rng(2).standard_normal((times.shape[0],) + tuple(y0.shape))

    def leaves(dev, dtype):
        nets = {n: {layer: {k: v.detach().to(dev, dtype).clone().requires_grad_(True)
                            for k, v in d.items()} for layer, d in params[n].items()}
                for n in ("states", "precisions")}
        return (nets, consts.detach().to(dev, dtype).clone().requires_grad_(True),
                y0.detach().to(dev, dtype).clone().requires_grad_(True))

    got, ref = leaves(cuda, torch.float32), leaves("cpu", torch.float64)
    counts = (fb.blackbox_simulate.launches, fb.blackbox_bwd.launches)
    for (nets, c, y), sim, dev, dtype in ((got, fb.blackbox_simulate, cuda, torch.float32),
                                          (ref, fb.blackbox_simulate_plain, "cpu", torch.float64)):
        sol = sim(nets, c, y, times.to(dev, dtype), fb.KERNEL_N_STATES, "midpoint")
        (sol * torch.as_tensor(w, dtype=dtype, device=dev)).sum().backward()
    torch.cuda.synchronize()
    assert (fb.blackbox_simulate.launches, fb.blackbox_bwd.launches) == (counts[0] + 1,
                                                                         counts[1] + 1)
    NC, S = fb.KERNEL_N_CONST, fb.KERNEL_N_STATES + fb.N_PREC

    def outs(x):
        dw = torch.cat([x[0][a][b][c].grad.reshape(-1) for a, b, c in fb.WEIGHT_LEAVES])
        return dw, x[1].grad.reshape(-1, NC).t(), x[2].grad.reshape(-1, S).t()

    rw, rc, ry = outs(ref)
    shapes = fb.KERNEL_LEAF_SHAPES
    _assert_blackbox_cotangents_close(outs(got), (fb._split(rw, shapes), rc, ry), shapes)
