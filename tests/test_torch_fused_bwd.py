"""The backward of the port's fused ``dr`` integrator on the CPU.

``_dr_rhs_vjp_cols`` and ``_integrate_plain_bwd`` are the plain versions of
csrc/dr_bwd.cu (line for line its arithmetic; the CUDA kernel itself is
checked against them on the card by tests/test_torch_cuda.py and
chip_smoke.py).  Here they are held against torch.autograd through the plain
forward (float64, rtol 1e-9: the same function, summed in another order) and
against ``jax.grad`` of the JAX package's Pallas kernel in interpret mode,
which runs ``_make_bwd_kernel`` (float32, rtol 1e-3 atol 1e-5, the tolerance
tests/test_pallas.py holds that kernel's gradients to against the scan).
Inputs: dr_constant_one, B=3 series x K=4 samples, theta from the JAX
encoder and numpy draws, clipped as the decoder sees it."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_args, spec
from vihds_tpu.config import Config
from vihds_tpu.data.datasets import build_datasets
from vihds_tpu.models.dr_constant import _dr_constants as j_dr_constants
from vihds_tpu.ops import pallas_ode
from vihds_tpu.prob import ParamProgram, parse_parameters
from vihds_tpu.training import batch_arrays
from vihds_tpu.vae import VAE
from vihds_tpu_torch.ops import fused_ode

METHODS = ["midpoint", "modeuler", "rk4"]
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "vihds_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def setup():
    args = make_args(spec("dr_constant_one.yaml"))
    settings = Config(args)
    data = build_datasets(args, settings)
    program = ParamProgram(parse_parameters(settings.params))
    model = VAE(settings, data, program)
    params = model.init_params(jax.random.PRNGKey(0))
    batch = batch_arrays(data.train.dataset.select(np.arange(3)))
    q = model.encoder(params["enc"], batch)
    u = np.random.default_rng(1).standard_normal((3, 4, program.n_theta)).astype(np.float32)
    th = program.theta_dict(program.clip(program.sample(q, jnp.asarray(u)), stddevs=4))
    c = j_dr_constants(th, batch.inputs, 1)
    y0 = jnp.broadcast_to(
        model.ode_model.initialize_state(params["dec"], th, batch.inputs, 3, 4), (3, 4, 8)
    )
    T = batch.times.shape[0]
    return dict(
        c={k: np.array(jnp.broadcast_to(v, (3, 4))) for k, v in c.items()},
        y0=np.array(y0),
        times=np.array(batch.times),
        w=np.random.default_rng(2).standard_normal((T, 3, 4, 8)).astype(np.float32),
    )


def _packed(setup, dtype=torch.float64):
    c = {k: torch.as_tensor(v, dtype=dtype) for k, v in setup["c"].items()}
    packed, y0 = fused_ode._pack(c, torch.as_tensor(setup["y0"], dtype=dtype))
    return packed, y0, torch.as_tensor(setup["times"], dtype=dtype)


def test_rhs_vjp_matches_autograd(setup):
    """The hand-written pullback of one right-hand side evaluation, at every
    state of a trajectory, against torch.autograd of ``_dr_rhs_cols``."""
    packed, y0, times = _packed(setup)
    traj = fused_ode._integrate_plain(packed, y0, times, "midpoint")
    rng = np.random.default_rng(3)
    for i in (0, 17, 60, traj.shape[0] - 1):
        w = torch.as_tensor(rng.standard_normal(tuple(y0.shape)))
        pk = packed.clone().requires_grad_(True)
        y = traj[i].clone().requires_grad_(True)
        f = fused_ode._dr_rhs_cols(dict(zip(fused_ode.DR_CONST_NAMES, pk)), times[i], y)
        ref_dc, ref_dy = torch.autograd.grad((f * w).sum(), (pk, y))
        dc = {n: torch.zeros_like(packed[0]) for n in fused_ode.DR_CONST_NAMES}
        dy = fused_ode._dr_rhs_vjp_cols(dict(zip(fused_ode.DR_CONST_NAMES, packed)), times[i],
                                        traj[i], w, dc)
        got_dc = torch.stack([dc[n] for n in fused_ode.DR_CONST_NAMES])
        torch.testing.assert_close(dy, ref_dy, rtol=1e-9, atol=1e-12)
        torch.testing.assert_close(got_dc, ref_dc, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("method", METHODS)
def test_plain_bwd_matches_autograd(setup, method):
    packed, y0, times = _packed(setup)
    pk = packed.clone().requires_grad_(True)
    yy = y0.clone().requires_grad_(True)
    traj = fused_ode._integrate_plain(pk, yy, times, method)
    g = torch.as_tensor(setup["w"], dtype=torch.float64).permute(0, 3, 1, 2).reshape(traj.shape)
    ref_dc, ref_dy0 = torch.autograd.grad((traj * g).sum(), (pk, yy))
    dc, dy0 = fused_ode._integrate_plain_bwd(packed, times, traj.detach(), g, method)
    torch.testing.assert_close(dc, ref_dc, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(dy0, ref_dy0, rtol=1e-9, atol=1e-9)


# each method on the dense cotangent, then on a mostly zero one, as a training
# step's is: 8 of the 12 sample rows exactly zero, the others zero outside the
# observed species 0..3
COTANGENTS = [pytest.param(m, False, id=m) for m in METHODS] + [
    pytest.param(m, True, id=m + "-mostly-zero") for m in METHODS]
ZERO_ROWS = np.array([[True, False, True, True], [True, True, False, True],
                      [False, True, True, False]])


@pytest.mark.parametrize("method, mostly_zero", COTANGENTS)
def test_plain_bwd_matches_pallas_bwd_kernel(setup, method, mostly_zero):
    """jax.grad through the Pallas kernel (interpret mode: its custom VJP is
    ``_make_bwd_kernel``) against the port's differentiable wrapper on CPU
    tensors, whose backward is ``_integrate_plain_bwd``; float32 both.  On a
    mostly zero cotangent the rows whose cotangent is zero get exact zeros
    from both."""
    times = jnp.asarray(setup["times"])
    w_np = setup["w"].copy()
    if mostly_zero:
        w_np[..., 4:] = 0.0
        w_np[:, ZERO_ROWS] = 0.0
    w = jnp.asarray(w_np)

    def j_loss(c, y0):
        sol = pallas_ode.dr_constant_simulate(c, y0, times, method=method, block_rows=8,
                                              interpret=True)
        return jnp.sum(sol * w)

    jc = {k: jnp.asarray(v) for k, v in setup["c"].items()}
    j_dc, j_dy0 = jax.grad(j_loss, argnums=(0, 1))(jc, jnp.asarray(setup["y0"]))

    tc = {k: torch.as_tensor(v).requires_grad_(True) for k, v in setup["c"].items()}
    ty0 = torch.as_tensor(setup["y0"]).requires_grad_(True)
    fwd0, bwd0 = fused_ode.dr_constant_simulate.launches, fused_ode.dr_bwd.launches
    sol = fused_ode.dr_constant_simulate(tc, ty0, torch.as_tensor(setup["times"]), method)
    (sol * torch.as_tensor(w_np)).sum().backward()
    # CPU tensors: the plain versions, no kernel launch
    assert (fused_ode.dr_constant_simulate.launches, fused_ode.dr_bwd.launches) == (fwd0, bwd0)
    np.testing.assert_allclose(ty0.grad.numpy(), np.asarray(j_dy0), rtol=1e-3, atol=1e-5)
    grads = [(ty0.grad.numpy(), np.asarray(j_dy0))]
    for k in fused_ode.DR_CONST_NAMES:
        got, ref = tc[k].grad.numpy(), np.asarray(j_dc[k])
        assert np.isfinite(ref).all(), k
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5, err_msg=k)
        grads.append((got, ref))
    if mostly_zero:
        for got, ref in grads:
            assert (got[ZERO_ROWS] == 0).all() and (ref[ZERO_ROWS] == 0).all()


def test_times_get_no_cotangent(setup):
    """As the TPU kernel returns zeros for the grid, the Function returns no
    gradient for ``times`` (it is not differentiable there)."""
    packed, y0, times = _packed(setup, torch.float32)
    times = times.clone().requires_grad_(True)
    pk = packed.clone().requires_grad_(True)
    out = fused_ode._KindIntegrate.apply("dr", None, pk, y0, times, "midpoint")
    out.sum().backward()
    assert times.grad is None and pk.grad is not None


def test_bwd_constant_order_matches_forward_source():
    """dr_bwd.cu reads the constants and the methods by the DrConst and
    Method enums of dr_common.cuh, which the forward kernel includes too: the
    same names in the same order as the wrapper."""
    for name in ("dr_fwd.cu", "dr_bwd.cu"):
        assert '#include "dr_common.cuh"' in open(os.path.join(CSRC, name)).read(), name
    src = open(os.path.join(CSRC, "dr_common.cuh")).read()
    body = re.search(r"enum DrConst \{(.*?)\};", src, re.S).group(1)
    names = [m.group(1) for m in re.finditer(r"C_(\w+)", body)]
    assert tuple(names) == fused_ode.DR_CONST_NAMES == pallas_ode.DR_CONST_NAMES
    methods = re.search(r"enum Method \{(.*?)\};", src, re.S).group(1)
    assert [m.lower() for m in re.findall(r"(\w+) = \d", methods)] == list(fused_ode.METHODS)


def test_bwd_kernel_refuses_cpu_tensors(setup):
    """The kernel's wrapper checks its operands before it loads the library:
    CPU tensors are refused, never silently computed."""
    packed, y0, times = _packed(setup, torch.float32)
    traj = fused_ode._integrate_plain(packed, y0, times, "midpoint")
    with pytest.raises(ValueError, match="must be on"):
        fused_ode.dr_bwd(packed, times, traj, torch.ones_like(traj), "midpoint")


# ------------------------------------------------------------------------- #
# The rule chip_smoke.py holds dr_bwd to on the card (cotangents_ok): each
# constant's and state's row against the plain sweep in float64.  The plain
# float32 sweep, which rounds as a float32 kernel does, must pass it; a sweep
# with one derivative 1% off must not, whichever constant or state it is.
# Operands: dr_constant_icml, B=36 series x K=20 samples, theta from the
# prior, as phase 3 draws them at K=200.
# ------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def icml_operands():
    import chip_smoke

    _, _, _, _, packed, y0, times = chip_smoke.kind_inputs("cpu", "dr", 20, 3)
    g = torch.as_tensor(np.random.default_rng(4).standard_normal((times.shape[0],) + y0.shape),
                        dtype=torch.float32)
    return packed, y0, times, g


def _sweeps(operands, method="midpoint"):
    """The plain sweep in float32 and its float64 reference (the reference
    computed first, before a test breaks the float32 one)."""
    packed, y0, times, g = operands
    traj = fused_ode._integrate_plain(packed, y0, times, method)
    ref = torch.cat(fused_ode._integrate_plain_bwd(
        packed.double(), times.double(), traj.double(), g.double(), method))
    return lambda: torch.cat(fused_ode._integrate_plain_bwd(packed, times, traj, g, method)), ref


@pytest.mark.parametrize("method", METHODS)
def test_float32_sweep_is_within_the_card_tolerance(icml_operands, method):
    import chip_smoke

    sweep, ref = _sweeps(icml_operands, method)
    got = sweep()
    norm, rel = chip_smoke.cotangent_readings(got, ref)
    assert chip_smoke.cotangents_ok(got, ref), (float(norm.max()), float(rel.max()))


@pytest.mark.parametrize("name", fused_ode.DR_CONST_NAMES)
def test_card_tolerance_catches_one_constant_one_percent_off(icml_operands, monkeypatch, name):
    import chip_smoke

    sweep, ref = _sweeps(icml_operands)
    vjp = fused_ode._dr_rhs_vjp_cols

    def one_percent_off(c, t, y, w, dc):
        before = dc[name]
        out = vjp(c, t, y, w, dc)
        dc[name] = before + 1.01 * (dc[name] - before)
        return out

    monkeypatch.setattr(fused_ode, "_dr_rhs_vjp_cols", one_percent_off)
    got = sweep()
    norm, rel = chip_smoke.cotangent_readings(got, ref)
    i = fused_ode.DR_CONST_NAMES.index(name)
    assert not chip_smoke.cotangents_ok(got, ref)
    assert norm[i] > chip_smoke.BWD_NORM_TOL and rel[i] > chip_smoke.BWD_P99_TOL


@pytest.mark.parametrize("state", range(fused_ode.N_SPECIES))
def test_card_tolerance_catches_one_state_pullback_one_percent_off(icml_operands, monkeypatch,
                                                                   state):
    import chip_smoke

    sweep, ref = _sweeps(icml_operands)
    vjp = fused_ode._dr_rhs_vjp_cols

    def one_percent_off(c, t, y, w, dc):
        out = vjp(c, t, y, w, dc)
        return torch.cat([out[:state], 1.01 * out[state:state + 1], out[state + 1:]])

    monkeypatch.setattr(fused_ode, "_dr_rhs_vjp_cols", one_percent_off)
    got = sweep()
    norm, rel = chip_smoke.cotangent_readings(got, ref)
    assert not chip_smoke.cotangents_ok(got, ref), (float(norm.max()), float(rel.max()))
