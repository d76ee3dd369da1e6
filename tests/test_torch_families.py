"""The port's relay and degrader families on the CPU: the plain versions of
the ``relay``, ``relay_prec``, ``degrader`` and ``degrader_prec`` kernels
(csrc/<kind>_fwd.cu and _bwd.cu, line for line their arithmetic), the
families' constants, the models' fused route and the kernels' source
contracts.  The CUDA kernels themselves are checked on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Inputs: the shipped relay_constant_precisions and
degrader_constant_precisions specs, B=3 series x K=4 samples on their own
grids (T=99 and T=135), theta from the JAX encoder and numpy draws, clipped
and conditioned as the decoder sees it, the JAX initial params.  The plain
kinds take the species of the precisions models' states, as the JAX
package's tests build ``Relay_Constant`` / ``Degrader_Constant`` from the
precisions specs' settings (tests/test_pallas.py).

Tolerances, as tests/test_torch_prec.py states them for dr_prec: the
forward against the Pallas kernel in interpret mode rtol 2e-5, atol 1e-7,
each state group; the constants rtol 1e-6; the hand-written pullbacks and
the plain reverse sweep against torch.autograd in float64 rtol 1e-9; the
sweep against jax.grad through the Pallas backward in interpret mode rtol
1e-3, atol 1e-5 (float32 both); and the per-row rule chip_smoke.py holds
the backward kernels to on the card."""

import functools
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_args, spec
from vihds_tpu.config import Config
from vihds_tpu.data.datasets import build_datasets
from vihds_tpu.models.degrader_constant import _degrader_constants as j_degrader_constants
from vihds_tpu.models.relay_constant import _relay_constants as j_relay_constants
from vihds_tpu.ops import pallas_ode
from vihds_tpu.prob import ParamProgram, parse_parameters
from vihds_tpu.training import batch_arrays
from vihds_tpu.vae import VAE
from vihds_tpu_torch.models.degrader_constant import Degrader_Constant
from vihds_tpu_torch.models.degrader_constant import _degrader_constants as t_degrader_constants
from vihds_tpu_torch.models.relay_constant import Relay_Constant
from vihds_tpu_torch.models.relay_constant import _relay_constants as t_relay_constants
from vihds_tpu_torch.ops import build, fused_ode

METHODS = ["midpoint", "modeuler", "rk4"]
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "vihds_tpu_torch", "csrc")
FAMILIES = {
    "relay": ("relay_constant_precisions.yaml", j_relay_constants, t_relay_constants,
              Relay_Constant, "RL", "RelayConst"),
    "degrader": ("degrader_constant_precisions.yaml", j_degrader_constants,
                 t_degrader_constants, Degrader_Constant, "DG", "DegraderConst"),
}
KINDS = ["relay", "relay_prec", "degrader", "degrader_prec"]
#: the constants each family adds to dr's
NEW_CONSTANTS = [(f, n) for f in FAMILIES
                 for n in fused_ode.KINDS[f].names if n not in fused_ode.DR_CONST_NAMES]
#: the states each family adds to dr's 8 (with the precision block, which
#: reads every species)
NEW_STATES = [(f + "_prec", s) for f in FAMILIES for s in range(8, fused_ode.KINDS[f].n_species)]
#: the weight entries past dr's 10 columns: those of the families' new species
NEW_WEIGHTS = [(f + "_prec", j, col) for f in FAMILIES for j in range(2 * fused_ode.N_PREC)
               for col in range(2 + fused_ode.N_SPECIES, 2 + fused_ode.KINDS[f].n_species)]


def _family(kind):
    return kind[: -len("_prec")] if kind.endswith("_prec") else kind


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain sweeps' per-row weight cotangents cross PyTorch's intra-op
    parallel threshold; on a CPU shared with other workers, those parallel
    elementwise ops contend for it, and one thread is as fast alone.
    Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(family):
    """The JAX model of the family's spec at B=3 x K=4: constants, the
    precision nets' params, y0 of the precisions model, the grid, theta,
    the treatments, and a trajectory cotangent."""
    spec_name, j_constants = FAMILIES[family][:2]
    args = make_args(spec(spec_name))
    settings = Config(args)
    data = build_datasets(args, settings)
    program = ParamProgram(parse_parameters(settings.params))
    model = VAE(settings, data, program)
    params = model.init_params(jax.random.PRNGKey(0))
    batch = batch_arrays(data.train.dataset.select(np.arange(3)))
    q = model.encoder(params["enc"], batch)
    u = np.random.default_rng(1).standard_normal((3, 4, program.n_theta)).astype(np.float32)
    th = program.theta_dict(program.clip(program.sample(q, jnp.asarray(u)), stddevs=4))
    th = model.ode_model.condition_theta(params["dec"], th, batch.dev_1hot)
    c = j_constants(th, batch.inputs)
    S = model.ode_model.n_species + fused_ode.N_PREC
    y0 = jnp.broadcast_to(
        model.ode_model.initialize_state(params["dec"], th, batch.inputs, 3, 4), (3, 4, S)
    )
    T = batch.times.shape[0]
    return dict(
        c={k: np.array(jnp.broadcast_to(v, (3, 4))) for k, v in c.items()},
        pp=jax.tree_util.tree_map(np.asarray, params["dec"]["precisions"]),
        y0=np.array(y0),
        times=np.array(batch.times),
        theta={k: np.array(v) for k, v in th.items()},
        inputs=np.array(batch.inputs),
        w=np.random.default_rng(2).standard_normal((T, 3, 4, S)).astype(np.float32),
    )


def _kind_setup(kind):
    """The family's setup cut to ``kind``'s states."""
    s = dict(_setup(_family(kind)))
    n = fused_ode.KINDS[kind].n_states
    s["y0"], s["w"] = s["y0"][..., :n], s["w"][..., :n]
    return s


def _torch_pp(s, dtype=torch.float32):
    return {net: {k: torch.tensor(v, dtype=dtype) for k, v in d.items()}
            for net, d in s["pp"].items()}


def _packed(kind, dtype=torch.float64):
    """(wmat or None, packed, y0 columns, times) of ``kind`` in ``dtype``."""
    s = _kind_setup(kind)
    c = {k: torch.tensor(v, dtype=dtype) for k, v in s["c"].items()}
    packed, y0 = fused_ode._pack(c, torch.tensor(s["y0"], dtype=dtype), kind)
    wmat = fused_ode._prec_wmat(_torch_pp(s, dtype)) if fused_ode.KINDS[kind].prec else None
    return wmat, packed, y0, torch.tensor(s["times"], dtype=dtype)


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_simulate_matches_pallas(kind, method):
    s = _kind_setup(kind)
    k = fused_ode.KINDS[kind]
    ref = np.asarray(pallas_ode.simulate_kind(
        kind, {n: jnp.asarray(v) for n, v in s["c"].items()}, jnp.asarray(s["y0"]),
        jnp.asarray(s["times"]), method=method,
        prec_params=jax.tree_util.tree_map(jnp.asarray, s["pp"]) if k.prec else None,
        interpret=True,
    ))
    counter = fused_ode.COUNTERS[k.fwd]
    before = counter.launches
    got = fused_ode.simulate_kind(
        kind, {n: torch.tensor(v) for n, v in s["c"].items()}, torch.tensor(s["y0"]),
        torch.tensor(s["times"]), method=method, prec_params=_torch_pp(s) if k.prec else None,
    ).numpy()
    assert counter.launches == before  # CPU: no launch
    assert got.shape == ref.shape == (len(s["times"]), 3, 4, k.n_states)
    for group, sl in (("species", slice(0, k.n_species)), ("precisions", slice(k.n_species, None))):
        np.testing.assert_allclose(got[..., sl], ref[..., sl], rtol=2e-5, atol=1e-7,
                                   err_msg=group)


@pytest.mark.parametrize("family", FAMILIES)
def test_constants_match(family):
    """The per-row constants, PBAD / rC6 / rC12 of the degrader's three
    treatments included, in the kernels' packed order."""
    _, j_constants, t_constants = FAMILIES[family][:3]
    s = _setup(family)
    ref = j_constants({k: jnp.asarray(v) for k, v in s["theta"].items()},
                      jnp.asarray(s["inputs"]))
    got = t_constants({k: torch.tensor(v) for k, v in s["theta"].items()},
                      torch.tensor(s["inputs"]))
    names = fused_ode.KINDS[family].names
    assert names == pallas_ode.KINDS[family][0]
    assert set(names) <= set(got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6, err_msg=k)


# ----------------------------------------------------------------- backward
@pytest.mark.parametrize("kind", KINDS)
def test_rhs_vjp_matches_autograd(kind):
    """The hand-written pullback of one right-hand side evaluation (the
    family's rows, the shares they add to the core's, and the precision
    block), at states along a trajectory, against torch.autograd: dy, every
    constant and dW."""
    k = fused_ode.KINDS[kind]
    wmat, packed, y0, times = _packed(kind)
    traj = fused_ode._plain_fwd(kind, wmat, packed, y0, times, "midpoint")
    rhs, vjp = fused_ode._rhs_and_vjp(kind)
    rng = np.random.default_rng(3)
    for i in (0, 17, 60, traj.shape[0] - 1):
        w = torch.as_tensor(rng.standard_normal(tuple(y0.shape)))
        pk = packed.clone().requires_grad_(True)
        y = traj[i].clone().requires_grad_(True)
        wm = wmat.clone().requires_grad_(True) if k.prec else None
        c = dict(zip(k.names, pk))
        f = rhs((c, wm) if k.prec else c, times[i], y)
        grads = torch.autograd.grad((f * w).sum(), (pk, y) + ((wm,) if k.prec else ()))
        dc = {n: torch.zeros_like(packed[0]) for n in k.names}
        if k.prec:
            dc["W"] = torch.zeros(k.wmat_shape + (packed.shape[1],), dtype=packed.dtype)
        c = dict(zip(k.names, packed))
        dy = vjp((c, wmat) if k.prec else c, times[i], traj[i], w, dc)
        torch.testing.assert_close(dy, grads[1], rtol=1e-9, atol=1e-12)
        torch.testing.assert_close(torch.stack([dc[n] for n in k.names]), grads[0], rtol=1e-9,
                                   atol=1e-12)
        if k.prec:
            torch.testing.assert_close(dc["W"].sum(-1), grads[2], rtol=1e-9, atol=1e-12)
            assert grads[2].abs().max() > 0


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_bwd_matches_autograd(kind, method):
    k = fused_ode.KINDS[kind]
    wmat, packed, y0, times = _packed(kind)
    wm = wmat.clone().requires_grad_(True) if k.prec else None
    pk = packed.clone().requires_grad_(True)
    yy = y0.clone().requires_grad_(True)
    traj = fused_ode._plain_fwd(kind, wm, pk, yy, times, method)
    g = torch.as_tensor(_kind_setup(kind)["w"], dtype=torch.float64).permute(0, 3, 1, 2).reshape(
        traj.shape)
    ref = torch.autograd.grad((traj * g).sum(), (pk, yy) + ((wm,) if k.prec else ()))
    dw, dc, dy0 = fused_ode._plain_bwd(kind, wmat, packed, times, traj.detach(), g, method)
    torch.testing.assert_close(dc, ref[0], rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(dy0, ref[1], rtol=1e-9, atol=1e-9)
    if k.prec:
        torch.testing.assert_close(dw, ref[2], rtol=1e-9, atol=1e-9)
    else:
        assert dw is None


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_bwd_matches_pallas_bwd_kernel(kind, method):
    """jax.grad through the Pallas kernel (interpret mode: its custom VJP is
    ``_make_bwd_kernel``, the _prec kinds' per-cell dW partials summed on the
    host) against the port's differentiable wrapper on CPU tensors, whose
    backward is ``_plain_bwd``: dc, dy0 and the precision nets' four leaves;
    float32 both."""
    s = _kind_setup(kind)
    k = fused_ode.KINDS[kind]
    times = jnp.asarray(s["times"])
    w = jnp.asarray(s["w"])

    def j_loss(c, pp, y0):
        sol = pallas_ode.simulate_kind(kind, c, y0, times, method=method,
                                       prec_params=pp if k.prec else None, interpret=True)
        return jnp.sum(sol * w)

    j_dc, j_dpp, j_dy0 = jax.grad(j_loss, argnums=(0, 1, 2))(
        {n: jnp.asarray(v) for n, v in s["c"].items()},
        jax.tree_util.tree_map(jnp.asarray, s["pp"]), jnp.asarray(s["y0"]))

    tc = {n: torch.tensor(v).requires_grad_(True) for n, v in s["c"].items()}
    tpp = _torch_pp(s)
    for d in tpp.values():
        for leaf in d.values():
            leaf.requires_grad_(True)
    ty0 = torch.tensor(s["y0"]).requires_grad_(True)
    counts = [fused_ode.COUNTERS[n].launches for n in (k.fwd, k.bwd)]
    sol = fused_ode.simulate_kind(kind, tc, ty0, torch.tensor(s["times"]), method,
                                  tpp if k.prec else None)
    (sol * torch.tensor(s["w"])).sum().backward()
    # CPU tensors: the plain versions, no kernel launch
    assert [fused_ode.COUNTERS[n].launches for n in (k.fwd, k.bwd)] == counts
    np.testing.assert_allclose(ty0.grad.numpy(), np.asarray(j_dy0), rtol=1e-3, atol=1e-5)
    for n in k.names:
        got, ref = tc[n].grad.numpy(), np.asarray(j_dc[n])
        assert np.isfinite(ref).all(), n
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5, err_msg=n)
    if k.prec:
        for net in ("prod", "degr"):
            for leaf in ("w", "b"):
                got, ref = tpp[net][leaf].grad.numpy(), np.asarray(j_dpp[net][leaf])
                assert np.isfinite(ref).all() and np.abs(ref).max() > 0, (net, leaf)
                np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5, err_msg=net + leaf)


# ------------------------------------------------------------------------- #
# The rule chip_smoke.py holds the backward kernels to on the card (phase
# 3): each constant's and state's row over the samples, and each row of dW
# over its columns, against the plain sweep in float64.  The plain float32
# sweep, which rounds as a float32 kernel does, must pass it; a sweep with
# one derivative 1% off must not.  Pinned here for what the families add to
# dr's (whose core, precision block and first 10 weight columns
# tests/test_torch_fused_bwd.py and tests/test_torch_prec.py pin): the new
# constants, the new states' pullbacks, the weights of the new species.
# Operands: each spec, B=36 series x K=20 samples, theta from the prior, as
# phase 3 draws them at K=200.
# ------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _card_operands(kind, method="midpoint"):
    import chip_smoke

    _, _, _, wmat, packed, y0, times = chip_smoke.kind_inputs("cpu", kind, 20, 3)
    g = torch.as_tensor(np.random.default_rng(4).standard_normal((times.shape[0],) + y0.shape),
                        dtype=torch.float32)
    traj = fused_ode._plain_fwd(kind, wmat, packed, y0, times, method)
    ref = fused_ode._plain_bwd(kind, wmat.double() if wmat is not None else None,
                               packed.double(), times.double(), traj.double(), g.double(), method)
    return wmat, packed, times, traj, g, ref


def _card_rule(kind, method="midpoint"):
    """(ok, (norm, p99) of the [dc; dy0] rows, (norm, p99) of dW's rows or
    None) of the plain float32 sweep under the card's rule."""
    import chip_smoke

    wmat, packed, times, traj, g, (rw, rc, ry) = _card_operands(kind, method)
    dw, dc, dy0 = fused_ode._plain_bwd(kind, wmat, packed, times, traj, g, method)
    rows, ref = torch.cat([dc, dy0]), torch.cat([rc, ry])
    ok = chip_smoke.cotangents_ok(rows, ref) and (dw is None or chip_smoke.cotangents_ok(dw, rw))
    return (ok, chip_smoke.cotangent_readings(rows, ref),
            None if dw is None else chip_smoke.cotangent_readings(dw, rw))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", KINDS)
def test_float32_sweep_is_within_the_card_tolerance(kind, method):
    ok, (norm, rel), w = _card_rule(kind, method)
    assert ok, (float(norm.max()), float(rel.max()), w and float(w[0].max()))


@pytest.mark.parametrize("family,name", NEW_CONSTANTS, ids=lambda v: v)
def test_card_tolerance_catches_one_new_constant_one_percent_off(monkeypatch, family, name):
    import chip_smoke

    # the reference, before the pullback is broken (the cache's key is the
    # one _card_rule uses)
    _card_operands(family, "midpoint")
    attr = "_%s_rhs_vjp_cols" % family
    vjp = getattr(fused_ode, attr)

    def one_percent_off(c, t, y, w, dc):
        before = dc[name]
        out = vjp(c, t, y, w, dc)
        dc[name] = before + 1.01 * (dc[name] - before)
        return out

    monkeypatch.setattr(fused_ode, attr, one_percent_off)
    ok, (norm, rel), _ = _card_rule(family)
    i = fused_ode.KINDS[family].names.index(name)
    assert not ok
    assert norm[i] > chip_smoke.BWD_NORM_TOL and rel[i] > chip_smoke.BWD_P99_TOL


@pytest.mark.parametrize("kind,state", NEW_STATES, ids=lambda v: str(v))
def test_card_tolerance_catches_one_new_state_pullback_one_percent_off(monkeypatch, kind, state):
    _card_operands(kind, "midpoint")
    attr = "_%s_rhs_vjp_cols" % kind
    vjp = getattr(fused_ode, attr)

    def one_percent_off(c, t, y, w, dc):
        out = vjp(c, t, y, w, dc)
        return torch.cat([out[:state], 1.01 * out[state:state + 1], out[state + 1:]])

    monkeypatch.setattr(fused_ode, attr, one_percent_off)
    ok, (norm, rel), _ = _card_rule(kind)
    assert not ok, (float(norm.max()), float(rel.max()))


@pytest.mark.parametrize("kind,row,col", NEW_WEIGHTS, ids=lambda v: str(v))
def test_card_tolerance_catches_one_new_weight_one_percent_off(monkeypatch, kind, row, col):
    _card_operands(kind, "midpoint")
    vjp = fused_ode._prec_rhs_vjp_cols
    scale = torch.ones(fused_ode.KINDS[kind].wmat_shape + (1,))
    scale[row, col] = 1.01

    def one_percent_off(wmat, t, y, w, dc):
        before = dc["W"]
        out = vjp(wmat, t, y, w, dc)
        dc["W"] = before + (dc["W"] - before) * scale
        return out

    monkeypatch.setattr(fused_ode, "_prec_rhs_vjp_cols", one_percent_off)
    ok, _, (norm, rel) = _card_rule(kind)
    assert not ok
    assert norm[row] > 1e-4 or rel[row] > 1e-3


# ------------------------------------------------------------------------- #
# The rule chip_smoke.py holds the forward kernels to on the card
# (``states_ok``: each state group to its own tolerance, C6 / C12 against
# each trajectory's largest magnitude).  The plain float32 integrator, which
# rounds as a float32 kernel does, must pass it against float64 on the
# operands phase 3 draws; a trajectory with one state 1% off must not.
# ------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _fwd_card_operands(kind, method):
    """(float32 trajectory, float64 trajectory), each [T, R, S]."""
    import chip_smoke

    _, _, _, wmat, packed, y0, times = chip_smoke.kind_inputs("cpu", kind, 20, 3)
    got = fused_ode._plain_fwd(kind, wmat, packed, y0, times, method)
    ref = fused_ode._plain_fwd(kind, None if wmat is None else wmat.double(), packed.double(),
                               y0.double(), times.double(), method)
    return got.movedim(1, -1), ref.movedim(1, -1)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", KINDS)
def test_float32_forward_is_within_the_card_tolerance(kind, method):
    import chip_smoke

    rel, ok = chip_smoke.states_ok(*_fwd_card_operands(kind, method), kind)
    assert ok, rel


def test_degrader_signals_cross_zero_beyond_an_elementwise_rule():
    """Why C6 / C12 are held to their trajectories' scale: on prior draws
    the degrader's cross zero, and there the float32 plain version itself
    is off from float64 by more than the species' element-by-element rule."""
    import chip_smoke

    got, ref = _fwd_card_operands("degrader", "midpoint")
    sig = list(chip_smoke.SIGNAL_STATES["degrader"])
    a, b = got[..., sig].double(), ref[..., sig]
    assert bool((b.amin(dim=0) < 0).any() and (b.amax(dim=0) > 0).any())
    assert not bool(((a - b).abs() <= chip_smoke.KERNEL_ATOL
                     + chip_smoke.KERNEL_RTOL * b.abs()).all())


@pytest.mark.parametrize("kind", ["relay_prec", "degrader_prec"])
def test_card_forward_tolerance_catches_each_state_one_percent_off(kind):
    import chip_smoke

    got, ref = _fwd_card_operands(kind, "midpoint")
    for s in range(fused_ode.KINDS[kind].n_states):
        off = got.clone()
        off[..., s] *= 1.01
        assert not chip_smoke.states_ok(off, ref, kind)[1], s


# ------------------------------------------------------- the model's routes
def _port_model(family, solver):
    from vihds_tpu_torch.config import Config as TConfig
    from vihds_tpu_torch.data.datasets import build_datasets as t_build
    from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
    from vihds_tpu_torch.vae import VAE as TVAE

    targs = SimpleNamespace(yaml=spec(FAMILIES[family][0]), seed=0, folds=4, split=1,
                            heldout=None)
    tset = TConfig(targs)
    tset.params.solver = solver
    tdata = t_build(targs, tset)
    tprog = TProgram(t_parse(tset.params))
    return TVAE(tset, tdata, tprog), tdata, tset


def _prior_batch(model, data, program, params):
    from vihds_tpu_torch.training import batch_tensors

    host = data.train.dataset.select(np.arange(3))
    batch = batch_tensors(host, slice(None), torch.as_tensor(host.times), "cpu")
    u = torch.as_tensor(np.random.default_rng(1).standard_normal((3, 4, program.n_theta)),
                        dtype=torch.float32)
    theta = program.clip(program.sample(program.prior_q("cpu"), u), stddevs=4)
    return batch, theta


@pytest.mark.parametrize("n_hidden", [0, 20], ids=["kernel", "generic"])
@pytest.mark.parametrize("family", FAMILIES)
def test_fused_route_takes_the_prec_kernel_where_supported(monkeypatch, family, n_hidden):
    """``solver: pallas_midpoint`` on a family's _precisions model goes
    through its ``_prec`` wrapper with the model's precision params and
    agrees with the generic midpoint solver; a configuration the kernels do
    not cover (a hidden layer) takes the generic solver alone."""
    model, data, _ = _port_model(family, "pallas_midpoint")
    ode, program = model.ode_model, model.program
    ode.precisions.n_hidden = n_hidden
    assert ode._pallas_supported() == (n_hidden == 0)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")["dec"]
    batch, theta = _prior_batch(model, data, program, params)
    th = ode.condition_theta(params, program.theta_dict(theta), batch.dev_1hot)
    name = fused_ode.KINDS[family + "_prec"].simulate
    orig = getattr(fused_ode, name)
    calls = []

    def spy(constants, prec_params, *a, **k):
        calls.append(prec_params)
        return orig(constants, prec_params, *a, **k)

    monkeypatch.setattr(fused_ode, name, spy)
    sol = ode.simulate(params, th, batch.times, batch.inputs, batch.dev_1hot, 4)
    assert sol.shape == (3, 4, ode.n_species + 4, len(batch.times)) and torch.isfinite(sol).all()
    assert len(calls) == (n_hidden == 0)
    if calls:
        assert calls[0] is params["precisions"]
        ode.solver = "midpoint"
        generic = ode.simulate(params, th, batch.times, batch.inputs, batch.dev_1hot, 4)
        torch.testing.assert_close(sol, generic, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("family", FAMILIES)
def test_plain_model_takes_the_plain_kind(monkeypatch, family):
    """``Relay_Constant`` / ``Degrader_Constant`` built from the precisions
    spec's settings (no shipped spec names them) route ``pallas_midpoint``
    to the plain kind, and its trajectory and theta gradient equal the
    generic midpoint solver's."""
    model, data, tset = _port_model(family, "pallas_midpoint")
    ode = FAMILIES[family][3](tset)
    program = model.program
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")["dec"]
    batch, theta = _prior_batch(model, data, program, params)
    name = fused_ode.KINDS[family].simulate
    orig = getattr(fused_ode, name)
    calls = []
    monkeypatch.setattr(fused_ode, name, lambda *a, **k: calls.append(1) or orig(*a, **k))
    out = {}
    for solver in ("pallas_midpoint", "midpoint"):
        ode.solver = solver
        leaf = theta.clone().requires_grad_(True)
        sol = ode.simulate(params, program.theta_dict(leaf), batch.times, batch.inputs,
                           batch.dev_1hot, 4)
        out[solver] = (sol.detach(), torch.autograd.grad(sol.sum(), leaf)[0])
    assert calls == [1]
    (a, ga), (b, gb) = out["pallas_midpoint"], out["midpoint"]
    assert a.shape == (3, 4, ode.n_species, len(batch.times)) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)
    assert ga.abs().max() > 0
    torch.testing.assert_close(ga, gb, rtol=1e-4, atol=1e-4 * float(gb.abs().max()))


def test_simulate_kind_dispatches_every_kind():
    assert set(fused_ode.KINDS) == set(pallas_ode.KINDS)
    for kind, k in fused_ode.KINDS.items():
        assert k.n_states == pallas_ode.KINDS[kind][1]
        assert k.names == pallas_ode.KINDS[kind][0]
        assert k.prec == (kind in pallas_ode.PREC_KINDS)
        assert callable(getattr(fused_ode, k.simulate))
        assert callable(getattr(fused_ode, k.simulate + "_plain"))
    with pytest.raises(ValueError, match="no fused kernel kind 'blackbox'"):
        fused_ode.simulate_kind("blackbox", {}, torch.zeros(1, 1, 1), torch.zeros(2))


# ------------------------------------------------- the kernels' source contracts
@pytest.mark.parametrize("family", FAMILIES)
def test_constant_order_matches_kernel_source(family):
    """The relay / degrader kernels read their constants by the RelayConst /
    DegraderConst enums of dr_common.cuh: the wrapper's packing order, and
    the Pallas kernel's; the family's struct there has its counts."""
    prefix, enum = FAMILIES[family][4:6]
    src = open(os.path.join(CSRC, "dr_common.cuh")).read()
    body = re.search(r"enum %s \{(.*?)\};" % enum, src, re.S).group(1)
    names = [m.group(1) for m in re.finditer(r"\b%s_(\w+)" % prefix, body)]
    k = fused_ode.KINDS[family]
    assert tuple(names) == k.names == pallas_ode.KINDS[family][0]
    struct = re.search(r"struct %s \{\s*enum : int \{ NC = (\w+), NS = (\d+) \};"
                       % family.capitalize(), src)
    assert struct.group(1) == "N_%s_CONST" % family.upper() and int(struct.group(2)) == (
        k.n_species)


@pytest.mark.parametrize("kind", list(fused_ode.KINDS))
def test_kernel_sources_instantiate_their_kind(kind):
    """Each kind's two sources are thin C entry points over dr_common.cuh's
    launchers, for the kind's family and precision block, with the operands
    the wrapper passes (the weights first, with the block; dw before dc)."""
    k = fused_ode.KINDS[kind]
    cls = _family(kind).capitalize()
    for d, first, outs in (("fwd", "consts, y0, times, out", ""),
                           ("bwd", "consts, times, traj, g", "dc, dy0")):
        src = open(os.path.join(CSRC, "%s_%s.cu" % (kind, d))).read()
        assert '#include "dr_common.cuh"' in src
        call = re.search(r"return %s_launch<(\w+), (\w+)>\((.*?)\);" % d, src, re.S)
        assert call.group(1) == cls and call.group(2) == ("true" if k.prec else "false")
        args = " ".join(call.group(3).split())
        assert args.startswith("wmat, " if k.prec else "nullptr, ")
        assert first in args and outs in args
        assert ("dw, dc" in args) == (d == "bwd" and k.prec)
        assert re.search(r'extern "C" int %s_%s_launch\(' % (kind, d), src)


@pytest.mark.parametrize("family, F", [("dr", "Dr"), ("relay", "Relay"),
                                       ("degrader", "Degrader")])
def test_plain_bwd_sources_follow_the_header(family, F):
    """Each plain kind's backward answers the block query from the shared
    template, whose rows a block sweeps (32 rows x 2 warps, lane = row) set
    its grid and lanes; chip_smoke.py prints every backward's block through
    ``fused_ode.bwd_block``."""
    common = open(os.path.join(CSRC, "dr_common.cuh")).read()
    consts = {m.group(1): m.group(2) for m in re.finditer(r"constexpr int (\w+) = ([^;]+);", common)}
    assert consts["BWD_ROWS"] == "32"
    assert consts["BWD_THREADS"] == "BWD_ROWS * 2"
    assert "const dim3 grid((unsigned)((R + BWD_ROWS - 1) / BWD_ROWS));" in common
    kernel = common[common.index("bwd_kernel(const float*"):]
    assert "const int r = blockIdx.x * BWD_ROWS + lane;" in kernel
    assert "return block_of(bwd_kernel<F, METHOD>, BWD_ROWS, BWD_THREADS, rows, threads," in common
    src = open(os.path.join(CSRC, family + "_bwd.cu")).read()
    assert re.search(r"return bwd_block<%s, false>\(method, rows, threads, smem_bytes, "
                     r"registers, blocks_per_sm\);" % F, src)
    smoke = open(os.path.join(os.path.dirname(CSRC), os.pardir, "chip_smoke.py")).read()
    assert re.search(r"print_block\(device, k\.bwd, method,\s+fused_ode\.bwd_block\(kind, method\)",
                     smoke)


@pytest.mark.parametrize("family, F", [("dr", "Dr"), ("relay", "Relay"),
                                       ("degrader", "Degrader")])
def test_plain_fwd_sources_follow_the_header(family, F):
    """Each plain kind's forward answers the block query from the shared
    template: a block of 32 rows (the header's FWD_ROWS, which set its grid
    and lanes) x 2 + the family's reporter warps, whose species split holds
    each of the family's species in exactly one warp; the query reports
    these rows and threads for every method, and chip_smoke.py prints every
    forward's block through ``fused_ode.fwd_block``."""
    common = open(os.path.join(CSRC, "dr_common.cuh")).read()
    consts = {m.group(1): m.group(2)
              for m in re.finditer(r"constexpr int (\w+) = ([^;]+);", common)}
    assert consts["FWD_ROWS"] == "32"
    assert consts["WARPS"] == "2 + REP_WARPS"
    assert consts["THREADS"] == "FWD_ROWS * WARPS"
    assert "const dim3 grid((unsigned)((R + FWD_ROWS - 1) / FWD_ROWS));" in common
    kernel = common[common.index("fwd_kernel(const float*"):]
    assert "const int r = blockIdx.x * FWD_ROWS + lane;" in kernel
    for method in ("MODEULER", "MIDPOINT", "RK4"):
        assert ("return block_of(fwd_kernel<F, %s>, FWD_ROWS, FwdSplit<F>::THREADS, rows, threads,"
                % method) in common, method
    # the family's split: the growth warp x, the regulator warp LuxR and
    # LasR, one or two reporter warps the rest
    body = re.search(r"struct %s \{(.*?)\n\};" % F, common, re.S).group(1)
    rep_warps = int(re.search(r"FWD_REPORTER_WARPS = (\d+);", body).group(1))
    ns = int(re.search(r"NS = (\d+)", body).group(1))
    assert ns == fused_ode.KINDS[family].n_species and rep_warps in (1, 2)
    assert "reporter(int i) { return i < 5 ? 1 + i : 3 + i; }" in common
    reporters = [1 + i if i < 5 else 3 + i for i in range(ns - 3)]
    assert sorted([0, 6, 7] + reporters) == list(range(ns))
    src = open(os.path.join(CSRC, family + "_fwd.cu")).read()
    assert re.search(r"return fwd_block<%s>\(method, rows, threads, smem_bytes, registers, "
                     r"blocks_per_sm\);" % F, src)
    assert re.search(r'extern "C" int %s_fwd_block\(' % family, src)
    smoke = open(os.path.join(os.path.dirname(CSRC), os.pardir, "chip_smoke.py")).read()
    assert re.search(r"\n        fwd_rows\[method\]\[\"block\"\] = print_block\("
                     r"device, k\.fwd, method,\s+fused_ode\.fwd_block\(kind, method\)", smoke)


def test_build_lists_every_kernel():
    """Every fused kind's two kernels and the black-box ODE's two."""
    from vihds_tpu_torch.ops import fused_blackbox

    assert build.SOURCES == {n: n + ".cu" for n in [
        n for k in fused_ode.KINDS.values() for n in (k.fwd, k.bwd)] + list(
        fused_blackbox.COUNTERS)}
    assert all(os.path.exists(os.path.join(CSRC, f)) for f in build.SOURCES.values())


class _Refused(Exception):
    pass


@pytest.mark.parametrize("kind", KINDS)
def test_wrappers_pass_the_kind_operand_shapes(monkeypatch, kind):
    """The operands the wrappers check before they load a library, per kind
    (what the sources' layout comments state); and a CPU tensor is refused."""
    k = fused_ode.KINDS[kind]
    wmat, packed, y0, times = _packed(kind, torch.float32)
    with pytest.raises(ValueError, match="must be on a CUDA device"):
        fused_ode.kind_fwd(kind, wmat, packed, y0, times, "midpoint")
    seen = {}

    def spy(kernel, device, operands):
        seen[kernel] = [(name, shape) for name, _, shape in operands]
        raise _Refused

    monkeypatch.setattr(fused_ode, "_check_operands", spy)
    R, T, S, NC = packed.shape[1], times.shape[0], k.n_states, len(k.names)
    traj = fused_ode._plain_fwd(kind, wmat, packed, y0, times, "midpoint")
    for call in (lambda: fused_ode.kind_fwd(kind, wmat, packed, y0, times, "midpoint"),
                 lambda: fused_ode.kind_bwd(kind, wmat, packed, times, traj, traj, "midpoint")):
        with pytest.raises(_Refused):
            call()
    w = [("weights", (8, 2 + k.n_species))] if k.prec else []
    assert seen[k.fwd] == w + [("constants", (NC, R)), ("y0", (S, R)), ("times", (T,))]
    assert seen[k.bwd] == w + [("constants", (NC, R)), ("times", (T,)),
                               ("trajectory", (T, S, R)), ("cotangent", (T, S, R))]
