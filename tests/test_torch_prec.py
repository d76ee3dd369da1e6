"""The port's dr_constant_precisions path on the CPU: the plain ``dr_prec``
integrator and its hand-written reverse sweep (the plain versions of
csrc/dr_prec_fwd.cu and csrc/dr_prec_bwd.cu, line for line their
arithmetic), ``NeuralPrecisions``, the model's fused route and the
conversion of the precision nets' params.  The CUDA kernels themselves are
checked on the card by tests/test_torch_cuda.py and chip_smoke.py.

Inputs: dr_constant_precisions, B=3 series x K=4 samples, theta from the JAX
encoder and numpy draws, clipped and conditioned as the decoder sees it, the
JAX initial params (as tests/test_pallas.py's ``setup_prec``).

Tolerances, by state group:

* forward against the Pallas kernel in interpret mode: the 8 species and the
  4 precision states both to rtol 2e-5, atol 1e-7, the bar
  tests/test_pallas.py holds that kernel to against the scan.  The
  precision states reach ~1e4 here; both frameworks' float32 tanh / sigmoid
  are accurate to an ulp or two, and the precisions' dynamics contract, so
  they stay within float32 rounding (measured ~8e-7 relative; the TPU's
  approximate transcendentals moved them by up to 2e-2, which is why the
  TPU kernel's note warns about them);
* the hand-written pullbacks against torch.autograd in float64: rtol 1e-9
  (the same function, summed in another order);
* the reverse sweep against jax.grad through the Pallas backward in
  interpret mode: rtol 1e-3, atol 1e-5 (float32 both), as
  tests/test_pallas.py holds the Pallas backward against the scan."""

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
from vihds_tpu.models.base import NeuralPrecisions as JNeuralPrecisions
from vihds_tpu.models.dr_constant import _dr_constants as j_dr_constants
from vihds_tpu.ops import pallas_ode
from vihds_tpu.prob import ParamProgram, parse_parameters
from vihds_tpu.training import batch_arrays
from vihds_tpu.vae import VAE
from vihds_tpu_torch.convert import params_from_jax
from vihds_tpu_torch.models.base import NeuralPrecisions as TNeuralPrecisions
from vihds_tpu_torch.ops import fused_ode

METHODS = ["midpoint", "modeuler", "rk4"]
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "vihds_tpu_torch", "csrc")
S = fused_ode.N_SPECIES + fused_ode.N_PREC


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain sweep's per-row weight cotangents ([8, 10, R]) cross
    PyTorch's intra-op parallel threshold.  When the tests share a loaded CPU
    with other workers, those parallel elementwise ops contend for it (a card
    rule test took 8-24 s instead of 0.25 s); alone, one thread is as fast.
    Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    args = make_args(spec("dr_constant_precisions.yaml"))
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
    c = j_dr_constants(th, batch.inputs, 1)
    y0 = jnp.broadcast_to(
        model.ode_model.initialize_state(params["dec"], th, batch.inputs, 3, 4), (3, 4, S)
    )
    T = batch.times.shape[0]
    return dict(
        c={k: np.array(jnp.broadcast_to(v, (3, 4))) for k, v in c.items()},
        pp=jax.tree_util.tree_map(np.asarray, params["dec"]["precisions"]),
        y0=np.array(y0),
        times=np.array(batch.times),
        w=np.random.default_rng(2).standard_normal((T, 3, 4, S)).astype(np.float32),
    )


def _torch_pp(setup, dtype=torch.float32):
    return {net: {k: torch.as_tensor(v, dtype=dtype) for k, v in d.items()}
            for net, d in setup["pp"].items()}


def _packed(setup, dtype=torch.float64):
    c = {k: torch.as_tensor(v, dtype=dtype) for k, v in setup["c"].items()}
    packed, y0 = fused_ode._pack(c, torch.as_tensor(setup["y0"], dtype=dtype), "dr_prec")
    wmat = fused_ode._prec_wmat(_torch_pp(setup, dtype))
    return wmat, packed, y0, torch.as_tensor(setup["times"], dtype=dtype)


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("method", METHODS)
def test_plain_dr_prec_simulate_matches_pallas(setup, method):
    ref = np.asarray(pallas_ode.dr_constant_precisions_simulate(
        {k: jnp.asarray(v) for k, v in setup["c"].items()},
        jax.tree_util.tree_map(jnp.asarray, setup["pp"]), jnp.asarray(setup["y0"]),
        jnp.asarray(setup["times"]), method=method, block_rows=8, interpret=True,
    ))
    before = fused_ode.dr_constant_precisions_simulate.launches
    got = fused_ode.dr_constant_precisions_simulate(
        {k: torch.as_tensor(v) for k, v in setup["c"].items()}, _torch_pp(setup),
        torch.as_tensor(setup["y0"]), torch.as_tensor(setup["times"]), method=method,
    ).numpy()
    assert fused_ode.dr_constant_precisions_simulate.launches == before  # CPU: no launch
    assert got.shape == ref.shape == (len(setup["times"]), 3, 4, S)
    for group, sl in (("species", slice(0, 8)), ("precisions", slice(8, 12))):
        np.testing.assert_allclose(got[..., sl], ref[..., sl], rtol=2e-5, atol=1e-7,
                                   err_msg=group)


def test_prec_wmat_matches_pallas_packing(setup):
    """The [8, 10] weight operand: rows 0..3 prod, 4..7 degr, column 0 the
    bias, as the TPU kernel's ``_prec_wmat``."""
    ref = np.asarray(pallas_ode._prec_wmat(jax.tree_util.tree_map(jnp.asarray, setup["pp"])))
    got = fused_ode._prec_wmat(_torch_pp(setup)).numpy()
    assert got.shape == ref.shape == fused_ode.WMAT_SHAPE
    np.testing.assert_array_equal(got, ref)


# ----------------------------------------------------------------- backward
def test_prec_rhs_vjp_matches_autograd(setup):
    """The hand-written pullback of one dr_prec right-hand side evaluation
    (species and precision block), at states along a trajectory, against
    torch.autograd of ``_dr_prec_rhs_cols``: dy, every constant and dW."""
    wmat, packed, y0, times = _packed(setup)
    traj = fused_ode._integrate_prec_plain(wmat, packed, y0, times, "midpoint")
    rng = np.random.default_rng(3)
    names = fused_ode.DR_CONST_NAMES
    for i in (0, 17, 60, traj.shape[0] - 1):
        w = torch.as_tensor(rng.standard_normal(tuple(y0.shape)))
        pk = packed.clone().requires_grad_(True)
        wm = wmat.clone().requires_grad_(True)
        y = traj[i].clone().requires_grad_(True)
        f = fused_ode._dr_prec_rhs_cols((dict(zip(names, pk)), wm), times[i], y)
        ref_dc, ref_dw, ref_dy = torch.autograd.grad((f * w).sum(), (pk, wm, y))
        dc = {n: torch.zeros_like(packed[0]) for n in names}
        dc["W"] = torch.zeros(fused_ode.WMAT_SHAPE + (packed.shape[1],), dtype=packed.dtype)
        dy = fused_ode._dr_prec_rhs_vjp_cols((dict(zip(names, packed)), wmat), times[i],
                                             traj[i], w, dc)
        torch.testing.assert_close(dy, ref_dy, rtol=1e-9, atol=1e-12)
        torch.testing.assert_close(torch.stack([dc[n] for n in names]), ref_dc, rtol=1e-9,
                                   atol=1e-12)
        torch.testing.assert_close(dc["W"].sum(-1), ref_dw, rtol=1e-9, atol=1e-12)
        assert ref_dw.abs().max() > 0


@pytest.mark.parametrize("method", METHODS)
def test_plain_prec_bwd_matches_autograd(setup, method):
    wmat, packed, y0, times = _packed(setup)
    wm = wmat.clone().requires_grad_(True)
    pk = packed.clone().requires_grad_(True)
    yy = y0.clone().requires_grad_(True)
    traj = fused_ode._integrate_prec_plain(wm, pk, yy, times, method)
    g = torch.as_tensor(setup["w"], dtype=torch.float64).permute(0, 3, 1, 2).reshape(traj.shape)
    ref_dw, ref_dc, ref_dy0 = torch.autograd.grad((traj * g).sum(), (wm, pk, yy))
    dw, dc, dy0 = fused_ode._integrate_prec_plain_bwd(wmat, packed, times, traj.detach(), g,
                                                      method)
    torch.testing.assert_close(dw, ref_dw, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(dc, ref_dc, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(dy0, ref_dy0, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("method", METHODS)
def test_plain_prec_bwd_matches_pallas_bwd_kernel(setup, method):
    """jax.grad through the Pallas kernel (interpret mode: its custom VJP is
    ``_make_bwd_kernel`` with the per-cell dW partials summed on the host)
    against the port's differentiable wrapper on CPU tensors, whose backward
    is ``_integrate_prec_plain_bwd``: dc, dy0 and the precision nets' four
    leaves, each nonzero; float32 both."""
    times = jnp.asarray(setup["times"])
    w = jnp.asarray(setup["w"])

    def j_loss(c, pp, y0):
        sol = pallas_ode.dr_constant_precisions_simulate(c, pp, y0, times, method=method,
                                                         block_rows=8, interpret=True)
        return jnp.sum(sol * w)

    jc = {k: jnp.asarray(v) for k, v in setup["c"].items()}
    j_dc, j_dpp, j_dy0 = jax.grad(j_loss, argnums=(0, 1, 2))(
        jc, jax.tree_util.tree_map(jnp.asarray, setup["pp"]), jnp.asarray(setup["y0"]))

    tc = {k: torch.as_tensor(v).requires_grad_(True) for k, v in setup["c"].items()}
    tpp = _torch_pp(setup)
    for d in tpp.values():
        for leaf in d.values():
            leaf.requires_grad_(True)
    ty0 = torch.as_tensor(setup["y0"]).requires_grad_(True)
    fwd0 = fused_ode.dr_constant_precisions_simulate.launches
    bwd0 = fused_ode.dr_prec_bwd.launches
    sol = fused_ode.dr_constant_precisions_simulate(tc, tpp, ty0, torch.as_tensor(setup["times"]),
                                                    method)
    (sol * torch.as_tensor(setup["w"])).sum().backward()
    # CPU tensors: the plain versions, no kernel launch
    assert (fused_ode.dr_constant_precisions_simulate.launches,
            fused_ode.dr_prec_bwd.launches) == (fwd0, bwd0)
    np.testing.assert_allclose(ty0.grad.numpy(), np.asarray(j_dy0), rtol=1e-3, atol=1e-5)
    for k in fused_ode.DR_CONST_NAMES:
        got, ref = tc[k].grad.numpy(), np.asarray(j_dc[k])
        assert np.isfinite(ref).all(), k
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5, err_msg=k)
    for net in ("prod", "degr"):
        for leaf in ("w", "b"):
            got, ref = tpp[net][leaf].grad.numpy(), np.asarray(j_dpp[net][leaf])
            assert np.isfinite(ref).all() and np.abs(ref).max() > 0, (net, leaf)
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5, err_msg=net + leaf)


def test_times_get_no_cotangent(setup):
    wmat, packed, y0, times = _packed(setup, torch.float32)
    times = times.clone().requires_grad_(True)
    wm = wmat.clone().requires_grad_(True)
    out = fused_ode._KindIntegrate.apply("dr_prec", wm, packed, y0, times, "midpoint")
    out.sum().backward()
    assert times.grad is None and wm.grad is not None


# ------------------------------------------------- the kernels' operand checks
def test_prec_kernels_refuse_cpu_tensors(setup):
    """The kernels' wrappers check their operands before they load a
    library: CPU tensors are refused, never silently computed."""
    wmat, packed, y0, times = _packed(setup, torch.float32)
    with pytest.raises(ValueError, match="must be on"):
        fused_ode._integrate_prec_cuda(wmat, packed, y0, times, "midpoint")
    traj = fused_ode._integrate_prec_plain(wmat, packed, y0, times, "midpoint")
    with pytest.raises(ValueError, match="must be on"):
        fused_ode.dr_prec_bwd(wmat, packed, times, traj, torch.ones_like(traj), "midpoint")


def test_prec_kernel_sources_match_the_wrapper():
    """Both dr_prec kernels include dr_common.cuh, whose weight-matrix shape
    is the wrapper's; the rows a _prec backward block sweeps, and so the rows
    each of its dW partials covers, are the ones the wrapper sizes the
    partials by; and the three _prec backwards launch the shared template."""
    common = open(os.path.join(CSRC, "dr_common.cuh")).read()
    consts = {m.group(1): m.group(2) for m in re.finditer(r"constexpr int (\w+) = ([^;]+);", common)}
    assert consts["N_PREC"] == str(fused_ode.N_PREC)
    assert re.search(r"struct Dr \{\s*enum : int \{ NC = N_CONST, NS = (\d+) \};", common).group(
        1) == str(fused_ode.N_SPECIES)
    assert fused_ode.WMAT_SHAPE == fused_ode.KINDS["dr_prec"].wmat_shape == (
        2 * fused_ode.N_PREC, 2 + fused_ode.N_SPECIES)
    assert "constexpr int n_feat(int ns) { return 2 + ns; }" in common
    assert "constexpr int n_w(int ns) { return 2 * N_PREC * n_feat(ns); }" in common
    for name in ("dr_prec_fwd.cu", "dr_prec_bwd.cu"):
        src = open(os.path.join(CSRC, name)).read()
        assert '#include "dr_common.cuh"' in src and "<Dr, true>" in src, name
    # one partial per block of PREC_BWD_ROWS rows: the grid, the lanes and the
    # block's sum over its rows all count PREC_BWD_ROWS
    assert consts["PREC_BWD_ROWS"] == str(fused_ode.PREC_BWD_ROWS)
    assert "(Rf + PREC_BWD_ROWS - 1) / PREC_BWD_ROWS), (unsigned)folds)" in common
    assert "const int rl = blockIdx.x * PREC_BWD_ROWS + lane;" in common
    assert "dw_out[((size_t)fold * gridDim.x + blockIdx.x) * NW + e] = sum;" in common
    assert "for (int q = 0; q < PREC_BWD_ROWS; ++q) sum += sh.dW[e][q];" in common
    for family, F in (("dr", "Dr"), ("relay", "Relay"), ("degrader", "Degrader")):
        src = open(os.path.join(CSRC, family + "_prec_bwd.cu")).read()
        assert '#include "dr_common.cuh"' in src, family
        assert re.search(r"return bwd_launch<%s, true>\(wmat, consts, times, traj, g, dw, dc, "
                         r"dy0, R, T, method,\s+stream, folds\);" % F, src), family


@pytest.mark.parametrize("family, F", [("dr", "Dr"), ("relay", "Relay"),
                                       ("degrader", "Degrader")])
def test_prec_fwd_sources_follow_the_header(family, F):
    """Each _prec forward launches the shared template and answers the block
    query from it; the header's rows a forward block runs (its grid and
    lanes use them) are what the query reports for every method, and so what
    chip_smoke.py counts waves by; the plain kind's forward launches the
    template without the precision block."""
    common = open(os.path.join(CSRC, "dr_common.cuh")).read()
    consts = {m.group(1): m.group(2) for m in re.finditer(r"constexpr int (\w+) = ([^;]+);", common)}
    assert consts["PREC_FWD_ROWS"] == "32"
    assert consts["PREC_FWD_THREADS"] == "PREC_FWD_ROWS * (N_PREC + 1)"
    assert ("const dim3 grid((unsigned)((Rf + PREC_FWD_ROWS - 1) / PREC_FWD_ROWS), "
            "(unsigned)folds);" in common)
    assert "const int rl = blockIdx.x * PREC_FWD_ROWS + lane;" in common
    for method in ("MODEULER", "MIDPOINT", "RK4"):
        assert re.search(r"return block_of\(prec_fwd_kernel<F, %s>, PREC_FWD_ROWS, "
                         r"PREC_FWD_THREADS, rows,\s+threads, smem_bytes, registers, "
                         r"blocks_per_sm\);" % method, common), method
    assert "  *rows = n_rows;\n" in common
    smoke = open(os.path.join(os.path.dirname(CSRC), os.pardir, "chip_smoke.py")).read()
    assert "    rows, threads, smem, regs, per_sm = block\n" in smoke
    assert re.search(r"print_block\(device, k\.fwd, method,\s+fused_ode\.fwd_block\(kind, method\),",
                     smoke)
    src = open(os.path.join(CSRC, family + "_prec_fwd.cu")).read()
    assert '#include "dr_common.cuh"' in src
    assert re.search(r"return fwd_launch<%s, true>\(wmat, consts, y0, times, out, R, T, method, "
                     r"stream, folds\);" % F, src)
    assert re.search(r"return prec_fwd_block<%s>\(method, rows, threads, smem_bytes, registers, "
                     r"blocks_per_sm\);" % F, src)
    plain = open(os.path.join(CSRC, family + "_fwd.cu")).read()
    assert re.search(r"return fwd_launch<%s, false>\(nullptr, consts, y0, times, out, R, T, "
                     r"method, stream\);" % F, plain)


def test_build_hashes_the_shared_header(tmp_path, monkeypatch):
    """An edit to a header under csrc changes every library's path, so a
    stale library is never loaded after it."""
    import shutil

    from vihds_tpu_torch.ops import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    before = {name: build.library_path(name) for name in build.SOURCES}
    with open(csrc / "dr_common.cuh", "a") as f:
        f.write("\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)


# ------------------------------------------------------------- NeuralPrecisions
@pytest.mark.parametrize("n_hidden,activation,inverse",
                         [(0, "tanh", False), (0, "relu", False), (20, "tanh", False),
                          (20, "relu", True), (0, "tanh", True)],
                         ids=["h0-tanh", "h0-relu", "h20-tanh", "h20-relu-inverse",
                              "h0-tanh-inverse"])
def test_neural_precisions_match_jax(n_hidden, activation, inverse):
    """``rhs`` (over [t, species] and over [t, species, constants]),
    ``expand`` and ``at_time`` of the port's NeuralPrecisions on the JAX
    block's converted params; and the port's own init: the JAX tree and
    shapes, weights within their xavier bounds (gains 0.5 / 1.0 behind a
    hidden layer)."""
    rng = np.random.default_rng(5)
    for n_inputs, cst in ((8, None), (10, rng.standard_normal((3, 4, 2)).astype(np.float32))):
        jp = JNeuralPrecisions(n_inputs, n_hidden, 4, inverse=inverse, activation=activation)
        tp = TNeuralPrecisions(n_inputs, n_hidden, 4, inverse=inverse, activation=activation)
        jparams = jp.init_params(jax.random.PRNGKey(3))
        tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        state = (rng.standard_normal((3, 4, 12)) + 2.0).astype(np.float32)
        for t in (0.0, 0.7, 19.5):
            ref = jp.rhs(jparams, t, jnp.asarray(state), None if cst is None else jnp.asarray(cst))
            got = tp.rhs(tparams, t, torch.as_tensor(state),
                         None if cst is None else torch.as_tensor(cst))
            # O(1) outputs; the two frameworks' float32 sigmoids differ by an ulp
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)

        own = jax.tree_util.tree_map(np.asarray, tp.init_params(torch.Generator().manual_seed(0)))
        assert jax.tree_util.tree_structure(own) == jax.tree_util.tree_structure(jparams)
        n_in = n_inputs + 1
        layers_in = {"hidden": n_in} if n_hidden else {}
        for name, gain in (("hidden", 1.0), ("prod", 0.5), ("degr", 1.0)):
            if name not in own:
                continue
            fan_in = n_hidden if (n_hidden and name != "hidden") else layers_in.get(name, n_in)
            assert own[name]["w"].shape == np.shape(jparams[name]["w"]), name
            fan_out = own[name]["w"].shape[1]
            g = gain if n_hidden else 1.0
            assert np.abs(own[name]["w"]).max() <= g * np.sqrt(6.0 / (fan_in + fan_out)), name

    x_states = np.abs(rng.standard_normal((3, 4, 12, 7))).astype(np.float32) + 0.5
    for a, b in zip(tp.expand(tparams, None, 7, torch.as_tensor(x_states)),
                    jp.expand(jparams, None, 7, jnp.asarray(x_states))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)
    for a, b in zip(tp.at_time(tparams, None, torch.as_tensor(x_states[..., 2])),
                    jp.at_time(jparams, None, jnp.asarray(x_states[..., 2]))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)


# ------------------------------------------------------- the model's routes
def _port_model(spec_name, solver):
    from types import SimpleNamespace

    from vihds_tpu_torch.config import Config as TConfig
    from vihds_tpu_torch.data.datasets import build_datasets as t_build
    from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
    from vihds_tpu_torch.vae import VAE as TVAE

    targs = SimpleNamespace(yaml=spec(spec_name), seed=0, folds=4, split=1, heldout=None)
    tset = TConfig(targs)
    tset.params.solver = solver
    tdata = t_build(targs, tset)
    tprog = TProgram(t_parse(tset.params))
    return TVAE(tset, tdata, tprog), tdata


@pytest.mark.parametrize("n_hidden", [0, 20], ids=["kernel", "generic"])
def test_fused_route_takes_the_prec_kernel_where_supported(monkeypatch, n_hidden):
    """``solver: pallas_midpoint`` on dr_constant_precisions goes through
    ``dr_constant_precisions_simulate`` with the model's precision params
    and agrees with the generic midpoint solver; a configuration the kernels
    do not cover (a hidden layer) takes the generic solver alone."""
    from vihds_tpu_torch.training import batch_tensors

    model, data = _port_model("dr_constant_precisions.yaml", "pallas_midpoint")
    ode, program = model.ode_model, model.program
    ode.precisions.n_hidden = n_hidden
    assert ode._pallas_supported() == (n_hidden == 0)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")["dec"]
    host = data.train.dataset.select(np.arange(3))
    batch = batch_tensors(host, slice(None), torch.as_tensor(host.times), "cpu")
    u = torch.as_tensor(np.random.default_rng(1).standard_normal((3, 4, program.n_theta)),
                        dtype=torch.float32)
    th = program.theta_dict(program.clip(program.sample(program.prior_q("cpu"), u), stddevs=4))
    th = ode.condition_theta(params, th, batch.dev_1hot)
    calls = []
    orig = fused_ode.dr_constant_precisions_simulate

    def spy(constants, prec_params, *a, **k):
        calls.append(prec_params)
        return orig(constants, prec_params, *a, **k)

    monkeypatch.setattr(fused_ode, "dr_constant_precisions_simulate", spy)
    sol = ode.simulate(params, th, batch.times, batch.inputs, batch.dev_1hot, 4)
    assert sol.shape == (3, 4, S, len(host.times)) and torch.isfinite(sol).all()
    assert len(calls) == (n_hidden == 0)
    if calls:
        assert calls[0] is params["precisions"]
        ode.solver = "midpoint"
        generic = ode.simulate(params, th, batch.times, batch.inputs, batch.dev_1hot, 4)
        torch.testing.assert_close(sol, generic, rtol=2e-5, atol=1e-6)


def test_params_from_jax_maps_the_precision_leaves():
    """The JAX init of dr_constant_precisions converts leaf for leaf: the
    ``dec.precisions.{prod,degr}.{w,b}`` leaves keep their [9, 4] / [4]
    layouts and values, and the port's own init has the same tree."""
    args = make_args(spec("dr_constant_precisions.yaml"))
    settings = Config(args)
    data = build_datasets(args, settings)
    jmodel = VAE(settings, data, ParamProgram(parse_parameters(settings.params)))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jp = jparams["dec"]["precisions"]
    assert set(tparams["dec"]["precisions"]) == {"prod", "degr"}
    for net in ("prod", "degr"):
        assert tuple(tparams["dec"]["precisions"][net]["w"].shape) == (9, 4)
        for leaf in ("w", "b"):
            got = tparams["dec"]["precisions"][net][leaf]
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(jp[net][leaf]))
    own = _port_model("dr_constant_precisions.yaml", "midpoint")[0].init_params(
        torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), jparams)
    assert shapes == jax.tree_util.tree_map(lambda t: tuple(t.shape), own)


# ------------------------------------------------------------------------- #
# The rule chip_smoke.py holds dr_prec_bwd to on the card (phase 3): each
# constant's and state's row over the samples, and each of the 8 rows of dW
# over its 10 columns, against the plain sweep in float64.  The plain float32
# sweep, which rounds as a float32 kernel does, must pass it; a sweep with
# one derivative 1% off must not, whichever weight entry or state it is.
# Operands: dr_constant_precisions, B=36 series x K=20 samples, theta from
# the prior, as phase 3 draws them at K=200.
# ------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def prec_operands():
    import chip_smoke

    _, _, _, wmat, packed, y0, times = chip_smoke.kind_inputs("cpu", "dr_prec", 20, 3)
    g = torch.as_tensor(np.random.default_rng(4).standard_normal((times.shape[0],) + y0.shape),
                        dtype=torch.float32)
    traj = fused_ode._integrate_prec_plain(wmat, packed, y0, times, "midpoint")
    ref = fused_ode._integrate_prec_plain_bwd(wmat.double(), packed.double(), times.double(),
                                              traj.double(), g.double(), "midpoint")
    return wmat, packed, times, traj, g, ref


def _prec_ok(operands, method="midpoint"):
    """(ok, rows readings, W readings) of the plain float32 sweep."""
    import chip_smoke

    wmat, packed, times, traj, g, (rw, rc, ry) = operands
    dw, dc, dy0 = fused_ode._integrate_prec_plain_bwd(wmat, packed, times, traj, g, method)
    rows = torch.cat([dc, dy0])
    ref = torch.cat([rc, ry])
    ok = chip_smoke.cotangents_ok(rows, ref) and chip_smoke.cotangents_ok(dw, rw)
    return ok, chip_smoke.cotangent_readings(rows, ref), chip_smoke.cotangent_readings(dw, rw)


@pytest.mark.parametrize("method", METHODS)
def test_float32_prec_sweep_is_within_the_card_tolerance(method):
    import chip_smoke

    _, _, _, wmat, packed, y0, times = chip_smoke.kind_inputs("cpu", "dr_prec", 20, 3)
    g = torch.as_tensor(np.random.default_rng(4).standard_normal((times.shape[0],) + y0.shape),
                        dtype=torch.float32)
    traj = fused_ode._integrate_prec_plain(wmat, packed, y0, times, method)
    ref = fused_ode._integrate_prec_plain_bwd(wmat.double(), packed.double(), times.double(),
                                              traj.double(), g.double(), method)
    ok, (n1, r1), (n2, r2) = _prec_ok((wmat, packed, times, traj, g, ref), method)
    assert ok, (float(n1.max()), float(r1.max()), float(n2.max()), float(r2.max()))


@pytest.mark.parametrize("entry", range(fused_ode.WMAT_SHAPE[0] * fused_ode.WMAT_SHAPE[1]),
                         ids=lambda e: "W%d_%d" % divmod(e, fused_ode.WMAT_SHAPE[1]))
def test_card_tolerance_catches_one_weight_entry_one_percent_off(prec_operands, monkeypatch,
                                                                 entry):
    vjp = fused_ode._prec_rhs_vjp_cols
    scale = torch.ones(fused_ode.WMAT_SHAPE + (1,))
    scale.view(-1)[entry] = 1.01

    def one_percent_off(wmat, t, y, w, dc):
        before = dc["W"]
        out = vjp(wmat, t, y, w, dc)
        dc["W"] = before + (dc["W"] - before) * scale
        return out

    monkeypatch.setattr(fused_ode, "_prec_rhs_vjp_cols", one_percent_off)
    ok, _, (norm, rel) = _prec_ok(prec_operands)
    assert not ok
    row = entry // fused_ode.WMAT_SHAPE[1]
    assert norm[row] > 1e-4 or rel[row] > 1e-3


@pytest.mark.parametrize("state", range(S))
def test_card_tolerance_catches_one_prec_state_pullback_one_percent_off(prec_operands,
                                                                        monkeypatch, state):
    vjp = fused_ode._dr_prec_rhs_vjp_cols

    def one_percent_off(c, t, y, w, dc):
        out = vjp(c, t, y, w, dc)
        return torch.cat([out[:state], 1.01 * out[state:state + 1], out[state + 1:]])

    monkeypatch.setattr(fused_ode, "_dr_prec_rhs_vjp_cols", one_percent_off)
    ok, (norm, rel), _ = _prec_ok(prec_operands)
    assert not ok, (float(norm.max()), float(rel.max()))
