"""The port's dr_blackbox path on the CPU, against the JAX package: the plain
black-box integrator and its hand-written reverse sweep (the plain versions
of csrc/blackbox_fwd.cu and csrc/blackbox_bwd.cu), ``NeuralStates``,
``DR_Blackbox``, the routing, the eval forward, one training step on both
routes and a short ``run_xval.main``.  The CUDA kernels themselves are
checked on the card by tests/test_torch_cuda.py and chip_smoke.py.

Inputs: specs/dr_blackbox_icml.yaml (its shipped widths: 6 ODE states, 21
constants, hidden layers 25 and 20), B=3 series x K=4 samples, theta from the
JAX encoder and numpy draws, clipped and conditioned as the decoder sees it,
the JAX initial params converted by ``convert.params_from_jax`` (as
tests/test_pallas.py's ``setup_blackbox``).

Tolerances:

* forward against the Pallas kernel in interpret mode: rtol 2e-5, atol 1e-7
  for each state group (observed, latent species, precisions), the bar
  tests/test_pallas.py holds that kernel to against the scan;
* the hand-written pullback and sweep against torch.autograd in float64:
  rtol 1e-9 (the same function, summed in another order);
* the sweep against jax.grad through the Pallas backward in interpret mode:
  rtol 1e-3, atol 1e-5 per leaf, as tests/test_pallas.py holds the Pallas
  backward against the scan;
* the model's constants and initial states: rtol 1e-6; the eval forward's
  trajectories and moments rtol 1e-5 (atol 1e-6), its log-weights rtol 1e-5
  with atol 1e-2 nats (sums of ~1e3 nats, as tests/test_torch_slice.py);
* one training step: the loss rtol 1e-6, each gradient leaf within 1e-4 of
  its largest entry (as tests/test_torch_train.py)."""

import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_args, spec
from vihds_tpu.config import Config as JConfig
from vihds_tpu.data.datasets import build_datasets as j_build
from vihds_tpu.models.base import NeuralStates as JNeuralStates
from vihds_tpu.ops import pallas_blackbox
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu.training import _importance_weighted_outputs as j_iw
from vihds_tpu.training import batch_arrays, iwae_elbo as j_iwae_elbo
from vihds_tpu.training import iwae_elbo_terms as j_terms
from vihds_tpu.training import prior_as_q as j_prior_as_q
from vihds_tpu.utils.attrdict import AttrDict as JAttrDict
from vihds_tpu.vae import VAE as JVAE
from vihds_tpu_torch import run_xval
from vihds_tpu_torch import training as T
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.convert import params_from_jax
from vihds_tpu_torch.data.datasets import build_datasets as t_build
from vihds_tpu_torch.models.base import NeuralStates as TNeuralStates
from vihds_tpu_torch.ops import build, fused_blackbox as fb
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.vae import VAE as TVAE

SPEC = "dr_blackbox_icml.yaml"
METHODS = ["midpoint", "modeuler", "rk4"]
B, K = 3, 4
NS, S = fb.KERNEL_N_STATES, fb.KERNEL_N_STATES + fb.N_PREC
GROUPS = (("observed", slice(0, 4)), ("latent", slice(4, NS)), ("precisions", slice(NS, S)))
LEAVES = ["/".join(leaf) for leaf in fb.WEIGHT_LEAVES]
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "vihds_tpu_torch", "csrc")


def _jax_model(solver=None, **params):
    args = make_args(spec(SPEC))
    jset = JConfig(args)
    if solver:
        jset.params.solver = solver
    jset.params.update(params)
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    jmodel = JVAE(jset, jdata, jprog)
    return jset, jdata, jprog, jmodel, jmodel.init_params(jax.random.PRNGKey(0))


def _port_model(solver="midpoint", eval_solver=None, **params):
    targs = SimpleNamespace(yaml=spec(SPEC), seed=0, folds=4, split=1, heldout=None)
    tset = TConfig(targs)
    tset.params.solver = solver
    if eval_solver:
        tset.params.eval_solver = eval_solver
    tset.params.update(params)
    tdata = t_build(targs, tset)
    tprog = TProgram(t_parse(tset.params))
    return tset, tdata, tprog, TVAE(tset, tdata, tprog)


@pytest.fixture(scope="module")
def setup():
    """The operands of the kernels for B x K rows, as numpy arrays, the
    converted params, and the JAX Pallas kernel's trajectories (interpret
    mode) in all three methods and its gradients in midpoint, each computed
    once."""
    _, jdata, jprog, jmodel, jparams = _jax_model()
    ode = jmodel.ode_model
    batch = batch_arrays(jdata.train.dataset.select(np.arange(B)))
    q = jmodel.encoder(jparams["enc"], batch)
    u = np.random.default_rng(1).standard_normal((B, K, jprog.n_theta)).astype(np.float32)
    th = jprog.theta_dict(jprog.clip(jprog.sample(q, jnp.asarray(u)), stddevs=4))
    th = ode.condition_theta(jparams["dec"], th, batch.dev_1hot)
    c = ode._constants(th, batch.inputs, batch.dev_1hot, K)
    y0 = ode.initialize_state(jparams["dec"], th, batch.inputs, B, K)
    times = batch.times
    T_ = times.shape[0]
    w = np.random.default_rng(2).standard_normal((T_, B, K, S)).astype(np.float32)
    nets = {"states": jparams["dec"]["states"], "precisions": jparams["dec"]["precisions"]}
    ref = {m: np.asarray(pallas_blackbox.blackbox_simulate(
        nets, c, y0, times, ode.n_states, method=m, block_rows=8, interpret=True))
        for m in METHODS}

    def j_loss(nets, c, y0):
        sol = pallas_blackbox.blackbox_simulate(nets, c, y0, times, ode.n_states,
                                                method="midpoint", block_rows=8, interpret=True)
        return jnp.sum(sol * jnp.asarray(w))

    j_dnets, j_dc, j_dy0 = jax.grad(j_loss, argnums=(0, 1, 2))(nets, c, y0)
    return dict(
        jparams=jparams,
        tparams=params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
        theta={k: np.asarray(v) for k, v in th.items()},
        c=np.array(c), y0=np.array(y0), times=np.array(times), w=w, ref=ref,
        jgrad={"/".join(leaf): np.asarray(j_dnets[leaf[0]][leaf[1]][leaf[2]])
               for leaf in fb.WEIGHT_LEAVES} | {"dc": np.asarray(j_dc), "dy0": np.asarray(j_dy0)},
    )


def _nets(setup, dtype=torch.float32):
    return {net: {layer: {k: v.detach().clone().to(dtype) for k, v in d.items()}
                  for layer, d in setup["tparams"]["dec"][net].items()}
            for net in ("states", "precisions")}


def _packed(setup, dtype=torch.float64):
    wv, _, packed, y0 = fb._pack(_nets(setup, dtype), torch.as_tensor(setup["c"], dtype=dtype),
                                 torch.as_tensor(setup["y0"], dtype=dtype))
    return wv, packed, y0, torch.as_tensor(setup["times"], dtype=dtype)


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("method", METHODS)
def test_plain_blackbox_simulate_matches_pallas(setup, method):
    before = fb.blackbox_simulate.launches
    got = fb.blackbox_simulate(_nets(setup), torch.as_tensor(setup["c"]),
                               torch.as_tensor(setup["y0"]), torch.as_tensor(setup["times"]), NS,
                               method=method).numpy()
    assert fb.blackbox_simulate.launches == before  # CPU: no launch
    ref = setup["ref"][method]
    assert got.shape == ref.shape == (len(setup["times"]), B, K, S)
    for group, sl in GROUPS:
        np.testing.assert_allclose(got[..., sl], ref[..., sl], rtol=2e-5, atol=1e-7,
                                   err_msg=group)
    np.testing.assert_array_equal(
        fb.blackbox_simulate_plain(_nets(setup), torch.as_tensor(setup["c"]),
                                   torch.as_tensor(setup["y0"]),
                                   torch.as_tensor(setup["times"]), NS, method).numpy(), got)


# ----------------------------------------------------------------- backward
def test_rhs_vjp_matches_autograd(setup):
    """The hand-written pullback of one right-hand side at states along a
    trajectory, against torch.autograd of ``_bb_rhs_cols`` in float64: dy,
    every constant and each of the 12 leaves."""
    wv, packed, y0, times = _packed(setup)
    traj = fb._plain_fwd(wv, packed, y0, times, NS, "midpoint")
    rng = np.random.default_rng(3)
    for i in (0, 17, 60, traj.shape[0] - 1):
        w = torch.as_tensor(rng.standard_normal(tuple(y0.shape)))
        leaves = [x.clone().requires_grad_(True) for x in wv]
        pk = packed.clone().requires_grad_(True)
        y = traj[i].clone().requires_grad_(True)
        f = fb._bb_rhs_cols(leaves, pk, NS, times[i], y)
        ref = torch.autograd.grad((f * w).sum(), leaves + [pk, y])
        acc = {"c": torch.zeros_like(packed), "w": [torch.zeros_like(x) for x in wv]}
        dy = fb._bb_rhs_vjp_cols(wv, packed, NS, times[i], traj[i], w, acc)
        torch.testing.assert_close(dy, ref[-1], rtol=1e-9, atol=1e-12)
        torch.testing.assert_close(acc["c"], ref[-2], rtol=1e-9, atol=1e-12)
        for name, got, want in zip(LEAVES, acc["w"], ref[:-2]):
            torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12, msg=name)
            assert want.abs().max() > 0, name


@pytest.mark.parametrize("method", METHODS)
def test_plain_bwd_matches_autograd(setup, method):
    wv, packed, y0, times = _packed(setup)
    leaves = [x.clone().requires_grad_(True) for x in wv]
    pk = packed.clone().requires_grad_(True)
    yy = y0.clone().requires_grad_(True)
    traj = fb._plain_fwd(leaves, pk, yy, times, NS, method)
    g = torch.as_tensor(setup["w"], dtype=torch.float64).permute(0, 3, 1, 2).reshape(traj.shape)
    ref = torch.autograd.grad((traj * g).sum(), leaves + [pk, yy])
    dw, dc, dy0 = fb._plain_bwd(wv, packed, times, traj.detach(), g, NS, method)
    torch.testing.assert_close(dy0, ref[-1], rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(dc, ref[-2], rtol=1e-9, atol=1e-9)
    for name, got, want in zip(LEAVES, dw, ref[:-2]):
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9, msg=name)


@pytest.fixture(scope="module")
def port_grads(setup):
    """jax.grad's counterpart in the port: the differentiable wrapper on CPU
    tensors (its backward is ``_plain_bwd``), midpoint, float32."""
    nets = _nets(setup)
    for d in nets.values():
        for layer in d.values():
            for leaf in layer.values():
                leaf.requires_grad_(True)
    c = torch.as_tensor(setup["c"]).requires_grad_(True)
    y0 = torch.as_tensor(setup["y0"]).requires_grad_(True)
    before = (fb.blackbox_simulate.launches, fb.blackbox_bwd.launches)
    sol = fb.blackbox_simulate(nets, c, y0, torch.as_tensor(setup["times"]), NS, "midpoint")
    (sol * torch.as_tensor(setup["w"])).sum().backward()
    assert (fb.blackbox_simulate.launches, fb.blackbox_bwd.launches) == before
    grads = {"/".join(leaf): nets[leaf[0]][leaf[1]][leaf[2]].grad.numpy()
             for leaf in fb.WEIGHT_LEAVES}
    return grads | {"dc": c.grad.numpy(), "dy0": y0.grad.numpy()}


@pytest.mark.parametrize("name", LEAVES + ["dc", "dy0"])
def test_plain_bwd_matches_pallas_bwd_kernel(setup, port_grads, name):
    """jax.grad through the Pallas kernel (interpret mode: its custom VJP is
    ``_make_bwd_kernel`` with the per-cell weight partials summed on the
    host) against the port's wrapper: each weight leaf, dc and dy0, each
    nonzero; float32 both."""
    ref, got = setup["jgrad"][name], port_grads[name]
    assert got.shape == ref.shape
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0, name
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5, err_msg=name)


def test_times_get_no_cotangent(setup):
    wv, packed, y0, times = _packed(setup, torch.float32)
    wflat = torch.cat([x.reshape(-1) for x in wv]).requires_grad_(True)
    times = times.clone().requires_grad_(True)
    shapes = tuple(tuple(x.shape) for x in wv)
    out = fb._BlackboxIntegrate.apply(wflat, packed, y0, times, shapes, NS, "midpoint")
    out.sum().backward()
    assert times.grad is None and wflat.grad is not None and wflat.grad.shape == (fb.KERNEL_N_W,)


# ------------------------------------------------- the kernels' operand checks
def test_kernels_refuse_cpu_tensors(setup):
    """The kernels' wrappers check their operands before they load a
    library: CPU tensors are refused, never silently computed."""
    wv, packed, y0, times = _packed(setup, torch.float32)
    wflat = torch.cat([x.reshape(-1) for x in wv])
    shapes = tuple(tuple(x.shape) for x in wv)
    with pytest.raises(ValueError, match="must be on"):
        fb.blackbox_fwd(wflat, packed, y0, times, shapes, NS, "midpoint")
    traj = fb._plain_fwd(wv, packed, y0, times, NS, "midpoint")
    with pytest.raises(ValueError, match="must be on"):
        fb.blackbox_bwd(wflat, packed, times, traj, torch.ones_like(traj), shapes, NS, "midpoint")


def test_kernels_refuse_other_widths(setup):
    wv, packed, y0, times = _packed(setup, torch.float32)
    wflat = torch.cat([x.reshape(-1) for x in wv])
    shapes = fb.leaf_shapes(NS, 21, 30, 20)
    with pytest.raises(ValueError, match="is built for 6 states, 21 constants"):
        fb.blackbox_fwd(wflat, packed, y0, times, shapes, NS, "midpoint")


def test_kernel_sources_match_the_wrapper():
    """blackbox_common.cuh's widths, leaf offsets and backward block are the
    wrapper's; both entry points are built from the repo's sources."""
    common = open(os.path.join(CSRC, "blackbox_common.cuh")).read()
    consts = {m.group(1): m.group(2) for m in
              re.finditer(r"constexpr int (\w+) = ([^;]+);", common)}
    assert consts["NS"] == str(fb.KERNEL_N_STATES) and consts["NC"] == str(fb.KERNEL_N_CONST)
    assert (consts["H"], consts["HP"]) == ("25", "20")
    assert fb.KERNEL_LEAF_SHAPES[0] == (27, 25) and fb.KERNEL_LEAF_SHAPES[6] == (28, 20)
    assert consts["BWD_ROWS"] == str(fb.BWD_ROWS) and fb.KERNEL_N_W == 1760
    assert "static_assert(N_W == 1760" in common
    offsets = re.findall(r"constexpr int (\w\w_[WB]) = ", common)
    assert offsets == ["SH_W", "SH_B", "SP_W", "SP_B", "SD_W", "SD_B", "PH_W", "PH_B", "PP_W",
                       "PP_B", "PD_W", "PD_B"]
    for d in ("fwd", "bwd"):
        assert build.SOURCES["blackbox_" + d] == "blackbox_%s.cu" % d
        src = open(os.path.join(CSRC, "blackbox_%s.cu" % d)).read()
        assert '#include "blackbox_common.cuh"' in src
        assert 'extern "C" int blackbox_%s_launch(' % d in src
        assert "pallas_blackbox.py" in src


def test_bwd_partials_follow_the_kernel_block():
    """The wrapper sizes blackbox_bwd's dW partials as one per BWD_ROWS
    sample rows: the header's block rows, by which the entry point sizes its
    grid and each block offsets its rows and its partial."""
    common = open(os.path.join(CSRC, "blackbox_common.cuh")).read()
    rows = re.findall(r"^constexpr int BWD_ROWS = (\d+);", common, re.M)
    assert rows == [str(fb.BWD_ROWS)]
    launch = open(os.path.join(CSRC, "blackbox_bwd.cu")).read()
    assert "(R + bb::BWD_ROWS - 1) / bb::BWD_ROWS" in launch
    assert "blockIdx.x * BWD_ROWS + th.row" in common
    assert "dw_out[(size_t)blockIdx.x * N_W + e]" in common


def _header_value(consts, name):
    """The integer value of blackbox_common.cuh's ``constexpr int name``,
    its expression evaluated over the header's other constants."""
    expr = re.sub(r"\b[A-Z_][A-Z0-9_]*\b", lambda m: "(%d)" % _header_value(consts, m.group(0)),
                  consts[name])
    return eval(expr.replace("/", "//"), {"__builtins__": {}})


@pytest.mark.parametrize("part", ["grid", "rows", "constants"])
def test_fwd_block_follows_the_header(part):
    """blackbox_fwd runs the backward's block (FWD_ROWS = BWD_ROWS rows x 8
    warps): the entry point sizes its grid and block from the header's
    forward constants, the kernel offsets its rows by them, and the
    wrapper's FWD_ROWS is the header's."""
    common = open(os.path.join(CSRC, "blackbox_common.cuh")).read()
    headers = open(os.path.join(CSRC, "dr_common.cuh")).read() + common
    consts = {m.group(1): m.group(2) for m in
              re.finditer(r"^constexpr int (\w+) = ([^;]+);", headers, re.M)}
    kernel = common[common.index("fwd_kernel(const float*"):common.index("bwd_kernel(")]
    if part == "grid":
        launch = open(os.path.join(CSRC, "blackbox_fwd.cu")).read()
        assert "const dim3 grid((unsigned)((R + bb::FWD_ROWS - 1) / bb::FWD_ROWS));" in launch
        assert launch.count("<<<grid, bb::FWD_THREADS, 0, s>>>") == 3
        assert "__launch_bounds__(FWD_THREADS, FWD_MIN_BLOCKS)\nfwd_kernel(" in common
    elif part == "rows":
        assert "const int r0 = blockIdx.x * FWD_ROWS + th.row;" in kernel
        assert "th.row = threadIdx.x % FWD_ROWS;" in kernel
        assert "th.q = threadIdx.x / FWD_ROWS;" in kernel
        assert "const int r = live ? r0 : R - 1;" in kernel
        assert kernel.count("if (live") == 2  # y0 and each step: stored by live rows only
    else:
        assert consts["FWD_ROWS"] == "BWD_ROWS"
        assert _header_value(consts, "FWD_ROWS") == fb.FWD_ROWS == fb.BWD_ROWS == 32
        assert _header_value(consts, "FWD_THREADS") == fb.FWD_ROWS * 8
        assert _header_value(consts, "FWD_MIN_BLOCKS") == 3  # at most 80 registers a thread
        # the forward's staged weights and slot fit the 48 KB of static shared memory
        assert 4 * (_header_value(consts, "N_WF") + _header_value(consts, "LD") * 76) == 18496


# ------------------------------------------------------------- NeuralStates
def test_neural_states_match_jax():
    """``__call__`` on the JAX net's converted params, and the port's own
    init: the JAX tree and shapes, xavier bounds."""
    rng = np.random.default_rng(5)
    jn, tn = JNeuralStates(27, 25, 6, 12), TNeuralStates(27, 25, 6, 12)
    jp = jn.init_params(jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = (rng.standard_normal((3, 4, 6)) + 1.0).astype(np.float32)
    c = rng.standard_normal((3, 4, 21)).astype(np.float32)
    ref = jn(jp, jnp.asarray(x), jnp.asarray(c))
    got = tn(tp, torch.as_tensor(x), torch.as_tensor(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    own = jax.tree_util.tree_map(np.asarray, tn.init_params(torch.Generator().manual_seed(0)))
    assert jax.tree_util.tree_structure(own) == jax.tree_util.tree_structure(jp)
    for name, (n_in, n_out) in (("hidden", (27, 25)), ("prod", (25, 6)), ("degr", (25, 6))):
        assert own[name]["w"].shape == (n_in, n_out)
        assert np.abs(own[name]["w"]).max() <= np.sqrt(6.0 / (n_in + n_out))


# ------------------------------------------------------------- DR_Blackbox
def test_constants_and_initial_state_match_jax(setup):
    """The device offset on the y latents (``condition_theta``), the
    constants [z.., x.., y.., treatments in log1p space, dev_1hot] and the
    10 initial states, from the same theta."""
    _, jdata, _, jmodel, _ = _jax_model()
    _, _, _, tmodel = _port_model()
    jode, tode = jmodel.ode_model, tmodel.ode_model
    host = jdata.train.dataset.select(np.arange(B))
    jb = batch_arrays(host)
    tb = T.batch_tensors(host, slice(None), torch.as_tensor(host.times), "cpu")
    rng = np.random.default_rng(11)
    theta = {k: rng.standard_normal(np.shape(v)).astype(np.float32)
             for k, v in setup["theta"].items()}
    jth = jode.condition_theta(setup["jparams"]["dec"], {k: jnp.asarray(v) for k, v in
                                                         theta.items()}, jb.dev_1hot)
    tth = tode.condition_theta(setup["tparams"]["dec"], {k: torch.as_tensor(v) for k, v in
                                                         theta.items()}, tb.dev_1hot)
    for k in jth:
        np.testing.assert_allclose(tth[k].numpy(), np.asarray(jth[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    jc = jode._constants(jth, jb.inputs, jb.dev_1hot, K)
    tc = tode._constants(tth, tb.inputs, tb.dev_1hot, K)
    assert tc.shape == (B, K, 21)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
    jy = jode.initialize_state(setup["jparams"]["dec"], jth, jb.inputs, B, K)
    ty = tode.initialize_state(setup["tparams"]["dec"], tth, tb.inputs, B, K)
    assert ty.shape == (B, K, S)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6)
    x = np.abs(rng.standard_normal((B, K, NS, 7))).astype(np.float32)
    np.testing.assert_allclose(tode.observe(torch.as_tensor(x), tth).numpy(),
                               np.asarray(jode.observe(jnp.asarray(x), jth)), rtol=1e-6)


def test_params_from_jax_maps_the_blackbox_leaves(setup):
    """The JAX init of dr_blackbox_icml converts leaf for leaf
    (``dec.offset``, ``dec.states.*``, ``dec.precisions.*``), and the port's
    own init has the same tree and shapes."""
    jp, tp = setup["jparams"], setup["tparams"]
    assert set(tp["dec"]) == {"offset", "states", "precisions"}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp["dec"]):
        t = tp["dec"]
        for p in path:
            t = t[p.key]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    own = _port_model()[3].init_params(torch.Generator().manual_seed(0), device="cpu")
    assert (jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), jp)
            == jax.tree_util.tree_map(lambda t: tuple(t.shape), own))


@pytest.mark.parametrize(
    "overrides,kernel",
    [({}, True), ({"n_hidden_decoder_precisions": 0}, False),
     ({"n_hidden_decoder": 30}, False)],
    ids=["shipped", "precision-hidden-0", "other-width"],
)
def test_pallas_route_takes_the_kernel_where_supported(overrides, kernel, monkeypatch):
    """``solver: pallas_midpoint`` goes through ``blackbox_simulate`` for the
    shipped configuration and agrees with the generic midpoint solver; a
    configuration the kernels do not cover takes the generic solver with
    the same method.

    ``precision-hidden-0`` pins a fault of the reference: there
    (``--precision_hidden_layers 0``, vihds_tpu/config.py:176-177) the JAX
    ``DR_Blackbox.simulate`` falls back to ``OdeModel.simulate``, which hands
    ``pallas_midpoint`` to ``ops.solvers.integrate`` and raises "Unknown
    solver" (vihds_tpu/ops/solvers.py:135-142).  The port integrates."""
    _, tdata, tprog, tmodel = _port_model("pallas_midpoint", **overrides)
    ode = tmodel.ode_model
    assert fb.supported(ode) == kernel
    params = tmodel.init_params(torch.Generator().manual_seed(0), device="cpu")["dec"]
    host = tdata.train.dataset.select(np.arange(B))
    tb = T.batch_tensors(host, slice(None), torch.as_tensor(host.times), "cpu")
    u = torch.as_tensor(np.random.default_rng(1).standard_normal((B, K, tprog.n_theta)),
                        dtype=torch.float32)
    th = tprog.theta_dict(tprog.clip(tprog.sample(tprog.prior_q("cpu"), u), stddevs=4))
    th = ode.condition_theta(params, th, tb.dev_1hot)
    calls = []
    orig = fb.blackbox_simulate

    def spy(*a, **k):
        calls.append(k.get("method"))
        return orig(*a, **k)

    monkeypatch.setattr(fb, "blackbox_simulate", spy)
    sol = ode.simulate(params, th, tb.times, tb.inputs, tb.dev_1hot, K)
    assert sol.shape == (B, K, S, len(host.times)) and torch.isfinite(sol).all()
    assert calls == (["midpoint"] if kernel else [])
    ode.solver = "midpoint"
    generic = ode.simulate(params, th, tb.times, tb.inputs, tb.dev_1hot, K)
    torch.testing.assert_close(sol, generic, rtol=2e-5, atol=1e-6)

    if overrides == {"n_hidden_decoder_precisions": 0}:
        _, jdata, jprog, jmodel, jparams = _jax_model("pallas_midpoint", **overrides)
        assert not pallas_blackbox.supported(jmodel.ode_model)
        jb = batch_arrays(jdata.train.dataset.select(np.arange(B)))
        jth = jprog.theta_dict(jprog.clip(jprog.sample(jmodel.encoder(jparams["enc"], jb),
                                                       jnp.asarray(u.numpy())), stddevs=4))
        with pytest.raises(ValueError, match="Unknown solver 'pallas_midpoint'"):
            jmodel.ode_model.simulate(jparams["dec"], jth, jb.times, jb.inputs, jb.dev_1hot, K)


# ------------------------------------------------------------ the eval forward
@pytest.fixture(scope="module")
def forward_pair(setup):
    """Both packages' eval forward on the same params, batch and u: the port
    through ``eval_solver: pallas_midpoint`` (the kernels' plain versions),
    JAX through the midpoint scan (tests/test_pallas.py holds its Pallas
    kernel to it)."""
    _, jdata, jprog, jmodel, jparams = _jax_model()
    _, _, tprog, tmodel = _port_model(eval_solver="pallas_midpoint")
    host = jdata.train.dataset.select(np.arange(B))
    u = np.random.default_rng(7).standard_normal((B, K, jprog.n_theta)).astype(np.float32)
    jb = batch_arrays(host)
    jout = jmodel.forward(jparams, jb, jnp.asarray(u), eval_mode=True)
    jt = j_terms(jprog, jout, jb, jmodel.use_laplace)
    j = dict(x_states=jout.x_states, x_predict=jout.x_predict, precisions=jout.precisions,
             log_w=jt.log_w, log_p_obs=jt.log_p_obs, log_q=jt.log_q, log_p=jt.log_p,
             elbo=j_iwae_elbo(jt), **j_iw(jt, jout))
    tb = T.batch_tensors(host, slice(None), torch.as_tensor(host.times), "cpu")
    with torch.no_grad():
        tout = tmodel.forward(setup["tparams"], tb, torch.as_tensor(u), eval_mode=True)
        tt = T.iwae_elbo_terms(tprog, tout, tb, tmodel.use_laplace)
        t = dict(x_states=tout.x_states, x_predict=tout.x_predict, precisions=tout.precisions,
                 log_w=tt.log_w, log_p_obs=tt.log_p_obs, log_q=tt.log_q, log_p=tt.log_p,
                 elbo=T.iwae_elbo(tt), **T._importance_weighted_outputs(tt, tout))
    return {k: np.asarray(v) for k, v in j.items()}, {k: v.numpy() for k, v in t.items()}


@pytest.mark.parametrize("key", ["x_states", "x_predict", "precisions", "iw_predict_mu",
                                 "iw_predict_std", "iw_states", "iw_variance"])
def test_eval_forward_matches_jax(forward_pair, key):
    j, t = forward_pair
    assert t[key].shape == j[key].shape
    if key == "x_states":
        assert t[key].shape == (B, K, NS, len(t["x_states"][0, 0, 0]))
    if key == "iw_states":
        assert t[key].shape[1] == NS
    np.testing.assert_allclose(t[key], j[key], rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("key", ["log_w", "log_p_obs", "log_q", "log_p", "elbo"])
def test_iwae_terms_match_jax(forward_pair, key):
    j, t = forward_pair
    np.testing.assert_allclose(t[key], j[key], rtol=1e-5, atol=1e-2, err_msg=key)


# ------------------------------------------------------- one training step
@pytest.mark.parametrize("solver", ["midpoint", "pallas_midpoint"],
                         ids=["fold-route", "kernel-route"])
def test_one_step_loss_and_grads_match(solver, monkeypatch):
    """The JAX loss body (fold route: ``forward_logprob``; kernel route:
    ``forward`` through the Pallas kernel in interpret mode, spied as
    tests/test_pallas.py does) against the port's ``training.loss_fn`` on the
    same converted params, batch, mask and draws."""
    _, jdata, jprog, jmodel, jparams = _jax_model(solver)
    rng = np.random.default_rng(7)
    u = rng.standard_normal((B, K, jprog.n_theta)).astype(np.float32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    host = jdata.train.dataset.select(np.arange(B))
    jb = batch_arrays(host)
    calls = []
    if solver.startswith("pallas_"):
        orig = pallas_blackbox.blackbox_simulate

        def spy(*a, **k):
            calls.append(1)
            k["interpret"] = True
            return orig(*a, **k)

        monkeypatch.setattr(pallas_blackbox, "blackbox_simulate", spy)
    fold = jmodel.ode_model.supports_fold()
    assert fold == (solver == "midpoint")

    def loss(params):
        if fold:
            out = jmodel.forward_logprob(params, jb, jnp.asarray(u), checkpoint=True)
            log_p_obs = out.log_p_by_species.sum(axis=2)
            log_q = jprog.log_prob(out.q, out.theta)
            log_p = jprog.log_prob(j_prior_as_q(jprog), out.theta)
            terms = JAttrDict(log_w=log_p_obs + log_p - log_q)
        else:
            out = jmodel.forward(params, jb, jnp.asarray(u), checkpoint=True)
            terms = j_terms(jprog, out, jb, jmodel.use_laplace)
        return -j_iwae_elbo(terms, jnp.asarray(mask))

    j_loss, j_grads = jax.value_and_grad(loss)(jparams)
    assert bool(calls) == (not fold)

    _, _, tprog, tmodel = _port_model(solver)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    for leaf in T.param_leaves(tparams):
        leaf.requires_grad_(True)
    tb = T.batch_tensors(host, slice(None), torch.as_tensor(host.times), "cpu")
    loss_t = T.loss_fn(tmodel, tprog, tparams, tb, torch.as_tensor(mask), torch.as_tensor(u))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(j_loss), rtol=1e-6)
    leaves = jax.tree_util.tree_leaves_with_path(j_grads)
    assert len(leaves) == len(T.param_leaves(tparams))
    for path, g in leaves:
        t = tparams
        for p in path:
            t = t[p.key]
        ref = np.asarray(g)
        assert np.isfinite(ref).all() and np.abs(ref).max() > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------------ the CLI
def test_run_xval_main_trains_dr_blackbox(tmp_results, capsys):
    """Two epochs of the shipped spec (its own ``solver: midpoint``, the
    fold route) at 4 samples: finite ELBOs, the best-validation cache and
    the full ``xval_*`` set, with the 6-state ``iw_states``."""
    from vihds_tpu_torch.xval import XvalMerge

    run_xval.main([spec(SPEC), "--experiment", "bb", "--epochs", "2", "--test_epoch", "1",
                   "--train_samples", "4", "--test_samples", "4", "--seed", "0"], device="cpu")
    out = capsys.readouterr().out
    elbos = [float(v) for v in re.findall(r"iwae-elbo = (\S+),", out)]
    assert len(elbos) == 4 and np.isfinite(elbos).all()
    (run_dir,) = [os.path.join(tmp_results, d) for d in os.listdir(tmp_results)
                  if d.startswith("bb_")]
    names = set(os.listdir(run_dir))
    assert {"completed.txt", SPEC, ".vihds_cache_1_of_4"} <= names
    assert len([n for n in names if n.startswith("xval_")]) == 16
    args = SimpleNamespace(yaml=spec(SPEC), seed=0, folds=4, split=1, heldout=None, epochs=2)
    back = XvalMerge(args, SimpleNamespace(data=None, trainer=None))
    back.load(run_dir)
    assert back.iw_states.shape[1:] == (NS, len(back.times))
    assert np.isfinite(back.iw_predict_mu).all() and list(back.species_names) == [
        "OD", "RFP", "YFP", "CFP"]


# ------------------------------------------------------------------------- #
# The rule chip_smoke.py holds blackbox_bwd to on the card (phase 3): each
# constant's and state's row over the samples, and each weight leaf over its
# entries, against the plain sweep in float64 on the plain float32 sweep's
# relu masks (chip_smoke.bb_references).  The plain float32 sweep, which
# rounds as a float32 kernel does, must pass it; a sweep with one leaf's or
# one state's share 1% off must not.  Operands: dr_blackbox_icml, B=36
# series x K=4 samples, theta from the prior, as phase 3 draws them.
# ------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def card_operands():
    import chip_smoke

    _, _, _, wflat, packed, y0, times, shapes = chip_smoke.blackbox_inputs("cpu", 4, 3)
    wv = fb._split(wflat, shapes)
    traj = fb._plain_fwd(wv, packed, y0, times, NS, "midpoint")
    g = torch.as_tensor(np.random.default_rng(4).standard_normal(tuple(traj.shape)),
                        dtype=torch.float32)
    ref = chip_smoke.bb_references(wv, packed, times, traj, g, NS, "midpoint")[1]
    return wv, packed, times, traj, g, ref, shapes


def _card_ok(operands):
    """(normwise and p99 readings, ok) of the plain float32 sweep, midpoint."""
    import chip_smoke

    wv, packed, times, traj, g, ref, shapes = operands
    dw, dc, dy0 = fb._plain_bwd(wv, packed, times, traj, g, NS, "midpoint")
    norm, rel, ok = chip_smoke.bb_cotangent_readings(torch.cat([x.reshape(-1) for x in dw]), dc,
                                                     dy0, ref, shapes)
    return norm, rel, ok


@pytest.mark.parametrize("method", METHODS)
def test_float32_sweep_is_within_the_card_tolerance(method):
    import chip_smoke

    _, _, _, wflat, packed, y0, times, shapes = chip_smoke.blackbox_inputs("cpu", 4, 3)
    wv = fb._split(wflat, shapes)
    traj = fb._plain_fwd(wv, packed, y0, times, NS, method)
    g = torch.as_tensor(np.random.default_rng(4).standard_normal(tuple(traj.shape)),
                        dtype=torch.float32)
    (dw, dc, dy0), ref, own, flips = chip_smoke.bb_references(wv, packed, times, traj, g, NS,
                                                              method)
    norm, rel, ok = chip_smoke.bb_cotangent_readings(torch.cat([x.reshape(-1) for x in dw]), dc,
                                                     dy0, ref, shapes)
    assert ok, (float(norm.max()), float(rel.max()))
    # no unit flips at this size, so both float64 sweeps agree
    assert flips.shape == (packed.shape[1],) and int(flips.sum()) == 0
    for a, b in zip((*ref[0], ref[1], ref[2]), (*own[0], own[1], own[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", METHODS)
def test_relu_masks_replay_the_recorded_sides(card_operands, method):
    """chip_smoke.ReluMasks: a sweep replaying the masks another sweep
    recorded on the same operands repeats it bit for bit with no flip; with
    every mask inverted it takes the other side of every unit, and counts
    each as flipped."""
    import chip_smoke

    wv, packed, times, traj, g, _, _ = card_operands
    masks = chip_smoke.ReluMasks()
    first = fb._plain_bwd(wv, packed, times, traj, g, NS, method, masks)
    replay = masks.replay()
    again = fb._plain_bwd(wv, packed, times, traj, g, NS, method, replay)
    for a, b in zip((*first[0], first[1], first[2]), (*again[0], again[1], again[2])):
        assert torch.equal(a, b)
    assert int(replay.flips.sum()) == 0
    units = sum(int(m.shape[0]) for m in masks.recorded)
    inverted = chip_smoke.ReluMasks([~m for m in masks.recorded]).replay()
    other = fb._plain_bwd(wv, packed, times, traj, g, NS, method, inverted)
    assert torch.equal(inverted.flips, torch.full_like(inverted.flips, units))
    assert not torch.allclose(other[1], first[1])


@pytest.mark.parametrize("leaf", range(len(fb.WEIGHT_LEAVES)), ids=LEAVES)
def test_card_tolerance_catches_one_leaf_one_percent_off(card_operands, monkeypatch, leaf):
    vjp = fb._bb_rhs_vjp_cols

    def one_percent_off(wv, consts, n_states, t, y, w, acc):
        before = acc["w"][leaf]
        out = vjp(wv, consts, n_states, t, y, w, acc)
        acc["w"][leaf] = before + (acc["w"][leaf] - before) * 1.01
        return out

    monkeypatch.setattr(fb, "_bb_rhs_vjp_cols", one_percent_off)
    norm, rel, ok = _card_ok(card_operands)
    assert not ok
    row = card_operands[1].shape[0] + S + leaf
    assert norm[row] > 1e-4 or rel[row] > 1e-3


@pytest.mark.parametrize("state", range(S))
def test_card_tolerance_catches_one_state_pullback_one_percent_off(card_operands, monkeypatch,
                                                                   state):
    vjp = fb._bb_rhs_vjp_cols

    def one_percent_off(*a):
        out = vjp(*a)
        return torch.cat([out[:state], 1.01 * out[state:state + 1], out[state + 1:]])

    monkeypatch.setattr(fb, "_bb_rhs_vjp_cols", one_percent_off)
    norm, rel, ok = _card_ok(card_operands)
    assert not ok, (float(norm.max()), float(rel.max()))
