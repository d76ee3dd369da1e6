"""The port's simulator (``vihds_tpu_torch.simulate``) against the JAX
package's (``vihds_tpu.simulate``) on the CPU.

The two packages draw from different random streams, so the draws are
handed across: the port's tie of JAX's raw normal draw, its blocked
rejection sampler fed JAX's ``fold_in`` draws, its decode fed the same
clipped theta and JAX's decoder params (carried by the truth npz's
``dec[...]`` keys, ``convert.params_from_keystr``).  Tolerances: the design,
the tie and the writers exactly; theta rtol 1e-6 (float32 exp on two
backends); the decode rtol 2e-5, atol 1e-7 (the generic midpoint solver,
float32 sums in another order); the calibrated center rtol 1e-4, atol 1e-6
after 5 Adam steps.  Two recorded runs of the JAX package under
``reports/`` are decoded again: the reference's own CPU decode of the same
files reaches 3.7e-6 and 3.0e-6 relative in x_noiseless and 2.3e-4 of each
series' largest precision for the learned precisions.

JAX's reference runs are shared through module-scoped fixtures; the
calibrations run at most 20 steps."""

import filecmp
import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import spec
from vihds_tpu import simulate as jsim
from vihds_tpu.config import Config as JConfig
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu_torch import simulate as tsim
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.convert import keystr_leaves, params_from_keystr
from vihds_tpu_torch.data.datasets import build_datasets as t_build
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.run_xval import create_parser as t_run_parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the flags of the JAX package's tests/test_simulate.py with regime
#: conditioning and calibration
FLAGS_ONE = ["--n_per_device", "6", "--sigma_scale", "0.5", "--seed", "1",
             "--max_scaled", "2.0", "--calibrate_target", "1.0"]
CAL_STEPS = 5


def _both(spec_name, n_per_device=None, seed=0):
    """Both packages' settings, programs and the (resampled) design."""
    argv = [spec(spec_name), "--output_dir", "unused"]
    jset = JConfig(jsim.create_parser().parse_args(argv))
    tset = TConfig(tsim.create_parser().parse_args(argv))
    jprog = JProgram(j_parse(jset.params))
    tprog = TProgram(t_parse(tset.params))
    design = tsim.load_design(tset)
    if n_per_device:
        design = tsim.resample_design(design[0], design[1], n_per_device, seed) + (design[2],)
    return SimpleNamespace(jset=jset, tset=tset, jprog=jprog, tprog=tprog, design=design)


def _npz_layout(path):
    z = np.load(path, allow_pickle=True)
    return {k: (z[k].shape, z[k].dtype) for k in z.files}


@pytest.fixture(scope="module")
def one():
    """dr_constant_one on the design of FLAGS_ONE (6 series)."""
    return _both("dr_constant_one.yaml", 6, 1)


@pytest.fixture(scope="module")
def jax_run_one(tmp_path_factory):
    """The JAX package's simulator at FLAGS_ONE with its calibration cut to
    CAL_STEPS steps; records the calibration's (center, peak)."""
    recorded = {}
    calibrate = jsim.calibrate_shared_center

    def recording(*a, **kw):
        recorded["result"] = calibrate(*a, **dict(kw, steps=CAL_STEPS))
        return recorded["result"]

    out_dir = tmp_path_factory.mktemp("jax_one")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsim, "calibrate_shared_center", recording)
        out = jsim.simulate(jsim.create_parser().parse_args(
            [spec("dr_constant_one.yaml"), "--output_dir", str(out_dir)] + FLAGS_ONE))
    return out, recorded["result"]


@pytest.fixture(scope="module")
def port_run_one(tmp_path_factory):
    """The port's ``main`` at FLAGS_ONE on the CPU, its calibration cut to 20
    steps."""
    out_dir = tmp_path_factory.mktemp("port_one")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsim, "calibrate_shared_center",
                   functools.partial(tsim.calibrate_shared_center, steps=20))
        mp.setenv("INFERENCE_RESULTS_DIR", str(out_dir))
        return tsim.main([spec("dr_constant_one.yaml"), "--output_dir", str(out_dir)]
                         + FLAGS_ONE, device="cpu")


def test_design_and_resample_equal_jax():
    b = _both("dr_constant_precisions.yaml")
    jd = jsim.load_design(b.jset)
    td = tsim.load_design(b.tset)
    for j, t in zip(jd, td):
        assert j.dtype == t.dtype
        np.testing.assert_array_equal(j, t)
    jr = jsim.resample_design(jd[0], jd[1], 2, 0)
    tr = tsim.resample_design(td[0], td[1], 2, 0)
    assert len(np.unique(tr[0])) == 6 and len(tr[0]) == 12
    for j, t in zip(jr, tr):
        np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("spec_name", ["dr_constant_precisions.yaml", "dr_blackbox_icml.yaml"])
@pytest.mark.parametrize("centered", [False, True])
def test_tie_of_jax_draw_equals_jax(spec_name, centered):
    """The tie of JAX's raw draw equals ``_tied_normal_u`` exactly, with and
    without a center (dr_blackbox_icml ties its global_conditioned sites per
    device over six devices); ``_theta_from_u`` agrees at rtol 1e-6."""
    b = _both(spec_name, 2, 0)
    devices = b.design[0]
    key = jax.random.PRNGKey(3)
    xi = np.array(jax.random.normal(key, (len(devices), 1, b.jprog.n_theta), jnp.float32))
    center = None
    if centered:
        center = np.random.default_rng(4).standard_normal(b.jprog.n_theta).astype(np.float32)
        center[b.jprog.local_slice] = 0.0
    want = jsim._tied_normal_u(b.jprog, devices, key, center=center)
    got = tsim.tie(b.tprog, devices, xi, center=center)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    gc = b.tprog.global_cond_slice
    if gc.stop > gc.start:
        assert len({tuple(r) for r in got[:, 0, gc]}) == len(np.unique(devices))
    for j, t in zip(jsim._theta_from_u(b.jprog, want, 0.5), tsim._theta_from_u(b.tprog, got, 0.5)):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def decoders():
    """Both packages' decoders of dr_constant_precisions on 12 series (two a
    device) in both eval modes, the port's on JAX's params carried through
    the truth npz's keys; and a clipped theta to decode."""
    b = _both("dr_constant_precisions.yaml", 2, 0)
    devices, treatments, times = b.design
    out = {}
    for eval_mode in (True, False):
        _, jparams, jdecode = jsim.make_decoder(b.jset, b.jprog, devices, treatments, times,
                                                jax.random.PRNGKey(5), eval_mode=eval_mode)
        flat = {"dec" + jax.tree_util.keystr(kp): np.asarray(leaf)
                for kp, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
        tparams = params_from_keystr(flat, device="cpu")
        _, _, tdecode = tsim.make_decoder(b.tset, b.tprog, devices, treatments, times, None,
                                          eval_mode=eval_mode, device="cpu", params_dec=tparams)
        out[eval_mode] = (jdecode, tdecode, flat, tparams)
    _, clipped = jsim.sample_truth_theta(b.jprog, devices, jax.random.PRNGKey(6), 0.5)
    return out, clipped


def test_decoder_params_carry_across_the_npz_keys(decoders):
    """``params_from_keystr`` reads the reference's ``dec[...]`` keys into
    the port's tree and ``keystr_leaves`` writes them back letter for
    letter."""
    _, _, flat, tparams = decoders[0][True]
    assert sorted(tparams) == ["cond_aR", "cond_aS", "precisions"]
    assert tparams["precisions"]["prod"]["w"].shape == (9, 4)
    back = keystr_leaves(tparams)
    assert list(back) == list(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("eval_mode", [True, False])
def test_decode_equals_jax(decoders, eval_mode):
    jdecode, tdecode, _, _ = decoders[0][eval_mode]
    clipped = decoders[1]
    jx, jp = (np.asarray(a) for a in jdecode(jnp.asarray(clipped)))
    tx, tp = tdecode(clipped)
    tx, tp = tx.detach().numpy(), tp.detach().numpy()
    assert tx.shape == jx.shape == (12, 1, 4, 86)
    np.testing.assert_allclose(tx, jx, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(tp, jp, rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("report, spec_name", [
    ("recovery_study", "dr_constant_one.yaml"),
    ("recovery_precisions", "dr_constant_precisions.yaml"),
])
def test_recorded_truth_decodes_again(report, spec_name):
    """The port's CPU decode of a recorded truth npz (its clipped theta, its
    design, its ``dec[...]`` params) against the x_noiseless and precisions
    the JAX package recorded."""
    z = np.load(os.path.join(REPO, "reports", report, "synthetic_truth.npz"), allow_pickle=True)
    b = _both(spec_name)
    assert list(z["theta_names"]) == b.tprog.names
    _, _, decode = tsim.make_decoder(b.tset, b.tprog, z["devices"], z["treatments"], z["times"],
                                     None, device="cpu",
                                     params_dec=params_from_keystr(z, device="cpu"))
    x, prec = decode(z["theta_clipped"][:, None, :])
    x = x.numpy()[:, 0]
    prec = torch.broadcast_to(prec, (x.shape[0], 1) + x.shape[1:]).numpy()[:, 0]
    np.testing.assert_allclose(x, z["x_noiseless"], rtol=2e-5, atol=0)
    if report == "recovery_study":
        np.testing.assert_array_equal(prec, z["precisions"])
    else:
        scale = np.abs(z["precisions"]).max(axis=(1, 2), keepdims=True)
        assert (np.abs(prec - z["precisions"]) <= 1e-3 * scale).all()


@pytest.mark.parametrize("laplace", [False, True])
def test_noise_with_injected_eps_is_the_reference_formula(laplace):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((5, 1, 4, 7)).astype(np.float32)
    prec = np.exp(rng.standard_normal((5, 1, 4, 1))).astype(np.float32)
    eps = rng.standard_normal(x.shape).astype(np.float32)
    model = SimpleNamespace(use_laplace=laplace)
    obs, p = tsim.add_observation_noise(model, torch.as_tensor(x), torch.as_tensor(prec), eps=eps)
    # vihds_tpu/simulate.py's formulas, on the same eps
    want = x + eps / prec if laplace else x + eps / jnp.sqrt(prec)
    np.testing.assert_array_equal(obs, np.asarray(want)[:, 0])
    np.testing.assert_array_equal(p, np.broadcast_to(prec, x.shape)[:, 0])
    # drawn from a generator: the same seed gives the same noise
    a = tsim.add_observation_noise(model, torch.as_tensor(x), torch.as_tensor(prec),
                                   tsim.generator(0, tsim.STREAM_NOISE))[0]
    b = tsim.add_observation_noise(model, torch.as_tensor(x), torch.as_tensor(prec),
                                   tsim.generator(0, tsim.STREAM_NOISE))[0]
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and not np.array_equal(a, x[:, 0])


def test_rejection_sampler_on_jax_draws(one):
    """dr_constant_one, 6 series, seed 1, max_scaled 2 (tests/test_simulate.py's
    case): the port's sampler on JAX's own draws accepts the same attempt
    and round as the JAX package's."""
    devices, treatments, times = one.design
    _, _, jdecode = jsim.make_decoder(one.jset, one.jprog, devices, treatments, times,
                                      jax.random.PRNGKey(0))
    _, _, tdecode = tsim.make_decoder(one.tset, one.tprog, devices, treatments, times,
                                      torch.Generator(), device="cpu")
    k_theta = jax.random.split(jax.random.PRNGKey(1))[0]
    jt, jc, js = jsim.sample_truth_theta_in_regime(
        one.jprog, devices, k_theta, 0.5, 2.0,
        noiseless_fn=lambda c: jdecode(jnp.asarray(c))[0])

    def jax_draw(attempt, rnd=None):
        k_a = jax.random.fold_in(k_theta, attempt) if attempt else k_theta
        k = k_a if rnd is None else jax.random.fold_in(k_a, 10000 + rnd)
        return np.array(jax.random.normal(k, (len(devices), 1, one.tprog.n_theta), jnp.float32))

    tt, tc, ts = tsim.sample_truth_theta_in_regime(
        one.tprog, devices, jax_draw, 0.5, 2.0, noiseless_fn=lambda c: tdecode(c)[0])
    np.testing.assert_allclose(tt, jt, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=0)
    assert ts["truth_attempt"] == js["truth_attempt"] >= 1
    assert ts["local_rounds"] == js["local_rounds"] >= 1
    for k in ("probe_peak", "noiseless_peak"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5)
    assert ts["probe_peak"] <= 2.0 and ts["noiseless_peak"] <= 2.0


def test_calibration_equals_jax(one, jax_run_one):
    """CAL_STEPS Adam steps on the probe's log peak through the train-mode
    decode, against the JAX package's in its FLAGS_ONE run."""
    j_center, j_peak = jax_run_one[1]
    devices, treatments, times = one.design
    _, _, decode = tsim.make_decoder(one.tset, one.tprog, devices, treatments, times,
                                     torch.Generator(), eval_mode=False, device="cpu")
    center, peak = tsim.calibrate_shared_center(
        one.tprog, len(devices), lambda c: decode(c)[0], 0.5, 1.0, steps=CAL_STEPS)
    assert center.dtype == np.float32
    np.testing.assert_allclose(center, j_center, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(peak, j_peak, rtol=1e-4)
    assert (center[one.tprog.local_slice] == 0).all()
    assert (center[one.tprog.constant_slice] == 0).all()
    assert np.abs(center[one.tprog.global_slice]).max() > 0


def test_writers_are_byte_identical(one, tmp_path):
    devices, treatments, times = one.design
    raw = np.random.default_rng(9).standard_normal((len(devices), 4, len(times)))
    raw = (raw * 1e3).astype(np.float32)
    csv_path = str(tmp_path / "synthetic.csv")
    scales = [1.5, 2.0e4, 3.25, 7.0e3]
    for name, mod, settings in (("jax", jsim, one.jset), ("port", tsim, one.tset)):
        mod.write_csv(str(tmp_path / (name + ".csv")), settings, devices, treatments, times, raw)
        mod.write_derived_spec(str(tmp_path / (name + ".yaml")), spec("dr_constant_one.yaml"),
                               csv_path, scales)
    for ext in ("csv", "yaml"):
        assert filecmp.cmp(tmp_path / ("jax." + ext), tmp_path / ("port." + ext), shallow=False)


def test_simulated_csv_reloads_to_the_observations(port_run_one):
    """The written CSV and derived spec reload through the port's pipeline to
    the simulated observations (normalize pinned, background subtraction
    off); the truth is in regime and shares its global sites."""
    out = port_run_one
    args = t_run_parser(True).parse_args([out.spec])
    args.seed, args.folds = 0, 2
    settings = TConfig(args)
    assert settings.data.normalize == [float(s) for s in out.scales]
    assert settings.data.subtract_background is False
    ds = t_build(args, settings).train.dataset
    assert ds.observations.shape == out.observations.shape == (6, 4, len(out.times))
    np.testing.assert_allclose(ds.observations, out.observations, rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(ds.times, out.times)
    np.testing.assert_allclose(ds.inputs, np.log1p(out.treatments), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ds.devices, out.devices)

    truth = np.load(out.truth, allow_pickle=True)
    assert list(truth["theta_names"]) == out.program.names
    g = out.program.global_slice
    np.testing.assert_array_equal(truth["theta"][:, g],
                                  np.broadcast_to(truth["theta"][0:1, g], truth["theta"][:, g].shape))
    assert np.ptp(truth["theta"][:, out.program.local_slice], axis=0).max() > 0
    assert float(truth["probe_peak"]) <= 2.0 and float(truth["noiseless_peak"]) <= 2.0
    assert (np.max(np.abs(truth["x_noiseless"]), axis=(1, 2)) <= 2.0).all()
    # 20 steps move the probe peak from the prior center's ~6x toward the target
    assert 1.0 < float(truth["calibrated_peak"]) < 6.0
    assert (truth["u_center"][out.program.local_slice] == 0).all()
    assert not np.allclose(truth["x_noiseless"], out.observations)


@pytest.mark.parametrize("case", ["dr_constant_one", "dr_constant_precisions"])
def test_truth_npz_layout_equals_jax(case, jax_run_one, port_run_one, tmp_path, monkeypatch):
    """The truth npz's keys (``dec[...]`` among them), shapes and dtypes are
    the JAX package's at the same flags."""
    monkeypatch.setenv("INFERENCE_RESULTS_DIR", str(tmp_path))
    if case == "dr_constant_one":
        jpath, tpath = jax_run_one[0].truth, port_run_one.truth
    else:
        argv = [spec("dr_constant_precisions.yaml"), "--n_per_device", "1", "--seed", "2"]
        jpath = jsim.simulate(jsim.create_parser().parse_args(
            argv + ["--output_dir", str(tmp_path / "jax")])).truth
        tpath = tsim.main(argv + ["--output_dir", str(tmp_path / "port")], device="cpu").truth
    want, got = _npz_layout(jpath), _npz_layout(tpath)
    assert list(got) == list(want)
    assert got == want
    if case == "dr_constant_precisions":
        assert "dec['precisions']['prod']['w']" in got


def test_simulate_needs_a_card_unless_the_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.main([spec("dr_constant_one.yaml"), "--output_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
