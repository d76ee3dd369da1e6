"""The port's serving slice end to end on the CPU, against the JAX package.

``VAE.forward`` -> ``iwae_elbo_terms`` -> ``_importance_weighted_outputs``
in the port, with ``eval_solver: pallas_midpoint`` (the fused route; its
plain version on the CPU), is held against the JAX package with
``eval_solver`` unset (the midpoint ``lax.scan``, which tests/test_pallas.py
shows equals the Pallas kernel), on the same converted params and the same
numpy draws u.  Tolerance: rtol 1e-4 on trajectories and moments, and on
log-weights rtol 1e-5 with atol 1e-2 nats (log-likelihood sums of ~1e3-1e4
nats over 86 points x 4 signals in float32, summed in another order).

Also here: ``predict()`` end to end, the absence of JAX in the port, and the
refusal to fall back to the CPU when no card is visible."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_args, spec
from vihds_tpu.config import Config as JConfig
from vihds_tpu.data.datasets import build_datasets as j_build
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu.training import _importance_weighted_outputs as j_iw
from vihds_tpu.training import batch_arrays, iwae_elbo as j_iwae_elbo
from vihds_tpu.training import iwae_elbo_terms as j_terms
from vihds_tpu.vae import VAE as JVAE
from vihds_tpu_torch import predict as TP
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.convert import params_from_jax
from vihds_tpu_torch.data.datasets import build_datasets as t_build
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.training import Training
from vihds_tpu_torch.training import _importance_weighted_outputs as t_iw
from vihds_tpu_torch.training import batch_tensors, eval_step, iwae_elbo as t_iwae_elbo
from vihds_tpu_torch.training import iwae_elbo_terms as t_terms
from vihds_tpu_torch.vae import VAE as TVAE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
SPECS = ["dr_constant_one.yaml", "dr_constant_icml.yaml", "dr_constant_v2.yaml",
         "dr_constant_precisions.yaml", "dr_constant_precisions_v2.yaml",
         "relay_constant_precisions.yaml", "degrader_constant_precisions.yaml"]
B, K = 3, 4


def _port(spec_name, eval_solver="pallas_midpoint"):
    targs = SimpleNamespace(yaml=spec(spec_name), seed=0, folds=4, split=1, heldout=None)
    tset = TConfig(targs)
    tset.params.eval_solver = eval_solver
    tdata = t_build(targs, tset)
    tprog = TProgram(t_parse(tset.params))
    return tset, tdata, tprog, TVAE(tset, tdata, tprog)


def _jax(spec_name):
    args = make_args(spec(spec_name))
    jset = JConfig(args)
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    jmodel = JVAE(jset, jdata, jprog)
    return jset, jdata, jprog, jmodel, jmodel.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=SPECS)
def forward_pair(request):
    """Both packages' eval forward on the same params, batch and u."""
    jset, jdata, jprog, jmodel, jparams = _jax(request.param)
    assert "eval_solver" not in jset.params  # JAX side: the midpoint scan
    tset, tdata, tprog, tmodel = _port(request.param)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")

    host = jdata.train.dataset.select(np.arange(B))
    u = np.random.default_rng(7).standard_normal((B, K, jprog.n_theta)).astype(np.float32)

    jbatch = batch_arrays(host)
    jout = jmodel.forward(jparams, jbatch, jnp.asarray(u), eval_mode=True)
    jt = j_terms(jprog, jout, jbatch, jmodel.use_laplace)
    j = dict(
        x_states=jout.x_states, x_predict=jout.x_predict, log_w=jt.log_w,
        log_p_obs=jt.log_p_obs, log_q=jt.log_q, log_p=jt.log_p,
        elbo=j_iwae_elbo(jt), **j_iw(jt, jout),
    )
    times = torch.as_tensor(host.times)
    tbatch = batch_tensors(host, slice(None), times, "cpu")
    with torch.no_grad():
        tout = tmodel.forward(tparams, tbatch, torch.as_tensor(u), eval_mode=True)
        tt = t_terms(tprog, tout, tbatch, tmodel.use_laplace)
        t = dict(
            x_states=tout.x_states, x_predict=tout.x_predict, log_w=tt.log_w,
            log_p_obs=tt.log_p_obs, log_q=tt.log_q, log_p=tt.log_p,
            elbo=t_iwae_elbo(tt), **t_iw(tt, tout),
        )
        step = eval_step(tmodel, tprog, tparams, tbatch, K, u=torch.as_tensor(u))
    j["n_species"] = jmodel.ode_model.n_species
    return (
        {k: np.asarray(v) for k, v in j.items()},
        {k: v.numpy() for k, v in t.items()},
        {k: v.numpy() for k, v in step.items()},
    )


def test_forward_trajectories_match(forward_pair):
    j, t, _ = forward_pair
    S = int(j["n_species"])
    assert t["x_states"].shape == j["x_states"].shape == (B, K, S, j["x_states"].shape[-1])
    for k in ("x_states", "x_predict"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_iwae_terms_match(forward_pair):
    j, t, _ = forward_pair
    for k in ("log_w", "log_p_obs", "log_q", "log_p", "elbo"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=1e-2, err_msg=k)


def test_importance_weighted_moments_match(forward_pair):
    j, t, step = forward_pair
    for k in ("iw_predict_mu", "iw_predict_std", "iw_states", "iw_variance"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)
        # eval_step with an injected u is the same computation
        np.testing.assert_array_equal(step[k], t[k])
    np.testing.assert_allclose(
        step["per_item_elbo"].mean(), j["elbo"], rtol=1e-5, atol=1e-2
    )


def test_predict_end_to_end_on_cpu(tmp_path):
    """predict() on a new CSV writes the JAX package's npz key set, and the
    amortised q equals the JAX encoder's on the same rows."""
    from vihds_tpu.predict import load_new_data as j_load_new_data

    jset, jdata, jprog, jmodel, jparams = _jax("dr_constant_one.yaml")
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    csv = os.path.join(DATA, "proc141006.csv")
    args = TP.create_parser().parse_args(
        [spec("dr_constant_one.yaml"), "--data", csv, "--test_samples", "4", "--save_theta",
         "--treatments", "C6=25000;C12=0"]
    )
    settings = TConfig(args)
    settings.params.eval_solver = "pallas_midpoint"
    out = TP.predict(args, settings, params=tparams, device="cpu")
    path = str(tmp_path / "pred.npz")
    TP.save_predictions(path, out, args, settings)
    z = np.load(path, allow_pickle=True)
    for k in (
        "iw_predict_mu", "iw_predict_std", "iw_states", "iw_variance",
        "per_item_elbo", "elbo", "q_mu", "q_prec", "q_names",
        "species_names", "devices", "device_names", "inputs",
        "observations", "times", "scales", "checkpoint_epoch", "theta",
        "cf0_spec", "cf0_inputs", "cf0_iw_predict_mu", "cf0_iw_predict_std",
        "cf0_iw_states", "cf0_iw_variance",
    ):
        assert k in z, k
    n, S, T = out.host.observations.shape
    assert n > jset.params.n_batch  # more than one evaluation chunk, with padding
    assert z["theta"].shape == (jprog.n_theta, n, 4)
    assert z["iw_predict_mu"].shape == (n, 4, T) and np.isfinite(z["iw_predict_mu"]).all()
    assert np.isfinite(float(z["elbo"])) and np.isfinite(z["cf0_iw_predict_mu"]).all()

    jhost = j_load_new_data([csv], jset, jdata.train.dataset)
    jq = jmodel.encoder(jparams["enc"], batch_arrays(jhost))
    np.testing.assert_allclose(z["q_mu"], np.asarray(jq.mu), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(z["q_prec"], np.asarray(jq.prec), rtol=1e-5, atol=1e-6)


def test_evaluate_chunks_like_one_batch():
    """Chunked evaluation (n_batch rows at a time, the last chunk padded)
    reproduces the per-series results of one unchunked eval_step with the
    same draws."""
    tset, tdata, tprog, tmodel = _port("dr_constant_one.yaml")
    params = tmodel.init_params(torch.Generator().manual_seed(0), device="cpu")
    training = Training(tset, tdata, tprog, tmodel)
    training.n_batch = 4
    host = tdata.train.dataset.select(np.arange(10))
    merged, results = training.evaluate(params, host, 3, torch.Generator().manual_seed(5), "cpu")
    # the same draws, in one batch: chunks of 4 consume u in row order
    gen = torch.Generator().manual_seed(5)
    u = torch.cat([torch.randn((4, 3, tprog.n_theta), generator=gen) for _ in range(3)])[:10]
    batch = batch_tensors(host, slice(None), torch.as_tensor(host.times), "cpu")
    with torch.no_grad():
        one = eval_step(tmodel, tprog, params, batch, 3, u=u)
    np.testing.assert_allclose(merged.per_item_elbo, one["per_item_elbo"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(merged.iw_predict_mu, one["iw_predict_mu"].numpy(), rtol=1e-6)
    assert merged.theta.shape == (tprog.n_theta, 10, 3)
    assert results.iw_states.shape == (10, 8, len(host.times))


def test_unknown_model_lists_available():
    tset, tdata, tprog, _ = _port("dr_constant_one.yaml")
    tset.model = "no_such_model"
    with pytest.raises(ValueError, match="'no_such_model'; available: auto_constant, "
                                         "auto_constant_precisions, debug_constant, "
                                         "degrader_constant, degrader_constant_precisions, "
                                         "dr_blackbox, dr_constant, "
                                         "dr_constant_precisions, dr_constant_precisions_v2, "
                                         "dr_constant_v2, dr_growthrate, inducer_constant, "
                                         "inducer_constant_precisions, prpr_constant, "
                                         "prpr_constant_precisions, relay_constant, "
                                         "relay_constant_precisions$"):
        TVAE(tset, tdata, tprog)


def test_port_imports_no_jax():
    """A fresh interpreter that imports the port's serving path, the
    simulator, the recovery study, the samplers (and chip_smoke.py) has
    neither jax nor vihds_tpu in sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import vihds_tpu_torch.predict, vihds_tpu_torch.convert, vihds_tpu_torch.run_xval\n"
        "import vihds_tpu_torch.checkpoint, vihds_tpu_torch.call_run_xval, chip_smoke\n"
        "import vihds_tpu_torch.models.dr_blackbox, vihds_tpu_torch.ops.fused_blackbox\n"
        "import vihds_tpu_torch.simulate, vihds_tpu_torch.recovery_study\n"
        "import vihds_tpu_torch.refine\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vihds_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n" % REPO
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "clean" in r.stdout


def test_port_sources_never_import_jax():
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|vihds_tpu)(\s|\.|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "vihds_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert len(files) > 15 and not offenders, offenders


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is usable")


def _predict_default_device():
    tset, tdata, tprog, tmodel = _port("dr_constant_one.yaml")
    params = tmodel.init_params(torch.Generator().manual_seed(0), device="cpu")
    args = TP.create_parser().parse_args(
        [spec("dr_constant_one.yaml"), "--data", os.path.join(DATA, "proc141006.csv")]
    )
    TP.predict(args, params=params)


def _evaluate_default_device():
    tset, tdata, tprog, tmodel = _port("dr_constant_one.yaml")
    params = tmodel.init_params(torch.Generator().manual_seed(0), device="cpu")
    Training(tset, tdata, tprog, tmodel).evaluate(
        params, tdata.train.dataset.select(np.arange(2)), 2, torch.Generator()
    )


def _init_default_device():
    _port("dr_constant_one.yaml")[3].init_params(torch.Generator())


def _convert_default_device():
    params_from_jax({"w": np.zeros((2, 2), np.float32)})


def _run_xval_default_device():
    from vihds_tpu_torch import run_xval

    run_xval.main([spec("dr_constant_one.yaml"), "--epochs", "1", "--train_samples", "2",
                   "--test_samples", "2"])


def _train_default_device():
    from vihds_tpu_torch import run_xval

    tset, tdata, tprog, tmodel = _port("dr_constant_one.yaml")
    args = run_xval.create_parser(True).parse_args(
        [spec("dr_constant_one.yaml"), "--epochs", "1", "--train_samples", "2"]
    )
    Training(tset, tdata, tprog, tmodel, args=args).run()


@pytest.mark.parametrize(
    "entry",
    [_predict_default_device, _evaluate_default_device, _init_default_device,
     _convert_default_device, _run_xval_default_device, _train_default_device],
    ids=["predict", "evaluate", "init_params", "params_from_jax", "run_xval", "train"],
)
def test_entry_points_do_not_fall_back_to_cpu(entry, tmp_results):
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def _run_chip_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          timeout=300, cwd=cwd, env=env)


def test_chip_smoke_fails_without_cuda():
    _no_cuda()
    r = _run_chip_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    r = _run_chip_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
