"""The port's sampler tools (``vihds_tpu_torch.tools.refine_demo``,
``ar_mu_ground_truth``, ``icml_site_mechanism``) against the JAX package's
scripts under ``tools/`` on the CPU.

* ``refine_demo.refine`` on dr_constant_one's first 3 test series, the JAX
  package's initial params converted, against the JAX tool's calls into
  ``vihds_tpu`` (IWAE at ``PRNGKey(7)``, ``smc_refine``, ``hmc_refine`` on
  the same key), the port replaying each sampler's key schedule
  (``tests.test_torch_refine.JaxKeys``): IWAE (through the ODE) rtol 1e-5,
  the SMC log-evidence and the HMC traces rtol 1e-4 / atol 1e-6, each
  Metropolis decision equal where it lies further than 1e-4 from its
  threshold (the limits of tests/test_torch_refine.py).  The samplers run
  on that file's analytic likelihood in both packages, as there: at
  initial params the ODE's log-joint is of order -1e8 and NaN where a
  chain leaves the solver's range, and a JAX sampler through the ODE takes
  minutes to compile (tests/test_torch_refine_model.py holds the ODE's
  log-joint and its gradient).
* ``split_rhat`` and ``_ess`` bit-equal to the JAX tool's on random arrays.
* The ground-truth and ridge summaries against the JAX tools' arithmetic on
  one shared trace, rtol 1e-6: the JAX scripts run with their training and
  sampler replaced by stand-ins that hand in that trace (monkeypatched;
  nothing under ``vihds_tpu/`` or ``tools/`` changes).
* ``report`` writes the JAX tool's REPORT.md byte for byte on a copy of
  ``reports/ar_mu_ground_truth_r5`` and a run of the port's summary."""

import glob
import math
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_args, spec
from tests.test_torch_refine import (JaxKeys, _first_close_step, _jax_lik, _pair, _torch_lik,
                                     _torch_setup, hmc_keys, smc_keys)
from tests.test_torch_tools_parity import jax_tool
from vihds_tpu import refine as jref
from vihds_tpu import training as jtraining
from vihds_tpu.config import Config as JConfig
from vihds_tpu.data.datasets import build_datasets as j_build
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu.training import batch_arrays
from vihds_tpu.utils import AttrDict
from vihds_tpu.vae import VAE as JVAE
from vihds_tpu_torch import refine as tref
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.tools import ar_mu_ground_truth, icml_site_mechanism, refine_demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-6
N_SERIES, K = 3, 4
SMC_KW = dict(n_temps=2, n_moves=2)
N_STEPS = 4


@pytest.fixture(scope="module")
def demo():
    """The JAX tool's three computations and the port's ``refine`` on the
    same problem and keys: (JAX's, the port's, the port's Metropolis
    records, JAX's log alphas)."""
    args = make_args(spec("dr_constant_one.yaml"))
    jset = JConfig(args)
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    jmodel = JVAE(jset, jdata, jprog)
    jparams = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    host = jdata.test.dataset.select(jdata.test.indices[:N_SERIES])
    jbatch = batch_arrays(host)
    tprog, tmodel, tparams, tbatch = _torch_setup(spec("dr_constant_one.yaml"), jparams, host)
    key = jax.random.PRNGKey(7)
    # tests/test_torch_refine.py's analytic likelihood
    movable = ~jprog.is_constant
    weight = np.where(movable, 2.0, 0.0).astype(np.float32)
    center = np.where(jprog.is_lognormal, np.exp(jprog.prior_mu), jprog.prior_mu)
    target = (np.arcsinh(center) + 0.3).astype(np.float32)

    recorded = []
    nan_to_num = jnp.nan_to_num

    def spy(x, *a, **k):
        jax.debug.callback(lambda v: recorded.append(np.asarray(v)), x, ordered=True)
        return nan_to_num(x, *a, **k)

    def jax_side(params, batch, key):
        # tools/refine_demo.py's calls
        u = jmodel.sample_u(key, N_SERIES, K)
        out = jmodel.forward(params, batch, u)
        terms = jtraining.iwae_elbo_terms(jprog, out, batch, jmodel.use_laplace)
        iwae = jax.scipy.special.logsumexp(terms.log_w, axis=1) - np.log(K)
        smc = jref.smc_refine(jmodel, jprog, params, batch, key, n_particles=K, **SMC_KW)
        hmc = jref.hmc_refine(jmodel, jprog, params, batch, key, n_chains=K, n_steps=N_STEPS)
        return iwae, smc, hmc

    port_records = []
    accept = tref._accept

    def port_accept(draws, name, log_alpha, *index):
        out = accept(draws, name, log_alpha, *index)
        port_records.append((name, index, np.log(draws.uniforms[(name,) + index]),
                             log_alpha.numpy().copy()))
        return out

    draws = dict(iwae=JaxKeys(lambda name, *index: key),
                 smc=JaxKeys(smc_keys(key, SMC_KW["n_temps"], SMC_KW["n_moves"], N_SERIES)),
                 hmc=JaxKeys(hmc_keys(key, N_STEPS)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jref, "make_log_lik", _jax_lik(weight, target))
        mp.setattr(tref, "make_log_lik", _torch_lik(weight, target))
        mp.setattr(jnp, "nan_to_num", spy)
        want = jax.jit(jax_side)(jparams, jbatch, key)
        jax.effects_barrier()
        mp.setattr(tref, "_accept", port_accept)
        got = refine_demo.refine(tmodel, tprog, tparams, tbatch, draws, K, n_steps=N_STEPS,
                                 **SMC_KW)
    return want, got, port_records, recorded


def test_refine_demo_core_matches_the_jax_tools_calls(demo, capsys):
    (j_iwae, j_smc, j_hmc), (iwae, smc, hmc), port, jax_alphas = demo
    np.testing.assert_allclose(iwae.numpy(), np.asarray(j_iwae), rtol=1e-5)
    smc_records = [r for r in port if len(r[1]) == 2]
    hmc_records = [r for r in port if len(r[1]) == 1]
    assert len(smc_records) == SMC_KW["n_temps"] * SMC_KW["n_moves"]
    assert len(hmc_records) == N_STEPS
    # SMC's moves take no nan_to_num: their decisions read the port's alphas
    assert _first_close_step(smc_records, None) is None
    np.testing.assert_allclose(smc.log_evidence.numpy(), np.asarray(j_smc.log_evidence),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(smc.ess_trace.numpy(), np.asarray(j_smc.ess_trace),
                               rtol=RTOL, atol=ATOL)
    assert _first_close_step(hmc_records, _pair(hmc_records, jax_alphas, (2,))) is None
    for name in ("log_joint_trace", "z", "accept_rate", "step_size"):
        np.testing.assert_allclose(getattr(hmc, name).numpy(), np.asarray(getattr(j_hmc, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    shown = refine_demo.report(N_SERIES, iwae, smc, hmc)
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "per-datapoint bounds (first 3 validation series):"
    assert lines[2].startswith("  amortised IWAE:  mean ")
    np.testing.assert_allclose(float(lines[2].split()[-1]), float(np.asarray(j_iwae).mean()),
                               rtol=1e-5)
    assert all(math.isfinite(v) for v in shown.values())


@pytest.mark.parametrize("shape", [(40, 4), (301, 16), (7, 1)])
def test_split_rhat_and_ess_are_the_jax_tools_bit_for_bit(shape):
    jt = jax_tool("ar_mu_ground_truth")
    rng = np.random.default_rng(shape[0])
    walk = np.cumsum(rng.standard_normal(shape), axis=0).astype(np.float32)
    for x in (walk, rng.standard_normal(shape).astype(np.float32)):
        if shape[1] > 1:
            assert ar_mu_ground_truth.split_rhat(x) == jt.split_rhat(x)
        assert ar_mu_ground_truth._ess(x) == jt._ess(x)


class _Training:
    """Stands in for ``vihds_tpu.training.Training`` in the JAX tools: no
    training, the JAX package's initial params."""

    def __init__(self, args, settings, data, program, model):
        self.model = model

    def run(self):
        self.final_params = self.model.init_params(jax.random.PRNGKey(0))
        return SimpleNamespace(elbo=np.float32(321.5))


def _trace(shape, seed, walk=1.0):
    """Draws about a random walk of scale ``walk`` (per entry of axis 1
    where it is an array): iid draws where it is 0."""
    rng = np.random.default_rng(seed)
    walk = np.asarray(walk, np.float64).reshape((1, -1) + (1,) * (len(shape) - 2))
    return (walk * np.cumsum(rng.standard_normal(shape), axis=0) / np.sqrt(shape[0])
            + rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("sampler", ["perseries", "gibbs"])
def test_ground_truth_summary_is_the_jax_tools_arithmetic(sampler, tmp_path, monkeypatch):
    """The JAX tool's ``run`` on a shared trace (its ``Training`` and sampler
    replaced) against the port's summary of the same trace and q."""
    monkeypatch.chdir(tmp_path)
    jt = jax_tool("ar_mu_ground_truth")
    monkeypatch.setenv("VIHDS_ARMU_SAMPLER", sampler)
    monkeypatch.setenv("VIHDS_ARMU_EPOCHS", "1")
    monkeypatch.setattr("tempfile.mkdtemp", lambda prefix=None: str(tmp_path))
    monkeypatch.setattr(jtraining, "Training", _Training)
    seen = {}
    n_warmup = 100

    def sampler_fn(model, program, params, batch, key, **kw):
        seen.update(program=program, q=model.encoder(params["enc"], batch))
        B = batch.observations.shape[0]
        if sampler == "perseries":
            # every other series a walk: some series pass the R-hat / ESS
            # gate and some do not
            trace = _trace((2 * n_warmup, B, 4, program.n_theta), 5, 3.0 * (np.arange(B) % 2))
            seen["trace"] = trace
            return AttrDict(z_trace=jnp.asarray(trace), n_warmup=n_warmup,
                            accept_rate=jnp.full((B, 4), 0.75))
        csl = program.global_cond_slice
        trace = _trace((2 * n_warmup, 1, 4, csl.stop - csl.start), 6, 0.3)
        seen["trace"] = trace
        return AttrDict(state_trace={"c": jnp.asarray(trace)}, n_warmup=n_warmup,
                        accept_rate=jnp.full((4,), 0.25))

    monkeypatch.setattr(jref, "hmc_refine" if sampler == "perseries" else "gibbs_refine_pooled",
                        sampler_fn)
    jt.run(0, str(tmp_path / "jax"), n_steps=2 * n_warmup)
    q_mu, q_prec = np.asarray(seen["q"].mu), np.asarray(seen["q"].prec)
    summary = (ar_mu_ground_truth.perseries_summary if sampler == "perseries"
               else ar_mu_ground_truth.pooled_summary)
    out, arrays = summary(seen["trace"], n_warmup, q_mu, q_prec, seen["program"])
    with np.load(tmp_path / "jax" / "seed0.npz") as want:
        head = ["seed", "best_val_elbo", "accept", "n_steps", "sampler"]
        assert want.files == head + list(out) + list(arrays)
        for k, v in list(out.items()) + list(arrays.items()):
            np.testing.assert_allclose(v, want[k], rtol=1e-6, err_msg=k)
    if sampler == "perseries":
        assert 0 < out["aR_n_conv"] < seen["trace"].shape[1]


def test_ridge_summary_is_the_jax_tools_arithmetic(tmp_path, monkeypatch):
    jt = jax_tool("icml_site_mechanism")
    args = make_args(spec("dr_constant_icml.yaml"))
    jprog = JProgram(j_parse(JConfig(args).params))
    tprog = TProgram(t_parse(TConfig(args).params))
    trace = _trace((30, 9, 4, jprog.n_theta), 8, 0.3)
    monkeypatch.setattr(jt, "_train", lambda seed, epochs: (None, jprog, None, None, None, None))
    monkeypatch.setattr(jref, "hmc_refine", lambda *a, **k: AttrDict(
        z_trace=jnp.asarray(trace), n_warmup=10, accept_rate=jnp.full((9, 4), 0.5)))
    jt.ridge(0, str(tmp_path))
    mean_corr, corr = icml_site_mechanism.ridge_summary(torch.from_numpy(trace), 10, tprog)
    with np.load(tmp_path / "ridge_seed0.npz") as want:
        np.testing.assert_allclose(mean_corr, want["mean_corr"], rtol=1e-6)
        np.testing.assert_allclose(corr, want["corr"], rtol=1e-6)
        assert list(want["block"]) == list(icml_site_mechanism.BLOCK)


def test_report_is_the_jax_tools_byte_for_byte(tmp_path):
    """On the recorded r5 seeds and a port seed whose series converged (iid
    draws: every series past the R-hat / ESS gate)."""
    args = make_args(spec("dr_constant_one.yaml"))
    program = TProgram(t_parse(TConfig(args).params))
    trace = np.random.default_rng(2).standard_normal((400, 3, 4, program.n_theta))
    q_mu = np.zeros((3, program.n_theta), np.float32)
    out, arrays = ar_mu_ground_truth.perseries_summary(trace.astype(np.float32), 100, q_mu,
                                                       np.ones_like(q_mu), program)
    assert out["aR_n_conv"] == 3
    dirs = []
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        for path in glob.glob(os.path.join(REPO, "reports", "ar_mu_ground_truth_r5",
                                           "seed*.npz")):
            shutil.copy(path, d)
        np.savez(d / "seed9.npz", seed=9, best_val_elbo=1.0, accept=0.5, n_steps=400,
                 sampler="perseries", **out, **arrays)
        dirs.append(d)
    jax_tool("ar_mu_ground_truth").report(str(dirs[0]))
    ar_mu_ground_truth.report(str(dirs[1]))
    want = (dirs[0] / "REPORT.md").read_bytes()
    assert (dirs[1] / "REPORT.md").read_bytes() == want
    assert b"| 9 | aR |" in want and b"3/3" in want
