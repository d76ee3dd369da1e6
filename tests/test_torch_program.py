"""The port's ParamProgram and encoder against the JAX package, on the same
numpy-made q arrays, draws u and (converted) params.

Tolerances: sample / clip rtol 1e-6 (the same float32 ops, exp may differ
by an ulp); log_prob rtol 1e-5 atol 1e-4 on per-site terms of magnitude up
to ~1e3 (log, square and a 35-term sum in float32, summed in another
order); encoder q rtol 1e-5 (conv, pool and matmul reduce in another
order)."""

import glob
import os
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
from vihds_tpu.training import batch_arrays
from vihds_tpu.vae import VAE as JVAE
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.convert import params_from_jax
from vihds_tpu_torch.data.datasets import build_datasets as t_build
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse
from vihds_tpu_torch.training import batch_tensors
from vihds_tpu_torch.vae import VAE as TVAE

SPECS = ["dr_constant_one.yaml", "dr_constant_icml.yaml"]

# every distribution kind and both dependency slots, which no shipped spec uses
SYNTHETIC_PARAMS = {
    "constant": {"c0": 0.5},
    "global": {
        "tn": {"distribution": "TruncatedNormal", "mu": 0.3, "sigma": 1.0, "a": -1.0, "b": 2.0},
        "tn1": {"distribution": "TruncatedNormal", "mu": 1.0, "sigma": 0.5, "a": 0.0},
        "kw": {"distribution": "Kumaraswamy", "a": 2.0, "b": 3.0, "zmin": 0.0, "zmax": 5.0},
        "ln": {"distribution": "LogNormal", "mu": 0.0, "sigma": 0.5},
        "dep": {"distribution": "Normal", "mu": "ln", "prec": 4.0},
        "dep2": {"distribution": "LogNormal", "mu": 0.0, "prec": "ln"},
    },
}


def programs(spec_name):
    if spec_name == "synthetic":
        return JProgram(j_parse(SYNTHETIC_PARAMS)), TProgram(t_parse(SYNTHETIC_PARAMS))
    args = make_args(spec(spec_name))
    jset = JConfig(args)
    tset = TConfig(SimpleNamespace(yaml=spec(spec_name), seed=0))
    return JProgram(j_parse(jset.params)), TProgram(t_parse(tset.params))


def q_and_u(prog, B=3, K=4, seed=0):
    rng = np.random.default_rng(seed)
    n = prog.n_theta
    mu = (prog.prior_mu + 0.3 * rng.standard_normal((B, n))).astype(np.float32)
    prec = (prog.prior_prec * np.exp(0.5 * rng.standard_normal((B, n)))).astype(np.float32)
    # Kumaraswamy (a, b) ride the (mu, prec) slots and must be positive
    mu = np.where(prog.is_kumaraswamy, np.abs(mu) + 0.5, mu).astype(np.float32)
    u = rng.standard_normal((B, K, n)).astype(np.float32)
    return mu, prec, u


@pytest.mark.parametrize("spec_name", SPECS + ["synthetic"])
def test_sample_and_clip_match(spec_name):
    jp, tp = programs(spec_name)
    mu, prec, u = q_and_u(jp)
    j_theta = np.asarray(jp.sample({"mu": jnp.asarray(mu), "prec": jnp.asarray(prec)}, jnp.asarray(u)))
    t_theta = tp.sample(
        {"mu": torch.as_tensor(mu), "prec": torch.as_tensor(prec)}, torch.as_tensor(u)
    ).numpy()
    np.testing.assert_allclose(t_theta, j_theta, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tp.clip(torch.as_tensor(t_theta)).numpy(), np.asarray(jp.clip(jnp.asarray(t_theta))),
        rtol=1e-6, atol=1e-7,
    )


@pytest.mark.parametrize("spec_name", SPECS + ["synthetic"])
def test_log_prob_matches(spec_name):
    jp, tp = programs(spec_name)
    mu, prec, u = q_and_u(jp)
    theta = np.array(jp.sample({"mu": jnp.asarray(mu), "prec": jnp.asarray(prec)}, jnp.asarray(u)))
    for q_np in ({"mu": mu, "prec": prec}, {"mu": jp.prior_mu[None], "prec": jp.prior_prec[None]}):
        jq = {k: jnp.asarray(v) for k, v in q_np.items()}
        tq = {k: torch.as_tensor(v) for k, v in q_np.items()}
        for total in (False, True):
            a = tp.log_prob(tq, torch.as_tensor(theta), total=total).numpy()
            b = np.asarray(jp.log_prob(jq, jnp.asarray(theta), total=total))
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("spec_name", SPECS)
def test_encoder_q_matches(spec_name):
    args = make_args(spec(spec_name))
    jset = JConfig(args)
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    jmodel = JVAE(jset, jdata, jprog)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))

    targs = SimpleNamespace(yaml=spec(spec_name), seed=0, folds=4, split=1, heldout=None)
    tset = TConfig(targs)
    tdata = t_build(targs, tset)
    tprog = TProgram(t_parse(tset.params))
    tmodel = TVAE(tset, tdata, tprog)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")

    rows = np.arange(5)
    host = jdata.train.dataset.select(rows)
    jq = jmodel.encoder(jparams["enc"], batch_arrays(host))
    tq = tmodel.encoder(tparams["enc"], batch_tensors(host, slice(None), None, "cpu"))
    np.testing.assert_allclose(tq.mu.numpy(), np.asarray(jq.mu), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tq.prec.numpy(), np.asarray(jq.prec), rtol=1e-5, atol=1e-6)


def test_port_init_params_have_jax_shapes():
    """The port's seeded init makes a param tree of the JAX package's shape
    (the RNG streams differ, so only the structure is held equal)."""
    args = make_args(spec("dr_constant_icml.yaml"))
    jset = JConfig(args)
    jdata = j_build(args, jset)
    jmodel = JVAE(jset, jdata, JProgram(j_parse(jset.params)))
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jmodel.init_params(jax.random.PRNGKey(0)))

    targs = SimpleNamespace(yaml=spec("dr_constant_icml.yaml"), seed=0, folds=4, split=1, heldout=None)
    tset = TConfig(targs)
    tmodel = TVAE(tset, t_build(targs, tset), TProgram(t_parse(tset.params)))
    tparams = tmodel.init_params(torch.Generator().manual_seed(0), device="cpu")

    def shapes(t):
        return {k: shapes(v) for k, v in t.items()} if isinstance(t, dict) else tuple(t.shape)

    assert shapes(tparams) == jshapes


ALL_SPECS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "specs", "*.yaml")))


@pytest.mark.parametrize("spec_name", ALL_SPECS + ["synthetic"])
def test_fingerprints_and_runtime_priors_match(spec_name):
    """``fingerprint``, ``structural_fingerprint`` (SHA1 digests, letter for
    letter) and ``runtime_priors`` (float32 arrays, exactly, at 4 and 2
    standard deviations) equal the JAX package's for every shipped spec."""
    jp, tp = programs(spec_name)
    assert tp.fingerprint() == jp.fingerprint()
    assert tp.structural_fingerprint() == jp.structural_fingerprint()
    assert tp.fingerprint() != tp.structural_fingerprint()
    for stddevs in (4, 2):
        jr, tr = jp.runtime_priors(stddevs), tp.runtime_priors(stddevs)
        assert list(tr) == list(jr) == ["mu", "prec", "clip_lo", "clip_hi"]
        for key in jr:
            assert tr[key].dtype == jr[key].dtype == np.float32
            np.testing.assert_array_equal(tr[key], jr[key], err_msg=key)


def test_structural_fingerprint_ignores_the_prior_moments():
    """Two programs that differ only in a prior's moments (an inference-graph
    node before and after propagation) share the structural digest, not the
    full one, in both packages."""
    import copy

    base = copy.deepcopy(SYNTHETIC_PARAMS)
    moved = copy.deepcopy(SYNTHETIC_PARAMS)
    moved["global"]["ln"] = {"distribution": "LogNormal", "mu": 0.3, "sigma": 0.2}
    for build, parse in ((TProgram, t_parse), (JProgram, j_parse)):
        a, b = build(parse(base)), build(parse(moved))
        assert a.structural_fingerprint() == b.structural_fingerprint()
        assert a.fingerprint() != b.fingerprint()
