"""The port's site functions and the places where a PyTorch port of
``vihds_tpu.refine`` drifts without an error, against the JAX package on
the CPU (the samplers themselves: tests/test_torch_refine.py).

The site functions (``constrain_z``, ``log_prior_z_cols``, ``z_from_u``,
``log_q_z_sites``, the bijections' inverses) on tests/test_refine.py's
TruncNormal / Kumaraswamy spec at rtol 1e-5, the JAX side under one jit;
``_ZCAP``; ``jnp.median`` of an even count, the population variance of
``adapt_mass``, ``jnp.nan_to_num(nan=-inf)``, the pooled state's per-device
rows and the samplers' signatures."""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.conftest import make_args, spec
from vihds_tpu import refine as jref
from vihds_tpu.config import Config as JConfig
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu_torch import refine as tref
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse


# --------------------------------------------------------------------------- #
# (c) The site functions on bounded families
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def trunc_programs(tmp_path_factory):
    """tests/test_refine.py's trunc_setup spec: dr_constant_one plus a
    two-sided and a one-sided TruncNormal and a Kumaraswamy global site."""
    base = yaml.safe_load(open(spec("dr_constant_one.yaml")))
    base["params"]["global"]["tn_two"] = {
        "distribution": "TruncNormal", "mu": 1.0, "sigma": 0.5, "a": 0.2, "b": 1.2,
    }
    base["params"]["global"]["tn_lo"] = {
        "distribution": "TruncNormal", "mu": 0.0, "sigma": 1.0, "a": 0.0,
    }
    base["params"]["global"]["ku"] = {"distribution": "Kumaraswamy", "a": 2.0, "b": 3.0}
    p = tmp_path_factory.mktemp("trunc") / "trunc.yaml"
    p.write_text(yaml.dump(base))
    jprog = JProgram(j_parse(JConfig(make_args(str(p))).params))
    tprog = TProgram(t_parse(TConfig(SimpleNamespace(yaml=str(p), seed=0, folds=4, split=1,
                                                     heldout=None)).params))
    assert jprog.is_truncated.sum() == 2 and jprog.is_kumaraswamy.sum() == 1
    rng = np.random.default_rng(21)
    n = jprog.n_theta
    z = (2.0 * rng.standard_normal((3, 5, n))).astype(np.float32)
    u = rng.standard_normal((3, 5, n)).astype(np.float32)
    mu = rng.standard_normal((3, 1, n)).astype(np.float32)
    mu[..., jprog.is_kumaraswamy] = np.abs(mu[..., jprog.is_kumaraswamy]) + 0.5  # q's a
    prec = np.exp(rng.standard_normal((3, 1, n))).astype(np.float32)
    return jprog, tprog, z, u, mu, prec


@pytest.fixture(scope="module")
def site_pairs(trunc_programs):
    """{function: (JAX's output, the port's)} on trunc_programs' operands;
    the JAX side under one jit."""
    jprog, tprog, z, u, mu, prec = trunc_programs
    idx = np.flatnonzero(jprog.is_truncated | jprog.is_kumaraswamy | jprog.is_lognormal)[-6:]

    @jax.jit
    def jax_side(z, u, mu, prec):
        return (jref.constrain_z(jprog, z), jref.log_prior_z_cols(jprog, z),
                jref.log_prior_z_cols(jprog, z[..., idx], idx), jref.z_from_u(jprog, u, mu, prec),
                jref.log_q_z_sites(jprog, z, mu, prec))

    T_ = torch.as_tensor
    port = (tref.constrain_z(tprog, T_(z)), tref.log_prior_z_cols(tprog, T_(z)),
            tref.log_prior_z_cols(tprog, T_(z[..., idx]), idx),
            tref.z_from_u(tprog, T_(u), T_(mu), T_(prec)),
            tref.log_q_z_sites(tprog, T_(z), T_(mu), T_(prec)))
    names = ("constrain_z", "log_prior_z_cols", "log_prior_z_cols[idx]", "z_from_u",
             "log_q_z_sites")
    return dict(zip(names, zip(jax_side(z, u, mu, prec), port)))


@pytest.mark.parametrize("function", ["constrain_z", "log_prior_z_cols", "log_prior_z_cols[idx]",
                                      "z_from_u", "log_q_z_sites"])
def test_site_functions_equal_jax(site_pairs, function):
    want, got = site_pairs[function]
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_z_from_u_inverts_on_the_bounded_sites(trunc_programs):
    """z_from_u's bounded columns land inside their supports, and the
    bijections invert there (both packages' unconstrain_*)."""
    jprog, tprog, z, u, mu, prec = trunc_programs
    zt = tref.z_from_u(tprog, torch.as_tensor(u), torch.as_tensor(mu), torch.as_tensor(prec))
    theta = tref.constrain_z(tprog, zt).numpy()
    tr = jprog.is_truncated
    assert (theta[..., tr] >= jprog._trunc_a_safe[tr]).all()
    back = tref.unconstrain_truncated(tprog, torch.as_tensor(theta)).numpy()
    np.testing.assert_allclose(back[..., tr], zt.numpy()[..., tr], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        back, np.asarray(jref.unconstrain_truncated(jprog, theta)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tref.unconstrain_kuma(tprog, torch.as_tensor(theta)).numpy(),
        np.asarray(jref.unconstrain_kuma(jprog, theta)), rtol=1e-5, atol=1e-6)


def test_zcap_keeps_the_discarded_branches_gradient_finite(trunc_programs):
    """_ZCAP: at |z| far past 30 on the bounded columns, the gradient of the
    bounded log prior stays finite and equals JAX's (a torch.where without
    the cap would take 0 * inf = NaN from a discarded exp branch).
    ``constrain_z``'s LogNormal branch has no cap in either package: its
    exp overflows past z = 88, and the gradient there is NaN in both."""
    jprog, tprog, z, *_ = trunc_programs
    z = z[:1, :1].copy()
    bounded = jprog.is_truncated | jprog.is_kumaraswamy
    z[..., bounded] = np.array([200.0, -200.0, 150.0])
    for f_jax, f_port, finite in ((jref.log_prior_z_cols, tref.log_prior_z_cols, True),
                                  (jref.constrain_z, tref.constrain_z, False)):
        want = np.asarray(jax.jit(jax.grad(lambda z_: f_jax(jprog, z_).sum()))(jnp.asarray(z)))
        zt = torch.as_tensor(z).requires_grad_(True)
        f_port(tprog, zt).sum().backward()
        got = zt.grad.numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        assert np.isfinite(got).all() == finite
        if not finite:
            np.testing.assert_array_equal(~np.isfinite(got[0, 0]), bounded & (z[0, 0] > 88))
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# (e) Places where a port drifts without an error
# --------------------------------------------------------------------------- #
def test_median_averages_the_two_middle_values():
    x = np.array([[3.0, -1.0, 7.5, 2.0], [0.5, 9.0, -4.0, 1.25]], np.float32)
    want = float(np.asarray(jnp.median(jnp.asarray(x))))
    assert float(tref._median(torch.as_tensor(x))) == want == 1.625
    assert float(torch.median(torch.as_tensor(x))) != want  # the lower middle value
    odd = x.reshape(-1)[:7]
    assert float(tref._median(torch.as_tensor(odd))) == float(np.asarray(jnp.median(odd)))


def test_window_mass_uses_the_population_variance():
    rng = np.random.default_rng(2)
    zw = rng.standard_normal((5, 3, 4, 6)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 0], np.float32)
    # the JAX package's expression (refine.py:438-439)
    var = jnp.maximum(jnp.asarray(zw).var(axis=(0, 2)), 1e-10)
    want = np.asarray(jnp.where(mask > 0, 1.0 / var, 1.0)[:, None, :])
    got = tref._window_mass(torch.as_tensor(zw), torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    unbiased = 1.0 / torch.as_tensor(zw).var(dim=(0, 2)).numpy()
    assert not np.allclose(got[:, 0, mask > 0], unbiased[:, mask > 0], rtol=1e-3)


def test_nan_to_num_maps_like_jax():
    """``jnp.nan_to_num(x, nan=-inf)`` sends NaN to -inf and then every
    infinity to the largest finite float of its sign: NaN ends at -3.4e38,
    where ``torch.nan_to_num`` with the same arguments leaves -inf."""
    x = np.array([np.nan, np.inf, -np.inf, 1.5, -2.0], np.float32)
    want = np.asarray(jnp.nan_to_num(jnp.asarray(x), nan=-jnp.inf))
    got = tref._nan_to_neg_inf(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    big = np.finfo(np.float32).max
    np.testing.assert_array_equal(got[:3], [-big, big, -big])
    assert torch.nan_to_num(torch.as_tensor(x), nan=-math.inf)[0] == -math.inf


def test_device_rows_backward_sums_each_device():
    """The pooled state's per-device rows: forward a gather, backward each
    device's rows summed (a fixed-order reduction), equal to the index's."""
    c = torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    dev = torch.tensor([0, 1, 1, 0, 1])
    onehot = (dev[:, None] == torch.arange(2)[None]).to(torch.float32)
    w = torch.randn(5, 3, 4, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    a = c.clone().requires_grad_(True)
    b = c.clone().requires_grad_(True)
    out = tref._DeviceRows.apply(a, dev, onehot)
    assert torch.equal(out, c[dev])
    (out * w).sum().backward()
    (b[dev] * w).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-12, atol=1e-12)


def test_samplers_keep_every_argument_of_jax():
    import inspect

    for name in ("hmc_refine", "hmc_refine_pooled", "gibbs_refine_pooled", "pm_refine_shared",
                 "smc_refine", "make_log_joint", "init_z_from_q", "log_prior_z_cols"):
        want = inspect.signature(getattr(jref, name)).parameters
        got = inspect.signature(getattr(tref, name)).parameters
        assert list(got) == list(want), name
        assert [p.default for p in got.values()] == [p.default for p in want.values()], name
    assert math.isclose(tref._ZCAP, jref._ZCAP)
