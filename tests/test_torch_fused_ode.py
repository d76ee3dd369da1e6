"""The fused ``dr`` integrator of the port (``vihds_tpu_torch.ops.fused_ode``)
against the JAX package's Pallas kernel run in interpret mode, on the same
numpy constants and initial states.  On the CPU the port's wrapper runs its
plain PyTorch version; the CUDA kernel itself is checked on the card
(tests/test_torch_cuda.py and chip_smoke.py).

Tolerance: rtol 2e-5, atol 1e-7 — the bound tests/test_pallas.py holds the
Pallas kernel to against the XLA scan; the two frameworks' float32 sigmoid
and division may differ by an ulp per step."""

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
from vihds_tpu_torch.models.dr_constant import _dr_constants as t_dr_constants
from vihds_tpu_torch.ops import fused_ode

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "vihds_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def setup():
    """dr_constant_one, B=3 series x K=4 samples: theta from the JAX
    encoder and numpy draws, clipped as the decoder sees it."""
    args = make_args(spec("dr_constant_one.yaml"))
    settings = Config(args)
    data = build_datasets(args, settings)
    program = ParamProgram(parse_parameters(settings.params))
    model = VAE(settings, data, program)
    params = model.init_params(jax.random.PRNGKey(0))
    batch = batch_arrays(data.train.dataset.select(np.arange(3)))
    q = model.encoder(params["enc"], batch)
    u = np.random.default_rng(1).standard_normal((3, 4, program.n_theta)).astype(np.float32)
    theta = program.clip(program.sample(q, jnp.asarray(u)), stddevs=4)
    th = program.theta_dict(theta)
    y0 = jnp.broadcast_to(
        model.ode_model.initialize_state(params["dec"], th, batch.inputs, 3, 4), (3, 4, 8)
    )
    return dict(
        theta={k: np.array(v) for k, v in th.items()},
        inputs=np.array(batch.inputs),
        y0=np.array(y0),
        times=np.array(batch.times),
    )


def _constants(setup, version=1):
    c = j_dr_constants({k: jnp.asarray(v) for k, v in setup["theta"].items()},
                       jnp.asarray(setup["inputs"]), version)
    return {k: np.array(v) for k, v in c.items()}


@pytest.mark.parametrize("method", ["midpoint", "modeuler", "rk4"])
def test_plain_dr_simulate_matches_pallas(setup, method):
    c = _constants(setup)
    ref = np.asarray(
        pallas_ode.dr_constant_simulate(
            {k: jnp.asarray(v) for k, v in c.items()}, jnp.asarray(setup["y0"]),
            jnp.asarray(setup["times"]), method=method, block_rows=8, interpret=True,
        )
    )
    before = fused_ode.dr_constant_simulate.launches
    got = fused_ode.dr_constant_simulate(
        {k: torch.as_tensor(v) for k, v in c.items()}, torch.as_tensor(setup["y0"]),
        torch.as_tensor(setup["times"]), method=method,
    )
    assert fused_ode.dr_constant_simulate.launches == before  # CPU: no kernel launch
    assert tuple(got.shape) == ref.shape == (len(setup["times"]), 3, 4, 8)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("version", [1, 2])
def test_dr_constants_match(setup, version):
    theta = dict(setup["theta"])
    if version == 2:  # v2's crosstalk sites, absent from the v1 spec
        rng = np.random.default_rng(3)
        theta["eS6"] = rng.uniform(1e-3, 0.5, (3, 4)).astype(np.float32)
        theta["eR12"] = rng.uniform(1e-3, 0.5, (3, 4)).astype(np.float32)
    ref = j_dr_constants({k: jnp.asarray(v) for k, v in theta.items()},
                         jnp.asarray(setup["inputs"]), version)
    got = t_dr_constants({k: torch.as_tensor(v) for k, v in theta.items()},
                         torch.as_tensor(setup["inputs"]), version)
    assert set(got) == set(fused_ode.DR_CONST_NAMES) == set(pallas_ode.DR_CONST_NAMES)
    for k in fused_ode.DR_CONST_NAMES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6, err_msg=k)


def test_constant_order_matches_kernel_source():
    """The wrapper packs constants in DR_CONST_NAMES order; the CUDA kernel
    (dr_fwd.cu, which includes dr_common.cuh) reads them by the DrConst enum
    of dr_common.cuh, which must list the same names in the same order (and
    the same order as the Pallas kernel's packing)."""
    assert '#include "dr_common.cuh"' in open(os.path.join(CSRC, "dr_fwd.cu")).read()
    src = open(os.path.join(CSRC, "dr_common.cuh")).read()
    body = re.search(r"enum DrConst \{(.*?)\};", src, re.S).group(1)
    names = [m.group(1) for m in re.finditer(r"C_(\w+)", body)]
    assert tuple(names) == fused_ode.DR_CONST_NAMES == pallas_ode.DR_CONST_NAMES
    methods = re.search(r"enum Method \{(.*?)\};", src, re.S).group(1)
    assert [m.lower() for m in re.findall(r"(\w+) = \d", methods)] == list(fused_ode.METHODS)


def test_wrapper_rejects_unknown_method(setup):
    c = {k: torch.as_tensor(v) for k, v in _constants(setup).items()}
    with pytest.raises(ValueError, match="method 'euler' not in"):
        fused_ode.dr_constant_simulate(
            c, torch.as_tensor(setup["y0"]), torch.as_tensor(setup["times"]), method="euler"
        )


def test_cuda_route_refuses_cpu_tensors(setup):
    """The kernel route checks its inputs before it loads the library: a
    CPU tensor is refused, never silently computed."""
    c = {k: torch.as_tensor(v) for k, v in _constants(setup).items()}
    packed, y0 = fused_ode._pack(c, torch.as_tensor(setup["y0"]))
    with pytest.raises(ValueError, match="must be on"):
        fused_ode._integrate_cuda(packed, y0, torch.as_tensor(setup["times"]), "midpoint")
