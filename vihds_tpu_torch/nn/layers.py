"""Minimal layer primitives: explicit param dicts + plain functions.

Linear weights keep the JAX package's ``[n_in, n_out]`` layout (``x @ w``),
not ``nn.Linear``'s ``[out, in]``, so a JAX param tree maps onto the port
leaf for leaf (see ``vihds_tpu_torch.convert``).  The conv weight is
``[n_filters, n_in_channels, filter_size]`` (OIH) in both packages.

The initialisers draw from an explicit ``torch.Generator`` with the same
distributions as the JAX package's (the two give different numbers from the
same seed; parity tests hand both packages the same converted params).
"""

import math

import torch
import torch.nn.functional as F


def linear_init(generator, n_in, n_out, use_bias=True, mode="default", gain=1.0):
    """Weight [n_in, n_out] (+ bias [n_out]).

    mode: 'default' = U(+-1/sqrt(n_in)); 'xavier' = xavier-uniform with gain;
          'orthogonal'; 'normal' = N(mean=2.0, std=1.5) (device conditioner).
    """
    if mode == "default":
        bound = 1.0 / math.sqrt(n_in)
        w = torch.empty(n_in, n_out).uniform_(-bound, bound, generator=generator)
    elif mode == "xavier":
        bound = gain * math.sqrt(6.0 / (n_in + n_out))
        w = torch.empty(n_in, n_out).uniform_(-bound, bound, generator=generator)
    elif mode == "orthogonal":
        w = torch.nn.init.orthogonal_(torch.empty(n_in, n_out), generator=generator)
    elif mode == "normal":
        w = 2.0 + 1.5 * torch.randn(n_in, n_out, generator=generator)
    else:
        raise ValueError(mode)
    p = {"w": w}
    if use_bias:
        bound = 1.0 / math.sqrt(n_in)
        p["b"] = torch.empty(n_out).uniform_(-bound, bound, generator=generator)
    return p


def linear_apply(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def conv1d_init(generator, n_in_channels, n_filters, filter_size):
    """Orthogonal conv weight [n_filters, n_in_channels, filter_size] + bias."""
    fan_in = n_in_channels * filter_size
    w2d = torch.nn.init.orthogonal_(torch.empty(n_filters, fan_in), generator=generator)
    bound = 1.0 / math.sqrt(fan_in)
    b = torch.empty(n_filters).uniform_(-bound, bound, generator=generator)
    return {"w": w2d.reshape(n_filters, n_in_channels, filter_size), "b": b}


def conv1d_apply(p, x):
    """x [B, C, T] -> [B, F, T - fs + 1] (valid padding, stride 1, OIH weight)."""
    return F.conv1d(x, p["w"], p["b"])


def avgpool1d(x, pool_size):
    """Sliding-window mean with stride 1 over the last axis: [B, C, T] ->
    [B, C, T - pool + 1]."""
    return F.avg_pool1d(x, pool_size, stride=1)
