"""Minimal layer primitives: explicit param dicts + plain functions.

Linear weights keep the JAX package's ``[n_in, n_out]`` layout (``x @ w``),
not ``nn.Linear``'s ``[out, in]``, so a JAX param tree maps onto the port
leaf for leaf (see ``vihds_tpu_torch.convert``).  The conv weight is
``[n_filters, n_in_channels, filter_size]`` (OIH) in both packages.

The initialisers draw from an explicit ``torch.Generator`` with the same
distributions as the JAX package's (the two give different numbers from the
same seed; parity tests hand both packages the same converted params).

The fold axis (``--vmap_folds``): every leaf of a fold-batched param tree
has a leading ``[F]`` axis, and the rows of the data are the F folds',
fold-major (fold f's rows are ``[f * B, (f + 1) * B)``).  The apply
functions see the axis on their weights and run each fold's rows through
the one-fold op on that fold's weights (``by_fold``), so a fold's numbers
are, bit for bit, those of a run on that fold alone.  A batched matmul or a
grouped convolution would do the same work in one launch, but the card then
picks other kernels, whose float32 rounding differs in the last bits, and
Adam turns last-bit differences in near-zero gradient entries into
learning-rate-sized steps: a few steps apart, the folds' ELBOs no longer
follow their sequential runs.  No gather and no ``index_add``: nothing
mixes folds.
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


def by_fold(fn, p, x, n_folds):
    """``fn(p_f, x_f)`` for each fold f, concatenated along the rows: p_f
    fold f's leaves of ``p`` (views), x_f its rows of ``x``."""
    rows = x.shape[0] // n_folds
    return torch.cat([fn({k: v[f] for k, v in p.items()}, x[f * rows:(f + 1) * rows])
                      for f in range(n_folds)])


def linear_apply(p, x):
    """x [..., n_in] @ w [n_in, n_out] (+ b).  With a fold axis (w [F, n_in,
    n_out], b [F, n_out]) x's leading axis holds the F folds' rows,
    fold-major."""
    w = p["w"]
    if w.dim() == 3:
        return by_fold(linear_apply, p, x, w.shape[0])
    y = x @ w
    if "b" in p:
        y = y + p["b"]
    return y


def rows_of(v, n_rows):
    """A param vector v [n] as ``n_rows`` rows [n_rows, n]; with a fold axis
    (v [F, n]) each fold's vector on its n_rows / F rows, fold-major (an
    expand each, whose backward sums that fold's rows)."""
    if v.dim() == 2:
        n_folds = v.shape[0]
        return torch.cat([rows_of(v[f], n_rows // n_folds) for f in range(n_folds)])
    return v[None, :].expand(n_rows, v.shape[0])


def conv1d_init(generator, n_in_channels, n_filters, filter_size):
    """Orthogonal conv weight [n_filters, n_in_channels, filter_size] + bias."""
    fan_in = n_in_channels * filter_size
    w2d = torch.nn.init.orthogonal_(torch.empty(n_filters, fan_in), generator=generator)
    bound = 1.0 / math.sqrt(fan_in)
    b = torch.empty(n_filters).uniform_(-bound, bound, generator=generator)
    return {"w": w2d.reshape(n_filters, n_in_channels, filter_size), "b": b}


def conv1d_apply(p, x):
    """x [B, C, T] -> [B, F, T - fs + 1] (valid padding, stride 1, OIH weight).
    With a fold axis (w [n_folds, F, C, fs], b [n_folds, F]) x's rows are the
    folds', fold-major."""
    w = p["w"]
    if w.dim() == 4:
        return by_fold(conv1d_apply, p, x, w.shape[0])
    return F.conv1d(x, w, p["b"])


def avgpool1d(x, pool_size):
    """Sliding-window mean with stride 1 over the last axis: [B, C, T] ->
    [B, C, T - pool + 1]."""
    return F.avg_pool1d(x, pool_size, stride=1)
