"""Evaluation results: importance-weighted posterior-predictive summaries.

The same field names and ``.vihds_cache`` npy dump/load contract as
``vihds_tpu.results``.  The importance-weighted moments are computed on the
device inside the evaluation (``vihds_tpu_torch.training``); only [B, ...]
summaries reach the host.
"""

import os

import numpy as np

from vihds_tpu_torch.prob.sites import CONSTANT


def q_tensor_names(program):
    """Per-site tensor names, e.g. 'r.mu', 'r.prec', 'init_x.value'."""
    names = []
    for i, site in enumerate(program.sites.ordered):
        if site.kind == CONSTANT:
            names.append("%s.value" % site.name)
        else:
            names.append("%s.mu" % site.name)
            names.append("%s.prec" % site.name)
    return names


def q_tensor_values(program, q_mu, q_prec):
    """Per-site parameter arrays matching q_tensor_names.  Local/conditioned
    sites give per-datapoint vectors, global sites scalars, constants their
    value."""
    values = []
    n_local = len(program.sites.local) + len(program.sites.global_cond)
    for i, site in enumerate(program.sites.ordered):
        if site.kind == CONSTANT:
            values.append(np.array([site.init_mu], np.float32))
        elif i < n_local:
            values.append(np.asarray(q_mu[:, i]))
            values.append(np.asarray(q_prec[:, i]))
        else:
            values.append(np.asarray(q_mu[0:1, i]))
            values.append(np.asarray(q_prec[0:1, i]))
    return values


class Results:
    """Holder for eval outputs."""

    def __init__(self):
        self.species_names = None
        self.q_names = None
        self.q_values = None
        self.theta = None
        self.elbo = None
        self.iw_predict_mu = None
        self.iw_predict_std = None
        self.iw_states = None
        self.iw_variance = None
        self.elbo_list = None

    def init(self, species_names, program, q_mu, q_prec, theta, elbo, iw):
        """``iw``: dict with iw_predict_mu/std, iw_states, iw_variance
        (already importance-weighted, [B, ...])."""
        self.species_names = list(species_names)
        self.q_names = q_tensor_names(program)
        self.q_values = np.array(q_tensor_values(program, q_mu, q_prec), dtype=object)
        self.theta = np.asarray(theta)  # [n_theta, B, K]
        self.elbo = np.asarray(elbo)
        self.iw_predict_mu = np.asarray(iw["iw_predict_mu"])
        self.iw_predict_std = np.asarray(iw["iw_predict_std"])
        self.iw_states = np.asarray(iw["iw_states"])
        self.iw_variance = np.asarray(iw["iw_variance"])

    def dump(self, location=".vihds_cache"):
        os.makedirs(location, exist_ok=True)

        def savetxt(base, data):
            np.savetxt(
                os.path.join(location, base + ".csv"),
                np.array(data, dtype=str),
                delimiter=",",
                fmt="%s",
            )

        savetxt("species_names", self.species_names)
        savetxt("q_names", self.q_names)

        def save(base, data):
            np.save(os.path.join(location, base + ".npy"), data)

        save("q_values", self.q_values)
        save("theta", self.theta)
        save("elbo", self.elbo)
        save("iw_predict_mu", self.iw_predict_mu)
        save("iw_predict_std", self.iw_predict_std)
        save("iw_states", self.iw_states)
        save("iw_variance", self.iw_variance)

    def load(self, location=".vihds_cache"):
        def loadtxt(base):
            return np.loadtxt(os.path.join(location, base + ".csv"), dtype=str, delimiter=",")

        self.species_names = loadtxt("species_names")
        self.q_names = loadtxt("q_names")

        def load(base):
            return np.load(os.path.join(location, base + ".npy"), allow_pickle=True)

        self.q_values = load("q_values")
        self.theta = load("theta")
        self.elbo = load("elbo")
        self.iw_predict_mu = load("iw_predict_mu")
        self.iw_predict_std = load("iw_predict_std")
        self.iw_states = load("iw_states")
        self.iw_variance = load("iw_variance")
