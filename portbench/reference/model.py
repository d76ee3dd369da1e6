"""The two configurations' model, loss and optimizer in plain PyTorch: the
VI-HDS variational autoencoder of Roeder et al. (ICML 2019,
arXiv:1905.12090) as its published code defines it.

* Encoder: the observations' first differences through a valid Conv1d
  (``n_filters`` x ``filter_size``), a stride-1 average pool
  (``pool_size``), a dense layer to ``n_hidden`` and tanh; local sites'
  mean and log precision are dense heads of [encoding, device one-hot]
  (with bias), global-conditioned sites' heads of the device one-hot
  (without), global sites free vectors, constants fixed (log precision 0).
* theta = the sites' reparameterised draws (``spec.Program``), clipped
  before the decoder.
* ``dr_constant``: the double-receiver ODE over 8 species with device-
  conditioned aR, aS = relu(w . (one-hot * relevance)) (times 1 + . for a
  group with a default device).
* ``dr_blackbox``: a neural right-hand side over 4 observed + 2 latent
  species, h = relu(W_h [x, c] + b_h), dx = sigmoid(W_p h + b_p) -
  sigmoid(W_d h + b_d) x, and 4 precision states under a second net of
  [t, x, c]; c = [z, x, y + offset(device), log(1 + treatments), device].
* Midpoint steps on the data's time grid; a Gaussian likelihood of the 4
  signals with the precisions; IWAE weights log p(x | theta) + log p(theta)
  - log q(theta); importance-weighted predictive moments.
* Adam (beta 0.9 / 0.999, eps 1e-8) on the negative IWAE bound, a fold's
  batch mean over its unmasked rows.

The weights are made here from a seed (``make_params``): the benchmark hands
the same weights to the program and to this reference.
"""

import math

import torch
import torch.nn.functional as F

from portbench.reference import data as refdata
from portbench.reference.spec import Program, parse_sites

DEFAULTS = dict(n_filters=10, filter_size=10, pool_size=5, n_hidden=50,
                n_hidden_decoder=50, n_hidden_decoder_precisions=20,
                init_latent_species=0.001, init_prec=0.00001)
LOG2PI = math.log(2.0 * math.pi)


class Model:
    """One configuration's model in ``dtype`` on ``device``; ``shapes`` =
    (observed signals, time points, conditions, device one-hot width)."""

    def __init__(self, spec, shapes, dtype=torch.float64, device="cpu"):
        self.spec = spec
        self.params_cfg = dict(DEFAULTS, **spec["params"])
        self.kind = spec["model"]
        if self.kind not in ("dr_constant", "dr_blackbox"):
            raise ValueError("reference: model %r is not supported" % self.kind)
        if self.params_cfg.get("solver") not in ("midpoint", "pallas_midpoint"):
            raise ValueError("reference: only the midpoint method is supported")
        self.dtype, self.device = dtype, torch.device(device)
        self.n_obs, self.n_times, self.n_cond, self.depth = shapes
        self.program = Program(parse_sites(spec["params"]), dtype, self.device)
        self.local = self.program.tier("local")
        self.gc = self.program.tier("global_cond")
        self.glob = self.program.tier("global")
        self.const = self.program.tier("constant")
        p = self.params_cfg
        n_conv = self.n_times - 1 - (p["filter_size"] - 1)
        self.n_flat = (n_conv - (p["pool_size"] - 1)) * p["n_filters"]
        self.rel = {k: torch.tensor(v, dtype=dtype, device=self.device)
                    for k, v in refdata.relevance(spec["data"]).items()}
        self.defaults = spec["data"].get("default_devices") or {}
        if self.kind == "dr_blackbox":
            self.n_z, self.n_x, self.n_y = p["n_z"], p["n_x"], p["n_y"]
            self.n_states = 4 + p["n_latent_species"]
            self.n_const = self.n_z + self.n_x + self.n_y + self.n_cond + self.depth
        else:
            self.n_states = 8

    # ------------------------------------------------------------- weights
    def _layouts(self):
        """(path, shape, init) of every weight: init is ("ortho",),
        ("uniform", bound) or ("normal", mean, std)."""
        p = self.params_cfg
        S, nf, fs, nh = self.n_obs, p["n_filters"], p["filter_size"], p["n_hidden"]
        out = [(("enc", "conv", "w"), (nf, S, fs), ("ortho",)),
               (("enc", "conv", "b"), (nf,), ("uniform", 1.0 / math.sqrt(S * fs))),
               (("enc", "lin", "w"), (self.n_flat, nh), ("ortho",)),
               (("enc", "lin", "b"), (nh,), ("uniform", 1.0 / math.sqrt(self.n_flat)))]
        if self.local:
            d = nh + (self.n_cond if self.local[0].cond_treatments else 0) \
                + (self.depth if self.local[0].cond_devices else 0)
            for head in ("loc_mu", "loc_lp"):
                out += [(("enc", head, "w"), (d, len(self.local)), ("uniform", 1 / math.sqrt(d))),
                        (("enc", head, "b"), (len(self.local),), ("uniform", 1 / math.sqrt(d)))]
        if self.gc:
            d = (self.n_cond if self.gc[0].cond_treatments else 0) \
                + (self.depth if self.gc[0].cond_devices else 0)
            for head in ("gc_mu", "gc_lp"):
                out.append((("enc", head, "w"), (d, len(self.gc)), ("uniform", 1 / math.sqrt(d))))
        if self.kind == "dr_constant":
            for name in ("aR", "aS"):
                out.append((("dec", "cond_" + name, "w"), (self.depth, 1), ("normal", 2.0, 1.5)))
            return out
        ns, nc = self.n_states, self.n_const
        nh_s, nh_p = p["n_hidden_decoder"], p["n_hidden_decoder_precisions"]

        def xavier(n_in, n_out, gain=1.0):
            return ("uniform", gain * math.sqrt(6.0 / (n_in + n_out)))

        def bias(n_in):
            return ("uniform", 1.0 / math.sqrt(n_in))

        n_in = ns + nc
        out += [(("dec", "offset", "w"), (self.depth, self.n_y), bias(self.depth)),
                (("dec", "offset", "b"), (self.n_y,), bias(self.depth))]
        for net, nin, hid, nout, gains in (("states", n_in, nh_s, ns, (1.0, 1.0)),
                                           ("precisions", n_in + 1, nh_p, 4, (0.5, 1.0))):
            out += [(("dec", net, "hidden", "w"), (nin, hid), xavier(nin, hid)),
                    (("dec", net, "hidden", "b"), (hid,), bias(nin)),
                    (("dec", net, "prod", "w"), (hid, nout), xavier(hid, nout, gains[0])),
                    (("dec", net, "prod", "b"), (nout,), bias(hid)),
                    (("dec", net, "degr", "w"), (hid, nout), xavier(hid, nout, gains[1])),
                    (("dec", net, "degr", "b"), (nout,), bias(hid))]
        return out

    def make_params(self, seed, device):
        """Float32 weights from ``seed``, drawn on ``device`` in two calls
        (one of uniforms, one of normals; ``orthogonal`` for the conv and the
        encoder's dense layer): a nested dict of the program's
        layout ([n_in, n_out] dense weights, [n_filters, channels, width]
        conv weights), global sites' q means at the prior means and their
        log precisions at 0."""
        layouts = self._layouts()
        gen = torch.Generator(device=device).manual_seed(int(seed))
        sizes = [math.prod(shape) for _, shape, _ in layouts]
        uni = torch.rand(sum(sizes), generator=gen, device=device)
        nor = torch.randn(sum(sizes), generator=gen, device=device)
        params, at = {}, 0
        for (path, shape, init), n in zip(layouts, sizes):
            if init[0] == "uniform":
                leaf = (2.0 * uni[at:at + n] - 1.0) * init[1]
            elif init[0] == "normal":
                leaf = init[1] + init[2] * nor[at:at + n]
            else:
                leaf = orthogonal(nor[at:at + n].reshape(shape[0], -1))
            at += n
            node = params
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf.reshape(shape).to(torch.float32).contiguous()
        if self.glob:
            params["enc"]["glob_mu"] = torch.tensor([s.mu for s in self.glob], device=device)
            params["enc"]["glob_lp"] = torch.zeros(len(self.glob), device=device)
        return params

    def cast(self, params):
        """A weight tree in this model's dtype and device."""
        if isinstance(params, dict):
            return {k: self.cast(v) for k, v in params.items()}
        return params.detach().to(self.device, self.dtype)

    # ------------------------------------------------------------- encoder
    def encode(self, p, obs, inputs, dev):
        """q's mean and precision [B, n_theta]."""
        cfg = self.params_cfg
        x = F.conv1d(obs[:, :, 1:] - obs[:, :, :-1], p["conv"]["w"], p["conv"]["b"])
        x = F.avg_pool1d(x, cfg["pool_size"], stride=1)
        enc = torch.tanh(x.reshape(x.shape[0], -1) @ p["lin"]["w"] + p["lin"]["b"])
        B = obs.shape[0]
        mus, lps = [], []

        def feats(site, base):
            xs = base + ([inputs] if site.cond_treatments else []) \
                + ([dev] if site.cond_devices else [])
            return torch.cat(xs, dim=1)

        if self.local:
            h = feats(self.local[0], [enc])
            mus.append(h @ p["loc_mu"]["w"] + p["loc_mu"]["b"])
            lps.append(h @ p["loc_lp"]["w"] + p["loc_lp"]["b"])
        if self.gc:
            h = feats(self.gc[0], [])
            mus.append(h @ p["gc_mu"]["w"])
            lps.append(h @ p["gc_lp"]["w"])
        if self.glob:
            mus.append(p["glob_mu"][None, :].expand(B, -1))
            lps.append(p["glob_lp"][None, :].expand(B, -1))
        if self.const:
            mus.append(torch.tensor([s.mu for s in self.const], dtype=enc.dtype,
                                    device=enc.device)[None, :].expand(B, -1))
            lps.append(torch.zeros(B, len(self.const), dtype=enc.dtype, device=enc.device))
        mu, lp = torch.cat(mus, dim=1), torch.cat(lps, dim=1)
        return mu, torch.exp(lp)

    # ------------------------------------------------------------- decoder
    def _midpoint(self, rhs, y0, times):
        ys, y = [y0], y0
        for i in range(times.shape[0] - 1):
            t1, h = times[i], times[i + 1] - times[i]
            f1 = rhs(t1, y)
            y = y + h * rhs(t1 + 0.5 * h, y + 0.5 * h * f1)
            ys.append(y)
        return torch.stack(ys, dim=-1)  # [R, S, T]

    def _dr(self, p, th, inputs, dev, times, B, K):
        c6, c12 = torch.clamp(torch.exp(inputs) - 1.0, 1e-12, 1e6).unbind(1)
        c6, c12 = c6[:, None], c12[:, None]
        for name in ("aR", "aS"):
            cond = torch.relu((dev * self.rel[name]) @ p["cond_" + name]["w"])  # [B, 1]
            th[name] = 1.0 + cond if name in self.defaults else cond
        c = {k: torch.broadcast_to(v, (B, K)).reshape(-1) for k, v in dict(
            r=torch.clamp(th["r"], 0.0, 4.0), K=torch.clamp(th["K"], 0.0, 4.0),
            tlag=th["tlag"], rc=th["rc"], a530=th["a530"], a480=th["a480"],
            drfp=torch.clamp(th["drfp"], 1e-12, 2.0), dyfp=torch.clamp(th["dyfp"], 1e-12, 2.0),
            dcfp=torch.clamp(th["dcfp"], 1e-12, 2.0), dR=torch.clamp(th["dR"], 1e-12, 5.0),
            dS=torch.clamp(th["dS"], 1e-12, 5.0),
            **{k: th[k] for k in ("e76", "e81", "aCFP", "aYFP", "KGR_76", "KGS_76", "KGR_81",
                                  "KGS_81", "aR", "aS")}).items()}
        nR = torch.clamp(th["nR"], 0.5, 3.0)
        nS = torch.clamp(th["nS"], 0.5, 3.0)
        KR6, KR12, KS6, KS12 = (torch.clamp(th[k], 1e-12, 1.0) for k in ("KR6", "KR12", "KS6",
                                                                           "KS12"))
        c["fracLuxR"] = (((KR6 * c6) ** nR + (KR12 * c12) ** nR)
                         / (1.0 + KR6 * c6 + KR12 * c12) ** nR).reshape(-1)
        c["fracLasR"] = (((KS6 * c6) ** nS + (KS12 * c12) ** nS)
                         / (1.0 + KS6 * c6 + KS12 * c12) ** nS).reshape(-1)

        def rhs(t, y):
            x, rfp, yfp, cfp, f530, f480, luxR, lasR = y.unbind(1)
            gamma = c["r"] * torch.sigmoid(4.0 * (t - c["tlag"])) * (1.0 - x / c["K"])
            bR = luxR * luxR * c["fracLuxR"]
            bS = lasR * lasR * c["fracLasR"]
            P76 = (c["e76"] + c["KGR_76"] * bR + c["KGS_76"] * bS) / (
                1.0 + c["KGR_76"] * bR + c["KGS_76"] * bS)
            P81 = (c["e81"] + c["KGR_81"] * bR + c["KGS_81"] * bS) / (
                1.0 + c["KGR_81"] * bR + c["KGS_81"] * bS)
            return torch.stack([
                gamma * x, c["rc"] - (gamma + c["drfp"]) * rfp,
                c["rc"] * c["aYFP"] * P81 - (gamma + c["dyfp"]) * yfp,
                c["rc"] * c["aCFP"] * P76 - (gamma + c["dcfp"]) * cfp,
                c["rc"] * c["a530"] - gamma * f530, c["rc"] * c["a480"] - gamma * f480,
                c["rc"] * c["aR"] - (gamma + c["dR"]) * luxR,
                c["rc"] * c["aS"] - (gamma + c["dS"]) * lasR], dim=1)

        zero = torch.zeros(B * K, dtype=self.dtype, device=self.device)
        y0 = torch.stack([torch.broadcast_to(th[k], (B, K)).reshape(-1) for k in (
            "init_x", "init_rfp", "init_yfp", "init_cfp")] + [zero, zero] + [
            torch.broadcast_to(th[k], (B, K)).reshape(-1) for k in ("init_luxR", "init_lasR")],
            dim=1)
        xs = self._midpoint(rhs, y0, times).reshape(B, K, 8, -1)
        obs = torch.stack([xs[:, :, 0], xs[:, :, 0] * xs[:, :, 1],
                           xs[:, :, 0] * (xs[:, :, 2] + xs[:, :, 4]),
                           xs[:, :, 0] * (xs[:, :, 3] + xs[:, :, 5])], dim=2)
        prec = torch.stack([th[k] for k in ("prec_x", "prec_rfp", "prec_yfp", "prec_cfp")],
                           dim=-1)[:, :, :, None]
        return xs, obs, prec

    def _blackbox(self, p, th, inputs, dev, times, B, K):
        offset = dev @ p["offset"]["w"] + p["offset"]["b"]  # [B, n_y]
        for i in range(self.n_y):
            th["y%d" % (i + 1)] = th["y%d" % (i + 1)] + offset[:, None, i]
        names = (["z%d" % (i + 1) for i in range(self.n_z)]
                 + ["x%d" % (i + 1) for i in range(self.n_x)]
                 + ["y%d" % (i + 1) for i in range(self.n_y)])
        lat = torch.stack([torch.broadcast_to(th[n], (B, K)) for n in names], dim=-1)
        c = torch.cat([lat, torch.broadcast_to(inputs[:, None], (B, K, inputs.shape[1])),
                       torch.broadcast_to(dev[:, None], (B, K, dev.shape[1]))],
                      dim=-1).reshape(B * K, -1)
        ns = self.n_states
        st, pr = p["states"], p["precisions"]
        # the constants' share of each hidden layer, once per row
        hc = c @ st["hidden"]["w"][ns:] + st["hidden"]["b"]
        pc = c @ pr["hidden"]["w"][1 + ns:] + pr["hidden"]["b"]

        def rhs(t, y):
            x, v = y[:, :ns], y[:, ns:]
            h = torch.relu(x @ st["hidden"]["w"][:ns] + hc)
            dx = torch.sigmoid(h @ st["prod"]["w"] + st["prod"]["b"]) \
                - torch.sigmoid(h @ st["degr"]["w"] + st["degr"]["b"]) * x
            hp = torch.relu(t * pr["hidden"]["w"][0] + x @ pr["hidden"]["w"][1:1 + ns] + pc)
            dv = torch.sigmoid(hp @ pr["prod"]["w"] + pr["prod"]["b"]) \
                - torch.sigmoid(hp @ pr["degr"]["w"] + pr["degr"]["b"]) * v
            return torch.cat([dx, dv], dim=1)

        x0 = torch.stack([torch.broadcast_to(th[k], (B, K)).reshape(-1)
                          for k in ("init_x", "init_rfp", "init_yfp", "init_cfp")], dim=1)
        cfg = self.params_cfg
        y0 = torch.cat([x0, torch.full((B * K, ns - 4), float(cfg["init_latent_species"]),
                                       dtype=self.dtype, device=self.device),
                        torch.full((B * K, 4), float(cfg["init_prec"]), dtype=self.dtype,
                                   device=self.device)], dim=1)
        traj = self._midpoint(rhs, y0, times).reshape(B, K, ns + 4, -1)
        xs, prec = traj[:, :, :ns], traj[:, :, ns:]
        obs = torch.stack([xs[:, :, 0], xs[:, :, 0] * xs[:, :, 1], xs[:, :, 0] * xs[:, :, 2],
                           xs[:, :, 0] * xs[:, :, 3]], dim=2)
        return xs, obs, prec

    # ------------------------------------------------------------- forward
    def forward(self, params, batch, u):
        """One batch [B] at draws u [B, K, n_theta]: a dict of q's mu and
        prec, theta (the draw), the clipped theta, x_states [B, K, S, T],
        x_predict [B, K, 4, T], precisions and the IWAE log weights."""
        obs, inputs, dev, times = (batch[k] for k in ("observations", "inputs", "dev_1hot",
                                                      "times"))
        B, K = u.shape[:2]
        mu, prec = self.encode(params["enc"], obs, inputs, dev)
        theta = self.program.sample(mu, prec, u)
        clipped = self.program.clip(theta)
        th = self.program.columns(clipped)
        decode = self._dr if self.kind == "dr_constant" else self._blackbox
        xs, x_pred, precisions = decode(params["dec"], th, inputs, dev, times, B, K)
        lp_obs = (-0.5 * (LOG2PI - torch.log(precisions)
                          + precisions * (x_pred - obs[:, None]) ** 2)).sum(dim=(2, 3))
        log_w = lp_obs + self.program.log_prior(theta) - self.program.log_prob(mu, prec, theta)
        return dict(q_mu=mu, q_prec=prec, theta=theta, clipped=clipped, x_states=xs,
                    x_predict=x_pred, precisions=precisions, log_w=log_w)

    def evaluate(self, params, batch, u):
        """The served outputs of one batch: per-item ELBO [B], the IWAE log
        weights [B, K], q's moments, theta and the importance-weighted
        predictive mean, standard deviation (from the second moment
        E_w[x^2 + 1 / prec]) and states."""
        out = self.forward(params, batch, u)
        K = u.shape[1]
        lse = torch.logsumexp(out["log_w"], dim=1, keepdim=True)
        w = torch.exp(out["log_w"] - lse)[:, :, None, None]
        xp, pr = out["x_predict"], out["precisions"]
        mu = (w * xp).sum(1)
        m2 = (w * (xp ** 2 + 1.0 / pr)).sum(1)
        return dict(per_item_elbo=lse[:, 0] - math.log(K), log_w=out["log_w"],
                    q_mu=out["q_mu"], q_prec=out["q_prec"], theta=out["clipped"].permute(2, 0, 1),
                    iw_predict_mu=mu,
                    iw_predict_std=torch.sqrt(torch.clamp(m2 - mu ** 2, min=0.0)),
                    iw_states=(w * out["x_states"]).sum(1))

    def loss(self, params, batch, mask, u):
        """The negative IWAE bound of one fold's batch: the mean over its
        unmasked rows of logsumexp_K(log w) - log K."""
        log_w = self.forward(params, batch, u)["log_w"]
        per = torch.logsumexp(log_w, dim=1) - math.log(u.shape[1])
        return -(per * mask).sum() / mask.sum()


def orthogonal(m, iterations=60):
    """The orthogonal factor of the polar decomposition of a Gaussian matrix
    (orthonormal rows or columns, whichever are fewer; uniformly distributed,
    as a QR-based orthogonal initialisation is), by Newton-Schulz iterations
    in float64: matrix products only, no solver library to load."""
    x = m.double()
    tall = x.shape[0] >= x.shape[1]
    x = x if tall else x.t()
    x = x / torch.linalg.matrix_norm(x)
    for _ in range(iterations):
        x = 1.5 * x - 0.5 * x @ (x.t() @ x)
    return (x if tall else x.t()).float()


def leaves(params, prefix=()):
    """(path, tensor) of every leaf of a nested weight dict, in order."""
    if isinstance(params, dict):
        return [x for k, v in params.items() for x in leaves(v, prefix + (k,))]
    return [(prefix, params)]


class Adam:
    """Adam with beta1 0.9, beta2 0.999, eps 1e-8 and bias correction, on a
    list of leaf tensors; ``m``, ``v`` and ``t`` continue from moments
    after ``t`` steps."""

    def __init__(self, n, m=None, v=None, t=0):
        self.m = list(m) if m is not None else [None] * n
        self.v = list(v) if v is not None else [None] * n
        self.t = t

    def step(self, params, grads, lr):
        self.t += 1
        b1, b2 = 0.9, 0.999
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.m[i] = g * (1 - b1) if self.m[i] is None else b1 * self.m[i] + (1 - b1) * g
            self.v[i] = g * g * (1 - b2) if self.v[i] is None else b2 * self.v[i] + (1 - b2) * g * g
            m_hat = self.m[i] / (1 - b1 ** self.t)
            v_hat = self.v[i] / (1 - b2 ** self.t)
            out.append(p - lr * m_hat / (torch.sqrt(v_hat) + 1e-8))
        return out


def learning_rate(params_cfg, steps_per_epoch, step):
    """The rate of 0-based optimizer step ``step``: ``learning_rate`` times
    ``learning_gamma`` for every boundary (in epochs) already reached."""
    lr = float(params_cfg["learning_rate"])
    for b in params_cfg.get("learning_boundaries", []):
        if step >= int(b) * steps_per_epoch:
            lr *= float(params_cfg.get("learning_gamma", 0.1))
    return lr
