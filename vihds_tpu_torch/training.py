"""Training engine: IWAE-ELBO steps with Adam and multi-step LR decay,
periodic big-K evaluation, the best-validation cache and the NaN abort; and
the evaluation that serving (``vihds_tpu_torch.predict``) runs: IWAE terms,
importance-weighted posterior-predictive moments, chunked evaluation.

The counterpart of ``vihds_tpu.training`` without its TPU dispatch
pipeline.  PyTorch runs eagerly, so an epoch is a Python loop over steps:
the train split lives on the device, each step gathers its batch there by
index, and the per-step ELBOs stay on the device until the chunk of epochs
up to the next evaluation ends, when one read checks them for NaN.  Under
``solver: pallas_<method>`` a step runs the fused CUDA kernels (``dr_fwd``
forward and ``dr_bwd`` in the backward, or ``dr_prec_fwd`` / ``dr_prec_bwd``
for the precisions models); under a plain fixed-grid solver it
takes the online log-likelihood route (``VAE.forward_logprob``).
On ``merge: false`` data every file keeps its own grid: an epoch steps
through the files in turn, each on its own batches, and the evaluation runs
file by file and snaps its time-indexed outputs onto the shortest grid.
With ``--dreg`` a step takes the doubly-reparameterised gradient
(``dreg_value_and_grad``): one forward and two pulls through the same
graph, through the fused kernels' backward twice where both reach them.
Each evaluation writes TensorBoard scalars (``update_summaries``) to the
writers ``train_<split>`` / ``valid_<split>`` and, every ``plot_epoch``,
figures (``plotting_hooks``), rendered on one background thread
(``HostWorker``; inline where ``VIHDS_SYNC_EVAL`` is set); where tensorboard
or matplotlib is not installed they are left out, said once.  With
``--profile_dir`` the first chunk of epochs after the start epoch is traced
(``profiling.trace``).

The loss, the DReG gradient and the optimizer also take a fold axis
(``folds``, ``vihds_tpu_torch.xfold``): params with a leading ``[F]`` axis,
rows of F folds fold-major, one loss and one gradient clip per fold.

Over several processes (``mesh``, ``vihds_tpu_torch.parallel``) every rank
runs the same host loop in lockstep on the same data, with the mesh ambient
(``parallel.use_mesh``): each step's and each evaluation chunk's decoder
block shards its rows over the mesh's 'data' axis and its draws over
'sample' (``loss_fn``, ``sharded_eval_step``), every rank holds the
whole batch's gradients, and every value a host decision reads (the NaN
stop, the best validation ELBO) is the whole batch's on every rank.  Rank 0
alone writes: the cache, the event files, the checkpoints (the other ranks
wait at a barrier) and the trace.
"""

import math
import os
import time

import numpy as np
import torch

from vihds_tpu_torch import checkpoint as ckpt
from vihds_tpu_torch import parallel, plotting_hooks, profiling
from vihds_tpu_torch.ops.logprob import log_prob_observations
from vihds_tpu_torch.parallel import multihost
from vihds_tpu_torch.results import Results
from vihds_tpu_torch.utils import resolve_device, summary_writer, variable_summaries
from vihds_tpu_torch.utils.attrdict import AttrDict


def prior_as_q(program, device="cpu"):
    """The prior p as q-style tensors."""
    return program.prior_q(device)


def iwae_elbo_terms(program, out, batch, use_laplace):
    """log-weights and components: AttrDict with log_w[B,K],
    log_p_by_species[B,K,S], log_p_obs[B,K], log_q[B,K], log_p[B,K]."""
    log_p_by_species = log_prob_observations(
        out.x_predict, batch.observations, out.precisions, use_laplace
    )
    log_p_obs = log_p_by_species.sum(dim=2)
    log_q = program.log_prob(out.q, out.theta)
    log_p = program.log_prob(prior_as_q(program, out.theta.device), out.theta)
    log_w = log_p_obs + log_p - log_q
    return AttrDict(
        log_w=log_w,
        log_p_by_species=log_p_by_species,
        log_p_obs=log_p_obs,
        log_q=log_q,
        log_p=log_p,
    )


def masked_mean(x, mask, folds=None):
    """The (masked) mean of x [B]; with ``folds``, of each fold's B / folds
    rows (fold-major): [folds]."""
    if folds is not None:
        x = x.reshape(folds, -1)
        if mask is None:
            return x.mean(dim=1)
        mask = mask.reshape(folds, -1)
        return (x * mask).sum(dim=1) / mask.sum(dim=1)
    if mask is None:
        return x.mean()
    return (x * mask).sum() / mask.sum()


def iwae_elbo(terms, mask=None, folds=None):
    """IWAE bound = mean_B(logsumexp_K(log w) - log K); with ``folds``, one
    bound per fold [folds]."""
    n_iwae = terms.log_w.shape[1]
    lse = torch.logsumexp(terms.log_w, dim=1)
    return masked_mean(lse - math.log(n_iwae), mask, folds)


def _importance_weighted_outputs(terms, out):
    """Importance-weighted predictive moments over the K axis."""
    lse = torch.logsumexp(terms.log_w, dim=1, keepdim=True)
    w = torch.exp(terms.log_w - lse)[:, :, None, None]  # [B,K,1,1]
    x_predict = out.x_predict
    precisions = out.precisions
    iw_predict_mu = torch.sum(w * x_predict, 1)
    iw_predict_std = torch.sqrt(
        torch.clamp(
            torch.sum(w * (x_predict ** 2 + 1.0 / precisions), 1) - iw_predict_mu ** 2, min=0.0
        )
    )
    iw_states = torch.sum(w * out.x_states, 1)
    iw_variance = torch.sum(w / precisions * torch.ones_like(x_predict), 1)
    return dict(
        iw_predict_mu=iw_predict_mu,
        iw_predict_std=iw_predict_std,
        iw_states=iw_states,
        iw_variance=iw_variance,
    )


def eval_step(model, program, params, batch, n_samples, generator=None, u=None, with_theta=True,
              folds=None):
    """Evaluate one batch of tensors at K = ``n_samples`` draws, taken from
    ``generator`` or given as ``u[B, K, n_theta]``; ``folds``: the fold
    count of a fold-batched pass (``VAE.forward``).  Returns a dict of
    tensors: per-item ELBO [B], the [B,K] IWAE terms, log_p_by_species,
    q's moments, the importance-weighted moments and (``with_theta``) the
    clipped theta draws [B,K,n_theta]."""
    B = batch.observations.shape[0]
    if u is None:
        u = model.sample_u(generator, B, n_samples, batch.observations.device)
    out = model.forward(params, batch, u, eval_mode=True, folds=folds)
    terms = iwae_elbo_terms(program, out, batch, model.use_laplace)
    res = dict(
        per_item_elbo=torch.logsumexp(terms.log_w, dim=1) - math.log(n_samples),
        log_w=terms.log_w,
        log_p_obs=terms.log_p_obs,
        log_q=terms.log_q,
        log_p=terms.log_p,
        log_p_by_species=terms.log_p_by_species,
        q_mu=out.q.mu,
        q_prec=out.q.prec,
        **_importance_weighted_outputs(terms, out),
    )
    if with_theta:
        res["theta_bkn"] = out.theta_clipped
    return res


def make_results(model, program, merged):
    """Merged eval arrays -> Results (the serving artifact)."""
    res = Results()
    res.init(
        model.state_names,
        program,
        merged.q_mu,
        merged.q_prec,
        merged.get("theta", np.zeros((program.n_theta, 0, 0), np.float32)),
        merged.elbo,
        {k: merged[k] for k in ("iw_predict_mu", "iw_predict_std", "iw_states", "iw_variance")},
    )
    return res


#: the model-facing arrays of a host batch (``enc_observations`` only on
#: ``merge: false`` data)
TRAIN_DATA_KEYS = ("observations", "inputs", "dev_1hot", "enc_observations")

#: the time-indexed outputs that the evaluation of ``merge: false`` data
#: snaps onto the shortest grid
IW_KEYS = ("iw_predict_mu", "iw_predict_std", "iw_states", "iw_variance")


def device_data(host, device):
    """A host batch's model-facing arrays as float32 tensors on ``device``."""
    return {k: torch.as_tensor(host[k], dtype=torch.float32, device=device)
            for k in TRAIN_DATA_KEYS if k in host}


def batch_tensors(host, rows, times, device):
    """Rows ``rows`` of a host batch as float32 tensors on ``device``."""
    batch = AttrDict((k, torch.as_tensor(host[k][rows], dtype=torch.float32, device=device))
                     for k in TRAIN_DATA_KEYS if k in host)
    batch["times"] = times
    return batch


def epoch_perm(seed, e, n_train):
    """Batch permutation for absolute epoch ``e``, a function of (seed, e)
    alone, so a resumed run sees the uninterrupted run's batch orders (the
    JAX package's ``training.epoch_perm``, bit for bit)."""
    return np.random.RandomState((seed * 1_000_003 + e) % (2 ** 32)).permutation(n_train)


def build_epoch_stacks(seed, epoch, end_epoch, n_batch, n_batches, n_train):
    """Shuffled, padded batch-index grids for epochs [epoch, end_epoch]:
    {idx: [n_ep*n_batches, n_batch] int32, mask: same-shape float32}.  Pad
    rows repeat index 0 and carry mask 0 (the JAX package's grids, bit for
    bit)."""
    n_ep = end_epoch - epoch + 1
    pad_total = n_batches * n_batch - n_train
    perms = np.stack([epoch_perm(seed, e, n_train) for e in range(epoch, end_epoch + 1)])
    masks = np.ones((n_ep, n_batches * n_batch), np.float32)
    if pad_total:
        masks[:, n_train:] = 0.0
        perms = np.concatenate([perms, np.zeros((n_ep, pad_total), int)], axis=1)
    return dict(
        idx=perms.reshape(n_ep * n_batches, n_batch).astype(np.int32),
        mask=masks.reshape(n_ep * n_batches, n_batch),
    )


def file_epoch_stacks(seed, e, sizes, n_batch):
    """Per-file shuffled, padded batch-index grids of absolute epoch ``e`` on
    ``merge: false`` data: one {idx: [n_batches_f, n_batch] int32, mask} for
    each file of ``sizes[f]`` train rows.  The permutations are drawn in file
    order from one stream of (seed, e), so a resumed run replays the same
    batches (the JAX package's ``_run_multi_epochs``, bit for bit)."""
    rng = np.random.RandomState((seed * 1_000_003 + e) % (2 ** 32))
    stacks = []
    for n_f in sizes:
        nb = max(1, math.ceil(n_f / n_batch))
        perm = rng.permutation(n_f)
        pad = nb * n_batch - n_f
        mask = np.ones(nb * n_batch, np.float32)
        if pad:
            mask[n_f:] = 0.0
            perm = np.concatenate([perm, np.zeros(pad, int)])
        stacks.append(dict(idx=perm.reshape(nb, n_batch).astype(np.int32),
                           mask=mask.reshape(nb, n_batch)))
    return stacks


def stacks_to(host_stacks, device):
    """Host index grids {idx, mask} as tensors on ``device``."""
    return {"idx": torch.as_tensor(host_stacks["idx"], dtype=torch.int64, device=device),
            "mask": torch.as_tensor(host_stacks["mask"], device=device)}


def param_leaves(params):
    """The tensors of a nested param dict, in a fixed (insertion) order."""
    if isinstance(params, dict):
        return [leaf for v in params.values() for leaf in param_leaves(v)]
    return [params]


def learning_rate(p, steps_per_epoch, count):
    """The learning rate of the optimizer step with 0-based index ``count``:
    ``learning_rate`` times ``learning_gamma`` once for every boundary
    ``b * steps_per_epoch`` that ``count`` has reached (optax's
    ``piecewise_constant_schedule`` as the JAX package's ``make_optimizer``
    builds it)."""
    lr = float(p.learning_rate)
    for b in p.learning_boundaries:
        if count >= int(b) * steps_per_epoch:
            lr *= float(p.learning_gamma)
    return lr


def clip_scale(grads, clip_norm, folds=None):
    """optax.clip_by_global_norm's factor: max_norm / |g| where |g| >=
    max_norm, else 1.  With ``folds`` (leaves [F, ...]) one factor per fold
    from that fold's own norm, [F, 1] (what the clip gives under
    ``jax.vmap``), each summed as a run on that fold alone sums it."""
    if folds is not None:
        return torch.stack([clip_scale([g[f] for g in grads], clip_norm)
                            for f in range(folds)])[:, None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    return torch.where(norm < clip_norm, torch.ones_like(norm), clip_norm / norm)


class Optimizer:
    """The counterpart of the JAX package's ``make_optimizer``: Adam with the
    multi-step learning-rate decay and the optional global gradient-norm
    clip (``params.grad_clip_norm``).  ``torch.optim.Adam``'s update with its
    default betas and eps is optax's ``adam``; ``count`` is the schedule's
    step.  With ``folds`` the leaves carry a fold axis and each fold is
    clipped by its own norm; Adam is elementwise and the schedule's count is
    shared, so the rest is each fold's own optimizer as it stands."""

    def __init__(self, params, p, steps_per_epoch, folds=None):
        self.leaves = param_leaves(params)
        self.p = p
        self.steps_per_epoch = steps_per_epoch
        self.folds = folds
        self.clip_norm = p.get("grad_clip_norm")
        self.adam = torch.optim.Adam(self.leaves, lr=learning_rate(p, steps_per_epoch, 0))
        self.count = 0

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def step(self):
        if self.clip_norm:
            grads = [leaf.grad for leaf in self.leaves if leaf.grad is not None]
            scale = clip_scale(grads, self.clip_norm, self.folds)
            for g in grads:
                g.mul_(scale if self.folds is None
                       else scale.reshape((self.folds,) + (1,) * (g.dim() - 1)))
        for group in self.adam.param_groups:
            group["lr"] = learning_rate(self.p, self.steps_per_epoch, self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self):
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state):
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def loss_fn(model, program, params, batch, mask, u, folds=None):
    """-IWAE ELBO of one batch at the draws ``u`` [B, K, n_theta].  Fixed-grid
    solvers take the online log-likelihood route (``forward_logprob``, each
    step recomputed in the backward); ``pallas_<method>`` the trajectory
    route through the fused kernels.  log q and log p score the sampled
    theta.  With ``folds`` (params with a fold axis, the batch's rows the
    folds', fold-major) it returns each fold's loss [folds]; their sum's
    gradient is each fold's own, since the folds share no param.  Under an
    ambient mesh (``parallel.use_mesh``) the decoder block shards over its
    ranks (``VAE.forward_sharded``) and every rank gets the whole batch's
    loss and gradients."""
    mesh = parallel.active_mesh()
    if mesh is not None or model.ode_model.supports_fold():
        out = (model.forward_logprob(params, batch, u) if mesh is None
               else model.forward_sharded(params, batch, u, mesh))
        log_p_obs = out.log_p_by_species.sum(dim=2)
        log_q = program.log_prob(out.q, out.theta)
        log_p = program.log_prob(prior_as_q(program, out.theta.device), out.theta)
        terms = AttrDict(log_w=log_p_obs + log_p - log_q)
    else:
        out = model.forward(params, batch, u, folds=folds)
        terms = iwae_elbo_terms(program, out, batch, model.use_laplace)
    return -iwae_elbo(terms, mask, folds)


def dreg_value_and_grad(model, program, params, batch, mask, u, folds=None):
    """The doubly-reparameterised gradient estimator (DReG, Tucker et al.
    2019) of the IWAE bound for one batch at the draws ``u``: the
    counterpart of ``vihds_tpu.training.dreg_value_and_grad``.

    One forward through the route ``loss_fn`` takes gives two log-weights:
    ``log_w_std`` (log q differentiable) and ``log_w_dreg`` (log q with q's
    parameters detached; theta stays differentiable, so only the
    reparameterised sample path carries gradient).  Then two pulls through
    the same graph, each restricted to its leaves:

      * the decoder's leaves take the standard IWAE gradient: cotangent
        w-tilde * coeff on ``log_w_std`` (skipped where the decoder has no
        leaves);
      * the encoder's leaves take the DReG gradient: cotangent
        w-tilde^2 * coeff on ``log_w_dreg``.

    Both pulls run a fused kernel's backward where they reach it, on the
    one saved context.  Returns (-ELBO, {"enc": [...], "dec": [...]}), the
    gradients of -ELBO in the order of ``param_leaves`` of each part.  With
    ``folds`` (as ``loss_fn``) -ELBO is [folds] and each fold's rows weigh by
    that fold's mask."""
    mesh = parallel.active_mesh()
    if mesh is not None:
        out = model.forward_sharded(params, batch, u, mesh)
        log_p_by_species = out.log_p_by_species
    elif model.ode_model.supports_fold():
        out = model.forward_logprob(params, batch, u)
        log_p_by_species = out.log_p_by_species
    else:
        out = model.forward(params, batch, u, folds=folds)
        log_p_by_species = log_prob_observations(
            out.x_predict, batch.observations, out.precisions, model.use_laplace
        )
    log_lik = log_p_by_species.sum(dim=2)
    log_p = program.log_prob(prior_as_q(program, out.theta.device), out.theta)
    log_q = program.log_prob(out.q, out.theta)
    q_sg = AttrDict((k, v.detach()) for k, v in out.q.items())
    log_q_sg = program.log_prob(q_sg, out.theta)
    log_w_std = log_lik + log_p - log_q
    log_w_dreg = log_lik + log_p - log_q_sg

    B, n_iwae = log_w_std.shape
    log_w = log_w_std.detach()
    lse = torch.logsumexp(log_w, dim=1, keepdim=True)
    elbo = masked_mean(lse[:, 0] - math.log(n_iwae), mask, folds)
    w_tilde = torch.exp(log_w - lse)  # [B, K]
    n_folds = folds or 1
    if mask is None:
        coeff = torch.full((B, 1), n_folds / B, device=log_w.device)
    elif folds is None:
        coeff = (mask / mask.sum())[:, None]
    else:
        m = mask.reshape(folds, -1)
        coeff = (m / m.sum(dim=1, keepdim=True)).reshape(B, 1)
    grads = {}
    pulls = (("dec", log_w_std, w_tilde * coeff), ("enc", log_w_dreg, w_tilde ** 2 * coeff))
    for i, (part, target, cotangent) in enumerate(pulls):
        leaves = param_leaves(params[part])
        if not leaves:
            grads[part] = []
            continue
        got = torch.autograd.grad(target, leaves, grad_outputs=cotangent,
                                  retain_graph=i == 0, allow_unused=True)
        # d(-elbo)/dparams; a leaf the pull does not reach has a zero gradient
        grads[part] = [-g if g is not None else torch.zeros_like(leaf)
                       for g, leaf in zip(got, leaves)]
    return -elbo.detach(), grads


def sharded_eval_step(model, program, params, batch, n_samples, u, mesh, with_theta=True):
    """``eval_step``'s outputs for one chunk, whole on every rank, its
    decoder block sharded over ``mesh``: every rank encodes, draws
    (``u[B, K, n_theta]``, all of it), clips and conditions the whole chunk;
    the block (integration, observation, likelihood) runs on this rank's
    rows and samples; the blocks' log-likelihoods are assembled whole, so the
    IWAE terms and each row's logsumexp are the one-process ones; each row's
    importance-weighted moments are summed over this rank's samples, added
    over the sample ranks and joined over the data ranks."""
    q = model.encoder(params["enc"], batch)
    theta = model.program.sample(q, u)
    clipped = model.program.clip(theta, stddevs=4)
    th = model.condition(params, clipped, batch)
    B, K = u.shape[:2]
    block = {k: mesh.block(v.expand((B, K) + tuple(v.shape[2:])), B, K) for k, v in th.items()}
    rows = multihost.host_local_batch_to_global(mesh, batch)
    Ks = parallel.shard_span(K, mesh.shape["sample"], mesh.sample_index)[1]
    with parallel.block_scope(mesh, B, K):
        x_states, x_predict, precisions = model.integrate(params["dec"], block, rows, Ks,
                                                          eval_mode=True)
    log_p_by_species = mesh.gather_blocks({"lp": log_prob_observations(
        x_predict, rows.observations, precisions, model.use_laplace)}, B, K)["lp"]
    log_p_obs = log_p_by_species.sum(dim=2)
    log_q = program.log_prob(q, theta)
    log_p = program.log_prob(prior_as_q(program, theta.device), theta)
    log_w = log_p_obs + log_p - log_q
    lse = torch.logsumexp(log_w, dim=1)
    w = torch.exp(mesh.block(log_w, B, K, pad=0.0) - mesh.rows(lse, B)[:, None])
    w = torch.where(mesh.real(B, K, w.device), w, torch.zeros_like(w))[:, :, None, None]
    sums = mesh.sum_samples(dict(
        mu=torch.sum(w * x_predict, 1),
        second=torch.sum(w * (x_predict ** 2 + 1.0 / precisions), 1),
        states=torch.sum(w * x_states, 1),
        variance=torch.sum(w / precisions * torch.ones_like(x_predict), 1),
    ))
    iw = mesh.cat_rows(dict(
        iw_predict_mu=sums["mu"],
        iw_predict_std=torch.sqrt(torch.clamp(sums["second"] - sums["mu"] ** 2, min=0.0)),
        iw_states=sums["states"],
        iw_variance=sums["variance"],
    ), B)
    res = dict(per_item_elbo=lse - math.log(n_samples), log_w=log_w, log_p_obs=log_p_obs,
               log_q=log_q, log_p=log_p, log_p_by_species=log_p_by_species, q_mu=q.mu,
               q_prec=q.prec, **iw)
    if with_theta:
        res["theta_bkn"] = clipped
    return res


def _np_logsumexp(x, axis):
    m = np.max(x, axis=axis, keepdims=True)
    return (m + np.log(np.sum(np.exp(x - m), axis=axis, keepdims=True))).squeeze(axis)


def update_summaries(writer, epoch, merged, program, settings):
    """The TensorBoard scalars of one evaluated split (``merged``, the
    numpy arrays of ``Training.evaluate`` with the full ``log_w`` terms):
    q's moments per site, the unnormalised and normalised importance
    weights of one series, and the ELBO and its parts (the JAX package's
    ``update_summaries``, tag for tag)."""
    if writer is None:
        return
    plot_histograms = settings.params.plot_histograms
    prog = program
    n_var = len(prog.sites.local) + len(prog.sites.global_cond)
    for i, site in enumerate(prog.sites.ordered):
        if bool(prog.is_constant[i]):
            continue
        if i < n_var:
            variable_summaries(writer, epoch, merged.q_mu[:, i], site.name + ".mu", plot_histograms)
            variable_summaries(
                writer, epoch, merged.q_prec[:, i], site.name + ".prec", plot_histograms
            )
        else:
            writer.add_scalar("%s/mu" % site.name, float(merged.q_mu[:, i].mean()), epoch)
            writer.add_scalar("%s/prec" % site.name, float(merged.q_prec[:, i].mean()), epoch)
    log_w = merged.log_w
    K = log_w.shape[1]
    ts = min(1, log_w.shape[0] - 1)
    logw_row = log_w[ts, :]
    lse_p_obs = _np_logsumexp(merged.log_p_obs, 1)
    lse_p = _np_logsumexp(merged.log_p, 1)
    lse_q = _np_logsumexp(merged.log_q, 1)
    sp = np.stack(
        [_np_logsumexp(merged.log_p_by_species[:, :, i], 1)
         for i in range(merged.log_p_by_species.shape[2])], axis=-1,
    )
    normed_row = np.exp(logw_row - (merged.per_item_elbo[ts] + math.log(K)))
    variable_summaries(writer, epoch, logw_row, "IWS_unn_log", plot_histograms)
    variable_summaries(writer, epoch, normed_row, "IWS_normed", plot_histograms)
    writer.add_scalar("ELBO/elbo", merged.elbo, epoch)
    writer.add_scalar("ELBO/log_p", float(lse_p_obs.mean()), epoch)
    for i, name in enumerate(settings.data.signals):
        writer.add_scalar("ELBO/log_p_" + name, float(sp[:, i].mean()), epoch)
    writer.add_scalar("ELBO/log_prior", float(lse_p.mean()), epoch)
    writer.add_scalar("ELBO/loq_q", float(lse_q.mean()), epoch)


class TrainingLogData:
    """Counters collected for logging during training."""

    def __init__(self):
        self.training_elbo_list = []
        self.validation_elbo_list = []
        self.total_train_time = 0.0
        self.total_test_time = 0.0
        self.n_test = 0
        self.max_val_elbo = -float("inf")


class HostWorker:
    """One daemon thread that runs submitted callables in order: the
    figures of an evaluation (rendering and their TensorBoard writes), so
    that drawing them does not hold the training loop.  Every value a figure
    shows is computed on the training thread before it is submitted; only
    the rendering moves.  A figure that raises prints its traceback and
    training goes on.  Where ``VIHDS_SYNC_EVAL`` is set, ``for_run`` gives
    None and the callers render inline (the JAX package's ``HostWorker``)."""

    def __init__(self):
        import queue
        import threading

        self._q = queue.Queue()
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    @classmethod
    def for_run(cls, settings):
        """A worker for a run that writes TensorBoard files, else None."""
        if getattr(settings, "trainer", None) is None or os.environ.get("VIHDS_SYNC_EVAL"):
            return None
        return cls()

    def _loop(self):
        import traceback

        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:  # a failed figure must not stop training
                traceback.print_exc()

    def submit(self, fn):
        self._q.put(fn)

    def join(self):
        """Run what was submitted to its end and stop the thread."""
        self._q.put(None)
        self._t.join()


def run_on(worker, fn):
    """``fn()`` on ``worker``, or here and now where it is None."""
    if worker is None:
        fn()
    else:
        worker.submit(fn)


def elapsed_ms(marks):
    """Milliseconds between consecutive marks of ``Training.train_epochs``
    (CUDA events, read after the device has caught up, or host clocks)."""
    if isinstance(marks[0], float):
        return [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


class Training:
    """Trains a VAE on one train/validation split with the IWAE bound, and
    evaluates host batches for serving.

    ``args`` carries the training flags of ``run_xval`` (``epochs``,
    ``test_epoch``, ``plot_epoch``, ``train_samples``, ``test_samples``,
    ``split``/``heldout``, ``folds``, ``checkpoint_epoch``, ``resume_from``,
    ``dreg``, ``profile_dir``); serving needs none.
    ``run`` trains on ``device`` ("cuda" unless the caller asks for the
    CPU), sharded over ``mesh`` where it spans several ranks."""

    def __init__(self, settings, data, program, model, args=None, device="cuda", mesh=None):
        self.settings = settings
        self.program = program
        self.model = model
        self.args = args
        self.device = device
        # a mesh of one rank shards nothing: the unsharded step runs
        self.mesh = mesh if multihost.is_multiprocess_mesh(mesh) else None
        self.dataset_pair = data
        self.n_batch = min(settings.params.n_batch, data.n_train)
        # merge: false data: per-file work units on each file's native grid
        ds = data.train.dataset
        self.multi = hasattr(ds, "files")
        if self.multi:
            self.enc_idx = ds.enc_idx
            self.train_groups = [(i, ds.file_batch(i, local), pos)
                                 for i, local, pos in ds.group_by_file(data.train.indices)]
            self.valid_groups = [(i, ds.file_batch(i, local), pos)
                                 for i, local, pos in ds.group_by_file(data.test.indices)]
            self.steps_per_epoch = sum(
                max(1, math.ceil(host.observations.shape[0] / self.n_batch))
                for _, host, _ in self.train_groups
            )
        else:
            self.steps_per_epoch = max(1, math.ceil(data.n_train / self.n_batch))
        held_out = getattr(args, "heldout", None) or "%d_of_%d" % (
            getattr(args, "split", 1), getattr(args, "folds", 4)
        )
        trainer = getattr(settings, "trainer", None)
        if trainer is not None:
            # one best-validation cache per experiment and fold
            self.cache_dir = os.path.join(trainer.tb_log_dir, ".vihds_cache_%s" % held_out)
            self.ckpt_dir = os.path.join(trainer.tb_log_dir, "checkpoints_%s" % held_out)
            # the TensorBoard writers' directories
            self.train_path = os.path.join(trainer.tb_log_dir, "train_%s" % held_out)
            self.valid_path = os.path.join(trainer.tb_log_dir, "valid_%s" % held_out)
        else:
            # the trainer-less ranks of a --distributed launch write nothing:
            # they keep their best validation results in memory
            self.cache_dir = ".vihds_cache" if multihost.is_main() else None
            self.ckpt_dir = None
            self.train_path = self.valid_path = None
        self.empty_cache = True
        self._best = None
        #: milliseconds of each optimizer step of the last ``run``
        self.step_ms = []
        #: the figures' thread during ``run`` (``HostWorker``), else None
        self.host_worker = None

    def evaluate(self, params, host, n_samples, generator, device="cuda", with_theta=True):
        """Evaluate a host batch (numpy observations[B,S,T] training-scaled,
        inputs[B,C] log1p, dev_1hot[B,D], times[T]) at K = ``n_samples``.

        Runs in chunks of ``n_batch`` rows; the last chunk is padded with row
        0 and the padding dropped afterwards (IWAE is exact under chunking).
        Returns (merged numpy arrays, Results)."""
        merged = self._evaluate_arrays(params, host, n_samples, generator, device, with_theta)
        return merged, make_results(self.model, self.program, merged)

    def _evaluate_arrays(self, params, host, n_samples, generator, device, with_theta):
        """``evaluate``'s merged numpy arrays."""
        device = resolve_device(device)
        n = host.observations.shape[0]
        chunk = self.n_batch
        n_chunks = math.ceil(n / chunk)
        idx = np.concatenate([np.arange(n), np.zeros(n_chunks * chunk - n, int)])
        times = torch.as_tensor(host.times, dtype=torch.float32, device=device)
        parts = []
        with torch.no_grad():
            for rows in idx.reshape(n_chunks, chunk):
                batch = batch_tensors(host, rows, times, device)
                if self.mesh is None:
                    res = eval_step(
                        self.model, self.program, params, batch, n_samples,
                        generator=generator, with_theta=with_theta,
                    )
                else:
                    u = self.model.sample_u(generator, chunk, n_samples, device)
                    res = sharded_eval_step(self.model, self.program, params, batch, n_samples,
                                            u, self.mesh, with_theta=with_theta)
                parts.append({k: v.cpu().numpy() for k, v in res.items()})
        merged = AttrDict((k, np.concatenate([p[k] for p in parts])[:n]) for k in parts[0])
        if with_theta:
            merged["theta"] = np.transpose(merged.pop("theta_bkn"), (2, 0, 1))  # [n_theta, B, K]
        merged["elbo"] = float(np.mean(merged["per_item_elbo"]))
        return merged

    def evaluate_groups(self, params, groups, n_samples, generator, device="cuda",
                        with_theta=True):
        """Evaluate a ``merge: false`` split file by file (``groups`` as
        ``train_groups``), each on its native grid, drawing from
        ``generator`` in file order; the time-indexed outputs are snapped
        onto the shortest grid and every array is put back in the split's
        row order (the JAX package's ``_eval_multi``).  Returns the merged
        numpy arrays."""
        n_total = sum(len(pos) for _, _, pos in groups)
        merged = AttrDict()
        for file_i, host, pos in groups:
            part = self._evaluate_arrays(params, host, n_samples, generator, device, with_theta)
            part.pop("elbo")
            snap = self.enc_idx[file_i]
            for name in IW_KEYS:
                part[name] = part[name][:, :, snap]
            for name, v in part.items():
                if name == "theta":  # [n_theta, B, K]
                    if name not in merged:
                        merged[name] = np.zeros((v.shape[0], n_total) + v.shape[2:], v.dtype)
                    merged[name][:, pos] = v
                else:
                    if name not in merged:
                        merged[name] = np.zeros((n_total,) + v.shape[1:], v.dtype)
                    merged[name][pos] = v
        merged["elbo"] = float(np.mean(merged["per_item_elbo"]))
        return merged

    def _evaluate_split(self, params, which, n_samples, generator, device, with_theta):
        """Merged arrays of the ``"train"`` or ``"valid"`` split."""
        if self.multi:
            groups = self.train_groups if which == "train" else self.valid_groups
            return self.evaluate_groups(params, groups, n_samples, generator, device, with_theta)
        host = self.train_data if which == "train" else self.valid_data
        return self._evaluate_arrays(params, host, n_samples, generator, device, with_theta)

    # ------------------------------------------------------------- training
    def train_epochs(self, params, opt, generator, stacks, data, times):
        """One optimizer step for each row of ``stacks`` ({idx, mask}
        [n_steps, B] tensors on the device), each batch gathered by index
        from the device-resident split ``data``.  Returns the per-step ELBOs
        [n_steps] on the device, unread, and a time mark after each step
        (``elapsed_ms`` reads them once the device has caught up)."""
        K = self.args.train_samples
        dreg = getattr(self.args, "dreg", False)
        n_steps = stacks["idx"].shape[0]
        cuda = times.device.type == "cuda"
        marks = [self._mark(cuda)]
        elbos = []
        for s in range(n_steps):
            idx = stacks["idx"][s]
            batch = AttrDict((k, v.index_select(0, idx)) for k, v in data.items())
            batch["times"] = times
            u = self.model.sample_u(generator, idx.shape[0], K, times.device)
            opt.zero_grad()
            if dreg:
                loss, grads = dreg_value_and_grad(self.model, self.program, params, batch,
                                                  stacks["mask"][s], u)
                for part, part_grads in grads.items():
                    for leaf, g in zip(param_leaves(params[part]), part_grads):
                        leaf.grad = g
            else:
                loss = loss_fn(self.model, self.program, params, batch, stacks["mask"][s], u)
                loss.backward()
            opt.step()
            elbos.append(-loss.detach())
            marks.append(self._mark(cuda))
        return torch.stack(elbos), marks

    @staticmethod
    def _mark(cuda):
        """A CUDA event recorded on the current stream, or the host clock."""
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()


    def _eval_boundary(self, params, epoch, log_data, device, writers=(None, None)):
        """The big-K evaluation at a ``test_epoch`` boundary: the full train
        split at K=``train_samples`` and the validation split at
        K=``test_samples``; a new best validation ELBO is dumped to the
        cache.  Each split's scalars go to its writer of ``writers`` (train,
        valid), and at a ``plot_epoch`` its figures.  Prints the JAX
        package's ``epoch N | train (...) | val (...)`` line."""
        args = self.args
        train_writer, valid_writer = writers
        t0 = time.time()
        print("epoch %4d" % epoch, end="", flush=True)
        log_data.n_test += 1
        plot_epoch = getattr(args, "plot_epoch", 0) or 0
        plot = plot_epoch > 0 and epoch % plot_epoch == 0
        # the weighted-theta figure reads the train split's theta draws
        want_theta_plot = bool(getattr(self.settings.params, "theta_columns", None)) and plot
        dynamic = self.model.ode_model.precisions.dynamic
        seed = self.settings.seed or 0
        gen = torch.Generator(device=device).manual_seed((seed * 1_000_003 + epoch) % (2 ** 62))
        train_merged = self._evaluate_split(
            params, "train", args.train_samples, gen, device, with_theta=want_theta_plot
        )
        update_summaries(train_writer, epoch, train_merged, self.program, self.settings)
        print(
            " | train (iwae-elbo = %0.4f, time = %0.2f, total = %0.2f)"
            % (train_merged.elbo, log_data.total_train_time / epoch, log_data.total_train_time),
            end="",
            flush=True,
        )
        valid_merged = self._evaluate_split(
            params, "valid", args.test_samples, gen, device, with_theta=True
        )
        update_summaries(valid_writer, epoch, valid_merged, self.program, self.settings)
        if valid_merged.elbo > log_data.max_val_elbo:
            log_data.max_val_elbo = valid_merged.elbo
            best = make_results(self.model, self.program, valid_merged)
            if self.cache_dir is None:
                self._best = best
            else:
                best.dump(self.cache_dir)
            self.empty_cache = False
        log_data.training_elbo_list.append(train_merged.elbo)
        log_data.validation_elbo_list.append(valid_merged.elbo)
        log_data.total_test_time += time.time() - t0
        print(
            " | val (iwae-elbo = %0.4f, time = %0.2f, total = %0.2f)"
            % (valid_merged.elbo, log_data.total_test_time / log_data.n_test,
               log_data.total_test_time)
        )
        if plot:
            # after the epoch's line, so what the hooks say stands on lines
            # of its own; the values here, the rendering on the host worker
            # (inline without one), its time counted as test time
            t0 = time.time()
            outputs = [(writer, dataset, make_results(self.model, self.program, merged))
                       for writer, dataset, merged in (
                           (train_writer, self.train_data, train_merged),
                           (valid_writer, self.valid_data, valid_merged)) if writer is not None]

            def figures():
                for writer, dataset, output in outputs:
                    plotting_hooks.eval_plots(self, writer, epoch, dataset, output,
                                              dynamic=dynamic)
                if want_theta_plot:
                    plotting_hooks.weighted_theta_plot(self, valid_writer, epoch, train_merged)

            run_on(self.host_worker, figures)
            log_data.total_test_time += time.time() - t0

    def init_state(self, device):
        """Fresh params (from a CPU generator seeded with the spec seed), the
        optimizer and the training generator on ``device``."""
        seed = self.settings.seed or 0
        params = self.model.init_params(torch.Generator().manual_seed(seed), device=device)
        for leaf in param_leaves(params):
            leaf.requires_grad_(True)
        opt = Optimizer(params, self.settings.params, self.steps_per_epoch)
        generator = torch.Generator(device=device).manual_seed(seed)
        return params, opt, generator

    def run(self):
        """Train for ``args.epochs`` epochs, evaluating every
        ``args.test_epoch``; returns the best-validation ``Results`` (with
        ``elbo_list``), or None when no evaluation finished.  The writers
        ``train_<split>`` / ``valid_<split>`` are open for the run."""
        device = resolve_device(self.device)
        writers = (None, None)
        if self.train_path is not None:
            writers = (summary_writer(self.train_path), summary_writer(self.valid_path))
        self.host_worker = HostWorker.for_run(self.settings)
        try:
            with parallel.use_mesh(self.mesh):
                return self._run(device, writers)
        finally:
            if self.host_worker is not None:
                self.host_worker.join()
                self.host_worker = None
            for writer in writers:
                if writer is not None:
                    writer.close()

    def _run(self, device, writers):
        """``run`` with its writers open."""
        args = self.args
        seed = self.settings.seed or 0
        params, opt, generator = self.init_state(device)

        ckpt_every = getattr(args, "checkpoint_epoch", 0) or 0
        start_epoch = 1
        resume_from = getattr(args, "resume_from", None)
        if self.mesh is not None and (ckpt_every or resume_from):
            # rank 0's directory on every rank (the others have no trainer):
            # every rank calls ckpt.save, rank 0 writes
            self.ckpt_dir = multihost.broadcast_string(self.ckpt_dir or "") or None
        if resume_from:
            # restored on the host (every rank the same file): Adam keeps its
            # step counts there, and the generator state is a CPU tensor
            # whatever the generator's device
            _, state = ckpt.restore(resume_from)
            if state is not None:
                with torch.no_grad():
                    for leaf, saved in zip(param_leaves(params), param_leaves(state["params"])):
                        leaf.copy_(saved)
                opt.load_state_dict(state["opt_state"])
                generator.set_state(state["generator"])
                start_epoch = int(state["epoch"]) + 1
                print("Resumed from %s at epoch %d" % (resume_from, start_epoch - 1))

        n_train = self.dataset_pair.n_train
        self.train_data = self.dataset_pair.train.batch()
        self.valid_data = self.dataset_pair.test.batch()
        # the train split (on merge: false data, each file's part of it, with
        # its own grid) lives on the device for the whole run
        if self.multi:
            sizes = [host.observations.shape[0] for _, host, _ in self.train_groups]
            file_data = [
                (device_data(host, device),
                 torch.as_tensor(host.times, dtype=torch.float32, device=device))
                for _, host, _ in self.train_groups
            ]
        else:
            times = torch.as_tensor(self.train_data.times, dtype=torch.float32, device=device)
            train_dev = device_data(self.train_data, device)
        n_batches = math.ceil(n_train / self.n_batch)

        log_data = TrainingLogData()
        print("---------------------------")
        if getattr(args, "heldout", None):
            print("Training: heldout device = %s" % args.heldout)
        else:
            print("Training: split %d of %d" % (args.split, args.folds))
        self.step_ms = []

        def next_boundary(e):
            """The last epoch of the chunk starting at ``e``: the next eval,
            checkpoint or final epoch."""
            te = args.test_epoch
            cands = [args.epochs, ((e - 1) // te + 1) * te]
            if ckpt_every:
                cands.append(((e - 1) // ckpt_every + 1) * ckpt_every)
            return min(cands)

        profile_dir = getattr(args, "profile_dir", None)
        traced = False
        epoch = start_epoch
        end_epoch = None
        while epoch < args.epochs + 1:
            t0 = time.time()
            end_epoch = next_boundary(epoch)
            # one trace: the first chunk after the start epoch (the first
            # chunk carries the kernels' first launches)
            do_trace = (bool(profile_dir) and not traced and epoch > start_epoch
                        and multihost.is_main())
            with profiling.trace(profile_dir if do_trace else None,
                                 "epochs_%d-%d" % (epoch, end_epoch)):
                if self.multi:
                    # one pass over the files an epoch, each on its own grid
                    runs = []
                    for e in range(epoch, end_epoch + 1):
                        for host_stacks, (data_f, times_f) in zip(
                                file_epoch_stacks(seed, e, sizes, self.n_batch), file_data):
                            runs.append(self.train_epochs(params, opt, generator,
                                                          stacks_to(host_stacks, device), data_f,
                                                          times_f))
                else:
                    host_stacks = build_epoch_stacks(
                        seed, epoch, end_epoch, self.n_batch, n_batches, n_train
                    )
                    runs = [self.train_epochs(params, opt, generator,
                                              stacks_to(host_stacks, device), train_dev, times)]
            traced = traced or do_trace
            elbos = torch.cat([r[0] for r in runs])
            finite = bool(torch.isfinite(elbos).all())  # the chunk's one read
            for _, marks in runs:
                self.step_ms += elapsed_ms(marks)
            log_data.total_train_time += time.time() - t0
            if not finite:
                print("Cannot proceed with ELBO = nan. Exiting.")
                break
            epoch = end_epoch
            if epoch % args.test_epoch == 0:
                self._eval_boundary(params, epoch, log_data, device, writers)
            if ckpt_every and self.ckpt_dir and epoch % ckpt_every == 0:
                ckpt.save(self.ckpt_dir, epoch, {
                    "params": params,
                    "opt_state": opt.state_dict(),
                    "generator": generator.get_state(),
                    "epoch": epoch,
                })
            epoch += 1
        if profile_dir and not traced and multihost.is_main() and end_epoch is not None:
            print(profiling.untraced_line(profile_dir, start_epoch, end_epoch))

        self.final_params = params
        self.log_data = log_data
        if self.empty_cache:
            print("Exiting with no results in cache")
            return None
        if self.cache_dir is None:
            final = self._best
        else:
            final = Results()
            final.load(self.cache_dir)
        final.elbo_list = log_data.validation_elbo_list
        return final
