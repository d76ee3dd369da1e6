"""Hold ``call_run_xval --vmap_folds``'s batched step against each fold's
sequential run, bit for bit.

Two readings on a spec (``--spec``, dr_constant_icml by default) under
``solver: pallas_midpoint`` with 4 folds at B=36 x K=``--samples``:

* one step: the batched 4-fold step (``xfold.VmapXval`` at its initial
  state, the padded last batch of epoch 1, one draw of ``u`` shared by the
  folds) against fold 0's step alone on the same params, rows and draws:
  for each intermediate of the forward (q, theta, the conditioned aR, the
  ODE solution, the log-likelihood terms, log w), for the cotangent of each
  and for every param leaf's gradient, whether the two are equal bit for
  bit and their largest difference;
* one epoch: ``VmapXval.run`` against ``run_xval.make_training(...).run()``
  for folds 1 and 2 (1 epoch, evaluation at K=``--samples`` / ``--test-samples``):
  the largest difference of each fold's params after the epoch over its
  leaf's largest entry, and the train / validation ELBOs of both.

On the card the batched step equals each fold's step bit for bit only while
every op of a fold runs as in a run on that fold alone (``nn.layers.by_fold``)
and cuDNN is deterministic (``utils.resolve_device``); Adam turns last-bit
differences in near-zero gradient entries into learning-rate-sized steps,
so the epoch reading shows whether they hold.  Prints one line a reading and
a JSON line.

    python3 tools/vmap_fold_compare.py            # on the card
    python3 tools/vmap_fold_compare.py --device cpu --samples 4 --test-samples 4

Runs on the card unless ``--device cpu`` is given.
"""

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

FOLDS = 4
SHARED_U_SEED = 0


def _settings(args, spec, flags, vmap):
    from vihds_tpu_torch import call_run_xval
    from vihds_tpu_torch.config import Config, Trainer

    cli = call_run_xval.create_parser(False).parse_args(
        [spec, "--folds", str(FOLDS), "--seed", "0", "--train_samples", str(args.samples),
         "--test_samples", str(args.test_samples)] + flags + (["--vmap_folds"] if vmap else []))
    settings = Config(cli)
    settings.params.solver = "pallas_midpoint"
    settings.trainer = Trainer(cli, add_timestamp=True)
    return cli, settings


def _forward(runner, params, batch, u, mask, folds):
    """The batched (``folds``) or one-fold loss and its intermediates, each
    kept for its cotangent."""
    from vihds_tpu_torch import training as T
    from vihds_tpu_torch.utils.attrdict import AttrDict

    model, prog = runner.model, runner.program
    rec = {}
    q = model.encoder(params["enc"], batch)
    rec["q.mu"], rec["q.prec"] = q.mu, q.prec
    theta = rec["theta"] = prog.sample(q, u)
    th = prog.theta_dict(prog.clip(theta, stddevs=4))
    if model.condition_on_device:
        th = model.ode_model.condition_theta(params["dec"], th, batch.dev_1hot)
    x = rec["x_solution"] = model.ode_model.simulate(params["dec"], th, batch.times,
                                                     batch.inputs, batch.dev_1hot,
                                                     n_iwae=u.shape[1])
    states, prec = model.ode_model.expand_precisions(params["dec"], th, batch.times.shape[0], x)
    out = AttrDict(x_states=states, x_predict=model.ode_model.observe(states, th),
                   precisions=prec, theta=theta, q=q)
    terms = T.iwae_elbo_terms(prog, out, batch, model.use_laplace)
    for k in ("log_p_by_species", "log_q", "log_p", "log_w"):
        rec[k] = terms[k]
    for v in rec.values():
        if v.requires_grad:
            v.retain_grad()
    return rec, -T.iwae_elbo(terms, mask, folds)


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _leaf_names(v, prefix + "/" + k)]
    return [prefix]


def one_step(args, device):
    import torch

    from vihds_tpu_torch import training as T, xfold
    from vihds_tpu_torch.utils.attrdict import AttrDict

    cli, settings = _settings(args, args.spec, [], True)
    runner = xfold.VmapXval(cli, settings, device=device)
    params, _, _ = runner.init_state(device)
    data, n_max = runner._train_data(device)
    idx, mask = runner._chunk_stacks(0, 1, 1, [True] * FOLDS, n_max)
    times = torch.as_tensor(runner.train_hosts[0].times, dtype=torch.float32, device=device)
    s, B = idx.shape[0] - 1, runner.n_batch  # the padded last batch of the epoch
    batch = AttrDict((k, v.index_select(0, idx[s])) for k, v in data.items())
    batch["times"] = times
    u = runner.model.sample_u(torch.Generator(device=device).manual_seed(SHARED_U_SEED), B,
                              args.samples, device)
    rec_v, loss_v = _forward(runner, params, batch, u.repeat(FOLDS, 1, 1), mask[s], FOLDS)
    loss_v.sum().backward()

    def fold0(t):
        if isinstance(t, dict):
            return {k: fold0(v) for k, v in t.items()}
        return t.detach()[0].clone().requires_grad_(True)

    params0 = fold0(params)
    batch0 = AttrDict((k, v[:B]) for k, v in batch.items() if k != "times")
    batch0["times"] = times
    rec_0, loss_0 = _forward(runner, params0, batch0, u, mask[s][:B], None)
    loss_0.backward()
    readings = {"loss": (bool(torch.equal(loss_v[0].detach(), loss_0.detach())),
                         float((loss_v[0] - loss_0).abs()))}
    for k in rec_0:
        a, b = rec_v[k].detach()[:B], rec_0[k].detach()
        readings["fwd " + k] = (bool(torch.equal(a, b)), float((a - b).abs().max()))
        if rec_0[k].grad is not None:
            a, b = rec_v[k].grad[:B], rec_0[k].grad
            readings["bwd d" + k] = (bool(torch.equal(a, b)), float((a - b).abs().max()))
    for name, a, b in zip(_leaf_names(params), T.param_leaves(params), T.param_leaves(params0)):
        readings["grad " + name] = (bool(torch.equal(a.grad[0], b.grad)),
                                    float((a.grad[0] - b.grad).abs().max()))
    for k, (equal, diff) in readings.items():
        print("one step  %-28s bit-equal %-5s largest difference %.3e" % (k, equal, diff))
    return readings


def one_epoch(args, device):
    from vihds_tpu_torch import run_xval, training as T, xfold

    flags = ["--epochs", "1", "--test_epoch", "1", "--plot_epoch", "0"]
    cli, settings = _settings(args, args.spec, flags, True)
    runner = xfold.VmapXval(cli, settings, device=device)
    runner.run()
    cli, settings = _settings(args, args.spec, flags, False)
    out = {}
    for split in (1, 2):
        _, training = run_xval.make_training(cli, settings, split=split, device=device)
        training.run()
        f = split - 1
        worst = max(float((a.detach()[f] - b.detach()).abs().max()
                          / b.detach().abs().max().clamp_min(1e-30))
                    for a, b in zip(T.param_leaves(runner.final_params),
                                    T.param_leaves(training.final_params)))
        out[split] = dict(params_worst=worst,
                          train=(runner.log_datas[f].training_elbo_list,
                                 training.log_data.training_elbo_list),
                          valid=(runner.log_datas[f].validation_elbo_list,
                                 training.log_data.validation_elbo_list))
        print("one epoch fold %d: params' largest difference / leaf max %.3e; train ELBO batched "
              "%s sequential %s; valid batched %s sequential %s"
              % (split, worst, *out[split]["train"], *out[split]["valid"]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spec", default=os.path.join(HERE, "specs", "dr_constant_icml.yaml"))
    ap.add_argument("--samples", type=int, default=200, help="K of a training step")
    ap.add_argument("--test-samples", type=int, default=1000, help="K of the validation split")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from vihds_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    os.environ.setdefault("INFERENCE_RESULTS_DIR", tempfile.mkdtemp())
    card = None
    if device.type == "cuda":
        import chip_smoke

        card = chip_smoke.phase_card()
    result = {"card": card, "device": str(device), "one_step": one_step(args, device),
              "one_epoch": one_epoch(args, device)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
