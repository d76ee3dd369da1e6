"""The repository's research tools on the port: each module is the
counterpart of the script of the same name under ``tools/``, which drives
the JAX package.

    python -m vihds_tpu_torch.tools.posterior_parity ours <seed> [epochs] [out_dir] [spec]
    python -m vihds_tpu_torch.tools.posterior_parity compare [out_dir] [spec_label]
        [--against DIR --against_tag reference|ours]
    python -m vihds_tpu_torch.tools.clip_activity [out_dir] [spec]
    python -m vihds_tpu_torch.tools.refine_demo <checkpoints_dir> [spec] [n_particles]
    python -m vihds_tpu_torch.tools.ar_mu_ground_truth run <seed> [out_dir] [n_steps]
    python -m vihds_tpu_torch.tools.ar_mu_ground_truth report [out_dir]
    python -m vihds_tpu_torch.tools.icml_site_mechanism ridge|drift [seed] [out_dir] [epochs ...]
    python -m vihds_tpu_torch.tools.xval_plotting <results_dir> <spec.yaml>

Each takes its script's positional arguments and ``VIHDS_*`` environment
variables and prints the same lines.  Each module's ``main(argv=None,
device="cuda", **depth)`` runs it in process: on the CUDA device unless the
caller asks for the CPU, with keyword cuts of its depth (epochs, steps,
samples) where the tool trains or samples.  A spec name is joined to
``specs/`` (an absolute path passes whole), so a copy of a spec with
``solver: pallas_midpoint``, the fused kernels' route, can be handed in.
Default output directories are under the git-ignored ``build/``; the
best-validation cache of a run goes to a temporary directory, not to the
working directory, which no tool changes.
"""

import os
import tempfile
from types import SimpleNamespace

from vihds_tpu_torch.config import _REPO

#: the JAX tools' training regime: K = 200 samples in training and at each
#: evaluation, an evaluation every 20 epochs, no figures
TRAIN_SAMPLES = 200
TEST_SAMPLES = 200
TEST_EPOCH = 20


def spec_path(spec):
    """``spec`` under the repository's ``specs/`` (an absolute path whole)."""
    return os.path.join(_REPO, "specs", spec)


def build_out(name):
    """The default output directory ``build/<name>`` of the repository."""
    return os.path.join(_REPO, "build", name)


def training_args(spec, seed, epochs, train_samples=TRAIN_SAMPLES, test_samples=TEST_SAMPLES,
                  test_epoch=TEST_EPOCH):
    """``run_xval``'s flags for one split of ``spec`` in the tools' regime."""
    from vihds_tpu_torch.run_xval import create_parser

    args = create_parser(True).parse_args([spec_path(spec)])
    args.seed = seed
    args.epochs = epochs
    args.test_epoch = test_epoch
    args.plot_epoch = 0
    args.train_samples = train_samples
    args.test_samples = test_samples
    return args


def run_training(training):
    """``training.run()`` with its best-validation cache in a temporary
    directory, removed afterwards (the results are read into memory)."""
    with tempfile.TemporaryDirectory(prefix="vihds_tools_cache_") as cache:
        training.cache_dir = cache
        return training.run()


def train(spec, seed, epochs, device, **regime):
    """Train split 1 of 4 of ``spec`` as ``tools/ar_mu_ground_truth.py`` and
    ``tools/icml_site_mechanism.py`` do (``q_global_init: unit``, no
    trainer); ``regime``: ``training_args``'s sample counts.  Returns a
    namespace: data, program, model, training, results (best validation,
    or None), params (the final ones), host and batch (the train split on
    ``device``), q_mu and q_prec (the amortised q on it, numpy)."""
    import numpy as np
    import torch

    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.run_xval import make_training
    from vihds_tpu_torch.training import batch_tensors

    args = training_args(spec, seed, epochs, **regime)
    settings = Config(args)
    settings.trainer = None
    settings.params.q_global_init = "unit"  # the ctrl_unit battery convention
    data, training = make_training(args, settings, device=device)
    results = run_training(training)
    model, params = training.model, training.final_params
    host = data.train.batch()
    times = torch.as_tensor(host.times, dtype=torch.float32, device=device)
    batch = batch_tensors(host, np.arange(host.observations.shape[0]), times, device)
    with torch.no_grad():
        q = model.encoder(params["enc"], batch)
    return SimpleNamespace(data=data, program=training.program, model=model, training=training,
                           results=results, params=params, host=host, batch=batch,
                           q_mu=q.mu.cpu().numpy(), q_prec=q.prec.cpu().numpy())


def to_numpy(x):
    """A tensor (on any device) or an array as a numpy array."""
    import numpy as np

    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
