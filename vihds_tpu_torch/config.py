"""Configuration layer: YAML spec + CLI args -> settings object.

The same YAML schema as ``vihds_tpu.config`` (``data:`` / ``model:`` /
``params:`` with the five parameter tiers) and the same defaults, so one spec
drives both packages.
"""

import datetime
import os
import re
import shutil
from collections import OrderedDict

import numpy as np
import yaml

from vihds_tpu_torch.utils.attrdict import attrdictify

#: the repository's root, which holds ``specs/`` and ``data/``
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Default hyper-parameters merged under YAML ``params:`` (the JAX package's
#: ``config.DEFAULT_PARAMS``; both packages must resolve a spec identically).
DEFAULT_PARAMS = dict(
    solver="midpoint",
    adjoint_solver=False,
    use_laplace=False,
    n_filters=10,
    filter_size=10,
    pool_size=5,
    lambda_l2=0.001,
    lambda_l2_hidden=0.001,
    n_hidden=50,
    n_hidden_decoder=50,
    n_batch=36,
    data_format="channels_last",
    precision_type="constant",
    precision_alpha=1000.0,
    precision_beta=1.0,
    init_prec=0.00001,
    init_latent_species=0.001,
    transfer_func="tanh",
    n_hidden_decoder_precisions=20,
    n_growth_layers=4,
    tb_gradients=False,
    plot_histograms=False,
    learning_boundaries=[250, 500],
    learning_rate=0.01,
    learning_gamma=0.2,
    # "unit": global q-site log-precisions start at 0 (see the JAX package's
    # config.DEFAULT_PARAMS for the measurements behind this default)
    q_global_init="unit",
)


def apply_defaults_params(config):
    defaults = attrdictify(dict(DEFAULT_PARAMS))
    for k in config:
        defaults[k] = config[k]
    return defaults


def depth(group_values):
    return len(set(g for g in group_values if g is not None))


def proc_data(data_settings):
    """Device-group bookkeeping: component maps, multi-hot depth, relevance
    vectors and device index maps."""
    groups_list = [[k, v] for k, v in data_settings.groups.items()]
    data_settings.component_maps = OrderedDict()
    for k, group in groups_list:
        data_settings.component_maps[k] = OrderedDict(zip(data_settings.devices, group))
    # Total number of group-level parameters
    data_settings.device_depth = sum(
        depth(cm.values()) for cm in data_settings.component_maps.values()
    )
    # Relevance vectors decode the multi-hot cassette back into per-group one-hots
    data_settings.relevance_vectors = OrderedDict()
    k1 = 0
    for k, group in groups_list:
        k2 = depth(group) + k1
        rv = np.zeros(data_settings.device_depth)
        rv[k1:k2] = 1.0
        if k in data_settings.default_devices:
            rv[k1 + data_settings.default_devices[k]] = 0.0
        data_settings.relevance_vectors[k] = rv.astype(np.float32)
        k1 = k2
    data_settings.device_map = dict(
        zip(data_settings.devices, (float(v) for v in range(len(data_settings.devices))))
    )
    data_settings.device_idx_to_device_name = dict(enumerate(data_settings.devices))
    data_settings.device_lookup = {v: k for k, v in data_settings.device_map.items()}
    return data_settings


def apply_defaults_data(config):
    ndevices = len(config["devices"])
    defaults = attrdictify(
        dict(
            groups={"default": [0] * ndevices},
            default_devices=dict(),
            normalize=None,
            merge=True,
            subtract_background=True,
            separate_conditions=False,
            dtype="float32",
        )
    )
    for k in config:
        defaults[k] = config[k]
    defaults.data_dir = get_data_directory()
    return proc_data(defaults)


class Config:
    """Settings = YAML spec (+ defaults) + CLI args.

    ``args`` needs ``yaml`` and ``seed``; with ``yaml`` None no spec is read
    and the settings stay empty.  Training's flags, where ``args``
    has them, act as in the JAX package: ``test_epoch`` and ``plot_epoch``
    are clamped to ``epochs``, and ``--precision_hidden_layers``, ``--q_global_init`` and
    ``--grad_clip_norm`` override their ``params:`` entries."""

    def __init__(self, args):
        epochs = getattr(args, "epochs", None)
        if epochs is not None:
            for flag in ("test_epoch", "plot_epoch"):
                if getattr(args, flag, 0) > epochs:
                    setattr(args, flag, epochs)
        if args.seed is not None:
            np.random.seed(args.seed)
        if args.yaml is None:
            return
        if not os.path.exists(args.yaml):
            hint = ""
            candidate = os.path.join(_REPO, "specs", os.path.basename(args.yaml))
            if os.path.exists(candidate):
                hint = " (did you mean %s?)" % candidate
            raise SystemExit("Spec file not found: %s%s" % (args.yaml, hint))
        with open(args.yaml, "r") as stream:
            config = attrdictify(yaml.safe_load(stream))
        for section in ("data", "params"):
            if not isinstance(config.get(section), dict):
                raise SystemExit(
                    "Spec %s is missing its '%s:' section (or it is empty)" % (args.yaml, section)
                )
        if "model" not in config:
            nested = " (found one nested under params: — move it to the top level)"
            raise SystemExit("Spec %s has no top-level 'model:' key%s"
                             % (args.yaml, nested if "model" in config.params else ""))
        self.data = apply_defaults_data(config.data)
        self.params = apply_defaults_params(config.params)
        for flag, key in (
            ("precision_hidden_layers", "n_hidden_decoder_precisions"),
            ("q_global_init", "q_global_init"),
            ("grad_clip_norm", "grad_clip_norm"),
        ):
            if getattr(args, flag, None) is not None:
                self.params[key] = getattr(args, flag)
        self.model = config.model
        self.seed = args.seed if args.seed is not None else 0
        self.trainer = None


def get_data_directory():
    """Directory holding the plate-reader CSVs. ``INFERENCE_DATA_DIR`` wins;
    otherwise the repository's ``data/``."""
    data_dir = os.getenv("INFERENCE_DATA_DIR")
    if data_dir:
        return data_dir
    repo_data = os.path.join(_REPO, "data")
    if os.path.isdir(repo_data):
        return repo_data
    return "data"


def get_results_directory():
    """Where training writes its results.  ``INFERENCE_RESULTS_DIR`` wins;
    otherwise ``results`` under the working directory."""
    return os.getenv("INFERENCE_RESULTS_DIR") or "results"


class Trainer:
    """Results-directory bookkeeping: ``tb_log_dir`` is
    ``<results>/<experiment>[_<timestamp>]``, created with a copy of the spec
    in it (the JAX package's ``config.Trainer``)."""

    def __init__(self, args, log_dir=None, add_timestamp=False):
        self.results_dir = get_results_directory()
        self.experiment = args.experiment
        self.yaml_file_name = args.yaml
        if log_dir is None:
            self.create_logging_dirs(add_timestamp)
        else:
            self.tb_log_dir = log_dir

    def _unique_dir_name(self, experiment, add_timestamp):
        now = datetime.datetime.now().isoformat()
        time_code = re.sub("[^A-Za-z0-9]+", "", now)
        if add_timestamp is True:
            experiment += "_" + time_code
        return os.path.join(self.results_dir, experiment)

    def create_logging_dirs(self, add_timestamp=False):
        self.tb_log_dir = self._unique_dir_name(self.experiment, add_timestamp)
        os.makedirs(self.tb_log_dir, exist_ok=True)
        shutil.copyfile(
            self.yaml_file_name,
            os.path.join(self.tb_log_dir, os.path.basename(self.yaml_file_name)),
        )
