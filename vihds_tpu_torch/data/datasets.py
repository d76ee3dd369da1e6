"""Array dataset pipeline: preprocessing, multi-file merge, k-fold splits.

Host-side numpy, as in ``vihds_tpu.data.datasets``; batches become torch
tensors on the chosen device only where the evaluation consumes them.
"""

import numpy as np

from vihds_tpu_torch.data import procdata
from vihds_tpu_torch.utils.attrdict import AttrDict


def onehot(i, n):
    v = np.zeros((n,))
    if i is not None:
        v[i] = 1
    return v


def depth(group_values):
    return len(set(g for g in group_values if g is not None))


def get_cassettes(devices, settings):
    """Multi-hot cassette encoding: one one-hot block per grouped parameter,
    concatenated."""
    rows = []
    for d in devices:
        device_name = settings.device_idx_to_device_name[d]
        vs = [
            onehot(cm[device_name], depth(cm.values()))
            for cm in settings.component_maps.values()
        ]
        rows.append(np.hstack(vs))
    dtype = {"float32": np.float32, "float64": np.float64}.get(settings.dtype)
    if dtype is None:
        raise ValueError("Unknown dtype %s" % settings.dtype)
    return np.array(rows).astype(dtype)


def scale_data(X, settings):
    """Per-signal max scaling (or the given ``normalize`` scales), then
    per-series background subtraction."""
    n_outputs = np.shape(X)[1]
    if settings.normalize is None:
        scales = [np.max(X[:, i, :]).astype(np.float32) for i in range(n_outputs)]
    else:
        scales = settings.normalize
    for i, scale in enumerate(scales):
        X[:, i, :] /= scale
        if settings.subtract_background:
            mins = np.min(X[:, i, :], axis=1)[:, np.newaxis]
            X[:, i, :] -= mins
    return X, scales


def find_nearest(array, value):
    array = np.asarray(array)
    return (np.abs(array - value)).argmin()


def merge_observations(times_list, observations_list):
    """Snap every file onto the coarsest common time grid."""
    times_arr = list(times_list)
    obs_arr = list(observations_list)
    n_list = np.array([len(t) for t in times_arr])
    loc = int(np.argmin(n_list))
    chosen_times = times_arr[loc]
    for i, (t, obs) in enumerate(zip(times_arr, obs_arr)):
        locs = [find_nearest(t, ti) for ti in chosen_times]
        obs_arr[i] = obs[:, :, locs]
    return chosen_times, np.concatenate(obs_arr)


class TimeSeriesDataset:
    """All observations of one experiment, as host numpy arrays.

    Attributes after init: ``devices[L]``, ``dev_1hot[L,D]``, ``inputs[L,C]``
    (log1p-transformed), ``times[T]``, ``observations[L,S,T]`` (scaled),
    ``n_times``, ``n_species``, ``scales``.
    """

    def __init__(self, data_settings, params):
        self.parser = procdata.load
        self.data_settings = data_settings
        self.params = params
        self.n_times = None
        self.n_species = None

    def _preprocess(self, devices, inputs, times, observations):
        self.devices = devices
        self.dev_1hot = get_cassettes(devices, self.data_settings)
        self.inputs = np.log(1.0 + inputs)
        self.times = times
        self.n_times = len(times)
        obs, self.scales = scale_data(observations, self.data_settings)
        self.observations = obs
        self.n_species = np.shape(observations)[1]

    def init_multiple_merge(self):
        # files with no rows for the requested devices parse to None: skip them
        parsed = [self.parser(f, self.data_settings) for f in self.data_settings.files]
        parsed = [p for p in parsed if p is not None]
        if not parsed:
            raise ValueError("No data found for devices %s" % list(self.data_settings.devices))
        devices, inputs, times_list, observations_list = zip(*parsed)
        times, observations = merge_observations(times_list, observations_list)
        self._preprocess(np.concatenate(devices), np.concatenate(inputs), times, observations)

    def __len__(self):
        return len(self.devices)

    def select(self, idx):
        """Gather a host batch for integer indices ``idx`` (numpy array)."""
        return AttrDict(
            devices=self.devices[idx],
            dev_1hot=self.dev_1hot[idx],
            inputs=self.inputs[idx],
            observations=self.observations[idx],
            times=self.times,
        )


class Subset:
    """A view of a dataset restricted to ``indices``."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def batch(self):
        return self.dataset.select(self.indices)


class TimeSeriesDatasetPair:
    """Train/validation subsets plus shared shape info."""

    def __init__(self, train_subset, test_subset, data_settings):
        self.train = train_subset
        self.test = test_subset
        self.n_train = len(train_subset)
        self.n_test = len(test_subset)
        self.depth = data_settings.device_depth
        self.n_conditions = len(data_settings.conditions)


def build_datasets(args, config):
    """Load + merge CSVs, then make the k-fold train/val split for
    ``args.split`` of ``args.folds`` (or hold out ``args.heldout``).

    Uses the numpy global RNG seeded from ``args.seed`` exactly as the JAX
    package does, so both packages make the same folds."""
    data_settings = config.data
    if not data_settings.merge:
        raise NotImplementedError(
            "merge: false datasets are not ported yet (ROADMAP queue 1, \"Host layer: merge: false\")"
        )
    dataset = TimeSeriesDataset(data_settings, config.params)
    dataset.init_multiple_merge()

    np.random.seed(args.seed if args.seed is not None else 0)
    heldout = getattr(args, "heldout", None)
    if heldout:
        all_ids = np.arange(len(dataset), dtype=int)
        held_idx = data_settings.device_map.get(heldout)
        if held_idx is None:
            raise ValueError("Unknown heldout device %s" % heldout)
        val_ids = all_ids[dataset.devices == int(held_idx)]
        train_ids = np.setdiff1d(all_ids, val_ids)
        if len(val_ids) == 0:
            raise ValueError("Heldout device %s has no data" % heldout)
    else:
        indices = np.random.permutation(len(dataset))
        val_chunks = np.array_split(indices, args.folds)
        all_ids = np.arange(len(dataset), dtype=int)
        val_ids = np.sort(val_chunks[args.split - 1])
        train_ids = np.setdiff1d(all_ids, val_ids)

    train = Subset(dataset, train_ids)
    val = Subset(dataset, val_ids)
    return TimeSeriesDatasetPair(train, val, data_settings)
