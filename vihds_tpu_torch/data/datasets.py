"""Array dataset pipeline: preprocessing, multi-file merge or per-file
native grids (``merge: false``), k-fold splits.

Host-side numpy, as in ``vihds_tpu.data.datasets``; batches become torch
tensors on the chosen device only where the evaluation consumes them.
"""

import copy

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


class MultiTimeSeriesDataset:
    """Non-merged multi-file dataset (``data: merge: false``): every CSV keeps
    its native time grid.

    * each signal is scaled by its maximum over all files, the scale a
      merged load would compute;
    * the encoder reads every series snapped onto the shortest grid by
      nearest time (``enc_idx``), so it sees one input shape;
    * the ODE and the likelihood run on each file's native grid;
    * training and evaluation group the rows by file (``group_by_file``,
      ``file_batch``), and the report view (``select``, the xval arrays) is
      snapped onto the shortest grid, so it stays rectangular.
    """

    def __init__(self, data_settings, params):
        self.data_settings = data_settings
        self.params = params

    def init_multiple(self):
        parsed = [procdata.load(f, self.data_settings) for f in self.data_settings.files]
        parsed = [p for p in parsed if p is not None]
        if not parsed:
            raise ValueError("No data found for devices %s" % list(self.data_settings.devices))
        n_signals = parsed[0][3].shape[1]
        if self.data_settings.normalize is None:
            scales = [
                float(max(np.max(obs[:, i, :]) for _, _, _, obs in parsed))
                for i in range(n_signals)
            ]
        else:
            scales = self.data_settings.normalize
        shared = copy.copy(self.data_settings)
        shared.normalize = scales

        self.files = []
        for devices, inputs, times, observations in parsed:
            ds = TimeSeriesDataset(shared, self.params)
            ds._preprocess(devices, inputs, times, observations)
            self.files.append(ds)
        self.scales = scales
        self.n_species = self.files[0].n_species

        # the encoder's and the report's grid: the shortest native grid
        enc_file = int(np.argmin([f.n_times for f in self.files]))
        self.times = self.files[enc_file].times
        self.n_times = len(self.times)
        self.enc_idx = [
            np.array([find_nearest(f.times, t) for t in self.times]) for f in self.files
        ]

        counts = [len(f) for f in self.files]
        self.file_of = np.concatenate([np.full(c, i, int) for i, c in enumerate(counts)])
        self.local_of = np.concatenate([np.arange(c) for c in counts])
        self.devices = np.concatenate([f.devices for f in self.files])

    def __len__(self):
        return len(self.file_of)

    def group_by_file(self, global_ids):
        """[(file index, local row ids, positions within ``global_ids``)] for
        the files that ``global_ids`` touches, in file order."""
        global_ids = np.asarray(global_ids)
        groups = []
        for i in range(len(self.files)):
            positions = np.flatnonzero(self.file_of[global_ids] == i)
            if len(positions):
                groups.append((i, self.local_of[global_ids[positions]], positions))
        return groups

    def file_batch(self, file_idx, local_ids):
        """Native-grid host batch of one file, plus the encoder's snapped
        view ``enc_observations``."""
        batch = self.files[file_idx].select(np.asarray(local_ids))
        batch["enc_observations"] = batch.observations[:, :, self.enc_idx[file_idx]]
        return batch

    def select(self, idx):
        """Report view: the rows ``idx`` on the shortest grid."""
        idx = np.asarray(idx)
        obs = np.empty((len(idx), self.n_species, self.n_times), np.float32)
        for i, local_ids, positions in self.group_by_file(idx):
            obs[positions] = self.files[i].observations[local_ids][:, :, self.enc_idx[i]]
        return AttrDict(
            devices=self.devices[idx],
            dev_1hot=np.concatenate([f.dev_1hot for f in self.files])[idx],
            inputs=np.concatenate([f.inputs for f in self.files])[idx],
            observations=obs,
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
    """Load the CSVs (merged onto one grid, or per file on its own under
    ``merge: false``), then make the k-fold train/val split for
    ``args.split`` of ``args.folds`` (or hold out ``args.heldout``).

    Uses the numpy global RNG seeded from ``args.seed`` exactly as the JAX
    package does, so both packages make the same folds."""
    data_settings = config.data
    if data_settings.merge:
        dataset = TimeSeriesDataset(data_settings, config.params)
        dataset.init_multiple_merge()
    else:
        dataset = MultiTimeSeriesDataset(data_settings, config.params)
        dataset.init_multiple()

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
