"""Cross-validation merge: accumulate per-fold results, save the xval
artifact set and render its figures.

The same ``xval_*.npy`` / ``.txt`` names and contents as ``vihds_tpu.xval``
(they are the data contract between folds, the figures and the inference
graph), and the same figures: ``make_images`` writes the six families as
png and pdf beside the artifacts and into the ``xval`` TensorBoard writer
(``make_writer``).  The figures need matplotlib, seaborn and tensorboard
(``utils.FIGURE_PACKAGES``), imported only when they are drawn.
"""

import os

import numpy as np

from vihds_tpu_torch.utils import summary_writer


def fold_object_array(items):
    """A (n_folds,)-shaped object array with one fold payload per element
    (``np.asarray(list, dtype=object)`` would box every float when the folds
    share a shape)."""
    arr = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        arr[i] = x
    return arr


class XvalMerge:
    def __init__(self, args, settings):
        self.epoch = args.epochs
        self.elbo = []
        self.elbo_list = []
        self.q_names = []
        self.q_values = []
        self.splits = []
        self.theta = []
        self.iw_predict_mu = []
        self.iw_predict_std = []
        self.iw_states = []
        self.data_ids = []
        self.devices = []
        self.treatments = []
        self.X_obs = []
        self.chunk_sizes = None
        self.ids = None
        self.species_names = None
        self.times = None
        self.xval_writer = None
        self.settings = settings.data
        self.trainer = settings.trainer

    def add(self, split_idx, data_pair, val_results):
        """Append one fold's best-validation ``Results`` and its held-out data."""
        if self.species_names is None:
            # from the first fold that finished: a fold that hit the NaN
            # abort is never added
            self.q_names = val_results.q_names
            self.species_names = val_results.species_names
            self.times = data_pair.train.dataset.times
        n_times = len(data_pair.train.dataset.times)
        got = np.shape(val_results.iw_predict_mu)
        if got[-1] != n_times or got[0] != data_pair.n_test:
            raise ValueError(
                "fold %d results have shape %s but the dataset is [%d test x T=%d] — "
                "stale best-val cache?" % (split_idx, got, data_pair.n_test, n_times)
            )
        self.elbo.append(val_results.elbo)
        self.elbo_list.append(val_results.elbo_list)
        self.q_values.append(val_results.q_values)
        self.splits.append(split_idx)
        self.theta.append(val_results.theta)
        self.iw_predict_mu.append(val_results.iw_predict_mu)
        self.iw_predict_std.append(val_results.iw_predict_std)
        self.iw_states.append(val_results.iw_states)

        self.data_ids.append(data_pair.test.indices)
        dataset = data_pair.test.batch()
        self.devices.append(dataset["devices"])
        self.treatments.append(np.asarray(dataset["inputs"]))
        self.X_obs.append(np.asarray(dataset["observations"]))

    def finalize(self):
        """Concatenate the folds (ELBO trajectories stay ragged-safe)."""
        print("Preparing cross-validation results")
        self.elbo = np.array(self.elbo)
        self.elbo_list = fold_object_array(self.elbo_list)
        self.q_values = [
            np.concatenate([np.array(q[i], ndmin=1) for q in self.q_values])
            for i, _ in enumerate(self.q_names)
        ]
        self.iw_predict_mu = np.concatenate(self.iw_predict_mu, 0)
        self.iw_predict_std = np.concatenate(self.iw_predict_std, 0)
        self.iw_states = np.concatenate(self.iw_states, 0)
        self.devices = np.concatenate(self.devices, 0)
        self.treatments = np.concatenate(self.treatments, 0)
        self.X_obs = np.concatenate(self.X_obs, 0)
        self.chunk_sizes = np.array([len(ids) for ids in self.data_ids], dtype=object)
        self.ids = np.hstack(self.data_ids)

    def save(self):
        location = self.trainer.tb_log_dir
        print("Saving results to %s" % location)

        def save(base, data):
            np.save(os.path.join(location, base + ".npy"), fold_object_array(data)
                    if isinstance(data, list) else data)

        def savetxt(base, data):
            np.savetxt(
                os.path.join(location, base + ".txt"),
                np.array(data, dtype=str),
                delimiter=" ",
                fmt="%s",
            )

        save("xval_elbo", self.elbo)
        save("xval_elbo_list", self.elbo_list)
        savetxt("xval_q_names", self.q_names)
        save("xval_q_values", self.q_values)
        save("xval_theta", fold_object_array(self.theta))
        save("xval_iw_predict_mu", self.iw_predict_mu)
        save("xval_iw_predict_std", self.iw_predict_std)
        save("xval_iw_states", self.iw_states)
        savetxt("xval_device_names", self.settings.devices)
        save("xval_devices", self.devices)
        save("xval_treatments", self.treatments)
        save("xval_X_obs", self.X_obs)
        save("xval_chunk_sizes", self.chunk_sizes)
        save("xval_ids", self.ids)
        savetxt("xval_names", self.species_names)
        save("xval_times", self.times)

    def load(self, location=None):
        if location is None:
            location = self.trainer.tb_log_dir
        print("Loading results from %s" % location)

        def load(base):
            return np.load(os.path.join(location, base + ".npy"), allow_pickle=True)

        def loadtxt(base):
            return np.loadtxt(os.path.join(location, base + ".txt"), dtype=str, delimiter=" ")

        self.elbo = load("xval_elbo")
        self.elbo_list = load("xval_elbo_list")
        self.q_names = loadtxt("xval_q_names")
        self.q_values = load("xval_q_values")
        self.theta = load("xval_theta")
        self.iw_predict_mu = load("xval_iw_predict_mu")
        self.iw_predict_std = load("xval_iw_predict_std")
        self.iw_states = load("xval_iw_states")
        self.devices = load("xval_devices")
        self.treatments = load("xval_treatments")
        self.X_obs = load("xval_X_obs")
        self.chunk_sizes = load("xval_chunk_sizes")
        self.ids = load("xval_ids")
        self.species_names = loadtxt("xval_names")
        self.times = load("xval_times")

    def mark_completed(self, node_name):
        """Write the resume marker ``completed.txt``."""
        with open(os.path.join(self.trainer.tb_log_dir, "completed.txt"), "w") as f:
            f.write(node_name)

    def make_writer(self, location=None):
        """Open the ``xval`` TensorBoard writer under ``location`` (the
        results directory unless given); None where tensorboard is not
        installed."""
        if location is None:
            location = self.trainer.tb_log_dir
        self.xval_writer = summary_writer(os.path.join(location, "xval"))

    def close_writer(self):
        if self.xval_writer is not None:
            self.xval_writer.close()

    def save_figs(self, f, tag):
        """Write figure ``f`` as ``<tag>.png`` and ``<tag>.pdf`` in the
        results directory."""
        f.savefig(os.path.join(self.trainer.tb_log_dir, "%s.png" % tag), bbox_inches="tight")
        f.savefig(os.path.join(self.trainer.tb_log_dir, "%s.pdf" % tag), bbox_inches="tight")

    def make_images(self):
        """Render the six xval figure families (the prediction summary, the
        treatments where conditions are separate, the species, the global
        and variable parameters, and per device its summary and its
        individual fits): each as png and pdf, and into the ``xval``
        writer."""
        import matplotlib.pyplot as plt

        from vihds_tpu_torch import plotting

        device_ids = list(range(len(self.settings.devices)))

        def emit(f, name, tag):
            self.save_figs(f, name)
            if self.xval_writer is not None:
                self.xval_writer.add_figure(tag, f, self.epoch)
            plt.close(f)

        print("Making summary figure")
        f_summary = plotting.plot_prediction_summary(
            self.settings.devices,
            self.species_names,
            self.times,
            self.X_obs,
            self.iw_predict_mu,
            self.iw_predict_std,
            self.devices,
            "-",
        )
        emit(f_summary, "xval_fit", "Summary")

        if self.settings.separate_conditions is True:
            print("Making treatment figure")
            emit(plotting.xval_treatments(self, device_ids), "xval_treatments", "Treatment")

        print("Making species figure")
        f_species = plotting.species_summary(
            self.species_names,
            self.treatments,
            self.devices,
            self.times,
            self.iw_states,
            device_ids,
            self.settings,
        )
        emit(f_species, "xval_species", "Species")

        print("Making global parameters figure")
        f_gparas = plotting.xval_global_parameters(self)
        if f_gparas is not None:
            emit(f_gparas, "xval_global_parameters", "Parameters/Globals")

        print("Making variable parameters figure")
        f_vparas = plotting.xval_variable_parameters(self)
        if f_vparas is not None:
            emit(f_vparas, "xval_variable_parameters", "Parameters/Variable")

        print("Making summary device figures")
        for u in device_ids:
            device = self.settings.devices[u]
            f_summary_i = plotting.xval_fit_summary(
                self, u, separatedInputs=self.settings.separate_conditions
            )
            emit(f_summary_i, "xval_summary_%s" % device, "Device_Summary/" + device)

        print("Making individual device figures")
        for u in device_ids:
            device = self.settings.devices[u]
            if self.settings.separate_conditions is True:
                f_indiv_i = plotting.xval_individual_2treatments(self, u)
            else:
                f_indiv_i = plotting.xval_individual(self, u)
            emit(f_indiv_i, "xval_individual_%s" % device, "Device_Individual/" + device)
        if self.xval_writer is not None:
            self.xval_writer.flush()
