"""Hooks from the training loop into the plotting suite.

Kept apart so that training imports matplotlib only when it renders a
figure.  A figure needs matplotlib and seaborn to draw it and a TensorBoard
writer to carry it: where either is missing, the hooks draw nothing (said
once per process), and the run goes on.
"""

from vihds_tpu_torch.utils import missing_packages, note_once


def can_draw():
    """True when matplotlib and seaborn import; otherwise says once which
    is missing and returns False."""
    missing = missing_packages(("matplotlib", "seaborn"))
    if missing:
        note_once("Figures off: the %s package is not installed" % missing[0])
    return not missing


def weighted_theta_plot(training, valid_writer, epoch, train_merged, sample=True):
    """Importance-weighted theta pairplot of the train split, written to the
    validation writer; drawn when the spec sets ``params.theta_columns``."""
    import math

    import numpy as np

    columns = getattr(training.settings.params, "theta_columns", None)
    if not columns or valid_writer is None or not can_draw():
        return
    from vihds_tpu_torch import plotting

    def normed(merged):
        lse = merged.per_item_elbo + math.log(merged.log_w.shape[1])
        w = np.exp(merged.log_w - lse[:, None])
        return w / w.sum(axis=1, keepdims=True)

    fig = plotting.plot_weighted_theta(
        training.program.names,
        normed(train_merged),
        train_merged.theta,
        training.train_data.devices,
        columns=columns,
        sample=sample,
    )
    name = "Theta/Theta-Resample" if sample else "Theta/Theta-Uniform"
    valid_writer.add_figure(name, fig, global_step=epoch)
    valid_writer.flush()


def eval_plots(training, writer, epoch, dataset, output, dynamic=False):
    """The prediction-summary figure (and, for dynamic precisions, the
    variance figure) of one split, written to ``writer``."""
    if writer is None or not can_draw():
        return
    from vihds_tpu_torch import plotting

    fig = plotting.plot_prediction_summary(
        training.settings.data.devices,
        output.species_names,
        dataset.times,
        dataset.observations,
        output.iw_predict_mu,
        output.iw_predict_std,
        dataset.devices,
        "-",
    )
    writer.add_figure("Summary", fig, global_step=epoch)
    if dynamic:
        devices = list(range(len(training.settings.data.devices)))
        fig = plotting.species_summary(
            training.settings.data.signals,
            dataset.inputs,
            dataset.devices,
            dataset.times,
            output.iw_variance,
            devices,
            training.settings.data,
            normalise=False,
        )
        writer.add_figure("Precisions", fig, global_step=epoch)
    writer.flush()
