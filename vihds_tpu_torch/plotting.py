"""Reporting figures for training and cross-validation results.

The port's own copy of ``vihds_tpu.plotting``, figure for figure: the
prediction-vs-data summary, weighted-theta pairplots, species trajectories,
treatment dose-response, per-device fit summaries, per-device individual
fits, and the global / variable posterior-parameter plots.  Every grid figure
is built on the ``PanelGrid`` helper below, and the per-series "individual"
figures use a ``GridSpec`` with a spacer column.

All inputs are host numpy arrays.  This module imports matplotlib and
seaborn when it is imported, so the port imports it only inside the
functions that draw (``plotting_hooks``, ``xval.XvalMerge.make_images``,
``predict.make_figure``), never when a module loads.
"""

import matplotlib

matplotlib.use("agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import seaborn as sns  # noqa: E402
from matplotlib import cm  # noqa: E402

FS = 14  # base font size for labels/titles


# --------------------------------------------------------------------------- #
# Layout helpers
# --------------------------------------------------------------------------- #
class PanelGrid:
    """A rows x cols grid of panels with row labels, column titles, and one
    shared outer x/y label — the layout idiom every grid figure here shares.

    Wraps ``plt.subplots`` so callers never special-case the 1-row shape, and
    owns the frameless overlay axis used for the shared outer labels.
    """

    def __init__(self, n_rows, n_cols, figsize, share_x=True, share_y=False):
        self.fig, axes = plt.subplots(
            n_rows, n_cols, sharex=share_x, sharey=share_y, figsize=figsize
        )
        self.axes = np.asarray(axes).reshape(n_rows, n_cols)
        self.n_rows, self.n_cols = n_rows, n_cols

    def panel(self, row, col):
        return self.axes[row, col]

    def row_label(self, row, text, **kw):
        kw.setdefault("fontsize", FS)
        self.axes[row, 0].set_ylabel(text, **kw)

    def col_title(self, col, text, **kw):
        kw.setdefault("fontsize", FS)
        self.axes[0, col].set_title(text, **kw)

    def hide_panel(self, row, col):
        self.axes[row, col].set_visible(False)

    def outer_labels(self, xlabel=None, ylabel=None, x_pad=7, y_pad=0):
        """One shared axis label for the whole grid, via a frameless overlay."""
        overlay = self.fig.add_subplot(111, frameon=False)
        overlay.tick_params(labelcolor="none", top=False, bottom=False, left=False, right=False)
        if xlabel:
            overlay.set_xlabel(xlabel, fontsize=FS, labelpad=x_pad)
        if ylabel:
            overlay.set_ylabel(ylabel, fontsize=FS, labelpad=y_pad)
        return overlay

    def done(self, tight=True):
        if tight:
            self.fig.tight_layout()
        sns.despine(fig=self.fig)
        return self.fig


def credible_band(ax, t, mid, half_width, **style):
    """Shaded mid +- half_width band (the posterior-predictive 2-sigma band)."""
    style.setdefault("alpha", 0.1)
    ax.fill_between(t, mid - half_width, mid + half_width, **style)


def rows_of(device_ids, device):
    """Row indices of one device's time series."""
    return np.flatnonzero(np.asarray(device_ids) == device)


def from_log1p(x):
    """Invert the dataset's log(1+x) treatment transform."""
    return np.exp(x) - 1.0


# --------------------------------------------------------------------------- #
# Training-time / xval summary figures
# --------------------------------------------------------------------------- #
def plot_prediction_summary(
    device_names, signal_names, times, observed, pred_mu, pred_std, device_ids, style, clamp_y=False
):
    """Observed data (red) vs posterior-predictive mean +- 2 std, one panel
    per device x signal (capability: reference prediction summary)."""
    from matplotlib.collections import LineCollection, PolyCollection

    present = np.unique(device_ids)
    grid = PanelGrid(len(present), pred_mu.shape[1], figsize=(10, 2 * len(present)))
    times = np.asarray(times)
    t_band = np.concatenate([times, times[::-1]])
    linestyle = "--" if "--" in style else "-"
    for r, device in enumerate(present):
        rows = rows_of(device_ids, device)
        for c in range(pred_mu.shape[1]):
            ax = grid.panel(r, c)
            # one collection per artist family instead of one artist per
            # series: at icml-split scale (234 series) per-series
            # fill_between/plot cost ~7.6 s per figure; collections render
            # the identical picture in ~0.5 s (round-5 figure pipeline)
            mu_rc, sd_rc = pred_mu[rows, c], 2 * pred_std[rows, c]
            bands = np.stack(
                [
                    np.column_stack(
                        [t_band, np.concatenate([m - s, (m + s)[::-1]])]
                    )
                    for m, s in zip(mu_rc, sd_rc)
                ]
            )
            ax.add_collection(
                PolyCollection(bands, facecolor="grey", alpha=0.1, edgecolor="none")
            )
            obs_segs = [np.column_stack([times, o]) for o in observed[rows, c]]
            ax.add_collection(LineCollection(obs_segs, colors="r", lw=1))
            ax.add_collection(
                LineCollection(
                    [np.column_stack([times, m]) for m in mu_rc],
                    colors="k", lw=1, alpha=0.75, linestyle=linestyle,
                )
            )
            ax.autoscale_view()
            if clamp_y:
                ax.set_ylim(-0.2, 1.2)
            if r == grid.n_rows - 1:
                ax.set_xlabel("Time (h)")
        grid.row_label(r, device_names[device], fontsize=None)
    # Title only the panel columns: callers may pass the full species-name
    # list (the observed channels are its first entries — same indexing
    # contract as the reference, vihds/plotting.py:46-47).
    for c in range(grid.n_cols):
        grid.col_title(c, signal_names[c], fontsize=None)
    return grid.done()


def plot_weighted_theta(
    theta_names,
    train_weights,
    train_theta,
    train_device_ids,
    columns,
    sample=True,
    nsamples=100,
):
    """Pairplot of importance-(re)weighted theta samples coloured by device.

    ``train_theta``: [n_theta, L, K]; ``train_weights``: [L, K] normalised
    importance weights.  ``sample=True`` resamples each series' K draws by
    its weights; otherwise uniformly.
    """
    import pandas as pd

    L, K = train_weights.shape
    picks = np.stack(
        [
            np.random.choice(K, nsamples, p=w if sample else None)
            for w in train_weights
        ]
    )  # [L, nsamples]
    take = np.arange(L)[:, None], picks

    frame = {}
    for i in np.argsort(theta_names):
        frame[theta_names[i]] = train_theta[i][take].ravel()
    frame["device"] = np.broadcast_to(
        np.asarray(train_device_ids)[:, None], (L, nsamples)
    ).ravel()

    sns.set(style="ticks")
    pair = sns.PairGrid(pd.DataFrame(frame, dtype=float), hue="device", vars=columns)
    pair.map_diag(sns.kdeplot, fill=True, alpha=0.5)
    pair.map_offdiag(sns.scatterplot, s=20, alpha=0.25, edgecolor="k", linewidth=0.5)
    pair.add_legend()
    return pair.fig


def species_summary(
    species_names, treatments, device_ids, times, iw_states, devices, settings, normalise=True
):
    """Inferred (latent) species trajectories, one panel per device x state."""
    n_states = iw_states.shape[1]
    condition_palette = "grbcmyk"
    scale = np.array(
        [iw_states[:, s, :].max() if normalise else 1.0 for s in range(n_states)]
    )

    grid = PanelGrid(
        len(devices), n_states, figsize=(14, 2 * len(devices)), share_y=normalise
    )
    for r, device in enumerate(devices):
        device_rows = rows_of(device_ids, device)
        if settings.separate_conditions:
            groups = [
                (condition_palette[ci], device_rows[treatments[device_rows, ci] > 0.0])
                for ci in range(len(settings.conditions))
            ]
        else:
            groups = [("k", device_rows)]
        for s in range(n_states):
            ax = grid.panel(r, s)
            for color, rows in groups:
                ax.plot(
                    np.broadcast_to(times, (len(rows),) + times.shape).T,
                    (iw_states[rows, s, :] / scale[s]).T,
                    "-",
                    lw=1,
                    alpha=0.5 if settings.separate_conditions else 1.0,
                    color=color,
                )
            if normalise:
                ax.set_ylim(-0.1, 1.1)
            ax.set_xticks([0, 4, 8, 12, 16])
        grid.row_label(r, settings.pretty_devices[device], labelpad=20, fontweight="bold")
    for s in range(n_states):
        title = species_names[s] if s < len(species_names) else "Latent %d" % (s - len(species_names))
        grid.col_title(s, title, fontsize=None)
    grid.done()
    grid.outer_labels(
        "Time (h)", "Normalized output" if len(devices) > 1 else "Norm. output"
    )
    return grid.fig


def xval_treatments(res, devices):
    """Dose-response: final-timepoint predictions (dots +- std) and data (x)
    against each input concentration, per device x signal."""
    signals = res.settings.signals
    fills = ["g", "r", "b"]
    lines = ["darkgreen", "darkred", "darkblue"]

    grid = PanelGrid(len(devices), len(signals), figsize=(9, 2.2 * len(devices)), share_y=True)
    for r, device in enumerate(devices):
        rows = rows_of(res.devices, device)
        doses = from_log1p(res.treatments[rows, :])  # [n_rows, n_conditions]
        for c, signal in enumerate(signals):
            ax = grid.panel(r, c)
            final_mu = res.iw_predict_mu[rows, c, -1]
            final_std = res.iw_predict_std[rows, c, -1]
            for ci in range(doses.shape[1]):
                ax.errorbar(
                    doses[:, ci], final_mu, yerr=final_std, fmt="o", ms=5, lw=1,
                    mec=lines[ci % 3], color=fills[ci % 3], zorder=ci,
                )
                ax.semilogx(
                    doses[:, ci], res.X_obs[rows, c, -1], "x", ms=5, lw=1,
                    color=lines[ci % 3], zorder=ci + 20,
                )
            ax.set_ylim(-0.1, 1.1)
            ax.set_xticks(np.logspace(0, 4, 3))
            ax.tick_params(axis="both", which="major", labelsize=FS)
        # index by the device id being plotted, not the row counter — callers
        # may pass a subset or reordering of the device ids
        grid.row_label(r, res.settings.devices[device], labelpad=25, fontweight="bold")
    for c, signal in enumerate(signals):
        grid.col_title(c, signal)
    grid.panel(0, len(signals) - 1).legend(
        labels=[c + " (data)" for c in res.settings.conditions]
        + [c + " (model)" for c in res.settings.conditions]
    )
    grid.outer_labels(
        " / ".join(res.settings.conditions),
        "Normalized fluorescence" if len(devices) > 1 else "Norm. fluorescence",
        y_pad=7,
    )
    sns.despine(fig=grid.fig)
    return grid.fig


def _unique_treatment_rows(res, device, condition=None):
    """One representative series per distinct treatment of ``device`` —
    restricted to series where ``condition`` is active, if given."""
    rows = rows_of(res.devices, device)
    if condition is None:
        _, first = np.unique(res.treatments[rows, :], axis=0, return_index=True)
    else:
        rows = rows[res.treatments[rows, condition] > 0.0]
        _, first = np.unique(res.treatments[rows, condition], return_index=True)
    return rows[first]


def xval_fit_summary(res, device_id, separatedInputs=False):
    """Per-device fit over its distinct treatments (rainbow = dose order)."""
    signals = res.settings.signals
    if separatedInputs:
        row_sets = [
            _unique_treatment_rows(res, device_id, condition=ci)
            for ci in range(len(res.settings.conditions))
        ]
        figsize = (2.2 * len(signals), 1.6 * len(row_sets) + 1.2)
    else:
        row_sets = [_unique_treatment_rows(res, device_id)]
        figsize = (2.2 * len(signals), 2.8)

    grid = PanelGrid(len(row_sets), len(signals), figsize=figsize, share_y=True)
    for r, rows in enumerate(row_sets):
        dose_colors = cm.rainbow(np.linspace(0, 1, len(rows)))
        for c in range(len(signals)):
            ax = grid.panel(r, c)
            ax.set_prop_cycle("color", list(dose_colors))
            for mu, sd in zip(res.iw_predict_mu[rows, c], res.iw_predict_std[rows, c]):
                credible_band(ax, res.times, mu, 2 * sd)
            ax.plot(res.times, res.X_obs[rows, c].T, ".", markersize=2)
            ax.plot(res.times, res.iw_predict_mu[rows, c].T, "-", lw=2, alpha=0.75)
            ax.set_xlim(0.0, 17)
            ax.set_xticks([0, 5, 10, 15])
            ax.set_ylim(-0.2, 1.2)
        if len(row_sets) > 1:
            grid.row_label(
                r, res.settings.conditions[r] + " dilution", labelpad=25, fontweight="bold"
            )
    for c, signal in enumerate(signals):
        grid.col_title(c, signal)
    grid.outer_labels("Time (h)", "Normalized output", y_pad=7)
    return grid.done()


def gen_treatment_str(conditions, treatments, unit=None):
    """Human-readable 'C6 = 25  C12 = 0' label for one series' treatments."""
    parts = []
    for name, logged in zip(conditions, treatments):
        value = from_log1p(logged)
        fmt = "%1.1f" if 0.0 < value < 1.0 else "%1.0f"
        parts.append(("%s = " + fmt + ("" if unit is None else " " + unit)) % (name, value))
    return "\n".join(parts)


# --------------------------------------------------------------------------- #
# Per-series ("individual") figures: two blocks of signal columns side by
# side, one series per row, built on a GridSpec with a spacer column.
# --------------------------------------------------------------------------- #
_SIGNAL_COLORS = ["tab:gray", "r", "y", "c"]


def _individual_fig(res, block_rows, row_labels_unit=None):
    """Render per-series fits.  ``block_rows``: [rows-for-left-block,
    rows-for-right-block]; each row of a block is one series, each column one
    signal, normalised by the per-signal data max."""
    n_signals = res.X_obs.shape[1]
    signal_max = res.X_obs.max(axis=(0, 2))
    n_rows = max(max(map(len, block_rows)), 1)

    fig = plt.figure(figsize=(12, 1.35 * n_rows))
    # columns: [block0 signals] [spacer] [block1 signals]
    widths = [1.0] * n_signals + [0.6] + [1.0] * n_signals
    gs = fig.add_gridspec(n_rows, 2 * n_signals + 1, width_ratios=widths, hspace=0.35, wspace=0.25)

    for b, rows in enumerate(block_rows):
        col0 = b * (n_signals + 1)
        for i, series in enumerate(rows):
            label = gen_treatment_str(
                res.settings.conditions, res.treatments[series], unit=row_labels_unit
            )
            for s in range(n_signals):
                ax = fig.add_subplot(gs[i, col0 + s])
                mu = res.iw_predict_mu[series, s, :] / signal_max[s]
                sd = res.iw_predict_std[series, s, :] / signal_max[s]
                credible_band(ax, res.times, mu, 2 * sd, alpha=0.25, color=_SIGNAL_COLORS[s % 4])
                ax.plot(res.times, res.X_obs[series, s, :] / signal_max[s], "k.", markersize=2)
                ax.plot(res.times, mu, "-", lw=2, alpha=0.75, color=_SIGNAL_COLORS[s % 4])
                ax.set_xlim(0.0, 17)
                ax.set_xticks([0, 5, 10, 15])
                ax.set_xticklabels([])
                ax.set_ylim(-0.2, 1.2)
                ax.tick_params(axis="both", which="major", labelsize=FS)
                if i == 0:
                    ax.set_title(res.settings.signals[s], fontsize=FS)
                if s == 0:
                    ax.set_ylabel(label, labelpad=25, fontsize=FS - 2)
                else:
                    ax.set_yticklabels([])
        # shared block labels, placed relative to the block's grid cells
        x_left = b * 0.52 + 0.06
        fig.text(x_left, 0.5, "Normalized output", ha="center", va="center", rotation=90, fontsize=FS)
        fig.text(x_left + 0.2, 0.0, "Time (h)", ha="center", va="bottom", fontsize=FS)
    sns.despine(fig=fig)
    return fig


def xval_individual(res, device_id):
    """Every series of one device, split into two side-by-side blocks."""
    rows = rows_of(res.devices, device_id)
    rows = rows[np.argsort(res.ids[rows])]
    half = int(np.ceil(len(rows) / 2.0))
    return _individual_fig(res, [rows[:half], rows[half:]])


def xval_individual_2treatments(res, device_id):
    """Per-series fits with one block per input condition, dose-ordered."""
    blocks = []
    for ci in range(2):
        rows = rows_of(res.devices, device_id)
        rows = rows[res.treatments[rows, ci] > 0.0]
        blocks.append(rows[np.argsort(res.treatments[rows, ci])])
    return _individual_fig(res, blocks, row_labels_unit="nM")


def combined_treatments(results, devices):
    """Model-data dose responses of the two reporter signals to each input,
    for MULTIPLE result sets side by side (offline analysis figure).

    Each entry of ``results`` carries: devices, treatments, X_obs [L,T,S],
    importance_weights [L,K], PREDICT [L,K,S], STD [L,K,S], pretty_devices,
    label.
    """
    n_dev, n_res = len(devices), len(results)
    reporter_signals = [2, 3]  # YFP, CFP channels
    reporter_colors = ["y", "c"]
    c6_col, c12_col = 1, 0

    grid = PanelGrid(n_dev, 2 * n_res, figsize=(9, 2.2 * n_dev + 0.5), share_x=True, share_y=True)
    for r, device in enumerate(devices):
        grid.row_label(r, results[0].pretty_devices[r], labelpad=25, fontweight="bold")
        for ir, res in enumerate(results):
            rows = rows_of(res.devices, device)
            final_obs = res.X_obs[rows, -1, :]  # [n_rows, S]
            weights = res.importance_weights[rows]  # [n_rows, K]
            doses = {
                0: from_log1p(res.treatments[rows, c6_col]),
                1: from_log1p(res.treatments[rows, c12_col]),
            }
            for sig, color in zip(reporter_signals, reporter_colors):
                mu = (weights * res.PREDICT[rows, :, sig]).sum(1)
                second = (weights * (res.PREDICT[rows, :, sig] ** 2 + res.STD[rows, :, sig] ** 2)).sum(1)
                sd = np.sqrt(np.maximum(second - mu ** 2, 0))
                for half, sig_obs in enumerate(reporter_signals):
                    ax = grid.panel(r, ir + half * n_res)
                    ax.errorbar(doses[half], mu, yerr=sd, fmt="o", mec="k", ms=5, lw=1, color=color)
                    ax.semilogx(doses[half], final_obs[:, sig_obs], "x", ms=5, lw=1, color=color)
            for half in range(2):
                ax = grid.panel(r, ir + half * n_res)
                ax.set_xticks(np.logspace(0, 4, 3))
                ax.set_ylim(-0.1, 1.1)
                ax.set_yticks([0.0, 0.5, 1.0])
                ax.tick_params(axis="both", which="major", labelsize=FS)
                if r == 0:
                    ax.set_title(res.label, fontsize=FS)
    grid.outer_labels(
        "C$_6$ (nM)  /  C$_{12}$ (nM)",
        "Normalized fluorescence" if n_dev > 1 else "Norm. fluorescence",
        x_pad=10,
        y_pad=8,
    )
    return grid.done()


# --------------------------------------------------------------------------- #
# Posterior-parameter figures
# --------------------------------------------------------------------------- #
def _posterior_sites(res, per_datapoint):
    """(ordered base names, {name: values}) for q sites whose mu arrays are
    per-datapoint (local) or not (global), preserving spec order."""
    n_data = len(res.ids)
    values = dict(zip(list(res.q_names), list(res.q_values)))
    bases = list(dict.fromkeys(name.split(".")[0] for name in res.q_names))
    picked = [
        b
        for b in bases
        if b + ".mu" in values
        and (np.shape(values[b + ".mu"])[0] == n_data) == per_datapoint
    ]
    return picked, values


def _site_grid(names, ncols, panel_w, title):
    nrows = int(np.ceil(len(names) / ncols))
    grid = PanelGrid(nrows, ncols, figsize=(panel_w * ncols, 2 * nrows), share_x=(title == "Local parameters"))
    grid.fig.suptitle(title, fontsize=14)
    return grid


def xval_variable_parameters(res, ncols=2):
    """Per-datapoint posterior mu +- 1/prec error bars, coloured by device."""
    sites, values = _posterior_sites(res, per_datapoint=True)
    if not sites:
        print("- No variable parameters: not producing plot")
        return None
    palette = dict(zip(np.unique(res.devices), sns.color_palette()))
    grid = _site_grid(sites, ncols, panel_w=6, title="Local parameters")
    for k in range(grid.n_rows * grid.n_cols):
        r, c = divmod(k, ncols)
        if k >= len(sites):
            grid.hide_panel(r, c)
            continue
        ax = grid.panel(r, c)
        name = sites[k]
        for device, color in palette.items():
            rows = rows_of(res.devices, device)
            ax.errorbar(
                res.ids[rows],
                np.squeeze(values[name + ".mu"][rows]),
                np.squeeze(1 / values[name + ".prec"][rows]),
                fmt=".",
                color=color,
            )
        ax.set_title(name)
        if r == grid.n_rows - 1:
            ax.set_xlabel("Data instance")
    for r in range(grid.n_rows):
        grid.row_label(r, "Parameter value", fontsize=None)
    grid.fig.tight_layout(rect=(0, 0, 1, 0.97))
    sns.despine(fig=grid.fig)
    return grid.fig


def xval_global_parameters(res, ncols=6):
    """Per-fold global posterior mu +- 1/prec error bars."""
    n_folds = len(res.chunk_sizes)
    sites, values = _posterior_sites(res, per_datapoint=False)
    if not sites:
        print("- No global parameters: not producing plot")
        return None
    ncols = min(ncols, len(sites))
    grid = _site_grid(sites, ncols, panel_w=2, title="Global parameters")
    for k in range(grid.n_rows * grid.n_cols):
        r, c = divmod(k, ncols)
        if k >= len(sites):
            grid.hide_panel(r, c)
            continue
        ax = grid.panel(r, c)
        name = sites[k]
        ax.errorbar(
            np.arange(1, n_folds + 1), values[name + ".mu"], 1 / values[name + ".prec"], fmt="."
        )
        ax.set_title(name)
        ax.set_xlim(0.5, n_folds + 0.5)
        ax.set_xticks(range(1, n_folds + 1))
        if r == grid.n_rows - 1:
            ax.set_xlabel("Fold")
    for r in range(grid.n_rows):
        grid.row_label(r, "Parameter value", fontsize=None)
    grid.fig.tight_layout(rect=(0, 0, 1, 0.96))
    sns.despine(fig=grid.fig)
    return grid.fig
