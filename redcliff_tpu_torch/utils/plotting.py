"""Matplotlib visualization helpers.

Copy of ``redcliff_tpu/utils/plotting.py`` for the PyTorch port (host
matplotlib with the Agg backend, imported when this module is). Where
matplotlib is absent, as on the card's machine, importing this module
raises ``ImportError``, and the port's evaluation hooks skip their figures,
as the JAX package's do there.

Rebuilds the plotting surface of the reference's general_utils/plotting.py
(~25 helpers called from every fit()/save_checkpoint() and the eval drivers):
GC est-vs-true heatmap comparisons (:291-398), scatter + standard-error
overlays (:128-258), metric-history curves, signal-channel and wavelet plots
(:399-580), state-score traces (:582-634), and cross-experiment summary grids
(:14-126).  All helpers write a PNG and close their figure (the reference's
fit loops emit dozens of figures per checkpoint; leaking them OOMs long runs).
"""
from __future__ import annotations

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

__all__ = [
    "plot_heatmap",
    "plot_gc_est_comparison",
    "plot_gc_est_comparisons_by_factor",
    "make_scatter_and_std_err_of_mean_plot_overlay",
    "make_bar_and_whisker_plot_overlay",
    "plot_metric_histories",
    "plot_all_signal_channels",
    "plot_x_wavelet_comparison",
    "plot_x_simulation_comparison",
    "plot_state_score_traces",
    "plot_reconstruction_comparison",
    "plot_cross_experiment_summary_grid",
    "plot_cross_experiment_summary",
    "plot_confidence_interval_summary",
    "plot_scattered_results",
    "plot_training_loss",
    "plot_scatter",
    "plot_curve",
    "plot_curve_comparison",
    "plot_curve_comparison_from_dict",
    "plot_system_state_score_comparison",
    "plot_avg_system_state_score_comparison",
    "plot_estimated_vs_true_curve",
]

# reference-name aliases (the reference spells it "comparisson")
def _save(fig, save_path):
    fig.tight_layout()
    fig.savefig(save_path)
    plt.close(fig)


def plot_heatmap(A, save_path, title="", xlabel="source", ylabel="target",
                 cmap="viridis"):
    """Single-matrix heatmap (ref plotting.py:259-289)."""
    A = np.asarray(A)
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(A, cmap=cmap, aspect="auto")
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.colorbar(im, ax=ax)
    _save(fig, save_path)


def plot_gc_est_comparison(true_gc, est_gc, save_path, include_lags=False):
    """Side-by-side true vs estimated GC heatmaps; with ``include_lags`` each
    lag slice gets its own column pair (ref plotting.py:291-381)."""
    est_gc = None if est_gc is None else np.asarray(est_gc)
    true_gc = None if true_gc is None else np.asarray(true_gc)
    mats = []
    if include_lags:
        for name, M in (("true", true_gc), ("est", est_gc)):
            if M is None:
                continue
            M = M[:, :, None] if M.ndim == 2 else M
            for l in range(M.shape[2]):
                mats.append((f"{name} lag {l + 1}", M[:, :, l]))
    else:
        for name, M in (("true", true_gc), ("est", est_gc)):
            if M is None:
                continue
            if M.ndim == 3:
                M = M.sum(axis=2)
            mats.append((name, M))
    if not mats:
        return
    fig, axes = plt.subplots(1, len(mats),
                             figsize=(3.2 * len(mats), 3), squeeze=False)
    for ax, (title, M) in zip(axes[0], mats):
        im = ax.imshow(M, cmap="viridis", aspect="auto")
        ax.set_title(title)
        fig.colorbar(im, ax=ax, fraction=0.046)
    _save(fig, save_path)


def plot_gc_est_comparisons_by_factor(true_gcs, est_gcs, save_path,
                                      include_lags=False):
    """One row per factor of true/est GC heatmaps (ref plotting.py:383-398;
    either list may be None, matching the curation-time usage that plots
    ground truth alone)."""
    n_true = 0 if true_gcs is None else len(true_gcs)
    n_est = 0 if est_gcs is None else len(est_gcs)
    K = max(n_true, n_est)
    if K == 0:
        return
    fig, axes = plt.subplots(K, 2, figsize=(7, 3 * K), squeeze=False)
    for k in range(K):
        for col, (name, src) in enumerate((("true", true_gcs),
                                           ("est", est_gcs))):
            ax = axes[k][col]
            if src is None or k >= len(src):
                ax.axis("off")
                continue
            M = np.asarray(src[k])
            if M.ndim == 3:
                M = M.sum(axis=2) if not include_lags else M[:, :, 0]
            im = ax.imshow(M, cmap="viridis", aspect="auto")
            ax.set_title(f"factor {k} {name}")
            fig.colorbar(im, ax=ax, fraction=0.046)
    _save(fig, save_path)


def make_scatter_and_std_err_of_mean_plot_overlay(results_by_group, save_path,
                                                  title, xlabel, ylabel,
                                                  alpha=0.5,
                                                  make_diff_plots=False):
    """Per-group value scatter with mean ± SEM overlay — the cross-algorithm
    comparison figure (ref plotting.py:128-258).  With ``make_diff_plots``,
    each group additionally gets a ``<group>_IMPROVEMENTS/`` subfolder holding
    the same figure over its pairwise per-sample differences vs every other
    group (the reference's improvement panels, ref :177-198)."""
    if make_diff_plots:
        import os

        folder, fname = os.path.split(save_path)
        for g1, v1 in results_by_group.items():
            diffs = {
                f"{g1} - {g2}": [a - b for a, b in zip(v1, v2)]
                for g2, v2 in results_by_group.items() if g2 != g1
            }
            diff_dir = os.path.join(folder, f"{g1}_IMPROVEMENTS")
            os.makedirs(diff_dir, exist_ok=True)
            make_scatter_and_std_err_of_mean_plot_overlay(
                diffs, os.path.join(diff_dir, fname),
                f"{title}\n vs {g1} performance", xlabel, ylabel, alpha=alpha,
                make_diff_plots=False)
    groups = list(results_by_group.keys())
    fig, ax = plt.subplots(figsize=(max(6, 1.2 * len(groups)), 4))
    rng = np.random.default_rng(0)
    for i, g in enumerate(groups):
        vals = np.asarray([v for v in results_by_group[g] if v is not None],
                          dtype=np.float64)
        if vals.size == 0:
            continue
        jitter = rng.uniform(-0.15, 0.15, size=vals.size)
        ax.scatter(np.full(vals.size, i) + jitter, vals, alpha=alpha, s=18)
        mean = vals.mean()
        sem = vals.std() / np.sqrt(vals.size)
        ax.errorbar([i], [mean], yerr=[sem], fmt="o", color="black",
                    capsize=4, markersize=6, zorder=3)
    ax.set_xticks(range(len(groups)))
    ax.set_xticklabels(groups, rotation=30, ha="right", fontsize=8)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    _save(fig, save_path)


def plot_metric_histories(histories, save_path, title="training histories",
                          ylog=False):
    """Overlayed per-epoch metric curves from a {name: [values]} dict — the
    loss-curve panels every checkpoint writes (ref save_checkpoint usage,
    redcliff_s_cmlp.py:942-1112)."""
    fig, ax = plt.subplots(figsize=(7, 4))
    for name, vals in histories.items():
        vals = [v for v in vals if v is not None and np.isscalar(v)
                or isinstance(v, (int, float, np.floating))]
        if not vals:
            continue
        ax.plot(range(len(vals)), vals, label=str(name), linewidth=1.2)
    if ylog:
        ax.set_yscale("log")
    ax.set_xlabel("epoch")
    ax.legend(fontsize=7)
    ax.set_title(title)
    _save(fig, save_path)


def plot_all_signal_channels(X, save_path, title="signal", fs=None, zoom=None):
    """Stacked per-channel traces of one (T, C) recording
    (ref plotting.py:399-460, 548-579).  ``zoom`` additionally writes
    ``*_ZOOMED`` / ``*_partiallyZOOMED`` companions restricted to the first
    ``zoom`` / ``2*zoom`` steps, like the reference's curation plots."""
    X = np.asarray(X)

    def _one(Xv, path):
        T, C = Xv.shape
        t = np.arange(T) / fs if fs else np.arange(T)
        fig, axes = plt.subplots(C, 1, figsize=(8, 1.2 * C), sharex=True,
                                 squeeze=False)
        for c in range(C):
            axes[c][0].plot(t, Xv[:, c], linewidth=0.7)
            axes[c][0].set_ylabel(f"ch{c}", fontsize=7)
        axes[-1][0].set_xlabel("time (s)" if fs else "step")
        axes[0][0].set_title(title)
        _save(fig, path)

    _one(X, save_path)
    if zoom is not None:
        import os

        root, ext = os.path.splitext(save_path)
        ext = ext or ".png"
        _one(X[:zoom], f"{root}_ZOOMED{ext}")
        _one(X[: 2 * zoom], f"{root}_partiallyZOOMED{ext}")


def plot_x_wavelet_comparison(X, X_wavelet, save_path):
    """Original signal vs its wavelet-band decomposition
    (ref plotting.py:462-520)."""
    X = np.asarray(X)
    X_wavelet = np.asarray(X_wavelet)
    fig, axes = plt.subplots(2, 1, figsize=(8, 5), sharex=True)
    axes[0].plot(X, linewidth=0.7)
    axes[0].set_title("original channels")
    axes[1].plot(X_wavelet.reshape(X_wavelet.shape[0], -1), linewidth=0.5)
    axes[1].set_title("wavelet bands")
    _save(fig, save_path)


def plot_state_score_traces(scores, save_path, labels=None,
                            title="state scores"):
    """Per-state factor-score traces over time (ref plotting.py:582-634)."""
    scores = np.asarray(scores)  # (num_states, T)
    fig, ax = plt.subplots(figsize=(8, 3.5))
    for s in range(scores.shape[0]):
        name = labels[s] if labels else f"state {s}"
        ax.plot(scores[s], label=name, linewidth=1.0)
    ax.set_xlabel("step")
    ax.set_ylabel("score")
    ax.set_title(title)
    ax.legend(fontsize=8)
    _save(fig, save_path)


def plot_reconstruction_comparison(x_orig, x_recon, save_path):
    """Flattened original vs reconstruction overlay (the DCSFA evaluate
    figure, ref models/dcsfa_nmf.py:1346)."""
    fig, ax = plt.subplots(figsize=(8, 3.5))
    ax.plot(np.asarray(x_orig).ravel(), label="original", linewidth=0.7)
    ax.plot(np.asarray(x_recon).ravel(), label="reconstruction",
            linewidth=0.7, alpha=0.8)
    ax.legend(fontsize=8)
    ax.set_title("reconstruction comparison")
    _save(fig, save_path)


def plot_cross_experiment_summary_grid(summary, save_path, metric_key,
                                       title=None):
    """Grid of per-(dataset, algorithm) metric means — the cross-experiment
    summary figure (ref plotting.py:14-126).  ``summary`` maps
    {dataset: {algorithm: value}}."""
    datasets = list(summary.keys())
    algs = sorted({a for d in summary.values() for a in d})
    M = np.full((len(datasets), len(algs)), np.nan)
    for i, d in enumerate(datasets):
        for j, a in enumerate(algs):
            v = summary[d].get(a)
            if v is not None:
                M[i, j] = v
    fig, ax = plt.subplots(figsize=(1.2 * len(algs) + 2,
                                    0.6 * len(datasets) + 2))
    im = ax.imshow(M, cmap="viridis", aspect="auto")
    ax.set_xticks(range(len(algs)))
    ax.set_xticklabels(algs, rotation=30, ha="right", fontsize=8)
    ax.set_yticks(range(len(datasets)))
    ax.set_yticklabels(datasets, fontsize=8)
    for i in range(len(datasets)):
        for j in range(len(algs)):
            if np.isfinite(M[i, j]):
                ax.text(j, i, f"{M[i, j]:.3f}", ha="center", va="center",
                        fontsize=7, color="white")
    fig.colorbar(im, ax=ax)
    ax.set_title(title or metric_key)
    _save(fig, save_path)


def plot_cross_experiment_summary(save_path, means, sems, alg_names,
                                  dataset_names, title="", xlabel="", ylabel="",
                                  x_domain_lim=None,
                                  abbreviate_dataset_names=True):
    """The paper's headline comparison figure (ref plotting.py:14-107):
    horizontal grouped bars — one group per dataset, one bar per algorithm —
    with SEM whiskers.  ``means``/``sems`` are flat lists ordered
    dataset-major (all algs for dataset 0, then dataset 1, ...), matching the
    layout the summary condensers emit."""
    A, D = len(alg_names), len(dataset_names)
    assert len(means) == A * D, (len(means), A, D)
    means = np.asarray(means, dtype=np.float64)
    sems = np.asarray(sems, dtype=np.float64)

    def _alias(name):
        # "numN10_numE20_numF5" -> "10-20-5" (the paper's axis shorthand)
        parts = str(name).split("_")
        nums = []
        for part in parts:
            digits = "".join(ch for ch in part if ch.isdigit())
            if not digits:
                return str(name)
            nums.append(digits)
        return "-".join(nums)

    fig, ax = plt.subplots(figsize=(9, max(4, 0.6 * A * D)))
    group_stride = A + 1  # one blank row between dataset groups
    cmap = plt.get_cmap("tab10")
    for a, alg in enumerate(alg_names):
        ys = [d * group_stride + a for d in range(D)]
        idx = [d * A + a for d in range(D)]
        ax.barh(ys, means[idx], xerr=sems[idx], height=0.9,
                color=cmap(a % 10), capsize=4, label=str(alg))
    ax.set_yticks([d * group_stride + (A - 1) / 2 for d in range(D)])
    labels = [_alias(n) if abbreviate_dataset_names else str(n)
              for n in dataset_names]
    ax.set_yticklabels(labels)
    ax.invert_yaxis()
    ax.grid(True, axis="x", linestyle=":", linewidth=0.6, color="grey")
    if x_domain_lim is not None:
        ax.set_xlim(*x_domain_lim)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend(fontsize=8)
    _save(fig, save_path)


def plot_confidence_interval_summary(save_path, center, lower_bnd, upper_bnd,
                                     center_label="center", title="",
                                     criteria_name="", domain_name=""):
    """Center curve with lower/upper bound curves (ref plotting.py:110-125)."""
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.plot(center, marker=".", label=center_label)
    ax.plot(lower_bnd, marker=".", label="lower-bound")
    ax.plot(upper_bnd, marker=".", label="upper-bound")
    ax.set_title(title)
    ax.set_ylabel(criteria_name)
    ax.set_xlabel(domain_name)
    ax.legend(fontsize=8)
    ax.grid(True, linestyle=":")
    _save(fig, save_path)


def make_bar_and_whisker_plot_overlay(vals_by_label, save_path, title="",
                                      xlabel="", ylabel="", alpha=0.5,
                                      color="darkred"):
    """Bars of per-group means with boxplot overlays
    (ref plotting.py:201-226)."""
    groups = list(vals_by_label.keys())
    data = [np.asarray(vals_by_label[g], dtype=np.float64) for g in groups]
    fig, ax = plt.subplots(figsize=(max(6, 1.2 * len(groups)), 4.5))
    ax.bar(range(1, len(groups) + 1), [d.mean() if d.size else np.nan
                                       for d in data],
           align="center", alpha=alpha, color=color)
    ax.boxplot(data, positions=range(1, len(groups) + 1))
    ax.set_xticks(range(1, len(groups) + 1))
    ax.set_xticklabels(groups, rotation=70, fontsize=8)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    _save(fig, save_path)


def plot_scattered_results(x_vals, y_vals, save_path, title="", xlabel="",
                           ylabel="", x_eps=0.0, y_eps=0.0, alpha=0.5,
                           rng=None):
    """Scatter with optional gaussian jitter to de-overlap discrete values
    (ref plotting.py:229-241)."""
    rng = rng or np.random.default_rng(0)
    x = np.asarray(x_vals, dtype=np.float64)
    y = np.asarray(y_vals, dtype=np.float64)
    if x_eps:
        x = x + rng.normal(0.0, x_eps, size=x.shape)
    if y_eps:
        y = y + rng.normal(0.0, y_eps, size=y.shape)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(x, y, alpha=alpha)
    ax.set_title(title)
    ax.set_xlabel(f"{xlabel} (eps={x_eps})" if x_eps else xlabel)
    ax.set_ylabel(f"{ylabel} (eps={y_eps})" if y_eps else ylabel)
    _save(fig, save_path)


def plot_training_loss(train_loss_list, save_path, steps_per_entry=50):
    """Loss-vs-training-step curve; entries are ``steps_per_entry`` apart
    (the reference hard-codes 50, ref plotting.py:244-256)."""
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(steps_per_entry * np.arange(len(train_loss_list)), train_loss_list)
    ax.set_title("Training Loss")
    ax.set_ylabel("Loss")
    ax.set_xlabel("Training steps")
    _save(fig, save_path)


def plot_x_simulation_comparison(x, x_sim, save_path):
    """Per-channel actual-vs-simulated column pair for the first batch sample
    (ref plotting.py:458-480); ``x``/``x_sim`` are (B, T, C)."""
    x_sim = np.asarray(x_sim)
    C = x_sim.shape[2]
    fig, axes = plt.subplots(C, 2, figsize=(8, 2 * C), squeeze=False)
    for c in range(C):
        if x is not None:
            axes[c][0].plot(np.asarray(x)[0, :, c], linewidth=0.8)
        axes[c][0].set_title(f"actual ch{c}", fontsize=8)
        axes[c][1].plot(x_sim[0, :, c], linewidth=0.8)
        axes[c][1].set_title(f"simulated ch{c}", fontsize=8)
    _save(fig, save_path)


def plot_scatter(x, y, title, xlabel, ylabel, save_path):
    """Bare scatter (ref plotting.py:483-493)."""
    fig, ax = plt.subplots()
    ax.scatter(x, y)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    _save(fig, save_path)


def plot_curve(values, title, xlabel, ylabel, save_path, domain_start=0):
    """Single curve over a shifted integer domain (ref plotting.py:495-505)."""
    fig, ax = plt.subplots()
    ax.plot(np.arange(domain_start, domain_start + len(values)), values)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    _save(fig, save_path)


def _plot_curves_with_mean(curves, labels, title, xlabel, ylabel, save_path,
                           domain_start):
    fig, ax = plt.subplots()
    stacked = []
    for label, curve in zip(labels, curves):
        curve = np.asarray(curve, dtype=np.float64)
        ax.plot(np.arange(domain_start, domain_start + len(curve)), curve,
                label=label, alpha=0.5)
        stacked.append(curve)
    if stacked:
        n = min(len(c) for c in stacked)
        mean = np.mean([c[:n] for c in stacked], axis=0)
        ax.plot(np.arange(domain_start, domain_start + n), mean, label="mean",
                alpha=0.8, linewidth=1.6, color="black")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend(fontsize=7)
    _save(fig, save_path)


def plot_curve_comparison(lists_of_curve_values, title, xlabel, ylabel,
                          save_path, domain_start=0, label_root=""):
    """Overlay of curves + their mean (ref plotting.py:507-525)."""
    labels = [f"{label_root}{i}" for i in range(len(lists_of_curve_values))]
    _plot_curves_with_mean(lists_of_curve_values, labels, title, xlabel,
                           ylabel, save_path, domain_start)


def plot_curve_comparison_from_dict(dict_of_curve_values, title, xlabel,
                                    ylabel, save_path, domain_start=0,
                                    label_root=""):
    """Dict-keyed overlay of curves + their mean (ref plotting.py:527-546)."""
    keys = list(dict_of_curve_values.keys())
    _plot_curves_with_mean([dict_of_curve_values[k] for k in keys],
                           [f"{label_root}{k}" for k in keys], title, xlabel,
                           ylabel, save_path, domain_start)


def plot_system_state_score_comparison(save_path, scores, title="",
                                       colors=None, markers=None, labels=None):
    """State-score traces with dashed boundaries between equal-length state
    segments (ref plotting.py:582-599); ``scores`` is (num_states, T)."""
    scores = np.asarray(scores)
    S, T = scores.shape
    seg = T // S
    fig, ax = plt.subplots(figsize=(9, 4))
    for s in range(S):
        ax.plot(scores[s], alpha=0.6,
                color=None if colors is None else colors[s],
                marker=None if markers is None else markers[s],
                label=f"state {s}" if labels is None else labels[s])
        if s > 0:
            ax.axvline(x=s * seg, color="k", linestyle="dashed", linewidth=0.8)
    ax.set_xlabel("Recording Time ID")
    ax.set_ylabel("Amplitude")
    ax.set_title(title)
    ax.legend(fontsize=8)
    _save(fig, save_path)


def plot_avg_system_state_score_comparison(save_path, scores,
                                           true_label_traces, title="",
                                           colors=None, markers=None,
                                           labels=None, ylim=(-1, 2.5)):
    """Sample score traces faint in the background; averaged predictions
    (solid) vs averaged true label traces (dotted) per state on top
    (ref plotting.py:602-632).  ``scores``/``true_label_traces`` are lists of
    (num_states, T) arrays."""
    scores = [np.asarray(s) for s in scores]
    truths = [np.asarray(t) for t in true_label_traces]
    avg_pred = np.mean(scores, axis=0)
    avg_true = np.mean(truths, axis=0)
    S = avg_pred.shape[0]
    cmap = plt.get_cmap("tab10")
    col = lambda s: cmap(s % 10) if colors is None else colors[s]
    fig, ax = plt.subplots(figsize=(10, 6))
    for rec in scores:
        for s in range(S):
            ax.plot(rec[s], color=col(s), alpha=0.025)
    for s in range(S):
        name = f"state {s}" if labels is None else labels[s]
        ax.plot(avg_pred[s], color=col(s), alpha=0.6,
                marker=None if markers is None else markers[s],
                label=f"avg_pred_{name}")
        ax.plot(avg_true[s], color=col(s), alpha=0.6, linestyle="dotted",
                marker=None if markers is None else markers[s],
                label=f"true_{name}")
    ax.set_xlabel("Time Step")
    ax.set_ylabel("Amplitude")
    ax.set_title(title)
    if ylim is not None:
        ax.set_ylim(*ylim)
    ax.legend(fontsize=7)
    _save(fig, save_path)


def plot_estimated_vs_true_curve(save_path, est_curve, true_curve, title="",
                                 xlabel="", ylabel=""):
    """Estimated vs true curve overlay (ref plotting.py:635-646)."""
    fig, ax = plt.subplots()
    ax.plot(true_curve, color="k", marker="+", label="true", alpha=0.5)
    ax.plot(est_curve, color="salmon", marker="x", label="estimated",
            alpha=0.5)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend(fontsize=8)
    _save(fig, save_path)


# aliases matching the reference's spelling for drop-in compatibility
plot_gc_est_comparisson = plot_gc_est_comparison
plot_gc_est_comparissons_by_factor = plot_gc_est_comparisons_by_factor
make_scatter_and_stdErrOfMean_plot_overlay_vis = \
    make_scatter_and_std_err_of_mean_plot_overlay
plot_reconstruction_comparisson = plot_reconstruction_comparison
plot_x_simulation_comparisson = plot_x_simulation_comparison
plot_curve_comparisson = plot_curve_comparison
plot_curve_comparisson_from_dict = plot_curve_comparison_from_dict
make_bar_and_whisker_plot_overlay_vis = make_bar_and_whisker_plot_overlay
plot_system_state_score_comparisson = plot_system_state_score_comparison
plot_avg_system_state_score_comparisson = \
    plot_avg_system_state_score_comparison
