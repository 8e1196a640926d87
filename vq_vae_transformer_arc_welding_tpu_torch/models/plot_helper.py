"""Reconstruction plot helpers (parity: reference model/plot_helper.py).

Target-vs-prediction plots of welding cycles: a matplotlib figure
writer (reference :57-89), an optional plotly/wandb.Html table variant
(:11-54, requires wandb+plotly), and a fire-and-forget threaded wrapper
(:91-94). Arrays in, files/objects out: numpy, with matplotlib (and
plotly / wandb for the table) imported inside the functions, so that
importing this module needs neither.

Own copy of vq_vae_transformer_arc_welding_tpu/models/plot_helper.py:
the same figures from the same arrays."""
from __future__ import annotations

import os
import threading

import numpy as np


def plot_recon_matplotlib(target, prediction, out_path: str | None = None,
                          channel_names=("V", "I"), title: str = ""):
    """target/prediction: (T, C) or (B, T, C) (first sample used).
    Returns the matplotlib figure; saves to out_path if given."""
    import matplotlib
    matplotlib.use("agg")
    from matplotlib import pyplot as plt

    t = np.asarray(target)
    p = np.asarray(prediction)
    if t.ndim == 3:
        t, p = t[0], p[0]
    c = t.shape[-1]
    fig, axes = plt.subplots(c, 1, figsize=(10, 3 * c), squeeze=False)
    for ch in range(c):
        ax = axes[ch][0]
        ax.plot(t[:, ch], label=f"target {channel_names[ch % len(channel_names)]}")
        ax.plot(p[:, ch], label="prediction", alpha=0.8)
        ax.legend(loc="upper right")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path)
        plt.close(fig)
    return fig


def plot_recon_wandb_table(targets, predictions, run, key: str = "reconstructions",
                           max_rows: int = 8):
    """plotly->wandb.Html table of reconstruction pairs (reference :11-54).
    No-op with a warning when wandb/plotly aren't installed."""
    try:
        import wandb
        import plotly.graph_objects as go
    except ImportError:
        import logging
        logging.getLogger(__name__).warning(
            "wandb/plotly not installed; skipping reconstruction table")
        return None
    t = np.asarray(targets)
    p = np.asarray(predictions)
    rows = []
    for i in range(min(max_rows, len(t))):
        fig = go.Figure()
        for ch in range(t.shape[-1]):
            fig.add_trace(go.Scatter(y=t[i, :, ch], name=f"target ch{ch}"))
            fig.add_trace(go.Scatter(y=p[i, :, ch], name=f"pred ch{ch}"))
        rows.append([i, wandb.Html(fig.to_html(auto_play=False))])
    table = wandb.Table(columns=["idx", "plot"], data=rows)
    run.log({key: table})
    return table


def plot_single_cv(x, y, out_path: str | None = None):
    """Twin-axis voltage/current plot of one cycle, titled by quality
    (parity: dataloader/utils.py:71-79). x: (T, 2); y: 1=good, 0=bad."""
    import matplotlib
    matplotlib.use("agg")
    from matplotlib import pyplot as plt

    x = np.asarray(x)
    fig, ax1 = plt.subplots()
    ax1.plot(x[:, 0])
    ax2 = ax1.twinx()
    ax2.plot(x[:, 1], color="red")
    plt.title("good" if y == 1 else "bad")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path)
        plt.close(fig)
    return fig


def plot_recon_threaded(target, prediction, out_path: str):
    """Threaded matplotlib plot (reference :91-94)."""
    th = threading.Thread(target=plot_recon_matplotlib,
                          args=(target, prediction, out_path), daemon=True)
    th.start()
    return th
