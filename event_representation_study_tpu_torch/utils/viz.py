"""Visualization (the JAX package's ``utils/viz.py``): the equivalents of
ev-YOLOv6/yolov6/vis_utils.py (``make_binary_histo``, :30), box drawing,
the train-batch and validation-prediction mosaics of the Trainer and the
Evaler (engine.py:719-913), and the paper's figures (GWD against mAP, the
channel search's C_p, GWD curves, a 3D event cloud, representation
channels).

``make_binary_histo``, ``draw_boxes`` and ``_to_uint8`` are NumPy. Every
plot imports matplotlib when called, so a machine without it raises
``ImportError`` naming matplotlib at the first plot, and imports this
module without it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def make_binary_histo(events: np.ndarray, height: int, width: int) -> np.ndarray:
    """Gray background, white positive / black negative last polarity per
    pixel (vis_utils.py:30-60)."""
    img = np.full((height, width, 3), 127, np.uint8)
    if len(events):
        val = np.where(np.asarray(events["p"]) > 0, 255, 0).astype(np.uint8)
        img[events["y"], events["x"]] = val[:, None]
    return img


def draw_boxes(img: np.ndarray, boxes_xyxy: np.ndarray,
               labels: Optional[Sequence[str]] = None,
               color=(0, 255, 0)) -> np.ndarray:
    """Rectangle outlines on an HWC uint8 image (bbox_visualizer usage in
    engine.py:719-913)."""
    out = img.copy()
    h, w = img.shape[:2]
    for i, b in enumerate(np.asarray(boxes_xyxy).astype(int)):
        x1, y1, x2, y2 = np.clip(b[:4], 0, [w - 1, h - 1, w - 1, h - 1])
        out[y1, x1:x2] = color
        out[min(y2, h - 1), x1:x2] = color
        out[y1:y2, x1] = color
        out[y1:y2, min(x2, w - 1)] = color
    return out


def gwd_map_correlation_figure(gwd: Dict[str, float], mAP: Dict[str, float],
                               path: Optional[str] = None):
    """Scatter C_p vs mAP per representation (the paper's headline figure,
    viz/2_map_gwd_correlation.py). Returns (fig, pearson_r)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = sorted(set(gwd) & set(mAP))
    x = np.array([gwd[n] for n in names])
    y = np.array([mAP[n] for n in names])
    r = float(np.corrcoef(x, y)[0, 1]) if len(names) > 1 else float("nan")
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.scatter(x, y)
    for n, xi, yi in zip(names, x, y):
        ax.annotate(n, (xi, yi), fontsize=8)
    ax.set_xlabel("GWD (C_p, lower is better)")
    ax.set_ylabel("mAP")
    ax.set_title(f"GWD vs mAP (pearson r = {r:.3f})")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig, r


def plot_cp_over_time(optimization_results: Sequence[Dict],
                      baseline_cps: Optional[Dict[str, float]] = None,
                      path: Optional[str] = None):
    """ERGO-12 search progress: per-channel best C_p with the fixed
    representations' levels as dashed baselines
    (viz/1_optimization_details.py plot_cp_overtime)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cps = [o["C_p"] if "C_p" in o else o["obj"] for o in optimization_results]
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.plot(cps, color="b", marker="*")
    ax.scatter([len(cps) - 1], [cps[-1]], marker="*", s=200, color="b")
    if baseline_cps:
        for name, cp in baseline_cps.items():
            ax.hlines(cp, xmin=0, xmax=len(cps) - 1, linestyles="dashed",
                      color="gray")
            ax.annotate(name, xy=(len(cps) - 0.7, cp), fontsize=10)
    for c, o in enumerate(optimization_results):
        if all(k in o for k in ("window", "function", "aggregation")):
            ax.annotate(
                f"p{c + 1}=({o['window']}, {o['function']}, {o['aggregation']})",
                xy=(0.5, max(cps) - 0.03 * (max(cps) - min(cps)) * c),
                fontsize=8,
            )
    ax.set_xlabel("channel")
    ax.set_ylabel("C_p")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_gwd_curves(xs: Sequence, series: Dict[str, Sequence[float]],
                    xlabel: str, path: Optional[str] = None):
    """GWD ablation curves — channels / blur sweeps
    (viz/4_toy_examples.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    for name, ys in series.items():
        ax.plot(xs, ys, marker="o", label=name)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("GWD (C_p)")
    ax.legend()
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_events_3d(events: np.ndarray, path: Optional[str] = None,
                   max_points: int = 20000):
    """3D (x, y, t) event cloud colored by polarity — the matplotlib stand-in
    for ev-licious's open3d art module (evlicious/art/; open3d is not in
    this image)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(events)
    sel = np.linspace(0, n - 1, min(n, max_points)).astype(int) if n else []
    fig = plt.figure(figsize=(7, 5))
    ax = fig.add_subplot(projection="3d")
    if n:
        x = np.asarray(events["x"])[sel]
        y = np.asarray(events["y"])[sel]
        t = np.asarray(events["t"])[sel]
        p = np.asarray(events["p"])[sel]
        ax.scatter(t, x, y, s=0.5, c=np.where(p > 0, "r", "b"))
    ax.set_xlabel("t [us]")
    ax.set_ylabel("x")
    ax.set_zlabel("y")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_rep_channels(rep: np.ndarray, path: Optional[str] = None,
                      cols: int = 4):
    """Channel mosaic of one representation (viz/3_samples_view.py sample
    grids)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    C = rep.shape[-1]
    rows = (C + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 2.4 * rows))
    axes = np.atleast_2d(axes)
    for c in range(rows * cols):
        ax = axes[c // cols, c % cols]
        ax.axis("off")
        if c < C:
            ax.imshow(rep[..., c], cmap="viridis")
            ax.set_title(f"ch {c}", fontsize=8)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
    return fig


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """(H, W, C>=1) float -> displayable uint8 RGB (first 3 channels or
    channel-mean)."""
    x = np.asarray(img, np.float64)
    if x.ndim == 3 and x.shape[-1] >= 3:
        x = x[..., :3]
    elif x.ndim == 3:
        x = x.mean(-1, keepdims=True).repeat(3, -1)
    lo, hi = x.min(), x.max()
    x = (x - lo) / max(hi - lo, 1e-9)
    return (x * 255).astype(np.uint8)


def plot_train_batch(images: np.ndarray, gt_bboxes: np.ndarray,
                     gt_mask: np.ndarray, path: Optional[str] = None,
                     max_images: int = 8):
    """Train-batch mosaic with ground-truth boxes (the reference's
    plot_train_batch, engine.py:719-780)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    B = min(len(images), max_images)
    cols = min(B, 4)
    rows = (B + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3.2 * cols, 3.2 * rows))
    axes = np.atleast_1d(axes).reshape(-1)
    for i in range(rows * cols):
        axes[i].axis("off")
        if i >= B:
            continue
        img = _to_uint8(images[i])
        m = np.asarray(gt_mask[i]) > 0
        img = draw_boxes(img, np.asarray(gt_bboxes[i])[m])
        axes[i].imshow(img)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
    return fig


def plot_val_predictions(images: np.ndarray, dets: np.ndarray,
                         counts: np.ndarray, gt_bboxes: np.ndarray,
                         gt_mask: np.ndarray, path: Optional[str] = None,
                         max_images: int = 8, conf: float = 0.3):
    """Val prediction vs label mosaic (engine.py:782-913 plot_val_pred):
    green = ground truth, red = predictions above ``conf``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    B = min(len(images), max_images)
    cols = min(B, 4)
    rows = (B + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3.2 * cols, 3.2 * rows))
    axes = np.atleast_1d(axes).reshape(-1)
    for i in range(rows * cols):
        axes[i].axis("off")
        if i >= B:
            continue
        img = _to_uint8(images[i])
        m = np.asarray(gt_mask[i]) > 0
        img = draw_boxes(img, np.asarray(gt_bboxes[i])[m], color=(0, 255, 0))
        d = np.asarray(dets[i][: int(counts[i])])
        if len(d):
            d = d[d[:, 4] >= conf]
            img = draw_boxes(img, d[:, :4], color=(255, 0, 0))
        axes[i].imshow(img)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
    return fig
