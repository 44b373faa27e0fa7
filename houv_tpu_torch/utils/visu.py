"""Visualisation and analysis (counterpart of ``houv_tpu/utils/visu.py``):
cloud grids, a cloud beside its aligned copy and the target, mixture
plots, error histograms and the dumps of failed pairs (rotation error above
70°), written as PNG files.

Needs matplotlib, which it imports (on the Agg backend) inside each
function that draws: nothing on a training or sweep path imports this
module, and a machine without matplotlib runs everything else. Clouds may
be numpy arrays or tensors on any device.
"""

from __future__ import annotations

import os

import numpy as np


def _np(x) -> np.ndarray:
    """A numpy copy of an array or of a tensor on any device."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, save_path):
    """Write ``fig`` to ``save_path`` and close it (returning the path), or
    return the figure."""
    if not save_path:
        return fig
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=120)
    _pyplot().close(fig)
    return save_path


def plot_pcd(ax, pcd, color=None, size: float = 0.5, azim: float = -60,
             elev: float = 30):
    """One cloud scattered on a 3D axis, coloured by x unless ``color``."""
    pcd = _np(pcd)
    ax.view_init(elev=elev, azim=azim)
    if color is None:
        color = pcd[:, 0]
    ax.scatter(pcd[:, 0], pcd[:, 1], pcd[:, 2], c=color, s=size,
               cmap="viridis")
    lims = np.array([pcd.min(), pcd.max()])
    for setter in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
        setter(lims)
    ax.set_axis_off()


def plot_grid_pcd(clouds, shape=None, save_path: str | None = None,
                  title: str = "", size: float = 0.5):
    """The clouds in a (rows, cols) grid of one figure (one row by
    default)."""
    plt = _pyplot()
    rows, cols = shape or (1, len(clouds))
    fig = plt.figure(figsize=(3 * cols, 3 * rows))
    if title:
        fig.suptitle(title)
    for i, pcd in enumerate(clouds):
        plot_pcd(fig.add_subplot(rows, cols, i + 1, projection="3d"), pcd,
                 size=size)
    fig.tight_layout()
    return _finish(fig, save_path)


def aligned_plot_grid_pcd(src, tgt, transform, save_path=None, title=""):
    """src, src moved by the (4, 4) transform and tgt side by side."""
    src, t = _np(src), _np(transform)
    moved = src @ t[:3, :3].T + t[:3, 3]
    return plot_grid_pcd([src, moved, _np(tgt)], shape=(1, 3),
                         save_path=save_path, title=title)


def plot_gmm(ax, pi, mu, sigma, cmap="tab20"):
    """A mixture's means sized by weight, with their isotropic std as
    bars: pi (J,), mu (J, 3), sigma (J, 3, 3)."""
    pi, mu = _np(pi), _np(mu)
    std = np.sqrt(_np(sigma)[:, 0, 0])
    ax.scatter(mu[:, 0], mu[:, 1], mu[:, 2], s=2000 * pi,
               c=np.arange(len(pi)), cmap=cmap, alpha=0.6)
    for m, s in zip(mu, std):
        ax.plot([m[0] - s, m[0] + s], [m[1], m[1]], [m[2], m[2]], "k-",
                lw=0.3)


def analyse_distances(err_dict: dict, save_path: str | None = None,
                      bins: int = 50, log: bool = True,
                      xlabel: str = "rotation error (deg)"):
    """Step histograms of error distributions, one per entry (solver
    variants side by side)."""
    fig, ax = _pyplot().subplots(figsize=(7, 4))
    for name, errs in err_dict.items():
        ax.hist(_np(errs), bins=bins, histtype="step", label=name, log=log)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("count")
    ax.legend()
    fig.tight_layout()
    return _finish(fig, save_path)


def dump_failure_cases(src, tgt, transforms, r_err, out_dir: str,
                       threshold: float = 70.0, max_dumps: int = 16):
    """``aligned_plot_grid_pcd`` of each pair whose rotation error passes
    ``threshold``, at most ``max_dumps``; returns the written paths."""
    r_err = _np(r_err)
    src, tgt, transforms = _np(src), _np(tgt), _np(transforms)
    paths = []
    for j in np.nonzero(r_err > threshold)[0][:max_dumps]:
        path = os.path.join(out_dir, f"bad_{int(j)}_{r_err[j]:.0f}deg.png")
        aligned_plot_grid_pcd(src[j], tgt[j], transforms[j], save_path=path,
                              title=f"pair {int(j)}: {r_err[j]:.1f} deg")
        paths.append(path)
    return paths
