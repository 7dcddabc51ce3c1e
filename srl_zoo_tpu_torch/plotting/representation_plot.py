"""Representation scatter plots and the correlation heatmap (port of
``srl_zoo_tpu/plotting/representation_plot.py``).

The learned states as a 1-D, 2-D or 3-D scatter coloured by reward (a PCA
projection to 3 dims when the state has more), written per epoch by the
train CLI's ``--plot-every`` and after the export as ``states.png``; the
|Pearson r| heatmap of learned against ground-truth dims as
``correlation.png``; and ``LiveView``, the interactive window of
``--plot-every`` where matplotlib and a window server exist. The figures
are drawn by ``plotting/raster.py`` (numpy and OpenCV).

    python -m srl_zoo_tpu_torch.plotting.representation_plot \\
        --log-folder logs/<run> [--correlation] [--data-folder data/<ds>]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np

from srl_zoo_tpu_torch.plotting import raster

# the 3-D view: matplotlib's default azimuth -60 and elevation 30 degrees
_AZIM, _ELEV = np.deg2rad(-60.0), np.deg2rad(30.0)


def _project(states: np.ndarray, max_dim: int = 3) -> np.ndarray:
    """The states projected on their first ``max_dim`` principal axes
    when they have more dims than that, else as they are."""
    if states.shape[1] <= max_dim:
        return states
    centered = states - states.mean(axis=0)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    return centered @ vt[:max_dim].T


def _view_3d(p: np.ndarray) -> np.ndarray:
    """(N, 3) points, each axis scaled to [-1, 1], seen from the default
    3-D view: (N, 2) screen coordinates."""
    lo, hi = p.min(0), p.max(0)
    q = 2 * (p - lo) / np.where(hi > lo, hi - lo, 1.0) - 1
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    u = x * np.cos(_AZIM) + y * np.sin(_AZIM)
    depth = -x * np.sin(_AZIM) + y * np.cos(_AZIM)
    v = z * np.cos(_ELEV) - depth * np.sin(_ELEV)
    return np.stack([u, v], 1)


def render_states(states: np.ndarray, rewards: np.ndarray,
                  title: str) -> np.ndarray:
    """The reward-coloured scatter as an RGB uint8 image (shared by the
    file plots and the live window)."""
    proj = np.asarray(_project(np.asarray(states, np.float64)))
    rewards = np.asarray(rewards, np.float64).reshape(-1)
    img = raster.canvas(500, 600)
    raster.put_text(img, title, (300, 22), 0.55, centre=True)
    if proj.shape[1] >= 3:
        xy, labels = _view_3d(proj[:, :3]), ("", "")
        raster.put_text(img, "3-D: PCA 1-3 (azim -60, elev 30)", (60, 470),
                        0.4)
    elif proj.shape[1] == 2:
        xy, labels = proj, ("state 0", "state 1")
    else:
        xy = np.stack([np.arange(len(proj)), proj[:, 0]], 1)
        labels = ("row", "state 0")
    ax = raster.Axes(img, (60, 40, 480, 440),
                     (xy[:, 0].min(initial=0.0), xy[:, 0].max(initial=1.0)),
                     (xy[:, 1].min(initial=0.0), xy[:, 1].max(initial=1.0)))
    ax.frame(*labels)
    ax.scatter(xy[:, 0], xy[:, 1], raster.coolwarm(rewards))
    lo = float(rewards.min(initial=0.0))
    hi = float(rewards.max(initial=0.0))
    raster.colorbar(img, (520, 40, 540, 440), lo, hi, raster.coolwarm,
                    "reward")
    return img


def plot_representation(states: np.ndarray, rewards: np.ndarray,
                        save_path: Optional[str] = None,
                        title: str = "Learned state representation"
                        ) -> np.ndarray:
    """Scatter of the learned states coloured by reward; returns the RGB
    image and writes it to ``save_path`` as a PNG."""
    img = render_states(states, rewards, title)
    raster.save_png(img, save_path)
    return img


def plot_correlation(corr: np.ndarray, save_path: Optional[str] = None,
                     title: str = "Learned vs ground-truth correlation"
                     ) -> np.ndarray:
    """Heatmap of the (D_learned, D_gt) correlation matrix's magnitudes
    (nearest: the ground truth has 2-3 dims, which interpolation smears);
    returns the RGB image and writes it to ``save_path`` as a PNG."""
    import cv2
    corr = np.abs(np.asarray(corr, np.float64))
    n_learned, n_gt = corr.shape
    img = raster.canvas(500, 600)
    raster.put_text(img, title, (300, 22), 0.55, centre=True)
    x0, y0, x1, y1 = 90, 40, 480, 440
    cells = raster.viridis(corr)
    img[y0:y1, x0:x1] = cv2.resize(cells, (x1 - x0, y1 - y0),
                                   interpolation=cv2.INTER_NEAREST)
    cv2.rectangle(img, (x0, y0), (x1, y1), raster.BLACK, 1)
    for j in range(n_gt):
        raster.put_text(img, str(j), (x0 + (j + 0.5) * (x1 - x0) / n_gt,
                                      y1 + 16), 0.38, centre=True)
    step = max(1, n_learned // 16)
    for i in range(0, n_learned, step):
        raster.put_text(img, str(i), (x0 - 24, y0 + (i + 0.7)
                                      * (y1 - y0) / n_learned), 0.38)
    raster.put_text(img, "ground-truth dim", ((x0 + x1) // 2, y1 + 34),
                    centre=True)
    raster.put_text(img, "learned", (4, (y0 + y1) // 2), 0.4)
    raster.colorbar(img, (520, 40, 540, 440), 0.0, 1.0, raster.viridis,
                    "|Pearson r|")
    raster.save_png(img, save_path)
    return img


class LiveView:
    """The interactive window of the states during training, a matplotlib
    figure showing ``render_states``' image. ``create()`` gives None where
    no window can be made (no window server, no matplotlib, a dead X
    connection), and the train CLI's ``plots/live.html`` is the view
    there."""

    def __init__(self):
        import matplotlib.pyplot as plt
        plt.ion()
        self.fig = plt.figure(figsize=(6, 5))
        self.fig.canvas.manager.set_window_title("SRL live states")

    @classmethod
    def create(cls) -> Optional["LiveView"]:
        if sys.platform not in ("darwin", "win32") \
                and not os.environ.get("DISPLAY") \
                and not os.environ.get("WAYLAND_DISPLAY"):
            return None  # headless: no window server to draw on
        try:
            import matplotlib
            import matplotlib.pyplot as plt
        except ImportError:
            return None  # no GUI toolkit to draw with
        prev = matplotlib.get_backend()
        try:
            plt.switch_backend("TkAgg")
            return cls()
        except Exception:
            # switch_backend only imports tkinter: a dead X connection
            # raises from plt.figure() after the global backend changed.
            # Restore it, or every later pyplot user inherits a broken
            # TkAgg
            try:
                plt.switch_backend(prev)
            except Exception:
                plt.switch_backend("Agg")
            return None

    def update(self, states: np.ndarray, rewards: np.ndarray,
               title: str) -> None:
        if self.fig is None:
            return
        import matplotlib.pyplot as plt
        try:
            self.fig.clf()
            ax = self.fig.add_subplot(111)
            ax.imshow(render_states(states, rewards, title))
            ax.axis("off")
            self.fig.canvas.draw_idle()
            plt.pause(0.001)  # a tick of the GUI event loop
        except Exception:
            # the user closed the window: a view must never end a
            # training run, so it goes dark and live.html stays
            self.close()

    def close(self) -> None:
        if self.fig is None:
            return
        import matplotlib.pyplot as plt
        try:
            plt.ioff()
            plt.close(self.fig)
        except Exception:
            pass
        self.fig = None


def main(argv=None) -> None:
    """Plot a run's exported states (``states.png``) and, with
    ``--correlation``, their correlation with the ground truth
    (``correlation.png``)."""
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.evaluation.gtc import ground_truth_correlation

    p = argparse.ArgumentParser(description="Plot learned states")
    p.add_argument("--log-folder", type=str, required=True,
                   help="Run folder containing states_rewards.npz")
    p.add_argument("--correlation", action="store_true",
                   help="Also plot the ground-truth correlation heatmap")
    p.add_argument("--data-folder", type=str, default="",
                   help="Dataset folder (defaults to exp_config.json's)")
    args = p.parse_args(argv)

    sr = np.load(os.path.join(args.log_folder, "states_rewards.npz"))
    out = os.path.join(args.log_folder, "states.png")
    plot_representation(sr["states"], sr["rewards"], out)
    print(f"Saved {out}")
    if args.correlation:
        data_folder = args.data_folder
        if not data_folder:
            with open(os.path.join(args.log_folder, "exp_config.json")) as f:
                data_folder = json.load(f)["data-folder"]
        ds = load_dataset(data_folder)
        gtc, corr = ground_truth_correlation(sr["states"],
                                             ds.ground_truth_states)
        out = os.path.join(args.log_folder, "correlation.png")
        plot_correlation(corr, out)
        print(f"GTC score: {gtc:.4f}\nSaved {out}")


if __name__ == "__main__":
    main()
