"""Loss curves from a run's ``loss_history.npz`` (port of
``srl_zoo_tpu/plotting/losses_plot.py``), drawn by ``plotting/raster.py``.

    python -m srl_zoo_tpu_torch.plotting.losses_plot --log-folder logs/<run>

writes ``losses.png`` beside the history.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from srl_zoo_tpu_torch.plotting import raster


def _symlog(y: np.ndarray) -> np.ndarray:
    """matplotlib's symlog scale with its linear range of +-1 (base 10)."""
    a = np.abs(y)
    return np.sign(y) * np.where(a <= 1.0, a, 1.0 + np.log10(np.maximum(a,
                                                                        1.0)))


def plot_losses(history_path: str, save_path: Optional[str] = None
                ) -> np.ndarray:
    """Every 1-D numeric train/val series of a loss history, by epoch, on
    a symlog axis; returns the RGB image and writes it to ``save_path`` as
    a PNG."""
    data = np.load(history_path)
    epochs = data["epoch"] if "epoch" in data else None
    series = []
    for key in sorted(data.files):
        if key == "epoch" or key.endswith("/l1_reg"):
            continue
        y = data[key]
        if y.ndim != 1 or not np.issubdtype(y.dtype, np.number) or not len(y):
            continue
        x = epochs if epochs is not None and len(epochs) == len(y) \
            else np.arange(len(y))
        series.append((key, np.asarray(x, np.float64),
                       np.asarray(y, np.float64)))
    img = raster.canvas(500, 760)
    raster.put_text(img, "Training losses", (290, 22), 0.55, centre=True)
    xs = np.concatenate([x for _, x, _ in series]) if series else np.zeros(1)
    ys = np.concatenate([y for _, _, y in series]) if series else np.zeros(1)
    finite = ys[np.isfinite(ys)]
    lo, hi = finite.min(initial=0.0), finite.max(initial=1.0)
    ax = raster.Axes(img, (60, 40, 520, 440), (xs.min(), xs.max()),
                     (_symlog(lo), _symlog(hi)))
    ax.frame("epoch", "", ylim_text=(f"{lo:.3g}", f"{hi:.3g} (symlog)"))
    for i, (key, x, y) in enumerate(series):
        color = raster.TAB10[i % len(raster.TAB10)]
        ok = np.isfinite(y)
        ax.line(x[ok], _symlog(y[ok]), color)
        raster.put_text(img, key[:30], (540, 50 + 16 * i), 0.38, color=color)
    raster.save_png(img, save_path)
    return img


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="Plot a run's loss curves")
    p.add_argument("--log-folder", type=str, required=True)
    args = p.parse_args(argv)
    out = os.path.join(args.log_folder, "losses.png")
    plot_losses(os.path.join(args.log_folder, "loss_history.npz"), out)
    print(f"Saved {out}")
    return out


if __name__ == "__main__":
    main()
