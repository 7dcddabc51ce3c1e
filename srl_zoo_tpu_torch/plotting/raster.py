"""PNG figures drawn with numpy and OpenCV.

The JAX package draws its file plots with matplotlib. The port depends
on OpenCV, not on matplotlib, so it draws every file plot (states,
correlation, losses, neighbour grids, latent sweeps) itself: RGB uint8
canvases, OpenCV's line, circle and text primitives, and
``cv2.imwrite``. The figures do not depend on the GUI backend a live
window has selected.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

BLACK = (0, 0, 0)
# matplotlib's coolwarm at 9 even stops, and its tab10 line colours
COOLWARM = np.array([[59, 76, 192], [98, 130, 234], [141, 176, 254],
                     [185, 208, 249], [221, 220, 220], [245, 196, 172],
                     [244, 152, 122], [221, 95, 75], [180, 4, 38]],
                    np.float64)
TAB10 = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
         (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
         (188, 189, 34), (23, 190, 207))


def canvas(height: int, width: int) -> np.ndarray:
    return np.full((height, width, 3), 255, np.uint8)


def put_text(img: np.ndarray, text: str, org, scale: float = 0.45,
             color=BLACK, centre: bool = False) -> None:
    """``text`` with its baseline's left end (or centre) at ``org``."""
    import cv2
    org = (int(org[0]), int(org[1]))
    if centre:
        (w, _), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, 1)
        org = (org[0] - w // 2, org[1])
    cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, color, 1,
                cv2.LINE_AA)


def coolwarm(values: np.ndarray) -> np.ndarray:
    """(N,) values -> (N, 3) uint8 RGB, their range spread over coolwarm."""
    v = np.asarray(values, np.float64).reshape(-1)
    span = v.max() - v.min() if len(v) else 0.0
    t = (v - v.min()) / span if span > 0 else np.full(len(v), 0.5)
    pos = t * (len(COOLWARM) - 1)
    lo = np.minimum(pos.astype(int), len(COOLWARM) - 2)
    frac = (pos - lo)[:, None]
    return ((1 - frac) * COOLWARM[lo] + frac * COOLWARM[lo + 1]
            ).round().astype(np.uint8)


def viridis(values: np.ndarray) -> np.ndarray:
    """Values in [0, 1] (any shape) -> RGB uint8 of shape + (3,)."""
    import cv2
    v = np.clip(np.asarray(values, np.float64), 0.0, 1.0)
    u8 = (v * 255).round().astype(np.uint8)
    bgr = cv2.applyColorMap(u8.reshape(-1, 1), cv2.COLORMAP_VIRIDIS)
    return bgr[:, 0, ::-1].reshape(v.shape + (3,))


class Axes:
    """A data-to-pixel map into the box (x0, y0, x1, y1) of an image, with
    its frame and the limits of each axis written beside it."""

    def __init__(self, img: np.ndarray, box, xlim, ylim):
        self.img = img
        self.x0, self.y0, self.x1, self.y1 = box
        self.xlim = _widen(xlim)
        self.ylim = _widen(ylim)

    def px(self, x, y):
        (a, b), (c, d) = self.xlim, self.ylim
        u = self.x0 + (np.asarray(x, np.float64) - a) / (b - a) \
            * (self.x1 - self.x0)
        v = self.y1 - (np.asarray(y, np.float64) - c) / (d - c) \
            * (self.y1 - self.y0)
        return u, v

    def frame(self, xlabel: str = "", ylabel: str = "",
              ylim_text: Optional[Sequence[str]] = None) -> None:
        import cv2
        cv2.rectangle(self.img, (self.x0, self.y0), (self.x1, self.y1),
                      BLACK, 1)
        put_text(self.img, f"{self.xlim[0]:.3g}", (self.x0, self.y1 + 16),
                 0.38, centre=True)
        put_text(self.img, f"{self.xlim[1]:.3g}", (self.x1, self.y1 + 16),
                 0.38, centre=True)
        lo, hi = ylim_text or (f"{self.ylim[0]:.3g}", f"{self.ylim[1]:.3g}")
        put_text(self.img, lo, (2, self.y1), 0.38)
        put_text(self.img, hi, (2, self.y0 + 10), 0.38)
        if xlabel:
            put_text(self.img, xlabel, ((self.x0 + self.x1) // 2,
                                        self.y1 + 32), centre=True)
        if ylabel:
            put_text(self.img, ylabel, (2, (self.y0 + self.y1) // 2))

    def scatter(self, x, y, colors: np.ndarray, radius: int = 2) -> None:
        import cv2
        u, v = self.px(x, y)
        for ui, vi, c in zip(u, v, colors):
            cv2.circle(self.img, (int(round(ui)), int(round(vi))), radius,
                       tuple(int(k) for k in c), -1, cv2.LINE_AA)

    def line(self, x, y, color) -> None:
        import cv2
        u, v = self.px(x, y)
        pts = np.stack([u, v], 1).round().astype(np.int32)
        cv2.polylines(self.img, [pts], False, color, 1, cv2.LINE_AA)


def _widen(lim):
    lo, hi = float(lim[0]), float(lim[1])
    if not np.isfinite(lo) or not np.isfinite(hi):
        return (0.0, 1.0)
    if hi - lo <= 1e-12 * max(1.0, abs(lo)):
        return (lo - 0.5, hi + 0.5)
    pad = 0.04 * (hi - lo)
    return (lo - pad, hi + pad)


def colorbar(img: np.ndarray, box, lo: float, hi: float, colors_of,
             label: str) -> None:
    """A vertical bar in ``box`` of ``colors_of`` over [lo, hi], labelled."""
    import cv2
    x0, y0, x1, y1 = box
    t = np.linspace(1.0, 0.0, y1 - y0)
    img[y0:y1, x0:x1] = colors_of(t)[:, None, :]
    cv2.rectangle(img, (x0, y0), (x1, y1), BLACK, 1)
    put_text(img, f"{hi:.3g}", (x1 + 4, y0 + 10), 0.38)
    put_text(img, f"{lo:.3g}", (x1 + 4, y1), 0.38)
    put_text(img, label, (x0 - 4, y1 + 18), 0.38)


def image_grid(rows: Sequence[Sequence[Optional[np.ndarray]]],
               titles: Sequence[Sequence[str]], side: int,
               row_labels: Sequence[str] = (), title: str = "") -> np.ndarray:
    """Images (uint8, or floats in [0, 1]; None draws "no image") in a
    grid of side x side tiles (nearest-neighbour, so small frames stay
    sharp), each with a title above it, a label left of each row and a
    title on top."""
    import cv2
    n_rows, n_cols = len(rows), max(len(r) for r in rows)
    left = 56 if row_labels else 6
    top = 26 if title else 4
    cell_h = side + 20
    img = canvas(top + n_rows * cell_h + 6, left + n_cols * (side + 6))
    if title:
        put_text(img, title, (img.shape[1] // 2, 18), 0.5, centre=True)
    for r, row in enumerate(rows):
        y = top + r * cell_h + 18
        if r < len(row_labels):
            put_text(img, row_labels[r], (4, y + side // 2), 0.4)
        for c, image in enumerate(row):
            x = left + c * (side + 6)
            put_text(img, titles[r][c], (x + side // 2, y - 5), 0.4,
                     centre=True)
            if image is None:
                img[y:y + side, x:x + side] = 235
                put_text(img, "no image", (x + side // 2, y + side // 2),
                         0.45, centre=True)
            else:
                if image.dtype != np.uint8:
                    image = (np.clip(image, 0.0, 1.0) * 255).round(
                    ).astype(np.uint8)
                img[y:y + side, x:x + side] = cv2.resize(
                    np.ascontiguousarray(image[..., :3]), (side, side),
                    interpolation=cv2.INTER_NEAREST)
    return img


def save_png(img: np.ndarray, path: Optional[str]) -> None:
    """Write an RGB uint8 image as a PNG (no-op for no path)."""
    if not path:
        return
    import cv2
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1])):
        raise OSError(f"could not write {path}")
