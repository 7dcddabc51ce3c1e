"""Max-pool formulations measured beside the fused relu + pool (port of
``srl_zoo_tpu/ops/pooling.py``).

The port's models pool through K1f/K1b (ops/fused_pool.py). These two
formulations are kept as references and measured against it on the card
(chip_smoke.py phase 2c, PERF.md §6); no model calls them.

* :func:`max_pool_tree`: the pool as a chain of maxima of nine strided
  slices of the padded input. Its backward is autograd's through
  ``torch.maximum``, which splits a tie's gradient evenly, as JAX's
  ``jnp.maximum`` does.
* :func:`max_pool_argmax`: the 3x3/2 SAME pool as an autograd function
  whose forward caches the int8 argmax of the nine window offsets (the
  first maximum in raster order) and whose backward places the incoming
  gradient at each offset and sums the nine planes.

Both work on NHWC tensors and pad with the dtype's lowest finite value,
as the JAX functions pad with ``jnp.finfo(dtype).min``; on a window that
holds a real element the two agree with a ``-inf`` pad. Plain tensor code,
so they run on either device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from srl_zoo_tpu_torch.ops.fused_pool import same_pads

__all__ = ["same_pads", "max_pool_tree", "max_pool_argmax"]


def _pad_geometry(h: int, w: int, window, strides, padding):
    """((oh, ow), ((top, bottom), (left, right))) of a pool."""
    (wh, ww), (sh, sw) = window, strides
    if padding == "SAME":
        pads = same_pads(h, wh, sh), same_pads(w, ww, sw)
    else:
        pads = tuple((int(a), int(b)) for a, b in padding)
    (pt, pb), (pl, pr) = pads
    return ((h + pt + pb - wh) // sh + 1, (w + pl + pr - ww) // sw + 1), pads


def _padded(x: torch.Tensor, pads) -> torch.Tensor:
    (pt, pb), (pl, pr) = pads
    return F.pad(x, (0, 0, pl, pr, pt, pb), value=torch.finfo(x.dtype).min)


def _window(xp: torch.Tensor, dy: int, dx: int, out, strides):
    """The strided slice of the padded input at window offset (dy, dx)."""
    (oh, ow), (sh, sw) = out, strides
    return xp[:, dy:dy + (oh - 1) * sh + 1:sh, dx:dx + (ow - 1) * sw + 1:sw]


def max_pool_tree(x: torch.Tensor, window=(3, 3), strides=(2, 2),
                  padding="SAME") -> torch.Tensor:
    """Max pool of NHWC ``x`` as a chain of strided-slice maxima;
    ``padding`` is "SAME" or ((top, bottom), (left, right))."""
    out, pads = _pad_geometry(x.shape[1], x.shape[2], window, strides,
                              padding)
    xp = _padded(x, pads)
    y = None
    for dy in range(window[0]):
        for dx in range(window[1]):
            s = _window(xp, dy, dx, out, strides)
            y = s if y is None else torch.maximum(y, s)
    return y


class _MaxPoolArgmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        h, w = x.shape[1], x.shape[2]
        out, pads = _pad_geometry(h, w, (3, 3), (2, 2), "SAME")
        xp = _padded(x, pads)
        views = torch.stack([_window(xp, dy, dx, out, (2, 2))
                             for dy in range(3) for dx in range(3)], dim=-1)
        y, idx = views.max(dim=-1)
        # torch's max returns the first maximal position, as jnp.argmax
        ctx.save_for_backward(idx.to(torch.int8))
        ctx.geometry = (h, w, out, pads)
        return y

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        h, w, (oh, ow), ((pt, pb), (pl, pr)) = ctx.geometry
        total = g.new_zeros((g.shape[0], h + pt + pb, w + pl + pr,
                             g.shape[3]))
        zero = g.new_zeros(())
        for k in range(9):
            dy, dx = divmod(k, 3)
            total[:, dy:dy + 2 * oh - 1:2, dx:dx + 2 * ow - 1:2] += \
                torch.where(idx == k, g, zero)
        return total[:, pt:pt + h, pl:pl + w]


def max_pool_argmax(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 SAME max pool of NHWC ``x``; its backward reads the forward's
    int8 argmax of the nine window offsets."""
    return _MaxPoolArgmax.apply(x)
