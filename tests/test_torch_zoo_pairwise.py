"""K4 (pairwise squared distances) and the ``full`` neighbour route of the
port against the JAX package, on the CPU.

The plain version of K4 is held against the Pallas kernel in interpret
mode (as tests/test_ops.py runs it) and against its XLA reference, at
shapes that are multiples of no tile. The formula |x|^2 + |y|^2 - 2 x.y
cancels for near points, so the tolerance is 1e-5 of |x_i|^2 + |y_j|^2
per element, not of the distance. The ``full`` route (K4, then a stable
sort cut to k) is held against JAX's ``impl="full"``: indices equal on
separated random points, distances within 1e-5 relative, ties to the
lowest index. The CUDA kernel runs only on a GPU: chip_smoke.py holds it
against its plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_zoo_tpu.ops import pairwise as jax_pairwise
from srl_zoo_tpu.ops.knn_topk import knn_topk_with_dist as jax_knn
from srl_zoo_tpu_torch.ops import pairwise_sqdist
from srl_zoo_tpu_torch.ops.knn_topk import (knn_topk, knn_topk_plain,
                                            knn_topk_with_dist)
from srl_zoo_tpu_torch.ops.pairwise import pairwise_sqdist_plain


def _points(n, m, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32),
            rng.randn(m, d).astype(np.float32))


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_pairwise_sqdist_plain_matches_jax(reference):
    x, y = _points(300, 257, 200, 0)
    x[:5] = y[:5]  # a few exact pairs: distance 0 after the clamp
    if reference == "xla":
        want = np.asarray(jax_pairwise._pairwise_xla(jnp.asarray(x),
                                                     jnp.asarray(y)))
    else:
        want = np.asarray(jax_pairwise._pairwise_pallas(
            jnp.asarray(x), jnp.asarray(y), interpret=True))
    got = pairwise_sqdist_plain(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == (300, 257)
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
    err = np.abs(got.numpy() - want)
    assert (err <= 1e-5 * scale).all(), float((err / scale).max())
    assert (got >= 0).all()
    assert torch.equal(
        pairwise_sqdist(torch.from_numpy(x), torch.from_numpy(y)), got)


def test_pairwise_sqdist_takes_other_float_types_and_empty_sets():
    x, y = _points(7, 9, 5, 1)
    got = pairwise_sqdist(torch.from_numpy(x).double(),
                          torch.from_numpy(y).half())
    assert got.dtype == torch.float32
    want = ((x[:, None, :] - y.astype(np.float16).astype(np.float32)[None])
            ** 2).sum(-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert pairwise_sqdist(torch.zeros(0, 5),
                           torch.zeros(3, 5)).shape == (0, 3)
    with pytest.raises(ValueError, match=r"\(N, D\) and \(M, D\)"):
        pairwise_sqdist(torch.zeros(2, 5), torch.zeros(3, 4))


@pytest.mark.parametrize("k", [1, 6, 12])
def test_knn_topk_full_matches_jax_full(k):
    q, r = _points(130, 1111, 37, 2)
    want_d, want_i = jax_knn(q, r, k, impl="full")
    d, i = knn_topk_with_dist(torch.from_numpy(q), torch.from_numpy(r), k,
                              impl="full")
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=1e-5)
    # the fused route's plain version picks the same neighbours
    fd, fi = knn_topk_plain(torch.from_numpy(q), torch.from_numpy(r), k)
    assert torch.equal(fi, i) and torch.equal(fd, d)
    assert torch.equal(knn_topk(torch.from_numpy(q), torch.from_numpy(r), k,
                                impl="full"), i)


def test_knn_topk_full_gives_ties_to_the_lowest_index():
    # small integers and halves: every distance is exact in f32 whatever
    # the summation order, so the three copies of a point tie exactly
    rng = np.random.RandomState(3)
    base = rng.randint(-4, 5, (40, 8)).astype(np.float32)
    r = np.concatenate([base, base, base])
    q = base[:10].copy()
    q[:, 0] += 0.5
    d, i = knn_topk_with_dist(torch.from_numpy(q), torch.from_numpy(r), 3,
                              impl="full")
    nearest = np.arange(10)
    np.testing.assert_array_equal(i.numpy(), np.stack(
        [nearest, nearest + 40, nearest + 80], axis=1))
    np.testing.assert_array_equal(
        i.numpy(), np.asarray(jax_knn(q, r, 3, impl="full")[1]))
    assert (d[:, 0] == d[:, 1]).all() and (d[:, 1] == d[:, 2]).all()
    # a query that is itself in the set ties at 0 with its copies
    d0, i0 = knn_topk_with_dist(torch.from_numpy(base[:4]),
                                torch.from_numpy(r), 3, impl="full")
    assert (d0 == 0).all()
    np.testing.assert_array_equal(i0.numpy()[:, 0], np.arange(4))


@pytest.mark.parametrize("impl,error,match", [
    ("xla", ValueError, "unknown impl 'xla'"),
])
def test_knn_topk_names_what_it_does_not_run(impl, error, match):
    q, r = _points(4, 9, 3, 4)
    with pytest.raises(error, match=match):
        knn_topk(torch.from_numpy(q), torch.from_numpy(r), 2, impl=impl)


def test_pairwise_sqdist_raises_on_a_device_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pairwise_sqdist(torch.empty(4, 3, device="meta"),
                        torch.empty(9, 3, device="meta"))
    with pytest.raises(ValueError, match="on meta"):
        knn_topk(torch.empty(4, 3), torch.empty(9, 3, device="meta"), 2,
                 impl="full")
