"""The port's kernel modules against the JAX kernels they replace.

Each kernel of ``srl_zoo_tpu_torch/ops`` has a plain PyTorch version that
runs on the CPU; it is held here against the JAX function, which reaches
its Pallas kernel in interpret mode (as tests/test_ops.py runs it) or its
XLA reference. The CUDA kernels themselves run only on a GPU:
test_torch_zoo_card_kernels.py holds each against its plain version there. Inputs come from numpy with a
seed. Tolerances: K1 (relu + pool) exact, y and argmax; K2 (gather +
normalize) 1e-6 absolute (one rounding of the affine map); K3 (distance +
top-k) 1e-5 relative on distances (f32 summation order), indices equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_zoo_tpu.ops import fused_pool as jax_pool
from srl_zoo_tpu.ops.gather_norm import gather_normalize as jax_gather_norm
from srl_zoo_tpu.ops.knn_topk import knn_topk_with_dist as jax_knn
from srl_zoo_tpu.ops.preproc import normalize_images as jax_normalize
from srl_zoo_tpu_torch.ops.fused_pool import (SENTINEL, relu_max_pool,
                                              relu_max_pool_plain)
from srl_zoo_tpu_torch.ops.gather_norm import (gather_normalize,
                                               gather_normalize_plain)
from srl_zoo_tpu_torch.ops.knn_topk import knn_topk_plain, knn_topk_with_dist


def _pool_input(shape, seed):
    """Half the channels small integers (many exact positive ties and
    all-non-positive windows), half normal; the first window of the first
    channel all negative."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    c = shape[-1] // 2
    x[..., :c] = rng.randint(-2, 3, shape[:-1] + (c,))
    x[0, :3, :3, 0] = -1.0
    return x


def _np_pads(padding):
    return padding if padding == "SAME" else tuple(map(tuple, padding))


# ---------------------------------------------------------------------------
# K1: fused relu + 3x3/2 max-pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 32, 32, 64), (2, 8, 8, 64)])
@pytest.mark.parametrize("padding", ["SAME", ((1, 1), (1, 1))])
def test_relu_max_pool_plain_matches_pallas_bf16(shape, padding):
    x = jnp.asarray(_pool_input(shape, 0), jnp.bfloat16)
    pads = jax_pool._resolve_pads(shape[1], shape[2], padding)
    y_ref, idx_ref = jax_pool._fwd_pallas(x, pads, interpret=True)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    y, idx = relu_max_pool_plain(xt, _np_pads(padding), with_index=True)
    assert y.dtype == torch.bfloat16 and idx.dtype == torch.int8
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(y_ref.astype(jnp.float32)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    # the window forced all-negative is relu-killed: y 0, sentinel index
    assert float(y[0, 0, 0, 0]) == 0.0 and int(idx[0, 0, 0, 0]) == SENTINEL
    assert (idx.numpy() == SENTINEL).any() and (idx.numpy() < SENTINEL).any()


@pytest.mark.parametrize("shape,padding", [
    ((2, 32, 32, 64), "SAME"),
    ((2, 28, 28, 16), "SAME"),
    ((2, 7, 7, 64), "SAME"),
    ((2, 7, 7, 64), ((1, 1), (1, 1))),
    # the shapes that reach the kernels' scalar path and tile edges:
    # C * 4 bytes not a multiple of 16 (3, 66) or 3 vectors (12), B = 1,
    # a ragged 9 x 13 image, a 1 x 1 image, pads of 0, 2 and 1 per side
    ((1, 9, 13, 3), ((0, 0), (0, 0))),
    ((1, 9, 13, 12), ((2, 0), (0, 2))),
    ((1, 9, 13, 66), ((1, 1), (1, 1))),
    ((1, 1, 1, 12), ((1, 1), (1, 1))),
    ((1, 1, 1, 3), "SAME"),
    ((1, 1, 1, 66), ((2, 0), (0, 2))),
])
def test_relu_max_pool_plain_matches_reference_f32(shape, padding):
    x = _pool_input(shape, 1)
    ref = np.asarray(jax_pool.relu_max_pool_reference(jnp.asarray(x),
                                                      padding))
    y = relu_max_pool(torch.from_numpy(x), _np_pads(padding))
    np.testing.assert_array_equal(y.numpy(), ref)


def test_relu_max_pool_index_is_first_window_maximum():
    """Raster-first on positive ties, sentinel at a non-positive max."""
    x = np.zeros((1, 4, 4, 2), np.float32)
    x[0, 0, 1, 0] = x[0, 1, 0, 0] = 5.0  # tie: raster positions 1 and 3
    x[..., 1] = -3.0
    y, idx = relu_max_pool_plain(torch.from_numpy(x), ((0, 1), (0, 1)),
                                 with_index=True)
    assert float(y[0, 0, 0, 0]) == 5.0 and int(idx[0, 0, 0, 0]) == 1
    assert float(y[0, 0, 0, 1]) == 0.0 and int(idx[0, 0, 0, 1]) == SENTINEL


# ---------------------------------------------------------------------------
# K2: gather + normalize
# ---------------------------------------------------------------------------

def _store(n, c, seed=0):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, 64, 64, c)).astype(np.uint8)
    idx = rng.randint(0, n, 13)
    return frames, idx


def test_gather_normalize_plain_matches_pallas_tf():
    frames, idx = _store(20, 3)
    ref = np.asarray(jax_gather_norm(jnp.asarray(frames),
                                     jnp.asarray(idx, jnp.int32), "tf",
                                     use_pallas=True, interpret=True))
    got = gather_normalize(torch.from_numpy(frames), torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("channels", [3, 6])
def test_gather_normalize_plain_matches_image_net(channels):
    frames, idx = _store(20, channels, seed=1)
    ref = np.asarray(jax_normalize(jnp.asarray(frames[idx]), "image_net"))
    got = gather_normalize_plain(torch.from_numpy(frames),
                                 torch.from_numpy(idx), "image_net")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_gather_normalize_rejects_out_of_range_index():
    frames, _ = _store(4, 3)
    with pytest.raises(IndexError):
        gather_normalize(torch.from_numpy(frames), torch.tensor([0, 4]))


# ---------------------------------------------------------------------------
# K3: fused distance + top-k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,k", [("pallas_t", 6), ("pallas", 6),
                                    ("pallas", 12)])
def test_knn_topk_plain_matches_pallas(impl, k):
    rng = np.random.RandomState(2)
    q = rng.randn(130, 37).astype(np.float32)
    r = rng.randn(1111, 37).astype(np.float32)
    ref_d, ref_i = jax_knn(q, r, k, impl=impl, interpret=True)
    d, i = knn_topk_with_dist(torch.from_numpy(q), torch.from_numpy(r), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), rtol=1e-5)
    assert (np.diff(d.numpy(), axis=1) >= 0).all()


def test_knn_topk_ties_go_to_lowest_index():
    # small integers and halves: every distance is exact in f32, whatever
    # the summation order, so the three copies of a point tie exactly
    rng = np.random.RandomState(3)
    base = rng.randint(-4, 5, (40, 8)).astype(np.float32)
    r = np.concatenate([base, base, base])  # each point three times
    q = base[:10].copy()
    q[:, 0] += 0.5
    d, i = knn_topk_plain(torch.from_numpy(q), torch.from_numpy(r), 3)
    ref_d, ref_i = jax_knn(q, r, 3, impl="pallas_t", interpret=True)
    nearest = np.arange(10)
    np.testing.assert_array_equal(i.numpy(), np.stack(
        [nearest, nearest + 40, nearest + 80], axis=1))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    assert (d[:, 0] == d[:, 1]).all() and (d[:, 1] == d[:, 2]).all()


# ---------------------------------------------------------------------------
# wrappers: no silent fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda: relu_max_pool(torch.empty(1, 8, 8, 4, device="meta")),
    lambda: gather_normalize(
        torch.empty(2, 8, 8, 3, dtype=torch.uint8, device="meta"),
        torch.empty(1, dtype=torch.int64, device="meta")),
    lambda: gather_normalize(torch.empty(2, 8, 8, 3, dtype=torch.uint8),
                             torch.empty(1, dtype=torch.int64,
                                         device="meta")),
    lambda: knn_topk_with_dist(torch.empty(4, 3, device="meta"),
                               torch.empty(9, 3, device="meta"), 2),
], ids=["pool", "gather", "gather-mixed", "knn"])
def test_wrappers_raise_on_a_device_without_a_kernel(call):
    with pytest.raises(ValueError, match="device|on meta|meta"):
        call()
