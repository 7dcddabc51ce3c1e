"""The gather + normalize (K2) and distance + top-k (K3) modules of the port:
their host-side parts and plain versions, against the JAX package.

K2 takes its index on the host: the range check runs in numpy before any
launch, and the index goes up without a synchronise. K3's grid is planned
from the SM count and the kernel's occupancy. Both are Python that runs
here; the CUDA kernels run only on a GPU (test_torch_zoo_card_kernels.py
holds them against their plain versions there). Inputs come from numpy with a seed.
Tolerances: K2 1e-6 absolute (one rounding of the affine map); K3 1e-5
relative on distances (f32 summation order), indices equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_zoo_tpu.ops.gather_norm import gather_normalize as jax_gather_norm
from srl_zoo_tpu.ops.knn_topk import knn_topk_with_dist as jax_knn
from srl_zoo_tpu_torch.ops import gather_norm
from srl_zoo_tpu_torch.ops.gather_norm import (blocks_per_row,
                                               check_host_index,
                                               gather_normalize,
                                               gather_normalize_plain)
from srl_zoo_tpu_torch.ops.knn_topk import (knn_topk_plain,
                                            knn_topk_with_dist, split_plan)
from srl_zoo_tpu_torch.utils.device import upload


def _store(n, shape=(16, 12, 3), seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n,) + shape).astype(np.uint8), rng


# ---------------------------------------------------------------------------
# K2: the host index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["numpy-int32", "numpy-int64", "cpu-int64",
                                  "list"])
def test_gather_normalize_takes_a_host_index(form):
    frames, rng = _store(20)
    idx = rng.randint(0, 20, 9)
    host = {"numpy-int32": idx.astype(np.int32),
            "numpy-int64": idx.astype(np.int64),
            "cpu-int64": torch.from_numpy(idx.astype(np.int64)),
            "list": idx.tolist()}[form]
    got = gather_normalize(torch.from_numpy(frames), host, "image_net")
    want = gather_normalize_plain(torch.from_numpy(frames),
                                  torch.from_numpy(idx), "image_net")
    assert torch.equal(got, want)
    ref = np.asarray(jax_gather_norm(jnp.asarray(frames),
                                     jnp.asarray(idx, jnp.int32), "tf",
                                     use_pallas=True, interpret=True))
    np.testing.assert_allclose(
        gather_normalize(torch.from_numpy(frames), host).numpy(), ref,
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("bad", [[-1], [0, 20], [3, 25, 1]])
def test_an_out_of_range_host_index_raises_before_a_launch(bad):
    frames, _ = _store(20)
    with pytest.raises(IndexError, match=r"outside \[0, 20\)"):
        check_host_index(np.array(bad), 20)
    before = gather_normalize.launches
    with pytest.raises(IndexError):
        gather_normalize(torch.from_numpy(frames), np.array(bad))
    assert gather_normalize.launches == before


def test_check_host_index_gives_contiguous_int64():
    idx = np.arange(12, dtype=np.int32)[::2]
    out = check_host_index(idx, 12)
    assert out.dtype == np.int64 and out.flags.c_contiguous
    np.testing.assert_array_equal(out, idx)
    assert check_host_index(np.array([], np.int64), 0).shape == (0,)
    with pytest.raises(ValueError):
        check_host_index(np.zeros((2, 2), np.int64), 4)
    with pytest.raises(ValueError):
        check_host_index(np.array([0.0, 1.0]), 4)


def test_gather_normalize_of_an_empty_index():
    frames, _ = _store(4)
    out = gather_normalize(torch.from_numpy(frames), np.array([], np.int64))
    assert out.shape == (0, 16, 12, 3) and out.dtype == torch.float32


def test_upload_converts_on_the_cpu():
    t = upload(np.array([1, 0, 1], np.int32), torch.device("cpu"),
               torch.float32)
    assert t.dtype == torch.float32 and t.tolist() == [1.0, 0.0, 1.0]
    a = np.arange(6, dtype=np.int64).reshape(2, 3)[:, ::2]
    assert upload(a, torch.device("cpu")).tolist() == a.tolist()


@pytest.mark.parametrize("rows,units,sms", [(32, 37632, 132),
                                            (256, 37632, 132),
                                            (1, 37632, 132),
                                            (4000, 37632, 132),
                                            (7, 351, 132), (3, 1, 1)])
def test_gather_grid_aims_at_two_blocks_per_sm(rows, units, sms):
    per_row = blocks_per_row(rows, units, sms)
    aim = sms * gather_norm.BLOCKS_PER_SM
    assert 1 <= per_row <= -(-units // gather_norm.THREADS)
    # no more blocks than the aim, unless one block per row is already more
    assert rows * per_row <= max(aim, rows)
    if per_row < -(-units // gather_norm.THREADS) and rows <= aim:
        assert rows * (per_row + 1) > aim  # as many as the aim allows


def test_gather_grid_at_the_main_paths():
    # 224 x 224 x 3 frames in 4-byte groups on 132 SMs, an aim of 264
    # blocks: 8 per row at the training batch, one per row at the export's
    assert blocks_per_row(32, 224 * 224 * 3 // 4, 132) == 8
    assert blocks_per_row(256, 224 * 224 * 3 // 4, 132) == 1


# ---------------------------------------------------------------------------
# K3: the plain version at the edges of k and N, and the grid plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq,n,d,k,impl", [
    (20, 300, 9, 1, "pallas_t"),
    (20, 300, 9, 64, "pallas"),
    (13, 6, 9, 6, "pallas_t"),    # N = k
    (13, 64, 5, 64, "pallas"),    # N = k = 64
])
def test_knn_topk_plain_matches_pallas_at_the_edges(nq, n, d, k, impl):
    rng = np.random.RandomState(nq + n + k)
    q = rng.randn(nq, d).astype(np.float32)
    r = rng.randn(n, d).astype(np.float32)
    ref_d, ref_i = jax_knn(q, r, k, impl=impl, interpret=True)
    dist, idx = knn_topk_with_dist(torch.from_numpy(q), torch.from_numpy(r),
                                   k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(dist.numpy(), np.asarray(ref_d), rtol=1e-5)
    if n == k:  # every reference, nearest first
        assert sorted(idx[0].tolist()) == list(range(n))
    dp, ip = knn_topk_plain(torch.from_numpy(q), torch.from_numpy(r), k)
    assert torch.equal(ip, idx) and torch.equal(dp, dist)


@pytest.mark.parametrize("q_tiles,r_tiles,sms,per_sm", [
    (64, 79, 132, 2), (64, 79, 132, 1), (1, 79, 132, 2), (3, 5, 132, 2),
    (1, 1, 132, 2), (500, 400, 132, 2), (64, 79, 8, 3), (2, 1000, 16, 1)])
def test_split_plan_fills_whole_waves(q_tiles, r_tiles, sms, per_sm):
    splits, tiles = split_plan(q_tiles, r_tiles, sms, per_sm)
    assert 1 <= splits <= r_tiles and 1 <= tiles <= r_tiles
    # the splits cover the tiles, and none is empty
    assert splits * tiles >= r_tiles > (splits - 1) * tiles
    slots = sms * per_sm
    # the blocks fit one wave of the slots, unless one split per query
    # tile is already more
    assert q_tiles * splits <= max(slots, q_tiles)
    # and fill it: a block with one tile fewer would overflow the wave
    if tiles > 1 and q_tiles <= slots:
        assert q_tiles * -(-r_tiles // (tiles - 1)) > slots
    # when one wave holds every (query tile, reference tile) pair, it is
    # taken: one tile per block
    if q_tiles * r_tiles <= slots:
        assert (splits, tiles) == (r_tiles, 1)


def test_split_plan_at_the_main_path():
    # Q 4,096 / N 20,000: 64 query tiles of 64, 79 reference tiles of 256;
    # at 2 blocks per SM on 132 SMs, 4 splits of 20 tiles make 256 blocks,
    # one wave of the 264 slots
    assert split_plan(64, 79, 132, 2) == (4, 20)
