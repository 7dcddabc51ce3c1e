"""The port's hand-written kernels on the card against their plain
PyTorch versions: the fused relu + max-pool forward (K1f) and backward
(K1b), the gather + normalize (K2), the fused distance + top-k (K3) and
the pairwise distances (K4), at the shapes the main paths give them and
at edge shapes, each on the path its shape selects (the wrappers'
``vector_launches`` and ``bf16_launches``); K3 over reference blocks
merged by ``merge_topk``; and the measured alternatives (subpixel
deconvolution, the pool formulations, the s2d stem and the blocked
neighbour route) against the port's own formulations.

Every test needs a CUDA device and skips without one; this file imports
no JAX, so on the card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q -m chip \\
        tests/test_torch_zoo_card_kernels.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_card_lib import cuda  # noqa: F401 (a fixture)
from torch_card_lib import (IMG, KNN_QUERIES, N_FRAMES, POOLS, SEED,
                            STATE_DIM, launches, near_ties)

pytestmark = pytest.mark.chip
F32, BF16 = torch.float32, torch.bfloat16
EXPORT_BATCH = 256  # predict_dataset's batch
TRAIN_BATCH = 32
K = 6


@pytest.fixture
def gen(cuda):
    return torch.Generator(device=cuda).manual_seed(SEED)


@pytest.fixture(scope="module")
def store(cuda):
    """The inference path's store: 20,000 random 224x224x3 frames."""
    g = torch.Generator(device=cuda).manual_seed(SEED)
    return torch.randint(0, 256, (N_FRAMES,) + IMG, generator=g, device=cuda,
                         dtype=torch.uint8)


def path_of(fn, call):
    """``call()``'s result and the path its one launch of ``fn`` took."""
    before = fn.vector_launches
    out = call()
    return out, "vector" if fn.vector_launches - before == 1 else "scalar"


# ---------------------------------------------------------------------------
# K1f and K1b
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("hw", POOLS)
@pytest.mark.parametrize("batch", [TRAIN_BATCH, EXPORT_BATCH])
def test_pool_forward_at_the_main_shapes(cuda, gen, batch, hw, dtype):
    """K1f at the three pools of a config-1 forward, at the serve and
    training batch and the export batch: y and the argmax plane equal
    to the plain version's, on the vector path."""
    from srl_zoo_tpu_torch.ops.fused_pool import (relu_max_pool,
                                                  relu_max_pool_plain)
    x = torch.randn((batch, hw, hw, 64), generator=gen, device=cuda).to(dtype)
    (y, idx), path = path_of(relu_max_pool,
                             lambda: relu_max_pool(x, with_index=True))
    yp, ip = relu_max_pool_plain(x, with_index=True)
    assert torch.equal(y, yp) and torch.equal(relu_max_pool(x), yp)
    assert torch.equal(idx, ip), int((idx != ip).sum())
    assert path == "vector"


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("kind", ["integer", "random"])
@pytest.mark.parametrize("hw", POOLS)
def test_pool_backward_at_the_main_shapes(cuda, gen, hw, kind, dtype):
    """K1b at the three pools of a batch-32 train step: exact on
    integer-valued inputs and cotangents, within 1e-6 of the largest |g|
    on random floats (both add a window's nine positions in raster order
    in f32 and round once), on the vector path."""
    from srl_zoo_tpu_torch.ops.fused_pool import (relu_max_pool_bwd,
                                                  relu_max_pool_bwd_plain,
                                                  relu_max_pool_plain)
    shape = (TRAIN_BATCH, hw, hw, 64)
    integer = kind == "integer"
    x = (torch.randint(-2, 3, shape, generator=gen, device=cuda) if integer
         else torch.randn(shape, generator=gen, device=cuda)).to(dtype)
    _, idx = relu_max_pool_plain(x, with_index=True)
    gy = (torch.randint(-8, 9, idx.shape, generator=gen, device=cuda)
          if integer else torch.randn(idx.shape, generator=gen, device=cuda)
          ).to(dtype)
    dx, path = path_of(relu_max_pool_bwd,
                       lambda: relu_max_pool_bwd(gy, idx, shape))
    err = float((dx.float() - relu_max_pool_bwd_plain(
        gy, idx, shape).float()).abs().max())
    assert err <= (0.0 if integer else 1e-6 * float(gy.float().abs().max()))
    assert path == "vector"


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_pool_at_the_resnet_stem(cuda, gen, dtype):
    """K1f and K1b at the ResNet stem's pool, (32, 112, 112, 64) with the
    explicit pads ((1, 1), (1, 1)): the inference and training forward
    and the backward, exact on integer values, on the vector path."""
    from srl_zoo_tpu_torch.models.resnet import STEM_POOL_PADS as pads
    from srl_zoo_tpu_torch.ops.fused_pool import (relu_max_pool,
                                                  relu_max_pool_bwd,
                                                  relu_max_pool_bwd_plain,
                                                  relu_max_pool_plain)
    shape = (TRAIN_BATCH, POOLS[0], POOLS[0], 64)
    x = torch.randint(-2, 3, shape, generator=gen, device=cuda).to(dtype)
    (y, idx), path = path_of(relu_max_pool, lambda: relu_max_pool(
        x, pads, with_index=True))
    yp, ip = relu_max_pool_plain(x, pads, with_index=True)
    gy = torch.randint(-8, 9, yp.shape, generator=gen, device=cuda).to(dtype)
    dx, bpath = path_of(relu_max_pool_bwd,
                        lambda: relu_max_pool_bwd(gy, idx, shape, pads))
    assert torch.equal(y, yp) and torch.equal(idx, ip)
    assert torch.equal(relu_max_pool(x, pads), yp)
    assert torch.equal(dx, relu_max_pool_bwd_plain(gy, ip, shape, pads))
    assert (path, bpath) == ("vector", "vector")


POOL_EDGES = [(1, hw, c, dtype, pads, False)
              for c, dtype in ((3, F32), (12, F32), (66, F32), (64, F32),
                               (12, BF16), (64, BF16))
              for hw in ((9, 13), (1, 1))
              for pads in (((0, 0), (0, 0)), ((2, 0), (0, 2)),
                           ((1, 1), (1, 1)))]
POOL_EDGES += [(3, (9, 13), 64, dtype, "SAME", True) for dtype in (F32, BF16)]


@pytest.mark.parametrize("b,hw,c,dtype,pads,offset", POOL_EDGES)
def test_pool_at_edge_shapes(cuda, gen, b, hw, c, dtype, pads, offset):
    """K1f (y and idx) and K1b (dx) equal to their plain versions where
    the scalar path and the vector path's tile edges are reached: C 3,
    12, 66 and 64 in f32, 12 and 64 in bf16, 9 x 13 and 1 x 1 images,
    three pads, slices at a storage offset of one element; integer
    values, so every sum is exact. Each call takes the path its shape
    and alignment select, and a pool with no output raises."""
    from srl_zoo_tpu_torch.ops.fused_pool import (relu_max_pool,
                                                  relu_max_pool_bwd,
                                                  relu_max_pool_bwd_plain,
                                                  relu_max_pool_plain)
    shape = (b, *hw, c)

    def ints(lo, hi, count):
        flat = torch.randint(lo, hi, (count + offset,), generator=gen,
                             device=cuda).to(dtype)
        return flat[int(offset):]

    x = ints(-2, 3, int(np.prod(shape))).view(shape)
    if pads == ((0, 0), (0, 0)) and hw[0] == 1:
        with pytest.raises(ValueError):
            relu_max_pool(x, pads)
        return
    want = "vector" if (c * x.element_size()) % 16 == 0 and not offset \
        else "scalar"
    (y, idx), path = path_of(
        relu_max_pool, lambda: relu_max_pool(x, pads, with_index=True))
    yp, ip = relu_max_pool_plain(x, pads, with_index=True)
    gy = ints(-8, 9, yp.numel()).view(yp.shape)
    dx, bpath = path_of(relu_max_pool_bwd,
                        lambda: relu_max_pool_bwd(gy, ip, shape, pads))
    assert torch.equal(y, yp) and torch.equal(idx, ip)
    assert torch.equal(relu_max_pool(x, pads), yp)
    assert torch.equal(dx, relu_max_pool_bwd_plain(gy, ip, shape, pads))
    assert (path, bpath) == (want, want)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["tf", "image_net"])
@pytest.mark.parametrize("rows", [EXPORT_BATCH, TRAIN_BATCH])
def test_gather_at_the_main_shapes(cuda, store, rows, mode):
    """K2 of the export batch and the training batch from a host index:
    within 1e-6 of the plain version, on the vector path, and a CUDA
    index gives the same rows."""
    from srl_zoo_tpu_torch.ops.gather_norm import (gather_normalize,
                                                   gather_normalize_plain)
    idx = np.random.default_rng(SEED).integers(0, N_FRAMES, rows)
    idx_dev = torch.from_numpy(idx).to(cuda)
    out, path = path_of(gather_normalize,
                        lambda: gather_normalize(store, idx, mode))
    ref = gather_normalize_plain(store, idx_dev, mode)
    assert float((out - ref).abs().max()) <= 1e-6
    assert path == "vector"
    assert torch.equal(gather_normalize(store, idx_dev, mode), out)


@pytest.mark.parametrize("channels", [3, 6])
def test_gather_over_the_identity_index(cuda, gen, channels):
    """K2 over the identity index, as a streamed batch is normalized (6
    channels: two views stacked): within 1e-6, on the vector path."""
    from srl_zoo_tpu_torch.ops.gather_norm import (gather_normalize,
                                                   gather_normalize_plain)
    from srl_zoo_tpu_torch.training.train_step import normalize_streamed
    u8 = torch.randint(0, 256, (TRAIN_BATCH, IMG[0], IMG[1], channels),
                       generator=gen, device=cuda, dtype=torch.uint8)
    out, path = path_of(gather_normalize,
                        lambda: normalize_streamed(u8, "tf", cuda))
    ref = gather_normalize_plain(u8, torch.arange(TRAIN_BATCH, device=cuda))
    assert float((out - ref).abs().max()) <= 1e-6
    assert path == "vector"


@pytest.mark.parametrize("frames_shape,offset", [
    ((5, 9, 13, 1), 0), ((5, 9, 13, 3), 0), ((5, 9, 13, 4), 0),
    ((5, 9, 13, 6), 0), ((5, 9, 13, 8), 0), ((5, 16, 16, 1), 0),
    ((1, 7, 5, 8), 0), ((3,) + IMG, 1), ((3,) + IMG, 4)])
def test_gather_at_edge_shapes(cuda, gen, frames_shape, offset):
    """K2 within 1e-6 of its plain version off the main path, each call
    on the path its shape selects (vector where a frame is a whole number
    of 4-byte groups and the store starts 4-byte aligned): B 1 and 7,
    both modes where C is 3 or 6, indices as numpy and as a CPU
    tensor."""
    from srl_zoo_tpu_torch.ops.gather_norm import (gather_normalize,
                                                   gather_normalize_plain)
    n, h, w, c = frames_shape
    flat = torch.randint(0, 256, (n * h * w * c + offset,), generator=gen,
                         device=cuda, dtype=torch.uint8)
    frames = flat[offset:].view(frames_shape)
    want = "vector" if (h * w * c) % 4 == 0 and offset % 4 == 0 \
        else "scalar"
    rng = np.random.default_rng(SEED)
    for b in (1, 7):
        idx_np = rng.integers(0, n, b)
        for mode in ("tf", "image_net") if c % 3 == 0 else ("tf",):
            ref = gather_normalize_plain(
                frames, torch.from_numpy(idx_np).to(cuda), mode)
            for idx in (idx_np, torch.from_numpy(idx_np)):
                out, path = path_of(gather_normalize, lambda: (
                    gather_normalize(frames, idx, mode)))
                assert float((out - ref).abs().max()) <= 1e-6, (b, mode)
                assert path == want


def test_gather_rejects_an_index_out_of_range(cuda, store):
    """An index of -1 or N raises IndexError: from the host before any
    launch, and from a CUDA index (read back to the host)."""
    from srl_zoo_tpu_torch.ops.gather_norm import gather_normalize
    before = gather_normalize.launches
    for bad in ([0, -1], [N_FRAMES]):
        with pytest.raises(IndexError):
            gather_normalize(store, np.array(bad))
    assert gather_normalize.launches == before
    for bad in ([0, -1], [N_FRAMES]):
        with pytest.raises(IndexError):
            gather_normalize(store, torch.tensor(bad, device=cuda))


# ---------------------------------------------------------------------------
# K3 and K4
# ---------------------------------------------------------------------------

def knn_against_plain(q, refs, k: int) -> None:
    """K3's distances within 1e-4 relative of its plain version's, and
    its indices equal but at near ties within that tolerance."""
    from srl_zoo_tpu_torch.ops.knn_topk import (knn_topk_plain,
                                                knn_topk_with_dist)
    kd, ki = knn_topk_with_dist(q, refs, k)
    pd, pi = knn_topk_plain(q, refs, k)
    rel = float(((kd - pd).abs() / pd.abs().clamp_min(1e-30)).max())
    assert rel <= 1e-4, rel
    near_ties(q, refs, ki, pi, 1e-4)


# (Q, N, D, k): Q 1 and 130; N = k and 1,111; D 1, 5, 37 and 200 (and 600,
# past the resident query tile); k 1, 6, 33 and 64; then the main shape
KNN_SHAPES = ((1, 1111, 37, 6), (130, 1111, 1, 1), (130, 1111, 5, 33),
              (130, 64, 37, 64), (130, 6, 200, 6), (1, 1111, 200, 64),
              (130, 1111, 200, 33), (130, 33, 5, 33), (130, 1, 37, 1),
              (130, 1111, 600, 6), (KNN_QUERIES, N_FRAMES, STATE_DIM, K))


@pytest.mark.parametrize("nq,n,d,k", KNN_SHAPES)
def test_knn_against_plain(cuda, gen, nq, n, d, k):
    """K3 at KNN-MSE's shape (Q 4,096, N 20,000, D 200, k 6) and at ten
    ragged shapes against its plain version."""
    knn_against_plain(torch.randn((nq, d), generator=gen, device=cuda),
                      torch.randn((n, d), generator=gen, device=cuda), k)


def test_knn_queries_that_are_references_find_themselves_first(cuda, gen):
    """Queries that are references (as KNN-MSE's are) find themselves
    first at a distance of exactly 0: the norms are summed in the dot
    products' order, so a near-duplicate cannot win by rounding."""
    from srl_zoo_tpu_torch.ops.knn_topk import knn_topk_with_dist
    refs = torch.randn((N_FRAMES, STATE_DIM), generator=gen, device=cuda)
    kd, ki = knn_topk_with_dist(refs[:KNN_QUERIES], refs, K)
    assert bool((kd[:, 0] == 0).all())
    assert torch.equal(ki[:, 0], torch.arange(KNN_QUERIES, device=cuda))


def within_norm_tol(got, want, x, y, rtol: float = 1e-5) -> None:
    """|got - want| / (|x_i|^2 + |y_j|^2) <= ``rtol`` (the formula
    cancels for near points, so the distance itself is no scale)."""
    x, y = x.double(), y.double()
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
    err = float(((got.double() - want.double()).abs() / scale).max())
    assert err <= rtol, err


def test_pairwise_against_plain_and_float64(cuda, gen):
    """K4 at KNN-MSE's shape against its plain version and, on a
    512 x 512 corner, float64; then at four ragged shapes (1 x 1,
    M % 4 != 0, D not a multiple of 16)."""
    from srl_zoo_tpu_torch.ops.pairwise import (pairwise_sqdist,
                                                pairwise_sqdist_plain)
    x = torch.randn((KNN_QUERIES, STATE_DIM), generator=gen, device=cuda)
    y = torch.randn((N_FRAMES, STATE_DIM), generator=gen, device=cuda)
    out = pairwise_sqdist(x, y)
    within_norm_tol(out, pairwise_sqdist_plain(x, y), x, y)
    xc, yc = x[:512].double(), y[:512].double()
    within_norm_tol(out[:512, :512],
                    ((xc[:, None, :] - yc[None, :, :]) ** 2).sum(-1), xc, yc)
    for n, m, d in ((1, 1, 1), (129, 131, 5), (130, 257, 37),
                    (300, 1111, 200)):
        ex = torch.randn((n, d), generator=gen, device=cuda)
        ey = torch.randn((m, d), generator=gen, device=cuda)
        within_norm_tol(pairwise_sqdist(ex, ey),
                        pairwise_sqdist_plain(ex, ey), ex, ey)


def test_full_route_against_the_fused_route(cuda, gen):
    """The ``full`` route's top-6 (K4 and a stable sort) equals K3's but
    at near ties."""
    from srl_zoo_tpu_torch.ops.knn_topk import knn_topk_with_dist
    x = torch.randn((KNN_QUERIES, STATE_DIM), generator=gen, device=cuda)
    y = torch.randn((N_FRAMES, STATE_DIM), generator=gen, device=cuda)
    _, fi = knn_topk_with_dist(x, y, K, impl="full")
    _, ki = knn_topk_with_dist(x, y, K)
    near_ties(x, y, fi, ki, 1e-4)


def test_knn_over_reference_blocks_merged(cuda, gen):
    """K3 over 4 contiguous blocks of the 20,000 references, each
    block's candidates offset and merged by ``merge_topk`` (the merge of
    ``knn_topk_sharded``), against K3 over the whole set: distances
    within 1e-5 relative, indices equal but at near ties; 4 K3
    launches."""
    from srl_zoo_tpu_torch.ops.knn_topk import (knn_topk_with_dist,
                                                merge_topk, reference_block)
    q = torch.randn((KNN_QUERIES, STATE_DIM), generator=gen, device=cuda)
    refs = torch.randn((N_FRAMES, STATE_DIM), generator=gen, device=cuda)
    with launches() as ran:
        parts = []
        for b in range(4):
            block, start = reference_block(refs, 4, b)
            bd, bi = knn_topk_with_dist(q, block, K)
            parts.append((bd, bi + start))
        md, mi = merge_topk(parts, K)
    assert ran["knn_topk"] == 4
    wd, wi = knn_topk_with_dist(q, refs, K)
    assert float(((md - wd).abs() / wd.abs().clamp_min(1e-30)).max()) <= 1e-5
    near_ties(q, refs, mi, wi, 1e-5)


# ---------------------------------------------------------------------------
# the measured alternatives against the port's formulations
# ---------------------------------------------------------------------------

def close_rel_max(got, want, rtol: float, floor: float = 0.0) -> None:
    """|got - want| <= rtol * max(max |want|, floor)."""
    err = float((got.double() - want.double()).abs().max())
    scale = max(float(want.double().abs().max()), floor, 1e-30)
    assert err <= rtol * scale, (err, scale)


def test_subpixel_decoder_against_conv_transpose(cuda, gen):
    """Config 1's CNNDecoder (state 200 -> 224x224x3) with each
    deconvolution from one state dict, eval mode, f32, batch 32: the
    reconstructions and every weight gradient within 1e-4 of scale (a
    bias in front of a BatchNorm has a gradient of 0: there 1e-2 of the
    largest gradient)."""
    from srl_zoo_tpu_torch.models.decoders import CNNDecoder
    torch.manual_seed(SEED)
    state = CNNDecoder(STATE_DIM, *IMG).state_dict()
    z = torch.randn((TRAIN_BATCH, STATE_DIM), generator=gen, device=cuda)
    cot = torch.randn((TRAIN_BATCH, IMG[2], IMG[0], IMG[1]), generator=gen,
                      device=cuda).contiguous(
        memory_format=torch.channels_last)
    got = {}
    for deconv in ("conv_transpose", "subpixel"):
        dec = CNNDecoder(STATE_DIM, *IMG, deconv=deconv)
        dec.load_state_dict(state)
        dec = dec.to(cuda, memory_format=torch.channels_last).eval()
        y = dec(z)
        y.backward(cot)
        got[deconv] = (y.detach(), {n: p.grad for n, p
                                    in dec.named_parameters()})
    (y0, g0), (y1, g1) = got["conv_transpose"], got["subpixel"]
    close_rel_max(y1, y0, 1e-4)
    floor = 1e-2 * max(float(v.abs().max()) for v in g0.values())
    for n in g0:
        close_rel_max(g1[n], g0[n], 1e-4, floor)


def max_pool2d_nhwc(x):
    """The SAME 3x3/2 pool of NHWC ``x`` by ``F.max_pool2d`` on the input
    padded with -inf, NHWC out."""
    import torch.nn.functional as F
    from srl_zoo_tpu_torch.ops.fused_pool import same_pads
    (pt, pb), (pl, pr) = (same_pads(x.shape[1], 3, 2),
                          same_pads(x.shape[2], 3, 2))
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb), value=float("-inf"))
    return F.max_pool2d(xp, 3, stride=2).permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("batch", [TRAIN_BATCH, EXPORT_BATCH])
def test_pool_formulations_agree_bit_for_bit(cuda, gen, batch, dtype):
    """The 3x3/2 SAME pool of relu'd input at config 1's first pool by
    K1f/K1b, ``F.max_pool2d`` on the -inf-padded input,
    ``max_pool_tree`` and ``max_pool_argmax``: y equal across the four;
    on integer values from 1 (ties in most windows, every maximum above
    0) the input gradients of K1b and ``max_pool_argmax`` equal."""
    from srl_zoo_tpu_torch.ops.fused_pool import relu_max_pool
    from srl_zoo_tpu_torch.ops.pooling import max_pool_argmax, max_pool_tree
    shape = (batch, POOLS[0], POOLS[0], 64)
    x = torch.relu(torch.randn(shape, generator=gen, device=cuda)).to(dtype)
    with torch.no_grad():
        y = relu_max_pool(x)
        for form in (max_pool2d_nhwc, max_pool_tree, max_pool_argmax):
            assert torch.equal(form(x), y), form.__name__
    xi = torch.randint(1, 5, shape, generator=gen, device=cuda).to(dtype)
    gy = torch.randint(-3, 4, y.shape, generator=gen, device=cuda).to(dtype)
    dx = []
    for form in (relu_max_pool, max_pool_argmax):
        xg = xi.clone().requires_grad_()
        dx.append(torch.autograd.grad(form(xg), xg, gy)[0])
    assert torch.equal(*dx)


def rel_l2(got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("channels", [3, 6])
def test_s2d_stem_against_the_direct_stem(cuda, gen, channels):
    """Config 5's ResNet-18 encoder (224 px, state 200) with each stem
    from one state dict, train mode. At batch 8 in f32 the s2d encoder's
    output, whole gradient and stem gradient (conv1, bn1) deviate from
    the direct encoder in float64 on the CPU by at most twice the larger
    of the direct f32 encoder's deviations on the card and on the CPU
    (+1e-5); in bf16 both encoders' values are finite. The stem
    convolution alone (output and weight gradient, batch 32) is within
    1e-5 of scale of the direct one in f32 and 2^-7 in bf16."""
    from srl_zoo_tpu_torch.models.precision import compute_dtype, conv
    from srl_zoo_tpu_torch.models.resnet import ResNet18, s2d_stem
    b, bc = TRAIN_BATCH, 8
    torch.manual_seed(SEED + channels)
    state = ResNet18(STATE_DIM, channels).state_dict()
    x = torch.rand((b, IMG[0], IMG[1], channels), generator=gen,
                   device=cuda) * 2 - 1
    cot = torch.randn((b, STATE_DIM), generator=gen, device=cuda)

    def model(dtype=None, stem="direct"):
        m = ResNet18(STATE_DIM, channels, dtype=dtype, stem=stem)
        m.load_state_dict(state)
        return m.train()

    ref = model().double()
    y64 = ref(x[:bc].double().cpu())
    y64.backward(cot[:bc].double().cpu())
    g64 = {n: p.grad for n, p in ref.named_parameters()}
    stem_keys = [n for n in g64 if n.startswith(("conv1.", "bn1."))]

    def flat(grads, keys):
        return torch.cat([grads[k].double().cpu().ravel() for k in keys])

    def deviation(m, xb, cotb) -> dict:
        y = m(xb)
        y.backward(cotb)
        grads = {n: p.grad for n, p in m.named_parameters()}
        assert bool(torch.isfinite(y).all()) and all(
            bool(torch.isfinite(v).all()) for v in grads.values())
        return {"output": rel_l2(y, y64),
                "gradient": rel_l2(flat(grads, g64), flat(g64, g64)),
                "stem": rel_l2(flat(grads, stem_keys), flat(g64, stem_keys))}

    cpu_dev = deviation(model(), x[:bc].cpu(), cot[:bc].cpu())
    for dtype in ("float32", "bfloat16"):
        dt = compute_dtype(dtype)
        models, dev_of = {}, {}
        for stem in ("direct", "s2d"):
            models[stem] = model(dt, stem).to(
                cuda, memory_format=torch.channels_last)
            dev_of[stem] = deviation(models[stem], x[:bc], cot[:bc])
        if dtype == "float32":
            over = [k for k, v in dev_of["s2d"].items() if v > 2 * max(
                dev_of["direct"][k], cpu_dev[k]) + 1e-5]
            assert not over, (dev_of, cpu_dev)
        conv1 = models["direct"].conv1
        gy = torch.randn((b, 64, IMG[0] // 2, IMG[1] // 2), generator=gen,
                         device=cuda).to(dt or F32).contiguous(
            memory_format=torch.channels_last)
        outs = []
        for stem in (lambda: conv(conv1, x.permute(0, 3, 1, 2), dt),
                     lambda: s2d_stem(conv1, x, dt)):
            conv1.weight.grad = None
            y = stem()
            y.backward(gy)
            outs.append((y.detach(), conv1.weight.grad.clone()))
        rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
        close_rel_max(outs[1][0], outs[0][0], rtol)
        close_rel_max(outs[1][1], outs[0][1], rtol)


def test_blocked_route_against_the_full_route(cuda, gen):
    """The blocked neighbour route at KNN-MSE's shape: its distances
    within 1e-4 relative of the ``full`` route's, its indices equal but
    at near ties."""
    from srl_zoo_tpu_torch.ops.knn_topk import knn_topk_with_dist
    q = torch.randn((KNN_QUERIES, STATE_DIM), generator=gen, device=cuda)
    refs = torch.randn((N_FRAMES, STATE_DIM), generator=gen, device=cuda)
    bd, bi = knn_topk_with_dist(q, refs, K, impl="blocked")
    fd, fi = knn_topk_with_dist(q, refs, K, impl="full")
    assert float(((bd - fd).abs() / fd.abs().clamp_min(1e-30)).max()) <= 1e-4
    near_ties(q, refs, bi, fi, 1e-4)
