"""The measured alternatives of the PyTorch port (ROADMAP.md A10) against
the JAX package, on the CPU at 16-64 px: the pools of ``ops/pooling.py``,
the decoder's sub-pixel deconvolution (``ops/subpixel.py``,
``CNNDecoder(deconv="subpixel")``), the ResNet's space-to-depth stem
(``ResNet18(stem="s2d")``) and the blocked neighbour route
(``knn_topk(impl="blocked")``, also under ``knn_topk_sharded``).

Inputs come from numpy with a seed; weights from the JAX package's own
init, bridged into the port. Tolerances, each with its reason:

* Pools: bit for bit, forward and gradient. Both packages take the same
  maxima and add the same gradient planes in the same order.
* Sub-pixel deconvolution: 1e-5 of the output's largest magnitude (the
  same products, summed by another convolution); the decoder's parameter
  gradients 1e-4 of each tensor's largest (backward sums compound the
  forward's rounding). In bfloat16 the deviation from float64 is held to
  at most twice JAX's, as tests/test_torch_zoo_bf16.py holds the zoo.
* s2d stem: the port's s2d against its direct stem in float64 within
  1e-12 of scale (the same sums, regrouped); against JAX's s2d in float32
  within 1e-4, as test_torch_zoo_resnet.py holds one encoder call, and
  config 5's train step in float64, as test_torch_zoo_train.py holds it.
* Blocked route: indices equal to JAX's ``_topk_blocked``, distances
  within 1e-5 relative; with exact ties, equal to the lowest-column order.
"""

from __future__ import annotations

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_zoo_tpu.ops import pooling as jax_pooling
from srl_zoo_tpu_torch import bridge
from srl_zoo_tpu_torch.models.decoders import CNNDecoder
from srl_zoo_tpu_torch.models.resnet import ResNet18
from srl_zoo_tpu_torch.ops.knn_topk import knn_topk_with_dist
from srl_zoo_tpu_torch.ops.pooling import (max_pool_argmax, max_pool_tree,
                                           same_pads)
from test_torch_zoo_bf16 import _rel_l2
from test_torch_zoo_dist import _spawn
from test_torch_zoo_resnet import PX, STATE_DIM, _jax_resnet, _port_resnet
from test_torch_zoo_train import (_check_grads, _close_rel_max,  # noqa: F401
                                  _jax_grads, _port_grads, _step_setup,
                                  two_pass_bn_variance)

# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------

POOL_CASES = [((2, 23, 23, 8), "SAME"), ((2, 24, 24, 8), "SAME"),
              ((1, 33, 17, 3), "SAME"), ((2, 16, 16, 8), ((1, 1), (1, 1)))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,padding", POOL_CASES)
def test_max_pool_tree_equals_jax_and_flax(shape, padding, dtype):
    """Forward bit for bit against JAX's max_pool_tree and flax's
    nn.max_pool (at 23, 24 and 33 px and the ResNet stem's pads), and the
    float32 gradient against JAX's through its maxima."""
    rng = np.random.RandomState(3)
    x = rng.randn(*shape).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x, jdt)
    pads = padding if padding == "SAME" else tuple(map(tuple, padding))
    want = np.asarray(jax_pooling.max_pool_tree(xj, padding=pads),
                      np.float32)
    flax_y = np.asarray(nn.max_pool(xj, (3, 3), strides=(2, 2),
                                    padding=pads), np.float32)
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    y = max_pool_tree(xt, padding=padding)
    assert y.dtype == dtype
    np.testing.assert_array_equal(y.detach().float().numpy(), want)
    np.testing.assert_array_equal(want, flax_y)
    if dtype == torch.float32:
        g = rng.randn(*want.shape).astype(np.float32)
        _, vjp = jax.vjp(lambda v: jax_pooling.max_pool_tree(
            v, padding=pads), xj)
        y.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(xt.grad.numpy(),
                                      np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("values", ["random", "integer"])
@pytest.mark.parametrize("shape", [(2, 23, 23, 8), (2, 24, 24, 8),
                                   (1, 33, 17, 3)])
def test_max_pool_argmax_equals_jax(shape, values):
    """Forward bit for bit, and the input gradient equal to JAX's
    max_pool_argmax VJP on the same cotangent; integer-valued inputs tie
    often, so the first-maximum routing shows."""
    rng = np.random.RandomState(4)
    x = (rng.randn(*shape) if values == "random"
         else rng.randint(-2, 3, shape)).astype(np.float32)
    want, vjp = jax.vjp(jax_pooling.max_pool_argmax, jnp.asarray(x))
    g = rng.randint(-3, 4, want.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = max_pool_argmax(xt)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(y.detach().numpy(),
                                  max_pool_tree(torch.from_numpy(x)).numpy())
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))


def test_same_pads_equal_jax():
    for size in range(1, 40):
        for k, s in ((3, 2), (7, 2), (3, 1)):
            assert same_pads(size, k, s) == jax_pooling._same_pads(
                size, k, s)[1]


# ---------------------------------------------------------------------------
# sub-pixel deconvolution
# ---------------------------------------------------------------------------

def _jax_subpixel_layer(cin: int, cout: int, seed: int):
    from srl_zoo_tpu.ops.subpixel import SubpixelConvTranspose
    layer = SubpixelConvTranspose(cout)
    params = layer.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 4, 4, cin)))["params"]
    rng = np.random.RandomState(seed)
    return layer, {k: np.asarray(v) + 0.1 * rng.randn(*v.shape).astype(
        np.float32) for k, v in params.items()}


@pytest.mark.parametrize("cin,cout,h,w", [(6, 4, 5, 7), (64, 3, 7, 7),
                                          (16, 32, 1, 2)])
def test_subpixel_deconv_equals_jax_and_conv_transpose(cin, cout, h, w):
    """``subpixel_deconv`` on a ConvTranspose2d holding JAX's
    SubpixelConvTranspose parameters (through the bridge's flip) against
    that module and against the layer's own transposed convolution."""
    from srl_zoo_tpu_torch.models.decoders import deconv_weight_from_flax
    from srl_zoo_tpu_torch.ops.subpixel import subpixel_deconv
    jlayer, params = _jax_subpixel_layer(cin, cout, seed=cin + cout)
    x = np.random.RandomState(5).randn(2, h, w, cin).astype(np.float32)
    want = np.asarray(jlayer.apply({"params": params}, jnp.asarray(x)))
    layer = torch.nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)
    with torch.no_grad():
        layer.weight.copy_(deconv_weight_from_flax(
            torch.from_numpy(params["kernel"])))
        layer.bias.copy_(torch.from_numpy(params["bias"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = subpixel_deconv(layer, xt).permute(0, 2, 3, 1).numpy()
        transposed = layer(xt).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 2 * h, 2 * w, cout)
    _close_rel_max(got, want, 1e-5)
    _close_rel_max(transposed, want, 1e-5)


def _jax_decoder(px: int, dtype, seed: int = 1):
    """JAX's CNNDecoder (sub-pixel) with its init and perturbed BatchNorm
    statistics, and the port's state dict of both."""
    from srl_zoo_tpu.models.decoders import CNNDecoder as JaxDecoder
    model = JaxDecoder(img_height=px, img_width=px, dtype=dtype,
                       deconv="subpixel")
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((2, 6)),
                                             train=True))(
        jax.random.PRNGKey(seed))
    # running statistics made non-trivial (means 0 +- 0.15, variances 1
    # +- 0.15), mildly enough that eval-mode ReLUs stay alive
    rng = np.random.RandomState(seed + 100)
    stats = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.uniform(-0.15, 0.15, v.shape)).astype(
            np.float32), jax.device_get(variables["batch_stats"]))
    params = jax.device_get(variables["params"])
    sd, skipped = bridge.state_dict_from_jax({"decoder": params},
                                             {"decoder": stats})
    assert skipped == []
    return model, params, stats, {k[len("decoder."):]: v
                                  for k, v in sd.items()}


def _port_decoder(sd, px: int, deconv: str, dtype=None) -> CNNDecoder:
    dec = CNNDecoder(6, px, px, deconv=deconv, dtype=dtype)
    dec.load_state_dict(sd)
    return dec


@pytest.mark.parametrize("train", [True, False])
def test_subpixel_decoder_equals_jax_and_conv_transpose(train,
                                                        two_pass_bn_variance):
    """CNNDecoder(deconv="subpixel") at 64 px against JAX's sub-pixel
    decoder and the port's conv_transpose decoder, both from the same
    bridged weights: output 1e-5, input and parameter gradients 1e-4 of
    scale, float32."""
    jmodel, params, stats, sd = _jax_decoder(64, jnp.float32)
    rng = np.random.RandomState(14)
    z = rng.randn(5, 6).astype(np.float32)
    cot = rng.randn(5, 64, 64, 3).astype(np.float32)

    def f(p, z):
        out = jmodel.apply({"params": p, "batch_stats": stats}, z,
                           train=train, mutable=["batch_stats"])[0]
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, want), (gp, gz) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, z)
    assert np.abs(want).max() > 0.05  # the ReLUs pass something
    want_grads, _ = bridge.state_dict_from_jax({"decoder": jax.device_get(
        gp)}, {"decoder": stats})
    outs = {}
    for deconv in ("subpixel", "conv_transpose"):
        dec = _port_decoder(sd, 64, deconv).train(train)
        zt = torch.from_numpy(z).requires_grad_()
        out = dec(zt).permute(0, 2, 3, 1)
        assert dec(zt).is_contiguous(memory_format=torch.channels_last)
        _close_rel_max(out.detach().numpy(), want, 1e-5)
        (out * torch.from_numpy(cot)).sum().backward()
        _close_rel_max(zt.grad.numpy(), gz, 1e-4)
        _check_grads(dec, want_grads, "decoder.")
        outs[deconv] = out.detach().numpy()
    _close_rel_max(outs["subpixel"], outs["conv_transpose"], 1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_subpixel_decoder_in_bf16_matches_jax(train, two_pass_bn_variance):
    """In bfloat16 (the last layer in float32) the sub-pixel decoder's
    float32 output strays from the float32 decoder run in float64 by at
    most twice JAX's sub-pixel bf16 decoder's deviation."""
    jmodel, params, stats, sd = _jax_decoder(32, jnp.bfloat16)
    z = np.random.RandomState(15).randn(5, 6).astype(np.float32)
    want, _ = jmodel.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(z), train=train,
                           mutable=["batch_stats"])
    assert want.dtype == jnp.float32 and np.abs(want).max() > 0.05
    with torch.no_grad():
        got = _port_decoder(sd, 32, "subpixel", torch.bfloat16).train(
            train)(torch.from_numpy(z)).permute(0, 2, 3, 1)
        f64 = _port_decoder(sd, 32, "subpixel").train(train).double()(
            torch.from_numpy(z).double()).permute(0, 2, 3, 1).numpy()
    assert got.dtype == torch.float32
    port_dev, jax_dev = _rel_l2(got.numpy(), f64), _rel_l2(np.asarray(want),
                                                           f64)
    print(f"subpixel bf16 train={train}: deviation from float64 (relative "
          f"L2): port {port_dev:.3g}, JAX {jax_dev:.3g}")
    assert port_dev <= 2 * jax_dev, (port_dev, jax_dev)


def test_one_state_dict_serves_both_deconvs():
    """A conv_transpose decoder's state dict loads into a sub-pixel one
    (the same keys and shapes) and gives the same reconstruction; an
    unknown formulation raises."""
    torch.manual_seed(0)
    a = CNNDecoder(6, 32, 32).eval()
    b = CNNDecoder(6, 32, 32, deconv="subpixel").eval()
    b.load_state_dict(a.state_dict())
    assert a.state_dict().keys() == b.state_dict().keys()
    z = torch.randn(3, 6)
    with torch.no_grad():
        _close_rel_max(b(z).numpy(), a(z).numpy(), 1e-5)
    with pytest.raises(ValueError, match="deconv must be one of"):
        CNNDecoder(6, 32, 32, deconv="pixel_shuffle")


# ---------------------------------------------------------------------------
# the s2d stem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels,px", [(3, 32), (6, 32), (3, 33)])
def test_s2d_stem_equals_the_direct_stem(channels, px):
    """In float64, the port's s2d ResNet against its direct one with the
    same weights, at 3 and 6 channels and at an odd side (the direct
    fallback): output and every gradient within 1e-12 of scale, and the
    stem convolutions alone at a bf16 compute dtype equal bit for bit
    once the product is rounded."""
    from srl_zoo_tpu_torch.models.resnet import s2d_stem
    torch.manual_seed(channels + px)
    direct = ResNet18(STATE_DIM, channels).double()
    s2d = ResNet18(STATE_DIM, channels, stem="s2d").double()
    s2d.load_state_dict(direct.state_dict())
    x = torch.from_numpy(np.random.RandomState(6).uniform(
        -1, 1, (4, px, px, channels)))
    outs = []
    for model in (direct, s2d):
        xt = x.clone().requires_grad_()
        out = model(xt)
        out.square().sum().backward()
        outs.append((out.detach().numpy(), xt.grad.numpy(),
                     {n: p.grad.numpy() for n, p in model.named_parameters()}))
    (y0, gx0, gp0), (y1, gx1, gp1) = outs
    _close_rel_max(y1, y0, 1e-12)
    _close_rel_max(gx1, gx0, 1e-12)
    for n in gp0:
        _close_rel_max(gp1[n], gp0[n], 1e-12)
    if px % 2 == 0:
        x32 = x.float()
        conv1 = ResNet18(STATE_DIM, channels).conv1
        with torch.no_grad():
            a = s2d_stem(conv1, x32)
            b = conv1(x32.permute(0, 3, 1, 2))
        assert a.is_contiguous(memory_format=torch.channels_last)
        _close_rel_max(a.numpy(), b.numpy(), 1e-5)


@pytest.mark.parametrize("channels,px", [(6, 32), (3, 33)])
def test_s2d_resnet_matches_jax(channels, px, two_pass_bn_variance):
    """ResNet18(stem="s2d") against JAX's ResNet18(stem="s2d") on the same
    bridged weights in train mode, at 6 channels and at an odd side (the
    direct fallback in both): output, input gradient and every parameter
    gradient within 1e-4 of scale, float32.
    test_torch_zoo_resnet.py::test_resnet18_matches_jax[s2d-*] holds 3
    channels at 32 px in both modes."""
    train = True
    jmodel, params, stats = _jax_resnet("s2d", channels, seed=channels)
    model = _port_resnet(params, stats, channels, stem="s2d").train(train)
    rng = np.random.RandomState(22)
    x = rng.uniform(-1, 1, (8, px, px, channels)).astype(np.float32)
    cot = rng.randn(8, STATE_DIM).astype(np.float32)

    def f(p, x):
        out = jmodel.apply({"params": p, "batch_stats": stats}, x,
                           train=train, mutable=["batch_stats"])[0]
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, x)
    assert np.abs(want).max() > 0.05
    xt = torch.from_numpy(x).requires_grad_()
    out = model(xt)
    _close_rel_max(out.detach().numpy(), want, 1e-4)
    (out * torch.from_numpy(cot)).sum().backward()
    _close_rel_max(xt.grad.numpy(), gx, 1e-4)
    want_sd, _ = bridge.state_dict_from_jax({"encoder": jax.device_get(gp)},
                                            {"encoder": stats})
    _check_grads(model, want_sd, "encoder.")


def test_config5_step_with_the_s2d_stem_matches_jax(monkeypatch,
                                                    two_pass_bn_variance):
    """Config 5 (triplet, ResNet-18, two views) with the port's encoder on
    the s2d stem, JAX's on its default s2d: one train step in float64
    (ROADMAP §C: float32 routes near-zero ReLUs apart), loss 1e-5
    relative, gradients 1e-4 of scale, as test_train_step_matches_jax
    holds the direct stem."""
    from srl_zoo_tpu_torch.models import encoders
    monkeypatch.setattr(encoders, "ResNet18",
                        functools.partial(ResNet18, stem="s2d"))
    frames, jcfg, jmodel, state, _, batches = _step_setup("triplet")
    want_loss, want_sd = _jax_grads(frames, jcfg, jmodel, state, batches[0],
                                    float64=True)
    loss, model = _port_grads(jcfg, state, frames, batches[0],
                              torch.float64)
    assert model.encoder.stem == "s2d"
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _check_grads(model, want_sd)


def test_make_encoder_keeps_the_direct_stem():
    from srl_zoo_tpu_torch.models.encoders import make_encoder
    assert make_encoder("resnet", STATE_DIM, 3, PX, PX).stem == "direct"
    with pytest.raises(ValueError, match="stem must be one of"):
        ResNet18(STATE_DIM, stem="space_to_depth")


# ---------------------------------------------------------------------------
# the blocked neighbour route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(5000, 6), (2048, 6), (1111, 1),
                                 (4100, 64), (2049, 6)])
def test_blocked_route_equals_jax(n, k):
    """Indices equal to JAX's ``_topk_blocked``, distances within 1e-5
    relative, at N below, at and past one tile of 2048, k 1, 6 and 64; and
    the indices equal to the ``full`` route's."""
    from srl_zoo_tpu.ops.knn_topk import _topk_blocked
    rng = np.random.RandomState(n + k)
    q = rng.randn(40, 7).astype(np.float32)
    refs = rng.randn(n, 7).astype(np.float32)
    jd, ji = map(np.asarray, _topk_blocked(jnp.asarray(q),
                                           jnp.asarray(refs), k))
    d, i = knn_topk_with_dist(torch.from_numpy(q), torch.from_numpy(refs), k,
                              impl="blocked")
    assert d.dtype == torch.float32 and i.dtype == torch.int64
    assert d.shape == i.shape == (40, k)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-5, atol=1e-30)
    _, fi = knn_topk_with_dist(torch.from_numpy(q), torch.from_numpy(refs), k,
                               impl="full")
    np.testing.assert_array_equal(i.numpy(), fi.numpy())


@pytest.mark.parametrize("k", [1, 6, 64])
def test_blocked_route_gives_ties_to_the_lowest_column(k):
    """Integer-valued points over 3 tiles tie exactly and often: the
    indices equal JAX's, and each row's k columns are the first k of a
    stable sort of the exact (float64) distances."""
    from srl_zoo_tpu.ops.knn_topk import _topk_blocked
    rng = np.random.RandomState(k)
    q = rng.randint(0, 3, (30, 4)).astype(np.float32)
    refs = rng.randint(0, 3, (5000, 4)).astype(np.float32)
    exact = ((q[:, None, :].astype(np.float64) - refs[None]) ** 2).sum(-1)
    want = np.argsort(exact, axis=1, kind="stable")[:, :k]
    ji = np.asarray(_topk_blocked(jnp.asarray(q), jnp.asarray(refs), k)[1])
    d, i = knn_topk_with_dist(torch.from_numpy(q), torch.from_numpy(refs), k,
                              impl="blocked")
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(d.numpy(), np.take_along_axis(
        exact, want, 1))


def test_knn_topk_sharded_takes_the_blocked_route(tmp_path):
    """4,503 references over two gloo ranks, each running the blocked
    route on its block (over two tiles, the last block padded): the merged
    top-6 equals the unsharded blocked call's, indices exactly, distances
    within 1e-5 relative."""
    from srl_zoo_tpu_torch.ops.knn_topk import knn_topk_sharded
    rng = np.random.RandomState(11)
    q = torch.from_numpy(rng.randn(50, 7).astype(np.float32))
    refs = torch.from_numpy(rng.randn(4503, 7).astype(np.float32))
    # the ranks run the port's function itself (args: q, refs, k, impl)
    ranks = _spawn(knn_topk_sharded, tmp_path / "ranks", q, refs, 6,
                   "blocked")
    want_d, want_i = knn_topk_with_dist(q, refs, 6, impl="blocked")
    for d, i in ranks:
        np.testing.assert_array_equal(i.numpy(), want_i.numpy())
        np.testing.assert_allclose(d.numpy(), want_d.numpy(), rtol=1e-5)
