"""The port's training slice (config 1: autoencoder, CustomCNN + CNNDecoder,
Adam) against the JAX package, on the CPU at 32 px.

Inputs come from numpy with a seed, or from the shared 32 px
``synthetic_dataset``; weights come from the JAX package's own init,
bridged into the port. Tolerances, each with its reason:

* K1 backward: exact. Integer inputs and integer cotangents make every
  gradient sum exact, so any routing difference shows.
* BatchNorm: 1e-5. One f32 reduction in another order.
* CNNDecoder and one train step: outputs within 1e-5 of their largest
  magnitude, the loss within 1e-5 relative, each
  gradient within 1e-4 of its tensor's largest magnitude (f32 convolutions
  sum in another order, and backward sums compound that).
* Three Adam steps: Adam scales every update to about lr (its first step
  is lr times the gradient's sign), so an element whose gradient sits at
  rounding level may move by up to lr per step in either direction, and
  the forward of the next steps carries that on. Every parameter stays
  within 3 lr; the median within 1e-5 and 95% of them within 1e-4
  (lr/50).
* Two epochs of the learner: epoch totals within 2e-2 relative (ten Adam
  steps carry those rounding-level moves on; the loss falls fourfold over
  the two epochs), and the same best epoch.
"""

import contextlib
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_zoo_tpu.config import SRLConfig as JaxConfig
from srl_zoo_tpu.ops import fused_pool as jax_pool
from srl_zoo_tpu_torch import bridge
from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.ops.fused_pool import (relu_max_pool,
                                              relu_max_pool_bwd,
                                              relu_max_pool_bwd_plain,
                                              relu_max_pool_plain)


@contextlib.contextmanager
def _one_torch_thread():
    """One intra-op thread for a training run: pytest-xdist runs the suite
    in several worker processes at once, and a thread per core in each of
    them oversubscribes the cores (the learner and CLI tests ran about
    five times slower with six workers). The step tests keep torch's
    default: their gradients are held to JAX's at rounding level, and the
    thread count sets torch's order of summation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)

STATE_DIM = 4
BS = 16


def _np_pads(padding):
    return padding if padding == "SAME" else tuple(map(tuple, padding))


def _close_rel_max(got, want, rtol, floor=0.0):
    """|got - want| <= rtol * max(max|want|, floor) everywhere."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), floor, 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _check_grads(model, want_sd, prefix=""):
    """Each parameter's gradient within 1e-4 of its tensor's largest
    magnitude. A bias in front of a train-mode BatchNorm has an exact
    gradient of 0 (the normalization removes it), so its tensor holds only
    rounding: there the scale is 1e-2 of the model's largest gradient."""
    grads = {f"{prefix}{n}": p.grad.numpy()
             for n, p in model.named_parameters()}
    floor = 1e-2 * max(float(np.abs(want_sd[n].numpy()).max()) for n in grads)
    for name, g in grads.items():
        _close_rel_max(g, want_sd[name].numpy(), 1e-4, floor)


# ---------------------------------------------------------------------------
# (a) K1 backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,padding", [
    ((2, 16, 16, 8), "SAME"),
    ((2, 16, 16, 8), ((1, 1), (1, 1))),
    ((2, 7, 7, 8), "SAME"),
    ((3, 15, 9, 4), "SAME"),
    # the kernels' scalar path and tile edges: C in {3, 12, 66}, B = 1,
    # 9 x 13 and 1 x 1 images, pads of 0, 2 and 1 per side
    ((1, 9, 13, 3), ((0, 0), (0, 0))),
    ((1, 9, 13, 12), ((2, 0), (0, 2))),
    ((1, 9, 13, 66), ((1, 1), (1, 1))),
    ((1, 1, 1, 12), ((1, 1), (1, 1))),
    ((1, 1, 1, 66), ((2, 0), (0, 2))),
])
def test_relu_max_pool_gradient_equals_xla_exactly(shape, padding):
    rng = np.random.RandomState(11)
    x = rng.randint(-2, 3, shape).astype(np.float32)
    y_ref = jax_pool.relu_max_pool_reference(jnp.asarray(x), padding)
    g = rng.randint(-8, 9, y_ref.shape).astype(np.float32)
    dx_ref = np.asarray(jax.grad(lambda v: jnp.vdot(
        jax_pool.relu_max_pool_reference(v, padding), jnp.asarray(g)))(
        jnp.asarray(x)))

    pads = _np_pads(padding)
    xt = torch.from_numpy(x).requires_grad_()
    y = relu_max_pool(xt, pads)
    assert y.requires_grad
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), dx_ref)

    _, idx = relu_max_pool_plain(torch.from_numpy(x), pads, with_index=True)
    plain = relu_max_pool_bwd_plain(torch.from_numpy(g), idx, shape, pads)
    np.testing.assert_array_equal(plain.numpy(), dx_ref)
    np.testing.assert_array_equal(
        relu_max_pool_bwd(torch.from_numpy(g), idx, shape, pads).numpy(),
        dx_ref)


@pytest.mark.parametrize("padding", ["SAME", ((1, 1), (1, 1))])
def test_relu_max_pool_bwd_plain_matches_pallas_bf16(padding):
    """The Pallas backward (interpret mode) on bf16, a packable geometry,
    with the argmax plane of the Pallas forward."""
    rng = np.random.RandomState(12)
    shape = (2, 16, 16, 8)
    x = jnp.asarray(rng.randint(-2, 3, shape).astype(np.float32),
                    jnp.bfloat16)
    pads = jax_pool._resolve_pads(16, 16, padding)
    y, idx = jax_pool._fwd_pallas(x, pads, interpret=True)
    g = jnp.asarray(rng.randint(-8, 9, y.shape).astype(np.float32),
                    jnp.bfloat16)
    want = jax_pool._bwd_pallas(g, idx, shape, pads, interpret=True)
    gt = torch.from_numpy(np.asarray(g.astype(jnp.float32))).to(
        torch.bfloat16)
    got = relu_max_pool_bwd_plain(gt, torch.from_numpy(np.asarray(idx)),
                                  shape, _np_pads(padding))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_relu_max_pool_writes_the_plane_only_for_a_gradient():
    x = torch.randn(2, 8, 8, 4, requires_grad=True)
    with torch.no_grad():
        y = relu_max_pool(x)
    assert not y.requires_grad
    y2, idx = relu_max_pool(x, with_index=True)
    assert y2.requires_grad and idx.dtype == torch.int8
    assert not idx.requires_grad
    np.testing.assert_array_equal(y2.detach().numpy(), y.numpy())
    with pytest.raises(ValueError, match="device"):
        relu_max_pool_bwd(torch.empty(1, 4, 4, 4, device="meta"),
                          torch.empty(1, 4, 4, 4, dtype=torch.int8,
                                      device="meta"), (1, 8, 8, 4))


def test_relu_max_pool_inference_takes_no_autograd_node():
    """With no gradient to take and no index asked for, the wrapper calls
    the kernel (here its plain version) directly: y has no autograd node
    and equals the differentiable path's y; with ``requires_grad`` the
    backward still routes g through the argmax plane."""
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randint(-2, 3, (2, 9, 13, 8)).astype(np.float32))
    y = relu_max_pool(x)
    assert y.grad_fn is None and not y.requires_grad
    xg = x.clone().requires_grad_()
    with torch.no_grad():
        y_nograd = relu_max_pool(xg)
    assert y_nograd.grad_fn is None
    y_grad = relu_max_pool(xg)
    assert y_grad.grad_fn is not None
    np.testing.assert_array_equal(y_nograd.numpy(), y.numpy())
    np.testing.assert_array_equal(y_grad.detach().numpy(), y.numpy())
    g = torch.from_numpy(rng.randint(-8, 9, y.shape).astype(np.float32))
    y_grad.backward(g)
    _, idx = relu_max_pool_plain(x, with_index=True)
    np.testing.assert_array_equal(
        xg.grad.numpy(), relu_max_pool_bwd_plain(g, idx, x.shape).numpy())


# ---------------------------------------------------------------------------
# (b) BatchNorm in train mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("momentum", [0.9, 0.99])
def test_batchnorm_train_mode_matches_jax(momentum):
    from srl_zoo_tpu.models.batchnorm import BatchNorm as JaxBN
    from srl_zoo_tpu_torch.models.batchnorm import BatchNorm
    rng = np.random.RandomState(13)
    xs = [(2.0 + 3.0 * rng.randn(4, 5, 6, 8)).astype(np.float32)
          for _ in range(2)]
    jbn = JaxBN(use_running_average=False, momentum=momentum)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    bn = BatchNorm(8, momentum).train()
    for x in xs:
        want, mutated = jbn.apply(variables, jnp.asarray(x),
                                  mutable=["batch_stats"])
        variables = {"params": variables["params"], **mutated}
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=0, atol=1e-5)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# (c) CNNDecoder, from bridged weights
# ---------------------------------------------------------------------------

@pytest.fixture
def two_pass_bn_variance(monkeypatch):
    """Make the JAX BatchNorm take its batch variance in two passes, as
    torch does. flax's default one-pass E[x^2] - E[x]^2 cancels in float32:
    its train-mode gradients then stray from a float64 reference by up to
    a few percent (test_jax_one_pass_bn_variance_strays_from_the_port)."""
    from flax.linen import normalization
    one_pass = normalization._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return one_pass(*args, **kwargs)

    monkeypatch.setattr(normalization, "_compute_stats", two_pass)


def _jax_state(cfg: JaxConfig, seed: int = 0, perturb_stats: bool = False):
    """JAX model + TrainState from create_train_state; optionally BN
    statistics made non-trivial (eval mode then means something)."""
    from srl_zoo_tpu.models.srl_modules import SRLModules as JaxModules
    from srl_zoo_tpu.training.state import (create_train_state,
                                            make_optimizer)
    # jitted: the eager init takes several times longer on the CPU
    state = jax.jit(lambda k: create_train_state(cfg, k)[1])(
        jax.random.PRNGKey(seed))
    model, tx = JaxModules(cfg), make_optimizer(cfg)
    if perturb_stats:
        rng = np.random.RandomState(seed + 100)
        stats = jax.tree_util.tree_map(
            lambda v: jnp.asarray(np.asarray(v) + rng.uniform(
                0.1, 0.5, v.shape).astype(np.float32)), state.batch_stats)
        state = state.replace(batch_stats=stats)
    return model, state, tx


def _port_model(jcfg: JaxConfig, state):
    from srl_zoo_tpu_torch.models.srl_modules import SRLModules
    cfg = SRLConfig.from_exp_config(jcfg.to_exp_config())
    model = SRLModules(cfg)
    sd, skipped = bridge.state_dict_from_jax(jax.device_get(state.params),
                                             jax.device_get(state.batch_stats))
    assert skipped == []
    model.load_state_dict(sd)
    return cfg, model


@pytest.mark.parametrize("px", [32, 64])
@pytest.mark.parametrize("train", [True, False])
def test_cnn_decoder_matches_jax(px, train, two_pass_bn_variance):
    jcfg = JaxConfig(state_dim=6, img_height=px, img_width=px)
    jmodel, state, _ = _jax_state(jcfg, seed=1, perturb_stats=True)
    _, model = _port_model(jcfg, state)
    model.train(train)
    rng = np.random.RandomState(14)
    z = rng.randn(5, 6).astype(np.float32)
    cot = rng.randn(5, px, px, 3).astype(np.float32)

    def f(params, z):
        out = jmodel.apply({"params": params,
                            "batch_stats": state.batch_stats}, z,
                           train=train, mutable=["batch_stats"],
                           method=lambda m, z, train: m.decoder(
                               z, train=train))[0]
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, want), (gp, gz) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(state.params, z)
    zt = torch.from_numpy(z).requires_grad_()
    out = model.decoder(zt).permute(0, 2, 3, 1)
    _close_rel_max(out.detach().numpy(), want, 1e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    _close_rel_max(zt.grad.numpy(), gz, 1e-4)
    want_grads, _ = bridge.state_dict_from_jax(
        jax.device_get(gp), jax.device_get(state.batch_stats))
    _check_grads(model.decoder, want_grads, "decoder.")


# ---------------------------------------------------------------------------
# (d) one train step, from JAX's create_train_state weights
# ---------------------------------------------------------------------------


def _jax_batch(idx):
    return {"indices": jnp.asarray(idx, jnp.int32),
            "valid": jnp.ones(len(idx), jnp.float32),
            "actions": jnp.zeros(len(idx), jnp.int32),
            "reward_classes": jnp.zeros(len(idx), jnp.int32),
            "rewards": jnp.zeros(len(idx), jnp.float32)}


# BASELINE configs 1-5 at 32 px: (losses, split dimensions); config 4's
# splits are 100/50/25/25 of 200, cut here to 4/2/1/1 of 8. "triplet" is
# config 5 (ResNet-18, two camera views), "multiview" the 6-channel input
# of --multi-view without triplet (ResNet-18, priors).
CONFIGS = {
    "autoencoder": ((("autoencoder", 1.0),), (("autoencoder", -1),)),
    "vae": ((("vae", 1.0),), (("vae", -1),)),
    "priors": ((("priors", 1.0),), (("priors", -1),)),
    "splits": ((("autoencoder", 1.0), ("inverse", 2.0), ("forward", 1.0),
                ("reward", 1.0)),
               (("autoencoder", 4), ("inverse", 2), ("forward", 1),
                ("reward", 1))),
    "triplet": ((("triplet", 1.0),), (("triplet", -1),)),
    "multiview": ((("priors", 1.0),), (("priors", -1),)),
}
TWO_VIEWS = {"model_type": "resnet", "multi_view": True}


def _jcfg(name, **kw):
    losses, splits = CONFIGS[name]
    views = TWO_VIEWS if name in ("triplet", "multiview") else {}
    return JaxConfig(state_dim=STATE_DIM if name == "autoencoder" else 8,
                     losses=losses, split_dims=splits, img_height=32,
                     img_width=32, batch_size=BS, n_actions=4,
                     n_reward_classes=3, **views, **kw)


def _second_view(frames):
    """The second camera view of the step tests' frames: mirrored left to
    right, channels reversed."""
    return np.ascontiguousarray(frames[:, :, ::-1, ::-1])


def _np_batch(idx, actions, reward_classes, pair_rng=None):
    """A loader-style batch of rows ``idx``; with ``pair_rng`` it carries
    the priors' pairs too."""
    from srl_zoo_tpu_torch.data import samplers
    batch = {"indices": idx.astype(np.int32),
             "valid": np.ones(len(idx), np.float32),
             "actions": actions[idx], "reward_classes": reward_classes[idx],
             "rewards": np.zeros(len(idx), np.float32)}
    if pair_rng is not None:
        (batch["same_action_partners"],
         batch["same_action_mask"]) = samplers.find_same_action_pairs(
            actions[idx], pair_rng)
        (batch["dissimilar_partners"],
         batch["dissimilar_mask"]) = samplers.find_dissimilar_pairs(
            actions[idx], reward_classes[idx], pair_rng)
    return batch


@functools.lru_cache(maxsize=None)
def _step_setup(name="autoencoder"):
    """Random uint8 frames (a batch of them spreads every BatchNorm
    channel), a 32 px model of the config from JAX's init, three batches
    with random actions and reward classes. Cached per config: the JAX
    state and the arrays are only read."""
    frames = np.random.RandomState(17).randint(0, 256, (64, 32, 32, 3)
                                               ).astype(np.uint8)
    jcfg = _jcfg(name)
    jmodel, state, tx = _jax_state(jcfg, seed=2)
    rng = np.random.RandomState(15)
    rows = [rng.choice(len(frames), BS, replace=False) for _ in range(3)]
    meta = np.random.RandomState(19)
    actions = meta.randint(0, 4, len(frames)).astype(np.int32)
    reward_classes = meta.randint(0, 3, len(frames)).astype(np.int32)
    batches = [_np_batch(idx, actions, reward_classes,
                         meta if jcfg.use_priors else None) for idx in rows]
    if jcfg.use_triplet:
        for batch in batches:
            batch["neg_indices"] = meta.randint(0, len(frames), BS).astype(
                np.int32)
    return frames, jcfg, jmodel, state, tx, batches


def _eps(jcfg):
    """The VAE noise the port's step draws from a generator seeded with 0:
    one (B, state_dim) normal for the state, one for the next state."""
    if not jcfg.use_vae:
        return []
    g = torch.Generator().manual_seed(0)
    return [torch.randn((BS, jcfg.state_dim), generator=g).numpy()
            for _ in range(1 + jcfg.needs_next_obs)]


@contextlib.contextmanager
def _jax_normal_returns(arrays):
    """Make ``jax.random.normal`` return the given arrays in turn (the
    VAE's sampling calls it once per encoded batch), so that JAX samples
    the port's eps."""
    queue = list(arrays)
    real = jax.random.normal

    def fake(key, shape, dtype=jnp.float32):
        eps = queue.pop(0)
        assert eps.shape == tuple(shape)
        return jnp.asarray(eps, dtype)

    jax.random.normal = fake
    try:
        yield
    finally:
        jax.random.normal = real
    assert not queue


def _jax_apply(frames, jcfg, jmodel, params, batch_stats, batch):
    """JAX train-mode outputs, loss and updated BN statistics of a batch."""
    from srl_zoo_tpu.losses.registry import compute_total_loss as jax_loss
    from srl_zoo_tpu.ops.preproc import normalize_images
    view2 = _second_view(frames)

    def norm(u8):
        return normalize_images(jnp.asarray(u8), "tf")

    def views(rows):
        if jcfg.multi_view and not jcfg.use_triplet:
            return norm(np.concatenate([frames[rows], view2[rows]], -1))
        return norm(frames[rows])

    idx = batch["indices"]
    obs = views(idx)
    nxt = views(np.minimum(idx + 1, len(frames) - 1)) \
        if jcfg.needs_next_obs else None
    actions = jnp.asarray(batch["actions"]) if jcfg.use_forward else None
    pos = neg = None
    if jcfg.use_triplet:
        pos, neg = norm(view2[idx]), norm(frames[batch["neg_indices"]])
    outputs, mutated = jmodel.apply(
        {"params": params, "batch_stats": batch_stats}, obs, nxt, actions,
        pos, neg, train=True, rngs={"sampling": jax.random.PRNGKey(0)},
        mutable=["batch_stats"])
    total, _ = jax_loss(jcfg, outputs, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                        obs, params)
    return total, (mutated["batch_stats"], outputs)


def _jax_grads(frames, jcfg, jmodel, state, batch, float64=False):
    """(loss, port-named state dict of the gradients and the updated BN
    statistics) of one JAX train-mode apply. ``float64`` runs the encoder
    in float64 (JAX's 64-bit mode, the encoder built at that dtype; its
    last Dense and the losses stay float32, after every ReLU and pool)."""
    from srl_zoo_tpu.models import srl_modules
    from srl_zoo_tpu.models.srl_modules import SRLModules as JaxModules

    def run():
        with _jax_normal_returns(_eps(jcfg)):
            return jax.jit(jax.value_and_grad(
                lambda p: _jax_apply(frames, jcfg, model, p,
                                     state.batch_stats, batch),
                has_aux=True))(state.params)

    model = jmodel
    if float64:
        make = srl_modules.make_encoder
        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
            mp.setattr(srl_modules, "make_encoder", lambda *a, **k: make(
                *a, **{**k, "dtype": jnp.float64}))
            model = JaxModules(jcfg)
            (loss, (stats, _)), grads = run()
    else:
        (loss, (stats, _)), grads = run()
    sd, _ = bridge.state_dict_from_jax(jax.device_get(grads),
                                       jax.device_get(stats))
    return float(loss), sd


def _port_grads(jcfg, state, frames, batch, dtype=torch.float32):
    from srl_zoo_tpu_torch.training.train_step import _inputs, _loss
    cfg, model = _port_model(jcfg, state)
    model.to(dtype).train()
    store = {"frames": torch.from_numpy(frames),
             "frames_2": torch.from_numpy(_second_view(frames))}
    inputs = _inputs(model, store, batch, torch.Generator().manual_seed(0))
    for k in ("obs", "next_obs", "pos_obs", "neg_obs"):
        if inputs[k] is not None:
            inputs[k] = inputs[k].to(dtype)
    total, metrics = _loss(model, inputs)
    total.backward()
    assert float(metrics["_n_valid"]) == BS
    return float(total.detach()), model


@pytest.mark.parametrize("name", ["vae", "priors", "splits"])
def test_srl_modules_forward_matches_jax(name, two_pass_bn_variance):
    """Every output of a train-mode forward (obs, next obs, actions, the
    VAE's eps taken from the JAX side) within 1e-4 of its largest
    magnitude, and the BN statistics after it."""
    frames, jcfg, jmodel, state, _, batches = _step_setup(name)
    batch = batches[0]
    eps = _eps(jcfg)
    with _jax_normal_returns(eps):
        _, (stats, want) = jax.jit(lambda p: _jax_apply(
            frames, jcfg, jmodel, p, state.batch_stats, batch))(state.params)
    _, model = _port_model(jcfg, state)
    model.train()
    idx = batch["indices"]

    def obs(rows):
        return torch.from_numpy(frames[rows].astype(np.float32) / 127.5
                                - 1.0)
    got = model(obs(idx),
                obs(np.minimum(idx + 1, len(frames) - 1))
                if jcfg.needs_next_obs else None,
                torch.from_numpy(batch["actions"]),
                dict(zip(("state", "next_state"),
                         map(torch.from_numpy, eps))))
    want = {k: v for k, v in want.items() if v is not None}
    assert set(got) == set(want)
    for k, v in want.items():
        _close_rel_max(got[k].detach().numpy(), np.asarray(v), 1e-4)
    if jcfg.use_vae:
        start, size = jcfg.slices["vae"]
        z = got["mu"] + torch.exp(0.5 * got["logvar"]) * torch.from_numpy(
            eps[0])
        assert torch.equal(got["state"][:, start:start + size],
                           z[:, start:start + size])
    want_sd, _ = bridge.state_dict_from_jax(jax.device_get(state.params),
                                            jax.device_get(stats))
    for name_, buf in model.named_buffers():
        if "running" in name_:
            _close_rel_max(buf.numpy(), want_sd[name_].numpy(), 1e-5)


@pytest.mark.parametrize("name", ["autoencoder", "vae", "priors", "splits",
                                  "triplet", "multiview"])
def test_train_step_matches_jax(name, two_pass_bn_variance):
    from srl_zoo_tpu.training.train_step import build_steps
    from srl_zoo_tpu_torch.training.state import make_optimizer
    from srl_zoo_tpu_torch.training.train_step import train_step
    frames, jcfg, jmodel, state, tx, batches = _step_setup(name)
    # ResNet-18's steps are held in float64 (its encoder's, in JAX): in
    # float32 a ReLU or pool input within rounding of its switch point
    # routes the gradient one way in one package and the other way in the
    # other, which moves the gradients of the layers below it past the
    # tolerance, and these steps have such inputs (which ones depends on
    # the order of summation, so on the thread count).
    # test_resnet18_matches_jax holds one float32 encoder call.
    dtype = torch.float64 if jcfg.model_type == "resnet" else torch.float32
    want_loss, want_sd = _jax_grads(frames, jcfg, jmodel, state, batches[0],
                                    float64=dtype == torch.float64)
    loss, model = _port_grads(jcfg, state, frames, batches[0], dtype)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _check_grads(model, want_sd)
    for name_, buf in model.named_buffers():
        if "running" in name_:
            np.testing.assert_allclose(buf.numpy(), want_sd[name_].numpy(),
                                       rtol=0, atol=1e-5)
    if name != "autoencoder":
        # The three Adam steps hold config 1 only. JAX's train step draws
        # the VAE's eps itself. The priors are invariant to a shift of the
        # state, so the Dense bias has an exact gradient of 0, and Adam's
        # first steps move each such element by about lr in the direction
        # of its rounding noise, in either package: after three steps
        # such elements differ by several lr. The two-epoch test below
        # holds configs 3 and 4 over whole epochs instead.
        return

    # three optimizer steps in both packages, from the same start
    train_jax = build_steps(jcfg, jmodel, tx)[0]
    cache = {"frames": jnp.asarray(frames)}
    cfg, model = _port_model(jcfg, state)
    opt = make_optimizer(cfg, model)
    store = {"frames": torch.from_numpy(frames)}
    gen = torch.Generator().manual_seed(0)
    for batch in batches:
        state, _ = train_jax(state, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                             jax.random.PRNGKey(0), cache)
        train_step(model, opt, store, batch, gen)
    want_sd, _ = bridge.state_dict_from_jax(jax.device_get(state.params),
                                            jax.device_get(state.batch_stats))
    lr = cfg.learning_rate
    deltas = np.concatenate([
        np.abs(p.detach().numpy() - want_sd[name_].numpy()).ravel()
        for name_, p in model.named_parameters()])
    assert deltas.max() <= 3 * lr, deltas.max()
    assert np.median(deltas) <= 1e-5, np.median(deltas)
    assert np.percentile(deltas, 95) <= 1e-4, np.percentile(deltas, 95)


@pytest.fixture(scope="module")
def init_state_32px():
    """JAX's initial TrainState of a 32 px config-1 model (the init does
    not read the regularizer weights)."""
    return _jax_state(JaxConfig(state_dim=STATE_DIM, img_height=32,
                                img_width=32, batch_size=BS), seed=5)[1]


@pytest.mark.parametrize("l1,l2", [(0.5, 0.0), (0.0, 2.0), (0.3, 1.5)])
def test_regularized_loss_matches_jax(l1, l2, init_state_32px):
    """compute_total_loss with l1/l2 regularizers, on JAX's initial weights
    (their zero biases included) and fixed outputs with one padded row:
    the terms and the total within 1e-5 relative (sums over ~10^5 elements
    in another order), and the gradient of the total with respect to every
    parameter, which is the regularizers' alone, within 1e-6 of its
    tensor's largest magnitude (the same elementwise products)."""
    from srl_zoo_tpu.losses.registry import compute_total_loss as jax_loss
    from srl_zoo_tpu_torch.losses.registry import compute_total_loss
    jcfg = JaxConfig(state_dim=STATE_DIM, img_height=32, img_width=32,
                     batch_size=BS, l1_reg=l1, l2_reg=l2)
    state = init_state_32px
    cfg, model = _port_model(jcfg, state)
    rng = np.random.RandomState(18)
    recon, obs = rng.uniform(-1, 1, (2, BS, 3, 32, 32)).astype(np.float32)
    valid = np.ones(BS, np.float32)
    valid[-1] = 0.0
    batch = {**_jax_batch(np.arange(BS)), "valid": jnp.asarray(valid)}
    outputs = {"state": jnp.zeros((BS, STATE_DIM)),
               "recon": jnp.asarray(recon.transpose(0, 2, 3, 1))}
    (want, want_m), grads = jax.value_and_grad(
        lambda p: jax_loss(jcfg, outputs, batch,
                           jnp.asarray(obs.transpose(0, 2, 3, 1)), p),
        has_aux=True)(state.params)

    total, metrics = compute_total_loss(
        cfg, {"state": torch.zeros(BS, STATE_DIM),
              "recon": torch.from_numpy(recon)},
        torch.from_numpy(obs), torch.from_numpy(valid), model.parameters())
    assert set(metrics) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(want_m[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(want), rtol=1e-5)
    total.backward()
    want_sd, _ = bridge.state_dict_from_jax(jax.device_get(grads),
                                            jax.device_get(state.batch_stats))
    for name, p in model.named_parameters():
        _close_rel_max(p.grad.numpy(), want_sd[name].numpy(), 1e-6)


def test_jax_one_pass_bn_variance_strays_from_the_port(monkeypatch):
    """The fault the two-pass fixture works around, pinned. On the same
    batch and weights, the stock JAX gradients (flax's one-pass batch
    variance) stray from the two-pass ones by more than 1e-3 of some
    tensor's largest gradient, while the port's stay within 1e-4 of the
    two-pass ones, and within 1e-4 of its own float64 gradients."""
    frames, jcfg, jmodel, state, _, batches = _step_setup()
    _, stock = _jax_grads(frames, jcfg, jmodel, state, batches[0])
    from flax.linen import normalization
    one_pass = normalization._compute_stats
    monkeypatch.setattr(normalization, "_compute_stats",
                        lambda *a, **k: one_pass(
                            *a, **{**k, "use_fast_variance": False}))
    _, two_pass = _jax_grads(frames, jcfg, jmodel, state, batches[0])
    _, model = _port_grads(jcfg, state, frames, batches[0])
    _check_grads(model, two_pass)

    def worst(a_sd, b_sd):
        return max(float(np.abs(a_sd[n].numpy() - b_sd[n].numpy()).max())
                   / float(np.abs(b_sd[n].numpy()).max())
                   for n, _ in model.named_parameters()
                   if not n.endswith("bias") or "deconvs.4" in n)
    assert worst(stock, two_pass) > 1e-3

    from srl_zoo_tpu_torch.ops.preproc import normalize_images
    m64 = _port_model(jcfg, state)[1].double().train()
    x = normalize_images(torch.from_numpy(frames[batches[0]["indices"]]),
                         "tf").double()
    ((m64(x)["recon"] - x) ** 2).mean().backward()
    f64 = {n: p.grad.float() for n, p in m64.named_parameters()}
    _check_grads(model, f64)


# ---------------------------------------------------------------------------
# (e) loader and split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("losses", [
    pytest.param(("autoencoder",), id="False"),
    pytest.param(("priors",), id="True"),
    # the triplet's negatives are drawn before the priors' pairs
    pytest.param(("triplet", "priors"), id="triplet+priors")])
@pytest.mark.parametrize("n_rows", [None, 5])
@pytest.mark.parametrize("train", [True, False])
def test_loader_batches_equal_jax(synthetic_dataset, n_rows, train, losses):
    from srl_zoo_tpu.data.loader import DataLoader as JaxLoader
    from srl_zoo_tpu_torch.data.loader import DataLoader
    from srl_zoo_tpu_torch.data.schema import load_dataset
    jds = synthetic_dataset
    ds = load_dataset(jds.data_folder)
    idx = np.random.RandomState(16).permutation(jds.training_indices())
    idx = idx[:n_rows] if n_rows else idx[:-3]
    jcfg = _jcfg("autoencoder").replace(
        losses=tuple((n, 1.0) for n in losses),
        split_dims=tuple((n, -1) for n in losses))
    kw = dict(shuffle=train, seed=7, wraparound=train)
    want = JaxLoader(jds, idx, jcfg, emit_images=False, **kw)
    got = DataLoader(ds, idx, BS, priors=jcfg.use_priors,
                     triplet=jcfg.use_triplet, **kw)
    assert len(got) == len(want)
    for _ in range(2):
        wb, gb = list(want), list(got)
        assert len(wb) == len(gb)
        for w, g in zip(wb, gb):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_split_equals_the_jax_learner(synthetic_dataset):
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.learner import split_indices
    jds = synthetic_dataset
    for size, val in ((-1, 0.2), (50, 0.3)):
        cfg = SRLConfig(state_dim=STATE_DIM, img_height=32, img_width=32,
                        seed=3, training_set_size=size, val_size=val)
        # srl_zoo_tpu/training/learner.py, learn(): the split
        indices = jds.training_indices()
        indices = indices[np.random.RandomState(3).permutation(len(indices))]
        if size > 0:
            indices = indices[:size]
        n_val = int(len(indices) * val)
        train, valid = split_indices(load_dataset(jds.data_folder), cfg)
        np.testing.assert_array_equal(valid, indices[:n_val])
        np.testing.assert_array_equal(train, indices[n_val:])


# ---------------------------------------------------------------------------
# (f) two epochs of the learner from the same start
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["autoencoder", "priors", "splits",
                                  "triplet"])
def test_two_epochs_of_the_learner_match_jax(name, request,
                                             tmp_path_factory,
                                             two_pass_bn_variance):
    """The epoch means of the loss history within 2e-2: every train
    mean (the priors' pair terms weighted by their pair counts), the
    validation total and the priors' validation terms. Config 2 draws its
    noise from torch on one side and jax.random on the other: its one-step
    test stands in.

    Configs 3 and 4 run at lr 1e-4. At their lr of 5e-3 two epochs of
    five steps are chaotic at this size: a 1e-6 relative perturbation of
    the port's own initial weights moves their epoch means by more than
    this tolerance (test_two_epochs_of_priors_at_lr_5e3_are_chaotic). At
    1e-4 config 4's validation forward loss, a small MSE read through
    eval-mode BatchNorm, still moves by about as much as it differs from
    JAX's, so it is held through the validation total. Config 5 (triplet)
    runs at lr 1e-5, on the two-view dataset: at 1e-4 its two epochs are
    chaotic at this size (test_two_epochs_of_priors_at_lr_5e3_are_chaotic),
    as the triplet hinge switches rows on and off."""
    from srl_zoo_tpu.training.learner import SRL4robotics as JaxLearner
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    synthetic_dataset = request.getfixturevalue(
        "synthetic_dataset_mv" if name == "triplet" else "synthetic_dataset")
    lr = {"autoencoder": 5e-3, "triplet": 1e-5}.get(name, 1e-4)
    jcfg = _jcfg(name, epochs=2, seed=4, learning_rate=lr)
    jdir = str(tmp_path_factory.mktemp("jax_learn"))
    tdir = str(tmp_path_factory.mktemp("port_learn"))
    jl = JaxLearner(jcfg, log_folder=jdir)
    cfg = SRLConfig.from_exp_config(jcfg.to_exp_config())
    pl = SRL4robotics(cfg, log_folder=tdir, device="cpu")
    sd, _ = bridge.state_dict_from_jax(jax.device_get(jl.state.params),
                                       jax.device_get(jl.state.batch_stats))
    pl.model.load_state_dict(sd)
    jl.learn(synthetic_dataset)
    with _one_torch_thread():
        pl.learn(load_dataset(synthetic_dataset.data_folder))
    want = np.load(os.path.join(jdir, "loss_history.npz"))
    got = np.load(os.path.join(tdir, "loss_history.npz"))
    assert set(got.files) == set(want.files)
    for k in got.files:
        if k.startswith(("train/", "val/total", "val/priors")):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-2, err_msg=k)
    assert np.argmin(got["val/total"]) == np.argmin(want["val/total"])


@pytest.mark.parametrize("name,lr,chaotic", [
    pytest.param("priors", 5e-3, True, id="0.005-True"),
    pytest.param("priors", 1e-4, False, id="0.0001-False"),
    pytest.param("triplet", 1e-4, True, id="triplet-0.0001-True"),
    pytest.param("triplet", 1e-5, False, id="triplet-1e-05-False")])
def test_two_epochs_of_priors_at_lr_5e3_are_chaotic(name, lr, chaotic,
                                                    request, tmp_path):
    """Why the two-epoch comparison of configs 3 and 4 runs at lr 1e-4,
    and config 5's at 1e-5: two port runs from initial weights that
    differ by a 1e-6 relative perturbation end their epochs more than
    2e-2 apart at lr 5e-3 for config 3 and at 1e-4 for config 5 (on the
    two-view dataset), and within 2e-2 at the lr the comparison uses."""
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    cfg = SRLConfig.from_exp_config(_jcfg(
        name, epochs=2, seed=4, learning_rate=lr).to_exp_config())
    ds = load_dataset(request.getfixturevalue(
        "synthetic_dataset_mv" if name == "triplet" else
        "synthetic_dataset").data_folder)
    hist = []
    for eps in (0.0, 1e-6):
        run = SRL4robotics(cfg, log_folder=str(tmp_path / str(eps)),
                           device="cpu")
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for p in run.model.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=g))
        with _one_torch_thread():
            run.learn(ds)
        hist.append(np.load(tmp_path / str(eps) / "loss_history.npz"))
    rel = max(float(np.abs(hist[1][k] - hist[0][k]).max()
                    / np.abs(hist[0][k]).max())
              for k in hist[0].files if k.startswith(("train/", "val/")))
    assert (rel > 2e-2) == chaotic, rel


# ---------------------------------------------------------------------------
# (g) the CLI, (h) resume
# ---------------------------------------------------------------------------

def _cli(data_folder, log_folder, epochs, *extra, losses=("autoencoder",),
         state_dim=STATE_DIM):
    from srl_zoo_tpu_torch.train import main
    with _one_torch_thread():
        return main(["--data-folder", data_folder, "--losses", *losses,
                     "--state-dim", str(state_dim), "-bs", str(BS),
                     "--epochs", str(epochs), "--log-folder", log_folder,
                     "--device", "cpu", *extra])


# the --losses tokens of BASELINE configs 2-5, config 4's splits cut to 8,
# and config 5's model and views (on the two-view dataset)
CLI_LOSSES = {"vae": ("vae",), "priors": ("priors",),
              "splits": ("autoencoder:1:4", "inverse:2:2", "forward:1:1",
                         "reward:1:1"),
              "triplet": ("triplet",)}
CLI_FLAGS = {"triplet": ("--model-type", "resnet", "--multi-view")}


@pytest.fixture(scope="module")
def config_runs(synthetic_dataset, synthetic_dataset_mv, tmp_path_factory):
    """Two-epoch CLI runs of configs 2-5 (state_dim 8), made once each."""
    runs = {}

    def run(name):
        if name not in runs:
            ds = synthetic_dataset_mv if name in CLI_FLAGS \
                else synthetic_dataset
            runs[name] = _cli(ds.data_folder,
                              str(tmp_path_factory.mktemp(name) / "run"), 2,
                              "--beta", "0.5", *CLI_FLAGS.get(name, ()),
                              losses=CLI_LOSSES[name], state_dim=8)
        return runs[name]
    return run


@pytest.fixture(scope="module")
def port_cli_run(synthetic_dataset, tmp_path_factory):
    return _cli(synthetic_dataset.data_folder,
                str(tmp_path_factory.mktemp("port_cli") / "run"), 2)


def test_cli_writes_a_run_folder_both_packages_read(port_cli_run,
                                                    synthetic_dataset,
                                                    trained_ae_cli_run):
    from srl_zoo_tpu.evaluation.gtc import ground_truth_correlation
    from srl_zoo_tpu_torch.inference import StateEncoder
    run = port_cli_run
    cfg = SRLConfig.load(run)
    jcfg = JaxConfig.load(run)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert jcfg.bn_momentum == 0.9 and jcfg.epochs == 2
    enc = StateEncoder.load(run, device="cpu")
    out = np.load(os.path.join(run, "states_rewards.npz"))
    frames = np.asarray(synthetic_dataset.frames)
    np.testing.assert_allclose(out["states"], enc.encode(frames), rtol=0,
                               atol=1e-5)
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    learner = SRL4robotics.load(run, device="cpu")
    np.testing.assert_allclose(
        learner.predict_states(load_dataset(synthetic_dataset.data_folder)),
        out["states"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out["rewards"], synthetic_dataset.rewards)
    want = np.load(os.path.join(trained_ae_cli_run, "loss_history.npz"))
    hist = np.load(os.path.join(run, "loss_history.npz"))
    assert set(hist.files) == set(want.files)
    assert hist["train/total"][-1] < hist["train/total"][0]

    def keys(folder):
        with open(os.path.join(folder, "metrics.jsonl")) as f:
            return [set(json.loads(line)) for line in f]
    assert keys(run) == keys(trained_ae_cli_run) * 2
    with open(os.path.join(run, "gtc.txt")) as f:
        gtc = float(f.read())
    want_gtc, _ = ground_truth_correlation(
        out["states"], synthetic_dataset.ground_truth_states)
    assert abs(gtc - want_gtc) < 1e-6


def test_resume_equals_a_straight_run(port_cli_run, synthetic_dataset,
                                      tmp_path):
    run = str(tmp_path / "resumed")
    _cli(synthetic_dataset.data_folder, run, 1)
    _cli(synthetic_dataset.data_folder, run, 2, "--resume")
    for name in ("loss_history.npz", "states_rewards.npz"):
        want = np.load(os.path.join(port_cli_run, name))
        got = np.load(os.path.join(run, name))
        for k in ("states", "train/total", "val/total", "epoch"):
            if k in want.files:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want = torch.load(os.path.join(port_cli_run, "srl_model.pth"))
    got = torch.load(os.path.join(run, "srl_model.pth"))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]


@pytest.mark.parametrize("name", ["vae", "priors", "splits", "triplet"])
def test_cli_trains_configs_2_to_4(name, config_runs, synthetic_dataset,
                                   synthetic_dataset_mv):
    """The run folder of each config (config 5 too: triplet, ResNet-18,
    two views) loads in both packages with equal fields, its exported
    states are the encoder's (mu for the VAE), its GTC is written, and
    its loss history holds each loss of the config, finite."""
    from srl_zoo_tpu_torch.inference import StateEncoder
    if name in CLI_FLAGS:
        synthetic_dataset = synthetic_dataset_mv
    run = config_runs(name)
    assert os.path.exists(os.path.join(run, "gtc.txt"))
    cfg = SRLConfig.load(run)
    assert dataclasses.asdict(JaxConfig.load(run)) == dataclasses.asdict(cfg)
    assert cfg.beta == 0.5 and cfg.state_dim == 8
    out = np.load(os.path.join(run, "states_rewards.npz"))
    enc = StateEncoder.load(run, device="cpu")
    np.testing.assert_allclose(out["states"], enc.encode(np.asarray(
        synthetic_dataset.frames)), rtol=0, atol=1e-5)
    hist = np.load(os.path.join(run, "loss_history.npz"))
    for loss in cfg.loss_names:
        for split in ("train", "val"):
            assert np.isfinite(hist[f"{split}/{loss}"]).all()
    if name == "priors":
        assert {f"train/priors/{t}" for t in (
            "temporal", "causality", "proportionality", "repeatability")
        } <= set(hist.files)


def test_vae_resume_equals_a_straight_run(config_runs, synthetic_dataset,
                                          tmp_path):
    """1 epoch + --resume equals 2 epochs bit for bit for the VAE, whose
    steps draw noise: the resume checkpoint carries the generator."""
    straight = config_runs("vae")
    run = str(tmp_path / "resumed")
    for epochs, extra in ((1, ()), (2, ("--resume",))):
        _cli(synthetic_dataset.data_folder, run, epochs, "--beta", "0.5",
             *extra, losses=CLI_LOSSES["vae"], state_dim=8)
    for name in ("loss_history.npz", "states_rewards.npz"):
        want = np.load(os.path.join(straight, name))
        got = np.load(os.path.join(run, name))
        assert set(got.files) == set(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for name in ("srl_model.pth", "checkpoints/state_latest.pth"):
        want = torch.load(os.path.join(straight, name))
        got = torch.load(os.path.join(run, name))
        want = want.get("model", want) | {"generator": want.get("generator")}
        got = got.get("model", got) | {"generator": got.get("generator")}
        for k in want:
            assert (want[k] is None and got[k] is None) or \
                torch.equal(got[k], want[k]), (name, k)


def test_resume_keeps_the_saved_bn_momentum(synthetic_dataset, tmp_path):
    """A resumed run keeps the momentum it trained at unless --bn-momentum
    is given: a config recorded before the key existed means flax 0.99."""
    run = tmp_path / "old"
    SRLConfig(state_dim=STATE_DIM).save(str(run))
    with open(run / "exp_config.json") as f:
        raw = json.load(f)
    del raw["bn-momentum"]
    with open(run / "exp_config.json", "w") as f:
        json.dump(raw, f)
    _cli(synthetic_dataset.data_folder, str(run), 1, "--resume")
    assert SRLConfig.load(str(run)).bn_momentum == 0.99
    _cli(synthetic_dataset.data_folder, str(run), 1, "--resume",
         "--bn-momentum", "0.9")
    assert SRLConfig.load(str(run)).bn_momentum == 0.9


def test_jax_resume_replays_the_first_epochs_shuffle(synthetic_dataset,
                                                    tmp_path):
    """The fault the port's resume avoids, pinned: the JAX learner builds
    its train loader afresh on --resume, so the resumed epoch 1 is drawn
    from RandomState(seed + 0), epoch 0's shuffle, and its loss differs
    from a straight run's epoch 1 (the port's is equal; see above)."""
    from srl_zoo_tpu.training.learner import SRL4robotics as JaxLearner
    hist = {}
    for name, runs in (("straight", ((2, False),)),
                       ("resumed", ((1, False), (2, True)))):
        folder = str(tmp_path / name)
        for epochs, resume in runs:
            cfg = JaxConfig(state_dim=STATE_DIM, img_height=32,
                            img_width=32, batch_size=BS, epochs=epochs)
            JaxLearner(cfg, log_folder=folder).learn(synthetic_dataset,
                                                     resume=resume)
        hist[name] = np.load(os.path.join(folder, "loss_history.npz"))
    np.testing.assert_array_equal(hist["resumed"]["epoch"], [0, 1])
    assert hist["resumed"]["train/total"][0] == \
        hist["straight"]["train/total"][0]
    assert hist["resumed"]["train/total"][1] != \
        hist["straight"]["train/total"][1]


# ---------------------------------------------------------------------------
# (i) exp_config.json both ways, (j) flags not ported yet
# ---------------------------------------------------------------------------

def test_exp_config_round_trips_between_the_packages(tmp_path):
    from srl_zoo_tpu_torch.models.srl_modules import SRLModules
    jcfg = JaxConfig(state_dim=7, losses=(("autoencoder", 1.0),
                                          ("inverse", 2.5)),
                     split_dims=(("autoencoder", 3), ("inverse", 4)),
                     n_actions=5, img_height=64, img_width=32,
                     batch_size=8, epochs=3, learning_rate=1e-3, seed=5,
                     val_size=0.3, training_set_size=40, l1_reg=0.1,
                     bn_momentum=0.95, data_folder="d", log_folder="l",
                     device_cache="on")
    jax_dir, port_dir = tmp_path / "j", tmp_path / "p"
    jcfg.save(str(jax_dir))
    cfg = SRLConfig.load(str(jax_dir))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    cfg.save(str(port_dir))
    assert dataclasses.asdict(JaxConfig.load(str(port_dir))) == \
        dataclasses.asdict(jcfg)
    with open(port_dir / "exp_config.json") as f:
        raw = json.load(f)
    with open(jax_dir / "exp_config.json") as f:
        assert json.load(f) == raw
    del raw["bn-momentum"]
    old = SRLConfig.from_exp_config(raw)
    assert old.bn_momentum == JaxConfig.from_exp_config(raw).bn_momentum \
        == 0.99
    bn = SRLModules(old.replace(losses=(("autoencoder", 1.0),),
                                split_dims=(("autoencoder", -1),))
                    ).encoder.bns[0]
    assert abs(bn.momentum - 0.01) < 1e-12


@pytest.mark.parametrize("flags,item", [
    (["--num-processes", "2", "--device-cache", "off"], "item 8"),
    (["--num-processes", "2", "--device-cache", "hybrid"], "item 8"),
])
def test_unported_flags_name_their_roadmap_item(synthetic_dataset, tmp_path,
                                                flags, item):
    """Streaming and the hybrid store across processes (ROADMAP.md A8b)
    are refused before a process group starts or anything is written."""
    from srl_zoo_tpu_torch.train import main
    argv = ["--data-folder", synthetic_dataset.data_folder, "--state-dim",
            str(STATE_DIM), "--log-folder", str(tmp_path / "run"),
            "--device", "cpu", *flags]
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md queue A {item}"):
        main(argv)
    assert not os.path.exists(tmp_path / "run")


@pytest.mark.parametrize("flags", [
    ["--device-cache", "hybrid"],
    ["--stream-overlap"],
    ["--balanced-sampling"],
    ["--device-cache", "off"],
    ["--device-cache", "hybrid", "--no-hybrid-rotation"],
])
def test_data_layer_flags_train_through_the_cli(synthetic_dataset, tmp_path,
                                                monkeypatch, flags):
    """The data layer's flags, refused before it was ported, train: a
    hybrid store under a budget of 40 rows (rotating, or a static prefix),
    streaming with and without the copy overlap, and balanced sampling;
    the config records each."""
    monkeypatch.setenv("SRL_ZOO_CACHE_BUDGET_MB",
                       str(40.5 * 32 * 32 * 3 / 2**20))
    run = _cli(synthetic_dataset.data_folder, str(tmp_path / "run"), 2,
               *flags)
    cfg = SRLConfig.load(run)
    assert (cfg.device_cache, cfg.stream_overlap, cfg.balanced_sampling,
            cfg.hybrid_rotation) == (
        flags[1] if flags[0] == "--device-cache" else "auto",
        "--stream-overlap" in flags, "--balanced-sampling" in flags,
        "--no-hybrid-rotation" not in flags)
    hist = np.load(os.path.join(run, "loss_history.npz"))
    assert np.isfinite(hist["train/total"]).all()
    states = np.load(os.path.join(run, "states_rewards.npz"))["states"]
    assert states.shape == (synthetic_dataset.n_samples, STATE_DIM)


def test_cli_without_device_needs_a_gpu(synthetic_dataset, tmp_path):
    """No --device means cuda: without a GPU the CLI raises before it
    writes anything."""
    from srl_zoo_tpu_torch.train import main
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--data-folder", synthetic_dataset.data_folder,
              "--log-folder", str(tmp_path / "run")])
    assert not os.path.exists(tmp_path / "run")
