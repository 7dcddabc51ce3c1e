"""The port's config-5 modules (ResNet-18, the triplet loss and its
negatives, two camera views, torchvision weights) against the JAX package,
on the CPU at 32 px.

Inputs come from numpy with a seed, or from the shared 32 px two-view
``synthetic_dataset_mv``; weights come from the JAX package's own init,
bridged into the port. Tolerances, each with its reason:

* ResNet-18 forward: within 1e-4 of the output's largest magnitude (f32
  convolutions sum in another order; JAX's "s2d" stem regroups the stem
  convolution, so it rounds otherwise again); BatchNorm running
  statistics within 1e-5 of their largest.
* ResNet-18 gradients: each within 1e-4 of its tensor's largest magnitude
  (backward sums compound the forward's rounding).
* Stem pool gradient: exact. Integer inputs and cotangents make every sum
  exact, so any routing difference shows.
* Triplet loss: value 1e-6 relative, gradients 1e-6 of their largest (the
  same elementwise formula).
* Negatives: equal (the same draws from the same RandomState).
* Export and encode of a bridged run: 1e-4, as the other configs'.
* Pretrained weights: the converted tensors exactly; the encode 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_zoo_tpu.config import SRLConfig as JaxConfig
from srl_zoo_tpu_torch import bridge
from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.models.resnet import STEM_POOL_PADS, ResNet18
from test_torch_zoo_train import (_check_grads, _close_rel_max,  # noqa: F401
                                  two_pass_bn_variance)

PX = 32
STATE_DIM = 6


def _jax_resnet(stem: str, channels: int = 3, seed: int = 0):
    """A JAX ResNet18 with its init and BatchNorm statistics made
    non-trivial (eval mode then means something)."""
    from srl_zoo_tpu.models.resnet import ResNet18 as JaxResNet18
    model = JaxResNet18(state_dim=STATE_DIM, stem=stem, bn_momentum=0.9)
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((2, PX, PX, channels)), train=True))(
        jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 100)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.1, 0.5, v.shape).astype(
            np.float32), jax.device_get(variables["batch_stats"]))
    return model, jax.device_get(variables["params"]), stats


def _port_resnet(params, stats, channels: int = 3) -> ResNet18:
    """The port's ResNet18 with the JAX weights, through the bridge."""
    sd, skipped = bridge.state_dict_from_jax({"encoder": params},
                                             {"encoder": stats})
    assert skipped == []
    model = ResNet18(STATE_DIM, channels)
    model.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    return model


@pytest.mark.parametrize("stem", ["direct", "s2d"])
@pytest.mark.parametrize("train", [True, False])
def test_resnet18_matches_jax(stem, train, two_pass_bn_variance):
    """Output, input gradient, every parameter's gradient and (train mode)
    the updated BatchNorm statistics of one forward + backward."""
    jmodel, params, stats = _jax_resnet(stem)
    model = _port_resnet(params, stats).train(train)
    rng = np.random.RandomState(21)
    x = rng.uniform(-1, 1, (8, PX, PX, 3)).astype(np.float32)
    cot = rng.randn(8, STATE_DIM).astype(np.float32)

    def f(p, x):
        out, mutated = jmodel.apply({"params": p, "batch_stats": stats}, x,
                                    train=train, mutable=["batch_stats"])
        return jnp.vdot(out, jnp.asarray(cot)), (out, mutated)

    (_, (want, mutated)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, x)
    xt = torch.from_numpy(x).requires_grad_()
    out = model(xt)
    _close_rel_max(out.detach().numpy(), want, 1e-4)
    (out * torch.from_numpy(cot)).sum().backward()
    _close_rel_max(xt.grad.numpy(), gx, 1e-4)
    want_sd, _ = bridge.state_dict_from_jax(
        {"encoder": jax.device_get(gp)},
        {"encoder": jax.device_get(mutated["batch_stats"])})
    _check_grads(model, want_sd, "encoder.")
    for name, buf in model.named_buffers():
        if "running" in name:
            _close_rel_max(buf.numpy(), want_sd[f"encoder.{name}"].numpy(),
                           1e-5)


def test_resnet18_stem_pools_with_explicit_pads(monkeypatch):
    """The stem pool is the fused relu + pool at pads ((1, 1), (1, 1)),
    never 'SAME', whose pads at an even side are (0, 1): the same output
    size from other windows."""
    from srl_zoo_tpu_torch.models import resnet
    from srl_zoo_tpu_torch.ops.fused_pool import _resolve_pads
    seen = []
    real = resnet.relu_max_pool

    def spy(x, padding="SAME", with_index=False):
        seen.append(padding)
        return real(x, padding, with_index)

    monkeypatch.setattr(resnet, "relu_max_pool", spy)
    ResNet18(STATE_DIM)(torch.zeros(2, PX, PX, 3))
    assert seen == [((1, 1), (1, 1))] == [STEM_POOL_PADS]
    assert _resolve_pads(PX // 2, PX // 2, "SAME") != STEM_POOL_PADS


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 15, 9, 8)])
def test_stem_pool_gradient_equals_flax_exactly(shape):
    """relu + 3x3/2 max-pool at the stem's pads and its gradient, equal to
    flax's ``nn.max_pool(nn.relu(x))`` (XLA's select-and-scatter) on
    integer-valued inputs, where ties are common."""
    import flax.linen as nn
    from srl_zoo_tpu_torch.ops.fused_pool import relu_max_pool
    rng = np.random.RandomState(12)
    x = rng.randint(-2, 3, shape).astype(np.float32)

    def pool(v):
        return nn.max_pool(nn.relu(v), (3, 3), strides=(2, 2),
                           padding=STEM_POOL_PADS)

    y_ref = pool(jnp.asarray(x))
    g = rng.randint(-8, 9, y_ref.shape).astype(np.float32)
    dx_ref = jax.grad(lambda v: jnp.vdot(pool(v), jnp.asarray(g)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = relu_max_pool(xt, STEM_POOL_PADS)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dx_ref))


@pytest.mark.parametrize("case", ["random", "identical", "masked"])
def test_triplet_loss_matches_jax(case):
    """Value and gradients in all three inputs; identical embeddings (d = 0
    on both branches) keep a finite gradient."""
    from srl_zoo_tpu.losses.functions import triplet_loss as jax_triplet
    from srl_zoo_tpu_torch.losses.functions import triplet_loss
    rng = np.random.RandomState(22)
    a, p, n = (0.5 * rng.randn(3, 10, 5)).astype(np.float32)
    if case == "identical":
        p = n = a.copy()
    valid = np.ones(10, np.float32)
    if case == "masked":
        valid[-3:] = 0.0
    value, grads = jax.value_and_grad(
        lambda *t: jax_triplet(*t, valid=jnp.asarray(valid)),
        argnums=(0, 1, 2))(a, p, n)
    ts = [torch.from_numpy(v).requires_grad_() for v in (a, p, n)]
    got = triplet_loss(*ts, valid=torch.from_numpy(valid))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(value), rtol=1e-6)
    for t, want in zip(ts, grads):
        assert np.isfinite(t.grad.numpy()).all()
        _close_rel_max(t.grad.numpy(), np.asarray(want), 1e-6, 1e-6)


@pytest.mark.parametrize("seed,pool_size", [(0, 96), (1, 12), (2, 5)])
def test_triplet_negatives_equal_jax(seed, pool_size):
    """The same negatives from the same RandomState, and so the same state
    of the generator after the draws, also where most draws fall inside
    the anchor's window and are drawn again."""
    from srl_zoo_tpu.data import samplers as jax_samplers
    from srl_zoo_tpu_torch.data import samplers
    episode_ids = np.repeat(np.arange(4), 24).astype(np.int32)
    rng = np.random.RandomState(seed)
    idx = rng.choice(96, 16).astype(np.int32)
    pool = np.sort(rng.choice(96, pool_size, replace=False)).astype(np.int32)
    want_rng, got_rng = (np.random.RandomState(seed + 10) for _ in range(2))
    want = jax_samplers.triplet_negatives(idx, episode_ids, pool, want_rng)
    got = samplers.triplet_negatives(idx, episode_ids, pool, got_rng)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.int32
    assert got_rng.randint(1 << 30) == want_rng.randint(1 << 30)


# ---------------------------------------------------------------------------
# a bridged JAX config-5 run: encode, export
# ---------------------------------------------------------------------------

def _jcfg(name: str, data_folder: str) -> JaxConfig:
    losses = {"triplet": (("triplet", 1.0),),
              "multiview": (("priors", 1.0),)}[name]
    return JaxConfig(state_dim=STATE_DIM, model_type="resnet",
                     multi_view=True, losses=losses,
                     split_dims=tuple((n, -1) for n, _ in losses),
                     img_height=PX, img_width=PX, batch_size=16,
                     data_folder=data_folder)


@pytest.fixture(scope="module", params=["triplet", "multiview"])
def jax_run(request, synthetic_dataset_mv, tmp_path_factory):
    """A JAX run folder of config 5 (triplet) or of the 6-channel priors
    config, from JAX's init with BatchNorm statistics made non-trivial,
    converted by the bridge CLI, and JAX's states of the whole dataset."""
    from srl_zoo_tpu.training.checkpoint import save_srl_model
    from srl_zoo_tpu.training.learner import SRL4robotics as JaxLearner
    run = str(tmp_path_factory.mktemp(request.param) / "run")
    jcfg = _jcfg(request.param, synthetic_dataset_mv.data_folder)
    learner = JaxLearner(jcfg, log_folder=run)
    rng = np.random.RandomState(23)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.1, 0.5, v.shape).astype(
            np.float32), jax.device_get(learner.state.batch_stats))
    learner.state = learner.state.replace(batch_stats=stats)
    jcfg.save(run)
    save_srl_model(run, learner.state.params, stats)
    path = bridge.main(["--log-folder", run])
    assert os.path.exists(path)
    return run, learner.predict_states(synthetic_dataset_mv)


def test_bridge_converts_a_jax_resnet_run(jax_run, synthetic_dataset_mv):
    """Every key of the JAX tree is taken (none skipped), the shortcut
    convs sit where the width changes, and the converted run's encode of
    the dataset's frames (both views stacked where the encoder stacks
    them) is within 1e-4 of JAX's states."""
    from srl_zoo_tpu_torch.inference import StateEncoder
    run, want = jax_run
    tree = bridge.read_flax_msgpack(os.path.join(run, "srl_model.msgpack"))
    sd, skipped = bridge.state_dict_from_jax(tree["params"],
                                             tree["batch_stats"])
    assert skipped == []
    assert sd["encoder.layer2.0.downsample.0.weight"].shape == (128, 64, 1,
                                                                 1)
    assert "encoder.layer1.0.downsample.0.weight" not in sd
    enc = StateEncoder.load(run, device="cpu")
    assert sd["encoder.conv1.weight"].shape[1] == enc.cfg.n_channels
    ds = synthetic_dataset_mv
    frames = np.asarray(ds.frames[:20])
    if enc.cfg.stack_views:
        frames = np.concatenate([frames, np.asarray(ds.frames_2[:20])], -1)
    np.testing.assert_allclose(enc.encode(frames), want[:20], rtol=0,
                               atol=1e-4)


def test_multi_view_export_matches_jax(jax_run):
    """The export CLI's states (each view gathered from its own store
    where the encoder stacks both) within 1e-4 of JAX's predict_states."""
    from srl_zoo_tpu_torch.evaluation import predict_dataset
    run, want = jax_run
    path = predict_dataset.main(["--log-folder", run, "--device", "cpu"])
    got = np.load(path)["states"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# --pretrained-weights
# ---------------------------------------------------------------------------

def _torchvision_state_dict(seed: int = 24):
    """Seeded random tensors under torchvision's resnet18 keys and shapes,
    the 1000-way fc included."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in ResNet18(1000).state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(7)
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
    return sd


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_pretrained_weights_equal_the_jax_port(fmt, tmp_path):
    """The learner's encoder after --pretrained-weights, from .npz and
    .pth: every tensor but fc equal to JAX's ported ones, fc left at its
    fresh init, and the eval-mode encode within 1e-4 of the JAX encoder
    with the same ported weights (and the port's fc)."""
    from srl_zoo_tpu.models.resnet import ResNet18 as JaxResNet18
    from srl_zoo_tpu.models.torch_port import load_ported_resnet18 as jload
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    sd = _torchvision_state_dict()
    path = str(tmp_path / f"resnet18.{fmt}")
    if fmt == "npz":
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    else:
        torch.save(sd, path)
    cfg = SRLConfig(state_dim=STATE_DIM, model_type="resnet",
                    losses=(("triplet", 1.0),),
                    split_dims=(("triplet", -1),), img_height=PX,
                    img_width=PX, pretrained_weights=path)
    fresh = SRL4robotics(cfg.replace(pretrained_weights=""),
                         log_folder=str(tmp_path / "a"), device="cpu")
    learner = SRL4robotics(cfg, log_folder=str(tmp_path / "b"),
                           device="cpu")
    enc = learner.model.encoder.eval()
    from srl_zoo_tpu_torch.models.torch_port import load_ported_resnet18
    assert not any(k.startswith("fc.") for k in load_ported_resnet18(path))
    params, stats = jload(path, state_dim=-1)
    assert "Dense_0" not in params
    fc = fresh.model.encoder.fc
    params["Dense_0"] = {"kernel": fc.weight.detach().numpy().T,
                         "bias": fc.bias.detach().numpy()}
    want_sd, _ = bridge.state_dict_from_jax({"encoder": params},
                                            {"encoder": stats})
    for k, v in enc.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want_sd[f"encoder.{k}"]), k
    x = np.random.RandomState(25).uniform(-1, 1, (4, PX, PX, 3)).astype(
        np.float32)
    want = JaxResNet18(state_dim=STATE_DIM, stem="s2d").apply(
        {"params": params, "batch_stats": stats}, x, train=False)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    _close_rel_max(got.numpy(), np.asarray(want), 1e-4)
    with pytest.raises(ValueError, match="resnet only"):
        SRL4robotics(cfg.replace(model_type="custom_cnn"), device="cpu")


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_type", ["mlp", "linear"])
def test_dense_encoders_still_name_their_roadmap_item(model_type):
    from srl_zoo_tpu_torch.models.encoders import make_encoder
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        SRLConfig(model_type=model_type)
    with pytest.raises(ValueError, match="Unknown model type"):
        make_encoder(model_type, STATE_DIM, 3, PX, PX)
    assert isinstance(make_encoder("resnet", STATE_DIM, 6, PX, PX),
                      ResNet18)
