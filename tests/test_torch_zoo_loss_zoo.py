"""The rest of the loss zoo in the port (denoising autoencoder, perceptual
similarity, episode prior, reward prior, supervised, random features)
and ``--grad-accum``, against the JAX package on the CPU at 32 px.

Inputs are made with numpy from a seed; weights come from JAX's init,
bridged into the port; the DAE's random draws (patch corners, gaussian
noise) are derived with ``jax.random`` from the keys JAX's steps derive
and passed into the port's step. JAX's gradients are its own train
step's: an optimizer that keeps the gradients as its state and changes
no parameter. Tolerances, each with its reason:

* loss functions and the Discriminator: 1e-6 relative (the same float32
  operations, sums in another order);
* occlusion, gaussian noise, samplers, loader batches: exact;
* one train step: the loss and every metric within 1e-5 relative, each
  gradient within 1e-4 of its tensor's largest magnitude (as in
  test_torch_zoo_train.py: float32 convolutions and their backward sum in
  another order), BatchNorm statistics within 1e-5; one Adam step after it
  with that file's bounds on three steps (every parameter within 3 lr,
  the median within 1e-5, 95% within 1e-4);
* an eval step: every metric within 1e-5 relative;
* ``--grad-accum``: the accumulated gradient within 1e-5 of its tensor's
  largest magnitude of optax.MultiSteps' running mean when both take the
  same gradients, and the parameters within 2e-5 lr per Adam step (optax
  takes Adam's bias corrections in float32) and two float32 spacings
  after it; the parameters unchanged, exactly, on accumulating steps;
* resume in the middle of an accumulation, separate against shared
  optimizers: bit for bit;
* two epochs of the learner: epoch means within 2e-2, as the two-epoch
  tests of test_torch_zoo_train.py.
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srl_zoo_tpu.config import SRLConfig as JaxConfig
from srl_zoo_tpu_torch import bridge
from srl_zoo_tpu_torch.config import SRLConfig
from test_torch_zoo_train import (_check_grads, _cli,  # noqa: F401
                                  _close_rel_max, _jax_state,
                                  _one_torch_thread, _port_model,
                                  two_pass_bn_variance)

BS = 16
PX = 32
STATE_DIM = 4

# step cases: (losses with split dims, extra config fields)
CASES = {
    "dae": ((("dae", -1),), {}),
    "dae-gaussian": ((("dae", -1),), {"noise_type": "gaussian",
                                      "noise_std": 0.3}),
    "perceptual": ((("perceptual", -1),), {}),
    "episode-prior": ((("episode-prior", -1), ("autoencoder", -1)), {}),
    "episode-prior-separate": ((("episode-prior", -1), ("autoencoder", -1)),
                               {"episode_prior_optimizer": "separate"}),
    "reward-prior": ((("reward-prior", -1), ("autoencoder", -1)), {}),
    "supervised": ((("supervised", 2), ("autoencoder", 2)), {}),
}
GT_DIM = 2


def _jcfg(case, **kw):
    losses, extra = CASES[case]
    weights = {"episode-prior": 0.5}  # the encoder term at its own weight
    return JaxConfig(**{
        "state_dim": STATE_DIM, "img_height": PX, "img_width": PX,
        "batch_size": BS, "n_actions": 4, "n_reward_classes": 3,
        "losses": tuple((n, weights.get(n, 1.0)) for n, _ in losses),
        "split_dims": tuple(losses), **extra, **kw})


@functools.lru_cache(maxsize=None)
def _frames():
    """Random uint8 frames: a batch of them spreads every BatchNorm
    channel."""
    return np.random.RandomState(17).randint(0, 256, (64, PX, PX, 3)
                                             ).astype(np.uint8)


def _check_scaled_grads(model, want_sd, scale):
    """``_check_grads`` of ``scale`` times each parameter's gradient."""
    floor = 1e-2 * max(float(np.abs(want_sd[n].numpy()).max())
                       for n, _ in model.named_parameters())
    for n, p in model.named_parameters():
        _close_rel_max(p.grad.numpy() * scale, want_sd[n].numpy(), 1e-4,
                       floor)


# ---------------------------------------------------------------------------
# JAX's draws
# ---------------------------------------------------------------------------

def _occl_key(rng, step=None):
    """The key JAX's step corrupts with: ``fold_in(rng, step)`` in train
    mode (eval folds in no step), then the first half of the split of
    ``fold_in(., 1)``."""
    if step is not None:
        rng = jax.random.fold_in(rng, step)
    return jax.random.split(jax.random.fold_in(rng, 1))[0]


def _jax_corruption(jcfg, key, batch):
    """The DAE's draw of ``ops/preproc.py`` from ``key``, in the port's
    form: the (y0, x0) patch corners, or the noise tensor."""
    if jcfg.noise_type == "gaussian":
        return torch.from_numpy(np.array(jax.random.normal(
            key, (batch, jcfg.img_height, jcfg.img_width, 3))))
    h, w = jcfg.img_height, jcfg.img_width
    p = jcfg.occlusion_percentage
    side_h = jnp.asarray(h * jnp.sqrt(p), jnp.int32)
    side_w = jnp.asarray(w * jnp.sqrt(p), jnp.int32)
    ky, kx = jax.random.split(key)
    y0 = jax.random.randint(ky, (batch, 1, 1), 0, jnp.maximum(h - side_h + 1, 1))
    x0 = jax.random.randint(kx, (batch, 1, 1), 0, jnp.maximum(w - side_w + 1, 1))
    return tuple(torch.from_numpy(np.asarray(v).reshape(-1).astype(np.int64))
                 for v in (y0, x0))


def _keep_grads():
    """An optax transformation that keeps the gradients as its state and
    moves no parameter: JAX's own train step then hands out its
    gradients."""
    zeros = functools.partial(jax.tree_util.tree_map, jnp.zeros_like)
    return optax.GradientTransformation(
        lambda params: zeros(params),
        lambda updates, state, params=None: (zeros(updates), updates))


# ---------------------------------------------------------------------------
# (a) loss functions
# ---------------------------------------------------------------------------

def _loss_inputs(name, rng):
    b, d = BS, 6
    if name in ("dae", "perceptual"):
        a, t = rng.uniform(-1, 1, (2, b, 8, 8, 3)).astype(np.float32)
        if name == "perceptual":
            a, t = a.reshape(b, -1)[:, :d], t.reshape(b, -1)[:, :d]
        return (a, t)
    if name == "reward_prior":
        return (rng.randn(b, d).astype(np.float32),
                rng.uniform(0, 1, b).astype(np.float32))
    if name == "supervised":
        return tuple(rng.randn(2, b, d).astype(np.float32))
    return (rng.randn(b).astype(np.float32) * 3,
            rng.randn(b).astype(np.float32) * 3,
            (rng.rand(b) < 0.5).astype(np.float32))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["dae", "perceptual", "reward_prior",
                                  "supervised", "episode_prior"])
def test_loss_function_matches_jax(name, masked):
    from srl_zoo_tpu.losses import functions as JF
    from srl_zoo_tpu_torch.losses import functions as F
    rng = np.random.RandomState(31)
    args = _loss_inputs(name, rng)
    valid = None
    if masked:
        valid = np.ones(BS, np.float32)
        valid[-4:] = 0.0
    fn = {"dae": "dae_loss", "perceptual": "perceptual_similarity_loss",
          "reward_prior": "reward_prior_loss",
          "supervised": "supervised_loss",
          "episode_prior": "episode_prior_losses"}[name]
    want = getattr(JF, fn)(*map(jnp.asarray, args),
                           None if valid is None else jnp.asarray(valid))
    got = getattr(F, fn)(*map(torch.from_numpy, args),
                         None if valid is None else torch.from_numpy(valid))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


# ---------------------------------------------------------------------------
# (b) the DAE's corruption
# ---------------------------------------------------------------------------

def test_occlusion_side_is_float32_as_jax():
    """The patch's side over h in {32, 64, 224} and p on a grid of 0.01
    and at every (k / h)^2: equal to JAX's float32 computation, which
    differs from float64's at some of these points."""
    from srl_zoo_tpu_torch.ops.preproc import occlusion_side
    ps = [float(p) for p in np.round(np.arange(0.01, 1.0, 0.01), 2)]
    f64_differs = []
    for h in (32, 64, 224):
        for p in ps + [(k / h) ** 2 for k in range(1, h + 1)]:
            want = int(jnp.asarray(h * jnp.sqrt(p), jnp.int32))
            assert occlusion_side(h, p) == want, (h, p)
            if int(h * np.sqrt(p)) != want:
                f64_differs.append((h, p))
    assert len(f64_differs) >= 10, f64_differs


@pytest.mark.parametrize("h,w,p", [(32, 32, 0.5), (64, 48, 0.3),
                                   (224, 224, 0.02040816326530612),
                                   (224, 224, 0.07415896045918366)])
def test_occlude_matches_jax(h, w, p):
    """The port's occlusion from JAX's corners equals JAX's, and keeps
    the frames' layout; the last two p are where float64 would cut the
    side one pixel off."""
    from srl_zoo_tpu.ops.preproc import occlude as jax_occlude
    from srl_zoo_tpu_torch.ops.preproc import draw_occlusion, occlude
    rng = np.random.RandomState(32)
    obs = rng.uniform(-1, 1, (5, h, w, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_occlude(key, jnp.asarray(obs), p))
    jcfg = JaxConfig(img_height=h, img_width=w, occlusion_percentage=p)
    corners = _jax_corruption(jcfg, key, 5)
    got = occlude(torch.from_numpy(obs), corners, p)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.is_contiguous()
    assert (want == 0).any() and (want != 0).any()
    y0, x0 = draw_occlusion(torch.Generator().manual_seed(0), 1000, h, w, p,
                            "cpu")
    side = int(jnp.asarray(h * jnp.sqrt(p), jnp.int32))
    assert int(y0.min()) == 0 and int(y0.max()) == h - side


def test_gaussian_noise_matches_jax():
    from srl_zoo_tpu.ops.preproc import gaussian_noise as jax_noise
    from srl_zoo_tpu_torch.ops.preproc import gaussian_noise
    obs = np.random.RandomState(33).uniform(-1, 1, (4, 16, 16, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(8)
    want = np.asarray(jax_noise(key, jnp.asarray(obs), 0.2))
    noise = torch.from_numpy(np.array(jax.random.normal(key, obs.shape)))
    np.testing.assert_array_equal(
        gaussian_noise(torch.from_numpy(obs), noise, 0.2).numpy(), want)


# ---------------------------------------------------------------------------
# (c) samplers and loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 2, 16, 33])
def test_episode_prior_pairs_equal_jax(b):
    from srl_zoo_tpu.data.samplers import episode_prior_pairs as jax_pairs
    from srl_zoo_tpu_torch.data.samplers import episode_prior_pairs
    ep = np.random.RandomState(34).randint(0, 3, b)
    want = jax_pairs(ep, np.random.RandomState(5))
    got = episode_prior_pairs(ep, np.random.RandomState(5))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("train", [True, False])
def test_loader_batches_equal_jax(synthetic_dataset, train):
    """Two epochs of batches of a config with the priors, the episode
    prior and the supervised loss: the priors' pairs, then the episode
    pairs, from one generator, and the ground truth."""
    from srl_zoo_tpu.data.loader import DataLoader as JaxLoader
    from srl_zoo_tpu_torch.data.loader import DataLoader, batch_flags
    from srl_zoo_tpu_torch.data.schema import load_dataset
    jds = synthetic_dataset
    idx = np.random.RandomState(16).permutation(jds.training_indices())[:-3]
    names = ("priors", "episode-prior", "supervised")
    jcfg = JaxConfig(state_dim=STATE_DIM, img_height=PX, img_width=PX,
                     batch_size=BS, losses=tuple((n, 1.0) for n in names),
                     split_dims=tuple((n, -1) for n in names))
    kw = dict(shuffle=train, seed=7, wraparound=train)
    want = JaxLoader(jds, idx, jcfg, emit_images=False, **kw)
    cfg = SRLConfig.from_exp_config(jcfg.to_exp_config())
    got = DataLoader(load_dataset(jds.data_folder), idx, BS,
                     **batch_flags(cfg), **kw)
    for _ in range(2):
        wb, gb = list(want), list(got)
        assert len(wb) == len(gb) > 1
        for w, g in zip(wb, gb):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---------------------------------------------------------------------------
# (d) the Discriminator and the bridge
# ---------------------------------------------------------------------------

def test_discriminator_matches_jax():
    from srl_zoo_tpu.models.srl_modules import SRLModules as JaxModules
    jcfg = _jcfg("episode-prior")
    jmodel, state, _ = _jax_state(jcfg, seed=3)
    _, model = _port_model(jcfg, state)
    s1, s2 = np.random.RandomState(35).randn(2, BS, STATE_DIM).astype(
        np.float32)
    want = np.asarray(jmodel.apply({"params": state.params,
                                    "batch_stats": state.batch_stats},
                                   s1, s2, method=JaxModules.discriminate))
    got = model.discriminate(torch.from_numpy(s1), torch.from_numpy(s2))
    assert got.shape == (BS,)
    _close_rel_max(got.detach().numpy(), want, 1e-6)


def test_bridge_converts_a_jax_episode_prior_run(synthetic_dataset,
                                                 tmp_path):
    """A JAX ``episode-prior autoencoder`` run converts with no skipped
    key, and the port's model encodes and discriminates as JAX's."""
    import train as jax_train
    from srl_zoo_tpu.models.srl_modules import SRLModules as JaxModules
    from srl_zoo_tpu.training import checkpoint as jax_ckpt
    from srl_zoo_tpu_torch.checkpoint import load_srl_model
    run = str(tmp_path / "run")
    jax_train.main(["--data-folder", synthetic_dataset.data_folder,
                    "--losses", "episode-prior", "autoencoder", "--epochs",
                    "1", "--state-dim", str(STATE_DIM), "-bs", str(BS),
                    "--log-folder", run, "--no-display-plots"])
    _, skipped = bridge.convert_run(run)
    assert skipped == []
    jcfg = JaxConfig.load(run)
    jmodel, jstate, _ = jax_ckpt.load_srl_model(run, jcfg)
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    _, model = load_srl_model(run, torch.device("cpu"))
    frames = np.asarray(synthetic_dataset.frames[:BS])
    x = frames.astype(np.float32) * (2.0 / 255.0) - 1.0
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                   method=JaxModules.encode))
    got = model.encode(torch.from_numpy(x)).detach().numpy()
    _close_rel_max(got, want, 1e-5)
    want = want.copy()
    s2 = want[::-1].copy()
    want_d = np.asarray(jmodel.apply(variables, want, s2,
                                     method=JaxModules.discriminate))
    got_d = model.discriminate(torch.from_numpy(want), torch.from_numpy(s2))
    _close_rel_max(got_d.detach().numpy(), want_d, 1e-5)


def test_frozen_dae_refuses_a_jax_run(trained_ae_cli_run, tmp_path):
    """A JAX run folder (``srl_model.msgpack`` alone) is not decoded
    silently: the error names the bridge's command."""
    from srl_zoo_tpu_torch.training.learner import load_frozen_dae
    run = tmp_path / "jax_run"
    run.mkdir()
    for f in ("exp_config.json", "srl_model.msgpack"):
        shutil.copy(os.path.join(trained_ae_cli_run, f), run / f)
    with pytest.raises(FileNotFoundError,
                       match="python -m srl_zoo_tpu_torch.bridge "
                             "--log-folder"):
        load_frozen_dae(str(run), torch.device("cpu"))


# ---------------------------------------------------------------------------
# (e) one train step and one eval step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _frozen_dae():
    """A DAE of JAX's init with non-trivial BatchNorm statistics: JAX's
    frozen feature function and the port's frozen model of its weights."""
    from srl_zoo_tpu.models.srl_modules import SRLModules as JaxModules
    dcfg = _jcfg("dae")
    dmodel, dstate, _ = _jax_state(dcfg, seed=4, perturb_stats=True)
    variables = {"params": jax.lax.stop_gradient(dstate.params),
                 "batch_stats": dstate.batch_stats}

    def feature_fn(x):
        return dmodel.apply(variables, x, train=False,
                            method=JaxModules.encode)
    _, port = _port_model(dcfg, dstate)
    return feature_fn, port.eval().requires_grad_(False)


@functools.lru_cache(maxsize=None)
def _setup(case):
    """Random uint8 frames, a 32 px model of the case from JAX's init
    (BatchNorm statistics perturbed, so eval mode means something), a
    train batch and an eval batch whose last three rows are padding, each
    with every loss's metadata."""
    from srl_zoo_tpu_torch.data import samplers
    frames = _frames()
    jcfg = _jcfg(case)
    jmodel, state, _ = _jax_state(jcfg, seed=2, perturb_stats=True)
    meta = np.random.RandomState(36)
    batches = []
    for pad in (0, 3):
        idx = meta.choice(len(frames), BS, replace=False)
        partners, labels = samplers.episode_prior_pairs(idx // 16, meta)
        valid = np.ones(BS, np.float32)
        valid[BS - pad:] = 0.0
        batches.append({
            "indices": idx.astype(np.int32), "valid": valid,
            "actions": meta.randint(0, 4, BS).astype(np.int32),
            "reward_classes": meta.randint(0, 3, BS).astype(np.int32),
            "rewards": meta.uniform(0, 1, BS).astype(np.float32),
            "gt_states": meta.uniform(0, 1, (BS, GT_DIM)).astype(np.float32),
            "episode_partners": partners, "episode_labels": labels})
    return frames, jcfg, jmodel, state, batches


def _jax_steps(jcfg, jmodel, tx):
    from srl_zoo_tpu.training.train_step import build_steps
    feature_fn = _frozen_dae()[0] if "perceptual" in jcfg.loss_dict \
        else None
    return build_steps(jcfg, jmodel, tx, dae_feature_fn=feature_fn)


def _as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _fresh(state, tx):
    """A copy of a cached TrainState with ``tx``'s state: JAX's train step
    donates (deletes) the state it takes."""
    state = jax.tree_util.tree_map(lambda v: jnp.array(v, copy=True), state)
    return state.replace(opt_state=tx.init(state.params))


def _jax_float64_grads(jcfg, state, obs, enc_obs, batch):
    """Port-named gradients of JAX's train-mode loss of a DAE config with
    every layer in float64 (JAX's 64-bit mode, the modules' float32 read
    as float64), on the clean frames ``obs`` and the corrupted
    ``enc_obs``."""
    from srl_zoo_tpu.losses.registry import compute_total_loss
    from srl_zoo_tpu.models import batchnorm, decoders, encoders, srl_modules

    class As64:
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for module in (srl_modules, encoders, decoders, batchnorm):
            mp.setattr(module, "jnp", As64())
        model = srl_modules.SRLModules(jcfg)

        def f64(tree):
            return jax.tree_util.tree_map(
                lambda v: jnp.asarray(np.asarray(v), jnp.float64), tree)
        stats, (x, x_enc) = f64(state.batch_stats), f64((obs, enc_obs))

        def loss(params):
            out, _ = model.apply({"params": params, "batch_stats": stats},
                                 x, None, None, None, None, x_enc,
                                 train=True, mutable=["batch_stats"])
            return compute_total_loss(jcfg, out, _as_jax(batch), x,
                                      params)[0]
        grads = jax.jit(jax.grad(loss))(f64(state.params))
        grads = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32),
                                       grads)
    return bridge.state_dict_from_jax(grads,
                                      jax.device_get(state.batch_stats))[0]


def _close_metrics(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k].detach()), float(w),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case, two_pass_bn_variance):
    from srl_zoo_tpu.training.state import make_optimizer as jax_optimizer
    from srl_zoo_tpu_torch.training.state import make_optimizer
    from srl_zoo_tpu_torch.training.train_step import _inputs, _loss
    frames, jcfg, jmodel, state, batches = _setup(case)
    batch = batches[0]
    cache = {"frames": jnp.asarray(frames)}
    key = jax.random.PRNGKey(0)
    tx = _keep_grads()
    train_jax = _jax_steps(jcfg, jmodel, tx)[0]
    new, want_m = train_jax(_fresh(state, tx), _as_jax(batch), key, cache)
    want_sd, _ = bridge.state_dict_from_jax(jax.device_get(new.opt_state),
                                            jax.device_get(new.batch_stats))

    cfg, model = _port_model(jcfg, state)
    model.train()
    inputs = _inputs(model, {"frames": torch.from_numpy(frames)}, batch,
                     torch.Generator().manual_seed(0))
    if cfg.use_dae:
        inputs["corruption"] = _jax_corruption(jcfg, _occl_key(key, 0), BS)
    total, metrics = _loss(model, inputs, _frozen_dae()[1])
    total.backward()
    if case == "dae-gaussian":
        # JAX's float32 gradients of this step stray by ~1e-2 of their
        # scale (test_jax_gaussian_dae_gradients_stray_from_float64): the
        # port is held to JAX's float64 ones
        f64 = _jax_float64_grads(
            jcfg, state, inputs["obs"].numpy(),
            (inputs["obs"] + 0.3 * inputs["corruption"]).numpy(), batch)
        want_sd.update({n: f64[n] for n, _ in model.named_parameters()})
    np.testing.assert_allclose(float(total.detach()), float(want_m["total"]),
                               rtol=1e-5)
    _close_metrics(metrics, want_m)
    if cfg.use_episode_prior:
        assert float(metrics["_w/episode-prior"]) == BS
    _check_grads(model, want_sd)
    for name, buf in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(),
                                       rtol=0, atol=1e-5)

    # one Adam step after it (two Adams with a separate discriminator)
    opt = make_optimizer(cfg, model)
    assert len(opt.adams) == (2 if case.endswith("separate") else 1)
    if len(opt.adams) == 2:
        disc = {id(p) for p in model.discriminator.parameters()}
        assert {id(p) for p in opt.adams[1].param_groups[0]["params"]} \
            == disc
        assert not disc & {id(p) for p in
                           opt.adams[0].param_groups[0]["params"]}
    assert opt.step()
    real = jax_optimizer(jcfg)
    moved, _ = _jax_steps(jcfg, jmodel, real)[0](
        _fresh(state, real), _as_jax(batch), key, cache)
    want_sd, _ = bridge.state_dict_from_jax(jax.device_get(moved.params),
                                            jax.device_get(moved.batch_stats))
    lr = cfg.learning_rate
    deltas = np.concatenate([
        np.abs(p.detach().numpy() - want_sd[n].numpy()).ravel()
        for n, p in model.named_parameters()])
    assert deltas.max() <= 3 * lr and np.median(deltas) <= 1e-5 and \
        np.percentile(deltas, 95) <= 1e-4, (deltas.max(), np.median(deltas))


def test_jax_gaussian_dae_gradients_stray_from_float64():
    """A fault of the JAX package that the port avoids, pinned. The train
    step of the gaussian DAE (noise std 0.3, the 32 px frames of these
    tests, JAX init seed 2, two-pass BatchNorm variance): JAX's float32
    gradients stray from JAX's own float64 ones by more than 1e-3 of some
    tensor's largest gradient (about 1e-2 of nearly every tensor), while
    the port's float32 ones stay within 1e-4 of them. Where JAX's float32
    loses them is not isolated: not in XLA's fast math, and the loss and
    the occlusion DAE's gradients agree."""
    from srl_zoo_tpu_torch.training.train_step import _inputs, _loss
    from flax.linen import normalization
    one_pass = normalization._compute_stats
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(normalization, "_compute_stats", lambda *a, **k: one_pass(
            *a, **{**k, "use_fast_variance": False}))
        frames, jcfg, jmodel, state, batches = _setup("dae-gaussian")
        key = jax.random.PRNGKey(0)
        tx = _keep_grads()
        new, _ = _jax_steps(jcfg, jmodel, tx)[0](
            _fresh(state, tx), _as_jax(batches[0]), key,
            {"frames": jnp.asarray(frames)})
        f32, _ = bridge.state_dict_from_jax(jax.device_get(new.opt_state),
                                            jax.device_get(new.batch_stats))
        cfg, model = _port_model(jcfg, state)
        model.train()
        inputs = _inputs(model, {"frames": torch.from_numpy(frames)},
                         batches[0], torch.Generator().manual_seed(0))
        inputs["corruption"] = _jax_corruption(jcfg, _occl_key(key, 0), BS)
        f64 = _jax_float64_grads(
            jcfg, state, inputs["obs"].numpy(),
            (inputs["obs"] + 0.3 * inputs["corruption"]).numpy(), batches[0])
    _loss(model, inputs)[0].backward()
    _check_grads(model, f64)

    def worst(sd):
        return max(float(np.abs(sd[n].numpy() - f64[n].numpy()).max())
                   / float(np.abs(f64[n].numpy()).max())
                   for n, _ in model.named_parameters()
                   if not n.endswith("bias") or "deconvs.4" in n)
    assert worst(f32) > 1e-3


@pytest.mark.parametrize("case", list(CASES))
def test_eval_step_matches_jax(case):
    """The metrics of an eval step of a batch with three padded rows, the
    DAE corrupted by JAX's eval draw (its key folds in no step)."""
    from srl_zoo_tpu_torch.training.train_step import eval_step
    frames, jcfg, jmodel, state, batches = _setup(case)
    key = jax.random.PRNGKey(9)
    want = _jax_steps(jcfg, jmodel, _keep_grads())[1](
        state, _as_jax(batches[1]), key, {"frames": jnp.asarray(frames)})
    cfg, model = _port_model(jcfg, state)
    corruption = _jax_corruption(jcfg, _occl_key(key), BS) \
        if cfg.use_dae else None
    got = eval_step(model, {"frames": torch.from_numpy(frames)}, batches[1],
                    corruption, _frozen_dae()[1])
    assert float(got["_n_valid"]) == BS - 3
    _close_metrics(got, want)


def test_episode_prior_gradient_split():
    """The discriminator learns from its own loss alone and the encoder
    from the rest: d_loss reaches no encoder parameter, the encoder term
    no discriminator parameter, and the total's gradients are those of
    the two parts."""
    from srl_zoo_tpu_torch.training.train_step import _inputs, _loss
    frames, jcfg, _, state, batches = _setup("episode-prior")
    cfg, model = _port_model(jcfg, state)
    model.train()
    total, m = _loss(model, _inputs(model, {"frames": torch.from_numpy(
        frames)}, batches[0], torch.Generator().manual_seed(0)))
    disc = [p for n, p in model.named_parameters()
            if n.startswith("discriminator.")]
    rest = [p for n, p in model.named_parameters()
            if not n.startswith("discriminator.")]
    d_loss, e_loss = m["episode-prior/discriminator"], m["episode-prior"]
    w = cfg.loss_dict["episode-prior"]

    def grads(out, params):
        return torch.autograd.grad(out, params, retain_graph=True,
                                   allow_unused=True)
    assert all(g is None for g in grads(d_loss, rest))
    assert all(g is None for g in grads(e_loss, disc))
    for got, want in zip(grads(total, disc), grads(d_loss, disc)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for got, want in zip(grads(total, rest),
                         grads(m["autoencoder"] + w * e_loss, rest)):
        if want is None:
            assert got is None
        else:
            _close_rel_max(got.numpy(), want.numpy(), 1e-6)
    assert any(g is not None and float(g.abs().max()) > 0
               for g in grads(e_loss, rest))


# ---------------------------------------------------------------------------
# (f) --grad-accum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("separate", [False, True])
def test_accumulating_adam_matches_optax_multisteps(separate):
    """Six micro-steps at --grad-accum 3 with the same random gradients on
    both sides (the port takes them through ``backward`` of a loss whose
    gradient they are): the accumulated gradient against MultiSteps'
    running mean after each micro-step, the parameters unchanged on
    accumulating steps and against JAX's after each Adam step, and Adam's
    step count."""
    from srl_zoo_tpu.training.state import make_optimizer as jax_optimizer
    from srl_zoo_tpu_torch.training.state import make_optimizer
    jcfg = _jcfg("episode-prior-separate" if separate else "episode-prior",
                 grad_accum=3)
    _, state, _ = _jax_state(jcfg, seed=5)
    cfg, model = _port_model(jcfg, state)
    tx = jax_optimizer(jcfg)
    params, opt_state = state.params, tx.init(state.params)
    opt = make_optimizer(cfg, model)
    rng = np.random.RandomState(37)
    names = [n for n, _ in model.named_parameters()]
    for t in range(1, 7):
        g = jax.tree_util.tree_map(
            lambda v: jnp.asarray(rng.randn(*v.shape).astype(np.float32)),
            params)
        updates, opt_state = tx.update(g, opt_state, params)
        jax_before, params = params, optax.apply_updates(params, updates)
        g_sd, _ = bridge.state_dict_from_jax(jax.device_get(g),
                                             jax.device_get(state.batch_stats))
        before = [p.detach().clone() for p in model.parameters()]
        opt.backward(sum((p * g_sd[n]).sum()
                         for n, p in model.named_parameters()))
        if t % 3:
            # MultiSteps keeps the mean of the micro-steps so far, the
            # port the sum over k: equal at the k-th
            acc, _ = bridge.state_dict_from_jax(
                jax.device_get(opt_state.acc_grads),
                jax.device_get(state.batch_stats))
            for n, p in model.named_parameters():
                _close_rel_max(p.grad.numpy() * (3 / (t % 3)),
                               acc[n].numpy(), 1e-5)
        assert opt.step() == (t % 3 == 0)
        want, _ = bridge.state_dict_from_jax(jax.device_get(params),
                                             jax.device_get(state.batch_stats))
        for (n, p), b in zip(model.named_parameters(), before):
            if t % 3:
                assert torch.equal(p.detach(), b), n
            else:
                # optax takes Adam's bias corrections in float32 (1 - 0.999
                # is 1.0000467e-3 there), torch in float64: an update
                # differs by up to ~1e-5 of lr, and each sum p + update
                # rounds to p's float32 spacing
                assert p.grad is None
                w = want[n].numpy()
                err = np.abs(p.detach().numpy() - w)
                assert (err <= 2e-5 * cfg.learning_rate * (t // 3)
                        + 2 * np.spacing(np.abs(w))).all(), (n, err.max())
        assert opt.micro_step == t % 3
        if t % 3:
            jax.tree_util.tree_map(np.testing.assert_array_equal, params,
                                   jax_before)
    for adam in opt.adams:
        assert all(int(s["step"]) == 2 for s in adam.state.values())
    assert int(opt_state.gradient_step) == 2
    assert len(names) == sum(len(a.param_groups[0]["params"])
                             for a in opt.adams)


def test_grad_accum_train_steps_match_jax(two_pass_bn_variance):
    """Six train steps of the autoencoder at --grad-accum 3 in both
    packages from the same start: the losses of the first three (one set
    of parameters), the accumulated gradient after micro-steps 1 and 2,
    the parameters unchanged on accumulating steps, and after the first
    Adam step within the bounds of test_torch_zoo_train.py's three Adam
    steps. After the second, every parameter within 3 lr and the median
    within 1e-5: its three micro-steps run at parameters that already
    differ by up to 2 lr where the first step's sign followed a gradient
    at rounding level, so more elements move apart (95% were within
    1.7e-4 when this test was written)."""
    from srl_zoo_tpu.training.state import make_optimizer as jax_optimizer
    from srl_zoo_tpu.training.train_step import build_steps
    from srl_zoo_tpu_torch.training.state import make_optimizer
    from srl_zoo_tpu_torch.training.train_step import train_step
    frames = _frames()
    jcfg = JaxConfig(state_dim=STATE_DIM, img_height=PX, img_width=PX,
                     batch_size=BS, grad_accum=3)
    jmodel, state, _ = _jax_state(jcfg, seed=2)
    tx = jax_optimizer(jcfg)
    cfg, model = _port_model(jcfg, state)
    state = _fresh(state, tx)
    train_jax = build_steps(jcfg, jmodel, tx)[0]
    opt = make_optimizer(cfg, model)
    rng = np.random.RandomState(38)
    cache = {"frames": jnp.asarray(frames)}
    store = {"frames": torch.from_numpy(frames)}
    gen = torch.Generator().manual_seed(0)
    lr = cfg.learning_rate
    for t in range(1, 7):
        idx = rng.choice(len(frames), BS, replace=False).astype(np.int32)
        batch = {"indices": idx, "valid": np.ones(BS, np.float32)}
        before = [p.detach().clone() for p in model.parameters()]
        state, want_m = train_jax(state, _as_jax(batch),
                                  jax.random.PRNGKey(0), cache)
        got_m = train_step(model, opt, store, batch, gen)
        if t <= 3:
            np.testing.assert_allclose(float(got_m["total"]),
                                       float(want_m["total"]), rtol=1e-5)
        stats = jax.device_get(state.batch_stats)
        want, _ = bridge.state_dict_from_jax(jax.device_get(state.params),
                                             stats)
        if t % 3:
            assert all(torch.equal(p.detach(), b)
                       for p, b in zip(model.parameters(), before))
            if t < 3:
                acc, _ = bridge.state_dict_from_jax(
                    jax.device_get(state.opt_state.acc_grads), stats)
                _check_scaled_grads(model, acc, 3 / t)
        else:
            deltas = np.concatenate([
                np.abs(p.detach().numpy() - want[n].numpy()).ravel()
                for n, p in model.named_parameters()])
            assert deltas.max() <= 3 * lr, deltas.max()
            assert np.median(deltas) <= 1e-5, np.median(deltas)
            if t == 3:
                assert np.percentile(deltas, 95) <= 1e-4
    assert int(state.opt_state.gradient_step) == 2
    assert all(int(s["step"]) == 2 for s in opt.adams[0].state.values())


def test_resume_mid_accumulation_equals_a_straight_run(synthetic_dataset,
                                                       tmp_path):
    """--grad-accum 3 at five steps an epoch: the first epoch ends two
    micro-steps into a cycle. One epoch + --resume equals two epochs bit
    for bit: the loss history, the states, the model and the resume
    checkpoint with its accumulated gradients."""
    ds = synthetic_dataset.data_folder
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    _cli(ds, straight, 2, "--grad-accum", "3")
    _cli(ds, resumed, 1, "--grad-accum", "3")
    mid = torch.load(os.path.join(resumed, "checkpoints",
                                  "state_latest.pth"))["optimizer"]
    assert mid["micro_step"] == 2 and all(g is not None
                                          for g in mid["grads"])
    _cli(ds, resumed, 2, "--grad-accum", "3", "--resume")
    for name in ("loss_history.npz", "states_rewards.npz"):
        want = np.load(os.path.join(straight, name))
        got = np.load(os.path.join(resumed, name))
        assert set(got.files) == set(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for name in ("srl_model.pth", "checkpoints/state_latest.pth"):
        want = torch.load(os.path.join(straight, name))
        got = torch.load(os.path.join(resumed, name))
        _assert_equal_trees(got, want, name)


def _assert_equal_trees(got, want, where):
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want), where
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_equal_trees(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal_trees(g, w, f"{where}/{i}")
    else:
        assert got == want, where


# ---------------------------------------------------------------------------
# (g) the learner and the CLI
# ---------------------------------------------------------------------------

def test_separate_equals_shared_loss_history(synthetic_dataset, tmp_path):
    """Adam is elementwise: a discriminator with an Adam of its own trains
    as one Adam over every parameter does, bit for bit."""
    hist = {}
    for mode in ("shared", "separate"):
        run = _cli(synthetic_dataset.data_folder, str(tmp_path / mode), 2,
                   "--episode-prior-optimizer", mode,
                   losses=("episode-prior", "autoencoder"))
        hist[mode] = np.load(os.path.join(run, "loss_history.npz"))
        opt = torch.load(os.path.join(run, "checkpoints",
                                      "state_latest.pth"))["optimizer"]
        assert len(opt["adams"]) == (2 if mode == "separate" else 1)
    assert "train/episode-prior/discriminator" in hist["shared"].files
    assert set(hist["shared"].files) == set(hist["separate"].files)
    for k in hist["shared"].files:
        np.testing.assert_array_equal(hist["separate"][k], hist["shared"][k],
                                      err_msg=k)


def test_random_features_cli(synthetic_dataset, tmp_path):
    """--losses random trains nothing: srl_model.pth holds the initial
    weights of the seed, the loss history is empty and the exported
    states are a direct encode of that model."""
    from srl_zoo_tpu_torch.inference import StateEncoder
    from srl_zoo_tpu_torch.training.state import make_model
    run = _cli(synthetic_dataset.data_folder, str(tmp_path / "rand"), 5,
               losses=("random",))
    cfg = SRLConfig.load(run)
    init = make_model(cfg, torch.device("cpu")).state_dict()
    saved = torch.load(os.path.join(run, "srl_model.pth"))
    _assert_equal_trees(saved, init, "srl_model.pth")
    assert np.load(os.path.join(run, "loss_history.npz")).files == []
    states = np.load(os.path.join(run, "states_rewards.npz"))["states"]
    frames = np.asarray(synthetic_dataset.frames)
    np.testing.assert_allclose(states, StateEncoder.load(
        run, device="cpu").encode(frames), rtol=0, atol=1e-6)
    assert not os.path.exists(os.path.join(run, "checkpoints"))


def test_perceptual_needs_a_frozen_dae(tmp_path):
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    cfg = SRLConfig.from_exp_config(_jcfg("perceptual").to_exp_config())
    with pytest.raises(ValueError, match="--path-to-dae"):
        SRL4robotics(cfg, log_folder=str(tmp_path), device="cpu")


def test_supervised_slice_must_match_the_ground_truth(synthetic_dataset,
                                                      tmp_path):
    """The supervised slice must be as wide as the ground truth (2 here),
    as in the JAX learner: the whole state of 4 is refused, a 2-wide
    split trains."""
    with pytest.raises(ValueError, match="supervised loss slice has size 4"):
        _cli(synthetic_dataset.data_folder, str(tmp_path / "whole"), 1,
             losses=("supervised",))
    run = _cli(synthetic_dataset.data_folder, str(tmp_path / "split"), 1,
               losses=("supervised:1:2", "autoencoder:1:2"))
    hist = np.load(os.path.join(run, "loss_history.npz"))
    assert np.isfinite(hist["train/supervised"]).all()


def test_validation_corruption_is_fixed(synthetic_dataset, tmp_path,
                                        monkeypatch):
    """Every validation batch of every epoch of a DAE run reads the one
    validation draw (the best model is chosen on it), while each train
    step draws anew."""
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training import learner as learner_mod
    from srl_zoo_tpu_torch.training import train_step as step_mod
    seen, drawn = [], []
    real_eval, real_draw = learner_mod.eval_step, step_mod.draw_corruption

    def eval_step(model, store, batch, corruption=None, frozen_dae=None):
        seen.append(tuple(c.clone() for c in corruption))
        return real_eval(model, store, batch, corruption, frozen_dae)

    def draw(*args):
        drawn.append(real_draw(*args))
        return drawn[-1]
    monkeypatch.setattr(learner_mod, "eval_step", eval_step)
    monkeypatch.setattr(step_mod, "draw_corruption", draw)
    cfg = SRLConfig.from_exp_config(_jcfg("dae", epochs=2).to_exp_config())
    with _one_torch_thread():
        learner_mod.SRL4robotics(cfg, log_folder=str(tmp_path),
                                 device="cpu").learn(
            load_dataset(synthetic_dataset.data_folder))
    assert len(seen) == 2 * 2  # two validation batches, two epochs
    for corners in seen[1:]:
        assert all(torch.equal(a, b) for a, b in zip(corners, seen[0]))
    assert len(drawn) == 2 * 5
    assert not all(torch.equal(drawn[0][0], d[0]) for d in drawn[1:])


# the two-epoch comparison's lr: 5e-3 (the configs') where two epochs are
# not chaotic at this size, else 1e-4 (test_two_epochs_at_lr_5e3_are_chaotic)
EPOCH_LR = {"dae": 5e-3, "episode-prior": 1e-4, "reward-prior": 1e-4}


@pytest.mark.parametrize("case,lr,chaotic", [
    ("episode-prior", 5e-3, True), ("episode-prior", 1e-4, False),
    ("reward-prior", 5e-3, True), ("reward-prior", 1e-4, False),
    ("dae", 5e-3, False)])
def test_two_epochs_at_lr_5e3_are_chaotic(case, lr, chaotic,
                                          synthetic_dataset, tmp_path):
    """Why the two-epoch comparison of the episode prior and the reward
    prior runs at lr 1e-4: two port runs from initial weights that differ
    by a 1e-6 relative perturbation end their epochs more than 2e-2 apart
    at lr 5e-3 (the adversarial game, and the reward prior's covariance
    over a batch, amplify it), and within 2e-2 at 1e-4; the DAE's are
    within 2e-2 at 5e-3."""
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    cfg = SRLConfig.from_exp_config(_jcfg(
        case, epochs=2, seed=4, learning_rate=lr).to_exp_config())
    ds = load_dataset(synthetic_dataset.data_folder)
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


@pytest.mark.parametrize("case", ["dae", "episode-prior", "reward-prior"])
def test_two_epochs_of_the_learner_match_jax(case, synthetic_dataset,
                                             tmp_path, monkeypatch,
                                             two_pass_bn_variance):
    """The epoch means of the loss history within 2e-2 (every train mean,
    the episode prior's weighted by its pair counts, and the validation
    total) and the same best epoch, at the lr of ``EPOCH_LR``. The port's
    DAE takes JAX's draws: the
    train steps' keys fold in their step into the JAX learner's train
    key, the validation draw comes from its eval key."""
    from srl_zoo_tpu.training.learner import SRL4robotics as JaxLearner
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training import learner as learner_mod
    from srl_zoo_tpu_torch.training import train_step as step_mod
    jcfg = _jcfg(case, epochs=2, seed=4, learning_rate=EPOCH_LR[case])
    jl = JaxLearner(jcfg, log_folder=str(tmp_path / "jax"))
    keys = {}
    for name in ("train_epoch", "eval_epoch"):
        real = getattr(jl, name)

        def record(st, batches, rng, cache, real=real, name=name):
            keys[name] = rng
            return real(st, batches, rng, cache)
        setattr(jl, name, record)
    cfg = SRLConfig.from_exp_config(jcfg.to_exp_config())
    pl = learner_mod.SRL4robotics(cfg, log_folder=str(tmp_path / "port"),
                                  device="cpu")
    sd, _ = bridge.state_dict_from_jax(jax.device_get(jl.state.params),
                                       jax.device_get(jl.state.batch_stats))
    pl.model.load_state_dict(sd)
    jl.learn(synthetic_dataset)
    if cfg.use_dae:
        steps = iter(range(100))
        monkeypatch.setattr(step_mod, "draw_corruption", lambda *a: (
            _jax_corruption(jcfg, _occl_key(keys["train_epoch"],
                                            next(steps)), BS)))
        monkeypatch.setattr(learner_mod, "draw_corruption", lambda *a: (
            _jax_corruption(jcfg, _occl_key(keys["eval_epoch"]), BS)))
    with _one_torch_thread():
        pl.learn(load_dataset(synthetic_dataset.data_folder))
    want = np.load(tmp_path / "jax" / "loss_history.npz")
    got = np.load(tmp_path / "port" / "loss_history.npz")
    assert set(got.files) == set(want.files)
    for k in got.files:
        if k.startswith(("train/", "val/total")):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-2, err_msg=k)
    assert np.argmin(got["val/total"]) == np.argmin(want["val/total"])
