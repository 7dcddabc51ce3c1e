"""``--dtype bfloat16`` in the port against the JAX package's bfloat16
compute, on the CPU at 32 px.

Inputs come from numpy with a seed; weights come from the JAX package's
own init, carried into the port by ``bridge.py`` (a bfloat16 run's
parameters are float32 in both packages). JAX's gradients are its own
train step's (``build_steps`` with an optimizer that keeps the gradients
as its state).

In bfloat16 every layer rounds its output to 8 significant bits, and two
packages that round one intermediate value to neighbouring bfloat16
numbers carry that difference on. The train-mode BatchNorm backward
cancels heavily: one step's gradients stray from the float64 step's by
10-50% (relative L2) in either package. So a bfloat16 result is held the
way ``test_torch_zoo_card_steps.py`` holds the card's ResNet step: both
packages' bfloat16 results against a float64 computation of the same
function (the port's float32 configuration in float64, the same weights
and inputs), and the port's deviation at most twice JAX's own.
Tolerances, each with its reason:

* the plain K1b in bfloat16: equal bit for bit to JAX's ``_bwd_pallas``
  (both add the window gradients in float32 and round once), and within
  the rounding of XLA's select-and-scatter, which rounds each add to
  bfloat16 (at most four addends: four unit roundoffs, 2^-8 each, of the
  sum of the magnitudes added); the forward's y and argmax exact;
* encoder forward: the relative L2 deviation of the output from float64
  at most twice JAX's; the mlp and linear encoders and both decoders,
  whose bfloat16 layers round the same products the same way, also
  directly within 2^-8 (one bfloat16 rounding) of JAX's largest output;
* one train step: the loss, the whole gradient (relative L2), the worst
  tensor (its largest error over its largest float64 magnitude; 1e-2 of
  the model's largest gradient where that is larger) and the BatchNorm
  running statistics each at most twice JAX's deviation from float64.
  The loss is a mean of float32 terms and both deviations lie far below
  bfloat16's unit roundoff; there the limit is that roundoff, 2^-9;
* two epochs of config 1 from JAX's initial weights: the epoch means
  within 2e-2 relative of JAX's bfloat16 run (``EPOCH_RTOL``), the
  float32 two-epoch tests' tolerance (measured: 5e-3).
"""

import copy
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_zoo_tpu.config import SRLConfig as JaxConfig
from srl_zoo_tpu.ops import fused_pool as jax_pool
from srl_zoo_tpu_torch import bridge
from srl_zoo_tpu_torch.config import SRLConfig
from test_torch_zoo_dense import _post, jax_step_grads, port_step
from test_torch_zoo_loss_zoo import _frozen_dae, _jax_corruption, _occl_key
from test_torch_zoo_train import (_cli, _close_rel_max,  # noqa: F401
                                  _jax_state, _one_torch_thread,
                                  _port_model, _second_view,
                                  two_pass_bn_variance)

PX = 32
BS = 16
U_BF16 = 2.0 ** -9  # bfloat16's unit roundoff (8 significant bits)
EPOCH_RTOL = 2e-2


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# (a) the plain K1b in bfloat16
# ---------------------------------------------------------------------------

def _bf16_ulps(a, b) -> int:
    """The largest distance between ``a`` and ``b`` in bfloat16 steps."""
    def ordered(v):
        bits = torch.from_numpy(np.asarray(v, np.float32)).bfloat16().view(
            torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("padding", ["SAME", ((1, 1), (1, 1))])
def test_relu_max_pool_bwd_plain_in_bf16_against_both_jax_backwards(
        padding):
    """Half-integer inputs make ties in most windows, 3x3/2 windows
    overlap, and random cotangents make every sum round. The port's
    plain backward equals JAX's Pallas backward (interpret mode) bit for
    bit; XLA's select-and-scatter (the VJP of ``nn.max_pool``, which
    JAX's models run) rounds each add to bfloat16, and differs from both
    by up to 2 (SAME) and 16 (pads (1, 1), where a sum cancels) bfloat16
    steps, within four unit roundoffs of the magnitudes added."""
    from srl_zoo_tpu_torch.ops.fused_pool import (relu_max_pool_bwd_plain,
                                                  relu_max_pool_plain)
    rng = np.random.RandomState(5)
    shape = (2, 16, 16, 8)
    x = (rng.randint(-3, 4, shape) / 2).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    pads = jax_pool._resolve_pads(16, 16, padding)
    y, idx = jax_pool._fwd_pallas(xb, pads, True)
    g = jnp.asarray(3 * rng.randn(*y.shape), jnp.bfloat16)
    _, vjp = jax.vjp(lambda v: jax_pool.relu_max_pool_reference(
        v, padding), xb)
    dx_xla = np.asarray(vjp(g)[0], np.float32)
    dx_pallas = np.asarray(jax_pool._bwd_pallas(g, idx, shape, pads, True),
                           np.float32)

    xt = torch.from_numpy(x).bfloat16()
    gt = torch.from_numpy(np.asarray(g, np.float32)).bfloat16()
    yt, it = relu_max_pool_plain(xt, padding, with_index=True)
    np.testing.assert_array_equal(yt.float().numpy(),
                                  np.asarray(y, np.float32))
    np.testing.assert_array_equal(
        yt.float().numpy(), np.asarray(jax_pool.relu_max_pool_reference(
            xb, padding), np.float32))
    np.testing.assert_array_equal(it.numpy(), np.asarray(idx))
    dx = relu_max_pool_bwd_plain(gt, it, shape, padding)
    assert dx.dtype == torch.bfloat16
    dx = dx.float().numpy()
    np.testing.assert_array_equal(dx, dx_pallas)
    # the sum of the magnitudes each element of dx adds up
    mag = relu_max_pool_bwd_plain(gt.float().abs(), it, shape,
                                  padding).numpy()
    assert np.all(np.abs(dx - dx_xla) <= 4 * 2.0 ** -8 * mag)
    assert (dx != dx_xla).any()  # the two orders of rounding do differ
    assert _bf16_ulps(dx, dx_xla) == {"SAME": 2}.get(padding, 16)


# ---------------------------------------------------------------------------
# (b) forward of the encoders and decoders
# ---------------------------------------------------------------------------

# CustomCNN, ResNet-18 with each of JAX's two stems, and the dense types
ENCODERS = ("custom_cnn", "resnet-direct", "resnet-s2d", "mlp", "linear")


def _jax_encoder(name: str, dtype):
    from srl_zoo_tpu.models.encoders import make_encoder
    from srl_zoo_tpu.models.resnet import ResNet18
    if name.startswith("resnet"):
        return ResNet18(state_dim=6, dtype=dtype, stem=name.split("-")[1],
                        bn_momentum=0.9)
    return make_encoder(name, 6, dtype=dtype)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", ENCODERS)
def test_bf16_encoder_forward_matches_jax(name, train, two_pass_bn_variance):
    """The output (float32 in both), its deviation from float64, and in
    the conv encoders the pools' inputs: the BatchNorm outputs, bfloat16
    and channels_last (the pool reads them in place)."""
    from srl_zoo_tpu_torch.models.encoders import make_encoder
    from srl_zoo_tpu_torch.models.resnet import ResNet18
    model_type = name.split("-")[0]
    jmodel = _jax_encoder(name, jnp.bfloat16)
    rng = np.random.RandomState(21)
    x = rng.uniform(-1, 1, (8, PX, PX, 3)).astype(np.float32)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, PX, PX, 3)),
                                              train=True))(
        jax.random.PRNGKey(1))
    params = jax.device_get(variables["params"])
    # running statistics made non-trivial (means 0 +- 0.15, variances 1
    # +- 0.15), mildly enough that eval-mode ReLUs stay alive through
    # ResNet-18's BatchNorms at 32 px
    stats = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.uniform(-0.15, 0.15, v.shape)
                   ).astype(np.float32),
        jax.device_get(variables.get("batch_stats", {})))
    want, _ = jmodel.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x), train=train,
                           mutable=["batch_stats"])
    assert want.dtype == jnp.float32
    want = np.asarray(want)
    sd, skipped = bridge.state_dict_from_jax({"encoder": params},
                                             {"encoder": stats})
    assert skipped == []
    sd = {k[len("encoder."):]: v for k, v in sd.items()}

    def port(dtype):
        if model_type == "resnet":  # with the JAX model's stem
            enc = ResNet18(6, 3, dtype=dtype, stem=name.split("-")[1])
        else:
            enc = make_encoder(model_type, 6, 3, PX, PX, dtype=dtype)
        enc.load_state_dict(sd)
        return enc.train(train)
    enc = port(torch.bfloat16)
    bns = list(getattr(enc, "bns", [])) + ([enc.bn1] if hasattr(
        enc, "bn1") else [])
    layouts = []
    hooks = [bn.register_forward_hook(lambda m, i, out: layouts.append(
        (out.dtype, out.is_contiguous(memory_format=torch.channels_last))))
        for bn in bns]
    with torch.no_grad(), _one_torch_thread():
        got = enc(torch.from_numpy(x))
        f64 = port(None).double()(torch.from_numpy(x).double()).numpy()
    for h in hooks:
        h.remove()
    assert layouts == [(torch.bfloat16, True)] * len(bns)
    assert got.dtype == torch.float32
    got = got.numpy()
    port_dev, jax_dev = _rel_l2(got, f64), _rel_l2(want, f64)
    print(f"{name} train={train}: deviation from float64 (relative L2): "
          f"port {port_dev:.3g}, JAX {jax_dev:.3g}")
    assert port_dev <= 2 * jax_dev, (port_dev, jax_dev)
    if model_type in ("mlp", "linear"):
        _close_rel_max(got, want, 2.0 ** -8)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("model_type", ["custom_cnn", "mlp"])
def test_bf16_decoder_forward_matches_jax(model_type, train,
                                          two_pass_bn_variance):
    """CNNDecoder (custom_cnn) and DenseDecoder (mlp) in bfloat16, from
    JAX's init with perturbed BatchNorm statistics: a float32
    reconstruction within 2^-8 of JAX's largest output."""
    jcfg = JaxConfig(state_dim=6, img_height=PX, img_width=PX,
                     model_type=model_type, compute_dtype="bfloat16")
    jmodel, state, _ = _jax_state(jcfg, seed=1, perturb_stats=True)
    _, model = _port_model(jcfg, state)
    model.train(train)
    z = np.random.RandomState(14).randn(5, 6).astype(np.float32)
    want, _ = jmodel.apply({"params": state.params,
                            "batch_stats": state.batch_stats},
                           jnp.asarray(z), train=train,
                           mutable=["batch_stats"],
                           method=lambda m, z, train: m.decoder(
                               z, train=train))
    with torch.no_grad():
        got = model.decoder(torch.from_numpy(z)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close_rel_max(got.numpy(), np.asarray(want), 2.0 ** -8)


# ---------------------------------------------------------------------------
# (c) one train step
# ---------------------------------------------------------------------------

# (losses with split dims, other config fields): configs 1-5, the
# 6-channel --multi-view input, the DAE, the perceptual loss (a float32
# frozen DAE), the episode prior, and the dense model types
STEP_CASES = {
    "autoencoder": ((("autoencoder", -1),), {}),
    "vae": ((("vae", -1),), {}),
    "priors": ((("priors", -1),), {}),
    "splits": ((("autoencoder", 4), ("inverse", 2), ("forward", 1),
                ("reward", 1)), {}),
    "triplet": ((("triplet", -1),), {"model_type": "resnet",
                                     "multi_view": True}),
    "multiview": ((("priors", -1),), {"model_type": "resnet",
                                      "multi_view": True}),
    "dae": ((("dae", -1),), {}),
    "perceptual": ((("perceptual", -1),), {}),
    "episode-prior": ((("episode-prior", -1), ("autoencoder", -1)), {}),
    "mlp": ((("autoencoder", 4), ("inverse", 2), ("forward", 1),
             ("reward", 1)), {"model_type": "mlp",
                              "inverse_model_type": "mlp"}),
    "linear": ((("autoencoder", -1),), {"model_type": "linear"}),
}
WEIGHTS = {"inverse": 2.0, "episode-prior": 0.5}
STEP_BATCH_SEEDS = (36, 37, 38)


def _step_jcfg(case: str) -> JaxConfig:
    losses, extra = STEP_CASES[case]
    return JaxConfig(state_dim=8, img_height=PX, img_width=PX,
                     batch_size=BS, n_actions=4, n_reward_classes=3,
                     losses=tuple((n, WEIGHTS.get(n, 1.0))
                                  for n, _ in losses),
                     split_dims=tuple(losses), compute_dtype="bfloat16",
                     **extra)


def _step_batch(seed: int):
    """A batch of 16 of 64 rows with the metadata of every case."""
    from srl_zoo_tpu_torch.data import samplers
    meta = np.random.RandomState(seed)
    idx = meta.choice(64, BS, replace=False)
    actions = meta.randint(0, 4, BS).astype(np.int32)
    reward_classes = meta.randint(0, 3, BS).astype(np.int32)
    batch = {"indices": idx.astype(np.int32),
             "valid": np.ones(BS, np.float32), "actions": actions,
             "reward_classes": reward_classes,
             "rewards": meta.uniform(0, 1, BS).astype(np.float32),
             "neg_indices": meta.randint(0, 64, BS).astype(np.int32)}
    (batch["same_action_partners"],
     batch["same_action_mask"]) = samplers.find_same_action_pairs(actions,
                                                                  meta)
    (batch["dissimilar_partners"],
     batch["dissimilar_mask"]) = samplers.find_dissimilar_pairs(
        actions, reward_classes, meta)
    (batch["episode_partners"],
     batch["episode_labels"]) = samplers.episode_prior_pairs(idx // 16,
                                                             meta)
    return batch


def _deviations(loss, grads, stats, ref):
    """A step's deviations from the float64 step ``ref`` (loss, grads,
    stats): loss, whole-gradient relative L2, worst tensor, and the
    running statistics' largest relative error."""
    l64, g64, s64 = ref
    floor = 1e-2 * max(float(np.abs(v).max()) for v in g64.values())
    keys = sorted(g64)
    return {
        "loss": abs(loss - l64) / abs(l64),
        "l2": _rel_l2(np.concatenate([grads[k].ravel() for k in keys]),
                      np.concatenate([g64[k].ravel() for k in keys])),
        "worst": max(float(np.abs(grads[k] - g64[k]).max())
                     / max(float(np.abs(g64[k]).max()), floor)
                     for k in keys),
        "stats": max((float(np.abs(stats[k] - s64[k]).max()
                            / np.abs(s64[k]).max()) for k in s64),
                     default=0.0)}


def _port_result(model, total):
    grads = {n: p.grad.double().numpy() for n, p in model.named_parameters()}
    stats = {n: b.double().numpy() for n, b in model.named_buffers()
             if "running" in n}
    return float(total.detach()), grads, stats


def _port_deviations(jcfg, ref_cfg, state, frames, batch, eps, corruption,
                     dae, dae64):
    """(the port's bf16 step's deviations from its float64 step, the
    float64 step's (loss, grads, stats), the step's metric names) on one
    batch."""
    cfg, model = _port_model(jcfg, state)
    assert cfg.compute_dtype == "bfloat16"
    total, metrics = port_step(cfg, model, frames, batch, eps, corruption,
                               dae)
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    _, ref_model = _port_model(ref_cfg, state)
    ref_total, _ = port_step(cfg.replace(compute_dtype="float32"),
                             ref_model.double(), frames, batch, eps,
                             corruption, dae64, torch.float64)
    ref = _port_result(ref_model, ref_total)
    return _deviations(*_port_result(model, total), ref), ref, set(metrics)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_bf16_train_step_matches_jax(case, two_pass_bn_variance):
    """One step from JAX's init on each of three batches; each measure is
    the largest over the three (one batch's loss deviation is a matter of
    where its roundings cancel)."""
    frames = np.random.RandomState(17).randint(0, 256, (64, PX, PX, 3)
                                               ).astype(np.uint8)
    jcfg = _step_jcfg(case)
    jmodel, state, _ = _jax_state(jcfg, seed=2)
    batches = [_step_batch(seed) for seed in STEP_BATCH_SEEDS]
    g = torch.Generator().manual_seed(0)
    eps = [torch.randn((BS, jcfg.state_dim), generator=g).numpy()
           for _ in range(1 + jcfg.needs_next_obs)] if jcfg.use_vae else []
    feature_fn, dae = _frozen_dae() if case == "perceptual" else (None,
                                                                  None)
    jax_steps = jax_step_grads(jcfg, jmodel, state, frames, batches, eps,
                               feature_fn)
    corruption = _jax_corruption(jcfg, _occl_key(jax.random.PRNGKey(0), 0),
                                 BS) if jcfg.use_dae else None
    ref_cfg = jcfg.replace(compute_dtype="float32")
    dae64 = None if dae is None else copy.deepcopy(dae).double()
    got, want = [], []
    with _one_torch_thread():
        port = [_port_deviations(jcfg, ref_cfg, state, frames, batch, eps,
                                 corruption, dae, dae64)
                for batch in batches]
    for (got_d, ref, names), (want_m, want_sd) in zip(port, jax_steps):
        assert names == set(want_m)
        got.append(got_d)
        want.append(_deviations(
            float(want_m["total"]),
            {k: want_sd[k].double().numpy() for k in ref[1]},
            {k: want_sd[k].double().numpy() for k in ref[2]}, ref))
    got = {k: max(d[k] for d in got) for k in got[0]}
    want = {k: max(d[k] for d in want) for k in want[0]}
    print(f"{case}: largest deviation from float64 over "
          f"{len(batches)} batches: port "
          + ", ".join(f"{k} {v:.3g}" for k, v in got.items()) + "; JAX "
          + ", ".join(f"{k} {v:.3g}" for k, v in want.items()))
    over = [k for k in got
            if got[k] > 2 * max(want[k], U_BF16 if k == "loss" else 0.0)]
    assert not over, (over, got, want)


# ---------------------------------------------------------------------------
# (d) the frozen DAE keeps its own dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run_dtype,dae_dtype", [("bfloat16", "float32"),
                                                 ("float32", "bfloat16")])
def test_perceptual_run_reads_the_dae_at_its_own_dtype(
        run_dtype, dae_dtype, synthetic_dataset, tmp_path):
    """A perceptual run of one dtype on a DAE run of the other: the
    frozen DAE is built from the DAE run's own config, so it computes at
    the DAE's dtype (its encode equals a model of that config), and the
    run trains to finite losses."""
    from srl_zoo_tpu_torch.checkpoint import read_state_dict
    from srl_zoo_tpu_torch.models.srl_modules import SRLModules
    from srl_zoo_tpu_torch.training.learner import load_frozen_dae
    data = synthetic_dataset.data_folder
    dae_run = _cli(data, str(tmp_path / "dae"), 1, "--dtype", dae_dtype,
                   losses=("dae",))
    dae = load_frozen_dae(dae_run, torch.device("cpu"))
    want_dt = torch.bfloat16 if dae_dtype == "bfloat16" else None
    assert dae.encoder.compute_dtype is want_dt
    assert not any(p.requires_grad for p in dae.parameters())
    same = SRLModules(SRLConfig.load(dae_run)).eval()
    same.load_state_dict(read_state_dict(dae_run))
    x = torch.rand(4, PX, PX, 3) * 2 - 1
    with torch.no_grad():
        assert torch.equal(dae.encode(x), same.encode(x))
    run = _cli(data, str(tmp_path / "perceptual"), 1, "--dtype", run_dtype,
               "--path-to-dae", dae_run, losses=("perceptual",))
    assert SRLConfig.load(run).compute_dtype == run_dtype
    hist = np.load(os.path.join(run, "loss_history.npz"))
    assert np.isfinite(hist["train/total"]).all()


# ---------------------------------------------------------------------------
# (e) end to end
# ---------------------------------------------------------------------------

def test_bfloat16_compute_end_to_end(synthetic_dataset, tmp_path):
    """JAX's test of the same name (tests/test_loss_matrix.py) on the
    port: autoencoder, inverse and reward on SRL splits in bfloat16
    through the learner: finite losses, a loss that falls, a finite
    float32 export; then ``StateEncoder.encode`` and the server hand out
    float32, an empty batch too (JAX's tests/test_serve.py)."""
    from srl_zoo_tpu_torch.checkpoint import save_srl_model
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.inference import StateEncoder
    from srl_zoo_tpu_torch.serve import build_server
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    ds = load_dataset(synthetic_dataset.data_folder)
    cfg = SRLConfig(state_dim=8, img_height=PX, img_width=PX, batch_size=16,
                    epochs=2, compute_dtype="bfloat16",
                    losses=(("autoencoder", 1.0), ("inverse", 1.0),
                            ("reward", 1.0)),
                    split_dims=(("autoencoder", 4), ("inverse", 2),
                                ("reward", 2)),
                    n_actions=ds.n_actions,
                    n_reward_classes=ds.n_reward_classes,
                    log_folder=str(tmp_path / "bf16"))
    learner = SRL4robotics(cfg, log_folder=cfg.log_folder, device="cpu")
    with _one_torch_thread():
        metrics = learner.learn(ds)
    assert np.isfinite(metrics["total"])
    states = learner.predict_states(ds)
    assert states.dtype == np.float32 and np.all(np.isfinite(states))
    hist = np.load(tmp_path / "bf16" / "loss_history.npz")
    assert hist["train/total"][-1] < hist["train/total"][0]
    assert all(v.dtype == torch.float32
               for v in learner.model.state_dict().values()
               if v.is_floating_point())

    run = str(tmp_path / "bf16")
    save_srl_model(run, learner.model)
    enc = StateEncoder.load(run, max_batch=8, device="cpu")
    frames = np.asarray(ds.frames[:3])
    got = enc.encode(frames)
    assert got.dtype == np.float32 and got.shape == (3, 8)
    np.testing.assert_allclose(got, states[:3], rtol=0, atol=1e-5)
    empty = enc.encode(np.zeros((0, PX, PX, 3), np.uint8))
    assert empty.dtype == np.float32 and empty.shape == (0, 8)
    srv = build_server(run, port=0, coalesce_ms=5, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        served = _post(f"http://127.0.0.1:{srv.server_address[1]}",
                       frames[0])
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(10)
    assert served.dtype == np.float32 and served.shape == (8,)
    np.testing.assert_allclose(served, states[0], rtol=0, atol=1e-5)


# --losses tokens and flags of configs 1-5 and the rest of the zoo
CLI_CASES = {
    "autoencoder": (("autoencoder",), ()),
    "vae": (("vae",), ()),
    "priors": (("priors",), ()),
    "splits": (("autoencoder:1:4", "inverse:2:2", "forward:1:1",
                "reward:1:1"), ()),
    "triplet": (("triplet",), ("--model-type", "resnet", "--multi-view")),
    "dae": (("dae",), ()),
    "episode-prior": (("episode-prior", "autoencoder"),
                      ("--episode-prior-optimizer", "separate")),
    "reward-prior": (("reward-prior", "autoencoder"), ()),
    "supervised": (("supervised:1:2", "autoencoder:1:6"), ()),
    "grad-accum": (("autoencoder",), ("--grad-accum", "2")),
    "random": (("random",), ()),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_trains_in_bf16(case, synthetic_dataset, synthetic_dataset_mv,
                            tmp_path):
    """The train CLI with ``--dtype bfloat16``: the config records it, the
    run trains (but ``random``), and its export is finite float32, within
    1e-5 of the largest state of a direct encode, and scores a finite
    KNN-MSE."""
    from srl_zoo_tpu_torch.evaluation.knn import knn_mse
    from srl_zoo_tpu_torch.inference import StateEncoder
    losses, flags = CLI_CASES[case]
    ds = synthetic_dataset_mv if "--multi-view" in flags \
        else synthetic_dataset
    run = _cli(ds.data_folder, str(tmp_path / "run"), 1, "--dtype",
               "bfloat16", *flags, losses=losses, state_dim=8)
    assert SRLConfig.load(run).compute_dtype == "bfloat16"
    assert JaxConfig.load(run).compute_dtype == "bfloat16"
    hist = np.load(os.path.join(run, "loss_history.npz"))
    assert case == "random" or np.isfinite(hist["train/total"]).all()
    states = np.load(os.path.join(run, "states_rewards.npz"))["states"]
    assert states.dtype == np.float32 and np.isfinite(states).all()
    enc = StateEncoder.load(run, device="cpu")
    frames = np.asarray(ds.frames[:8])
    if enc.cfg.stack_views:
        frames = np.concatenate([frames, np.asarray(ds.frames_2[:8])], -1)
    # export batches (256 rows) and encode chunks (32) may sum in other
    # orders: relative to the states' scale, as the card tests hold it
    _close_rel_max(enc.encode(frames), states[:8], 1e-5)
    score, _, _ = knn_mse(states, ds.ground_truth_states, k=5, device="cpu")
    assert np.isfinite(score)


# ---------------------------------------------------------------------------
# (f) two epochs of config 1
# ---------------------------------------------------------------------------

def test_two_epochs_of_config_1_in_bf16_match_jax(synthetic_dataset,
                                                  tmp_path,
                                                  two_pass_bn_variance):
    """Config 1 in bfloat16 for two epochs (lr 5e-3, ten Adam steps) from
    JAX's initial weights, in both packages: every epoch mean of the loss
    history within EPOCH_RTOL relative of JAX's, and the same best
    epoch."""
    from srl_zoo_tpu.training.learner import SRL4robotics as JaxLearner
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    jcfg = JaxConfig(state_dim=4, img_height=PX, img_width=PX,
                     batch_size=BS, epochs=2, seed=4, learning_rate=5e-3,
                     compute_dtype="bfloat16",
                     n_actions=synthetic_dataset.n_actions,
                     n_reward_classes=synthetic_dataset.n_reward_classes)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jl = JaxLearner(jcfg, log_folder=jdir)
    cfg = SRLConfig.from_exp_config(jcfg.to_exp_config())
    assert cfg.compute_dtype == "bfloat16"
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
        if k.startswith(("train/", "val/")):
            print(k, got[k], want[k])
            np.testing.assert_allclose(got[k], want[k], rtol=EPOCH_RTOL,
                                       err_msg=k)
    assert np.argmin(got["val/total"]) == np.argmin(want["val/total"])
