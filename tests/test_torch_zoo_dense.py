"""The port's mlp and linear model types (``DenseEncoder``,
``LinearEncoder``, ``DenseDecoder``) against the JAX package, on the CPU
at 32 px.

Inputs come from numpy with a seed, or from the shared 32 px synthetic
datasets; weights come from the JAX package's own init, carried into the
port by ``bridge.py``. JAX's gradients are its own train step's
(``build_steps``, with an optimizer that keeps the gradients as its
state). Tolerances, each with its reason:

* the modules' forward: within 1e-5 of the output's largest magnitude
  (the same float32 products, summed in another order);
* one train step: the loss within 1e-5 relative and each gradient within
  1e-4 of its tensor's largest magnitude, as the other configs' steps in
  test_torch_zoo_train.py (backward sums compound the forward's
  rounding; the first Dense sums 3,072 or 6,144 products);
* a bridged JAX run: the port's encode within 1e-5 of JAX's;
* the train CLI's run: exported and served states within 1e-5 of a
  direct encode, KNN-MSE within 1e-6 of JAX's on the same states.
"""

import io
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_zoo_tpu.config import SRLConfig as JaxConfig
from srl_zoo_tpu_torch import bridge
from srl_zoo_tpu_torch.config import SRLConfig
from test_torch_zoo_loss_zoo import _as_jax, _fresh, _keep_grads
from test_torch_zoo_train import (_check_grads, _cli, _close_rel_max,
                                  _jax_normal_returns, _jax_state,
                                  _np_batch, _port_model, _second_view)

PX = 32
BS = 16
STATE_DIM = 4


# ---------------------------------------------------------------------------
# (a) the modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [3, 6])
@pytest.mark.parametrize("model_type", ["mlp", "linear"])
def test_dense_modules_match_jax(model_type, channels):
    """The encoder of ``model_type`` and the DenseDecoder, each from JAX's
    init through the bridge: forward within 1e-5 of the largest output;
    the encoder flattens the NHWC frame in flax's (H, W, C) order."""
    from srl_zoo_tpu.models.decoders import DenseDecoder as JaxDecoder
    from srl_zoo_tpu.models.encoders import make_encoder as jax_encoder
    from srl_zoo_tpu_torch.models.decoders import DenseDecoder
    from srl_zoo_tpu_torch.models.encoders import (DenseEncoder,
                                                   LinearEncoder,
                                                   make_encoder)
    rng = np.random.RandomState(31)
    x = rng.uniform(-1, 1, (5, PX, PX, channels)).astype(np.float32)
    z = rng.randn(5, STATE_DIM).astype(np.float32)
    jenc = jax_encoder(model_type, STATE_DIM)
    jdec = JaxDecoder(img_height=PX, img_width=PX, out_channels=channels)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    penc = jenc.init(k1, jnp.asarray(x))["params"]
    pdec = jdec.init(k2, jnp.asarray(z))["params"]
    sd, skipped = bridge.state_dict_from_jax(
        jax.device_get({"encoder": penc, "decoder": pdec}), {})
    assert skipped == []
    enc = make_encoder(model_type, STATE_DIM, channels, PX, PX)
    assert type(enc) is {"mlp": DenseEncoder,
                         "linear": LinearEncoder}[model_type]
    assert len(enc.layers) == {"mlp": 3, "linear": 1}[model_type]
    dec = DenseDecoder(STATE_DIM, PX, PX, channels)
    for part, module in (("encoder.", enc), ("decoder.", dec)):
        module.load_state_dict({k[len(part):]: v for k, v in sd.items()
                                if k.startswith(part)})
    want = np.asarray(jenc.apply({"params": penc}, jnp.asarray(x)))
    got = enc(torch.from_numpy(x))
    _close_rel_max(got.detach().numpy(), want, 1e-5)
    want = np.asarray(jdec.apply({"params": pdec}, jnp.asarray(z)))
    got = dec(torch.from_numpy(z))
    assert got.shape == (5, channels, PX, PX)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close_rel_max(got.permute(0, 2, 3, 1).detach().numpy(), want, 1e-5)


# ---------------------------------------------------------------------------
# (b) one train step, from JAX's create_train_state weights
# ---------------------------------------------------------------------------

# (losses, split dimensions); "multiview" stacks both camera views into a
# 6-channel input (the decoder reconstructs all six)
CASES = {
    "autoencoder": ((("autoencoder", 1.0),), (("autoencoder", -1),)),
    "vae": ((("vae", 1.0),), (("vae", -1),)),
    "priors": ((("priors", 1.0),), (("priors", -1),)),
    "splits": ((("autoencoder", 1.0), ("inverse", 2.0), ("forward", 1.0),
                ("reward", 1.0)),
               (("autoencoder", 4), ("inverse", 2), ("forward", 1),
                ("reward", 1))),
    "multiview": ((("autoencoder", 1.0),), (("autoencoder", -1),)),
}


def _frames():
    return np.random.RandomState(17).randint(0, 256, (64, PX, PX, 3)
                                             ).astype(np.uint8)


def _jcfg(case, model_type, **kw):
    losses, splits = CASES[case]
    return JaxConfig(state_dim=8, losses=losses, split_dims=splits,
                     img_height=PX, img_width=PX, batch_size=BS,
                     n_actions=4, n_reward_classes=3, model_type=model_type,
                     multi_view=case == "multiview", **kw)


def _batch(jcfg):
    meta = np.random.RandomState(19)
    actions = meta.randint(0, 4, 64).astype(np.int32)
    reward_classes = meta.randint(0, 3, 64).astype(np.int32)
    idx = np.random.RandomState(15).choice(64, BS, replace=False)
    return _np_batch(idx, actions, reward_classes,
                     meta if jcfg.use_priors else None)


def _vae_eps(jcfg):
    """The VAE's eps of the port's step with a generator seeded 0."""
    if not jcfg.use_vae:
        return []
    g = torch.Generator().manual_seed(0)
    return [torch.randn((BS, jcfg.state_dim), generator=g).numpy()
            for _ in range(1 + jcfg.needs_next_obs)]


def jax_step_grads(jcfg, jmodel, state, frames, batches, eps,
                   feature_fn=None):
    """[(JAX's train-step metrics, port-named gradients and updated
    BatchNorm statistics)] of one step of JAX's ``build_steps`` from
    ``state`` on each of ``batches``, with the key PRNGKey(0) (its DAE
    draws: test_torch_zoo_loss_zoo.py ``_occl_key``) and the VAE's draws
    replaced by ``eps``, which the first call's trace bakes in."""
    from srl_zoo_tpu.training.train_step import build_steps
    tx = _keep_grads()
    cache = {"frames": jnp.asarray(frames),
             "frames_2": jnp.asarray(_second_view(frames))}
    step = build_steps(jcfg, jmodel, tx, dae_feature_fn=feature_fn)[0]
    out = []
    for i, batch in enumerate(batches):
        with _jax_normal_returns(eps if i == 0 else []):
            new, metrics = step(_fresh(state, tx), _as_jax(batch),
                                jax.random.PRNGKey(0), cache)
        sd, _ = bridge.state_dict_from_jax(jax.device_get(new.opt_state),
                                           jax.device_get(new.batch_stats))
        out.append((metrics, sd))
    return out


def port_step(cfg, model, frames, batch, eps, corruption=None,
              frozen_dae=None, dtype=torch.float32):
    """(total, metrics) of one train-mode step of the port's ``model``
    (gradients in ``.grad``), its inputs in ``dtype``."""
    from srl_zoo_tpu_torch.training.train_step import _inputs, _loss
    model.train()
    store = {"frames": torch.from_numpy(frames),
             "frames_2": torch.from_numpy(_second_view(frames))}
    inputs = _inputs(model, store, batch, torch.Generator().manual_seed(0))
    for k in ("obs", "next_obs", "pos_obs", "neg_obs"):
        if inputs[k] is not None:
            inputs[k] = inputs[k].to(dtype)
    if eps:
        inputs["noise"] = {k: torch.from_numpy(e).to(dtype) for k, e in
                           zip(("state", "next_state"), eps)}
    if corruption is not None:
        inputs["corruption"] = corruption
    total, metrics = _loss(model, inputs, frozen_dae)
    total.backward()
    return total, metrics


@pytest.mark.parametrize("model_type", ["mlp", "linear"])
@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case, model_type):
    frames = _frames()
    jcfg = _jcfg(case, model_type)
    jmodel, state, _ = _jax_state(jcfg, seed=2)
    batch = _batch(jcfg)
    eps = _vae_eps(jcfg)
    (want_m, want_sd), = jax_step_grads(jcfg, jmodel, state, frames,
                                        [batch], eps)
    cfg, model = _port_model(jcfg, state)
    assert cfg.n_channels == (6 if case == "multiview" else 3)
    total, metrics = port_step(cfg, model, frames, batch, eps)
    np.testing.assert_allclose(float(total.detach()),
                               float(want_m["total"]), rtol=1e-5)
    for k, v in want_m.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    _check_grads(model, want_sd)


# ---------------------------------------------------------------------------
# (c) the bridge: a JAX mlp or linear run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_type", ["mlp", "linear"])
def test_bridge_converts_a_jax_dense_run(model_type, synthetic_dataset,
                                         tmp_path):
    """A JAX run of the model type (autoencoder: encoder and decoder)
    converts with no skipped key; the port encodes and decodes as JAX."""
    import train as jax_train
    from srl_zoo_tpu.models.srl_modules import SRLModules as JaxModules
    from srl_zoo_tpu.training import checkpoint as jax_ckpt
    from srl_zoo_tpu_torch.checkpoint import load_srl_model
    run = str(tmp_path / "run")
    jax_train.main(["--data-folder", synthetic_dataset.data_folder,
                    "--losses", "autoencoder", "--model-type", model_type,
                    "--epochs", "1", "--state-dim", str(STATE_DIM), "-bs",
                    str(BS), "--log-folder", run, "--no-display-plots"])
    _, skipped = bridge.convert_run(run)
    assert skipped == []
    jcfg = JaxConfig.load(run)
    jmodel, jstate, _ = jax_ckpt.load_srl_model(run, jcfg)
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    _, model = load_srl_model(run, torch.device("cpu"))
    x = np.asarray(synthetic_dataset.frames[:BS]).astype(np.float32) * \
        (2.0 / 255.0) - 1.0
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                   method=JaxModules.encode))
    with torch.no_grad():
        got = model.encode(torch.from_numpy(x)).numpy()
        recon = model.decoder(torch.from_numpy(want.copy())).permute(
            0, 2, 3, 1)
    _close_rel_max(got, want, 1e-5)
    want_recon = np.asarray(jmodel.apply(
        variables, jnp.asarray(want), train=False,
        method=lambda m, z, train: m.decoder(z, train=train)))
    _close_rel_max(recon.numpy(), want_recon, 1e-5)


# ---------------------------------------------------------------------------
# (d) the train CLI, export, serve and KNN-MSE
# ---------------------------------------------------------------------------

# model type -> the --losses of its run (mlp: config 1's, linear: config
# 3's on the same dataset)
CLI_RUNS = {"mlp": ("autoencoder",), "linear": ("priors",)}


@pytest.fixture(scope="module")
def dense_runs(synthetic_dataset, tmp_path_factory):
    runs = {}

    def run(model_type):
        if model_type not in runs:
            runs[model_type] = _cli(
                synthetic_dataset.data_folder,
                str(tmp_path_factory.mktemp(model_type) / "run"), 2,
                "--model-type", model_type, losses=CLI_RUNS[model_type])
        return runs[model_type]
    return run


def _post(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(f"{url}/encode", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.load(io.BytesIO(r.read()))


@pytest.mark.parametrize("model_type", ["mlp", "linear"])
def test_cli_trains_exports_serves_and_scores(model_type, dense_runs,
                                              synthetic_dataset):
    from srl_zoo_tpu.evaluation.knn import knn_mse as jax_knn_mse
    from srl_zoo_tpu_torch.evaluation.knn import knn_mse
    from srl_zoo_tpu_torch.inference import StateEncoder
    from srl_zoo_tpu_torch.serve import build_server
    run = dense_runs(model_type)
    cfg = SRLConfig.load(run)
    assert (cfg.model_type, cfg.compute_dtype) == (model_type, "float32")
    assert JaxConfig.load(run).model_type == model_type
    hist = np.load(os.path.join(run, "loss_history.npz"))
    assert hist["train/total"][-1] < hist["train/total"][0]
    states = np.load(os.path.join(run, "states_rewards.npz"))["states"]
    frames = np.asarray(synthetic_dataset.frames)
    enc = StateEncoder.load(run, device="cpu")
    np.testing.assert_allclose(states, enc.encode(frames), rtol=0,
                               atol=1e-5)
    srv = build_server(run, port=0, coalesce_ms=5, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        served = _post(f"http://127.0.0.1:{srv.server_address[1]}",
                       frames[:6])
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(10)
    assert served.dtype == np.float32
    np.testing.assert_allclose(served, states[:6], rtol=0, atol=1e-5)
    gt = synthetic_dataset.ground_truth_states
    got, _, _ = knn_mse(states, gt, k=5, device="cpu")
    want, _, _ = jax_knn_mse(states, gt, k=5)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("run", ["mlp", "bf16"])
def test_enjoy_latent_decodes_dense_and_bf16_runs(run, dense_runs,
                                                 synthetic_dataset,
                                                 tmp_path):
    """``enjoy_latent`` on the mlp run (DenseDecoder) and on a bfloat16
    config-1 run: the PNG is written, the sweeps are float32 frames in
    [0, 1], and the middle column (the mean state) is within 1e-5 of its
    largest value of a direct decode of the mean state (a batch of six
    and a batch of one sum their products in other orders)."""
    from srl_zoo_tpu_torch import checkpoint as ckpt
    from srl_zoo_tpu_torch.evaluation import enjoy_latent
    folder = dense_runs("mlp") if run == "mlp" else _cli(
        synthetic_dataset.data_folder, str(tmp_path / "bf16"), 1,
        "--dtype", "bfloat16")
    out = enjoy_latent.main(["--log-folder", folder, "--n-dims", "2",
                             "--n-steps", "3", "--device", "cpu"])
    assert os.path.getsize(out) > 0
    cfg, model = ckpt.load_srl_model(folder, torch.device("cpu"))
    states = np.load(os.path.join(folder, "states_rewards.npz"))["states"]
    grid = enjoy_latent.latent_sweep_grid(cfg, model, states, 2, 3)
    assert grid.shape == (2, 3, PX, PX, 3) and grid.dtype == np.float32
    assert grid.min() >= 0.0 and grid.max() <= 1.0
    direct = enjoy_latent.decode_states(cfg, model, states.mean(0)[None])
    _close_rel_max(grid[:, 1], np.repeat(direct, 2, 0), 1e-5)
