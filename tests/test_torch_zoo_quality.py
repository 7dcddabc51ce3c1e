"""Trained quality of the port against the JAX package, on the CPU.

Configs 1 (autoencoder), 2 (vae), 3 (priors) and 5 (triplet, ResNet-18,
two camera views), the denoising autoencoder (dae), and the reward prior
and the episode prior each beside the autoencoder, train in both packages
with the golden settings of ``tests/test_golden.py`` (4 epochs, lr 3e-3,
batch 16, state_dim 4, seed 1) on the 32 px synthetic datasets, from the
same initial weights (JAX's init, carried into the port by
``bridge.py``) and the same batches. The port's states must then

* pass JAX's own golden gates unchanged: autoencoder KNN-MSE < 0.02 and
  GTC > 0.7, priors KNN-MSE < 0.03, VAE KNN-MSE < 0.025 and GTC > 0.55,
  triplet KNN-MSE < 0.02, DAE KNN-MSE < 0.04 and GTC > 0.5, reward prior
  KNN-MSE < 0.04 and GTC > 0.55 (KNN-MSE with k = 3, as the gates take
  it), and the episode prior's last train discriminator BCE within 0.12
  of ln 2;
* score within ``TOLERANCE`` of JAX's KNN-MSE and GTC.

The tolerance is twice JAX's own spread: the largest deviation of a JAX
run from its unperturbed run over three reruns whose initial weights are
perturbed by 1e-6 relative (numpy seeds 0, 1, 2, each weight times 1 +
1e-6 N(0, 1)), and for the VAE and the DAE, whose noise (the VAE's eps,
the DAE's occlusion) each package draws from its own generator, also
over three reruns with other noise keys (PRNGKey(1000 + i)). ``python tests/test_torch_zoo_quality.py`` measures
it and prints these lines. Measured on the CPU (8 virtual JAX devices, as
the tests run), JAX with the two-pass BatchNorm variance (see
``two_pass_bn_variance`` in test_torch_zoo_train.py):

    config       JAX knn    JAX gtc   spread knn  spread gtc
    autoencoder  0.008007   0.8017    0.005285    0.01745
    vae          0.01083    0.6651    0.0117      0.07632
    priors       0.002967   0.7313    0.002302    0.08215
    triplet      0.004863   0.7137    0.01983     0.3277
    dae          0.01937    0.7576    0.01168     0.1102
    reward-prior 0.03495    0.7327    0.008357    0.03616
    episode-prior 0.00732   0.6439    0.008692    0.1485

(TOLERANCE holds twice these spreads.) The port's scores in the same
runs, beside these, are in PERF.md's findings.
"""

import os
import sys

if __name__ == "__main__":  # the spread measurement, as the tests run JAX
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from srl_zoo_tpu_torch import bridge  # noqa: E402
from srl_zoo_tpu_torch.config import SRLConfig  # noqa: E402

EPOCHS, LR, BS, STATE_DIM, SEED = 4, 3e-3, 16, 4, 1
K = 3  # the golden gates' neighbours
# config: (losses, multi-view ResNet-18)
CONFIGS = {"autoencoder": (("autoencoder",), False),
           "vae": (("vae",), False), "priors": (("priors",), False),
           "triplet": (("triplet",), True), "dae": (("dae",), False),
           "reward-prior": (("reward-prior", "autoencoder"), False),
           "episode-prior": (("episode-prior", "autoencoder"), False)}
# the configs whose noise each package draws from its own generator
NOISY = ("vae", "dae")
# JAX's golden gates (tests/test_golden.py): KNN-MSE below, GTC above
GATES = {"autoencoder": (0.02, 0.7), "vae": (0.025, 0.55),
         "priors": (0.03, None), "triplet": (0.02, None),
         "dae": (0.04, 0.5), "reward-prior": (0.04, 0.55),
         "episode-prior": (None, None)}
# the episode prior's gate: its last train discriminator BCE within this
# of ln 2, the equilibrium of a discriminator that can no longer tell
DISC_GATE = 0.12
# twice JAX's spread (module docstring): (KNN-MSE, GTC), absolute
TOLERANCE = {"autoencoder": (0.01057, 0.0349), "vae": (0.0234, 0.1526),
             "priors": (0.004604, 0.1643), "triplet": (0.03966, 0.6554),
             "dae": (0.02336, 0.2204), "reward-prior": (0.01671, 0.07232),
             "episode-prior": (0.01738, 0.297)}


def _jax_cfg(name, ds):
    from srl_zoo_tpu.config import SRLConfig as JaxConfig
    losses, two_views = CONFIGS[name]
    views = {"model_type": "resnet", "multi_view": True} if two_views else {}
    return JaxConfig(state_dim=STATE_DIM, img_height=32, img_width=32,
                     batch_size=BS, epochs=EPOCHS, learning_rate=LR,
                     losses=tuple((n, 1.0) for n in losses),
                     split_dims=tuple((n, -1) for n in losses),
                     n_actions=ds.n_actions,
                     n_reward_classes=ds.n_reward_classes, seed=SEED,
                     **views)


def _scores(states, ds):
    from srl_zoo_tpu.evaluation.gtc import ground_truth_correlation
    from srl_zoo_tpu.evaluation.knn import knn_mse
    knn, _, _ = knn_mse(states, ds.ground_truth_states, k=K)
    gtc, _ = ground_truth_correlation(states, ds.ground_truth_states)
    return knn, gtc


def _jax_learner(name, ds, folder):
    from srl_zoo_tpu.training.learner import SRL4robotics as JaxLearner
    return JaxLearner(_jax_cfg(name, ds), log_folder=folder)


def _perturbed(learner, seed, eps=1e-6):
    """Each initial weight of a JAX learner times 1 + eps N(0, 1)."""
    rng = np.random.RandomState(seed)

    def perturb(v):
        host = np.asarray(v)
        out = host * (1 + eps * rng.standard_normal(host.shape))
        return jax.device_put(out.astype(host.dtype), v.sharding)
    learner.state = learner.state.replace(
        params=jax.tree_util.tree_map(perturb, learner.state.params))


def _jax_run(name, ds, folder, perturb_seed=None, noise_key=None):
    """(KNN-MSE, GTC) of one JAX golden training."""
    learner = _jax_learner(name, ds, folder)
    if perturb_seed is not None:
        _perturbed(learner, perturb_seed)
    if noise_key is not None:
        learner.rng = jax.random.PRNGKey(noise_key)
    learner.learn(ds)
    return _scores(learner.predict_states(ds), ds)


def _two_pass_bn():
    """flax's BatchNorm with the two-pass batch variance (what
    ``two_pass_bn_variance`` patches in); returns the undo."""
    from flax.linen import normalization
    one_pass = normalization._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return one_pass(*args, **kwargs)
    normalization._compute_stats = two_pass
    return lambda: setattr(normalization, "_compute_stats", one_pass)


@pytest.fixture
def two_pass_bn_variance():
    undo = _two_pass_bn()
    yield
    undo()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trained_quality_matches_jax(name, request, tmp_path,
                                     two_pass_bn_variance):
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.evaluation.gtc import ground_truth_correlation
    from srl_zoo_tpu_torch.evaluation.knn import knn_mse
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    jds = request.getfixturevalue("synthetic_dataset_mv" if CONFIGS[name][1]
                                  else "synthetic_dataset")
    jl = _jax_learner(name, jds, str(tmp_path / "jax"))
    cfg = SRLConfig.from_exp_config(jl.cfg.to_exp_config())
    pl = SRL4robotics(cfg, log_folder=str(tmp_path / "port"), device="cpu")
    sd, _ = bridge.state_dict_from_jax(jax.device_get(jl.state.params),
                                       jax.device_get(jl.state.batch_stats))
    pl.model.load_state_dict(sd)
    jl.learn(jds)
    want = _scores(jl.predict_states(jds), jds)

    ds = load_dataset(jds.data_folder)
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # xdist runs several workers per machine
    try:
        pl.learn(ds)
    finally:
        torch.set_num_threads(n)
    states = pl.predict_states(ds)
    knn, _, _ = knn_mse(states, ds.ground_truth_states, k=K, device="cpu")
    gtc, _ = ground_truth_correlation(states, ds.ground_truth_states)
    print(f"{name}: port knn {knn:.6g} gtc {gtc:.6g}; JAX knn {want[0]:.6g} "
          f"gtc {want[1]:.6g}")

    knn_gate, gtc_gate = GATES[name]
    if knn_gate is not None:
        assert knn < knn_gate, f"{name}: KNN-MSE gate: {knn}"
    if gtc_gate is not None:
        assert gtc > gtc_gate, f"{name}: GTC gate: {gtc}"
    if name == "episode-prior":
        disc = float(np.load(tmp_path / "port" / "loss_history.npz")[
            "train/episode-prior/discriminator"][-1])
        print(f"{name}: port last train discriminator BCE {disc:.6g}")
        assert abs(disc - np.log(2.0)) < DISC_GATE, (name, disc)
    tol_knn, tol_gtc = TOLERANCE[name]
    assert abs(knn - want[0]) <= tol_knn, (name, knn, want[0])
    assert abs(gtc - want[1]) <= tol_gtc, (name, gtc, want[1])


def measure_spread(names, folder: str) -> None:
    """JAX's spread per config (module docstring), printed."""
    from srl_zoo_tpu.data.schema import load_dataset
    from srl_zoo_tpu.data.synthetic import generate_dataset
    sets = {}
    for mv in (False, True):
        path = os.path.join(folder, f"synth{'_mv' * mv}")
        generate_dataset(path, n_episodes=4, episode_len=24, img_size=32,
                         seed=0, multi_view=mv)
        sets[mv] = load_dataset(path)
    _two_pass_bn()
    print("config       JAX knn    JAX gtc   spread knn  spread gtc")
    for name in names:
        ds = sets[CONFIGS[name][1]]
        run = os.path.join(folder, name)
        base = _jax_run(name, ds, run + "_base")
        others = [_jax_run(name, ds, f"{run}_p{s}", perturb_seed=s)
                  for s in range(3)]
        if name in NOISY:
            others += [_jax_run(name, ds, f"{run}_n{s}", noise_key=1000 + s)
                       for s in range(3)]
        dk = max(abs(o[0] - base[0]) for o in others)
        dg = max(abs(o[1] - base[1]) for o in others)
        print(f"{name:12s} {base[0]:<10.4g} {base[1]:<9.4g} {dk:<11.4g} "
              f"{dg:.4g}", flush=True)


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        measure_spread(sys.argv[1:] or list(CONFIGS), tmp)
