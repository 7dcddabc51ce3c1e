"""The port's pipeline slice against the JAX package, on the CPU at 32 px:
``knn_images``, ``predict_reward``, ``enjoy_latent``, the plots, the
pipeline and its helpers, and the asynchronous checkpoint writer.

Tolerances, each with its reason:

* KNN-MSE: 1e-6 relative; neighbour indices equal except where two
  candidates' distances are within 1e-5 relative (a near tie, counted):
  the port centres the states before the product, JAX does not.
* Reward probe: the same accuracy exactly. The port carries its own
  stratified split and L2 logistic regression (it does not depend on
  scikit-learn); both minimise the same convex objective from zero
  weights, so the same rows are predicted alike.
* Latent sweeps: 1e-4. Two decoders' f32 transposed convolutions sum in
  other orders.
* The PCA projection of the plots: 1e-5. The same numpy computation.
"""

import argparse
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from srl_zoo_tpu_torch import bridge, checkpoint as ckpt
from srl_zoo_tpu_torch.config import SRLConfig

STATE_DIM, BS = 4, 16


@pytest.fixture(scope="module")
def port_run(trained_ae_cli_run, tmp_path_factory):
    """A copy of the shared JAX run with srl_model.pth from the bridge
    (the eval CLIs write into it)."""
    run = str(tmp_path_factory.mktemp("pipe") / "run")
    shutil.copytree(trained_ae_cli_run, run)
    bridge.main(["--log-folder", run])
    return run


@pytest.fixture(scope="module")
def jpg_dataset(tmp_path_factory):
    """The shared synthetic dataset again, with its JPEGs on disk."""
    from srl_zoo_tpu.data.synthetic import generate_dataset
    folder = str(tmp_path_factory.mktemp("jpg") / "synth")
    generate_dataset(folder, n_episodes=4, episode_len=24, img_size=32,
                     seed=0, save_jpgs=True)
    return folder


@pytest.fixture(scope="module")
def pipe_dataset(tmp_path_factory):
    """A small dataset of its own for the pipeline runs (with JPEGs)."""
    from srl_zoo_tpu.data.synthetic import generate_dataset
    folder = str(tmp_path_factory.mktemp("pipe_ds") / "synth")
    generate_dataset(folder, n_episodes=3, episode_len=16, img_size=32,
                     seed=0, save_jpgs=True)
    return folder


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # xdist runs several workers per machine
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# knn_images
# ---------------------------------------------------------------------------

def _main_capturing(module, monkeypatch, argv):
    """``module.main(argv)`` with its neighbour-grid call recorded: (score,
    queries, neighbour indices)."""
    seen = {}
    real = module.save_neighbor_grids

    def record(data_folder, images_path, queries, neighbors, out, n_grids):
        seen["q"], seen["n"] = np.asarray(queries), np.asarray(neighbors)
        real(data_folder, images_path, queries, neighbors, out, n_grids)
    monkeypatch.setattr(module, "save_neighbor_grids", record)
    return module.main(argv), seen["q"], seen["n"]


def _near_tie_mismatches(states, queries, got, want, rtol=1e-5) -> int:
    """Positions where the neighbour lists differ; each must be a near
    tie: the two candidates' squared distances within ``rtol``."""
    s = np.asarray(states, np.float64)
    bad = np.argwhere(got != want)
    for qi, j in bad:
        q = s[queries[qi]]
        da = np.sum((s[got[qi, j]] - q) ** 2)
        db = np.sum((s[want[qi, j]] - q) ** 2)
        assert abs(da - db) <= rtol * max(da, db, 1e-12), (qi, j, da, db)
    return len(bad)


@pytest.mark.parametrize("jpgs", [True, False], ids=["jpgs", "no-jpgs"])
@pytest.mark.parametrize("n_samples,seed", [(-1, 0), (40, 3)])
def test_knn_images_matches_jax(port_run, jpg_dataset, tmp_path,
                                monkeypatch, jpgs, n_samples, seed):
    from srl_zoo_tpu.evaluation import knn_images as jax_knn_images
    from srl_zoo_tpu_torch.evaluation import knn_images
    runs = {}
    for side in ("jax", "port"):
        runs[side] = str(tmp_path / side)
        shutil.copytree(port_run, runs[side])
    flags = ["-k", "5", "--n-samples", str(n_samples), "--seed", str(seed),
             "--n-grids", "2"] + (["--data-folder", jpg_dataset] if jpgs
                                  else [])
    want, wq, wn = _main_capturing(jax_knn_images, monkeypatch,
                                   ["--log-folder", runs["jax"], *flags])
    got, gq, gn = _main_capturing(knn_images, monkeypatch,
                                  ["--log-folder", runs["port"], *flags,
                                   "--device", "cpu"])
    states = np.load(os.path.join(port_run, "states_rewards.npz"))["states"]
    np.testing.assert_array_equal(gq, wq)
    ties = _near_tie_mismatches(states, gq, gn, wn)
    print(f"knn_images: {ties} neighbour indices differ at near ties")
    assert abs(got - want) <= 1e-6 * abs(want)
    with open(os.path.join(runs["port"], "knn_mse.json")) as f:
        assert json.load(f) == {"knn_mse": got, "k": 5}
    grids = [os.path.join(runs["port"], "NearestNeighbors",
                          f"knn_grid_{g}.png") for g in range(2)]
    assert all(os.path.getsize(p) > 0 for p in grids)
    # the query's tile: a decoded frame, or the grey "no image" tile
    import cv2
    tile = cv2.imread(grids[0])[30:170, 10:150]
    assert (np.mean(tile == 235) > 0.8) == (not jpgs)


def test_knn_images_checks_lengths_and_device(port_run, tmp_path):
    from srl_zoo_tpu_torch.evaluation import knn_images
    run = str(tmp_path / "run")
    shutil.copytree(port_run, run)
    sr = np.load(os.path.join(run, "states_rewards.npz"))
    np.savez(os.path.join(run, "states_rewards.npz"),
             states=sr["states"][:-1], rewards=sr["rewards"][:-1])
    with pytest.raises(ValueError, match="ground-truth entries"):
        knn_images.main(["--log-folder", run, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            knn_images.main(["--log-folder", run])
    assert not os.path.exists(os.path.join(run, "knn_mse.json"))


# ---------------------------------------------------------------------------
# predict_reward
# ---------------------------------------------------------------------------

def _reward_cases():
    rng = np.random.RandomState(5)
    states = rng.randn(120, 6).astype(np.float32)
    three = rng.randint(0, 3, 120).astype(np.float32)
    states3 = states + three[:, None] * rng.rand(6).astype(np.float32)
    one_row = np.zeros(60, np.float32)
    one_row[7] = 2.0  # a class of one row: the split is not stratified
    return {"three-classes": (states3, three, 0.2, 0),
            "other-seed": (states3, three, 0.3, 7),
            "one-row-class": (states[:60], one_row, 0.2, 1),
            "single-class": (states[:30], np.ones(30, np.float32), 0.2, 0)}


@pytest.mark.parametrize("case", list(_reward_cases()))
def test_predict_reward_matches_jax(case):
    from srl_zoo_tpu.evaluation.predict_reward import \
        predict_reward_accuracy as jax_accuracy
    from srl_zoo_tpu_torch.evaluation.predict_reward import \
        predict_reward_accuracy
    states, rewards, test_size, seed = _reward_cases()[case]
    got = predict_reward_accuracy(states, rewards, test_size, seed)
    assert got == jax_accuracy(states, rewards, test_size, seed)
    if case == "single-class":
        assert got == 1.0


@pytest.mark.parametrize("stratify", [True, False])
def test_reward_probe_split_is_sklearns(stratify):
    from sklearn.model_selection import train_test_split
    from srl_zoo_tpu_torch.evaluation.predict_reward import split_rows
    y = np.random.RandomState(2).randint(0, 4, 103)
    for seed in range(4):
        want = train_test_split(np.arange(len(y)), test_size=0.2,
                                random_state=seed,
                                stratify=y if stratify else None)
        got = split_rows(y, 0.2, seed, stratify)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_predict_reward_cli_matches_jax(port_run, tmp_path):
    from srl_zoo_tpu.evaluation import predict_reward as jax_predict_reward
    from srl_zoo_tpu_torch.evaluation import predict_reward
    run = str(tmp_path / "run")
    shutil.copytree(port_run, run)
    got = predict_reward.main(["--log-folder", run])
    with open(os.path.join(run, "reward_accuracy.json")) as f:
        assert json.load(f) == {"accuracy": got}
    jrun = str(tmp_path / "jax")
    shutil.copytree(port_run, jrun)
    want = jax_predict_reward.main(["--log-folder", jrun])
    assert got == want and 0.0 <= got <= 1.0


# ---------------------------------------------------------------------------
# enjoy_latent
# ---------------------------------------------------------------------------

def test_latent_sweep_grid_matches_jax(port_run):
    from srl_zoo_tpu.config import SRLConfig as JaxConfig
    from srl_zoo_tpu.evaluation.enjoy_latent import \
        latent_sweep_grid as jax_grid
    from srl_zoo_tpu.training import checkpoint as jax_ckpt
    from srl_zoo_tpu_torch.evaluation.enjoy_latent import latent_sweep_grid
    states = np.load(os.path.join(port_run, "states_rewards.npz"))["states"]
    jcfg = JaxConfig.load(port_run)
    _, state, _ = jax_ckpt.load_srl_model(port_run, jcfg)
    want = jax_grid(jcfg, {"params": state.params,
                           "batch_stats": state.batch_stats}, states, 3, 5)
    cfg, model = ckpt.load_srl_model(port_run, torch.device("cpu"))
    got = latent_sweep_grid(cfg, model, states, 3, 5)
    assert got.shape == want.shape == (3, 5, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_enjoy_latent_cli_and_a_run_without_decoder(port_run, tmp_path):
    from srl_zoo_tpu.config import SRLConfig as JaxConfig
    from srl_zoo_tpu.evaluation.enjoy_latent import \
        model_recon_slice as jax_slice
    from srl_zoo_tpu_torch.evaluation import enjoy_latent
    run = str(tmp_path / "run")
    shutil.copytree(port_run, run)
    out = enjoy_latent.main(["--log-folder", run, "--n-dims", "2",
                             "--n-steps", "3", "--device", "cpu"])
    assert out == os.path.join(run, "latent_sweeps.png")
    assert os.path.getsize(out) > 0
    priors = SRLConfig(state_dim=4, losses=(("priors", 1.0),),
                       split_dims=(("priors", -1),))
    with pytest.raises(ValueError) as want:
        jax_slice(JaxConfig.from_exp_config(priors.to_exp_config()))
    with pytest.raises(ValueError) as got:
        enjoy_latent.model_recon_slice(priors)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# plotting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [1, 2, 3, 10])
def test_project_matches_jax_and_plots_write(dims, tmp_path, rng):
    from srl_zoo_tpu.plotting.representation_plot import \
        _project as jax_project
    from srl_zoo_tpu_torch.plotting.representation_plot import (
        _project, plot_representation)
    states = rng.randn(50, dims).astype(np.float32)
    np.testing.assert_allclose(_project(states), jax_project(states),
                               rtol=0, atol=1e-5)
    out = str(tmp_path / f"states_{dims}d.png")
    img = plot_representation(states, rng.randn(50), out)
    assert os.path.getsize(out) > 0 and img.dtype == np.uint8


def test_plot_correlation_and_losses_write(tmp_path, rng):
    from srl_zoo_tpu_torch.plotting.losses_plot import plot_losses
    from srl_zoo_tpu_torch.plotting.representation_plot import \
        plot_correlation
    out = str(tmp_path / "corr.png")
    plot_correlation(rng.rand(8, 2) * 2 - 1, out)
    assert os.path.getsize(out) > 0
    hist = str(tmp_path / "loss_history.npz")
    np.savez(hist, epoch=np.arange(5),
             **{"train/total": np.linspace(1, 0.1, 5),
                "val/total": np.linspace(1.2, -0.3, 5),
                "train/l1_reg": np.zeros(5)})
    out = str(tmp_path / "losses.png")
    plot_losses(hist, out)
    assert os.path.getsize(out) > 0


def test_plot_clis(port_run, tmp_path):
    from srl_zoo_tpu_torch.plotting import losses_plot, representation_plot
    run = str(tmp_path / "run")
    shutil.copytree(port_run, run)
    representation_plot.main(["--log-folder", run, "--correlation"])
    assert losses_plot.main(["--log-folder", run]) == \
        os.path.join(run, "losses.png")
    for name in ("states.png", "correlation.png", "losses.png"):
        assert os.path.getsize(os.path.join(run, name)) > 0


def test_live_view_headless_returns_none(monkeypatch):
    from srl_zoo_tpu_torch.plotting.representation_plot import LiveView
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    monkeypatch.setattr("sys.platform", "linux")
    assert LiveView.create() is None


def _fake_display(monkeypatch):
    """A display, with pyplot on Agg where LiveView asks for TkAgg."""
    import matplotlib.pyplot as plt
    monkeypatch.setenv("DISPLAY", ":0")
    orig_switch = plt.switch_backend
    monkeypatch.setattr(plt, "switch_backend",
                        lambda name: orig_switch("Agg"))
    monkeypatch.setattr(plt, "pause", lambda t: None)  # no event loop


def test_live_view_update_cycle(monkeypatch, rng):
    from srl_zoo_tpu_torch.plotting.representation_plot import LiveView
    _fake_display(monkeypatch)
    view = LiveView.create()
    assert view is not None
    view.update(rng.randn(40, 2), rng.rand(40), "epoch 1")
    view.update(rng.randn(40, 8), rng.rand(40), "epoch 2")  # PCA path
    view.close()


def test_live_view_dead_x_restores_backend(monkeypatch):
    """A TkAgg switch that succeeds but whose figure fails (a dead X
    connection) leaves the backend as it was."""
    import matplotlib
    import matplotlib.pyplot as plt
    from srl_zoo_tpu_torch.plotting.representation_plot import LiveView
    before = matplotlib.get_backend()
    monkeypatch.setenv("DISPLAY", ":0")

    def fake_switch(name):  # the switch itself succeeds
        matplotlib.rcParams["backend"] = name

    monkeypatch.setattr(plt, "switch_backend", fake_switch)
    monkeypatch.setattr(plt, "figure",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("couldn't connect to display")))
    assert LiveView.create() is None
    assert matplotlib.rcParams["backend"] == before


def test_live_view_update_failure_goes_dark(monkeypatch, rng):
    """A window closed mid-run (its draw raises) turns the view off and
    never raises; close() may be called again."""
    from srl_zoo_tpu_torch.plotting.representation_plot import LiveView
    _fake_display(monkeypatch)
    view = LiveView.create()
    assert view is not None
    view.fig.clf = lambda: (_ for _ in ()).throw(
        RuntimeError("canvas destroyed"))
    view.update(rng.randn(10, 2), rng.rand(10), "epoch 1")
    assert view.fig is None
    view.update(rng.randn(10, 2), rng.rand(10), "epoch 2")
    view.close()


def test_train_cli_writes_the_plots(synthetic_dataset, tmp_path, one_thread):
    from srl_zoo_tpu_torch.train import main
    run = str(tmp_path / "run")
    main(["--data-folder", synthetic_dataset.data_folder, "--losses",
          "autoencoder", "--state-dim", str(STATE_DIM), "-bs", str(BS),
          "--epochs", "2", "--log-folder", run, "--device", "cpu",
          "--plot-every", "1", "--no-display-plots"])
    for name in ("states.png", "correlation.png", "plots/epoch_1.png",
                 "plots/epoch_2.png", "plots/latest.png", "plots/live.html"):
        assert os.path.getsize(os.path.join(run, name)) > 0, name
    with open(os.path.join(run, "plots", "epoch_2.png"), "rb") as a, \
            open(os.path.join(run, "plots", "latest.png"), "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# the pipeline's helpers against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [
    [["autoencoder"], ["vae", "priors"]], ["autoencoder", "vae priors"],
    "autoencoder", [], [42], "", [["a", 1]]])
def test_normalize_loss_groups_matches_jax(groups):
    from pipeline import _normalize_loss_groups as jax_fn
    from srl_zoo_tpu_torch.pipeline import _normalize_loss_groups
    try:
        want = jax_fn(groups)
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            _normalize_loss_groups(groups)
        assert str(got.value) == str(e)
    else:
        assert _normalize_loss_groups(groups) == want


def _grid_actions():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int)
    p.add_argument("--state-dims", nargs="+", type=int)
    p.add_argument("--dtype", choices=["float32", "bfloat16"])
    p.add_argument("--multi-view", action="store_true")
    p.add_argument("--stream", action=argparse.BooleanOptionalAction)
    p.add_argument("--name", type=str)
    return {a.dest: a for a in p._actions}


@pytest.mark.parametrize("dest,value", [
    ("epochs", "50"), ("state_dims", 4), ("state_dims", ["4", 8]),
    ("dtype", "bfloat16"), ("multi_view", 1), ("multi_view", True),
    ("stream", 0), ("name", 7), (None, {"x": 1}), ("epochs", "many"),
    ("epochs", 1.5), ("epochs", 2.0), ("dtype", "float16"),
    ("multi_view", "yes")])
def test_coerce_grid_value_matches_jax(dest, value):
    from pipeline import _coerce_grid_value as jax_fn
    from srl_zoo_tpu_torch.pipeline import _coerce_grid_value
    action = _grid_actions().get(dest)
    try:
        want = jax_fn(action, value)
    except (TypeError, ValueError) as e:
        with pytest.raises(type(e)) as got:
            _coerce_grid_value(action, value)
        assert str(got.value) == str(e)
    else:
        got = _coerce_grid_value(action, value)
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("n_seeds", [1, 3])
def test_aggregate_seeds_matches_jax(n_seeds):
    from pipeline import aggregate_seeds as jax_fn
    from srl_zoo_tpu_torch.pipeline import aggregate_seeds
    rng = np.random.RandomState(n_seeds)
    per_seed = [{"log_folder": f"logs/ds/run{s}", "losses": ["vae"],
                 "state_dim": 8, "model_type": "custom_cnn", "seed": s,
                 "knn_mse": float(rng.rand()), "gtc": float(rng.rand()),
                 "reward_accuracy": float(rng.rand()),
                 "images_per_sec": float(rng.rand() * 1e3)}
                for s in range(1, n_seeds + 1)]
    assert aggregate_seeds(per_seed) == jax_fn(per_seed)


def test_cell_log_folders_never_collide(tmp_path, monkeypatch):
    from srl_zoo_tpu_torch.pipeline import _cell_log_folder
    monkeypatch.chdir(tmp_path)
    a = _cell_log_folder("ds", "custom_cnn", ["vae"], 8, 1)
    b = _cell_log_folder("ds", "custom_cnn", ["vae"], 8, 2)
    assert a != b and a.startswith(os.path.join("logs", "ds", ""))
    os.makedirs(a)
    c = _cell_log_folder("ds", "custom_cnn", ["vae"], 8, 1)
    assert c not in (a, b) and c.startswith(a)
    os.makedirs(c)
    assert _cell_log_folder("ds", "custom_cnn", ["vae"], 8, 1) not in (a, c)


# ---------------------------------------------------------------------------
# the pipeline end to end
# ---------------------------------------------------------------------------

PIPE_FLAGS = ["--state-dims", str(STATE_DIM), "--epochs", "1", "-bs", "8",
              "--img-size", "32", "--device", "cpu"]


def _pipeline(argv, cwd, monkeypatch):
    from srl_zoo_tpu_torch import pipeline
    monkeypatch.chdir(cwd)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return pipeline.main(argv)
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipeline_grid(pipe_dataset, tmp_path_factory):
    """Two loss groups x one state dim, one epoch, through the port's
    pipeline (and one cell through JAX's, for its report's keys)."""
    mp = pytest.MonkeyPatch()
    try:
        cwd = tmp_path_factory.mktemp("grid")
        results = _pipeline(["--data-folder", pipe_dataset, "--losses",
                             "autoencoder", "--losses", "priors",
                             *PIPE_FLAGS], cwd, mp)
        import pipeline as jax_pipeline
        jcwd = tmp_path_factory.mktemp("jax_grid")
        mp.chdir(jcwd)
        jax_results = jax_pipeline.main(
            ["--data-folder", pipe_dataset, "--losses", "autoencoder",
             "--state-dims", str(STATE_DIM), "--epochs", "1", "-bs", "8",
             "--img-size", "32", "--no-grids"])
    finally:
        mp.undo()
    return cwd, results, jax_results


def test_pipeline_grid_report(pipeline_grid):
    from srl_zoo_tpu_torch.evaluation import knn_images
    cwd, results, jax_results = pipeline_grid
    report = cwd / "logs" / "synth" / "pipeline_report.json"
    assert json.loads(report.read_text()) == results
    assert [r["losses"] for r in results] == [["autoencoder"], ["priors"]]
    for r in results:
        assert set(r) == set(jax_results[0])
        folder = os.path.join(cwd, r["log_folder"])
        assert r["knn_mse"] == knn_images.main(
            ["--log-folder", folder, "--n-grids", "0", "--device", "cpu"])
        with open(os.path.join(folder, "gtc.txt")) as f:
            assert r["gtc"] == float(f.read())
        assert 0.0 <= r["reward_accuracy"] <= 1.0
        for name in ("knn_mse.json", "reward_accuracy.json",
                     "states.png", "correlation.png",
                     *(f"NearestNeighbors/knn_grid_{g}.png"
                       for g in range(3))):
            assert os.path.exists(os.path.join(folder, name)), name


def test_pipeline_exp_config_gives_the_flags_grid(pipeline_grid,
                                                  pipe_dataset, tmp_path,
                                                  monkeypatch):
    _, results, _ = pipeline_grid
    grid = {"data-folder": pipe_dataset, "losses": ["autoencoder", "priors"],
            "state_dims": STATE_DIM, "epochs": "1", "batch-size": 8,
            "img-size": 32, "device": "cpu"}
    (tmp_path / "grid.json").write_text(json.dumps(grid))
    got = _pipeline(["--exp-config", str(tmp_path / "grid.json")], tmp_path,
                    monkeypatch)
    skip = ("log_folder", "images_per_sec")
    assert [{k: v for k, v in r.items() if k not in skip} for r in got] == \
        [{k: v for k, v in r.items() if k not in skip} for r in results]


def test_pipeline_seeds_aggregate(pipe_dataset, tmp_path, monkeypatch):
    results = _pipeline(["--data-folder", pipe_dataset, "--losses",
                         "autoencoder", "--seeds", "1", "2", "--no-grids",
                         *PIPE_FLAGS], tmp_path, monkeypatch)
    (r,) = results
    assert r["seeds"] == [1, 2] and len(set(r["log_folders"])) == 2
    knn = []
    for folder in r["log_folders"]:
        with open(os.path.join(tmp_path, folder, "knn_mse.json")) as f:
            knn.append(json.load(f)["knn_mse"])
        assert not os.path.exists(os.path.join(tmp_path, folder,
                                               "NearestNeighbors"))
    assert r["knn_mse"] == pytest.approx(np.mean(knn), rel=1e-12)
    assert r["knn_mse_std"] == pytest.approx(np.std(knn), rel=1e-9, abs=0)
    for key in ("gtc", "reward_accuracy", "images_per_sec"):
        assert f"{key}_std" in r


def test_pipeline_bad_grid_value_exits_before_training(pipe_dataset,
                                                       tmp_path,
                                                       monkeypatch):
    grid = {"data-folder": pipe_dataset, "losses": [["autoencoder"]],
            "epochs": "not-a-number", "device": "cpu"}
    (tmp_path / "bad.json").write_text(json.dumps(grid))
    with pytest.raises(SystemExit):
        _pipeline(["--exp-config", str(tmp_path / "bad.json")], tmp_path,
                  monkeypatch)
    assert not os.path.exists(tmp_path / "logs")


@pytest.mark.parametrize("mode", ["off", "hybrid", "sharded"])
def test_pipeline_passes_the_device_cache_to_its_cells(pipe_dataset,
                                                       tmp_path, monkeypatch,
                                                       mode):
    """``--device-cache off`` (streaming), ``hybrid`` (a store of 24
    rows) and ``sharded`` (one rank's block, all rows) reach each cell's
    train CLI, which trains and is scored."""
    if mode != "sharded":
        monkeypatch.setenv("SRL_ZOO_CACHE_BUDGET_MB",
                           str(24.5 * 32 * 32 * 3 / 2**20))
    results = _pipeline(["--data-folder", pipe_dataset, *PIPE_FLAGS,
                         "--no-grids", "--device-cache", mode], tmp_path,
                        monkeypatch)
    with open(os.path.join(tmp_path, results[0]["log_folder"],
                           "exp_config.json")) as f:
        assert json.load(f)["device-cache"] == mode
    assert np.isfinite(results[0]["knn_mse"])


def test_pipeline_passes_the_dtype_and_model_types_to_its_cells(
        pipe_dataset, tmp_path, monkeypatch):
    """``--dtype bfloat16`` reaches each cell's train CLI, and the dense
    model types run as cells: each cell's ``exp_config.json`` records
    the compute dtype and its model type, and it is scored."""
    results = _pipeline(["--data-folder", pipe_dataset, *PIPE_FLAGS,
                         "--dtype", "bfloat16", "--no-grids",
                         "--model-types", "custom_cnn", "mlp"], tmp_path,
                        monkeypatch)
    assert [r["model_type"] for r in results] == ["custom_cnn", "mlp"]
    for r in results:
        with open(os.path.join(tmp_path, r["log_folder"],
                               "exp_config.json")) as f:
            cfg = json.load(f)
        assert (cfg["compute-dtype"], cfg["model-type"]) == (
            "bfloat16", r["model_type"])
        assert np.isfinite(r["knn_mse"]) and 0.0 <= r["reward_accuracy"] \
            <= 1.0


def test_pipeline_needs_a_gpu_before_any_write(pipe_dataset, tmp_path,
                                               monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _pipeline(["--data-folder", pipe_dataset, "--img-size", "32"],
                  tmp_path, monkeypatch)
    assert not os.path.exists(tmp_path / "logs")


@pytest.mark.parametrize("fault", ["no-preprocessed-data", "frames-length",
                                   "frames-size", "no-frames"])
def test_check_dataset_refuses_what_needs_preprocessing(pipe_dataset,
                                                        tmp_path, fault):
    """What the pipeline once refused it now repairs, as the JAX pipeline
    does: a folder of record_* episodes without preprocessed_data.npz is
    preprocessed (equal to the schema it was made from), and a missing
    frames.npy, or one of another length or size, is rebuilt at the
    asked size from the JPEGs. A missing folder still raises."""
    from srl_zoo_tpu_torch.pipeline import check_dataset
    from srl_zoo_tpu_torch.preprocessing.preprocess import frames_cache_stale
    folder = str(tmp_path / "ds")
    shutil.copytree(pipe_dataset, folder)
    check_dataset(folder, 32)  # as written: nothing to do
    frames = np.load(os.path.join(folder, "frames.npy"))
    pre = dict(np.load(os.path.join(folder, "preprocessed_data.npz")))
    gt = dict(np.load(os.path.join(folder, "ground_truth.npz")))
    if fault == "no-preprocessed-data":
        # the recorded episodes that preprocessing reads: each episode's
        # rewards of acting at frame t are the schema's of arriving at t+1
        starts = np.nonzero(pre["episode_starts"])[0]
        for e, (a, b) in enumerate(zip(starts, list(starts[1:]) +
                                       [len(pre["actions"])])):
            np.savez(os.path.join(folder, f"record_{e:03d}",
                                  "episode_data.npz"),
                     actions=pre["actions"][a:b],
                     rewards=np.append(pre["rewards"][a + 1:b], 0.0),
                     ground_truth_states=gt["ground_truth_states"][a:b])
        os.remove(os.path.join(folder, "preprocessed_data.npz"))
    elif fault == "frames-length":
        np.save(os.path.join(folder, "frames.npy"), frames[:-1])
    elif fault == "no-frames":
        os.remove(os.path.join(folder, "frames.npy"))
    size = 64 if fault == "frames-size" else 32
    check_dataset(folder, size)
    got = np.load(os.path.join(folder, "preprocessed_data.npz"))
    for k, v in pre.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(
        np.load(os.path.join(folder, "ground_truth.npz"))["images_path"],
        gt["images_path"])
    path = os.path.join(folder, "frames.npy")
    assert not frames_cache_stale(path, size, len(frames))
    if size == 32 and fault != "no-preprocessed-data":
        # rebuilt from the JPEGs with the writer's decoder chain
        from srl_zoo_tpu.preprocessing.preprocess import build_frames_cache
        want = np.load(build_frames_cache(
            _copy_without_frames(folder, tmp_path / "want"), 32))
        np.testing.assert_array_equal(np.load(path), want)
    with pytest.raises(FileNotFoundError):
        check_dataset(str(tmp_path / "missing"), 32)


def _copy_without_frames(src, dst):
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("frames*.npy"))
    return str(dst)


# ---------------------------------------------------------------------------
# AsyncCheckpointer
# ---------------------------------------------------------------------------

def _model():
    cfg = SRLConfig(state_dim=STATE_DIM, img_height=32, img_width=32)
    from srl_zoo_tpu_torch.models.srl_modules import SRLModules
    model = SRLModules(cfg)
    return model, torch.optim.Adam(model.parameters(), 1e-3), \
        torch.Generator().manual_seed(0)


def test_checkpointer_keeps_the_newest_job_of_each_kind(tmp_path,
                                                        monkeypatch):
    model, opt, gen = _model()
    started, release, written = threading.Event(), threading.Event(), []
    real = ckpt.write_train_state

    def slow_write(folder, state, step, epoch, best_val):
        written.append(epoch)
        started.set()
        assert release.wait(30)
        return real(folder, state, step, epoch, best_val)

    monkeypatch.setattr(ckpt, "write_train_state", slow_write)
    writer = ckpt.AsyncCheckpointer(str(tmp_path), torch.device("cpu"))
    writer.save_state(model, opt, gen, 1, 1, 0.5)
    assert started.wait(30)
    for epoch in (2, 3, 4):
        writer.save_state(model, opt, gen, epoch, epoch, 0.5)
    with torch.no_grad():
        model.encoder.fc.bias.add_(1.0)  # after the last submit
    release.set()
    writer.close()
    assert written == [1, 4]
    saved = torch.load(tmp_path / "checkpoints" / "state_latest.pth")
    assert saved["epoch"] == 4 and saved["step"] == 4
    assert torch.equal(saved["model"]["encoder.fc.bias"] + 1.0,
                       model.encoder.fc.bias.detach())


def test_checkpointer_close_flushes_and_refuses_later_jobs(tmp_path):
    model, opt, gen = _model()
    writer = ckpt.AsyncCheckpointer(str(tmp_path), torch.device("cpu"))
    writer.save_model(model, model.state_dict())
    writer.save_state(model, opt, gen, 7, 2, 0.25)
    writer.close()
    got = ckpt.read_state_dict(str(tmp_path))
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k
    assert SRLConfig.load(str(tmp_path)) == model.cfg
    assert ckpt.load_meta(str(tmp_path)) == {"step": 7, "epoch": 2,
                                             "best_val": 0.25}
    with pytest.raises(RuntimeError, match="already closed"):
        writer.save_state(model, opt, gen, 8, 3, 0.2)


def test_checkpointer_raises_the_writers_error_at_close(tmp_path,
                                                        monkeypatch):
    model, opt, gen = _model()

    def fail(*args):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "write_train_state", fail)
    writer = ckpt.AsyncCheckpointer(str(tmp_path), torch.device("cpu"))
    writer.save_state(model, opt, gen, 1, 1, 0.5)
    with pytest.raises(RuntimeError, match="writer failed") as e:
        writer.close()
    assert isinstance(e.value.__cause__, OSError)


def test_checkpointer_close_times_out_on_a_hung_write(tmp_path,
                                                      monkeypatch):
    model, opt, gen = _model()
    release = threading.Event()
    monkeypatch.setattr(ckpt, "write_train_state",
                        lambda *a: release.wait(30))
    monkeypatch.setattr(ckpt, "FLUSH_TIMEOUT_S", 0.2)
    writer = ckpt.AsyncCheckpointer(str(tmp_path), torch.device("cpu"))
    writer.save_state(model, opt, gen, 1, 1, 0.5)
    with pytest.raises(RuntimeError, match="did not flush"):
        writer.close()
    release.set()
    writer._thread.join(30)
    assert not writer._thread.is_alive()


def _learner(synthetic_dataset, folder, epochs=3):
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    cfg = SRLConfig(state_dim=STATE_DIM, img_height=32, img_width=32,
                    batch_size=BS, epochs=epochs, seed=1)
    return (SRL4robotics(cfg, log_folder=folder, device="cpu"),
            load_dataset(synthetic_dataset.data_folder))


class _Stop(Exception):
    pass


def _stop_after(epoch):
    calls = []

    def callback(learner, e, train_m, val_m):
        calls.append((e, set(train_m), set(val_m)))
        if e == epoch:
            raise _Stop(f"stop after epoch {e}")
    return callback, calls


def test_crash_path_flushes_the_resume_state(synthetic_dataset, tmp_path,
                                             one_thread):
    learner, ds = _learner(synthetic_dataset, str(tmp_path))
    callback, calls = _stop_after(1)
    with pytest.raises(_Stop, match="stop after epoch 1"):
        learner.learn(ds, epoch_callback=callback)
    assert [c[0] for c in calls] == [0, 1]
    assert "total" in calls[0][1] and "total" in calls[0][2]
    meta = ckpt.load_meta(str(tmp_path))
    assert meta["epoch"] == 2 and meta["step"] > 0
    saved = torch.load(tmp_path / "checkpoints" / "state_latest.pth")
    for k, v in learner.model.state_dict().items():
        assert torch.equal(saved["model"][k], v), k
    hist = np.load(tmp_path / "loss_history.npz")
    np.testing.assert_array_equal(hist["epoch"], [0, 1])


def test_crash_path_keeps_the_real_error_when_the_flush_fails(
        synthetic_dataset, tmp_path, monkeypatch, capsys, one_thread):
    learner, ds = _learner(synthetic_dataset, str(tmp_path))

    def fail(*args):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "write_train_state", fail)
    callback, _ = _stop_after(0)
    with pytest.raises(_Stop):
        learner.learn(ds, epoch_callback=callback)
    out = capsys.readouterr().out
    assert "checkpoint flush failed during crash handling" in out
    assert "disk full" in out
    assert os.path.exists(tmp_path / "loss_history.npz")


def test_learner_predict_states_takes_rows(synthetic_dataset, tmp_path,
                                           one_thread):
    learner, ds = _learner(synthetic_dataset, str(tmp_path), epochs=1)
    learner.learn(ds)
    rows = np.array([5, 0, 17, 5])
    np.testing.assert_array_equal(learner.predict_states(ds, rows),
                                  learner.predict_states(ds)[rows])
