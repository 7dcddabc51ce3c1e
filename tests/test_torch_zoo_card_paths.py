"""The port's entry points on the card, at config 1's width (224x224x3,
state_dim 200, batch 32): the inference path (serve, state export,
KNN-MSE by both neighbour routes) over a 20,000-frame store; the train
CLI with ``--profile`` and the doctor; the train CLI per BASELINE config
and per loss of the zoo, in bf16 and on the dense models, on a two-camera
4,096-frame dataset, with its run files, KNN-MSE, served states and the
torch export; the data layer (recorded JPEG episodes, streamed and
hybrid stores); a process group of world size 1 over nccl; and config 5
through the pipeline. Each path counts its kernels' launches from zero
and every pool and gather launch must take the vector path.

Every test needs a CUDA device and skips without one; this file imports
no JAX, so on the card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q -m chip \\
        tests/test_torch_zoo_card_paths.py
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import threading
import types
import urllib.request
from unittest import mock

import numpy as np
import pytest
import torch

from torch_card_lib import cuda, train_data  # noqa: F401 (fixtures)
from torch_card_lib import (ALL_CONFIGS, BATCH, BF16_DENSE_CONFIGS,
                            HYBRID_ROWS, IMG, KNN_QUERIES, N_FRAMES,
                            POOL_KERNELS, POOLS, RESNET_VIEWS, SEED,
                            STATE_DIM, TRACED, TRAIN_EPISODES, TRAIN_FRAMES,
                            launches, near_ties)

pytestmark = pytest.mark.chip
CONFIG = {name: (tokens, epochs, kw) for name, tokens, epochs, kw
          in ALL_CONFIGS}
CLI_FLAG = {"noise_type": "--noise-type",
            "episode_prior_optimizer": "--episode-prior-optimizer",
            "grad_accum": "--grad-accum", "path_to_dae": "--path-to-dae",
            "compute_dtype": "--dtype", "learning_rate": "-lr"}
TRAINING_KERNELS = POOL_KERNELS + ("gather_normalize", "knn_topk",
                                   "pairwise_sqdist")
DATA_FRAMES = 1024  # frames of the scene recorded as JPEG episodes


def cli_flags(kw) -> list:
    """The train CLI's flags of a config's fields ``kw``."""
    flags = (["--model-type", kw.get("model_type", "custom_cnn")]
             + (["--multi-view"] if kw.get("multi_view") else []))
    for key, flag in CLI_FLAG.items():
        if key in kw:
            flags += [flag, str(kw[key])]
    return flags


def stacked_frames(dataset, rows, cfg) -> np.ndarray:
    """uint8 observations of ``rows`` as the encoder of ``cfg`` takes them:
    both views on the channel axis where it stacks them."""
    frames = np.asarray(dataset.frames[rows])
    if cfg.stack_views:
        frames = np.concatenate([frames, np.asarray(dataset.frames_2[rows])],
                                axis=-1)
    return frames


def serve_rounds(run_dir: str, payloads, rounds: int = 1) -> list:
    """The states a fresh server of ``run_dir`` (coalescing 5 ms, max batch
    32) answers in each of ``rounds`` rounds of concurrent requests of
    ``payloads``, a client thread each, in their order."""
    from srl_zoo_tpu_torch.serve import build_server
    server = build_server(run_dir, port=0, max_batch=32, coalesce_ms=5)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/encode"
    out = []

    def client(replies, i):
        buf = io.BytesIO()
        np.save(buf, payloads[i])
        req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            replies[i] = np.load(io.BytesIO(r.read()))
    try:
        for _ in range(rounds):
            out.append([None] * len(payloads))
            clients = [threading.Thread(target=client, args=(out[-1], i))
                       for i in range(len(payloads))]
            for t in clients:
                t.start()
            for t in clients:
                t.join(300)
            assert all(r is not None for r in out[-1]), \
                "a request did not complete"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    assert not thread.is_alive()
    return out


def check_full_route(q, refs, full_idx, queries, gt, score) -> None:
    """The full route's 6 nearest against the fused route's on the same
    points (equal but at near ties), and its KNN-MSE (k=5) equal to
    ``score`` within 1e-6."""
    from srl_zoo_tpu_torch.evaluation.knn import score_neighbors
    from srl_zoo_tpu_torch.ops.knn_topk import knn_topk
    near_ties(q, refs, full_idx, knn_topk(q, refs, 6), 1e-4)
    full, _ = score_neighbors(full_idx.cpu().numpy(), queries, gt, 5)
    assert abs(full - score) <= 1e-6 * max(1.0, abs(score)), (full, score)


def knn_both_routes(states, gt, dev) -> tuple:
    """KNN-MSE (k=5) of 4,096 sampled queries by the fused kernel, and the
    same queries' 6 nearest by the ``full`` route: (score, queries,
    neighbours, centred queries, centred states, full route's top-6)."""
    from srl_zoo_tpu_torch.evaluation.knn import centre, knn_mse
    from srl_zoo_tpu_torch.ops.knn_topk import knn_topk
    score, queries, nbrs = knn_mse(states, gt, k=5, n_samples=KNN_QUERIES,
                                   seed=SEED)
    refs = centre(torch.from_numpy(states).to(dev))
    q = refs[torch.from_numpy(queries).to(dev)]
    return score, queries, nbrs, q, refs, knn_topk(q, refs, 6, impl="full")


# ---------------------------------------------------------------------------
# the inference path
# ---------------------------------------------------------------------------

def random_model(cfg, seed: int):
    """Config-1 model with seeded random weights and non-trivial BN
    statistics."""
    from srl_zoo_tpu_torch.models.srl_modules import SRLModules
    g = torch.Generator().manual_seed(seed)
    model = SRLModules(cfg)
    enc = model.encoder
    with torch.no_grad():
        for conv in enc.convs:
            fan_in = conv.weight[0].numel()
            conv.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=g)
        for bn in enc.bns:
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.normal_(0.0, 0.1, generator=g)
            bn.running_mean.normal_(0.0, 0.2, generator=g)
            bn.running_var.uniform_(0.5, 2.0, generator=g)
        enc.fc.weight.normal_(0.0, enc.fc.in_features ** -0.5, generator=g)
        enc.fc.bias.normal_(0.0, 0.1, generator=g)
    return model


def test_inference_path(cuda, tmp_path):
    """A seeded random config-1 model saved as a run folder: the server
    answers two rounds of 8 concurrent single frames and 2 batches of 16
    (the first as a fresh server's first clients see it); states are
    exported for the 20,000-frame store in batches of 256; KNN-MSE (k=5)
    scores 4,096 sampled queries with the fused kernel and the ``full``
    route finds their 6 nearest. K1f, K2, K3 and K4 run, the pools and
    the gather on their vector path. The replies and 64 exported rows
    equal a direct encode within 1e-5, the score the plain top-k's within
    1e-6, and the full route the fused one but at near ties."""
    from srl_zoo_tpu_torch.checkpoint import save_srl_model
    from srl_zoo_tpu_torch.config import SRLConfig
    from srl_zoo_tpu_torch.data.device_cache import build_cache
    from srl_zoo_tpu_torch.data.schema import Dataset
    from srl_zoo_tpu_torch.evaluation.knn import (sample_queries,
                                                  score_neighbors)
    from srl_zoo_tpu_torch.evaluation.predict_dataset import predict_states
    from srl_zoo_tpu_torch.inference import StateEncoder
    from srl_zoo_tpu_torch.ops.knn_topk import knn_topk_plain
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (N_FRAMES,) + IMG, dtype=np.uint8)
    gt = rng.standard_normal((N_FRAMES, 3)).astype(np.float32)
    store = build_cache(Dataset(
        data_folder="<generated>", actions=np.zeros(N_FRAMES, np.int32),
        rewards=np.zeros(N_FRAMES, np.float32), ground_truth_states=gt,
        frames=frames), cuda)["frames"]
    run_dir = str(tmp_path)
    save_srl_model(run_dir, random_model(SRLConfig(
        state_dim=STATE_DIM, img_height=IMG[0], img_width=IMG[1]), SEED))
    encoder = StateEncoder.load(run_dir)
    payloads = [frames[i] for i in range(8)] + [frames[8:24], frames[24:40]]
    with launches() as ran:
        rounds = serve_rounds(run_dir, payloads, rounds=2)
        states = predict_states(encoder, {"frames": store})
        score, queries, nbrs, q, refs, full_idx = knn_both_routes(
            states, gt, cuda)
    assert all(ran[k] > 0 for k in ("relu_max_pool", "gather_normalize",
                                    "knn_topk", "pairwise_sqdist")), ran
    direct = encoder.encode(frames[:40])
    for replies in rounds:
        got = np.concatenate([r[None] for r in replies[:8]] + replies[8:])
        assert got.shape == (40, STATE_DIM)
        assert float(np.abs(got - direct).max()) <= 1e-5
    assert states.shape == (N_FRAMES, STATE_DIM)
    assert np.isfinite(states).all()
    rows = np.random.RandomState(SEED).choice(N_FRAMES, 64, replace=False)
    assert float(np.abs(states[rows] - encoder.encode(frames[rows])).max()
                 ) <= 1e-5
    assert np.array_equal(queries, sample_queries(len(states), KNN_QUERIES,
                                                  SEED))
    plain, plain_nbrs = score_neighbors(
        knn_topk_plain(q, refs, 6)[1].cpu().numpy(), queries, gt, 5)
    assert np.isfinite(score)
    assert abs(score - plain) <= 1e-6 * max(1.0, abs(plain)), (
        score, plain, int((nbrs != plain_nbrs).sum()))
    check_full_route(q, refs, full_idx, queries, gt, score)


# ---------------------------------------------------------------------------
# --profile and the doctor (before the training runs: after a run of
# training profiles CUPTI has been seen to record no kernel at all)
# ---------------------------------------------------------------------------

def test_profile_run_traces_the_kernels_and_the_doctor(cuda, train_data,
                                                       tmp_path, capsys):
    """Config 1 through the train CLI with ``--profile`` for one epoch of
    640 rows: the trace holds K1f, K1b and K2 launches under the kernels'
    names and its summary (``utils/profiling.py``) sums device time. A
    trace that lacks a kernel is taken once more: CUPTI now and then
    drops a kernel record. Then the doctor on the dataset: it measures a
    pinned bandwidth and names the whole store as the mode."""
    from srl_zoo_tpu_torch import train as train_cli
    from srl_zoo_tpu_torch.utils import doctor, profiling
    for attempt in range(2):
        run = str(tmp_path / f"profiled_{attempt}")
        with launches() as ran:
            train_cli.main(["--data-folder", train_data, "--losses",
                            "autoencoder", "--state-dim", str(STATE_DIM),
                            "-bs", str(BATCH), "--epochs", "1",
                            "--training-set-size", "640", "--log-folder",
                            run, "--profile"])
        basis, rows = profiling.summarize_profile_dir(
            os.path.join(run, "profile"), top=10**6)
        traced = {k: sum(r.calls for r in rows if name in r.name)
                  for k, name in TRACED.items()}
        if basis == profiling.DEVICE_TIME and all(traced.values()):
            break
    assert basis == profiling.DEVICE_TIME
    assert all(traced.values()) and all(ran[k] for k in TRACED), (traced,
                                                                  ran)
    capsys.readouterr()
    rc = doctor.main(["--data-folder", train_data, "--img-size",
                      str(IMG[0]), "-bs", str(BATCH)])
    text = capsys.readouterr().out
    assert rc == 0 and "mode: whole store" in text and "MB/s" in text, text


# ---------------------------------------------------------------------------
# the train CLI per config
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def learners():
    """The learners the train CLI builds while the block runs."""
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    out, real = [], SRL4robotics.learn

    def learn(self, *args, **kw):
        out.append(self)
        return real(self, *args, **kw)
    with mock.patch.object(SRL4robotics, "learn", learn):
        yield out


class Runs:
    """Phase 4's runs of the train CLI on the training dataset, each
    trained at its first request: config 1 for 3 epochs with
    ``--plot-every 1``, the others for 2; then its states scored by
    KNN-MSE through both neighbour routes and, for the ResNet, bf16 and
    dense runs, one round of 8 concurrent single frames served; the
    launch counts zeroed just before and read just after."""

    def __init__(self, data: str, work, dev):
        self.data, self.work, self.dev, self.done = data, work, dev, {}

    def __call__(self, name: str):
        if name not in self.done:
            self.done[name] = self._train(name)
        return self.done[name]

    def _train(self, name: str):
        from srl_zoo_tpu_torch import train as train_cli
        from srl_zoo_tpu_torch.config import SRLConfig
        from srl_zoo_tpu_torch.data.schema import load_dataset
        tokens, epochs, kw = CONFIG[name]
        if "path_to_dae" in kw:
            kw = {**kw, "path_to_dae": self(kw["path_to_dae"]).dir}
        run = str(self.work / name)
        dataset = load_dataset(self.data)
        served = kw.get("model_type") == "resnet" or name in {
            n for n, *_ in BF16_DENSE_CONFIGS}
        with learners() as built, launches() as ran:
            train_cli.main(["--data-folder", self.data, "--losses", *tokens,
                            *cli_flags(kw), "--state-dim", str(STATE_DIM),
                            "-bs", str(BATCH), "--epochs", str(epochs),
                            "--log-folder", run,
                            *(["--plot-every", "1"]
                              if name == "autoencoder" else [])])
            states = np.load(os.path.join(run, "states_rewards.npz")
                             )["states"]
            knn = knn_both_routes(states, dataset.ground_truth_states,
                                  self.dev)
            cfg = SRLConfig.load(run)
            replies = serve_rounds(run, list(stacked_frames(
                dataset, np.arange(8), cfg)))[0] if served else None
        return types.SimpleNamespace(
            dir=run, cfg=cfg, epochs=epochs, launches=ran, learner=built[-1],
            states=states, knn=knn, replies=replies, dataset=dataset)


@pytest.fixture(scope="module")
def runs(cuda, train_data, tmp_path_factory):
    return Runs(train_data, tmp_path_factory.mktemp("runs"), cuda)


def check_run_files(run, plots: bool) -> None:
    """The plots every run writes (and those of ``--plot-every 1``), and
    a resume checkpoint that loads at the run's epoch and step."""
    want = ["states.png", "correlation.png"]
    if plots:
        want += [f"plots/epoch_{e}.png" for e in range(1, run.epochs + 1)] \
            + ["plots/latest.png", "plots/live.html"]
    for f in want:
        assert os.path.getsize(os.path.join(run.dir, f)) > 0, f
    state = torch.load(os.path.join(run.dir, "checkpoints",
                                    "state_latest.pth"),
                       map_location="cpu", weights_only=True)
    with open(os.path.join(run.dir, "metrics.jsonl")) as f:
        last_step = [json.loads(line)["step"] for line in f][-1]
    assert (state["epoch"], state["step"]) == (run.epochs, last_step)


def check_trained(run) -> None:
    """The training loss fell; under ``--grad-accum`` Adam stepped once
    every ``grad_accum`` micro-steps, across epochs; the perceptual run
    launched K1b three times per encoder backward, twice a step: the
    gradient goes back through the frozen DAE's pools too."""
    cfg = run.cfg
    hist = np.load(os.path.join(run.dir, "loss_history.npz"))
    assert hist["train/total"][-1] < hist["train/total"][0]
    with open(os.path.join(run.dir, "metrics.jsonl")) as f:
        micro_steps = [json.loads(line) for line in f][-1]["step"]
    if cfg.grad_accum > 1:
        opt = torch.load(os.path.join(run.dir, "checkpoints",
                                      "state_latest.pth"),
                         map_location="cpu", weights_only=True)["optimizer"]
        steps = {int(s["step"]) for a in opt["adams"]
                 for s in a["state"].values()}
        assert steps == {micro_steps // cfg.grad_accum}
        assert opt["micro_step"] == micro_steps % cfg.grad_accum
    if "perceptual" in cfg.loss_names:
        assert run.launches["relu_max_pool_bwd"] == \
            2 * len(POOLS) * micro_steps


def check_random_features(run) -> None:
    """``--losses random``: srl_model.pth holds the seed's initial model
    bit for bit, with no loss history and no resume checkpoint."""
    from srl_zoo_tpu_torch.training.state import make_model
    saved = torch.load(os.path.join(run.dir, "srl_model.pth"),
                       map_location="cpu", weights_only=True)
    init = make_model(run.cfg, torch.device("cpu")).state_dict()
    assert set(saved) == set(init)
    assert all(torch.equal(saved[k], init[k]) for k in init)
    assert not np.load(os.path.join(run.dir, "loss_history.npz")).files
    assert not os.path.exists(os.path.join(run.dir, "checkpoints"))


@pytest.mark.parametrize("name", [n for n, _, epochs, _ in ALL_CONFIGS
                                  if epochs])
def test_train_cli(cuda, runs, name):
    """A config through the train CLI (see ``Runs``). Its cached phases
    ran through the epoch runner by replay, no step through the per-step
    loop. K1f, K1b, K2, K3 and K4 launched (no K1b for ``random``, no pool
    on a dense model), a bf16 run's pools in bf16 only, an f32 run's in
    f32 only. The exported states are finite and equal a direct encode,
    as do the served ones, within 1e-5 of the largest |state| (2^-7 in
    bf16: export batches of 256, encode chunks of 32 and served groups of
    8 take different cuDNN algorithms); the two routes' KNN-MSE agree
    within 1e-6; GTC is written; the run files and the training are
    checked, or for ``random`` that it trained nothing."""
    from srl_zoo_tpu_torch.inference import StateEncoder
    run = runs(name)
    cfg, ran = run.cfg, run.launches
    random = cfg.only_random_features
    learner = run.learner
    assert random or (learner.runner.replays > 0
                      and learner.loop_steps == 0), learner.runner.counts()
    kernels = [k for k in TRAINING_KERNELS
               if not (random and k == "relu_max_pool_bwd")]
    bf16 = cfg.compute_dtype == "bfloat16"
    if cfg.model_type in ("mlp", "linear"):
        assert not any(ran[k] for k in POOL_KERNELS), ran
        kernels = [k for k in kernels if k not in POOL_KERNELS]
    else:
        assert all(ran[f"{k}/bf16"] == (ran[k] if bf16 else 0)
                   for k in POOL_KERNELS), ran
    assert all(ran[k] > 0 for k in kernels), ran
    if random:
        check_random_features(run)
    else:
        check_run_files(run, plots=name == "autoencoder")
        check_trained(run)
    assert run.states.shape == (TRAIN_FRAMES, STATE_DIM)
    assert np.isfinite(run.states).all()
    assert os.path.getsize(os.path.join(run.dir, "gtc.txt")) > 0
    score, queries, _, q, refs, full_idx = run.knn
    check_full_route(q, refs, full_idx, queries,
                     run.dataset.ground_truth_states, score)
    tol = 2.0 ** -7 if bf16 else 1e-5
    direct = StateEncoder.load(run.dir).encode(
        stacked_frames(run.dataset, np.arange(64), cfg))
    scale = float(np.abs(direct).max())
    assert float(np.abs(run.states[:64] - direct).max()) / scale <= tol
    if run.replies is not None:
        got = np.stack(run.replies)
        assert got.shape == (8, STATE_DIM)
        assert float(np.abs(got - direct[:8]).max()) / scale <= tol


def test_latent_sweeps_of_the_autoencoder_run(cuda, runs):
    """``enjoy_latent`` on config 1's run (8 dims x 7 steps at 224 px):
    its PNG, and the sweep's middle column within 1e-5 (of its largest
    value) of a direct decode of the mean state."""
    from srl_zoo_tpu_torch import checkpoint as ckpt
    from srl_zoo_tpu_torch.evaluation import enjoy_latent
    run = runs("autoencoder")
    out = enjoy_latent.main(["--log-folder", run.dir, "--n-dims", "8",
                             "--n-steps", "7"])
    assert os.path.getsize(out) > 0
    cfg, model = ckpt.load_srl_model(run.dir, cuda)
    grid = enjoy_latent.latent_sweep_grid(cfg, model, run.states, 8, 7)
    direct = enjoy_latent.decode_states(cfg, model,
                                        run.states.mean(0)[None])[0]
    assert grid.shape == (8, 7) + IMG
    assert float(np.abs(grid[:, 3] - direct[None]).max()) <= \
        1e-5 * float(np.abs(direct).max())


# loads each artifact with torch alone (run outside the checkout) on the
# card and encodes the frames in chunks of 32; float32 convolutions in
# full float32, as the port's entry points run them
ARTIFACT_LOADER = r"""
import json, sys
import numpy as np, torch
torch.backends.cudnn.allow_tf32 = False
for job in json.loads(sys.argv[1]):
    enc = torch.jit.load(job["artifact"], map_location="cuda").eval()
    obs = np.load(job["frames"])
    with torch.no_grad():
        states = torch.cat([enc(torch.from_numpy(obs[s:s + 32]).to(
            "cuda").float()).cpu() for s in range(0, len(obs), 32)])
    np.save(job["states"], states.numpy())
print(json.dumps([m for m in sys.modules if m.startswith("srl_zoo_tpu")]))
"""


def test_torch_export_runs_on_torch_alone(cuda, runs, tmp_path):
    """The runs of configs 1, 2 (the VAE's mu), 5, the 6-channel config
    and the mlp exported as TorchScript, and config 5's as a
    ``--state-dict`` file (torchvision's keys, no normalizer, the run's
    weights). A subprocess that imports torch only, outside the checkout,
    loads each artifact on the card with no module of the port loaded and
    encodes 256 of the run's uint8 frames as float: within 1e-4 of the
    largest |state| of the port's StateEncoder on the card."""
    from srl_zoo_tpu_torch.export.torch_export import export_torch_encoder
    from srl_zoo_tpu_torch.inference import StateEncoder
    names = ("autoencoder", "vae", "triplet", "multiview", "mlp")
    jobs, frames = [], {}
    for name in names:
        run = runs(name)
        frames[name] = stacked_frames(run.dataset, np.arange(256), run.cfg)
        np.save(tmp_path / f"{name}_frames.npy", frames[name])
        jobs.append({"artifact": export_torch_encoder(run.dir),
                     "frames": str(tmp_path / f"{name}_frames.npy"),
                     "states": str(tmp_path / f"{name}_states.npy")})
    triplet = runs("triplet").dir
    sd = torch.load(export_torch_encoder(triplet, str(tmp_path / "sd.pt"),
                                         torchscript=False),
                    weights_only=True)
    enc = {k[len("encoder."):]: v for k, v in torch.load(
        f"{triplet}/srl_model.pth", weights_only=True).items()
        if k.startswith("encoder.")}
    assert "shift" not in sd and "scale" not in sd
    assert sd.keys() == enc.keys() and "layer4.1.conv2.weight" in sd
    assert all(torch.equal(v, enc[k]) for k, v in sd.items())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", ARTIFACT_LOADER,
                          json.dumps(jobs)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    for name, job in zip(names, jobs):
        want = StateEncoder.load(runs(name).dir).encode(frames[name])
        got = np.load(job["states"])
        assert float(np.abs(got - want).max()) <= \
            1e-4 * float(np.abs(want).max()), name


# ---------------------------------------------------------------------------
# the data layer
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def k2_by_batch():
    """K2's launches split by the kind of batch a step took (``streamed``:
    uint8 pixels; ``slot``: a hybrid store's slots; ``index``: the whole
    store's rows), over the learner's steps and the epoch runner's
    phases (whose kind the stacked batches say)."""
    from srl_zoo_tpu_torch.ops.gather_norm import gather_normalize
    from srl_zoo_tpu_torch.training import learner as learner_mod
    from srl_zoo_tpu_torch.training.epoch import EpochRunner
    counts = {"streamed": 0, "slot": 0, "index": 0}
    stacked = ["index"]

    def counted(fn, kind_of):
        def run(*args, **kw):
            kind = kind_of(args)
            before = gather_normalize.launches
            out = fn(*args, **kw)
            counts[kind] += gather_normalize.launches - before
            return out
        return run

    def step_kind(batch):
        return "streamed" if "obs" in batch else \
            "slot" if "cache_slots" in batch else "index"

    def stack(batches, *args, real=learner_mod.stack_batches):
        stacked[0] = step_kind(batches[0])
        return real(batches, *args)
    with contextlib.ExitStack() as patches:
        for owner, name, fn in (
                (learner_mod, "train_step", counted(
                    learner_mod.train_step, lambda a: step_kind(a[3]))),
                (learner_mod, "eval_step", counted(
                    learner_mod.eval_step, lambda a: step_kind(a[2]))),
                (learner_mod, "stack_batches", stack),
                (EpochRunner, "train_epoch", counted(
                    EpochRunner.train_epoch, lambda a: stacked[0])),
                (EpochRunner, "eval_epoch", counted(
                    EpochRunner.eval_epoch, lambda a: stacked[0]))):
            patches.enter_context(mock.patch.object(owner, name, fn))
        yield counts


def train_data_run(data: str, run: str, tokens, epochs: int, flags,
                   kw=None, env=None):
    """One run of the train CLI on the data layer's paths (``flags``, the
    environment ``env`` set around it): its launches, counted from zero
    (K1f, K1b and K2 must run), K2's launches by kind of batch, and its
    learner. Its losses and exported states are finite."""
    from srl_zoo_tpu_torch import train as train_cli
    with mock.patch.dict(os.environ, env or {}), learners() as built, \
            k2_by_batch() as k2, launches() as ran:
        train_cli.main(["--data-folder", data, "--losses", *tokens,
                        *cli_flags(kw or {}), "--state-dim", str(STATE_DIM),
                        "-bs", str(BATCH), "--epochs", str(epochs),
                        "--log-folder", run, "--num-cpu",
                        str(os.cpu_count() or 4), *flags])
    assert all(ran[k] > 0 for k in POOL_KERNELS + ("gather_normalize",)), ran
    hist = np.load(os.path.join(run, "loss_history.npz"))
    assert np.isfinite(hist["train/total"]).all()
    assert np.isfinite(np.load(os.path.join(run, "states_rewards.npz")
                               )["states"]).all()
    return ran, k2, built[0]


def check_hybrid_store(learner, dataset, epochs: int) -> None:
    """The store invariant after ``epochs`` epochs: every resident row's
    slot holds that row's bytes, in each view the store holds; and the
    hybrid export (the CLI's states_rewards.npz, through the rotated
    window and streaming) against an export from the whole store (1e-5
    of the largest |state|)."""
    from srl_zoo_tpu_torch.data.device_cache import build_cache
    from srl_zoo_tpu_torch.evaluation.predict_dataset import predict_states
    from srl_zoo_tpu_torch.inference import StateEncoder
    hot = learner._hot_store
    assert hot is not None and hot.rotate and hot.epoch == epochs, hot
    resident = np.nonzero(hot.slot_of >= 0)[0]
    dev = hot.cache["frames"].device
    for name in hot.cache:
        for s in range(0, len(resident), 512):
            r = resident[s:s + 512]
            want = torch.from_numpy(np.asarray(getattr(dataset, name)[r]))
            got = hot.cache[name][torch.from_numpy(
                hot.slot_of[r].astype(np.int64)).to(dev)]
            assert torch.equal(got, want.to(dev)), name
    states = np.load(os.path.join(learner.log_folder,
                                  "states_rewards.npz"))["states"]
    encoder = StateEncoder(learner.cfg, learner.model.eval(), dev)
    whole = predict_states(encoder, build_cache(dataset, dev))
    assert float(np.abs(states - whole).max()) <= \
        1e-5 * float(np.abs(whole).max())


@pytest.fixture(scope="module")
def recorded(train_data, tmp_path_factory) -> str:
    """1,024 frames of the scene (both views, its first four episodes)
    recorded as JPEG episodes with ``DatasetRecorder`` and preprocessed
    (no frames cache yet)."""
    from srl_zoo_tpu_torch.data.record import DatasetRecorder
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.preprocessing.preprocess import preprocess_folder
    ds = load_dataset(train_data)
    folder = str(tmp_path_factory.mktemp("recorded") / "data")
    ep_len = TRAIN_FRAMES // TRAIN_EPISODES
    rec = DatasetRecorder(folder)
    for e in range(DATA_FRAMES // ep_len):
        rec.new_episode()
        rows = np.arange(e * ep_len, (e + 1) * ep_len)
        # the reward of acting at t: the scene's next reward
        for i, r in zip(rows, np.append(ds.rewards[rows[1:]], 0.0)):
            rec.record(ds.frames[i], ds.actions[i], r,
                       ds.ground_truth_states[i], obs_2=ds.frames_2[i])
    rec.close()
    preprocess_folder(folder)
    return folder


def test_recorded_episodes_give_back_the_scene(cuda, train_data, recorded):
    """The preprocessed schema gives back the scene's actions, ground
    truth and rewards (shifted by the recording convention: 0 at an
    episode's start)."""
    from srl_zoo_tpu_torch.data.schema import load_dataset
    ds, got = load_dataset(train_data), load_dataset(recorded)
    rows = np.arange(DATA_FRAMES)
    starts = got.episode_starts
    assert got.n_samples == DATA_FRAMES and got.images_path_2 is not None
    assert np.array_equal(got.actions, ds.actions[rows])
    assert np.array_equal(got.ground_truth_states,
                          ds.ground_truth_states[rows])
    assert np.array_equal(got.rewards[~starts], ds.rewards[rows][~starts])
    assert not got.rewards[starts].any()


def test_streamed_and_slot_steps_do_not_synchronise(cuda, train_data):
    """Under ``set_sync_debug_mode("error")``: whole streamed train steps
    of config 1 (the batch's copy to the card included), with and without
    ``--stream-overlap``'s copy stream; a train step of config 3 on a
    hybrid store's slot batch; and the store's adoption of a streamed
    batch of entering rows. The batches are assembled in pinned memory
    first, and each kind of call runs once before, outside the mode."""
    from torch_card_lib import assert_no_sync, train_config
    from srl_zoo_tpu_torch.data.hybrid import RotatingHotStore
    from srl_zoo_tpu_torch.data.loader import DataLoader, batch_flags
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.data.transfer import stream_batches
    from srl_zoo_tpu_torch.training.state import make_model, make_optimizer
    from srl_zoo_tpu_torch.training.train_step import train_step
    ds = load_dataset(train_data)
    gen = torch.Generator(device=cuda).manual_seed(SEED)
    cfg1, cfg3 = train_config(["autoencoder"]), train_config(["priors"])
    m1, m3 = make_model(cfg1, cuda), make_model(cfg3, cuda)
    o1, o3 = make_optimizer(cfg1, m1), make_optimizer(cfg3, m3)
    pinned = list(DataLoader(ds, np.arange(BATCH * 6), BATCH, shuffle=False,
                             emit_images=True, pin_memory=True,
                             **batch_flags(cfg1)))
    hot = RotatingHotStore(ds, cuda, cfg3, HYBRID_ROWS)
    hot.begin_epoch()
    slot_rows = np.nonzero(hot.trainable_mask(np.arange(TRAIN_FRAMES - 1)))[0]
    slot_batch = next(iter(DataLoader(ds, slot_rows, BATCH,
                                      slot_map=hot.slot_of,
                                      **batch_flags(cfg3))))
    entering = list(stream_batches(DataLoader(
        ds, hot._entering[:2 * BATCH], BATCH, shuffle=False,
        emit_images=True, pin_memory=True, **batch_flags(cfg3)), cuda))

    def streamed(batches, overlap):
        for b in stream_batches(batches, cuda, overlap):
            train_step(m1, o1, None, b, gen)

    def calls(first: bool) -> list:
        # the first pass takes batches 0, 1-2 and entering batch 0; the
        # checked one 3, 4-5 and entering batch 1
        a = 0 if first else 3
        return [("streamed train_step of autoencoder",
                 lambda: streamed(pinned[a:a + 1], False)),
                ("streamed train_steps with --stream-overlap",
                 lambda: streamed(pinned[a + 1:a + 3], True)),
                ("slot-addressed train_step of priors",
                 lambda: train_step(m3, o3, hot.cache, slot_batch, gen)),
                ("adoption of a streamed batch of entering rows",
                 lambda: hot.maybe_adopt(entering[a > 0]["indices"],
                                         entering[a > 0]))]
    for _, call in calls(True):
        call()
    assert_no_sync(calls(False))


# name, --losses tokens, flags, config fields, environment, epochs: config
# 1 streamed from the recorded JPEGs and from the memmap, with and
# without --stream-overlap; config 5 on a rotating hybrid store of about
# half the rows; config 3 with --balanced-sampling
HYBRID_BUDGET_MB = str((HYBRID_ROWS + 0.5) * 2 * np.prod(IMG) / 2**20)
DATA_RUNS = {
    "jpegs": (("autoencoder",), ["--device-cache", "off"], {}, {}, 2),
    "memmap": (("autoencoder",), ["--device-cache", "off"], {}, {}, 2),
    "memmap-overlap": (("autoencoder",), ["--device-cache", "off",
                                          "--stream-overlap"], {}, {}, 2),
    "hybrid": (("triplet",), ["--device-cache", "hybrid"], RESNET_VIEWS,
               {"SRL_ZOO_CACHE_BUDGET_MB": HYBRID_BUDGET_MB}, 3),
    "balanced": (("priors",), ["--balanced-sampling"], {}, {}, 2),
}


@pytest.mark.parametrize("name", DATA_RUNS)
def test_data_layer_run(cuda, train_data, recorded, tmp_path, name):
    """The train CLI on the data layer's paths (``DATA_RUNS``): a streamed
    run launches K2 on streamed batches only, the hybrid run on streamed
    and slot batches and holds its store invariant and its export. After
    the run from the JPEGs (no ``frames.npy`` there), both views' frames
    caches are built from them and held against the scene's pixels: the
    mean error within 3 levels."""
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.preprocessing.preprocess import \
        refresh_frames_caches
    tokens, flags, kw, env, epochs = DATA_RUNS[name]
    folder = recorded if name == "jpegs" else train_data
    _, k2, learner = train_data_run(folder, str(tmp_path / "run"), tokens,
                                    epochs, flags, kw, env)
    if flags[:2] == ["--device-cache", "off"]:
        assert k2["streamed"] and not k2["slot"] and not k2["index"], k2
    if name == "hybrid":
        assert k2["streamed"] and k2["slot"], k2
        check_hybrid_store(learner, load_dataset(folder), epochs)
    if name == "jpegs":
        refresh_frames_caches(recorded, IMG[0])
        ds, got = load_dataset(train_data), load_dataset(recorded)
        for view in ("frames", "frames_2"):
            a = np.asarray(getattr(got, view), np.int16)
            b = np.asarray(getattr(ds, view)[:DATA_FRAMES], np.int16)
            assert a.shape == b.shape
            assert float(np.abs(a - b).mean()) <= 3.0, view


# ---------------------------------------------------------------------------
# a process group of world size 1
# ---------------------------------------------------------------------------

# config 1's streamed and hybrid runs, in the group and without one: name,
# flags and environment (the hybrid store holds about half the rows)
GROUP_STREAMS = {
    "off": (["--device-cache", "off"], {}),
    "off --stream-overlap": (["--device-cache", "off", "--stream-overlap"],
                             {}),
    "hybrid": (["--device-cache", "hybrid"], {
        "SRL_ZOO_CACHE_BUDGET_MB": str((HYBRID_ROWS + 0.5) * np.prod(IMG)
                                       / 2**20)}),
}
GROUP_EPOCHS = 2
# the hybrid run in the group against the same run alone: the largest
# relative difference of a training epoch mean allowed (the CPU tests'
# tolerance for a group against one process)
GROUP_HYBRID_RTOL = 2e-2


def run_streams(data: str, work, where: str) -> dict:
    """Each run of GROUP_STREAMS for 2 epochs, then KNN-MSE of its
    exported states, whose K3 launches count with the run's: K1f, K1b,
    K2 and K3 must launch, K2 on streamed batches only, and for the
    hybrid run on slot batches too. Returns {name: (run folder, learner,
    collectives)}."""
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.evaluation.knn import knn_mse
    from srl_zoo_tpu_torch.parallel import mesh
    gt = load_dataset(data).ground_truth_states
    out = {}
    for i, (name, (flags, env)) in enumerate(GROUP_STREAMS.items()):
        run = str(work / f"{where}_{i}")
        mesh.zero_counts()
        with launches() as ran:
            _, k2, learner = train_data_run(data, run, ("autoencoder",),
                                            GROUP_EPOCHS, flags, env=env)
            coll = dict(mesh.counts)
            knn_mse(np.load(os.path.join(run, "states_rewards.npz")
                            )["states"], gt, k=5, n_samples=KNN_QUERIES,
                    seed=SEED)
        assert ran["knn_topk"] and k2["streamed"] and not k2["index"], ran
        assert bool(k2["slot"]) == (name == "hybrid"), k2
        out[name] = (run, learner, coll)
    return out


def equal_runs(a: str, b: str) -> str:
    """'' where two run folders hold equal loss histories and exported
    states, else what differs."""
    for name in ("loss_history.npz", "states_rewards.npz"):
        x, y = np.load(os.path.join(a, name)), np.load(os.path.join(b, name))
        for key in y.files:
            if not np.array_equal(x[key], y[key]):
                return f"{name} {key}"
    return ""


def train_deviation(a: str, b: str) -> list:
    """By epoch, the largest relative difference between two run folders'
    training epoch means, each loss term relative to its largest |mean|
    in ``b``."""
    x, y = (np.load(os.path.join(r, "loss_history.npz")) for r in (a, b))
    keys = [k for k in y.files if k.startswith("train/")]
    return [max(float(abs(x[k][e] - y[k][e]) / np.abs(y[k]).max())
                for k in keys) for e in range(len(y[keys[0]]))]


@pytest.fixture
def deterministic_cudnn():
    """cuDNN on its deterministic algorithms: its default weight-gradient
    algorithms add in a varying order, and two runs of one config then
    part in the fourth digit of the loss."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def test_world_size_1_group(cuda, train_data, tmp_path, deterministic_cudnn):
    """A process group of world size 1 over nccl (``parallel/mesh.py``),
    in which config 1 trains for 2 epochs with ``--device-cache sharded``,
    with the whole store (``on``), then streamed, streamed with
    ``--stream-overlap`` and through a rotating hybrid store of about half
    the rows; the last three again without a group. The sharded run
    launches K2, K1f and K1b and gathers by reduce-scatter; the sharded
    and the streamed runs' losses and exported states equal the whole
    store's bit for bit; the hybrid run in the group adopts through uint8
    all-gathers, holds the store invariant as the lone run does, ends on
    the lone run's slot map and keeps its training epoch means within
    2e-2 of the lone run's."""
    from srl_zoo_tpu_torch import train as train_cli
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.parallel import mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mesh.initialize_distributed(f"127.0.0.1:{port}", 1, 0, cuda)
    try:
        assert mesh.dist.get_backend() == "nccl"
        whole = {}
        for mode in ("sharded", "on"):
            mesh.zero_counts()
            with launches() as ran:
                whole[mode] = train_cli.main([
                    "--data-folder", train_data, "--losses", "autoencoder",
                    "--state-dim", str(STATE_DIM), "-bs", str(BATCH),
                    "--epochs", str(GROUP_EPOCHS), "--device-cache", mode,
                    "--log-folder", str(tmp_path / mode)])
            if mode == "sharded":
                assert all(ran[k] for k in POOL_KERNELS
                           + ("gather_normalize",)), ran
                assert mesh.counts["reduce_scatter"], mesh.counts
        grouped = run_streams(train_data, tmp_path, "group")
    finally:
        mesh.shutdown()
    alone = run_streams(train_data, tmp_path, "alone")
    for run in (whole["sharded"], grouped["off"][0],
                grouped["off --stream-overlap"][0]):
        assert equal_runs(run, whole["on"]) == "", run
    dataset = load_dataset(train_data)
    (g_run, g_learner, g_coll), (a_run, a_learner, _) = \
        grouped["hybrid"], alone["hybrid"]
    assert g_coll["all_gather_frames"], g_coll
    for learner in (g_learner, a_learner):
        check_hybrid_store(learner, dataset, GROUP_EPOCHS)
    assert np.array_equal(g_learner._hot_store.slot_of,
                          a_learner._hot_store.slot_of)
    assert max(train_deviation(g_run, a_run)) <= GROUP_HYBRID_RTOL


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def test_pipeline_of_config_5(cuda, train_data, tmp_path, monkeypatch):
    """BASELINE config 5 (triplet, ResNet-18, two views, 2 epochs, seeds 1
    and 2) through ``srl_zoo_tpu_torch.pipeline.main``: training, KNN-MSE
    of all 4,096 states with three neighbour grids, the reward probe and
    the report. K1f, K1b, K2 and K3 run, the pools and the gather on
    their vector path. Each seed's KNN-MSE equals a direct ``knn_mse`` of
    its states (1e-6); the report holds both seeds' mean and std of
    KNN-MSE, GTC and reward accuracy (in [0, 1]); the grids,
    ``knn_mse.json`` and ``reward_accuracy.json`` are written."""
    from srl_zoo_tpu_torch import pipeline
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.evaluation.knn import knn_mse
    seeds = (1, 2)
    monkeypatch.chdir(tmp_path)
    with launches() as ran:
        results = pipeline.main([
            "--data-folder", train_data, "--losses", "triplet",
            "--model-types", "resnet", "--multi-view", "--img-size",
            str(IMG[0]), "--state-dims", str(STATE_DIM), "-bs", str(BATCH),
            "--epochs", "2", "--seeds", *map(str, seeds)])
    assert all(ran[k] > 0 for k in POOL_KERNELS + ("gather_normalize",
                                                   "knn_topk")), ran
    with open(os.path.join("logs", os.path.basename(train_data),
                           "pipeline_report.json")) as f:
        report = json.load(f)
    assert report == results and len(report) == 1
    (cell,) = report
    assert cell["seeds"] == list(seeds)
    gt = load_dataset(train_data).ground_truth_states
    per_seed = {"knn_mse": [], "gtc": [], "reward_accuracy": []}
    for folder in cell["log_folders"]:
        def read(name, key):
            with open(os.path.join(folder, name)) as f:
                return json.load(f)[key]
        states = np.load(os.path.join(folder, "states_rewards.npz"))["states"]
        knn = read("knn_mse.json", "knn_mse")
        direct, _, _ = knn_mse(states, gt, k=5)
        assert abs(knn - direct) <= 1e-6 * abs(direct), (knn, direct)
        acc = read("reward_accuracy.json", "accuracy")
        assert 0.0 <= acc <= 1.0
        with open(os.path.join(folder, "gtc.txt")) as f:
            per_seed["gtc"].append(float(f.read()))
        per_seed["knn_mse"].append(knn)
        per_seed["reward_accuracy"].append(acc)
        for name in ["states.png", "correlation.png"] + [
                f"NearestNeighbors/knn_grid_{g}.png" for g in range(3)]:
            assert os.path.isfile(os.path.join(folder, name)), name
    for key, vals in per_seed.items():
        tol = 1e-6 * max(1.0, abs(cell[key]))
        assert abs(cell[key] - np.mean(vals)) <= tol, (key, cell, vals)
        assert abs(cell[f"{key}_std"] - np.std(vals)) <= tol, (key, vals)
