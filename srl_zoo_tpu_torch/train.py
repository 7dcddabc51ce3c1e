"""Train an SRL model with the PyTorch port (port of the JAX package's
``train.py``, same flags plus ``--device``).

    python -m srl_zoo_tpu_torch.train --data-folder data/<ds> \\
        --losses autoencoder --model-type custom_cnn --state-dim 200 \\
        -bs 32 --epochs 30 --log-folder logs/<run>

The run folder gets ``exp_config.json``, ``srl_model.pth`` (the best
validation weights), ``loss_history.npz``, ``metrics.jsonl``,
``checkpoints/`` (resume), ``states_rewards.npz`` (states of the whole
dataset), ``states.png``, ``correlation.png`` and ``gtc.txt``; with
``--plot-every N``, ``plots/epoch_<e>.png`` and ``plots/latest.png``
every N epochs, ``plots/live.html`` (a page that follows
``latest.png``) and, unless ``--no-display-plots`` or headless, a live
window. It runs on CUDA unless ``--device cpu`` is given; without a GPU
it raises. It trains every loss of the zoo, alone or as SRL splits
(``name:weight:split_dim``): autoencoder, vae (``--beta``), dae
(``--noise-type``, ``--occlusion-percentage``, ``--noise-std``),
perceptual (a frozen DAE run of the port, ``--path-to-dae``), priors,
forward, inverse, reward (``--inverse-model-type``), triplet,
episode-prior (``--episode-prior-optimizer``), reward-prior, supervised
(its slice as wide as the ground truth) and random (no training: the
initial model is exported), with ``--grad-accum`` micro-steps per Adam
step, on the custom_cnn, resnet (ResNet-18, ``--pretrained-weights`` from
a torchvision state dict), mlp or linear encoder, computing in float32 or
(``--dtype bfloat16``) bfloat16;
``--multi-view`` reads a two-camera dataset (``frames_2.npy``, or its
second camera's images): triplet takes the second view as its positive,
any other loss stacks both views into a 6-channel input.
``--device-cache`` picks where the frames live (data/device_cache.py):
``auto`` keeps the whole ``frames.npy`` on the device where it fits the
budget (80% of free device memory, or ``SRL_ZOO_CACHE_BUDGET_MB``), else
a hybrid store of what fits (data/hybrid.py; rotating unless
``--no-hybrid-rotation``), else streams; ``on``, ``off`` and ``hybrid``
force one mode. Streamed batches are decoded from the JPEGs where the
folder has no ``frames.npy`` (the images are then taken at 224 x 224) on
``--num-cpu`` threads, and with ``--stream-overlap`` each batch's copy to
the device overlaps the step before it. ``--balanced-sampling`` draws
every reward class equally often. ``--profile`` writes a torch.profiler
trace of the first epoch's training into ``<log>/profile`` (summary:
``python -m srl_zoo_tpu_torch.utils.profiling --log-folder <log>``).

Data parallelism: N processes on one host, one per GPU, each run with
``--num-processes N --process-id i --coordinator-address host:port``
(rank 0 listens there; ``nccl`` on CUDA, ``gloo`` with ``--device
cpu``), train one model on the global batch (parallel/mesh.py); the
batch size must be divisible by N. Rank 0 writes the run folder, rank i
its logs into ``<log>/.proc<i>``. Every ``--device-cache`` mode runs
across processes: ``sharded`` splits the store over the ranks
(ops/sharded_store.py); ``off`` streams each rank's rows of a batch;
every rank holds the whole hybrid store and adopts a streamed batch's
entering rows from all ranks' pixels; every rank plans with the least of
the ranks' budgets. A ``--coordinator-address`` with one process starts a
group of one.
"""

from __future__ import annotations

import argparse
import datetime
import os
import shutil
import sys

import numpy as np
import torch

from srl_zoo_tpu_torch.config import (SRLConfig, build_config,
                                      parse_loss_arguments)
from srl_zoo_tpu_torch.data.schema import load_dataset, save_states_rewards
from srl_zoo_tpu_torch.evaluation.gtc import ground_truth_correlation
from srl_zoo_tpu_torch.plotting.representation_plot import (
    LiveView, plot_correlation, plot_representation)
from srl_zoo_tpu_torch.parallel import mesh
from srl_zoo_tpu_torch.training.learner import SRL4robotics
from srl_zoo_tpu_torch.utils.device import resolve_device
from srl_zoo_tpu_torch.utils.misc import (createFolder, parseDataFolder,
                                          printGreen, printYellow,
                                          set_global_seeds)

DEFAULT_BN_MOMENTUM = 0.9


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="State Representation Learning with a zoo of "
                    "objectives (PyTorch + CUDA port)")
    p.add_argument("--data-folder", type=str, required=True,
                   help="Dataset folder (data/<name> or <name>)")
    p.add_argument("--losses", nargs="+", type=str, default=["autoencoder"],
                   help="Losses as name[:weight[:split_dim]]")
    p.add_argument("--model-type", type=str, default="custom_cnn",
                   choices=["custom_cnn", "resnet", "mlp", "linear"])
    p.add_argument("--state-dim", type=int, default=2)
    p.add_argument("-bs", "--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("-lr", "--learning-rate", type=float, default=5e-3)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--val-size", type=float, default=0.2)
    p.add_argument("--training-set-size", type=int, default=-1,
                   help="Limit the number of training samples (-1 = all)")
    p.add_argument("--l1-reg", type=float, default=0.0)
    p.add_argument("--l2-reg", type=float, default=0.0)
    p.add_argument("--beta", type=float, default=1.0,
                   help="beta for the beta-VAE KL term")
    p.add_argument("--occlusion-percentage", type=float, default=0.5,
                   help="DAE occlusion fraction")
    p.add_argument("--noise-type", type=str, default="occlusion",
                   choices=["occlusion", "gaussian"])
    p.add_argument("--noise-std", type=float, default=0.2)
    p.add_argument("--multi-view", action="store_true")
    p.add_argument("--balanced-sampling", action="store_true")
    p.add_argument("--inverse-model-type", type=str, default="linear",
                   choices=["linear", "mlp"])
    p.add_argument("--bn-momentum", type=float, default=None,
                   help="BatchNorm running-average momentum, flax "
                        "convention ra = m*ra + (1-m)*batch (default 0.9 = "
                        "torch's 0.1; a resumed run keeps its saved value "
                        "unless this is given)")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--episode-prior-optimizer", type=str, default="shared",
                   choices=["shared", "separate"])
    p.add_argument("--path-to-dae", type=str, default="")
    p.add_argument("--pretrained-weights", type=str, default="")
    p.add_argument("--log-folder", type=str, default="",
                   help="Where to write the run (default: logs/<dataset>/"
                        "<timestamp>_<model>_<losses>)")
    p.add_argument("--num-cpu", type=int, default=4)
    p.add_argument("--no-display-plots", action="store_true",
                   help="No live window with --plot-every (the plots are "
                        "written to files either way)")
    p.add_argument("--plot-every", type=int, default=0,
                   help="Plot the states every N epochs (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the resume checkpoint in --log-folder")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="Write the resume checkpoint every N epochs")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device-cache", type=str, default="auto",
                   choices=["auto", "on", "off", "hybrid", "sharded"],
                   help="Where the frames live: 'auto' caches them on the "
                        "device where they fit, else a hybrid store, else "
                        "streams; 'on', 'off' and 'hybrid' force a mode")
    p.add_argument("--stream-overlap", default=False,
                   action=argparse.BooleanOptionalAction)
    p.add_argument("--no-hybrid-rotation", action="store_true",
                   default=False)
    p.add_argument("--coordinator-address", type=str, default="")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda)")
    return p.parse_args(argv)


def _process_group(args: argparse.Namespace, device: torch.device) -> bool:
    """Join the process group the flags ask for (a CUDA rank takes GPU
    ``process_id`` mod the GPU count unless ``--device`` names one);
    whether one was started."""
    if args.num_processes <= 1 and not args.coordinator_address:
        return False
    if device.type == "cuda" and torch.device(
            args.device or "cuda").index is None:
        device = torch.device(
            "cuda", args.process_id % torch.cuda.device_count())
    mesh.initialize_distributed(args.coordinator_address,
                                args.num_processes, args.process_id, device)
    return True


def default_log_folder(dataset_name: str, model_type: str,
                       loss_names) -> str:
    ts = datetime.datetime.now().strftime("%y-%m-%d_%Hh%M_%S")
    exp = f"{ts}_{model_type}_{'_'.join(loss_names)}"
    return os.path.join("logs", os.path.basename(dataset_name.rstrip("/")),
                        exp)


LIVE_HTML = ('<!doctype html><title>SRL live states</title>\n'
             '<meta http-equiv="refresh" content="2">\n'
             '<body style="background:#111;text-align:center">\n'
             '<img src="latest.png" style="max-width:100%">\n')


def _epoch_plots(dataset, log_folder: str, every: int, display: bool):
    """The learner's epoch callback of ``--plot-every``, and the live
    window it updates (None where there is none). Every ``every`` epochs
    it plots the states of every ``max(n // 2000, 1)``-th row to
    ``plots/epoch_<e>.png`` and copies that to ``plots/latest.png``,
    which ``plots/live.html`` (written now) reloads."""
    rows = np.arange(0, dataset.n_samples,
                     max(dataset.n_samples // 2000, 1), dtype=np.int64)
    plots_dir = os.path.join(log_folder, "plots")
    os.makedirs(plots_dir, exist_ok=True)
    with open(os.path.join(plots_dir, "live.html"), "w") as f:
        f.write(LIVE_HTML)
    live_view = LiveView.create() if display else None

    def callback(learner, epoch, train_metrics, val_metrics):
        if (epoch + 1) % every:
            return
        states = learner.predict_states(dataset, rows)
        title = f"States after epoch {epoch + 1}"
        path = os.path.join(plots_dir, f"epoch_{epoch + 1}.png")
        plot_representation(states, dataset.rewards[rows], path, title=title)
        shutil.copyfile(path, os.path.join(plots_dir, "latest.png"))
        if live_view is not None:
            live_view.update(states, dataset.rewards[rows], title)
    return callback, live_view


def main(argv=None) -> str:
    args = parse_args(argv)
    device = resolve_device(args.device)  # no GPU: raise before any write
    started = _process_group(args, device)
    if started and device.type == "cuda":
        device = resolve_device(None)  # the rank's GPU
    try:
        return _train(args, device)
    finally:
        if started:
            mesh.shutdown()


def _train(args: argparse.Namespace, device: torch.device) -> str:
    set_global_seeds(args.seed)

    dataset_name = parseDataFolder(args.data_folder)
    data_folder = args.data_folder if os.path.isdir(args.data_folder) \
        else os.path.join("data", dataset_name)
    if not os.path.isdir(data_folder):
        printYellow(f"Dataset folder not found: {data_folder}")
        sys.exit(1)
    losses, split_dims = parse_loss_arguments(args.losses, args.state_dim)
    if args.resume and not args.log_folder:
        printYellow("--resume needs --log-folder pointing at the previous "
                    "run (the default log folder is a fresh timestamp)")
        sys.exit(1)
    log_folder = args.log_folder or default_log_folder(
        dataset_name, args.model_type, list(losses))
    if args.bn_momentum is None:
        # a resumed run keeps the momentum it trained at (a config written
        # before the key existed trained at flax's 0.99)
        saved = os.path.join(log_folder, "exp_config.json")
        args.bn_momentum = SRLConfig.load(log_folder).bn_momentum \
            if args.resume and os.path.exists(saved) else DEFAULT_BN_MOMENTUM

    dataset = load_dataset(data_folder)
    img_shape = tuple(dataset.frames.shape[1:]) \
        if dataset.frames is not None else None
    args.log_folder, args.data_folder = log_folder, data_folder
    cfg = build_config(args, losses, split_dims,
                       n_actions=dataset.n_actions,
                       n_reward_classes=dataset.n_reward_classes,
                       img_shape=img_shape)
    # rank 0 writes the run folder; rank i its own copy of the run's
    # records in <log>/.proc<i>
    out = mesh.rank_folder(log_folder)
    createFolder(out, f"Log folder {out} already exists")
    cfg.save(out)
    printGreen(f"Training {cfg.model_type} with losses {dict(cfg.losses)} "
               f"-> {out}")

    learner = SRL4robotics(cfg, log_folder=log_folder, device=device)
    epoch_callback, live_view = None, None
    if args.plot_every > 0:
        epoch_callback, live_view = _epoch_plots(
            dataset, out, args.plot_every, not args.no_display_plots)
    try:
        learner.learn(dataset, resume=args.resume,
                      checkpoint_every=args.checkpoint_every,
                      epoch_callback=epoch_callback, profile=args.profile)
    finally:
        if live_view is not None:
            live_view.close()

    states = learner.predict_states(dataset)
    save_states_rewards(out, states, dataset.rewards)
    printGreen(f"Saved states_rewards.npz ({states.shape})")
    plot_representation(states, dataset.rewards,
                        os.path.join(out, "states.png"))
    gtc, corr = ground_truth_correlation(states, dataset.ground_truth_states)
    plot_correlation(corr, os.path.join(out, "correlation.png"))
    printGreen(f"GTC score: {gtc:.4f}")
    with open(os.path.join(out, "gtc.txt"), "w") as f:
        f.write(f"{gtc:.6f}\n")
    return log_folder


if __name__ == "__main__":
    main()
