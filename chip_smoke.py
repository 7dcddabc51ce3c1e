#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's inference, training and pipeline paths on
one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --pools-of CHECKOUT
    python3 chip_smoke.py --step-seeds N
    python3 chip_smoke.py --data-layer
    python3 chip_smoke.py --dist-tooling

Needs one CUDA card, nvcc (CUDA_HOME or PATH) and this checkout; it builds
the kernels of ``srl_zoo_tpu_torch/csrc`` itself. Phases, each of which
must pass (else the exit code is 1 and no result line is printed); each
prints its wall time:

1. The card's name and power limit (nvidia-smi); the kernels' build time.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it, timed beside its bound:
   relu + pool (K1f) at the three pools of a config-1 forward, at the
   serve and training batch (32) and the export batch (256), in f32 and
   bf16 (``--dtype bfloat16``), y and argmax exact; its backward (K1b) at
   the three pools of a batch-32 train step, exact on integer-valued
   inputs and within 1e-6 of the largest |g| on random floats, in f32 and
   bf16. Both pools must take their vector path there, and each is timed
   twice: the kernel alone (torch.profiler's device time over 10 calls)
   and the wrapper (CUDA events over 100 calls, Python included), K1f
   also as the training forward (with the index plane, at batch 32).
   Then both pools, exact,
   at edge shapes that reach the scalar path and the tile edges (C 3, 12,
   66 and 64 in f32, 12 and 64 in bf16; 9x13 and 1x1 images, B 1, pads
   of 0, 2 and 1 per side; slices at an odd storage offset), each on the
   path its shape selects. Both pools at the ResNet stem's shape (32,
   112, 112, 64) with its explicit pads ((1, 1), (1, 1)), in f32 and
   bf16: the inference and training forward and the backward, exact and
   on the vector path, each timed beside its bound. Gather + normalize (K2) of
   256 random rows of
   a 20,000-frame 224x224x3 store from a host index and of 32 rows (the
   training batch), both modes, within 1e-6 on the vector path, device
   and wrapper time; over the identity index (a streamed batch's
   normalize) at (32, 224, 224, 3) and (32, 224, 224, 6), the same way;
   then at edge shapes (9x13 frames of C 1, 3, 4, 6 and
   8, 16x16x1, one frame, B 1 and 7, store slices at offsets 1 and 4),
   each on the path it selects, and IndexError for -1 and N from host
   and CUDA indices. Under ``torch.cuda.set_sync_debug_mode("error")``,
   K2 at 256 and 32 rows from a host index, and a whole train step and
   eval step (``train_step``, ``eval_step``: inputs, forward, loss,
   backward, Adam) of configs 1, 3 and 5, of configs 1 and 5 at
   ``--dtype bfloat16`` and config 1's loss on the mlp model type, and
   of ``dae``, ``perceptual``
   (through a frozen DAE), ``episode-prior autoencoder`` and
   ``autoencoder --grad-accum 4`` (a full cycle of four micro-steps),
   must not synchronise. Distance +
   top-k (K3) at Q=4,096, N=20,000, D=200, k=6 and at ten ragged shapes
   (Q 1 and 130, N = k and 1,111, D 1 to 600, k 1 to 64), distances
   within 1e-4 relative and indices equal except at ties within that
   tolerance (counted), timed as all of a call's kernels together;
   4,096 queries that are references must find themselves first at a
   distance of exactly 0; pairwise distances (K4) at the same Q, N, D,
   each element within 1e-5 of |x|^2 + |y|^2 against the plain version
   (and at four ragged shapes) and against float64 on a 512 x 512
   corner, timed beside ``torch.cdist`` (the library call), and the
   ``full`` route's top-6 indices against K3's, equal except at counted
   near ties.
2b. K3 over 4 contiguous blocks of the main shape's 20,000 references on
   the one card, each block's candidates offset and merged by
   ``merge_topk`` (the merge of ``knn_topk_sharded``), against K3 over
   the whole set: indices equal but at counted near ties, distances
   within 1e-5 relative; the block calls, the merge and the whole-set
   call timed (CUDA events). Launches counted from zero: 4 of K3.
3. The inference path at the full width of config 1 (custom_cnn,
   224x224x3, state_dim 200), from a seeded random model saved as a run
   folder: the HTTP server (coalescing 5 ms, max batch 32) answers two
   rounds of 8 concurrent single frames and 2 batches of 16, the first as
   a fresh server's first clients see it; states are exported for the
   20,000-frame store in batches of 256; KNN-MSE (k=5) scores 4,096
   sampled queries with the fused kernel, and the ``full`` route (K4 and a
   stable sort) finds the same queries' 6 nearest. Kernel launch counts
   are zeroed just before and read just after; K1, K2, K3 and K4 must have
   run, and every pool and gather launch must have taken the vector path.
   Then the replies are held against a direct encode (1e-5), 64
   exported rows against a direct encode (1e-5), the score against the
   plain top-k's (1e-6), the ``full`` route's indices against the fused
   route's (equal but at counted near ties) and its score against the
   fused one's (1e-6), and an export of 2,048 rows is profiled (device
   time by kernel, busy share).
4. Training of BASELINE configs 1-5 (224x224x3, state_dim 200, batch 32,
   lr 5e-3, BN momentum 0.9): 1 autoencoder, 2 vae, 3 priors, 4
   ``autoencoder:1:100 inverse:2:50 forward:1:25 reward:1:25`` (custom_cnn),
   5 triplet (ResNet-18, ``--multi-view``), and the 6-channel input of
   ``--multi-view`` without triplet (ResNet-18, priors). For each: one
   train step on the card against the same step on the CPU (plain
   versions) and in float64, batch 8, from the same weights (and the
   VAE's same eps): loss and gradients within twice the CPU f32 step's
   deviation from float64 (the ResNet steps: the whole gradient's and the
   stem's relative L2, the CPU at the larger of two orders of summation,
   all cores and one thread). A two-camera 4,096-frame 224x224x3 dataset
   folder with structure is written (the second view mirrored, in other
   colours; view 1 also as the JPEGs ``images_path`` names), and the
   train CLI (``srl_zoo_tpu_torch.train.main``) trains each config on it
   (config 1 for 3 epochs with ``--plot-every 1``, the others for 2),
   checkpointing through ``AsyncCheckpointer`` (the main thread's seconds
   inside its calls are printed per epoch), exports its states, scores
   GTC and plots ``states.png`` and ``correlation.png`` (config 1 also
   ``plots/epoch_<e>.png``, ``latest.png`` and ``live.html``, and its
   ``checkpoints/state_latest.pth`` must load at the run's epoch and
   step); KNN-MSE of
   the exported states is then scored through both neighbour routes (K3
   and K4), and the server answers one round of 8 concurrent frames from
   each ResNet run. Launch counts are zeroed just before and read just
   after; K1, K1b, K2, K3 and K4 must have run, the pools and the gather
   on their vector path. The training loss must fall, the exported
   states and the served ones must match a direct encode (1e-5), and the
   two routes' scores must agree (1e-6); train images/s and export
   states/s are printed. Then each pool's input must be channels_last
   (the pool reads it in place), and 8 train steps each of configs 1 and
   5 are profiled after one more step in the profiler's warm-up (device
   time by kernel, busy share, layout transposes and the operations that
   launch them); the window must hold every K2 launch of its 8 steps.
   Then the rest of the loss zoo at config 1's width (custom_cnn,
   224x224x3, state_dim 200, batch 32), each with the card-vs-CPU-vs-
   float64 step (the same DAE draws, episode pairs and frozen-DAE weights
   on every device) and, but for the gaussian DAE, the train CLI for 2
   epochs, export, KNN-MSE by both routes and the launch counts as
   above: ``dae`` (occlusion 0.5), ``dae --noise-type gaussian`` (the
   step alone), ``perceptual --path-to-dae`` the ``dae`` run (its K1b
   launches must be 2 x 3 per step: the gradient goes through the frozen
   DAE's pools), ``episode-prior autoencoder --episode-prior-optimizer
   separate`` (its discriminator and encoder BCE printed), ``reward-prior
   autoencoder``, ``supervised:1:2 autoencoder:1:198`` (the ground truth
   is 2 wide), ``autoencoder --grad-accum 4`` (Adam's step count in
   ``state_latest.pth`` must be the micro-steps // 4, across epochs) and
   ``random`` (no train step, no K1b: ``srl_model.pth`` must equal the
   seed's initial model and the export a direct encode of it). 8 steps
   each of ``dae`` and ``perceptual`` are profiled as configs 1 and 5
   are, their pools' layouts checked first.
   Then configs 1 and 5 at ``--dtype bfloat16`` and the dense
   model types (``--model-type mlp --losses autoencoder``,
   ``--model-type linear --losses priors``) at the same width, each with
   the card-vs-CPU-vs-float64 step (a bf16 step, whatever its model, is
   held as the ResNet f32 step is: loss, whole-gradient and first-layer
   relative L2 against the float32 config in float64, within twice the
   CPU bf16 step's deviation, the loss at least twice bfloat16's unit
   roundoff), the train CLI for 2 epochs, export, KNN-MSE by both routes
   and one served round of 8 frames. The bf16 runs must launch K1f and
   K1b in bf16 only, on the vector path; the mlp and linear runs K2, K3
   and K4 and no pool. 8 bf16 steps each of configs 1 and 5 are
   profiled beside their f32 profiles, the pools' inputs checked to be
   channels_last bf16.
4a. Config 1 (224x224x3, state_dim 200, batch 32) through the train CLI
   with ``--profile`` for one epoch of 640 rows: the trace must hold K1f,
   K1b and K2 launches under the kernels' names and sum device time
   (``utils/profiling.py``, whose top-12 table is printed); launch counts
   zeroed just before and read just after. Then the doctor on phase 4's
   dataset (``utils/doctor.py``): its pinned bandwidth and the mode it
   names, which must be the whole store. It runs before phase 4's
   configs, right after the dataset is written: after phase 4's training
   profiles CUPTI has been seen to record no kernel at all.
4b. The data layer at the same width (224x224x3, state_dim 200, batch
   32). 1,024 frames of phase 4's scene (both views, four episodes) are
   recorded as JPEG episodes with ``DatasetRecorder`` and preprocessed
   (the schema must give back the scene's actions, ground truth and
   shifted rewards). Under the sync debug mode, whole streamed train
   steps of config 1 (the copy to the card included), with and without
   ``--stream-overlap``'s copy stream, a slot-addressed step of config 3
   on a hybrid store and its adoption of a streamed batch must not
   synchronise. Then the train CLI runs config 1 with
   ``--device-cache off`` from the recorded JPEGs (no ``frames.npy``;
   then both views' frames caches are built from the JPEGs and held
   against the scene's pixels: largest and mean error, the mean within
   3 levels) and from phase 4's memmap, with and without
   ``--stream-overlap``; config 5 (triplet, ResNet-18, two views) with
   ``--device-cache hybrid`` for 3 epochs under a
   ``SRL_ZOO_CACHE_BUDGET_MB`` of 2,048 of the 4,096 rows (the store
   invariant after training, every resident row's slot holding its
   frame in both views, and the hybrid export against a whole-store
   export, 1e-5 of the largest |state|); and config 3 with
   ``--balanced-sampling`` for 2 epochs. Each run zeroes the launch
   counts just before and reads them just after (K1f, K1b and K2 must
   have run, on the vector path), splits K2's launches by the kind of
   batch (the streamed runs only streamed, the hybrid run streamed and
   by slot), and prints images/s by epoch and by phase (the learner's
   synchronised phase timing: hot, cold, adoption, rotation with its
   swept rows) and which routes of the native runtime served.
4c. A process group of world size 1 over nccl (``parallel/mesh.py``), in
   which config 1 trains through the train CLI for 2 epochs with
   ``--device-cache sharded`` and then ``on``, cuDNN on its
   deterministic algorithms; each run's collectives and launches counted
   from zero (the sharded run must launch K2, K1f and K1b and gather by
   reduce-scatter), and the two runs' losses and exported states must be
   equal bit for bit. Then config 1 at 224 px, batch 32, 2 epochs, in
   the group and again without one, streamed (``--device-cache off``),
   streamed with ``--stream-overlap`` and through a rotating hybrid store
   of 2,048 of the 4,096 rows (``SRL_ZOO_CACHE_BUDGET_MB``), each scored
   by KNN-MSE: K1f, K1b, K2 and K3 must launch in each run (K2 on
   streamed batches only, the hybrid run's also by slot); the streamed
   runs in the group must equal the whole store's bit for bit; the
   hybrid run in the group must adopt through uint8 all-gathers
   (``all_gather_frames``), hold the store invariant after its 2 epochs
   as the lone run does, end on the lone run's slot map, and keep its
   training epoch means within 2e-2 of the lone run's (the deviation is
   printed by epoch, beside the streamed pair's and beside the lone
   runs' own spread when their initial weights are perturbed by 1e-6);
   images/s by epoch and by phase for every run. Then an
   account of what the group costs config 1's
   step at batch 32 (wall ms, best of three windows of 30 steps): in the
   group, with ``nn.BatchNorm2d``'s own forward in place of the global
   BatchNorm, with the NCCL calls skipped, and without a group; a
   torch.profiler trace of the group's step and of the lone step, summed
   by the operators' CPU self time.
5. The pipeline at full width: BASELINE config 5 (triplet, ResNet-18,
   ``--multi-view``, 224x224x3, state_dim 200, batch 32, 2 epochs, seeds
   1 and 2) through ``srl_zoo_tpu_torch.pipeline.main`` on phase 4's
   dataset: training, KNN-MSE of all 4,096 states with three neighbour
   grids (``knn_images``), the reward probe and the report. Launch counts
   are zeroed just before and read just after; K1f, K1b, K2 and K3 must
   have run, the pools and the gather on their vector path. Each seed's
   KNN-MSE must equal a direct ``knn_mse`` of its states (1e-6), the
   report must hold both seeds' mean and std of KNN-MSE, GTC
   (``gtc.txt``) and reward accuracy (in [0, 1]), and the grids,
   ``knn_mse.json`` and ``reward_accuracy.json`` must be written; wall
   time, images/s and the scores are printed. Then ``enjoy_latent`` on
   config 1's run (8 dims x 7 steps at 224 px): ``latent_sweeps.png``,
   and the sweep's middle column within 1e-5 (of its largest value) of a
   direct decode of the mean state.
6. A ``{"kernels": [...]}`` line (launches summed over all the paths;
   every kernel with ``device_ms``, the kernel alone, beside ``ms``, the
   wrapper; K1f and K1b also with ``device_ms_bf16``, ``ms_bf16`` and
   ``bound_ms_bf16``, their three pools in bf16), the nvidia-smi line,
   and last ``{"ok": true, "device": {...}}``.

With ``--pools-of CHECKOUT`` it imports the port package of another
checkout (e.g. a ``git archive`` of the parent commit), builds that
checkout's kernels into its own ``build/``, runs phase 2's main-shape
checks and timings of K1f, K1b, K2 and K3 alone on them (K2 from a CUDA
index where that tree's wrapper takes no host index), and prints a
``{"tree": ..., "pool_times": [...], "kernel_times": [...]}`` line and the
card, so that the device times of two trees' kernels can be compared in
one run on one card.

With ``--data-layer`` it runs phase 2's K2 over the identity index and
phase 4b alone, on a freshly written phase 4 dataset.

With ``--dist-tooling`` it runs phases 2b, 4a and 4c alone, on a freshly
written phase 4 dataset.

With ``--step-seeds N`` it runs only phase 4's card-vs-CPU step of the
two ResNet configs and the two bf16 configs at seeds 0..N-1, holds
nothing, and prints each held measure's ratio to its limit per seed and
the largest over the seeds.

Bounds use the H100 SXM data-sheet rates at 700 W: 3.35 TB/s of device
memory and 67 TFLOP/s of float32 outside the tensor cores. No single
PyTorch call computes K1f's, K1b's, K2's or K3's function (K1b:
``max_pool2d_with_indices_backward`` takes int64 indices and has no relu
mask), so their ``library_ms`` is null; K4's is ``torch.cdist(x, y,
compute_mode="use_mm_for_euclid_dist")``, the same product and norms plus
a square root.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
N_FRAMES = 20_000
IMG = (224, 224, 3)
STATE_DIM = 200
SERVE_BATCH = 32
SEED = 0
# training: config 1's batch, a structured dataset written here, and the
# batch of the card-vs-CPU step
TRAIN_BATCH = 32
TRAIN_FRAMES = 4096
TRAIN_EPISODES = 16
CPU_STEP_BATCH = 8
PROFILE_STEPS = 8
KNN_QUERIES = 4096
POOLS = (IMG[0] // 2, IMG[0] // 8, IMG[0] // 32)  # 112, 28, 7 at 224
# back-to-back pool calls per wrapper time: at the 28^2 and 7^2 pools a
# call is host time, which swings with the shared host over 10 calls
WRAPPER_CALLS = 100
# config 5's model and views: ResNet-18 on a two-camera dataset
RESNET_VIEWS = {"model_type": "resnet", "multi_view": True}
# BASELINE configs 1-5: name, --losses tokens, epochs here (30 in the
# configs; cut to stay well inside the script's time limit), model and
# views; then the 6-channel input of --multi-view without triplet
TRAIN_CONFIGS = (
    ("autoencoder", ("autoencoder",), 3, {}),
    ("vae", ("vae",), 2, {}),
    ("priors", ("priors",), 2, {}),
    ("splits", ("autoencoder:1:100", "inverse:2:50", "forward:1:25",
                "reward:1:25"), 2, {}),
    ("triplet", ("triplet",), 2, RESNET_VIEWS),
    ("multiview", ("priors",), 2, RESNET_VIEWS),
)
# the rest of the loss zoo at config 1's width (custom_cnn, one view):
# name, --losses tokens, epochs (0: the card-vs-CPU step alone) and the
# config's other fields, each a train CLI flag (``path_to_dae`` names the
# run of this list that it reads)
ZOO_CONFIGS = (
    ("dae", ("dae",), 2, {}),
    ("dae-gaussian", ("dae",), 0, {"noise_type": "gaussian"}),
    ("perceptual", ("perceptual",), 2, {"path_to_dae": "dae"}),
    ("episode-prior", ("episode-prior", "autoencoder"), 2,
     {"episode_prior_optimizer": "separate"}),
    ("reward-prior", ("reward-prior", "autoencoder"), 2, {}),
    # the ground truth is 2 wide: the supervised loss reads a 2-wide slice
    ("supervised", ("supervised:1:2", f"autoencoder:1:{STATE_DIM - 2}"), 2,
     {}),
    ("grad-accum", ("autoencoder",), 2, {"grad_accum": 4}),
    ("random", ("random",), 2, {}),
)
# the zoo's configs whose whole train and eval steps the sync check runs
SYNC_ZOO = ("dae", "perceptual", "episode-prior", "grad-accum")
# configs 1 and 5 at --dtype bfloat16, and the dense model types (mlp on
# config 1's loss, linear on config 3's), through the train CLI as the
# configs above; each run serves one round of 8 frames. The dense runs
# take lr 1e-4: Adam moves each weight of their first Dense, 150,528 raw
# pixels wide, by about lr a step, so at 5e-3 a pre-activation jumps by
# hundreds a step: the linear map runs away under the priors (its loss
# grows, in the JAX package as in the port) and the mlp's ReLUs die
BF16 = {"compute_dtype": "bfloat16"}
DENSE_LR = 1e-4
BF16_DENSE_CONFIGS = (
    ("autoencoder-bf16", ("autoencoder",), 2, BF16),
    ("triplet-bf16", ("triplet",), 2, {**RESNET_VIEWS, **BF16}),
    ("mlp", ("autoencoder",), 2, {"model_type": "mlp",
                                  "learning_rate": DENSE_LR}),
    ("linear", ("priors",), 2, {"model_type": "linear",
                                "learning_rate": DENSE_LR}),
)
# of those, the ones whose whole train and eval steps the sync check runs
SYNC_BF16_DENSE = ("autoencoder-bf16", "triplet-bf16", "mlp")
CLI_FLAG = {"noise_type": "--noise-type",
            "episode_prior_optimizer": "--episode-prior-optimizer",
            "grad_accum": "--grad-accum", "path_to_dae": "--path-to-dae",
            "compute_dtype": "--dtype", "learning_rate": "-lr"}
# bfloat16's unit roundoff: the least loss deviation a bf16 step is held to
U_BF16 = 2.0 ** -9
INFERENCE_KERNELS = ("relu_max_pool", "gather_normalize", "knn_topk",
                     "pairwise_sqdist")
# phase 4b: the data layer. DATA_FRAMES frames of phase 4's scene are
# recorded as JPEGs; the hybrid run keeps HYBRID_ROWS of the 4,096 rows
# resident (about half) for DATA_EPOCHS_HYBRID epochs
DATA_FRAMES = 1024
HYBRID_ROWS = TRAIN_FRAMES // 2
DATA_EPOCHS_HYBRID = 3
# phase 5: BASELINE config 5 through the pipeline, at two seeds (epochs
# cut from 30, as in phase 4)
PIPELINE_SEEDS = (1, 2)
PIPELINE_EPOCHS = 2
PIPELINE_KERNELS = ("relu_max_pool", "relu_max_pool_bwd", "gather_normalize",
                    "knn_topk")
TRAINING_KERNELS = ("relu_max_pool", "relu_max_pool_bwd", "gather_normalize",
                    "knn_topk", "pairwise_sqdist")
POOL_KERNELS = ("relu_max_pool", "relu_max_pool_bwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def device_ms(fn, kernel: str, iters: int = 10, per_call: int = 1,
              tries: int = 3) -> float:
    """Device time of one call of ``fn``: torch.profiler's (CUPTI's) device
    time of the kernels whose name holds ``kernel`` over ``iters`` calls
    after a warm-up call, over the calls; a call that launches several
    such kernels (K3's passes) is the sum of them. Only a profile that saw
    ``per_call`` of them a call, ``per_call`` x ``iters`` in all, is read:
    CUPTI now and then drops a kernel record from a profile (9 of 10
    single launches, once in some 370 profiles on the H100), so a profile
    with another count is taken again, up to ``tries`` times, and then it
    fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and kernel in e.key]
        n = sum(e.count for e in evs)
        if n == per_call * iters:
            if counts:
                log(f"device_ms({kernel}): profiled again after "
                    f"{counts} launches in {iters} calls")
            return sum(e.self_device_time_total for e in evs) / iters / 1e3
        counts.append(n)
    raise AssertionError(f"{counts} launches of a {kernel} kernel in "
                         f"{iters} calls ({per_call} a call expected)")


def vector_count(fn):
    """A wrapper's vector-path launches so far (None for a tree whose
    kernel counts none)."""
    return getattr(fn, "vector_launches", None)


def path_of(fn, call):
    """Run ``call``: its result and the path its one launch of ``fn`` took
    ("vector", "scalar", or "one" for kernels without a vector path)."""
    before = vector_count(fn)
    out = call()
    if before is None:
        return out, "one"
    return out, ("vector" if vector_count(fn) - before == 1 else "scalar")


def pool_line(what, shape, dtype, dev_ms, ms, plain, b, by) -> str:
    return (f"{what} {shape} {str(dtype)[6:]}: device {dev_ms:.4f} ms, "
            f"wrapper {ms:.4f} ms (plain {plain:.4f} ms), bound {b:.4f} ms "
            f"by {by}: {100 * b / dev_ms:.1f}% of the bound in device time")


def check_pool(dev, g, times: list) -> dict:
    """K1f at its twelve main-path shapes, the three pools of a config-1
    forward at the serve and training batch (32) and at the export batch
    (256), each in f32 and bf16: y and idx equal to the plain version's,
    the vector path taken; then the device time (torch.profiler) and the
    wrapper time (CUDA events over WRAPPER_CALLS calls, Python included)
    of the inference call, and at batch 32 also of the training call
    (with the index plane, from an input that requires grad). Appends one
    record per timing to ``times``. Returns the sums of the three pools:
    {"serve": ..., "export": ..., "serve-bf16": ..., "export-bf16":
    ...}."""
    import torch
    from srl_zoo_tpu_torch.evaluation.predict_dataset import BATCH
    from srl_zoo_tpu_torch.ops.fused_pool import (relu_max_pool,
                                                  relu_max_pool_plain)
    batches = {SERVE_BATCH: "serve", BATCH: "export"}
    cases = [((b, hw, hw, 64), dtype) for b in (SERVE_BATCH, BATCH)
             for hw in POOLS for dtype in (torch.float32, torch.bfloat16)]
    totals = {}
    for shape, dtype in cases:
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        (y, idx), path = path_of(relu_max_pool,
                                 lambda: relu_max_pool(x, with_index=True))
        yp, ip = relu_max_pool_plain(x, with_index=True)
        torch.cuda.synchronize()
        err = float((y.float() - yp.float()).abs().max())
        if not (torch.equal(y, yp) and torch.equal(idx, ip)
                and torch.equal(relu_max_pool(x), yp)):
            raise AssertionError(
                f"relu_max_pool {shape} {dtype}: y err {err}, "
                f"{int((idx != ip).sum())} argmax mismatches")
        if path == "scalar":
            raise AssertionError(f"relu_max_pool {shape} {dtype} took the "
                                 "scalar path")
        del idx, ip, yp
        es = x.element_size()
        ops = 10 * y.numel()  # nine compares + relu per output
        runs = [("K1f relu_max_pool", lambda: relu_max_pool(x),
                 (x.numel() + y.numel()) * es, False)]
        if shape[0] == TRAIN_BATCH:
            xg = x.detach().requires_grad_()
            # the training forward: an autograd node and the index plane,
            # one byte per output
            runs.append(("K1f relu_max_pool, training forward (+idx)",
                         lambda: relu_max_pool(xg),
                         (x.numel() + y.numel()) * es + y.numel(), True))
        for what, call, nbytes, index in runs:
            dev_ms = device_ms(call, "relu_max_pool_fwd")
            ms = time_ms(call, iters=WRAPPER_CALLS)
            plain = time_ms(lambda: relu_max_pool_plain(x, with_index=index))
            b, by = bound(nbytes, ops)
            log(pool_line(what, shape, dtype, dev_ms, ms, plain, b, by)
                + (f"; y+idx exact, {path} path" if not index else ""))
            times.append({"kernel": "K1f", "shape": list(shape),
                          "dtype": str(dtype)[6:], "index": index,
                          "device_ms": dev_ms, "ms": ms, "plain_ms": plain,
                          "bound_ms": b})
            if not index:
                key = batches[shape[0]] + (
                    "-bf16" if dtype == torch.bfloat16 else "")
                t = totals.setdefault(key, dict.fromkeys(
                    ("ms", "device_ms", "plain_ms", "bytes", "ops", "err"),
                    0.0))
                t["ms"] += ms
                t["device_ms"] += dev_ms
                t["plain_ms"] += plain
                t["bytes"] += nbytes
                t["ops"] += ops
                t["err"] = max(t["err"], err)
    for path, t in totals.items():
        b, by = bound(t["bytes"], t["ops"])
        log(f"K1f relu_max_pool, the three pools of a {path} batch: "
            f"device {t['device_ms']:.4f} ms, wrapper {t['ms']:.4f} ms "
            f"(plain {t['plain_ms']:.4f} ms), bound {b:.4f} ms by {by}")
    return totals


def check_pool_bwd(dev, g, times: list) -> dict:
    """K1b at the three pools of a config-1 train step (batch 32): exact on
    integer-valued inputs and cotangents (every sum exact) in f32 and bf16,
    and within 1e-6 of the largest |g| on random floats in f32 and bf16
    (both add the nine window positions in raster order in f32 and round
    once, so 0 is expected); the vector path taken; the device time
    (torch.profiler) and the wrapper time (CUDA events over WRAPPER_CALLS
    calls) in f32 and bf16. Appends one record per timing to ``times``.
    Returns the f32 sums of the three pools, with the bf16 sums under
    "bf16"."""
    import torch
    from srl_zoo_tpu_torch.ops.fused_pool import (relu_max_pool_bwd,
                                                  relu_max_pool_bwd_plain,
                                                  relu_max_pool_plain)
    sums = {dtype: dict.fromkeys(("ms", "device_ms", "plain_ms", "bytes",
                                  "ops", "err"), 0.0)
            for dtype in (torch.float32, torch.bfloat16)}
    for hw in POOLS:
        shape = (TRAIN_BATCH, hw, hw, 64)
        for kind, dtype in (("integer", torch.float32),
                            ("random", torch.float32),
                            ("integer", torch.bfloat16),
                            ("random", torch.bfloat16)):
            if kind == "integer":
                x = torch.randint(-2, 3, shape, generator=g, device=dev)
            else:
                x = torch.randn(shape, generator=g, device=dev)
            x = x.to(dtype)
            _, idx = relu_max_pool_plain(x, with_index=True)
            gshape = idx.shape
            gy = (torch.randint(-8, 9, gshape, generator=g, device=dev)
                  if kind == "integer" else
                  torch.randn(gshape, generator=g, device=dev)).to(dtype)
            dx, path = path_of(relu_max_pool_bwd,
                               lambda: relu_max_pool_bwd(gy, idx, shape))
            ref = relu_max_pool_bwd_plain(gy, idx, shape)
            torch.cuda.synchronize()
            err = float((dx.float() - ref.float()).abs().max())
            tol = 0.0 if kind == "integer" else \
                1e-6 * float(gy.float().abs().max())
            if not err <= tol:
                raise AssertionError(f"relu_max_pool_bwd {shape} {kind} "
                                     f"{dtype}: max err {err} > {tol}")
            if path == "scalar":
                raise AssertionError(f"relu_max_pool_bwd {shape} {dtype} "
                                     "took the scalar path")
            if kind != "random":
                continue
            call = lambda: relu_max_pool_bwd(gy, idx, shape)  # noqa: E731
            dev_ms = device_ms(call, "relu_max_pool_bwd")
            ms = time_ms(call, iters=WRAPPER_CALLS)
            plain = time_ms(lambda: relu_max_pool_bwd_plain(gy, idx, shape))
            # read g and idx once per output, write dx once per input
            es = gy.element_size()
            nbytes = gy.numel() * (es + 1) + dx.numel() * es
            ops = 8 * dx.numel()  # <= 4 compares and 4 adds per input
            b, by = bound(nbytes, ops)
            log(pool_line("K1b relu_max_pool_bwd", shape, dtype, dev_ms, ms,
                          plain, b, by)
                + f"; integer inputs exact, random max err {err:.3g}, "
                f"{path} path")
            times.append({"kernel": "K1b", "shape": list(shape),
                          "dtype": str(dtype)[6:], "index": True,
                          "device_ms": dev_ms, "ms": ms, "plain_ms": plain,
                          "bound_ms": b})
            t = sums[dtype]
            t["ms"] += ms
            t["device_ms"] += dev_ms
            t["plain_ms"] += plain
            t["bytes"] += nbytes
            t["ops"] += ops
            t["err"] = max(t["err"], err)
    for dtype, t in sums.items():
        b, by = bound(t["bytes"], t["ops"])
        log(f"K1b relu_max_pool_bwd {str(dtype)[6:]}, the three pools of a "
            f"train step: device {t['device_ms']:.4f} ms, wrapper "
            f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms), bound "
            f"{b:.4f} ms by {by}, {t['bytes'] / 1e6:.1f} MB")
    return sums[torch.float32] | {"bf16": sums[torch.bfloat16]}


def check_stem_pool(dev, g, times: list) -> None:
    """K1f and K1b at the ResNet stem's pool, (TRAIN_BATCH, 112, 112, 64)
    with the explicit pads ((1, 1), (1, 1)) (its 56 x 56 output is the
    size of 'SAME', whose windows at 112 px pad (0, 1)), in f32 and bf16
    (config 5 and its ``--dtype bfloat16`` run): the inference forward,
    the training forward (with the index plane) and the backward, each
    exact against its plain version (integer-valued inputs and cotangents
    for the backward, so every sum is exact) and on the vector path; then
    each one's device time (torch.profiler), wrapper time (CUDA events
    over WRAPPER_CALLS calls) and plain time beside its bound. Appends one
    record per timing to ``times``."""
    import torch
    from srl_zoo_tpu_torch.models.resnet import STEM_POOL_PADS as pads
    from srl_zoo_tpu_torch.ops.fused_pool import (relu_max_pool,
                                                  relu_max_pool_bwd,
                                                  relu_max_pool_bwd_plain,
                                                  relu_max_pool_plain)
    shape = (TRAIN_BATCH, POOLS[0], POOLS[0], 64)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randint(-2, 3, shape, generator=g, device=dev).to(dtype)
        (y, idx), path = path_of(relu_max_pool, lambda: relu_max_pool(
            x, pads, with_index=True))
        yp, ip = relu_max_pool_plain(x, pads, with_index=True)
        gy = torch.randint(-8, 9, yp.shape, generator=g, device=dev
                           ).to(dtype)
        dx, bpath = path_of(relu_max_pool_bwd,
                            lambda: relu_max_pool_bwd(gy, idx, shape, pads))
        ref = relu_max_pool_bwd_plain(gy, ip, shape, pads)
        torch.cuda.synchronize()
        if not (torch.equal(y, yp) and torch.equal(idx, ip)
                and torch.equal(relu_max_pool(x, pads), yp)
                and torch.equal(dx, ref)):
            raise AssertionError(
                f"stem pool {shape} {dtype} pads {pads}: y err "
                f"{float((y.float() - yp.float()).abs().max())}, "
                f"{int((idx != ip).sum())} argmax mismatches, dx err "
                f"{float((dx.float() - ref.float()).abs().max())}")
        if path != "vector" or bpath != "vector":
            raise AssertionError(f"stem pool {shape} {dtype}: forward took "
                                 f"the {path} path, backward the {bpath}")
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        xg = x.detach().requires_grad_()
        _, ip = relu_max_pool_plain(x, pads, with_index=True)
        gy = torch.randn(yp.shape, generator=g, device=dev).to(dtype)
        out, n_out, es = yp.numel(), x.numel(), x.element_size()
        runs = (
            ("K1f relu_max_pool, stem", "relu_max_pool_fwd", False,
             lambda: relu_max_pool(x, pads),
             lambda: relu_max_pool_plain(x, pads), (n_out + out) * es,
             10 * out),
            ("K1f relu_max_pool, stem training forward (+idx)",
             "relu_max_pool_fwd", True, lambda: relu_max_pool(xg, pads),
             lambda: relu_max_pool_plain(x, pads, with_index=True),
             (n_out + out) * es + out, 10 * out),
            ("K1b relu_max_pool_bwd, stem", "relu_max_pool_bwd", True,
             lambda: relu_max_pool_bwd(gy, ip, shape, pads),
             lambda: relu_max_pool_bwd_plain(gy, ip, shape, pads),
             out * (es + 1) + n_out * es, 8 * n_out),
        )
        for what, kernel, index, call, plain_call, nbytes, ops in runs:
            dev_ms = device_ms(call, kernel)
            ms = time_ms(call, iters=WRAPPER_CALLS)
            plain = time_ms(plain_call)
            b, by = bound(nbytes, ops)
            log(pool_line(what, shape, dtype, dev_ms, ms, plain, b, by)
                + f"; pads {pads}, exact, vector path")
            times.append({"kernel": what.split()[0], "shape": list(shape),
                          "dtype": str(dtype)[6:], "index": index,
                          "pads": pads, "device_ms": dev_ms, "ms": ms,
                          "plain_ms": plain, "bound_ms": b})


def check_pool_edges(dev, g) -> None:
    """K1f (y and idx) and K1b (dx) equal to their plain versions at the
    shapes that reach the scalar path and the vector path's tile edges:
    C in {3, 12, 66, 64} in f32 and {12, 64} in bf16, 9 x 13 and 1 x 1
    images, B = 1, pads ((0, 0), (0, 0)), ((2, 0), (0, 2)) and ((1, 1),
    (1, 1)), and inputs that are contiguous slices at a storage offset of
    one element (not a multiple of 16 bytes); integer-valued inputs and
    cotangents, so every sum is exact. Each call must take the path its
    shape and alignment select, and a pool with no output must raise."""
    import torch
    from srl_zoo_tpu_torch.ops.fused_pool import (relu_max_pool,
                                                  relu_max_pool_bwd,
                                                  relu_max_pool_bwd_plain,
                                                  relu_max_pool_plain)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(1, hw, c, dtype, pads, False)
             for c, dtype in ((3, f32), (12, f32), (66, f32), (64, f32),
                              (12, bf16), (64, bf16))
             for hw in ((9, 13), (1, 1))
             for pads in (((0, 0), (0, 0)), ((2, 0), (0, 2)),
                          ((1, 1), (1, 1)))]
    cases += [(3, (9, 13), 64, dtype, "SAME", True) for dtype in (f32, bf16)]
    n = {"vector": 0, "scalar": 0}
    for b, (h, w), c, dtype, pads, offset in cases:
        shape = (b, h, w, c)
        numel = b * h * w * c

        def ints(lo, hi, count):
            flat = torch.randint(lo, hi, (count + offset,), generator=g,
                                 device=dev).to(dtype)
            return flat[int(offset):]  # offset: 2 or 4 bytes in

        x = ints(-2, 3, numel).view(shape)
        if pads == ((0, 0), (0, 0)) and h == 1:
            try:
                relu_max_pool(x, pads)
            except ValueError:
                continue
            raise AssertionError("relu_max_pool accepted a pool with no "
                                 "output")
        want = "vector" if (c * x.element_size()) % 16 == 0 and not offset \
            else "scalar"
        (y, idx), path = path_of(
            relu_max_pool, lambda: relu_max_pool(x, pads, with_index=True))
        yp, ip = relu_max_pool_plain(x, pads, with_index=True)
        gy = ints(-8, 9, yp.numel()).view(yp.shape)
        dx, bpath = path_of(relu_max_pool_bwd,
                            lambda: relu_max_pool_bwd(gy, ip, shape, pads))
        ref = relu_max_pool_bwd_plain(gy, ip, shape, pads)
        torch.cuda.synchronize()
        if not (torch.equal(y, yp) and torch.equal(idx, ip)
                and torch.equal(relu_max_pool(x, pads), yp)
                and torch.equal(dx, ref)):
            raise AssertionError(
                f"pool edge {shape} {dtype} pads {pads} offset {offset}: "
                f"y err {float((y.float() - yp.float()).abs().max())}, "
                f"{int((idx != ip).sum())} argmax mismatches, dx err "
                f"{float((dx.float() - ref.float()).abs().max())}")
        if path != want or bpath != want:
            raise AssertionError(f"pool edge {shape} {dtype} pads {pads}: "
                                 f"forward took the {path} path, backward "
                                 f"the {bpath}, expected {want}")
        n[want] += 1
    log(f"K1f and K1b at {sum(n.values())} edge shapes (C 3/12/66/64 f32, "
        f"12/64 bf16, 9x13 and 1x1, B 1, three pads, offset slices): y, "
        f"idx and dx exact; {n['vector']} on the vector path, "
        f"{n['scalar']} on the scalar path")


def check_gather(store, dev, times: list) -> dict:
    """K2 at its main-path shapes: the export batch (256 rows) and the
    training batch (32 rows) in both modes, from a host index where the tree's wrapper takes one (a CUDA index otherwise, as
    the parent's does): within 1e-6 of the plain version, the vector path
    taken, and a CUDA index giving the same rows; then the device time
    (torch.profiler), the wrapper time (CUDA events over WRAPPER_CALLS
    calls, the host index's check and upload included) and the plain
    time. Appends one record per shape to ``times``. Returns the 256-row
    "tf" numbers."""
    import torch
    from srl_zoo_tpu_torch.evaluation.predict_dataset import BATCH
    from srl_zoo_tpu_torch.ops import gather_norm
    from srl_zoo_tpu_torch.ops.gather_norm import (gather_normalize,
                                                   gather_normalize_plain)
    host = hasattr(gather_norm, "check_host_index")
    n = store.shape[0]
    rng = np.random.default_rng(SEED)
    res = {}
    for rows, mode in ((BATCH, "tf"), (BATCH, "image_net"),
                       (TRAIN_BATCH, "tf"), (TRAIN_BATCH, "image_net")):
        idx_np = rng.integers(0, n, rows)
        idx_dev = torch.from_numpy(idx_np).to(dev)
        idx = idx_np if host else idx_dev
        out, path = path_of(gather_normalize,
                            lambda: gather_normalize(store, idx, mode))
        ref = gather_normalize_plain(store, idx_dev, mode)
        err = float((out - ref).abs().max())
        if err > 1e-6:
            raise AssertionError(f"gather_normalize {mode} B={rows}: max err "
                                 f"{err}")
        if path == "scalar":
            raise AssertionError(f"gather_normalize B={rows} took the scalar "
                                 "path")
        if host and not torch.equal(gather_normalize(store, idx_dev, mode),
                                    out):
            raise AssertionError("gather_normalize: a CUDA index gives other "
                                 "rows than the same host index")
        del ref
        call = lambda: gather_normalize(store, idx, mode)  # noqa: E731
        dev_ms = device_ms(call, "gather_norm")
        ms = time_ms(call, iters=WRAPPER_CALLS)
        plain = time_ms(lambda: gather_normalize_plain(store, idx_dev, mode))
        nbytes = out.numel() * 5 + idx_np.size * 8
        ops = 2 * out.numel()
        b, by = bound(nbytes, ops)
        log(f"K2 gather_normalize {mode} B={rows} of N={n}: max err "
            f"{err:.3g}, {path} path, {'host' if host else 'CUDA'} index; "
            f"device {dev_ms:.4f} ms, wrapper {ms:.4f} ms (plain "
            f"{plain:.4f} ms), bound {b:.4f} ms by {by}: "
            f"{100 * b / dev_ms:.1f}% of the bound in device time")
        times.append({"kernel": "K2", "shape": [rows, *IMG], "mode": mode,
                      "device_ms": dev_ms, "ms": ms, "plain_ms": plain,
                      "bound_ms": b})
        if rows == BATCH and mode == "tf":  # config 1's mode, export batch
            res = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                   "bytes": nbytes, "ops": ops, "err": err}
    return res


def check_gather_streamed(dev, g, times: list) -> None:
    """K2 over the identity index, as a streamed batch is normalized: the
    training batch (32) of 3 and of 6 (two views stacked) channels,
    within 1e-6 of the plain version, on the vector path, timed beside
    its bound."""
    import torch
    from srl_zoo_tpu_torch.ops.gather_norm import (gather_normalize,
                                                   gather_normalize_plain)
    from srl_zoo_tpu_torch.training.train_step import normalize_streamed
    for c in (3, 6):
        u8 = torch.randint(0, 256, (TRAIN_BATCH, IMG[0], IMG[1], c),
                           generator=g, device=dev, dtype=torch.uint8)
        out, path = path_of(gather_normalize, lambda: normalize_streamed(
            u8, "tf", dev))
        ident = torch.arange(TRAIN_BATCH, device=dev)
        err = float((out - gather_normalize_plain(u8, ident)).abs().max())
        if err > 1e-6 or path != "vector":
            raise AssertionError(f"K2 identity C={c}: err {err}, {path}")
        call = lambda: normalize_streamed(u8, "tf", dev)  # noqa: E731
        dev_ms = device_ms(call, "gather_norm")
        ms = time_ms(call, iters=WRAPPER_CALLS)
        plain = time_ms(lambda: gather_normalize_plain(u8, ident))
        b, by = bound(out.numel() * 5 + TRAIN_BATCH * 8, 2 * out.numel())
        log(f"K2 over the identity index (a streamed batch) "
            f"{tuple(u8.shape)}: max err {err:.3g}, {path} path; device "
            f"{dev_ms:.4f} ms, wrapper {ms:.4f} ms (plain {plain:.4f} ms), "
            f"bound {b:.4f} ms by {by}: {100 * b / dev_ms:.1f}% of the "
            "bound in device time")
        times.append({"kernel": "K2", "shape": list(u8.shape),
                      "mode": "tf identity", "device_ms": dev_ms, "ms": ms,
                      "plain_ms": plain, "bound_ms": b})


def check_gather_edges(store, dev, g) -> None:
    """K2 within 1e-6 of its plain version off the main path, each call on
    the path its shape selects (vector where a frame is a whole number of
    4-byte groups and the store starts 4-byte aligned): 9x13 frames of C
    1, 3, 4, 6 and 8 (C 3 and 6 in both modes), 16x16x1 frames, a
    one-frame store, B 1 and 7, and 224x224x3 stores that are slices at
    storage offsets of 1 and 4 bytes; host indices as numpy and as a CPU
    tensor. Then an index of -1 or N raises IndexError, from the host
    before any launch, and from a CUDA index (read back to the host)."""
    import torch
    from srl_zoo_tpu_torch.ops.gather_norm import (gather_normalize,
                                                   gather_normalize_plain)
    rng = np.random.default_rng(SEED)
    n_path = {"vector": 0, "scalar": 0}
    for (n, h, w, c), offset in (((5, 9, 13, 1), 0), ((5, 9, 13, 3), 0),
                                 ((5, 9, 13, 4), 0), ((5, 9, 13, 6), 0),
                                 ((5, 9, 13, 8), 0), ((5, 16, 16, 1), 0),
                                 ((1, 7, 5, 8), 0), ((3,) + IMG, 1),
                                 ((3,) + IMG, 4)):
        numel = n * h * w * c
        flat = torch.randint(0, 256, (numel + offset,), generator=g,
                             device=dev, dtype=torch.uint8)
        frames = flat[offset:].view(n, h, w, c)
        want = "vector" if (h * w * c) % 4 == 0 and offset % 4 == 0 \
            else "scalar"
        for b in (1, 7):
            idx_np = rng.integers(0, n, b)
            for mode in ("tf", "image_net") if c % 3 == 0 else ("tf",):
                for idx in (idx_np, torch.from_numpy(idx_np)):
                    out, path = path_of(
                        gather_normalize,
                        lambda: gather_normalize(frames, idx, mode))
                    ref = gather_normalize_plain(
                        frames, torch.from_numpy(idx_np).to(dev), mode)
                    err = float((out - ref).abs().max())
                    if not err <= 1e-6 or path != want:
                        raise AssertionError(
                            f"gather_normalize edge {(n, h, w, c)} offset "
                            f"{offset} B={b} {mode}: max err {err}, {path} "
                            f"path, expected {want}")
                    n_path[want] += 1
    launches = gather_normalize.launches
    for bad in (np.array([0, -1]), np.array([store.shape[0]])):
        try:
            gather_normalize(store, bad)
        except IndexError:
            continue
        raise AssertionError(f"gather_normalize accepted the host index "
                             f"{bad.tolist()}")
    if gather_normalize.launches != launches:
        raise AssertionError("gather_normalize launched on an out-of-range "
                             "host index")
    for bad in ([0, -1], [store.shape[0]]):
        try:
            gather_normalize(store, torch.tensor(bad, device=dev))
        except IndexError:
            continue
        raise AssertionError(f"gather_normalize accepted the CUDA index "
                             f"{bad}")
    log(f"K2 at {sum(n_path.values())} edge calls (9x13 C 1/3/4/6/8, "
        f"16x16x1, N 1, B 1 and 7, slices at offsets 1 and 4, numpy and "
        f"CPU-tensor indices): within 1e-6, {n_path['vector']} on the "
        f"vector path, {n_path['scalar']} on the scalar path; -1 and N "
        f"raise IndexError from host (before a launch) and CUDA indices")


def step_batch(indices: np.ndarray, rng, n_rows: int) -> dict:
    """A loader-style batch of the store rows ``indices``, with the
    metadata of every loss (actions, rewards, the priors' pairs, the
    triplet's negatives among the store's ``n_rows`` rows, the episode
    prior's pairs of rows in four episodes, a 2-wide ground truth)."""
    from srl_zoo_tpu_torch.data import samplers
    b = len(indices)
    actions = rng.randint(0, 4, b).astype(np.int32)
    rewards = rng.randint(0, 2, b).astype(np.int32)
    batch = {"indices": indices.astype(np.int32),
             "valid": np.ones(b, np.float32), "actions": actions,
             "reward_classes": rewards,
             "neg_indices": rng.randint(0, n_rows, b).astype(np.int32)}
    (batch["same_action_partners"],
     batch["same_action_mask"]) = samplers.find_same_action_pairs(actions,
                                                                  rng)
    (batch["dissimilar_partners"],
     batch["dissimilar_mask"]) = samplers.find_dissimilar_pairs(
        actions, rewards, rng)
    batch["rewards"] = rewards.astype(np.float32)
    (batch["episode_partners"],
     batch["episode_labels"]) = samplers.episode_prior_pairs(
        rng.randint(0, 4, b), rng)
    batch["gt_states"] = rng.uniform(0, 1, (b, 2)).astype(np.float32)
    return batch


def random_dae(batch_size: int, device, seed: int = SEED):
    """A frozen DAE of config 1's width with seeded random weights, for
    the perceptual loss where no trained one is at hand."""
    from srl_zoo_tpu_torch.training.state import make_model
    cfg = train_config(("dae",), batch_size).replace(seed=seed)
    return make_model(cfg, device).eval().requires_grad_(False)


def check_no_sync(store, dev) -> None:
    """Under ``torch.cuda.set_sync_debug_mode("error")``, K2 at the export
    and training batch from a host index, and one whole ``train_step`` and
    ``eval_step`` (inputs, forward, loss, backward, Adam) of configs 1
    (autoencoder), 3 (priors: the next frames and the pairs' metadata)
    and 5 (triplet, ResNet-18: the second view's positives and the
    negatives, each view's store here the same tensor) at batch 32,
    configs 1 and 5 at ``--dtype bfloat16`` and config 1's loss on the
    mlp model type (SYNC_BF16_DENSE), the zoo's configs of SYNC_ZOO
    (``zoo_sync_calls``), and config 5's checkpoint submits (``AsyncCheckpointer.save_model`` and
    ``save_state``; the worker's host copies wait until the mode is off),
    complete without a synchronise. The mode is first shown to catch one
    (a pageable upload); each call runs once before, outside the mode, for
    its first-use work (the build, the pinned-memory pool, cuDNN's plans,
    Adam's state)."""
    import torch
    from srl_zoo_tpu_torch import checkpoint as ckpt
    from srl_zoo_tpu_torch.evaluation.predict_dataset import BATCH
    from srl_zoo_tpu_torch.ops.gather_norm import gather_normalize
    from srl_zoo_tpu_torch.training.state import make_model, make_optimizer
    from srl_zoo_tpu_torch.training.train_step import eval_step, train_step
    n = store.shape[0]
    rng = np.random.RandomState(SEED)
    calls = [(f"K2 B={rows}", lambda rows=rows: gather_normalize(
        store, rng.randint(0, n, rows))) for rows in (BATCH, TRAIN_BATCH)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    views = {"frames": store, "frames_2": store}
    for name, tokens, _, model_kw in TRAIN_CONFIGS[:5:2]:  # configs 1, 3, 5
        cfg = train_config(tokens, TRAIN_BATCH, model_kw)
        model = make_model(cfg, dev)
        opt = make_optimizer(cfg, model)
        batch = step_batch(rng.choice(n, TRAIN_BATCH, replace=False), rng,
                           n)
        calls.append((f"train_step of {name}", lambda m=model, o=opt,
                      b=batch: train_step(m, o, views, b, gen)))
        calls.append((f"eval_step of {name}", lambda m=model, b=batch:
                      eval_step(m, views, b)))
    # the worker's writes wait for ``quiet``: set while the mode is off
    quiet, writers = threading.Event(), []
    real = {f: getattr(ckpt, f) for f in ("write_train_state",
                                          "write_state_dict")}

    def gated(fn):
        def write(*args):
            if not quiet.wait(60):
                raise TimeoutError("the sync check never ended")
            return fn(*args)
        return write

    def submits(m=model, o=opt):
        writers.append(ckpt.AsyncCheckpointer(tmp, dev))
        writers[-1].save_model(m, m.state_dict())
        writers[-1].save_state(m, o, gen, 1, 1, 0.5)
    calls.append((f"checkpoint submits of {name}", submits))
    for name, tokens, _, model_kw in BF16_DENSE_CONFIGS:
        if name not in SYNC_BF16_DENSE:
            continue
        cfg = train_config(tokens, TRAIN_BATCH, model_kw)
        model = make_model(cfg, dev)
        opt = make_optimizer(cfg, model)
        batch = step_batch(rng.choice(n, TRAIN_BATCH, replace=False), rng,
                           n)
        calls.append((f"train_step of {name}", lambda m=model, o=opt,
                      b=batch: train_step(m, o, views, b, gen)))
        calls.append((f"eval_step of {name}", lambda m=model, b=batch:
                      eval_step(m, views, b)))
    calls += zoo_sync_calls(views, rng, n, gen, dev)
    tmp = tempfile.mkdtemp()
    for f, fn in real.items():
        setattr(ckpt, f, gated(fn))
    try:
        quiet.set()
        for _, call in calls:
            call()
        writers.pop().close()
        torch.cuda.synchronize()
        quiet.clear()
        _check_no_sync(calls, dev)
    finally:
        quiet.set()
        for f, fn in real.items():
            setattr(ckpt, f, fn)
        for w in writers:
            w.close()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    log(f"no synchronise under set_sync_debug_mode('error') (which catches "
        f"a pageable upload): {', '.join(name for name, _ in calls)}")


def zoo_sync_calls(views, rng, n: int, gen, dev) -> list:
    """A whole ``train_step`` and ``eval_step`` at batch 32 of each config
    of SYNC_ZOO: the DAE with its validation draw, the perceptual loss
    through a frozen DAE, the episode prior with its two discriminator
    applies and its partners' metadata, and ``--grad-accum 4`` as a full
    cycle of four micro-steps."""
    from srl_zoo_tpu_torch.training.state import make_model, make_optimizer
    from srl_zoo_tpu_torch.training.train_step import (draw_corruption,
                                                       eval_step, train_step)
    calls = []
    for name, tokens, _, kw in ZOO_CONFIGS:
        if name not in SYNC_ZOO:
            continue
        cfg = train_config(tokens, TRAIN_BATCH, kw)
        model = make_model(cfg, dev)
        opt = make_optimizer(cfg, model)
        batch = step_batch(rng.choice(n, TRAIN_BATCH, replace=False), rng,
                           n)
        dae = random_dae(TRAIN_BATCH, dev) \
            if "perceptual" in cfg.loss_names else None
        held = draw_corruption(cfg, gen, TRAIN_BATCH, dev) \
            if cfg.use_dae else None

        def train(m=model, o=opt, b=batch, f=dae, k=cfg.grad_accum):
            for _ in range(k):
                train_step(m, o, views, b, gen, f)
        calls.append((f"train_step of {name}" + (
            f" ({cfg.grad_accum} micro-steps)" if cfg.grad_accum > 1
            else ""), train))
        calls.append((f"eval_step of {name}", lambda m=model, b=batch,
                      c=held, f=dae: eval_step(m, views, b, c, f)))
    return calls


def _check_no_sync(calls, dev) -> None:
    """Each of ``calls`` under ``set_sync_debug_mode("error")``, after
    showing that the mode catches a pageable upload."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        try:
            torch.ones(4).to(dev)
        except RuntimeError:
            pass
        else:
            raise AssertionError("the sync debug mode let a pageable upload "
                                 "through")
        for name, call in calls:
            try:
                call()
            except RuntimeError as e:
                raise AssertionError(f"{name} synchronised: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)


def near_tie_mismatches(q, refs, ki, pi, rtol: float) -> int:
    """Index mismatches between kernel and plain top-k; raises unless each
    is a tie within ``rtol`` in float64 distances."""
    bad = (ki != pi).nonzero()
    for qi, s in bad.tolist():
        qv = q[qi].double()
        da = float(((refs[ki[qi, s]].double() - qv) ** 2).sum())
        db = float(((refs[pi[qi, s]].double() - qv) ** 2).sum())
        if abs(da - db) > rtol * max(da, db):
            raise AssertionError(f"knn_topk: query {qi} slot {s} picks "
                                 f"{int(ki[qi, s])} at {da} vs plain "
                                 f"{int(pi[qi, s])} at {db}")
    return len(bad)


def knn_against_plain(q, refs, k: int):
    """K3 against its plain version: the largest relative distance error
    (raises above 1e-4) and the index mismatches, each a counted near
    tie."""
    import torch
    from srl_zoo_tpu_torch.ops.knn_topk import (knn_topk_plain,
                                                knn_topk_with_dist)
    kd, ki = knn_topk_with_dist(q, refs, k)
    pd, pi = knn_topk_plain(q, refs, k)
    torch.cuda.synchronize()
    rel = float(((kd - pd).abs() / pd.abs().clamp_min(1e-30)).max())
    if not rel <= 1e-4:
        raise AssertionError(f"knn_topk {tuple(q.shape)} of "
                             f"{tuple(refs.shape)}, k={k}: distances max rel "
                             f"err {rel}")
    return rel, near_tie_mismatches(q, refs, ki, pi, 1e-4), \
        float((kd - pd).abs().max())


def check_knn(dev, g, times: list) -> dict:
    """K3 at its main-path shape (Q 4,096, N 20,000, D 200, k 6) against
    its plain version; its device time (every kernel a call launches,
    torch.profiler), wrapper time and plain time. Appends one record to
    ``times``."""
    import torch
    from srl_zoo_tpu_torch.ops import knn_topk
    from srl_zoo_tpu_torch.ops.knn_topk import (knn_topk_plain,
                                                knn_topk_with_dist)
    nq, n, d, k = KNN_QUERIES, N_FRAMES, STATE_DIM, 6
    q = torch.randn((nq, d), generator=g, device=dev)
    refs = torch.randn((n, d), generator=g, device=dev)
    rel, ties, err = knn_against_plain(q, refs, k)
    call = lambda: knn_topk_with_dist(q, refs, k)  # noqa: E731
    # norms, partial and merge pass (two passes before the norms' pre-pass)
    per_call = 3 if hasattr(knn_topk, "split_plan") else 2
    dev_ms = device_ms(call, "knn_", per_call=per_call)
    ms = time_ms(call)
    plain = time_ms(lambda: knn_topk_plain(q, refs, k), iters=5)
    nbytes = 4 * (nq + n) * d + nq * k * 12
    ops = 2 * nq * n * d + 2 * (nq + n) * d
    b, by = bound(nbytes, ops)
    log(f"K3 knn_topk Q={nq} N={n} D={d} k={k}: max rel err {rel:.3g}, "
        f"{ties} index mismatches at near-ties; device {dev_ms:.4f} ms "
        f"({ops / dev_ms / 1e9:.1f} TFLOP/s), wrapper {ms:.4f} ms (plain "
        f"{plain:.4f} ms), bound {b:.4f} ms by {by}: "
        f"{100 * b / dev_ms:.1f}% of the bound in device time")
    times.append({"kernel": "K3", "shape": [nq, n, d, k], "device_ms": dev_ms,
                  "ms": ms, "plain_ms": plain, "bound_ms": b})
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
            "bytes": nbytes, "ops": ops, "err": err}


# (Q, N, D, k): Q 1 and 130; N = k and 1,111; D 1, 5, 37 and 200 (and 600,
# past the resident query tile); k 1, 6, 33 and 64
KNN_RAGGED = ((1, 1111, 37, 6), (130, 1111, 1, 1), (130, 1111, 5, 33),
              (130, 64, 37, 64), (130, 6, 200, 6), (1, 1111, 200, 64),
              (130, 1111, 200, 33), (130, 33, 5, 33), (130, 1, 37, 1),
              (130, 1111, 600, 6))


def check_knn_ragged(dev, g) -> None:
    """K3 against its plain version at KNN_RAGGED: distances within 1e-4
    relative, indices equal but at counted near ties. Then queries that
    are references (as KNN-MSE's are) must find themselves first at a
    distance of exactly 0: the norms are summed in the dot products'
    order, so a near-duplicate state cannot win by rounding."""
    import torch
    from srl_zoo_tpu_torch.ops.knn_topk import knn_topk_with_dist
    worst, ties = 0.0, 0
    for nq, n, d, k in KNN_RAGGED:
        q = torch.randn((nq, d), generator=g, device=dev)
        refs = torch.randn((n, d), generator=g, device=dev)
        rel, t, _ = knn_against_plain(q, refs, k)
        worst, ties = max(worst, rel), ties + t
    refs = torch.randn((N_FRAMES, STATE_DIM), generator=g, device=dev)
    kd, ki = knn_topk_with_dist(refs[:KNN_QUERIES], refs, 6)
    if not (bool((kd[:, 0] == 0).all()) and torch.equal(
            ki[:, 0], torch.arange(KNN_QUERIES, device=dev))):
        raise AssertionError("knn_topk: a query that is a reference is not "
                             "its own nearest at distance 0")
    log(f"K3 at {len(KNN_RAGGED)} ragged shapes (Q 1/130, N k/1111, D "
        f"1/5/37/200/600, k 1/6/33/64): max rel err {worst:.3g}, {ties} "
        f"index mismatches at near-ties; {KNN_QUERIES} queries that are "
        f"references find themselves first at distance 0")


def within_norm_tol(got, want, x, y, rtol: float = 1e-5) -> float:
    """Largest |got - want| / (|x_i|^2 + |y_j|^2); raises above ``rtol``
    (the formula cancels for near points, so the distance itself is no
    scale)."""
    import torch
    x, y = x.to(torch.float64), y.to(torch.float64)
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
    err = float(((got.to(torch.float64) - want.to(torch.float64)).abs()
                 / scale).max())
    if not err <= rtol:
        raise AssertionError(f"pairwise_sqdist: error {err} of |x|^2+|y|^2")
    return err


def check_pairwise(dev, g) -> dict:
    """K4 at the KNN shapes against its plain version and, on a corner,
    float64; timed beside torch.cdist; then the ``full`` route's top-6
    against the fused route's."""
    import torch
    from srl_zoo_tpu_torch.ops.knn_topk import knn_topk_with_dist
    from srl_zoo_tpu_torch.ops.pairwise import (pairwise_sqdist,
                                                pairwise_sqdist_plain)
    nq, n, d = KNN_QUERIES, N_FRAMES, STATE_DIM
    x = torch.randn((nq, d), generator=g, device=dev)
    y = torch.randn((n, d), generator=g, device=dev)
    out = pairwise_sqdist(x, y)
    ref = pairwise_sqdist_plain(x, y)
    torch.cuda.synchronize()
    rel = within_norm_tol(out, ref, x, y)
    err = float((out - ref).abs().max())
    del ref
    c = 512
    xc, yc = x[:c].double(), y[:c].double()
    f64 = ((xc[:, None, :] - yc[None, :, :]) ** 2).sum(-1)
    rel64 = within_norm_tol(out[:c, :c], f64, xc, yc)
    del out, f64
    edge = 0.0  # masked edges: 1 x 1, M % 4 != 0, D not a multiple of 16
    for en, em, ed in ((1, 1, 1), (129, 131, 5), (130, 257, 37),
                       (300, 1111, 200)):
        ex = torch.randn((en, ed), generator=g, device=dev)
        ey = torch.randn((em, ed), generator=g, device=dev)
        edge = max(edge, within_norm_tol(pairwise_sqdist(ex, ey),
                                         pairwise_sqdist_plain(ex, ey),
                                         ex, ey))
    call = lambda: pairwise_sqdist(x, y)  # noqa: E731
    dev_ms = device_ms(call, "pairwise_kernel")
    ms = time_ms(call)
    plain = time_ms(lambda: pairwise_sqdist_plain(x, y))
    lib = time_ms(lambda: torch.cdist(
        x, y, compute_mode="use_mm_for_euclid_dist"))
    nbytes = 4 * (nq + n) * d + 4 * nq * n
    ops = 2 * nq * n * d
    b, by = bound(nbytes, ops)
    log(f"K4 pairwise_sqdist Q={nq} N={n} D={d}: max err {rel:.3g} of "
        f"|x|^2+|y|^2 vs plain, {rel64:.3g} vs float64 on a {c}x{c} corner, "
        f"{edge:.3g} at four ragged shapes; device {dev_ms:.4f} ms "
        f"({ops / dev_ms / 1e9:.1f} TFLOP/s), wrapper {ms:.4f} ms (plain "
        f"{plain:.4f} ms, torch.cdist {lib:.4f} ms), bound {b:.4f} ms by "
        f"{by}: {100 * b / dev_ms:.1f}% of the bound in device time")
    k = 6
    fd, fi = knn_topk_with_dist(x, y, k, impl="full")
    kd, ki = knn_topk_with_dist(x, y, k)
    torch.cuda.synchronize()
    ties = near_tie_mismatches(x, y, fi, ki, 1e-4)
    full_ms = time_ms(lambda: knn_topk_with_dist(x, y, k, impl="full"),
                      iters=5)
    log(f"full route (K4 + stable sort) top-{k}: {ties} index mismatches "
        f"against K3 at near-ties; {full_ms:.4f} ms")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
            "library_ms": lib, "bytes": nbytes, "ops": ops, "err": err}


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------

def random_model(cfg, seed: int):
    """Config-1 model with seeded random weights and non-trivial BN stats."""
    import torch
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


# built once, before any timed request: urlopen builds its opener at first
# use, and ten client threads doing that at once cost each of them more
# than a steady request takes
OPENER = urllib.request.build_opener()


def post(url: str, arr: np.ndarray):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(f"{url}/encode", data=buf.getvalue(),
                                 method="POST")
    t0 = time.perf_counter()
    with OPENER.open(req, timeout=300) as r:
        states = np.load(io.BytesIO(r.read()))
    return states, (time.perf_counter() - t0) * 1e3


def serve_round(url: str, payloads) -> tuple:
    """One round of concurrent requests, a client thread each: ([(states,
    latency ms)] in the order of ``payloads``, the round's seconds)."""
    replies = [None] * len(payloads)

    def client(i):
        replies[i] = post(url, payloads[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if any(t.is_alive() for t in threads) or None in replies:
        raise AssertionError("a request did not complete")
    return replies, time.perf_counter() - t0


def profile_export(encoder, store, rows: int = 2048) -> None:
    """Device time by kernel, and the device's busy share of the wall
    time, over an export of ``rows`` rows of the store dict ``store``
    (torch.profiler, CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from srl_zoo_tpu_torch.evaluation.predict_dataset import predict_states
    idx = np.arange(min(rows, store["frames"].shape[0]))
    predict_states(encoder, store, idx)  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_states(encoder, store, idx)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels)
    log(f"profile export {len(idx)} rows: wall {wall_us / 1e3:.2f} ms, device "
        f"busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), idle "
        f"{100 * (1 - busy / wall_us):.1f}%")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms "
            f"{100 * e.self_device_time_total / busy:5.1f}% x{e.count:<4d} "
            f"{e.key[:90]}")


def check_full_route(q, refs, full_idx, queries, gt, score) -> None:
    """The full route's (k+1 = 6) nearest against the fused route's on the
    same points: indices equal but at counted near ties, and the KNN-MSE
    (k=5) from its neighbours equal to ``score`` within 1e-6."""
    from srl_zoo_tpu_torch.evaluation.knn import score_neighbors
    from srl_zoo_tpu_torch.ops.knn_topk import knn_topk
    fused = knn_topk(q, refs, full_idx.shape[1])
    ties = near_tie_mismatches(q, refs, full_idx, fused, 1e-4)
    full_score, _ = score_neighbors(full_idx.cpu().numpy(), queries, gt,
                                    full_idx.shape[1] - 1)
    if not abs(full_score - score) <= 1e-6 * max(1.0, abs(score)):
        raise AssertionError(f"full route knn_mse {full_score} vs fused "
                             f"{score}")
    log(f"full route vs fused: {ties} index mismatches at near-ties; "
        f"knn_mse {full_score:.9f} vs {score:.9f}")


def zero_counts(counters) -> None:
    for c in counters.values():
        c.launches = 0
        for extra in ("vector_launches", "bf16_launches"):
            if hasattr(c, extra):
                setattr(c, extra, 0)


def read_counts(counters, path: str) -> dict:
    """Launch counts by kernel, and the pools' bfloat16 launches under
    ``<kernel>/bf16``; fails unless every launch of the path of a kernel
    with a vector path (K1f, K1b, K2) took it."""
    launches = {k: c.launches for k, c in counters.items()}
    vector = {k: c.vector_launches for k, c in counters.items()
              if hasattr(c, "vector_launches")}
    bf16 = {k: c.bf16_launches for k, c in counters.items()
            if hasattr(c, "bf16_launches")}
    log(f"{path} launches: {launches}; on the vector path: {vector}; in "
        f"bf16: {bf16}")
    if any(vector[k] != launches[k] for k in vector):
        raise AssertionError(f"a launch of the {path} took the scalar path: "
                             f"{vector} of {launches}")
    return launches | {f"{k}/bf16": n for k, n in bf16.items()}


def run_slice(run_dir, frames_np, store, gt, counters) -> dict:
    import torch
    from srl_zoo_tpu_torch.evaluation.knn import (centre, knn_mse,
                                                  sample_queries,
                                                  score_neighbors)
    from srl_zoo_tpu_torch.evaluation.predict_dataset import predict_states
    from srl_zoo_tpu_torch.inference import StateEncoder
    from srl_zoo_tpu_torch.ops.knn_topk import knn_topk, knn_topk_plain
    from srl_zoo_tpu_torch.serve import build_server

    encoder = StateEncoder.load(run_dir)
    t0 = time.perf_counter()
    server = build_server(run_dir, port=0, max_batch=32, coalesce_ms=5)
    log(f"server up in {time.perf_counter() - t0:.1f} s (warms batch sizes "
        "1..32 on its encode thread)")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    payloads = [frames_np[i] for i in range(8)] + [frames_np[8:24],
                                                   frames_np[24:40]]
    try:
        # --- the main path, with the launch counts zeroed just before -----
        zero_counts(counters)
        # the first round is what the first clients of a fresh server see
        first_replies, first_s = serve_round(url, payloads)
        replies, serve_s = serve_round(url, payloads)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states = predict_states(encoder, {"frames": store})
        export_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        score, queries, nbrs = knn_mse(states, gt, k=5,
                                       n_samples=KNN_QUERIES, seed=SEED)
        knn_s = time.perf_counter() - t0

        # the same queries' 6 nearest through the full route (K4)
        t0 = time.perf_counter()
        refs = centre(torch.from_numpy(states).to(encoder.device))
        qi = torch.from_numpy(queries).to(encoder.device)
        full_idx = knn_topk(refs[qi], refs, 6, impl="full")
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        launches = read_counts(counters, "inference path")
        # --- end of the main path ------------------------------------------
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")
    for name, rep, secs in (("first", first_replies, first_s),
                            ("second", replies, serve_s)):
        lat = sorted(ms for _, ms in rep)
        log(f"serve, {name} round after start-up: 10 concurrent requests "
            f"(8 x 1 frame, 2 x 16) in {secs * 1e3:.1f} ms; latency min "
            f"{lat[0]:.1f} median {lat[len(lat) // 2]:.1f} max "
            f"{lat[-1]:.1f} ms")
    log(f"export: {len(states)} states in {export_s:.3f} s "
        f"({len(states) / export_s:.0f} frames/s, batches of 256)")
    log(f"knn_mse(k=5, {KNN_QUERIES} queries of {len(states)}): "
        f"{score:.6f} in {knn_s * 1e3:.1f} ms; full route top-6 of the same "
        f"queries in {full_s * 1e3:.1f} ms")
    if not all(launches[k] > 0 for k in INFERENCE_KERNELS):
        raise AssertionError(f"a kernel never ran on the inference path: "
                             f"{launches}")

    # --- outputs against direct encodes and the plain top-k ----------------
    direct = encoder.encode(frames_np[:40])
    for rep in (first_replies, replies):
        got = np.concatenate([rep[i][0][None] for i in range(8)]
                             + [rep[8][0], rep[9][0]])
        err = float(np.abs(got - direct).max())
        if got.shape != (40, STATE_DIM) or not err <= 1e-5:
            raise AssertionError(f"served states differ from encode: {err}")
    log(f"serve replies (both rounds) vs direct encode: max abs err "
        f"{err:.3g}")
    if states.shape != (N_FRAMES, STATE_DIM) or \
            not np.isfinite(states).all():
        raise AssertionError(f"export: shape {states.shape} or non-finite")
    rows = np.random.RandomState(SEED).choice(N_FRAMES, 64, replace=False)
    err = float(np.abs(states[rows] - encoder.encode(frames_np[rows])).max())
    if not err <= 1e-5:
        raise AssertionError(f"exported states differ from encode: {err}")
    log(f"export rows vs direct encode: max abs err {err:.3g}")
    queries_p = sample_queries(len(states), KNN_QUERIES, SEED)
    idx = knn_topk_plain(refs[qi], refs, 6)[1].cpu().numpy()
    plain_score, plain_nbrs = score_neighbors(idx, queries_p, gt, 5)
    if not (np.isfinite(score) and np.array_equal(queries, queries_p)
            and abs(score - plain_score) <= 1e-6 * max(1.0, abs(plain_score))):
        raise AssertionError(
            f"knn_mse {score} vs plain {plain_score}: "
            f"{int((nbrs != plain_nbrs).sum())} neighbour indices differ")
    log(f"knn_mse vs plain top-k: {score:.9f} vs {plain_score:.9f}")
    check_full_route(refs[qi], refs, full_idx, queries, gt, score)
    profile_export(encoder, {"frames": store})
    return launches


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------

def write_train_dataset(folder: str) -> None:
    """A two-camera dataset folder of TRAIN_FRAMES 224x224x3 frames in
    TRAIN_EPISODES episodes: a red square walks on a shaded background,
    and its centre (scaled to [0, 1]) is the ground truth; a reward of 1
    near the middle. The second view (``frames_2.npy``) is the scene
    mirrored left to right in other colours, as the JAX package's
    synthetic two-view datasets are. View 1's frames are also written as
    the JPEGs that ``images_path`` names (cv2), which the KNN-MSE
    neighbour grids decode."""
    import cv2
    rng = np.random.RandomState(SEED)
    n, (h, w, c) = TRAIN_FRAMES, IMG
    ep_len = n // TRAIN_EPISODES
    actions = rng.randint(0, 4, n).astype(np.int32)
    moves = np.array([[0, 6], [0, -6], [6, 0], [-6, 0]])
    pos = np.empty((n, 2))
    for e in range(TRAIN_EPISODES):
        s = slice(e * ep_len, (e + 1) * ep_len)
        walk = rng.uniform(40, h - 40, 2) + np.cumsum(moves[actions[s]], 0)
        pos[s] = np.clip(walk, 14, h - 15)
    starts = np.zeros(n, bool)
    starts[::ep_len] = True
    gt = (pos / h).astype(np.float32)
    rewards = (np.abs(gt - 0.5).max(axis=1) < 0.1).astype(np.float32)
    os.makedirs(folder, exist_ok=True)
    np.savez(os.path.join(folder, "preprocessed_data.npz"), actions=actions,
             rewards=rewards, episode_starts=starts)
    np.savez(os.path.join(folder, "ground_truth.npz"),
             ground_truth_states=gt,
             images_path=np.array([f"frame{i:06d}.jpg" for i in range(n)]))
    yy = np.arange(h)[None, :, None]
    xx = np.arange(w)[None, None, :]
    views = (("frames", (60, 80, 40), (220, 40, 40), pos),
             ("frames_2", (90, 50, 70), (40, 200, 60),
              np.stack([pos[:, 0], w - 1 - pos[:, 1]], axis=1)))
    for name, (base, dy, dx), colour, p_all in views:
        frames = np.lib.format.open_memmap(
            os.path.join(folder, f"{name}.npy"), mode="w+", dtype=np.uint8,
            shape=(n, h, w, c))
        shade = (base + dy * yy / h + dx * xx / w).astype(np.uint8)[0]
        for s in range(0, n, 256):
            p = p_all[s:s + 256]
            sq = (np.abs(yy - p[:, 0, None, None]) < 12) & \
                (np.abs(xx - p[:, 1, None, None]) < 12)
            block = np.empty((len(p), h, w, c), np.uint8)
            block[:] = shade[None, :, :, None]
            block[sq] = colour
            frames[s:s + 256] = block
            if name == "frames":
                for i, frame in enumerate(block, s):
                    if not cv2.imwrite(os.path.join(
                            folder, f"frame{i:06d}.jpg"), frame[..., ::-1]):
                        raise OSError(f"could not write frame {i}")
        frames.flush()
        del frames


def train_config(tokens, batch_size: int, model_kw=None):
    """SRLConfig of a --losses token list at the full width of the
    BASELINE configs (4 actions, 2 reward classes, as the dataset), with
    the model and views of ``model_kw`` (custom_cnn on one view if
    empty)."""
    from srl_zoo_tpu_torch.config import SRLConfig, parse_loss_arguments
    losses, splits = parse_loss_arguments(list(tokens), STATE_DIM)
    return SRLConfig(state_dim=STATE_DIM, img_height=IMG[0],
                     img_width=IMG[1], batch_size=batch_size, seed=SEED,
                     losses=tuple(losses.items()),
                     split_dims=tuple(splits.items()), n_actions=4,
                     n_reward_classes=2, **(model_kw or {}))


def cli_flags(model_kw) -> list:
    """The train CLI's flags of ``model_kw``."""
    flags = (["--model-type", model_kw.get("model_type", "custom_cnn")]
             + (["--multi-view"] if model_kw.get("multi_view") else []))
    for key, flag in CLI_FLAG.items():
        if key in model_kw:
            flags += [flag, str(model_kw[key])]
    return flags


def stacked_frames(dataset, rows, cfg) -> np.ndarray:
    """uint8 observations of ``rows`` as the encoder of ``cfg`` takes them:
    both views on the channel axis where it stacks them."""
    frames = np.asarray(dataset.frames[rows])
    if cfg.stack_views:
        frames = np.concatenate([frames, np.asarray(dataset.frames_2[rows])],
                                axis=-1)
    return frames


# each encoder's first layer (and its BatchNorm): the ResNet stem's
# tensors, which only the stem pool's routing reaches
STEMS = {"resnet": ("encoder.conv1.", "encoder.bn1."),
         "custom_cnn": ("encoder.convs.0.", "encoder.bns.0."),
         "mlp": ("encoder.layers.0.",), "linear": ("encoder.layers.0.",)}


def check_train_step_on_cpu(dev, name: str, tokens, model_kw,
                            seed: int = SEED, hold: bool = True) -> dict:
    """One train-mode forward + backward of a config at 224 px, batch
    CPU_STEP_BATCH, from the same weights, frames (a second view where
    the config reads one: the first mirrored, channels reversed),
    metadata and (VAE) noise, all drawn from ``seed``, on the card
    (kernels, f32), on the CPU (plain versions, f32) and on the CPU in
    float64. At this geometry the train-mode BatchNorm backwards cancel
    heavily, and f32 gradients stray from the float64 ones by ~1e-3 of
    their scale on either device. So the card's step is held to the
    float64 one within twice the CPU f32 step's deviation (+1e-5): its
    loss, and each gradient relative to its tensor's largest float64
    magnitude (a bias in front of a train-mode BatchNorm has an exact
    gradient of 0; there the scale is 1e-2 of the model's largest
    gradient), the worst tensor. A DAE's corruption, the episode prior's
    pairs and a perceptual loss's frozen DAE (seeded random weights) are
    the same on every device.

    A ResNet-18 step has, besides, ReLU inputs within rounding of 0, which
    each order of summation routes its own way, and a tensor above such a
    ReLU strays by several percent of its scale (printed), so the worst
    tensor is a matter of where the routings fall. For it the relative L2
    deviation is held instead, of the whole gradient and of the stem's
    tensors (conv1, bn1: the only gradients that the stem pool's routing
    reaches, ~1e-3 of the model's), and the CPU's f32 deviation is the
    larger of two orders of summation: the CPU step on all cores and on
    one thread. All measures are printed. Returns each run's deviations;
    with ``hold`` False nothing is held (``--step-seeds``).

    A ``--dtype bfloat16`` config is held as the ResNet step is, whatever
    its model: its card and CPU steps run in bf16, the float64 step is the
    float32 config's (the same function without the roundings), and a
    bf16 step's gradients stray from it by 10-50% in relative L2 on
    either device. The loss's limit is at least twice bfloat16's unit
    roundoff (the CPU tests' rule: one batch's loss deviation is a matter
    of where its roundings cancel); "stem" is the encoder's first layer
    and its BatchNorm."""
    import copy

    import torch
    from srl_zoo_tpu_torch.training.state import make_model
    from srl_zoo_tpu_torch.training.train_step import (_inputs, _loss,
                                                       draw_corruption)
    cfg = train_config(tokens, CPU_STEP_BATCH, model_kw).replace(seed=seed)
    if cfg.only_random_features:
        log(f"{name}: no train step to check (it trains nothing)")
        return {}
    b = CPU_STEP_BATCH
    rng = np.random.RandomState(seed)
    frames = torch.from_numpy(rng.randint(0, 256, (b + 1,) + IMG).astype(
        np.uint8))  # row b is the last row's next frame
    store = {"frames": frames,
             "frames_2": frames.flip(2, 3).contiguous()}
    batch = step_batch(np.arange(b), rng, b + 1)
    eps = torch.randn((2, b, STATE_DIM),
                      generator=torch.Generator().manual_seed(seed))
    # the DAE's draw and the perceptual loss's frozen DAE, the same on
    # every device
    corruption = draw_corruption(cfg, torch.Generator().manual_seed(seed),
                                 b, "cpu") if cfg.use_dae else None
    dae = random_dae(b, torch.device("cpu"), seed) \
        if "perceptual" in cfg.loss_names else None
    host = torch.device("cpu")
    cpu = make_model(cfg, host)
    bf16 = cfg.compute_dtype == "bfloat16"
    whole = cfg.model_type == "resnet" or bf16
    runs = [("card", copy.deepcopy(cpu).to(
        dev, memory_format=torch.channels_last), dev, torch.float32, 0),
        ("cpu", copy.deepcopy(cpu), host, torch.float32, 0)]
    if whole:
        runs.append(("cpu, one thread", copy.deepcopy(cpu), host,
                     torch.float32, 1))
    f64 = make_model(cfg.replace(compute_dtype="float32"), host)
    f64.load_state_dict(cpu.state_dict())
    runs.append(("f64", f64.double(), host, torch.float64, 0))
    res = {}
    threads = torch.get_num_threads()
    for run, model, d, dt, n_threads in runs:
        torch.set_num_threads(n_threads or threads)
        model.train()
        inputs = _inputs(model, {k: v.to(d) for k, v in store.items()},
                         batch)
        for k in ("obs", "next_obs", "pos_obs", "neg_obs"):
            if inputs[k] is not None:
                inputs[k] = inputs[k].to(dt)
        if cfg.use_vae:
            inputs["noise"] = {"state": eps[0].to(d, dt),
                               "next_state": eps[1].to(d, dt)}
        if corruption is not None:
            inputs["corruption"] = tuple(c.to(d) for c in corruption) \
                if isinstance(corruption, tuple) else corruption.to(d, dt)
        frozen = None if dae is None else copy.deepcopy(dae).to(d, dt)
        loss = _loss(model, inputs, frozen)[0]
        loss.backward()
        res[run] = (float(loss.detach()),
                    {k: p.grad.detach().double().cpu()
                     for k, p in model.named_parameters()})
    torch.set_num_threads(threads)
    l64, g64 = res.pop("f64")
    floor = 1e-2 * max(float(v.abs().max()) for v in g64.values())

    def rel_l2(grads, keys) -> float:
        return float(torch.cat([(grads[k] - g64[k]).ravel() for k in keys])
                     .norm() / torch.cat([g64[k].ravel() for k in keys])
                     .norm())

    stem = [k for k in g64 if k.startswith(STEMS[cfg.model_type])] \
        if whole else []
    dev_of = {}
    for run, (loss, grads) in res.items():
        dev_of[run] = {"loss": abs(loss - l64) / abs(l64), "worst": max(
            float((grads[k] - g64[k]).abs().max())
            / max(float(g64[k].abs().max()), floor) for k in g64),
            "l2": rel_l2(grads, list(g64))}
        if stem:
            dev_of[run]["stem_l2"] = rel_l2(grads, stem)
    report = "; ".join(
        f"{run} loss {d['loss']:.3g}, gradients {d['worst']:.3g} of their "
        f"scale (whole gradient L2 {d['l2']:.3g}"
        + (f", stem L2 {d['stem_l2']:.3g}" if stem else "") + ")"
        for run, d in dev_of.items())
    # the measures held, and their limits from the CPU deviations
    limits = step_limits(dev_of, bf16)
    over = [m for m in limits if dev_of["card"][m] > limits[m] + 1e-5]
    what = ("the whole gradient and the stem" if whole
            else "the worst tensor")
    if hold and over:
        raise AssertionError(f"{name} train step against float64: {report}; "
                             f"held: {what}; over: {', '.join(over)}")
    log(f"{name}: train step at batch {b}, {IMG[0]} px, seed {seed}, "
        f"against the float64 step: {report}; held: {what}"
        + (f"; over: {', '.join(over)}" if over else ""))
    return dev_of


def step_limits(dev_of: dict, bf16: bool) -> dict:
    """The limit of each held measure of a card step: twice the CPU runs'
    largest deviation (the whole gradient and the stem where the step
    has them, else the worst tensor), and for a bf16 loss at least twice
    bfloat16's unit roundoff."""
    cpus = [d for run, d in dev_of.items() if run != "card"]
    held = ("loss", "l2", "stem_l2") if "stem_l2" in dev_of["card"] else (
        "loss", "worst")
    return {m: 2 * max(max(d[m] for d in cpus),
                       U_BF16 if bf16 and m == "loss" else 0.0)
            for m in held}


def step_seeds(dev, n: int) -> None:
    """The card-vs-CPU step of the ResNet and bf16 configs at seeds
    0..n-1, nothing held: each held measure's ratio card / limit per
    seed, and its largest over the seeds (the margin the rule leaves)."""
    for name, tokens, _, model_kw in TRAIN_CONFIGS + BF16_DENSE_CONFIGS:
        bf16 = model_kw.get("compute_dtype") == "bfloat16"
        if model_kw.get("model_type") != "resnet" and not bf16:
            continue
        worst = {}
        for seed in range(n):
            d = check_train_step_on_cpu(dev, name, tokens, model_kw, seed,
                                        hold=False)
            ratios = {m: d["card"][m] / lim
                      for m, lim in step_limits(d, bf16).items()}
            log(f"{name} seed {seed}: card / limit: " + ", ".join(
                f"{m} {r:.3g}" for m, r in ratios.items()))
            for m, r in ratios.items():
                worst[m] = max(worst.get(m, 0.0), r)
        log(f"{name}: largest card / limit over {n} seeds: " + ", ".join(
            f"{m} {r:.3g}" for m, r in worst.items()))


def profile_training(dev, data_folder: str, name: str, tokens,
                     model_kw, frozen_dae=None) -> None:
    """Device time by kernel, and the device's busy share, over
    PROFILE_STEPS train steps of a config at batch 32 (torch.profiler),
    and the layout transposes among them (channels_last keeps them out).
    One more step runs under the profiler's warm-up before the window
    opens (records at the start of a trace are lost), and the window must
    hold every gather (K2) of its steps. ``frozen_dae`` is the perceptual
    loss's."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from srl_zoo_tpu_torch.data.device_cache import build_cache
    from srl_zoo_tpu_torch.data.loader import DataLoader, batch_flags
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.state import make_model, make_optimizer
    from srl_zoo_tpu_torch.training.train_step import train_step
    cfg = train_config(tokens, TRAIN_BATCH, model_kw)
    dataset = load_dataset(data_folder)
    store = build_cache(dataset, dev, cfg.needs_second_view)
    model = make_model(cfg, dev)
    opt = make_optimizer(cfg, model)
    batches = iter(DataLoader(dataset, dataset.training_indices(),
                              TRAIN_BATCH, seed=SEED, **batch_flags(cfg)))
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step(batch):
        train_step(model, opt, store, batch, gen, frozen_dae)
    step(next(batches))  # warm: cuDNN plans
    # each pool reads the NHWC view of its BatchNorm's output: that view
    # is the tensor itself (no copy) only if the output is channels_last,
    # which needs the encoder's input in NHWC (a DAE's corrupted frames too)
    # (a bf16 model's pools read bf16)
    enc = model.encoder
    pool_bns = list(enc.bns) if hasattr(enc, "bns") else [enc.bn1]
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    layouts = []
    hooks = [bn.register_forward_hook(lambda m, i, out: layouts.append(
        (out.is_contiguous(memory_format=torch.channels_last), out.dtype)))
        for bn in pool_bns]
    step(next(batches))
    for h in hooks:
        h.remove()
    # one record per pool BatchNorm and encoder pass: obs, next obs (where
    # a loss reads it), and the triplet's positive and negative
    passes = 1 + cfg.needs_next_obs + 2 * cfg.use_triplet
    if layouts != [(True, dtype)] * (len(pool_bns) * passes):
        raise AssertionError(f"a pool's input is not channels_last {dtype},"
                             f" so the pool reads a copy, or the step made "
                             f"other than {passes} encoder passes: "
                             f"{layouts}")
    log(f"{name}: the {len(layouts)} pool calls of a step read their "
        f"{str(dtype)[6:]} BatchNorm outputs in place (channels_last)")
    steps = [next(batches) for _ in range(PROFILE_STEPS + 1)]
    # one gather per encoder pass and camera view
    gathers = PROFILE_STEPS * passes * (2 if cfg.stack_views else 1)
    # CUPTI now and then drops a kernel record (see device_ms): a window
    # that lost a gather is profiled again, up to three times
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1,
                                       active=PROFILE_STEPS,
                                       repeat=1)) as prof:
            step(steps[0])
            torch.cuda.synchronize()
            prof.step()  # the warm-up step ends: the window opens
            t0 = time.perf_counter()
            for i, batch in enumerate(steps[1:]):
                step(batch)
                if i == PROFILE_STEPS - 1:
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
                prof.step()
        # a range such as the optimizer's "Optimizer.step#Adam.step" shows
        # on the device as a span from its first to its last kernel, idle
        # gaps included; its kernels are listed on their own, so it is
        # left out
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("Optimizer.")]
        k2 = sum(e.count for e in kernels if "gather_norm" in e.key)
        if k2 == gathers:
            break
        log(f"{name}: the profile holds {k2} K2 launches of its steps' "
            f"{gathers} (attempt {attempt + 1}): profiled again")
    busy = sum(e.self_device_time_total for e in kernels)
    log(f"{name}: profile train {PROFILE_STEPS} steps of batch "
        f"{TRAIN_BATCH}: wall "
        f"{wall_us / 1e3:.2f} ms ({wall_us / 1e3 / PROFILE_STEPS:.2f} ms per "
        f"step), device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}%), idle "
        f"{100 * (1 - busy / wall_us):.1f}%")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms "
            f"{100 * e.self_device_time_total / busy:5.1f}% x{e.count:<4d} "
            f"{e.key[:90]}")
    launched = {}
    for what, key in (("K1f", "relu_max_pool_fwd"),
                      ("K1b", "relu_max_pool_bwd"), ("K2", "gather_norm")):
        mine = [e for e in kernels if key in e.key]
        t = sum(e.self_device_time_total for e in mine)
        launched[what] = sum(e.count for e in mine)
        log(f"  {what}: {t / 1e3:.3f} ms ({100 * t / max(busy, 1e-9):.1f}% "
            f"of busy), {launched[what]} launches")
    if launched["K2"] != gathers:
        raise AssertionError(f"{name}: the profile holds {launched['K2']} "
                             f"K2 launches of its steps' {gathers}")
    layout = [e for e in kernels if is_transpose(e.key)]
    lt = sum(e.self_device_time_total for e in layout)
    log(f"  layout transposes (nchw<->nhwc): {sum(e.count for e in layout)} "
        f"launches of {len(layout)} kernels, {lt / 1e3:.3f} ms "
        f"({100 * lt / max(busy, 1e-9):.1f}% of busy)")

    # which operations launch them: one more step, with input shapes
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(steps[0])
        torch.cuda.synchronize()
    by_op = {}
    for e in prof.events():
        n = sum(is_transpose(k.name) for k in e.kernels)
        if n:
            key = f"{e.name} {e.input_shapes[:2]}"
            by_op[key] = by_op.get(key, 0) + n
    for key, n in sorted(by_op.items(), key=lambda kv: -kv[1]):
        log(f"  transposes in one step: x{n:<3d} from {key}")


def is_transpose(name: str) -> bool:
    return "nchwToNhwc" in name or "nhwcToNchw" in name


def timed_checkpoints():
    """Wrap ``AsyncCheckpointer.save_model`` and ``save_state`` to sum the
    main thread's seconds inside them: returns the list that gets one
    entry per ``save_state`` (one per epoch), and the undo."""
    from srl_zoo_tpu_torch.checkpoint import AsyncCheckpointer
    real = {n: getattr(AsyncCheckpointer, n)
            for n in ("save_model", "save_state")}
    per_epoch, pending = [], [0.0]

    def wrap(name):
        def timed(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real[name](self, *args, **kwargs)
            finally:
                pending[0] += time.perf_counter() - t0
                if name == "save_state":
                    per_epoch.append(pending[0])
                    pending[0] = 0.0
        return timed
    for n in real:
        setattr(AsyncCheckpointer, n, wrap(n))
    return per_epoch, lambda: [setattr(AsyncCheckpointer, n, f)
                               for n, f in real.items()]


def check_run_files(run_dir: str, name: str, epochs: int,
                    plots: bool) -> None:
    """The plots every run writes (and those of ``--plot-every 1``), and
    a resume checkpoint that loads with the run's epoch and step."""
    import torch
    want = ["states.png", "correlation.png"]
    if plots:
        want += [f"plots/epoch_{e}.png" for e in range(1, epochs + 1)] + \
            ["plots/latest.png", "plots/live.html"]
    missing = [f for f in want
               if not os.path.isfile(os.path.join(run_dir, f))
               or not os.path.getsize(os.path.join(run_dir, f)) > 0]
    if missing:
        raise AssertionError(f"{name}: no {missing}")
    state = torch.load(os.path.join(run_dir, "checkpoints",
                                    "state_latest.pth"),
                       map_location="cpu", weights_only=True)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        last_step = [json.loads(line)["step"] for line in f][-1]
    if (state["epoch"], state["step"]) != (epochs, last_step):
        raise AssertionError(f"{name}: state_latest.pth at epoch "
                             f"{state['epoch']} step {state['step']}, the "
                             f"run ended at {epochs}, {last_step}")
    log(f"{name}: {len(want)} plots written; state_latest.pth loads at "
        f"epoch {state['epoch']}, step {state['step']}")


def check_trained(run_dir: str, name: str, cfg, launches: dict) -> None:
    """A trained run's loss fell; its images/s; the episode prior's
    discriminator and encoder terms; Adam's step count under
    ``--grad-accum``; the perceptual run's K1b launches: three per
    encoder backward, and the gradient goes back through the frozen DAE's
    encoder on the reconstruction too."""
    import torch
    hist = np.load(os.path.join(run_dir, "loss_history.npz"))
    log(f"{name}: train/total by epoch: {hist['train/total'].tolist()}; "
        f"val/total: {hist['val/total'].tolist()}")
    if not hist["train/total"][-1] < hist["train/total"][0]:
        raise AssertionError(f"{name}: the training loss did not fall")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    ips = [r["images_per_sec"] for r in records]
    log(f"{name}: train images/s by epoch: {[round(v, 1) for v in ips]}")
    micro_steps = records[-1]["step"]
    if cfg.use_episode_prior:
        log(f"{name}: train discriminator BCE by epoch "
            f"{hist['train/episode-prior/discriminator'].tolist()}, "
            f"encoder BCE {hist['train/episode-prior'].tolist()} "
            f"(ln 2 = {np.log(2.0):.4f})")
    if cfg.grad_accum > 1:
        opt = torch.load(os.path.join(run_dir, "checkpoints",
                                      "state_latest.pth"),
                         map_location="cpu", weights_only=True)["optimizer"]
        steps = {int(s["step"]) for a in opt["adams"]
                 for s in a["state"].values()}
        want = micro_steps // cfg.grad_accum
        if steps != {want} or opt["micro_step"] != micro_steps % \
                cfg.grad_accum:
            raise AssertionError(f"{name}: Adam stepped {steps} times, micro"
                                 f"-step {opt['micro_step']}, over "
                                 f"{micro_steps} micro-steps at "
                                 f"--grad-accum {cfg.grad_accum}")
        log(f"{name}: Adam stepped {want} times over {micro_steps} "
            f"micro-steps (--grad-accum {cfg.grad_accum}, across epochs); "
            f"{opt['micro_step']} micro-steps pending")
    if "perceptual" in cfg.loss_names:
        want = 2 * len(POOLS) * micro_steps
        if launches["relu_max_pool_bwd"] != want:
            raise AssertionError(
                f"{name}: {launches['relu_max_pool_bwd']} K1b launches over "
                f"{micro_steps} steps, not {want} (the model's pools and the "
                "frozen DAE's on the reconstruction)")
        log(f"{name}: K1b {want} launches = 2 x 3 pools x {micro_steps} "
            "steps: the gradient went through the frozen DAE's pools")


def check_random_features(run_dir: str, cfg) -> None:
    """``--losses random``: srl_model.pth holds the seed's initial weights
    (a fresh ``make_model`` of the run's config, bit for bit), with no
    loss history and no resume checkpoint."""
    import torch
    from srl_zoo_tpu_torch.training.state import make_model
    saved = torch.load(os.path.join(run_dir, "srl_model.pth"),
                       map_location="cpu", weights_only=True)
    init = make_model(cfg, torch.device("cpu")).state_dict()
    if set(saved) != set(init) or not all(torch.equal(saved[k], init[k])
                                          for k in init):
        raise AssertionError("random: srl_model.pth is not the initial model")
    if np.load(os.path.join(run_dir, "loss_history.npz")).files or \
            os.path.exists(os.path.join(run_dir, "checkpoints")):
        raise AssertionError("random: the run trained")
    log("random: srl_model.pth equals the seed's initial model; no loss "
        "history, no checkpoint")


def run_training(data_folder: str, run_dir: str, dev, counters, name: str,
                 tokens, epochs: int, model_kw) -> dict:
    """A config trained through the CLI entry point at batch 32 on the
    card (config 1 with ``--plot-every 1``; ``model_kw`` gives the other
    flags), then its states scored by KNN-MSE through both neighbour
    routes and, for the ResNet runs and those of BF16_DENSE_CONFIGS, one
    round of 8 concurrent single frames served from the run, with the
    launch counts zeroed just before and read just after; then its
    outputs, plots and resume checkpoint are checked (``--losses
    random``: that it trained nothing). A bf16 run must launch its pools
    in bf16 only, an f32 run in f32 only, and an mlp or linear run no
    pool. A bf16 run's export and served states are held to a direct
    encode within 2^-7 of the largest |state| (export batches of 256,
    encode chunks of 32 and served groups of 8 take different cuDNN
    algorithms, which round bf16 intermediates differently), an f32
    run's within 1e-5."""

    import torch
    from srl_zoo_tpu_torch import train as train_cli
    from srl_zoo_tpu_torch.config import SRLConfig
    from srl_zoo_tpu_torch.data.device_cache import build_cache
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.evaluation.knn import centre, knn_mse
    from srl_zoo_tpu_torch.evaluation.predict_dataset import predict_states
    from srl_zoo_tpu_torch.inference import StateEncoder
    from srl_zoo_tpu_torch.ops.knn_topk import knn_topk
    from srl_zoo_tpu_torch.serve import build_server
    served_run = model_kw.get("model_type") == "resnet" or name in {
        n for n, *_ in BF16_DENSE_CONFIGS}
    dataset = load_dataset(data_folder)
    gt = dataset.ground_truth_states
    plots = name == "autoencoder"
    ckpt_s, undo = timed_checkpoints()
    # --- the training path, with the launch counts zeroed just before -----
    zero_counts(counters)
    t0 = time.perf_counter()
    try:
        train_cli.main(["--data-folder", data_folder, "--losses", *tokens,
                        *cli_flags(model_kw), "--state-dim", str(STATE_DIM),
                        "-bs", str(TRAIN_BATCH), "--epochs", str(epochs),
                        "--log-folder", run_dir,
                        *(["--plot-every", "1"] if plots else [])])
    finally:
        undo()
    train_s = time.perf_counter() - t0
    states = np.load(os.path.join(run_dir, "states_rewards.npz"))["states"]
    score, queries, _ = knn_mse(states, gt, k=5, n_samples=KNN_QUERIES,
                                seed=SEED)
    refs = centre(torch.from_numpy(states).to(dev))
    q = refs[torch.from_numpy(queries).to(dev)]
    full_idx = knn_topk(q, refs, 6, impl="full")
    torch.cuda.synchronize()
    cfg = SRLConfig.load(run_dir)
    served = None
    if served_run:
        server = build_server(run_dir, port=0, max_batch=32, coalesce_ms=5)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            served = serve_round(
                f"http://127.0.0.1:{server.server_address[1]}",
                list(stacked_frames(dataset, np.arange(8), cfg)))
        finally:
            server.shutdown()
            server.server_close()
            thread.join(30)
        if thread.is_alive():
            raise AssertionError("server thread did not stop")
    launches = read_counts(counters, f"{name} training path")
    # --- end of the training path -----------------------------------------
    log(f"{name}: train CLI ({epochs} epochs, export, GTC, plots) in "
        f"{train_s:.1f} s; main thread inside the checkpoint calls by "
        f"epoch: {[round(v, 6) for v in ckpt_s]} s")
    if cfg.only_random_features:
        # nothing trains: no backward, no checkpoint, no loss history
        check_random_features(run_dir, cfg)
        kernels = [k for k in TRAINING_KERNELS if k != "relu_max_pool_bwd"]
    else:
        check_run_files(run_dir, name, epochs, plots)
        kernels = TRAINING_KERNELS
    bf16 = cfg.compute_dtype == "bfloat16"
    if cfg.model_type in ("mlp", "linear"):
        # no pool in a dense model
        if any(launches[k] for k in POOL_KERNELS):
            raise AssertionError(f"{name}: a dense model launched a pool: "
                                 f"{launches}")
        kernels = [k for k in kernels if k not in POOL_KERNELS]
    elif any(launches[f"{k}/bf16"] != (launches[k] if bf16 else 0)
             for k in POOL_KERNELS):
        raise AssertionError(f"{name}: the pools of a {cfg.compute_dtype} "
                             f"run launched in another dtype: {launches}")
    if not all(launches[k] > 0 for k in kernels):
        raise AssertionError(f"a kernel never ran on the training path: "
                             f"{launches}")
    if not cfg.only_random_features:
        check_trained(run_dir, name, cfg, launches)
    if states.shape != (TRAIN_FRAMES, STATE_DIM) or \
            not np.isfinite(states).all():
        raise AssertionError(f"states_rewards.npz: {states.shape} or "
                             "non-finite")
    with open(os.path.join(run_dir, "gtc.txt")) as f:
        log(f"{name}: GTC after {epochs} epochs: {f.read().strip()}; "
            f"KNN-MSE (k=5) {score:.6f}")
    check_full_route(q, refs, full_idx, queries, gt, score)
    encoder = StateEncoder.load(run_dir)
    # export batches of 256 and encode chunks of 32 take different cuDNN
    # algorithms: their rounding, relative to the states' scale
    tol = 2.0 ** -7 if bf16 else 1e-5
    direct = encoder.encode(stacked_frames(dataset, np.arange(64), cfg))
    scale = float(np.abs(direct).max())
    err = float(np.abs(states[:64] - direct).max()) / scale
    if not err <= tol:
        raise AssertionError(f"exported states differ from encode: {err} "
                             "of their largest magnitude")
    if served is not None:
        replies, secs = served
        got = np.stack([states_ for states_, _ in replies])
        serve_err = float(np.abs(got - direct[:8]).max()) / scale
        lat = sorted(ms for _, ms in replies)
        log(f"{name}: serve, 8 concurrent single frames of "
            f"{cfg.n_channels} channels in {secs * 1e3:.1f} ms (latency "
            f"median {lat[len(lat) // 2]:.1f} max {lat[-1]:.1f} ms); "
            f"replies vs direct encode max err {serve_err:.3g} of the "
            "largest |state|")
        if got.shape != (8, STATE_DIM) or not serve_err <= tol:
            raise AssertionError(f"{name}: served states differ from encode:"
                                 f" {serve_err}")
    store = build_cache(dataset, encoder.device, cfg.stack_views)
    predict_states(encoder, store)  # warm; returns host arrays (synced)
    t0 = time.perf_counter()
    predict_states(encoder, store)
    export_s = time.perf_counter() - t0
    log(f"{name}: trained model: export vs direct encode max err {err:.3g} "
        f"of the largest |state|; {TRAIN_FRAMES / export_s:.0f} states/s "
        f"(export of {TRAIN_FRAMES} rows in batches of 256)")
    return launches


# ---------------------------------------------------------------------------
# phase 4b: the data layer
# ---------------------------------------------------------------------------

def record_scene(src: str, folder: str) -> None:
    """DATA_FRAMES frames of phase 4's scene (both views, its first
    episodes) recorded as episodes with the port's DatasetRecorder (JPEG
    quality 90), then preprocessed into the training schema (no frames
    cache yet); the schema must give back the scene's actions, ground
    truth and rewards (the last shifted by the recording convention:
    reward of acting at t, 0 at an episode's start)."""
    from srl_zoo_tpu_torch.data.record import DatasetRecorder
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.preprocessing.preprocess import preprocess_folder
    ds = load_dataset(src)
    ep_len = TRAIN_FRAMES // TRAIN_EPISODES
    rec = DatasetRecorder(folder)
    for e in range(DATA_FRAMES // ep_len):
        rec.new_episode()
        rows = np.arange(e * ep_len, (e + 1) * ep_len)
        acting = np.append(ds.rewards[rows[1:]], 0.0)
        for i, r in zip(rows, acting):
            rec.record(ds.frames[i], ds.actions[i], r,
                       ds.ground_truth_states[i], obs_2=ds.frames_2[i])
    rec.close()
    preprocess_folder(folder)
    got = load_dataset(folder)
    rows = np.arange(DATA_FRAMES)
    starts = got.episode_starts
    if got.n_samples != DATA_FRAMES or got.images_path_2 is None or \
            not np.array_equal(got.actions, ds.actions[rows]) or \
            not np.array_equal(got.ground_truth_states,
                               ds.ground_truth_states[rows]) or \
            not np.array_equal(got.rewards[~starts],
                               ds.rewards[rows][~starts]) or \
            got.rewards[starts].any():
        raise AssertionError("the recorded and preprocessed dataset differs "
                             "from the scene")


def check_jpeg_cache(src: str, folder: str) -> None:
    """Both views' frames caches built from the recorded JPEGs, held
    against the scene's pixels: the largest and the mean absolute error
    of JPEG quality 90 (the mean within 3 levels)."""
    from srl_zoo_tpu_torch import native
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.preprocessing.preprocess import \
        refresh_frames_caches
    native.reset_counts()
    t0 = time.perf_counter()
    refresh_frames_caches(folder, IMG[0])
    secs = time.perf_counter() - t0
    ds, got = load_dataset(src), load_dataset(folder)
    for name in ("frames", "frames_2"):
        a = np.asarray(getattr(got, name), np.int16)
        b = np.asarray(getattr(ds, name)[:DATA_FRAMES], np.int16)
        err = np.abs(a - b)
        log(f"frames cache {name}.npy from {DATA_FRAMES} JPEGs: largest "
            f"error {int(err.max())}, mean {float(err.mean()):.4f} levels")
        if a.shape != b.shape or not float(err.mean()) <= 3.0:
            raise AssertionError(f"{name}.npy: {a.shape} or mean error "
                                 f"{float(err.mean())}")
    log(f"both frames caches ({2 * DATA_FRAMES} images) built in "
        f"{secs:.1f} s by {decoders(native.counts)}")


def decoders(counts: dict) -> str:
    """Which routes of the native runtime served, with their images."""
    return ", ".join(f"{k} {v}" for k, v in counts.items() if v) or "none"


def check_streamed_no_sync(data_folder: str, dev) -> None:
    """Under ``set_sync_debug_mode("error")``: whole streamed train steps
    of config 1 (the batch's copy to the card, K2 over the identity index,
    forward, loss, backward, Adam), with and without the copy stream of
    ``--stream-overlap``; a train step of config 3 on a hybrid store's
    slot batch; and the store's adoption of a streamed batch of entering
    rows. The batches are assembled in pinned memory first (the loader's
    producer thread), and each kind of call runs once before, outside the
    mode."""
    import torch
    from srl_zoo_tpu_torch.data.hybrid import RotatingHotStore
    from srl_zoo_tpu_torch.data.loader import DataLoader, batch_flags
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.data.transfer import stream_batches
    from srl_zoo_tpu_torch.training.state import make_model, make_optimizer
    from srl_zoo_tpu_torch.training.train_step import train_step
    ds = load_dataset(data_folder)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg1 = train_config(["autoencoder"], TRAIN_BATCH)
    cfg3 = train_config(["priors"], TRAIN_BATCH)
    m1, m3 = make_model(cfg1, dev), make_model(cfg3, dev)
    o1, o3 = make_optimizer(cfg1, m1), make_optimizer(cfg3, m3)
    rows = np.arange(TRAIN_BATCH * 6)
    pinned = list(DataLoader(ds, rows, TRAIN_BATCH, shuffle=False,
                             emit_images=True, pin_memory=True,
                             **batch_flags(cfg1)))
    hot = RotatingHotStore(ds, dev, cfg3, 2 * TRAIN_FRAMES // 4)
    hot.begin_epoch()
    slot_rows = np.nonzero(hot.trainable_mask(np.arange(TRAIN_FRAMES - 1)))[0]
    slot_batch = next(iter(DataLoader(ds, slot_rows, TRAIN_BATCH,
                                      slot_map=hot.slot_of,
                                      **batch_flags(cfg3))))
    entering = list(stream_batches(DataLoader(
        ds, hot._entering[:2 * TRAIN_BATCH], TRAIN_BATCH, shuffle=False,
        emit_images=True, pin_memory=True, **batch_flags(cfg3)), dev))

    def streamed(batches, overlap):
        for b in stream_batches(batches, dev, overlap):
            train_step(m1, o1, None, b, gen)

    calls = [("streamed train_step of autoencoder (batch 0)",
              lambda: streamed(pinned[:1], False)),
             ("streamed train_steps with --stream-overlap (batches 1-2)",
              lambda: streamed(pinned[1:3], True)),
             ("slot-addressed train_step of priors", lambda: train_step(
                 m3, o3, hot.cache, slot_batch, gen)),
             ("adoption of a streamed batch of entering rows",
              lambda: hot.maybe_adopt(entering[0]["indices"], entering[0]))]
    for _, call in calls:  # first-use work, outside the mode
        call()
    calls[0] = ("streamed train_step of autoencoder (batch 3)",
                lambda: streamed(pinned[3:4], False))
    calls[1] = ("streamed train_steps with --stream-overlap (batches 4-5)",
                lambda: streamed(pinned[4:6], True))
    calls[3] = ("adoption of a streamed batch of entering rows",
                lambda: hot.maybe_adopt(entering[1]["indices"], entering[1]))
    torch.cuda.synchronize()
    _check_no_sync(calls, dev)
    torch.cuda.synchronize()
    log(f"no synchronise under set_sync_debug_mode('error'): "
        f"{', '.join(name for name, _ in calls)}")


def k2_by_route(learner_mod):
    """Wrap the learner's train and eval steps to split K2's launches by
    the kind of batch a step took (``streamed``: uint8 pixels; ``slot``:
    a hybrid store's slots; ``index``: the whole store's rows). Returns
    the counts and the undo."""
    from srl_zoo_tpu_torch.ops.gather_norm import gather_normalize
    counts = {"streamed": 0, "slot": 0, "index": 0}
    real = {f: getattr(learner_mod, f) for f in ("train_step", "eval_step")}

    def split(fn, batch_at):
        def step(*args, **kw):
            batch = args[batch_at]
            route = "streamed" if "obs" in batch else \
                "slot" if "cache_slots" in batch else "index"
            before = gather_normalize.launches
            out = fn(*args, **kw)
            counts[route] += gather_normalize.launches - before
            return out
        return step

    learner_mod.train_step = split(real["train_step"], 3)
    learner_mod.eval_step = split(real["eval_step"], 2)

    def undo():
        for f, fn in real.items():
            setattr(learner_mod, f, fn)
    return counts, undo


def capture_learners():
    """Hook ``SRL4robotics.learn`` to keep each learner the CLI builds and
    to turn its synchronised phase timing on. Returns the list and the
    undo."""
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    learners, real = [], SRL4robotics.learn

    def learn(self, *args, **kw):
        self.time_phases = True
        learners.append(self)
        return real(self, *args, **kw)
    SRL4robotics.learn = learn

    def undo():
        SRL4robotics.learn = real
    return learners, undo


def phase_summary(log_rows, name: str) -> None:
    """Per epoch: images/s of each train and validation phase, and the
    seconds of the hybrid store's adoptions and of its rotation (sweep
    rows)."""
    for epoch in sorted({r["epoch"] for r in log_rows}):
        rows = [r for r in log_rows if r["epoch"] == epoch]
        parts = []
        for r in rows:
            if r["what"].startswith(("train", "val")):
                parts.append(f"{r['what']} {r['rows']} rows "
                             f"{r['rows'] / max(r['s'], 1e-9):.0f} img/s")
        adopt = [r["s"] for r in rows if r["what"] == "adopt"]
        adv = [r for r in rows if r["what"] == "advance"]
        if adopt:
            parts.append(f"{len(adopt)} adoptions {sum(adopt):.4f} s")
        if adv:
            parts.append(f"advance {adv[0]['s']:.4f} s ({adv[0]['rows']} "
                         "rows swept)")
        log(f"{name} epoch {epoch + 1}: " + "; ".join(parts))


def run_data_config(data_folder: str, run_dir: str, counters, name: str,
                    tokens, epochs: int, flags, model_kw=None,
                    env=None) -> tuple:
    """One run of the train CLI on the data layer's paths (``flags``,
    ``env`` set around it), launch counts zeroed just before and read
    just after; K1f, K1b and K2 must have launched. Prints images/s by
    epoch (the CLI's metrics), by phase (synchronised phase timing) and
    which decoders served. Returns (launches, K2 by route, learner)."""
    from srl_zoo_tpu_torch import native
    from srl_zoo_tpu_torch import train as train_cli
    from srl_zoo_tpu_torch.training import learner as learner_mod
    learners, undo_learn = capture_learners()
    k2, undo_k2 = k2_by_route(learner_mod)
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    native.reset_counts()
    zero_counts(counters)
    t0 = time.perf_counter()
    try:
        train_cli.main(["--data-folder", data_folder, "--losses", *tokens,
                        *cli_flags(model_kw or {}), "--state-dim",
                        str(STATE_DIM), "-bs", str(TRAIN_BATCH), "--epochs",
                        str(epochs), "--log-folder", run_dir, "--num-cpu",
                        str(os.cpu_count() or 4), *flags])
    finally:
        undo_learn()
        undo_k2()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    secs = time.perf_counter() - t0
    launches = read_counts(counters, f"{name} data path")
    if not all(launches[k] > 0 for k in POOL_KERNELS + ("gather_normalize",)):
        raise AssertionError(f"{name}: a kernel never ran: {launches}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        ips = [round(json.loads(line)["images_per_sec"], 1) for line in f]
    hist = np.load(os.path.join(run_dir, "loss_history.npz"))
    states = np.load(os.path.join(run_dir, "states_rewards.npz"))["states"]
    if not np.isfinite(hist["train/total"]).all() or \
            not np.isfinite(states).all():
        raise AssertionError(f"{name}: non-finite losses or states")
    log(f"{name}: {' '.join(flags)}: train CLI ({epochs} epochs, export, "
        f"GTC) in {secs:.1f} s; train images/s by epoch {ips}; K2 launches "
        f"by batch {k2}; host runtime {decoders(native.counts)}")
    phase_summary(learners[0].phase_log, name)
    return launches, k2, learners[0]


def check_hybrid_store(learner, dataset,
                       epochs: int = DATA_EPOCHS_HYBRID) -> None:
    """The store invariant after ``epochs`` epochs of training: every
    resident row's slot holds that row's bytes, each view the store holds
    (compared in chunks on the card); and the hybrid export (the CLI's
    states_rewards.npz, through the rotated window and streaming) against
    an export from the whole store (1e-5 of the largest |state|)."""
    import torch
    from srl_zoo_tpu_torch.data.device_cache import build_cache
    from srl_zoo_tpu_torch.evaluation.predict_dataset import predict_states
    from srl_zoo_tpu_torch.inference import StateEncoder
    hot = learner._hot_store
    if hot is None or not hot.rotate or hot.epoch != epochs:
        raise AssertionError(f"no rotating hybrid store after {epochs} "
                             f"epochs: {hot}")
    resident = np.nonzero(hot.slot_of >= 0)[0]
    dev = hot.cache["frames"].device
    for name in hot.cache:
        src = getattr(dataset, name)
        for s in range(0, len(resident), 512):
            r = resident[s:s + 512]
            want = torch.from_numpy(np.asarray(src[r])).to(dev)
            got = hot.cache[name][torch.from_numpy(
                hot.slot_of[r].astype(np.int64)).to(dev)]
            if not torch.equal(got, want):
                raise AssertionError(f"hybrid store {name}: a resident "
                                     "row's slot holds other bytes")
    states = np.load(os.path.join(learner.log_folder,
                                  "states_rewards.npz"))["states"]
    encoder = StateEncoder(learner.cfg, learner.model.eval(), dev)
    cached = predict_states(encoder, build_cache(dataset, dev))
    err = float(np.abs(states - cached).max() / np.abs(cached).max())
    log(f"hybrid store after {hot.epoch} epochs: {hot.hot_n}/{hot.n} rows "
        f"resident, invariant holds for {len(hot.cache)} view(s); "
        f"{hot.adopted_rows} rows "
        f"adopted from streamed batches, {hot.swept_rows} swept from the "
        f"memmap; hybrid export vs whole-store export max err {err:.3g} of "
        "the largest |state|")
    if not err <= 1e-5:
        raise AssertionError(f"hybrid export differs: {err}")


def run_data_layer(data_folder: str, work: str, dev, counters) -> dict:
    """Phase 4b: record and preprocess, stream, go hybrid, balance (see
    the module note). Returns the launches summed over its runs."""
    from srl_zoo_tpu_torch.data.schema import load_dataset
    rec = f"{work}/recorded"
    t0 = time.perf_counter()
    record_scene(data_folder, rec)
    log(f"{DATA_FRAMES} frames (two views) recorded and preprocessed in "
        f"{time.perf_counter() - t0:.1f} s")
    check_streamed_no_sync(data_folder, dev)
    total = dict.fromkeys(counters, 0)
    runs = (
        ("config 1 from JPEGs", rec, ["autoencoder"],
         ["--device-cache", "off"], {}, {}, 2),
        ("config 1 from the memmap", data_folder, ["autoencoder"],
         ["--device-cache", "off"], {}, {}, 2),
        ("config 1 from the memmap, overlapped", data_folder,
         ["autoencoder"], ["--device-cache", "off", "--stream-overlap"], {},
         {}, 2),
        ("config 5 hybrid", data_folder, ["triplet"],
         ["--device-cache", "hybrid"], RESNET_VIEWS,
         {"SRL_ZOO_CACHE_BUDGET_MB": str((HYBRID_ROWS + 0.5) * 2
                                         * np.prod(IMG) / 2**20)},
         DATA_EPOCHS_HYBRID),
        ("config 3 balanced", data_folder, ["priors"],
         ["--balanced-sampling"], {}, {}, 2),
    )
    for i, (name, folder, tokens, flags, model_kw, env, epochs) in \
            enumerate(runs):
        t0 = time.perf_counter()
        launches, k2, learner = run_data_config(
            folder, f"{work}/run{i}", counters, name, tokens, epochs, flags,
            model_kw, env)
        total = {k: total[k] + launches[k] for k in counters}
        if "--device-cache" in flags and flags[1] == "off" and (
                k2["streamed"] == 0 or k2["slot"] or k2["index"]):
            raise AssertionError(f"{name}: K2 launches by batch {k2}")
        if name == "config 5 hybrid":
            if not (k2["streamed"] and k2["slot"]):
                raise AssertionError(f"{name}: K2 did not launch on both "
                                     f"streamed and slot batches: {k2}")
            check_hybrid_store(learner, load_dataset(folder))
        if name == "config 1 from JPEGs":
            check_jpeg_cache(data_folder, rec)
        log(f"phase 4b, {name} in {time.perf_counter() - t0:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 2b: K3 over reference blocks; phases 4a and 4c: the tooling and a
# process group
# ---------------------------------------------------------------------------

KNN_SHARDS = 4
PROFILE_ROWS = 640  # --training-set-size of the profiled epoch: 16 steps
PROFILED = {"relu_max_pool": "relu_max_pool_fwd",
            "relu_max_pool_bwd": "relu_max_pool_bwd",
            "gather_normalize": "gather_norm_kernel"}


def check_knn_sharded(dev, g, counters) -> dict:
    """Phase 2b: K3 over KNN_SHARDS blocks of the main shape's references
    on the one card, each block's candidates offset and merged
    (``merge_topk``, the merge of ``knn_topk_sharded``), against K3 over
    the whole set: indices equal but at counted near ties, distances
    within 1e-5 relative. The merge is timed beside K3 (CUDA events).
    Returns the blocks' K3 launches, counted from zero."""
    import torch
    from srl_zoo_tpu_torch.ops.knn_topk import (knn_topk_with_dist,
                                                merge_topk, reference_block)
    nq, n, d, k = KNN_QUERIES, N_FRAMES, STATE_DIM, 6
    q = torch.randn((nq, d), generator=g, device=dev)
    refs = torch.randn((n, d), generator=g, device=dev)
    blocks = [reference_block(refs, KNN_SHARDS, b) for b in range(KNN_SHARDS)]

    def local():
        out = []
        for block, start in blocks:
            bd, bi = knn_topk_with_dist(q, block, k)
            out.append((bd, bi + start))
        return out

    zero_counts(counters)
    parts = local()
    md, mi = merge_topk(parts, k)
    torch.cuda.synchronize()
    launches = read_counts(counters, "sharded K3 path")
    wd, wi = knn_topk_with_dist(q, refs, k)
    rel = float(((md - wd).abs() / wd.abs().clamp_min(1e-30)).max())
    if not rel <= 1e-5:
        raise AssertionError(f"sharded K3: distances max rel err {rel}")
    ties = near_tie_mismatches(q, refs, mi, wi, 1e-5)
    merge_ms = time_ms(lambda: merge_topk(parts, k))
    local_ms = time_ms(local)
    whole_ms = time_ms(lambda: knn_topk_with_dist(q, refs, k))
    log(f"K3 over {KNN_SHARDS} blocks of {blocks[0][0].shape[0]} references "
        f"(Q={nq}, N={n}, D={d}, k={k}): merged top-{k} vs K3 over the "
        f"whole set: max rel err {rel:.3g}, {ties} index mismatches at "
        f"near-ties; the {KNN_SHARDS} block calls {local_ms:.4f} ms, the "
        f"merge {merge_ms:.4f} ms, K3 over the whole set {whole_ms:.4f} ms "
        "(CUDA events)")
    if launches["knn_topk"] != KNN_SHARDS:
        raise AssertionError(f"sharded K3 launched {launches['knn_topk']} "
                             f"K3 calls, {KNN_SHARDS} expected")
    return launches


def run_profile(data_folder: str, run_dir: str, counters) -> dict:
    """Phase 4a: config 1 through the train CLI with ``--profile`` for one
    short epoch (PROFILE_ROWS rows, batch 32); the trace must hold K1f,
    K1b and K2 launches under the kernels' own names, and its summary
    (``utils/profiling.py``) must sum device time; its top table is
    printed. Then the doctor on the same dataset: its pinned bandwidth and
    the mode it names (the whole store is expected). Returns the run's
    launches, counted from zero."""
    import contextlib
    from srl_zoo_tpu_torch import train as train_cli
    from srl_zoo_tpu_torch.utils import doctor, profiling
    # CUPTI now and then drops kernel records (see device_ms): a trace
    # that lacks one of the kernels is taken again, once
    for attempt in range(2):
        run = f"{run_dir}_{attempt}"
        zero_counts(counters)
        t0 = time.perf_counter()
        train_cli.main(["--data-folder", data_folder, "--losses",
                        "autoencoder", "--state-dim", str(STATE_DIM), "-bs",
                        str(TRAIN_BATCH), "--epochs", "1",
                        "--training-set-size", str(PROFILE_ROWS),
                        "--log-folder", run, "--profile"])
        launches = read_counts(counters, "--profile run")
        log(f"--profile run (1 epoch of {PROFILE_ROWS} rows) in "
            f"{time.perf_counter() - t0:.1f} s")
        basis, rows = profiling.summarize_profile_dir(
            os.path.join(run, "profile"), top=10**6)
        traced = {k: sum(r.calls for r in rows if name in r.name)
                  for k, name in PROFILED.items()}
        for kernel, name in PROFILED.items():
            log(f"trace: {traced[kernel]} launches of {name} ({kernel}: "
                f"{launches[kernel]} counted in the run)")
        if basis == profiling.DEVICE_TIME and all(traced.values()):
            break
    if basis != profiling.DEVICE_TIME:
        raise AssertionError(f"the --profile trace has no device time "
                             f"({basis})")
    missing = [k for k, n in traced.items() if not n or not launches[k]]
    if missing:
        raise AssertionError(f"{missing} not in the --profile trace")
    log("profile summary, top 12:\n" + profiling.format_table(basis,
                                                              rows[:12]))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = doctor.main(["--data-folder", data_folder, "--img-size",
                          str(IMG[0]), "-bs", str(TRAIN_BATCH)])
    text = out.getvalue()
    lines = [ln for ln in text.splitlines()
             if "MB/s" in ln or "mode:" in ln or "device:" in ln
             or "budget" in ln]
    log("doctor: " + " | ".join(lines))
    if rc != 0 or "mode: whole store" not in text or "MB/s" not in text:
        raise AssertionError(f"doctor rc {rc}:\n{text}")
    return launches


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# phase 4c's runs of config 1 on the streamed and hybrid paths, in the
# group and without one: name, flags, environment (the hybrid store holds
# HYBRID_ROWS of the TRAIN_FRAMES rows, about half)
GROUP_STREAMS = (
    ("off", ["--device-cache", "off"], {}),
    ("off --stream-overlap", ["--device-cache", "off", "--stream-overlap"],
     {}),
    ("hybrid", ["--device-cache", "hybrid"],
     {"SRL_ZOO_CACHE_BUDGET_MB": str((HYBRID_ROWS + 0.5) * np.prod(IMG)
                                     / 2**20)}),
)
GROUP_EPOCHS = 2
# the hybrid run in the group against the same run alone: the largest
# relative difference of a training epoch mean allowed (the CPU tests'
# tolerance for a group against one process; the measured one is printed
# beside the spread of the lone runs under SPREAD_EPS)
GROUP_HYBRID_RTOL = 2e-2
SPREAD_EPS = 1e-6  # relative perturbation of the initial weights


@contextlib.contextmanager
def perturbed_init(eps: float):
    """The learner's models built with every initial weight scaled by
    1 + eps * N(0, 1) (a draw seeded with SEED): a run's spread under
    rounding-sized changes."""
    import torch
    from srl_zoo_tpu_torch.training import learner as learner_mod
    real = learner_mod.make_model

    def make_model(cfg, device):
        model = real(cfg, device)
        g = torch.Generator().manual_seed(SEED)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=g).to(
                    p.device))
        return model
    learner_mod.make_model = make_model
    try:
        yield
    finally:
        learner_mod.make_model = real


def run_streams(data_folder: str, work: str, counters, where: str) -> dict:
    """Each run of GROUP_STREAMS through the train CLI (``run_data_config``:
    launches counted from zero, K2 by route, images/s by epoch and by
    phase), then KNN-MSE of its exported states, whose K3 launches count
    with the run's. Every run must launch K1f, K1b, K2 and K3; a streamed
    run K2 on streamed batches only, a hybrid run K2 on streamed and slot
    batches. Returns {name: (run folder, launches, K2 by route, learner,
    collectives)}."""
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.evaluation.knn import knn_mse
    from srl_zoo_tpu_torch.parallel import mesh
    gt = load_dataset(data_folder).ground_truth_states
    out = {}
    for i, (name, flags, env) in enumerate(GROUP_STREAMS):
        run = f"{work}/{where.replace(' ', '_')}_{i}"
        mesh.zero_counts()
        launches, k2, learner = run_data_config(
            data_folder, run, counters, f"{where}, config 1 {name}",
            ["autoencoder"], GROUP_EPOCHS, flags, env=env)
        coll = dict(mesh.counts)
        states = np.load(os.path.join(run, "states_rewards.npz"))["states"]
        score, _, _ = knn_mse(states, gt, k=5, n_samples=KNN_QUERIES,
                              seed=SEED)
        launches["knn_topk"] = counters["knn_topk"].launches
        hybrid = name == "hybrid"
        log(f"{where}, config 1 {name}: KNN-MSE (k=5) {score:.6f}; "
            f"launches with the KNN-MSE {launches}; collectives {coll}")
        if not launches["knn_topk"] or not k2["streamed"] or \
                bool(k2["slot"]) != hybrid or k2["index"]:
            raise AssertionError(f"{where}, {name}: launches {launches}, "
                                 f"K2 by batch {k2}")
        out[name] = (run, launches, k2, learner, coll)
    return out


def equal_runs(a: str, b: str) -> str:
    """'' where two run folders hold equal loss histories and exported
    states, else what differs, with the largest difference."""
    for name in ("loss_history.npz", "states_rewards.npz"):
        x, y = np.load(os.path.join(a, name)), np.load(os.path.join(b, name))
        for key in y.files:
            if not np.array_equal(x[key], y[key]):
                return (f"{name} {key} differs by up to "
                        f"{float(np.abs(x[key] - y[key]).max()):.3g}")
    return ""


def train_deviation(a: str, b: str) -> list:
    """By epoch, the largest relative difference between two run folders'
    training epoch means, each loss term relative to its largest |mean|
    in ``b``."""
    x, y = (np.load(os.path.join(r, "loss_history.npz")) for r in (a, b))
    keys = [k for k in y.files if k.startswith("train/")]
    return [max(float(abs(x[k][e] - y[k][e]) / np.abs(y[k]).max())
                for k in keys) for e in range(len(y[keys[0]]))]


def run_process_group(data_folder: str, work: str, dev, counters) -> dict:
    """Phase 4c: a process group of world size 1 over nccl
    (``parallel/mesh.py``), in which config 1 trains through the train CLI
    for 2 epochs with ``--device-cache sharded``, with the whole store
    (``on``), then streamed (``off``, and with ``--stream-overlap``) and
    through a rotating hybrid store of about half the rows
    (``GROUP_STREAMS``); the three streamed and hybrid runs again without
    a group, and once more without a group from initial weights perturbed
    by SPREAD_EPS (the lone runs' spread under rounding-sized changes).
    Each run's collectives and launches are counted from zero; the
    sharded run must launch K2, K1f and K1b and gather by reduce-scatter; the sharded and the streamed runs' losses and exported
    states must equal the whole store's bit for bit; the hybrid run in the
    group must adopt through uint8 all-gathers, hold the store invariant
    and keep its training means within GROUP_HYBRID_RTOL of the same run
    alone. cuDNN runs its deterministic algorithms in every run: its
    default weight-gradient algorithms add in a varying order, and two
    runs of one config then part in the fourth digit of the loss on the
    H100. Then ``group_cost`` in the group and without it. Returns the
    launches summed over the sharded, streamed and hybrid runs."""
    import torch
    from srl_zoo_tpu_torch import train as train_cli
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.parallel import mesh
    mesh.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, dev)
    torch.backends.cudnn.deterministic = True
    results = {}
    try:
        timer = _StepTimer(data_folder, dev)
        for mode in ("sharded", "on"):
            zero_counts(counters)
            mesh.zero_counts()
            t0 = time.perf_counter()
            run = train_cli.main([
                "--data-folder", data_folder, "--losses", "autoencoder",
                "--state-dim", str(STATE_DIM), "-bs", str(TRAIN_BATCH),
                "--epochs", str(GROUP_EPOCHS), "--device-cache", mode,
                "--log-folder", f"{work}/{mode}"])
            secs = time.perf_counter() - t0
            launches = read_counts(counters, f"process group, {mode}")
            results[mode] = (run, launches, dict(mesh.counts))
            log(f"world size 1 over {mesh.dist.get_backend()}, "
                f"--device-cache {mode}: 2 epochs, export and GTC in "
                f"{secs:.1f} s; collectives {mesh.counts}")
        grouped = run_streams(data_folder, work, counters, "group")
        torch.backends.cudnn.deterministic = False
        cost = group_cost(timer, grouped=True)
    finally:
        torch.backends.cudnn.deterministic = False
        mesh.shutdown()
    cost.update(group_cost(timer, grouped=False))
    log("config 1's train step at batch 32, wall ms (best of 3 windows of "
        f"{GROUP_STEPS}): " + "; ".join(f"{k} {v:.3f}"
                                        for k, v in cost.items()))
    torch.backends.cudnn.deterministic = True
    try:
        alone = run_streams(data_folder, work, counters, "no group")
        with perturbed_init(SPREAD_EPS):
            spread = run_streams(data_folder, work, counters,
                                 "no group perturbed")
    finally:
        torch.backends.cudnn.deterministic = False
    run, launches, coll = results["sharded"]
    if not (launches["gather_normalize"] and launches["relu_max_pool"]
            and launches["relu_max_pool_bwd"] and coll["reduce_scatter"]):
        raise AssertionError(f"sharded run: launches {launches}, "
                             f"collectives {coll}")
    on = results["on"][0]
    for name, other in [("sharded store", run)] + [
            (f"--device-cache {n}", grouped[n][0])
            for n in ("off", "off --stream-overlap")]:
        diff = equal_runs(other, on)
        if diff:
            raise AssertionError(f"{name} vs whole store in the group: "
                                 f"{diff}")
    log("sharded store, streamed and streamed with --stream-overlap vs the "
        "whole store at world size 1: losses and exported states equal bit "
        "for bit")
    dataset = load_dataset(data_folder)
    (g_run, _, _, g_learner, g_coll), (a_run, _, _, a_learner, _) = \
        grouped["hybrid"], alone["hybrid"]
    if not g_coll["all_gather_frames"]:
        raise AssertionError(f"hybrid run in the group adopted no rows "
                             f"through an all-gather: {g_coll}")
    for learner in (g_learner, a_learner):
        check_hybrid_store(learner, dataset, GROUP_EPOCHS)
    if not np.array_equal(g_learner._hot_store.slot_of,
                          a_learner._hot_store.slot_of):
        raise AssertionError("hybrid run: the slot maps in and out of the "
                             "group differ")
    def by_epoch(runs, n):
        return [float(f"{r:.3g}") for r in train_deviation(runs[n][0],
                                                           alone[n][0])]
    rel = by_epoch(grouped, "hybrid")
    log(f"hybrid run in the group vs alone: {g_coll['all_gather_frames']} "
        f"adoption all-gathers; training epoch means differ by {max(rel)} "
        f"relative at most (limit {GROUP_HYBRID_RTOL}), by epoch {rel}; "
        f"the streamed run in the group vs alone by epoch "
        f"{by_epoch(grouped, 'off')}; alone with the initial weights "
        f"perturbed by {SPREAD_EPS}: hybrid {by_epoch(spread, 'hybrid')}, "
        f"streamed {by_epoch(spread, 'off')}")
    if not max(rel) <= GROUP_HYBRID_RTOL:
        raise AssertionError(f"hybrid run in the group vs alone: {rel}")
    total = dict(launches)
    for runs in (grouped, alone, spread):
        for _, ran, _, _, _ in runs.values():
            total = {k: total[k] + ran[k] for k in total}
    return total


GROUP_STEPS = 30  # train steps a timed window of phase 4c's account


class _StepTimer:
    """Config 1's train step at batch 32 on the whole store, timed: the
    model, optimizer and batches are built once and reused by every
    variant of phase 4c's account."""

    def __init__(self, data_folder: str, dev):
        import torch
        from srl_zoo_tpu_torch.data.device_cache import build_cache
        from srl_zoo_tpu_torch.data.loader import DataLoader, batch_flags
        from srl_zoo_tpu_torch.data.schema import load_dataset
        from srl_zoo_tpu_torch.training.state import (make_model,
                                                      make_optimizer)
        from srl_zoo_tpu_torch.training.train_step import train_step
        cfg = train_config(("autoencoder",), TRAIN_BATCH)
        dataset = load_dataset(data_folder)
        store = build_cache(dataset, dev)
        model = make_model(cfg, dev)
        opt = make_optimizer(cfg, model)
        loader = iter(DataLoader(dataset, dataset.training_indices(),
                                 TRAIN_BATCH, seed=SEED, **batch_flags(cfg)))
        self.batches = [next(loader) for _ in range(GROUP_STEPS)]
        gen = torch.Generator(device=dev).manual_seed(SEED)
        self.step = lambda b: train_step(model, opt, store, b, gen)

    def ms(self) -> float:
        """Wall ms a step: the best of three windows of GROUP_STEPS steps,
        each closed by a synchronise, after two warm steps."""
        import torch
        for b in self.batches[:2]:
            self.step(b)
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in self.batches:
                self.step(b)
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3 / GROUP_STEPS)
        return best

    def profile(self, name: str) -> None:
        """CPU self time by operator, and the device's busy share, over
        PROFILE_STEPS steps (torch.profiler); the top 12 operators and the
        host time of the collectives and their clones are printed."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        from srl_zoo_tpu_torch.utils import profiling
        for b in self.batches[:2]:
            self.step(b)
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for b in self.batches[:PROFILE_STEPS]:
                    self.step(b)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            _, dev_rows = profiling.summarize_trace(path, top=10**6)
            basis, rows = profiling.summarize_trace(
                path, top=10**6, basis=profiling.CPU_SELF_TIME)
        busy = sum(r.ms for r in dev_rows)
        host = sum(r.ms for r in rows)

        def share(*keys):
            ms = sum(r.ms for r in rows if any(k in r.name for k in keys))
            return (f"{ms / PROFILE_STEPS:.3f} ms a step "
                    f"({100 * ms / host:.1f}%)")
        log(f"{name}: {PROFILE_STEPS} steps in {wall:.2f} ms "
            f"({wall / PROFILE_STEPS:.2f} ms a step), device busy "
            f"{busy:.2f} ms ({100 * busy / wall:.1f}%); operators' CPU self "
            f"time {host / PROFILE_STEPS:.2f} ms a step, of which the "
            f"collectives {share('nccl:', 'c10d::', 'record_param_comms')}, "
            f"clones {share('aten::clone')}; top 12:\n"
            + profiling.format_table(basis, rows[:12]))


def group_cost(timer: "_StepTimer", grouped: bool) -> dict:
    """Phase 4c's account of what the process group costs config 1's step:
    wall ms a step in the group as it runs, with nn.BatchNorm2d's own
    (cuDNN) forward in place of the global BatchNorm, and with the
    collectives' NCCL calls skipped (at world size 1 each leaves its
    tensor as it is: the step computes the same numbers); without a group,
    the step alone (``grouped`` False). One profile of each of the group's
    step and the lone step."""
    import contextlib
    from unittest import mock
    import torch
    from srl_zoo_tpu_torch.models.batchnorm import BatchNorm
    from srl_zoo_tpu_torch.parallel import mesh
    if not grouped:
        timer.profile("no group")
        return {"no group": timer.ms()}

    def no_nccl():
        stack = contextlib.ExitStack()
        copy = lambda out, t, *a, **k: out.copy_(t)  # noqa: E731
        for name, fn in (("all_reduce", lambda t, *a, **k: None),
                         ("all_gather_single", copy),
                         ("all_gather_into_tensor", copy),
                         ("reduce_scatter_single", copy),
                         ("reduce_scatter_tensor", copy)):
            if hasattr(mesh.dist, name):
                stack.enter_context(mock.patch.object(mesh.dist, name, fn))
        return stack

    variants = {
        "group": contextlib.nullcontext,
        "group, nn.BatchNorm2d's forward": lambda: mock.patch.object(
            BatchNorm, "forward", torch.nn.BatchNorm2d.forward),
        "group, NCCL calls skipped": no_nccl}
    timer.profile("group")
    out = {}
    for name, patch in variants.items():
        with patch():
            out[name] = timer.ms()
    return out


# ---------------------------------------------------------------------------
# phase 5: the pipeline
# ---------------------------------------------------------------------------

def run_pipeline(data_folder: str, work: str, counters) -> dict:
    """BASELINE config 5 through the port's pipeline entry point
    (``srl_zoo_tpu_torch.pipeline.main``: train, KNN-MSE with neighbour
    grids, reward probe, report) for PIPELINE_SEEDS, in ``work``, with the
    launch counts zeroed just before and read just after; then the report
    is held against direct scores of each cell's states."""
    from srl_zoo_tpu_torch import pipeline
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.evaluation.knn import knn_mse
    os.makedirs(work, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        # --- the pipeline's path, with the launch counts zeroed just before
        zero_counts(counters)
        t0 = time.perf_counter()
        results = pipeline.main([
            "--data-folder", data_folder, "--losses", "triplet",
            "--model-types", "resnet", "--multi-view", "--img-size",
            str(IMG[0]), "--state-dims", str(STATE_DIM), "-bs",
            str(TRAIN_BATCH), "--epochs",
            str(PIPELINE_EPOCHS), "--seeds", *map(str, PIPELINE_SEEDS)])
        wall = time.perf_counter() - t0
        launches = read_counts(counters, "pipeline")
        # --- end of the pipeline's path -----------------------------------
        with open(os.path.join("logs", os.path.basename(data_folder),
                               "pipeline_report.json")) as f:
            report = json.load(f)
        folders = [os.path.join(work, d) for d in report[0]["log_folders"]]
    finally:
        os.chdir(cwd)
    if not all(launches[k] > 0 for k in PIPELINE_KERNELS):
        raise AssertionError(f"a kernel never ran in the pipeline: "
                             f"{launches}")
    if report != results or len(report) != 1 or \
            report[0]["seeds"] != list(PIPELINE_SEEDS):
        raise AssertionError(f"pipeline report: {report}")
    (cell,) = report
    gt = load_dataset(data_folder).ground_truth_states
    per_seed = {"knn_mse": [], "gtc": [], "reward_accuracy": []}
    for seed, folder in zip(PIPELINE_SEEDS, folders):
        states = np.load(os.path.join(folder, "states_rewards.npz"))["states"]
        direct, _, _ = knn_mse(states, gt, k=5)
        with open(os.path.join(folder, "knn_mse.json")) as f:
            knn = json.load(f)["knn_mse"]
        with open(os.path.join(folder, "gtc.txt")) as f:
            gtc = float(f.read())
        with open(os.path.join(folder, "reward_accuracy.json")) as f:
            acc = json.load(f)["accuracy"]
        with open(os.path.join(folder, "metrics.jsonl")) as f:
            ips = [json.loads(line)["images_per_sec"] for line in f]
        files = ["states.png", "correlation.png"] + [
            f"NearestNeighbors/knn_grid_{g}.png" for g in range(3)]
        missing = [n for n in files
                   if not os.path.isfile(os.path.join(folder, n))]
        if missing or not abs(knn - direct) <= 1e-6 * abs(direct) or \
                not 0.0 <= acc <= 1.0:
            raise AssertionError(f"pipeline seed {seed}: knn_mse {knn} vs "
                                 f"direct {direct}, accuracy {acc}, missing "
                                 f"{missing}")
        log(f"pipeline seed {seed}: KNN-MSE {knn:.6f} (direct "
            f"{direct:.6f}), GTC {gtc:.4f}, reward accuracy {acc:.4f}, "
            f"train images/s by epoch {[round(v, 1) for v in ips]}")
        for key, v in (("knn_mse", knn), ("gtc", gtc),
                       ("reward_accuracy", acc)):
            per_seed[key].append(v)
    for key, vals in per_seed.items():
        if not (abs(cell[key] - np.mean(vals)) <= 1e-6 * max(1.0, abs(
                cell[key])) and abs(cell[f"{key}_std"] - np.std(vals))
                <= 1e-6 * max(1.0, abs(cell[key]))):
            raise AssertionError(f"pipeline report {key}: {cell[key]} +- "
                                 f"{cell[f'{key}_std']} vs seeds {vals}")
    log(f"pipeline: config 5, {len(PIPELINE_SEEDS)} seeds x "
        f"{PIPELINE_EPOCHS} epochs in {wall:.1f} s; report KNN-MSE "
        f"{cell['knn_mse']:.6f} +- {cell['knn_mse_std']:.6f}, GTC "
        f"{cell['gtc']:.4f}, reward accuracy {cell['reward_accuracy']:.4f}, "
        f"images/s {cell['images_per_sec']:.1f}")
    return launches


def check_latent_sweeps(run_dir: str) -> None:
    """``enjoy_latent`` on a decoder run at 224 px (8 dims x 7 steps): its
    PNG, and the sweep's middle column (the mean state) against a direct
    decode of the mean state."""
    from srl_zoo_tpu_torch import checkpoint as ckpt
    from srl_zoo_tpu_torch.evaluation import enjoy_latent
    from srl_zoo_tpu_torch.utils.device import resolve_device
    t0 = time.perf_counter()
    out = enjoy_latent.main(["--log-folder", run_dir, "--n-dims", "8",
                             "--n-steps", "7"])
    secs = time.perf_counter() - t0
    cfg, model = ckpt.load_srl_model(run_dir, resolve_device(None))
    states = np.load(os.path.join(run_dir, "states_rewards.npz"))["states"]
    grid = enjoy_latent.latent_sweep_grid(cfg, model, states, 8, 7)
    direct = enjoy_latent.decode_states(cfg, model, states.mean(0)[None])[0]
    err = float(np.abs(grid[:, 3] - direct[None]).max()) / \
        float(np.abs(direct).max())
    if grid.shape != (8, 7) + IMG or not err <= 1e-5 or \
            not os.path.getsize(out) > 0:
        raise AssertionError(f"latent sweeps {grid.shape}: middle column "
                             f"vs direct decode {err}")
    log(f"enjoy_latent (8 dims x 7 steps at {IMG[0]} px) in {secs:.1f} s; "
        f"middle column vs direct decode of the mean state: {err:.3g} of "
        "its largest value")


def kernel_counters() -> dict:
    """Each kernel's wrapper by name: the launch counts live on them."""
    from srl_zoo_tpu_torch.ops import (fused_pool, gather_norm, knn_topk,
                                       pairwise)
    return {"relu_max_pool": fused_pool.relu_max_pool,
            "relu_max_pool_bwd": fused_pool.relu_max_pool_bwd,
            "gather_normalize": gather_norm.gather_normalize,
            "knn_topk": knn_topk.knn_topk_with_dist,
            "pairwise_sqdist": pairwise.pairwise_sqdist}


def kernels_only(card: str, tree: str) -> int:
    """Phase 2's main-shape checks and timings of the pools (K1f, K1b), the
    gather (K2) and the top-k (K3) alone, on the port package of ``tree``
    (another checkout, for a parent-against-change comparison on one
    card), then one ``{"tree": ..., "pool_times": [...], "kernel_times":
    [...]}`` line and the card."""
    import torch
    from srl_zoo_tpu_torch.utils.device import (resolve_device,
                                                use_strict_float32)
    dev = resolve_device(None)
    use_strict_float32()
    g = torch.Generator(device=dev).manual_seed(SEED)
    times = []
    t0 = time.perf_counter()
    check_pool(dev, g, times)
    check_pool_bwd(dev, g, times)
    log(f"pools of {tree} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    store = torch.randint(0, 256, (N_FRAMES,) + IMG, generator=g, device=dev,
                          dtype=torch.uint8)
    kernel_times = []
    check_gather(store, dev, kernel_times)
    del store
    check_knn(dev, g, kernel_times)
    log(f"K2 and K3 of {tree} in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"tree": tree, "pool_times": times,
                      "kernel_times": kernel_times}))
    print(card)
    return 0


def data_layer_only(card: str) -> int:
    """K2 over the identity index (phase 2) and phase 4b alone, on a
    freshly written phase 4 dataset, and the card."""
    import torch
    from srl_zoo_tpu_torch.utils.device import (resolve_device,
                                                use_strict_float32)
    dev = resolve_device(None)
    use_strict_float32()
    counters = kernel_counters()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_train_dataset(f"{tmp}/data")
        log(f"training dataset written in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        check_gather_streamed(dev, torch.Generator(device=dev).manual_seed(
            SEED), [])
        launches = run_data_layer(f"{tmp}/data", f"{tmp}/data_layer", dev,
                                  counters)
        log(f"phase 4b (data layer) in {time.perf_counter() - t0:.1f} s; "
            f"launches {launches}")
    print(card)
    return 0


def run_tooling(data_folder: str, work: str, dev, counters) -> dict:
    t0 = time.perf_counter()
    launches = run_profile(data_folder, f"{work}/profiled", counters)
    log(f"phase 4a (--profile, profile summary, doctor) in "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def run_group(data_folder: str, work: str, dev, counters) -> dict:
    t0 = time.perf_counter()
    launches = run_process_group(data_folder, f"{work}/group", dev, counters)
    log(f"phase 4c (process group of world size 1) in "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def dist_tooling_only(card: str) -> int:
    """Phases 2b, 4a and 4c alone, on a freshly written phase 4 dataset,
    and the card."""
    import torch
    from srl_zoo_tpu_torch.utils.device import (resolve_device,
                                                use_strict_float32)
    dev = resolve_device(None)
    use_strict_float32()
    counters = kernel_counters()
    t0 = time.perf_counter()
    check_knn_sharded(dev, torch.Generator(device=dev).manual_seed(SEED),
                      counters)
    log(f"phase 2b in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_train_dataset(f"{tmp}/data")
        log(f"training dataset written in {time.perf_counter() - t0:.1f} s")
        run_tooling(f"{tmp}/data", tmp, dev, counters)
        run_group(f"{tmp}/data", tmp, dev, counters)
    print(card)
    return 0


def main(argv) -> int:
    tree = seeds = None
    data_only = argv == ["--data-layer"]
    dist_only = argv == ["--dist-tooling"]
    if argv and not (data_only or dist_only):
        if len(argv) != 2 or argv[0] not in ("--pools-of", "--step-seeds") \
                or argv[0] == "--step-seeds" and not argv[1].isdigit():
            print("usage: chip_smoke.py [--pools-of CHECKOUT | --step-seeds "
                  "N | --data-layer | --dist-tooling]", file=sys.stderr)
            return 2
        if argv[0] == "--step-seeds":
            seeds = int(argv[1])
        else:
            # that checkout's port package, kernels and build directory
            tree = os.path.abspath(argv[1])
            sys.path.insert(0, tree)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    try:
        from srl_zoo_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from "
              "the root of a checkout", file=sys.stderr)
        return 2
    try:
        card = card_line()
        log(card)
        t0 = time.perf_counter()
        _build.build_all()
        log(f"kernels built in {time.perf_counter() - t0:.1f} s")
        if tree is not None:
            return kernels_only(card, tree)
        if seeds is not None:
            from srl_zoo_tpu_torch.utils.device import (resolve_device,
                                                        use_strict_float32)
            use_strict_float32()
            step_seeds(resolve_device(None), seeds)
            print(card)
            return 0
        if data_only:
            return data_layer_only(card)
        if dist_only:
            return dist_tooling_only(card)

        from srl_zoo_tpu_torch.checkpoint import save_srl_model
        from srl_zoo_tpu_torch.config import SRLConfig
        from srl_zoo_tpu_torch.data.device_cache import build_cache
        from srl_zoo_tpu_torch.data.schema import Dataset
        from srl_zoo_tpu_torch.utils.device import (resolve_device,
                                                    use_strict_float32)
        dev = resolve_device(None)
        use_strict_float32()
        g = torch.Generator(device=dev).manual_seed(SEED)

        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED)
        frames_np = rng.integers(0, 256, (N_FRAMES,) + IMG, dtype=np.uint8)
        gt = rng.standard_normal((N_FRAMES, 3)).astype(np.float32)
        dataset = Dataset(data_folder="<generated>",
                          actions=np.zeros(N_FRAMES, np.int32),
                          rewards=np.zeros(N_FRAMES, np.float32),
                          ground_truth_states=gt, frames=frames_np)
        store = build_cache(dataset, dev)["frames"]
        log(f"frame store {tuple(store.shape)} uint8 "
            f"({store.numel() / 1e9:.2f} GB) resident in "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        times = []
        pools = check_pool(dev, g, times)
        stats = {"relu_max_pool": pools["export"] | {
                     "bf16": pools["export-bf16"]},
                 "relu_max_pool_bwd": check_pool_bwd(dev, g, times)}
        check_stem_pool(dev, g, times)
        check_pool_edges(dev, g)
        stats["gather_normalize"] = check_gather(store, dev, times)
        check_gather_streamed(dev, g, times)
        check_gather_edges(store, dev, g)
        check_no_sync(store, dev)
        stats["knn_topk"] = check_knn(dev, g, times)
        check_knn_ragged(dev, g)
        stats["pairwise_sqdist"] = check_pairwise(dev, g)
        log(f"phase 2 (kernels) in {time.perf_counter() - t0:.1f} s")
        counters = kernel_counters()
        t0 = time.perf_counter()
        knn_blocks = check_knn_sharded(dev, g, counters)
        log(f"phase 2b (K3 over {KNN_SHARDS} reference blocks) in "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        cfg = SRLConfig(state_dim=STATE_DIM, img_height=IMG[0],
                        img_width=IMG[1])
        with tempfile.TemporaryDirectory() as run_dir:
            save_srl_model(run_dir, random_model(cfg, SEED))
            launches = run_slice(run_dir, frames_np, store, gt, counters)
        launches = {k: launches[k] + knn_blocks[k] for k in counters}
        del store, frames_np
        log(f"phase 3 (inference) in {time.perf_counter() - t0:.1f} s")

        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            write_train_dataset(f"{tmp}/data")
            log(f"training dataset ({TRAIN_FRAMES} frames of "
                f"{TRAIN_EPISODES} episodes) written in "
                f"{time.perf_counter() - t0:.1f} s")
            # before phase 4's training profiles: after them CUPTI has
            # been seen to record no kernel at all
            ran = run_tooling(f"{tmp}/data", tmp, dev, counters)
            launches = {k: launches[k] + ran[k] for k in counters}
            for name, tokens, epochs, model_kw in TRAIN_CONFIGS:
                t0 = time.perf_counter()
                check_train_step_on_cpu(dev, name, tokens, model_kw)
                training = run_training(f"{tmp}/data", f"{tmp}/{name}", dev,
                                        counters, name, tokens, epochs,
                                        model_kw)
                launches = {k: launches[k] + training[k] for k in counters}
                log(f"phase 4, {name} in {time.perf_counter() - t0:.1f} s")
            for name, tokens, epochs, model_kw in BF16_DENSE_CONFIGS:
                t0 = time.perf_counter()
                check_train_step_on_cpu(dev, name, tokens, model_kw)
                training = run_training(f"{tmp}/data", f"{tmp}/{name}", dev,
                                        counters, name, tokens, epochs,
                                        model_kw)
                launches = {k: launches[k] + training[k] for k in counters}
                log(f"phase 4, {name} in {time.perf_counter() - t0:.1f} s")
            for name, tokens, epochs, kw in ZOO_CONFIGS:
                t0 = time.perf_counter()
                if "path_to_dae" in kw:
                    kw = {**kw, "path_to_dae": f"{tmp}/{kw['path_to_dae']}"}
                check_train_step_on_cpu(dev, name, tokens, kw)
                if epochs:
                    training = run_training(f"{tmp}/data", f"{tmp}/{name}",
                                            dev, counters, name, tokens,
                                            epochs, kw)
                    launches = {k: launches[k] + training[k]
                                for k in counters}
                log(f"phase 4, {name} in {time.perf_counter() - t0:.1f} s")
            from srl_zoo_tpu_torch.training.learner import load_frozen_dae
            # configs 1 and 5 in f32 and bf16, the DAE (its corrupted
            # frames must keep the pools' inputs in place) and the
            # perceptual loss
            profiled = TRAIN_CONFIGS[::4] + BF16_DENSE_CONFIGS[:2] + tuple(
                (n, t, e, {**kw, "path_to_dae": f"{tmp}/dae"}
                 if "path_to_dae" in kw else kw)
                for n, t, e, kw in ZOO_CONFIGS if n in ("dae", "perceptual"))
            for name, tokens, _, model_kw in profiled:
                t0 = time.perf_counter()
                profile_training(dev, f"{tmp}/data", name, tokens, model_kw,
                                 load_frozen_dae(f"{tmp}/dae", dev)
                                 if "path_to_dae" in model_kw else None)
                log(f"{name}: training profile in "
                    f"{time.perf_counter() - t0:.1f} s")

            t0 = time.perf_counter()
            data = run_data_layer(f"{tmp}/data", f"{tmp}/data_layer", dev,
                                  counters)
            launches = {k: launches[k] + data[k] for k in counters}
            log(f"phase 4b (data layer) in {time.perf_counter() - t0:.1f} s")
            ran = run_group(f"{tmp}/data", tmp, dev, counters)
            launches = {k: launches[k] + ran[k] for k in counters}

            t0 = time.perf_counter()
            piped = run_pipeline(f"{tmp}/data", f"{tmp}/pipeline", counters)
            launches = {k: launches[k] + piped[k] for k in counters}
            check_latent_sweeps(f"{tmp}/autoencoder")
            log(f"phase 5 (pipeline) in {time.perf_counter() - t0:.1f} s")
    except Exception:
        traceback.print_exc()
        return 1

    meta = {
        "relu_max_pool": ("srl_zoo_tpu_torch/csrc/fused_pool.cu",
                          "srl_zoo_tpu/ops/fused_pool.py:242"),
        "relu_max_pool_bwd": ("srl_zoo_tpu_torch/csrc/fused_pool_bwd.cu",
                              "srl_zoo_tpu/ops/fused_pool.py:275"),
        "gather_normalize": ("srl_zoo_tpu_torch/csrc/gather_norm.cu",
                             "srl_zoo_tpu/ops/gather_norm.py:44"),
        "knn_topk": ("srl_zoo_tpu_torch/csrc/knn_topk.cu",
                     "srl_zoo_tpu/ops/knn_topk.py:309"),
        "pairwise_sqdist": ("srl_zoo_tpu_torch/csrc/pairwise.cu",
                            "srl_zoo_tpu/ops/pairwise.py:49"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        s = stats[name]
        b, by = bound(s["bytes"], s["ops"])
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": s["err"], "ms": s["ms"]}
        if "bf16" in s:
            # the pools' bf16 shapes of the same calls: device ms and bound
            b16 = s["bf16"]
            entry |= {"device_ms_bf16": b16["device_ms"],
                      "ms_bf16": b16["ms"], "bound_ms_bf16": bound(
                          b16["bytes"], b16["ops"])[0]}
        kernels.append(entry | {"device_ms": s["device_ms"],
                                "plain_ms": s["plain_ms"], "bound_ms": b,
                                "bound_by": by,
                                "library_ms": s.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
