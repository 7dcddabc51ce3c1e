"""The training cells: ``SRL4robotics.learn`` over the configuration's
dataset, whole epochs (train phase, validation, the checkpoint writer), as
the port's ``train.py`` runs them.

Set-up makes the dataset and the weights from the seed, builds the
learner (its model, its Adam and its epoch runner) and loads the weights
into it. It then drives that same learner (``probe``) through its
validation pass and its first three train steps, by the store, the feed
and the call that the window uses: the learner's own store, which
``learn`` reuses, and the first phase of the learner's own loaders of
each split. A phase of a resident store runs by the epoch runner on the
buffers sized for the whole epoch, whose captured graphs ``learn``'s
epochs then replay; a streamed phase runs step by step on the learner's
streamed batches. The traffic's ``device_cache`` picks which. Then
``learn`` starts, and its first epoch is set-up too. The window opens at
the end of that epoch, after a device synchronise, runs whole epochs,
and closes at the end of the epoch in which ``--seconds`` ran out, after
a device synchronise (an epoch's end is ``learn``'s ``epoch_callback``,
which runs after the epoch's checkpoints are queued).

With ``--trace 1`` the learner's ``time_phases`` times each phase through
the window, and the profiler records the window's first epoch.

Once the window has closed, the peak memory is read, the learner is
freed, and the plain reference runs the probe's steps from the same
weights and inputs (harness/check.py says what is compared). A reference
names the inputs it reads (``INPUTS`` of ``reference/<arch>.py``), and
the harness builds exactly those out of the dataset, from the rows each
probe step read (``reference_step``).

As a kind (core.py): the limits are the configuration's ``limits.train``;
the planted faults are a step that returns its state unchanged and half
of each batch left out of the loss; a reading for ``calibrate.py`` is
set-up's probe against the reference, with no window.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import math
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.harness import check, core, data, flops
from portbench.harness import trace as tracing
from portbench.harness.core import Cell, Outcome, stage

# learn's epoch loop runs until the window closes it
EPOCHS = 10 ** 6
PROBE_STEPS = 3
LIMITS = "train"


class _WindowClosed(Exception):
    """Raised from the epoch callback to end ``learn`` at an epoch's end."""


def srl_config(cell: Cell, log_folder: str):
    """The port's config of the cell (as ``train.py`` builds it from its
    flags)."""
    from srl_zoo_tpu_torch.config import SRLConfig, parse_loss_arguments
    c, t = cell.config, cell.traffic
    losses, splits = parse_loss_arguments(c["losses"], c["state_dim"])
    return SRLConfig(
        state_dim=c["state_dim"], model_type=c["model_type"],
        losses=tuple(losses.items()), split_dims=tuple(splits.items()),
        n_actions=c["n_actions"], n_reward_classes=c["n_reward_classes"],
        img_height=c["img_height"], img_width=c["img_width"],
        multi_view=c["multi_view"], batch_size=c["batch_size"],
        epochs=EPOCHS, learning_rate=c["learning_rate"],
        seed=data.program_seed(cell.seed), val_size=c["val_size"],
        compute_dtype=c["compute_dtype"],
        device_cache=t.get("device_cache", "auto"),
        bn_momentum=c["bn_momentum"], log_folder=log_folder)


def load_weights(model, weights: Dict[str, torch.Tensor]) -> None:
    """The benchmark's weights into the port's model, in place; every
    tensor but BatchNorm's batch counts must be given, and no other."""
    missing, unexpected = model.load_state_dict(weights, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"weights do not fit the port's model: missing "
                       f"{missing}, unexpected {unexpected}")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def adam_gradients(learner) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient as the Adam got it at its first step:
    its first moment after one step, over 1 - b1 (zeros where the Adam
    holds no state: it took no step)."""
    names = {id(p): n for n, p in learner.model.named_parameters()}
    out = {}
    for adam in learner.optimizer.adams:
        for group in adam.param_groups:
            b1 = group["betas"][0]
            for p in group["params"]:
                m = adam.state.get(p, {}).get("exp_avg")
                out[names[id(p)]] = torch.zeros_like(p) if m is None \
                    else m.detach() / (1.0 - b1)
    return out


class FrameRows:
    """The dataset rows of view-1 frames, found by their pixels: a
    streamed triplet batch names its negatives by their frames alone
    (``neg_obs``). A frame that is no row of the dataset reads -1."""

    KEY_BYTES = 64

    def __init__(self, frames: np.ndarray):
        self.frames = frames
        self.flat = frames.reshape(len(frames), -1)
        self.by_key = None

    def __call__(self, images) -> np.ndarray:
        if self.by_key is None:
            self.by_key = {self.flat[i, :self.KEY_BYTES].tobytes(): i
                           for i in range(len(self.flat))}
        imgs = torch.as_tensor(images).cpu().numpy().reshape(len(images),
                                                              -1)
        rows = np.full(len(imgs), -1, np.int64)
        for j, img in enumerate(imgs):
            i = self.by_key.get(img[:self.KEY_BYTES].tobytes(), -1)
            if i >= 0 and np.array_equal(self.flat[i], img):
                rows[j] = i
        return rows


def _rows(batch: Dict, frame_rows: FrameRows) -> Dict:
    """The rows a batch reads: its anchors, its negatives (None without
    the triplet loss) and which rows are real (not padding)."""
    neg = batch.get("neg_indices")
    if neg is None and "neg_obs" in batch:
        neg = frame_rows(batch["neg_obs"])
    return {"rows": np.asarray(batch["indices"]).copy(),
            "neg_rows": None if neg is None else np.asarray(neg).copy(),
            "valid": np.asarray(batch["valid"]) > 0}


def _steps(learner, store, frame_rows: FrameRows, loader, cached: bool,
           train: bool, n: Optional[int] = None):
    """(rows, metrics) of the phase's first ``n`` steps (all where
    None), run as ``learn`` runs the phase: a whole phase by the epoch
    runner (a train phase in two runs, so that the first step's
    gradients can be read), a streamed one step by step on the learner's
    own batches. Each yield covers one or more steps: a list of their
    rows, and their ``total`` losses, one a step."""
    from srl_zoo_tpu_torch.data.device_cache import store_rows
    from srl_zoo_tpu_torch.training.learner import stack_batches
    from srl_zoo_tpu_torch.training.train_step import eval_step, train_step
    cfg = learner.cfg
    if learner._whole(cached):
        batches = list(loader)
        stacked = stack_batches(batches, cfg, store_rows(store))
        runner = learner.runner
        if not train:
            yield [_rows(b, frame_rows) for b in batches], runner.eval_epoch(
                store, stacked, None)
            return
        # the buffers and graphs that learn's epochs of this phase reuse:
        # sized for the whole epoch, then the first step, then the rest
        runner._program("train", store, stacked, None)
        n = len(batches) if n is None else min(n, len(batches))
        for a, b in ((0, 1), (1, n)):
            yield [_rows(x, frame_rows) for x in batches[a:b]], \
                runner.train_epoch(
                store, {k: v[a:b] for k, v in stacked.items()})
        return
    it = iter(loader)
    feed = learner._batches(it, cached)
    try:
        for batch in itertools.islice(feed, n):
            if train:
                m = train_step(learner.model, learner.optimizer,
                               store if cached else None, batch,
                               learner.generator, learner.frozen_dae)
            else:
                m = eval_step(learner.model, store if cached else None,
                              batch, None, learner.frozen_dae)
            yield [_rows(batch, frame_rows)], \
                {"total": m["total"].reshape(1)}
    finally:
        feed.close()
        it.close()


def probe(learner, dataset, cfg) -> Dict:
    """The learner's validation pass at the weights the benchmark made,
    then its first ``PROBE_STEPS`` train steps, each by the store, the
    feed and the call that the window's epochs use: the learner's own
    store (``_store``, opened once a dataset, which ``learn`` reuses) and
    the first phase of its own loaders (``_make_phase_loaders``) of each
    split. A whole phase (the store resident) runs by the epoch runner on
    the buffers and graphs that ``learn``'s epochs replay; a streamed one
    step by step. Returns each validation step's loss, each train step's
    loss, the first step's gradients as Adam got them, the parameters
    after the last step, and the rows each step read."""
    from srl_zoo_tpu_torch.training.learner import split_indices
    train_idx, val_idx = split_indices(dataset, cfg)
    store = learner._store(dataset)
    val = learner._make_phase_loaders(dataset, val_idx, shuffle=False,
                                      wraparound=False)[0]
    train = learner._make_phase_loaders(dataset, train_idx, shuffle=True,
                                        wraparound=True)[0]
    out = {"eval_losses": [], "eval_steps": [], "losses": [], "steps": []}
    frame_rows = FrameRows(dataset.frames)
    for rows, metrics in _steps(learner, store, frame_rows, *val,
                                train=False):
        out["eval_steps"] += rows
        out["eval_losses"] += metrics["total"].double().cpu().tolist()
    for rows, metrics in _steps(learner, store, frame_rows, *train,
                                train=True, n=PROBE_STEPS):
        out["steps"] += rows
        out["losses"] += metrics["total"].double().cpu().tolist()
        if "grads" not in out:
            out["grads"] = adam_gradients(learner)
    out["params"] = {k: p.detach().clone()
                     for k, p in learner.model.named_parameters()}
    return out


@dataclass
class TrainReadings:
    """What the per-layer readers of a training cell read."""
    config: Dict
    arch: object
    batch: int
    steps: Dict[str, int]             # train and eval steps an epoch
    epoch_s: List[float]              # the window's epochs, wall seconds
    phase_log: List[Dict]             # the learner's timed phases
    counts: Dict[str, int]            # the window's replays and steps
    traced_s: float = 0.0             # the traced epoch's wall seconds
    trace: Optional[tracing.Trace] = None


class Window:
    """``learn``'s epoch callback: opens the window at the end of the
    first (warm) epoch, closes it at the end of the epoch in which the
    seconds ran out; with ``trace`` profiles the window's first epoch."""

    def __init__(self, seconds: float, device, trace: bool, t0: float):
        self.t0 = t0
        self.seconds = seconds
        self.device = device
        self.trace = trace
        self.start: Optional[float] = None
        self.end: Optional[float] = None
        self.last = 0.0
        self.epoch_s: List[float] = []
        self.epochs: List[int] = []
        self.finite: List[bool] = []
        self.counts0: Dict[str, int] = {}
        self.counts1: Dict[str, int] = {}
        self.prof = None
        self.prof_t0 = 0.0
        self.traced_s = 0.0
        self.collected: Optional[tracing.Trace] = None

    @staticmethod
    def counts(learner) -> Dict[str, int]:
        return dict(learner.runner.counts(), loop_steps=learner.loop_steps)

    def __call__(self, learner, epoch, train_metrics, val_metrics):
        _sync(self.device)
        now = time.perf_counter()
        if self.start is None:
            print(f"portbench: warm epoch ended at {now - self.t0:.3f} s",
                  file=sys.stderr, flush=True)
            self.start = self.last = now
            self.counts0 = self.counts(learner)
            if self.trace:
                learner.time_phases = True
                self._start_profile()
            return
        self.epoch_s.append(now - self.last)
        self.epochs.append(epoch)
        self.finite.append(all(math.isfinite(m.get("total", math.nan))
                               for m in (train_metrics, val_metrics)))
        self.last = now
        if self.prof is not None:
            self.prof.stop()
            self.traced_s = now - self.prof_t0
            self.collected = tracing.collect(self.prof)
            self.prof = None
            self.last = time.perf_counter()
        if self._closes(now):
            self.end = now
            self.counts1 = self.counts(learner)
            raise _WindowClosed

    def _closes(self, now: float) -> bool:
        """Whether the window closes at this epoch's end."""
        return now - self.start >= self.seconds

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.prof_t0 = time.perf_counter()


def successors(dataset, rows) -> np.ndarray:
    """The row that follows each of ``rows`` in its episode, by the zoo's
    pairing of a frame with the next one (``episode_starts``): row i + 1
    where it exists and starts no episode, else -1. The zoo pairs an
    episode's last frame with nothing and leaves it out of its
    minibatches; the port's loader pairs it with row ``min(i + 1, N -
    1)``, the next episode's first frame or itself."""
    rows = np.asarray(rows, np.int64)
    nxt = rows + 1
    has = nxt < len(dataset.episode_starts)
    has[has] = ~np.asarray(dataset.episode_starts, bool)[nxt[has]]
    return np.where(has, nxt, -1)


def reward_classes(dataset, rows) -> np.ndarray:
    """The reward class the zoo pairs with the transition from each of
    ``rows`` to its successor: the class of the reward received on
    arriving at the successor (the dataset's ``rewards[t]`` is the reward
    on arriving at frame t), a class being the rank of the reward among
    the dataset's distinct values. -1 where the row has no successor."""
    rewards = np.asarray(dataset.rewards)
    classes = np.searchsorted(np.unique(rewards), rewards)
    nxt = successors(dataset, rows)
    return np.where(nxt >= 0, classes[np.maximum(nxt, 0)], -1)


# the inputs that only a transition has: a reference that reads one is
# handed the rows the zoo pairs with a successor
TRANSITION_INPUTS = ("next", "actions", "reward_classes")


def reference_step(cell: Cell, dataset, rows: Dict) -> Dict:
    """One probe step as the reference reads it: each input that its
    module names in ``INPUTS``, of the step's real rows (padding left
    out), out of the dataset, on the device: ``obs`` the uint8 frames,
    ``pos`` their second view, ``neg`` the negatives' frames (a black
    frame for one that is no row of the dataset), ``next`` the frames of
    their successors (``successors``), ``actions`` their actions and
    ``reward_classes`` the classes of the rewards their transitions earn
    (int64). A reference that reads a transition is handed only the rows
    that have a successor, as the zoo's minibatches hold only those."""
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cell.device)
    inputs = cell.arch.INPUTS
    keep = rows["valid"].copy()
    nxt = successors(dataset, rows["rows"])
    if any(k in TRANSITION_INPUTS for k in inputs):
        keep &= nxt >= 0
    r = rows["rows"][keep]

    def neg():
        # a negative that is no row of the dataset reads a black frame
        n = rows["neg_rows"][keep]
        return up(np.where((n >= 0)[:, None, None, None],
                           dataset.frames[np.maximum(n, 0)], 0
                           ).astype(np.uint8))
    make = {"obs": lambda: up(dataset.frames[r]),
            "pos": lambda: up(dataset.frames_2[r]),
            "neg": neg,
            "next": lambda: up(dataset.frames[nxt[keep]]),
            "actions": lambda: up(np.asarray(dataset.actions)[r].astype(
                np.int64)),
            "reward_classes": lambda: up(reward_classes(
                dataset, r).astype(np.int64))}
    return {k: make[k]() for k in inputs}


def setup(cell: Cell, folder: str):
    """(config, dataset, weights, learner) of a cell: the inputs made
    from the seed, and the port's learner holding the weights."""
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    cfg = srl_config(cell, folder)
    dataset = data.make_dataset(cell.config, cell.seed, cell.device)
    weights = data.make_weights(cell.arch.param_spec(cell.config),
                                cell.seed, cell.device)
    stage(cell, "dataset and weights made")
    learner = SRL4robotics(cfg, log_folder=folder, device=cell.device)
    load_weights(learner.model, weights)
    stage(cell, "learner built")
    return cfg, dataset, weights, learner


def numbers(cell: Cell, dataset, weights, got) -> Dict[str, float]:
    """The compared numbers of a probe against the plain reference, run
    from the same weights on the frames of the rows the probe read: its
    train steps, and its validation steps in eval mode, one at a time."""
    from portbench.reference.common import strict_float32
    strict_float32()
    ref = cell.arch.train_steps(
        weights, [reference_step(cell, dataset, s) for s in got["steps"]],
        cell.config)
    out = check.train_numbers(got, ref, weights)
    with torch.no_grad():
        ref_eval = [float(cell.arch.loss(
            weights, reference_step(cell, dataset, s), cell.config,
            train=False)) for s in got["eval_steps"]]
    out["eval_gap"] = max(check.loss_gaps(got["eval_losses"], ref_eval))
    anchors = [int(i) for s in got["steps"] for i in s["rows"]]
    out["repeated_rows"] = float(len(anchors) - len(set(anchors)))
    return out


def limits(cell: Cell) -> Dict[str, float]:
    key = core.load_kind(cell.traffic["kind"]).LIMITS
    return dict(cell.config["limits"][key], repeated_rows=0.0)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell: Cell) -> Outcome:
    folder = tempfile.mkdtemp(prefix="portbench_run_")
    try:
        return measure(cell, folder)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def measure(cell: Cell, folder: str, window: Optional[Window] = None,
            ranks: int = 1, settled=None, freed=None,
            judged: bool = True) -> Outcome:
    """A run of a training cell whose learner logs into ``folder``: set-up,
    the probe, the window (``window``, by default a ``Window`` of the
    cell) and, once the learner is freed, the reference. A rank of a
    process group of ``ranks`` processes passes its own window, what to
    do once the inputs are made (``settled``) and once the learner is
    freed (``freed``), and whether it runs the reference (``judged``)."""
    from srl_zoo_tpu_torch.training.learner import split_indices
    cfg, dataset, weights, learner = setup(cell, folder)
    if settled is not None:
        settled()
    got = probe(learner, dataset, cfg)
    stage(cell, "probe steps run")
    window = window or Window(cell.seconds, cell.device, cell.trace,
                              cell.t0)
    try:
        learner.learn(dataset, epoch_callback=window)
    except _WindowClosed:
        pass
    if window.end is None:
        raise RuntimeError("learn ended before the window closed")
    peak = torch.cuda.max_memory_allocated(cell.device) \
        if cell.device.type == "cuda" else 0
    train_idx, val_idx = split_indices(dataset, cfg)
    steps = flops.step_counts(len(train_idx), len(val_idx), cfg.batch_size)
    phase_log = [p for p in learner.phase_log
                 if p["epoch"] in window.epochs]
    del learner
    free(cell.device)
    if freed is not None:
        freed()
    # the reference runs after the window, with the program freed
    checks = check.judge(numbers(cell, dataset, weights, got),
                         limits(cell)) if judged else {}
    rows = steps["train"] * cfg.batch_size * len(window.epoch_s)
    n_bad = sum(not ok for ok in window.finite)
    e2e = {"setup_s": window.start - cell.t0,
           cell.traffic["rate_metric"]: rows / (window.end - window.start)}
    counts = {k: window.counts1[k] - window.counts0[k]
              for k in window.counts0}
    # a rank computes its share of each batch
    readings = TrainReadings(
        config=cell.config, arch=cell.arch, batch=cfg.batch_size // ranks,
        steps=steps, epoch_s=window.epoch_s, phase_log=phase_log,
        counts=counts, traced_s=window.traced_s, trace=window.collected)
    return Outcome(e2e=e2e, readings=readings, checks=checks,
                   attempted=steps["train"] * len(window.epoch_s),
                   failed=steps["train"] * n_bad,
                   memory_peak_bytes=peak, trace=window.collected,
                   traced_s=window.traced_s)


# ---- the kind's faults, readings and test size ------------------------------
@contextlib.contextmanager
def half_batch():
    """Half of every train and eval batch's rows left out of the loss,
    the mean taken over the rest (planted under the step's inputs)."""
    from srl_zoo_tpu_torch.training import train_step as ts
    orig = ts._draws

    def draws(model, images, tensors, valid, generator, corruption):
        keep = torch.ones_like(valid)
        keep[valid.shape[0] // 2:] = 0
        return orig(model, images, tensors, valid * keep, generator,
                    corruption)
    ts._draws = draws
    try:
        yield
    finally:
        ts._draws = orig


@contextlib.contextmanager
def unchanged_state():
    """A step that returns its state unchanged: Adam's step left out."""
    from srl_zoo_tpu_torch.training.state import AccumulatingAdam
    orig = AccumulatingAdam.apply

    def apply(self):
        for adam in self.adams:
            adam.zero_grad(set_to_none=not self.capturable)
    AccumulatingAdam.apply = apply
    try:
        yield
    finally:
        AccumulatingAdam.apply = orig


FAULTS = {"half_batch": half_batch, "unchanged_state": unchanged_state}


def reading(cell: Cell) -> Dict[str, float]:
    """The compared numbers of set-up's probe against the reference, with
    no window."""
    folder = tempfile.mkdtemp(prefix="portbench_calib_")
    try:
        cfg, dataset, weights, learner = setup(cell, folder)
        got = probe(learner, dataset, cfg)
        del learner
        free(cell.device)
        return numbers(cell, dataset, weights, got)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def readings(items):
    return core.planted_readings(reading, FAULTS, items)


def tiny(cell: Cell) -> None:
    """The tests' cut of a training cell: the configuration's
    (tests/helpers.py ``TINY``) alone."""
