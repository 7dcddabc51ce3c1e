"""The training runtime (port of ``srl_zoo_tpu/training/learner.py``
``SRL4robotics``).

``learn`` splits the dataset's transitions into train and validation rows
as the JAX learner does, opens the frame store that ``--device-cache``
asks for (data/device_cache.py ``open_store``: the whole store, a hybrid
store or none) and runs the epoch loop. Each split is one phase of index
batches over the whole store, one phase of streamed batches
(data/transfer.py, ``--stream-overlap``), or with a hybrid store
(data/hybrid.py) a hot phase of slot-addressed batches and a cold phase of
streamed ones, each batch wholly one or the other. A cached phase (the
whole store's, a hybrid store's hot phase) runs whole, as the JAX
learner's ``train_epoch`` / ``eval_epoch`` scan does: its batches are
stacked once (``stack_batches``) and the epoch runner (training/epoch.py)
runs them, on a CUDA device as replays of captured CUDA graphs. Streamed
and cold phases run the per-step loop (``train_step``, ``eval_step``), and
so does every phase in a process group (the choice is ``_whole``). Under
rotation the phases are rebuilt every epoch, their generator seeded with
seed + epoch, the cold phases adopt their entering rows into the store,
the slots
validation's hot phase reads are held until it is done, and the window
moves on after validation; a resumed run replays the window to its start
epoch. An epoch is the train steps, train metrics
averaged over valid rows, a masked validation pass in eval mode, the
best-validation weights kept as on-device copies and exported to
``srl_model.pth``, the loss history and a resume checkpoint per epoch,
both written by ``checkpoint.AsyncCheckpointer`` off the main thread. One
``torch.Generator`` on the device, seeded with the config's seed, draws
the VAE's noise and the DAE's corruption; the resume checkpoint keeps its
state. A DAE's validation corruption is drawn once per run from a
generator of its own, seeded with seed + 1 (so a resumed run draws it
again the same), and every validation batch of every epoch reads it.
With ``--pretrained-weights`` a torchvision ResNet-18 state dict goes into
the encoder before training (models/torch_port.py); with
``--path-to-dae`` a trained (D)AE run of the port is loaded frozen, outside
the model (``load_frozen_dae``), for the perceptual loss. A
``--losses random`` run trains nothing: it saves its initial model and an
empty loss history. ``predict_states`` encodes a dataset, or rows of it,
through ``evaluation/predict_dataset.py``.

With ``profile`` a ``torch.profiler`` trace of the first epoch's training
(epoch 0, or a resumed run's first) is written into ``<log>/profile``
(``utils/profiling.py`` summarizes it): CPU activity, and CUDA activity
on a CUDA device.

In a process group (parallel/mesh.py) every rank runs this loop on the
same global batches, each computing its rows of them (training/
train_step.py), and the losses, metrics and parameters are the same on
every rank. Every store mode runs there: the ranks agree on one plan
(data/device_cache.py ``group_budget``); a streamed phase's loader
fetches this rank's rows of each batch (data/loader.py); a hybrid store
is whole on every rank, its phases and rotation the same on each, and
its adoption gathers a streamed batch's frames from every rank
(data/hybrid.py). Rank 0 owns the run folder: it alone writes the model and the
resume checkpoints, which ``resume`` reads on every rank; rank i writes
its metrics (and its trace) into ``<log>/.proc<i>``. The exported states
are gathered to every rank.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from srl_zoo_tpu_torch import checkpoint as ckpt
from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.data.device_cache import open_store, store_rows
from srl_zoo_tpu_torch.data.loader import DataLoader, batch_flags
from srl_zoo_tpu_torch.data.schema import Dataset
from srl_zoo_tpu_torch.data.transfer import stream_batches
from srl_zoo_tpu_torch.evaluation import predict_dataset
from srl_zoo_tpu_torch.inference import StateEncoder
from srl_zoo_tpu_torch.models.torch_port import load_ported_resnet18
from srl_zoo_tpu_torch.ops.gather_norm import check_host_index
from srl_zoo_tpu_torch.parallel import mesh
from srl_zoo_tpu_torch.losses.registry import recompose_epoch_means
from srl_zoo_tpu_torch.training.epoch import EpochRunner
from srl_zoo_tpu_torch.training.metrics import MetricsLogger
from srl_zoo_tpu_torch.training.state import make_model, make_optimizer
from srl_zoo_tpu_torch.training.train_step import (draw_corruption,
                                                   eval_step, step_arrays,
                                                   train_step)
from srl_zoo_tpu_torch.utils import spans
from srl_zoo_tpu_torch.utils.device import resolve_device, use_strict_float32
from srl_zoo_tpu_torch.utils.misc import (printGreen, printRed, printYellow,
                                          set_global_seeds)


def split_indices(dataset: Dataset, cfg: SRLConfig
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(train, val) rows: the within-episode transitions in the order of a
    permutation drawn from ``RandomState(seed)``, cut to
    ``training_set_size``; the first ``val_size`` share is validation."""
    indices = dataset.training_indices()
    indices = indices[np.random.RandomState(cfg.seed).permutation(
        len(indices))]
    if cfg.training_set_size > 0:
        indices = indices[:cfg.training_set_size]
    n_val = int(len(indices) * cfg.val_size)
    return indices[n_val:], indices[:n_val]


def mean_metrics(metric_dicts: List[Dict[str, torch.Tensor]],
                 cfg: SRLConfig) -> Dict[str, float]:
    """Epoch means of per-step metrics (a step's dict of scalars, or a
    whole phase's of (n_steps,) tensors: training/epoch.py), each
    weighted by its own per-step denominator (``_w/<name>``, the pair
    count of a pair term, else ``_n_valid``, the valid row count), fetched
    from the device in one transfer; ``priors`` and ``total`` are then
    recomposed from the exact component means."""
    if not metric_dicts:
        return {}

    def stacked(k):
        return torch.cat([m[k].reshape(-1) for m in metric_dicts]).float()

    names = [k for k in metric_dicts[0] if not k.startswith("_")]
    weights = [stacked(f"_w/{k}" if f"_w/{k}" in metric_dicts[0]
                       else "_n_valid") for k in names]
    means = torch.stack([(stacked(k) * w).sum() / w.sum().clamp_min(1.0)
                         for k, w in zip(names, weights)]).cpu().tolist()
    return recompose_epoch_means(cfg, dict(zip(names, means)))


def stack_batches(batches: List[Dict], cfg: SRLConfig, n_rows: int
                  ) -> Dict[str, np.ndarray]:
    """A cached phase's index batches as (n_steps, B, ...) arrays of
    ``train_step.step_keys`` for the epoch runner (the JAX learner's
    ``_stack_batches``, without its bucket padding: here only the real
    steps run). Every store row is range-checked against the store's
    ``n_rows`` rows, and every pair partner against the batch, here,
    once for the phase: the runner's gathers read the rows as they
    are."""
    per_step = [step_arrays(b, cfg, n_rows) for b in batches]
    stacked = {k: np.stack([a[k] for a in per_step]) for k in per_step[0]}
    b = stacked["valid"].shape[1]
    for k, v in stacked.items():
        if k.endswith("rows"):
            check_host_index(v.reshape(-1), n_rows)
        elif k.endswith("partners"):
            check_host_index(v.reshape(-1), b)
    return stacked


def load_frozen_dae(log_folder: str, device: torch.device):
    """A trained (D)AE run of the port, in eval mode on ``device`` with
    its parameters frozen (requires_grad False), channels_last: the
    perceptual loss's feature network, ``encode`` (mu)."""
    _, dae = ckpt.load_srl_model(log_folder, device)
    return dae.requires_grad_(False)


class SRL4robotics:
    """Build / learn / predict / save."""

    def __init__(self, cfg: SRLConfig, log_folder: Optional[str] = None,
                 device=None):
        mesh.check_batch_size(cfg.batch_size)
        self.cfg = cfg
        self.log_folder = log_folder or cfg.log_folder or "logs/default"
        self.device = resolve_device(device)
        use_strict_float32()
        set_global_seeds(cfg.seed)
        self.model = make_model(cfg, self.device)
        if cfg.pretrained_weights:
            self._load_pretrained_encoder(cfg.pretrained_weights)
        self.optimizer = make_optimizer(cfg, self.model)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        if "perceptual" in cfg.loss_names and not cfg.path_to_dae:
            raise ValueError("perceptual loss requires a frozen DAE "
                             "(--path-to-dae)")
        self.frozen_dae = load_frozen_dae(cfg.path_to_dae, self.device) \
            if cfg.path_to_dae else None
        self.runner = EpochRunner(self.model, self.optimizer,
                                  self.generator, self.frozen_dae)
        # steps of the per-step loop (streamed and cold phases, and every
        # phase in a process group); the runner counts its own
        self.loop_steps = 0
        self._cache = None
        self._cache_of = None
        self._hot_store = None
        self._eval_corruption = None
        # with time_phases each phase, adoption and rotation is timed
        # between two device synchronises into phase_log (``_phase``; a
        # measurement aid: the synchronises stall the host's queue ahead
        # of the device)
        self.time_phases = False
        self.phase_log: List[Dict] = []
        n_params = sum(p.numel() for p in self.model.parameters())
        printGreen(f"Model: {cfg.model_type}, {n_params / 1e6:.2f}M params, "
                   f"on {self.device}, compute dtype {cfg.compute_dtype}")

    def _load_pretrained_encoder(self, path: str) -> None:
        """torchvision ResNet-18 weights into the encoder; its fc head
        keeps its fresh init, as the reference replaces fc too."""
        if self.cfg.model_type != "resnet":
            raise ValueError("--pretrained-weights supports --model-type "
                             "resnet only")
        missing, unexpected = self.model.encoder.load_state_dict(
            load_ported_resnet18(path), strict=False)
        if unexpected or set(missing) != {"fc.weight", "fc.bias"}:
            raise ValueError(f"{path} is not a ResNet-18 state dict: "
                             f"missing {missing}, unexpected {unexpected}")
        printGreen(f"Loaded pretrained ResNet-18 weights from {path}")

    def _store(self, dataset: Dataset):
        """The dataset's uint8 frame store on the device as
        ``--device-cache`` asks (both camera views where the config reads
        the second): the whole store, a hybrid store's tensors (its
        ``RotatingHotStore`` in ``_hot_store``) or None to stream; opened
        once per dataset."""
        if self._cache_of is not dataset:
            self._cache, self._hot_store = open_store(dataset, self.cfg,
                                                      self.device)
            self._cache_of = dataset
        return self._cache

    def _split_hot_cold(self, indices: np.ndarray,
                        for_encode: bool = False) -> np.ndarray:
        """Which rows the store serves this epoch: all without a hybrid
        store; else the resident rows, and for a training gather only
        those whose successor is resident too where next_obs is read."""
        if self._hot_store is None:
            return np.ones(len(indices), bool)
        if for_encode:
            return self._hot_store.resident_mask(indices)
        return self._hot_store.trainable_mask(indices)

    def _make_phase_loaders(self, dataset: Dataset, indices: np.ndarray,
                            shuffle: bool, wraparound: bool,
                            seed_offset: int = 0
                            ) -> List[Tuple[DataLoader, bool]]:
        """[(loader, cached)]: one phase over the whole store or streamed,
        or a hybrid store's hot phase (index or slot batches) and cold
        phase (streamed). The hot triplet negatives are drawn from this
        epoch's resident rows, the cold ones from the whole split."""
        cfg = self.cfg
        if len(indices) == 0:
            return []
        common = dict(shuffle=shuffle, seed=cfg.seed + seed_offset,
                      wraparound=wraparound, **batch_flags(cfg))
        streamed = dict(emit_images=True,
                        pin_memory=self.device.type == "cuda")
        if self._cache is None:
            return [(DataLoader(dataset, indices, cfg.batch_size, **common,
                                **streamed), False)]
        hot = self._split_hot_cold(indices)
        store = self._hot_store
        phases = []
        if hot.any():
            negs = indices[self._split_hot_cold(indices, for_encode=True)] \
                if store is not None and cfg.use_triplet else None
            slots = store.slot_of if store is not None and store.rotate \
                else None
            phases.append((DataLoader(dataset, indices[hot], cfg.batch_size,
                                      neg_pool=negs, slot_map=slots,
                                      **common), True))
        if not hot.all():
            phases.append((DataLoader(dataset, indices[~hot], cfg.batch_size,
                                      neg_pool=indices, **common,
                                      **streamed), False))
        return phases

    @contextlib.contextmanager
    def _phase(self, epoch: int, what: str):
        """Where ``time_phases`` asks for it, the block as the span
        ``srl.learn.phase`` between two device synchronises, logged into
        ``phase_log``; yields the entry, whose ``rows`` the block sets."""
        entry = {"epoch": epoch, "what": what, "rows": 0}
        if not self.time_phases:
            yield entry
            return
        self._sync()
        with spans.span("srl.learn.phase") as timed:
            yield entry
            self._sync()
        entry["s"] = timed.seconds
        self.phase_log.append(entry)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _phase_name(self, cached: bool) -> str:
        if self._hot_store is not None:
            return "hot" if cached else "cold"
        return "cached" if cached else "streamed"

    def _adopt(self, batch: Dict, epoch: int) -> None:
        """The hybrid store adopts a streamed batch's entering rows."""
        with self._phase(epoch, "adopt"):
            self._hot_store.maybe_adopt(batch["indices"], batch)

    def _whole(self, cached: bool) -> bool:
        """Whether a phase runs whole through the epoch runner: a cached
        phase without a process group. In a process group every phase
        keeps the per-step loop (capturing the group's step with its
        collectives is ROADMAP A14b)."""
        return cached and not mesh.active()

    def _batches(self, loader: DataLoader, cached: bool):
        """A phase's batches: index batches as they come, streamed ones
        with their pixels on the device."""
        if cached:
            return iter(loader)
        return stream_batches(loader, self.device, self.cfg.stream_overlap)

    # ---- training ----------------------------------------------------------
    def _start_profile(self):
        """A running profiler of the CPU (and the CUDA device)."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, epoch: int) -> None:
        self._sync()
        prof.stop()
        out = os.path.join(mesh.rank_folder(self.log_folder), "profile")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"epoch_{epoch}.pt.trace.json")
        prof.export_chrome_trace(path)
        printGreen(f"Profile of epoch {epoch + 1}'s training -> {path}")

    def learn(self, dataset: Dataset, resume: bool = False,
              checkpoint_every: int = 1,
              epoch_callback: Optional[Callable] = None,
              profile: bool = False) -> Dict[str, float]:
        """Train on the dataset's transitions; returns the final
        validation metrics. ``resume`` continues from the run folder's
        resume checkpoint, if there is one. ``epoch_callback(learner,
        epoch, train_metrics, val_metrics)`` runs after each epoch's
        checkpoints are queued. ``profile`` traces the first epoch's
        training."""
        cfg = self.cfg
        owner = mesh.rank() == 0
        if cfg.use_supervised:
            sup_dim = cfg.slices["supervised"][1]
            gt_dim = dataset.ground_truth_states.shape[1]
            if sup_dim != gt_dim:
                raise ValueError(
                    f"supervised loss slice has size {sup_dim} but ground "
                    f"truth has {gt_dim} dims: use --state-dim/splits to "
                    "match")
        train_idx, val_idx = split_indices(dataset, cfg)
        printGreen(f"{len(train_idx)} training / {len(val_idx)} validation "
                   f"samples, batch size {cfg.batch_size}")
        logger = MetricsLogger(mesh.rank_folder(self.log_folder))
        if cfg.only_random_features:
            printYellow("random features only: skipping training")
            if owner:
                ckpt.save_srl_model(self.log_folder, self.model)
            logger.save_history()
            logger.close()
            return {"total": 0.0}
        self._store(dataset)
        hot_store = self._hot_store
        rotating = hot_store is not None and hot_store.rotate
        # the DAE's one validation draw, read by every validation pass
        self._eval_corruption = draw_corruption(
            cfg, torch.Generator(device=self.device).manual_seed(
                cfg.seed + 1), cfg.batch_size, self.device) \
            if cfg.use_dae else None

        def train_phases(epoch: int):
            return self._make_phase_loaders(
                dataset, train_idx, shuffle=True, wraparound=True,
                seed_offset=epoch if rotating else 0)

        def val_phases():
            # padded + masked, so val metrics are exact per-sample means
            return self._make_phase_loaders(dataset, val_idx, shuffle=False,
                                            wraparound=False)

        phases, vphases = train_phases(0), val_phases()
        # the rows validation's hot phase reads: its rows and their next
        val_reads = np.concatenate([val_idx, np.minimum(
            val_idx + 1, dataset.n_samples - 1)])
        start_epoch, step, best_val = 0, 0, float("inf")
        if resume:
            restored = ckpt.restore_train_state(self.log_folder, self.model,
                                                self.optimizer,
                                                self.generator)
            if restored is not None:
                step = restored["step"]
                start_epoch = min(restored["epoch"], cfg.epochs)
                best_val = restored["best_val"]
                printGreen(f"Resumed from step {step} (epoch {start_epoch}, "
                           f"best val {best_val:.4f})")
                if rotating:
                    hot_store.replay_to(start_epoch)
        # the shuffle of epoch e is drawn from RandomState(seed + e) in a
        # resumed run too
        for loader, _ in phases:
            loader.epoch = start_epoch
        best = ckpt.snapshot(self.model.state_dict())
        improved = False
        val_metrics: Dict[str, float] = {}
        writer = ckpt.AsyncCheckpointer(self.log_folder, self.device) \
            if owner else None
        prof = None
        try:
            for epoch in range(start_epoch, cfg.epochs):
                since, ran = spans.totals(), self.runner.counts()
                with spans.span("srl.learn.epoch"):
                    if profile and epoch == start_epoch:
                        prof = self._start_profile()
                    t_epoch = time.time()
                    if rotating:
                        hot_store.begin_epoch()
                        hot_store.hold(val_reads)
                        phases = train_phases(epoch)
                    acc, steps, n_images = self._train(phases, epoch)
                    step += steps
                    with spans.span("srl.learn.metrics"):
                        train_metrics = mean_metrics(acc, cfg)
                    ips = n_images / max(time.time() - t_epoch, 1e-9)
                    if prof is not None:
                        self._stop_profile(prof, epoch)
                        prof = None
                    if rotating:
                        vphases = val_phases()
                    val_metrics = self._run_eval(vphases, epoch) \
                        if vphases else train_metrics
                    if rotating:
                        # after validation, whose cold batches adopt too,
                        # and before the callback, which may export
                        # through the store
                        with self._phase(epoch, "advance") as timed:
                            swept = hot_store.swept_rows
                            hot_store.advance()
                            timed["rows"] = hot_store.swept_rows - swept

                    logger.log_epoch(epoch, train_metrics, val_metrics)
                    logger.log_step(step, {f"train/{k}": v
                                           for k, v in train_metrics.items()},
                                    epoch=epoch, images_per_sec=ips)
                    printGreen(f"Epoch {epoch + 1}/{cfg.epochs} "
                               f"train {train_metrics['total']:.4f} "
                               f"val {val_metrics['total']:.4f} "
                               f"({ips:.0f} img/s)")
                    if val_metrics["total"] < best_val:
                        best_val = val_metrics["total"]
                        best = writer.save_model(
                            self.model, self.model.state_dict()) if owner \
                            else ckpt.snapshot(self.model.state_dict())
                        improved = True
                    if (epoch + 1) % max(checkpoint_every, 1) == 0 \
                            or epoch == cfg.epochs - 1:
                        if self.optimizer.micro_step:
                            # a mid-cycle checkpoint saves every rank's
                            # gradients
                            self.optimizer.average_gradients()
                        if owner:
                            writer.save_state(self.model, self.optimizer,
                                              self.generator, step,
                                              epoch + 1, best_val)
                logger.log_spans(epoch, spans.delta(since), {
                    k: n - ran[k] for k, n in self.runner.counts().items()})
                if epoch_callback is not None:
                    epoch_callback(self, epoch, train_metrics, val_metrics)
        except BaseException:
            # flush the queued checkpoints (a crash is when the resume
            # checkpoint is needed) and keep the loss history of the epochs
            # that finished; a failed flush is reported and the original
            # error raised
            if prof is not None:
                prof.stop()
            try:
                if writer is not None:
                    writer.close()
            except Exception as err:
                printYellow(f"checkpoint flush failed during crash "
                            f"handling: {err!r}")
            finally:
                logger.save_history()
                logger.close()
            raise

        model_file = os.path.join(self.log_folder, ckpt.MODEL_FILE)
        if improved or not os.path.exists(model_file):
            if not improved and not np.isfinite(best_val):
                printRed("validation loss was never finite: the run "
                         "diverged; the exported srl_model.pth holds the "
                         "INITIAL (untrained) weights. Check --lr/--losses.")
            self.model.load_state_dict(best)
            if not improved and owner:
                writer.save_model(self.model, best)
        else:
            # resumed without beating the pre-crash best: the exported
            # model stays, and the state export uses it
            self.model.load_state_dict(ckpt.read_state_dict(self.log_folder))
        if owner:
            writer.close()  # flush the queued writes, the best model's too
        logger.save_history()
        logger.close()
        if not val_metrics:
            # a finished run resumed: evaluate the exported weights once,
            # over the validation rows (else the training rows, masked)
            val_metrics = self._run_eval(
                val_phases() or self._make_phase_loaders(
                    dataset, train_idx, shuffle=False, wraparound=False))
        r = self.runner
        printGreen(f"Best validation loss: {best_val:.4f}; cached phases "
                   f"by the epoch runner: {r.replays} replays, "
                   f"{r.eager_steps} eager steps, {r.captures} captures; "
                   f"{self.loop_steps} steps of the per-step loop")
        return val_metrics

    def _train(self, phases, epoch: int) -> Tuple[list, int, int]:
        """One epoch's train phases: (their per-step metrics, steps,
        valid rows)."""
        store, hot_store = self._cache, self._hot_store
        acc, steps, n_images = [], 0, 0
        for loader, cached in phases:
            with self._phase(epoch, f"train {self._phase_name(cached)}") \
                    as timed:
                n0 = n_images
                if self._whole(cached):
                    with spans.span("srl.learn.stack"):
                        stacked = stack_batches(list(loader), self.cfg,
                                                store_rows(store))
                    acc.append(self.runner.train_epoch(store, stacked))
                    steps += len(stacked["valid"])
                    n_images += int(stacked["valid"].sum())
                else:
                    for batch in self._batches(loader, cached):
                        acc.append(train_step(
                            self.model, self.optimizer,
                            store if cached else None, batch,
                            self.generator, self.frozen_dae))
                        steps += 1
                        self.loop_steps += 1
                        n_images += int(batch["valid"].sum())
                        if not cached and hot_store is not None:
                            self._adopt(batch, epoch)
                timed["rows"] = n_images - n0
        return acc, steps, n_images

    def _run_eval(self, phases, epoch: int = -1) -> Dict[str, float]:
        """One masked-exact eval pass over the phases. A hybrid store's
        held slots are released once the hot phase is done, and the cold
        batches adopt their entering rows."""
        acc = []
        with spans.span("srl.learn.validate"):
            for loader, cached in phases:
                if not cached and self._hot_store is not None:
                    self._hot_store.release()
                with self._phase(epoch, f"val {self._phase_name(cached)}") \
                        as timed:
                    if self._whole(cached):
                        with spans.span("srl.learn.stack"):
                            stacked = stack_batches(
                                list(loader), self.cfg,
                                store_rows(self._cache))
                        acc.append(self.runner.eval_epoch(
                            self._cache, stacked, self._eval_corruption))
                        timed["rows"] += int(stacked["valid"].sum())
                    else:
                        for batch in self._batches(loader, cached):
                            acc.append(eval_step(
                                self.model, self._cache if cached else None,
                                batch, self._eval_corruption,
                                self.frozen_dae))
                            self.loop_steps += 1
                            timed["rows"] += int(batch["valid"].sum())
                            if not cached and self._hot_store is not None:
                                self._adopt(batch, epoch)
            with spans.span("srl.learn.metrics"):
                return mean_metrics(acc, self.cfg)

    # ---- inference / export ------------------------------------------------
    def predict_states(self, dataset: Dataset,
                       indices: Optional[np.ndarray] = None) -> np.ndarray:
        """Deterministic states of the dataset's rows ``indices`` (all rows
        when None), in that order: from the store, streamed, or from a
        hybrid store's current window and streamed."""
        encoder = StateEncoder(self.cfg, self.model.eval(), self.device)
        return predict_dataset.predict_dataset(
            encoder, dataset, self._store(dataset), self._hot_store, indices)

    @classmethod
    def load(cls, log_folder: str, device=None) -> "SRL4robotics":
        """A learner with a run folder's exported weights."""
        learner = cls(SRLConfig.load(log_folder), log_folder=log_folder,
                      device=device)
        learner.model.load_state_dict(ckpt.read_state_dict(log_folder))
        return learner
