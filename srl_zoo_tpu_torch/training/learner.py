"""The training runtime (port of ``srl_zoo_tpu/training/learner.py``
``SRL4robotics``, full device-cache mode).

``learn`` splits the dataset's transitions into train and validation rows
as the JAX learner does, uploads the frame store to the device once, and
runs the epoch loop: the train steps over index batches, train metrics
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
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from srl_zoo_tpu_torch import checkpoint as ckpt
from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.data.device_cache import build_cache
from srl_zoo_tpu_torch.data.loader import DataLoader, batch_flags
from srl_zoo_tpu_torch.data.schema import Dataset
from srl_zoo_tpu_torch.evaluation import predict_dataset
from srl_zoo_tpu_torch.inference import StateEncoder
from srl_zoo_tpu_torch.models.torch_port import load_ported_resnet18
from srl_zoo_tpu_torch.losses.registry import recompose_epoch_means
from srl_zoo_tpu_torch.training.metrics import MetricsLogger
from srl_zoo_tpu_torch.training.state import make_model, make_optimizer
from srl_zoo_tpu_torch.training.train_step import (draw_corruption,
                                                   eval_step, train_step)
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
    """Epoch means of per-step metrics, each weighted by its own per-step
    denominator (``_w/<name>``, the pair count of a pair term, else
    ``_n_valid``, the valid row count), fetched from the device in one
    transfer; ``priors`` and ``total`` are then recomposed from the exact
    component means."""
    if not metric_dicts:
        return {}

    def stacked(k):
        return torch.stack([m[k] for m in metric_dicts]).float()

    names = [k for k in metric_dicts[0] if not k.startswith("_")]
    weights = [stacked(f"_w/{k}" if f"_w/{k}" in metric_dicts[0]
                       else "_n_valid") for k in names]
    means = torch.stack([(stacked(k) * w).sum() / w.sum().clamp_min(1.0)
                         for k, w in zip(names, weights)]).cpu().tolist()
    return recompose_epoch_means(cfg, dict(zip(names, means)))


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
        cfg.check_trainable()
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
        self._cache = None
        self._cache_of = None
        self._eval_corruption = None
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

    def _store(self, dataset: Dataset) -> Dict[str, torch.Tensor]:
        """The dataset's uint8 frame store on the device (both camera views
        where the config reads the second), uploaded once. A store that
        does not fit raises (streaming is not ported)."""
        if self._cache_of is not dataset:
            self._cache = build_cache(dataset, self.device,
                                      self.cfg.needs_second_view)
            self._cache_of = dataset
            mib = sum(t.numel() for t in self._cache.values()) / 2**20
            printGreen(f"Caching dataset on {self.device} ({mib:.0f} MiB)")
        return self._cache

    # ---- training ----------------------------------------------------------
    def learn(self, dataset: Dataset, resume: bool = False,
              checkpoint_every: int = 1,
              epoch_callback: Optional[Callable] = None
              ) -> Dict[str, float]:
        """Train on the dataset's transitions; returns the final
        validation metrics. ``resume`` continues from the run folder's
        resume checkpoint, if there is one. ``epoch_callback(learner,
        epoch, train_metrics, val_metrics)`` runs after each epoch's
        checkpoints are queued."""
        cfg = self.cfg
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
        logger = MetricsLogger(self.log_folder)
        if cfg.only_random_features:
            printYellow("random features only: skipping training")
            ckpt.save_srl_model(self.log_folder, self.model)
            logger.save_history()
            logger.close()
            return {"total": 0.0}
        store = self._store(dataset)
        pairs = batch_flags(cfg)
        # the DAE's one validation draw, read by every validation pass
        self._eval_corruption = draw_corruption(
            cfg, torch.Generator(device=self.device).manual_seed(
                cfg.seed + 1), cfg.batch_size, self.device) \
            if cfg.use_dae else None
        train_loader = DataLoader(dataset, train_idx, cfg.batch_size,
                                  shuffle=True, seed=cfg.seed,
                                  wraparound=True, **pairs)
        # padded + masked, so val metrics are exact per-sample means
        val_loader = DataLoader(dataset, val_idx, cfg.batch_size,
                                shuffle=False, seed=cfg.seed,
                                wraparound=False, **pairs) \
            if len(val_idx) else None

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
        # the shuffle of epoch e is drawn from RandomState(seed + e) in a
        # resumed run too
        train_loader.epoch = start_epoch
        best = ckpt.snapshot(self.model.state_dict())
        improved = False
        val_metrics: Dict[str, float] = {}
        writer = ckpt.AsyncCheckpointer(self.log_folder, self.device)
        try:
            for epoch in range(start_epoch, cfg.epochs):
                t_epoch = time.time()
                acc, n_images = [], 0
                for batch in train_loader:
                    acc.append(train_step(self.model, self.optimizer, store,
                                          batch, self.generator,
                                          self.frozen_dae))
                    step += 1
                    n_images += int(batch["valid"].sum())
                train_metrics = mean_metrics(acc, cfg)
                ips = n_images / max(time.time() - t_epoch, 1e-9)
                val_metrics = self._run_eval(val_loader, store) \
                    if val_loader is not None else train_metrics

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
                    best = writer.save_model(self.model,
                                             self.model.state_dict())
                    improved = True
                if (epoch + 1) % max(checkpoint_every, 1) == 0 \
                        or epoch == cfg.epochs - 1:
                    writer.save_state(self.model, self.optimizer,
                                      self.generator, step, epoch + 1,
                                      best_val)
                if epoch_callback is not None:
                    epoch_callback(self, epoch, train_metrics, val_metrics)
        except BaseException:
            # flush the queued checkpoints (a crash is when the resume
            # checkpoint is needed) and keep the loss history of the epochs
            # that finished; a failed flush is reported and the original
            # error raised
            try:
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
            if not improved:
                writer.save_model(self.model, best)
        else:
            # resumed without beating the pre-crash best: the exported
            # model stays, and the state export uses it
            self.model.load_state_dict(ckpt.read_state_dict(self.log_folder))
        writer.close()  # flush the queued writes, the best model's too
        logger.save_history()
        logger.close()
        if not val_metrics:
            # a finished run resumed: evaluate the exported weights once
            loader = val_loader or DataLoader(
                dataset, train_idx, cfg.batch_size, shuffle=False,
                seed=cfg.seed, wraparound=False, **pairs)
            val_metrics = self._run_eval(loader, store)
        printGreen(f"Best validation loss: {best_val:.4f}")
        return val_metrics

    def _run_eval(self, loader: DataLoader, store: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
        """One masked-exact eval pass."""
        return mean_metrics([eval_step(self.model, store, batch,
                                       self._eval_corruption,
                                       self.frozen_dae)
                             for batch in loader], self.cfg)

    # ---- inference / export ------------------------------------------------
    def predict_states(self, dataset: Dataset,
                       indices: Optional[np.ndarray] = None) -> np.ndarray:
        """Deterministic states of the dataset's rows ``indices`` (all rows
        when None), in that order."""
        encoder = StateEncoder(self.cfg, self.model.eval(), self.device)
        return predict_dataset.predict_states(encoder, self._store(dataset),
                                              indices)

    @classmethod
    def load(cls, log_folder: str, device=None) -> "SRL4robotics":
        """A learner with a run folder's exported weights."""
        learner = cls(SRLConfig.load(log_folder), log_folder=log_folder,
                      device=device)
        learner.model.load_state_dict(ckpt.read_state_dict(log_folder))
        return learner
