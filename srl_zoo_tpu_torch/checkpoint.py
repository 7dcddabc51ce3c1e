"""Run-folder checkpoints (port of ``srl_zoo_tpu/training/checkpoint.py``).

* The trained-model contract: ``srl_model.pth`` (the ``torch.save`` of the
  SRLModules state dict, the reference's file name) beside
  ``exp_config.json``. ``save_srl_model`` / ``load_srl_model``.
* Full-state resume checkpoints: ``checkpoints/state_latest.pth`` holds the
  model, the optimizer (each Adam's state and, in the middle of a
  ``--grad-accum`` cycle, the micro-step count and the accumulated
  gradients: training/state.py ``AccumulatingAdam``), the state of the
  generator that draws the VAE's noise and the DAE's corruption, the
  step, the epochs completed and the best validation loss so far, and
  ``checkpoints/meta.json`` the last three, so that ``--resume`` continues
  a run where it stopped.
* ``AsyncCheckpointer``, the learner's writer of both: a call takes an
  on-device snapshot and returns; one worker thread copies the snapshot
  to the host and writes it.

Every write goes to a temporary file that then replaces the target, so a
reader (a server, a resumed run) never sees a torn file.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Dict, Optional, Tuple

import torch

from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.models.srl_modules import SRLModules
from srl_zoo_tpu_torch.utils.spans import span

MODEL_FILE = "srl_model.pth"
RESUME_DIR = "checkpoints"
STATE_FILE = "state_latest.pth"
FLUSH_TIMEOUT_S = 600.0  # AsyncCheckpointer.close()'s wait for its worker


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def write_state_dict(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    _atomic_save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def save_srl_model(log_folder: str, model: SRLModules,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None
                   ) -> str:
    """exp_config.json and srl_model.pth of ``model`` (or of the given
    state dict of a model of the same config)."""
    os.makedirs(log_folder, exist_ok=True)
    model.cfg.save(log_folder)
    path = os.path.join(log_folder, MODEL_FILE)
    write_state_dict(path, model.state_dict() if state_dict is None
                     else state_dict)
    return path


def read_state_dict(log_folder: str) -> Dict[str, torch.Tensor]:
    """The run's ``srl_model.pth``; a JAX run folder (``srl_model.msgpack``
    alone) raises with the command that converts it."""
    path = os.path.join(log_folder, MODEL_FILE)
    if not os.path.exists(path) and os.path.exists(
            os.path.join(log_folder, "srl_model.msgpack")):
        raise FileNotFoundError(
            f"{log_folder} holds a JAX run (srl_model.msgpack, no "
            f"{MODEL_FILE}); convert it first: python -m "
            f"srl_zoo_tpu_torch.bridge --log-folder {log_folder}")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_srl_model(log_folder: str, device: torch.device
                   ) -> Tuple[SRLConfig, SRLModules]:
    """Rebuild the model from exp_config.json and load its weights, in eval
    mode on ``device`` with channels_last activations."""
    cfg = SRLConfig.load(log_folder)
    model = SRLModules(cfg)
    model.load_state_dict(read_state_dict(log_folder))
    model = model.to(device=device, memory_format=torch.channels_last)
    return cfg, model.eval()


def snapshot(obj):
    """A copy of every tensor in a nested dict, list or tuple, on the
    tensor's own device (other leaves as they are). On a CUDA device the
    clones are queued on the current stream and nothing waits for them."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(snapshot(v) for v in obj)
    return obj


def _to_host(obj):
    """``snapshot``'s structure with every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def write_train_state(log_folder: str, state: dict, step: int, epoch: int,
                      best_val: float) -> str:
    """The resume checkpoint after ``epoch`` completed epochs: ``state``
    holds the model's state dict (``"model"``), the optimizer's
    (``"optimizer"``) and the generator's state (``"generator"``)."""
    ckpt_dir = os.path.join(log_folder, RESUME_DIR)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, STATE_FILE)
    _atomic_save(_to_host(state) | {"step": int(step), "epoch": int(epoch),
                                    "best_val": float(best_val)}, path)
    meta = {"step": int(step), "epoch": int(epoch)}
    if best_val != float("inf"):
        meta["best_val"] = float(best_val)
    meta_path = os.path.join(ckpt_dir, "meta.json")
    with open(meta_path + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(meta_path + ".tmp", meta_path)
    return path


def load_meta(log_folder: str) -> dict:
    path = os.path.join(log_folder, RESUME_DIR, "meta.json")
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return {}  # a torn meta must not break crash recovery


def restore_train_state(log_folder: str, model: torch.nn.Module,
                        optimizer, generator: torch.Generator
                        ) -> Optional[dict]:
    """Load the resume checkpoint into ``model``, ``optimizer`` and
    ``generator`` (a checkpoint written before the generator was kept
    leaves it at its seed); returns
    {"step", "epoch", "best_val"}, or None when there is nothing to
    resume."""
    path = os.path.join(log_folder, RESUME_DIR, STATE_FILE)
    if not os.path.exists(path):
        return None
    dev = next(model.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    try:
        model.load_state_dict(ckpt["model"])
        optimizer.load_state_dict(ckpt["optimizer"])
        if "generator" in ckpt:
            # a generator's state is a CPU byte tensor on every device
            generator.set_state(ckpt["generator"].cpu())
    except (RuntimeError, ValueError, KeyError) as e:
        raise ValueError(
            f"Resume checkpoint in {log_folder} does not match the current "
            "model and optimizer. --resume requires the SAME model and "
            "optimizer flags as the original run (--model-type, --losses, "
            f"--state-dim, ...); underlying error: {type(e).__name__}: {e}"
        ) from e
    return {k: ckpt[k] for k in ("step", "epoch", "best_val")}


class AsyncCheckpointer:
    """Background writer of the resume checkpoint and the best-model
    export (port of ``srl_zoo_tpu/training/checkpoint.py``
    ``AsyncCheckpointer``).

    ``save_state`` and ``save_model`` take an on-device snapshot (tensor
    clones queued on the device) and return (the span
    ``srl.checkpoint.submit``, utils/spans.py); one worker thread keeps the
    newest job of each kind, copies its snapshot to the host and writes
    it. The main thread never waits for the device here.

    The worker's copies run on the device's default stream, the stream the
    clones were queued on, so stream order puts them after the clones and
    the caching allocator reuses the snapshot's memory only once the copy
    that reads it is done. A side stream would let the copies overlap the
    training kernels, but it needs an event per snapshot and
    ``record_stream`` on every tensor, for a copy of a few to a few
    hundred MB once per epoch.

    ``close()`` flushes what is queued, re-raises a writer's error and
    raises if the worker has not finished within ``FLUSH_TIMEOUT_S``; a
    submit after ``close()`` raises.
    """

    def __init__(self, log_folder: str, device: torch.device):
        self.log_folder = log_folder
        self.device = device
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._jobs: dict = {}
        self._stop = False
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="srl-ckpt-writer")
        self._thread.start()

    def _run(self) -> None:
        # the worker's current device is the learner's, so its copies go
        # to that device's default stream
        with torch.cuda.device(self.device) if self.device.type == "cuda" \
                else contextlib.nullcontext():
            while True:
                self._event.wait()
                with self._lock:
                    jobs, self._jobs = self._jobs, {}
                    stop = self._stop
                    self._event.clear()
                for kind, payload in jobs.items():
                    try:
                        if kind == "state":
                            write_train_state(self.log_folder, *payload)
                        else:
                            cfg, state_dict = payload
                            os.makedirs(self.log_folder, exist_ok=True)
                            cfg.save(self.log_folder)
                            write_state_dict(os.path.join(
                                self.log_folder, MODEL_FILE), state_dict)
                    except BaseException as e:  # raised again by close()
                        self._err = e
                if stop:
                    with self._lock:
                        if not self._jobs:
                            return
                    self._event.set()  # late arrivals before the exit

    def _submit(self, kind: str, payload) -> None:
        if self._err is not None:
            raise RuntimeError(f"checkpoint writer failed: "
                               f"{self._err!r}") from self._err
        with self._lock:
            if self._stop:
                # the worker may be gone: the job would never be written
                raise RuntimeError("checkpoint writer already closed")
            self._jobs[kind] = payload
        self._event.set()

    def save_state(self, model: torch.nn.Module, optimizer,
                   generator: torch.Generator, step: int, epoch: int,
                   best_val: float) -> None:
        """Queue the resume checkpoint after ``epoch`` completed epochs
        (``optimizer``: training/state.py ``AccumulatingAdam``)."""
        with span("srl.checkpoint.submit"):
            self._submit("state", (
                {"model": snapshot(model.state_dict()),
                 "optimizer": snapshot(optimizer.state_dict()),
                 "generator": generator.get_state()},
                step, epoch, best_val))

    def save_model(self, model: SRLModules,
                   state_dict: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """Queue ``srl_model.pth`` (``state_dict`` of a model of
        ``model``'s config) and ``exp_config.json``; returns the queued
        snapshot, which the caller may keep but must not change."""
        with span("srl.checkpoint.submit"):
            snap = snapshot(state_dict)
            self._submit("model", (model.cfg, snap))
        return snap

    def close(self) -> None:
        with self._lock:
            self._stop = True
        self._event.set()
        self._thread.join(timeout=FLUSH_TIMEOUT_S)
        if self._thread.is_alive():
            # a hung write must not pass for a flush: the files are stale
            raise RuntimeError(f"checkpoint writer did not flush within "
                               f"{FLUSH_TIMEOUT_S:.0f} s")
        if self._err is not None:
            raise RuntimeError(f"checkpoint writer failed: "
                               f"{self._err!r}") from self._err
