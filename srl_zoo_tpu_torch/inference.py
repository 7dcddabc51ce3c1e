"""Inference API: encode observations with a trained SRL model.

Port of ``srl_zoo_tpu/inference.py`` ``StateEncoder``, the hand-off surface
that downstream RL calls per observation:

    enc = StateEncoder.load("logs/<run>")      # on the GPU
    state = enc.encode(obs)                    # (H, W, C) or (B, H, W, C) uint8

Each chunk of at most ``max_batch`` rows is uploaded as uint8 and
normalized on the device by the gather kernel (identity index), then
encoded. A run whose encoder stacks both camera views takes (H, W, 6)
observations, view 1's channels first; the chunk goes through the kernel
as one upload of 6-channel frames, on its vector path where a frame is a
whole number of 4-byte groups (224 x 224 x 6 is).

On a CUDA device, with the model in eval mode, a chunk is one replay of a
captured CUDA graph. The host copies the rows into a static pinned
buffer; the graph copies them up (non-blocking), runs the gather kernel
over a static identity index (``gather_normalize_device``) and the
model's encode, and copies the states down into a static pinned buffer;
the host waits once, on an event recorded on the current stream of the
encoder's device (where the replay runs, whatever the calling thread's
current device), and copies the rows out into a fresh array, so a
call's states are its own. A graph's shapes are fixed, so
each chunk row count has its own graph, captured at the first chunk of
that many rows after one eager warm-up of the same work on the encoder's
side stream (the kernels' build, cuDNN's lazy set-up); nothing is
padded. At most ``max_batch`` graphs exist; they share one memory pool,
and the static buffers are those of ``max_batch`` rows, each graph using
its leading rows. The graphs read the model's parameters and buffers
where they lie, so weights loaded in place are seen. A lock guards the
static buffers: concurrent calls run their chunks in turn. The kernels'
launch counters count a replay's launches once a replay (ops/_build.py).
On the CPU, and for a model in training mode, each chunk is dispatched
eagerly, op by op. ``counts()`` says how many chunks took each route.

A call is the span ``srl.encode`` (utils/spans.py), tiled by its host
stages: ``srl.encode.upload`` (the checks and the staging: into the
pinned buffer, or on the eager route the upload), ``srl.encode.launch``
(the replay, with ``srl.encode.replay`` inside it, or the gather kernel
and the model's forward queued eagerly; a chunk's warm-up and capture
too) and ``srl.encode.readback`` (the wait for the states, their copy
out and their concatenation).
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch

from srl_zoo_tpu_torch import checkpoint as ckpt
from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.models.srl_modules import SRLModules
from srl_zoo_tpu_torch.ops import _build
from srl_zoo_tpu_torch.ops.gather_norm import (gather_normalize,
                                               gather_normalize_device)
from srl_zoo_tpu_torch.utils.device import resolve_device, use_strict_float32
from srl_zoo_tpu_torch.utils.spans import span

class StateEncoder:
    """Deterministic obs -> state encoder around a trained model."""

    def __init__(self, cfg: SRLConfig, model: SRLModules,
                 device: torch.device, max_batch: int = 32):
        self.cfg = cfg
        self.model = model
        self.device = device
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._graphs: Dict[int, tuple] = {}  # rows -> (graph, LaunchTally)
        self._static = None  # host_in, dev_in, idx, host_out
        self._stream = self._pool = self._done = None
        self.replays = self.captures = self.eager_chunks = 0

    @classmethod
    def load(cls, log_folder: str, max_batch: int = 32,
             device=None) -> "StateEncoder":
        device = resolve_device(device)
        use_strict_float32()
        cfg, model = ckpt.load_srl_model(log_folder, device)
        return cls(cfg, model, device, max_batch)

    def encode(self, obs: np.ndarray) -> np.ndarray:
        """uint8 (H, W, C) or (B, H, W, C) -> float32 (state_dim,) or
        (B, state_dim)."""
        with span("srl.encode"), torch.inference_mode():
            with span("srl.encode.upload"):
                obs = np.asarray(obs, np.uint8)
                single = obs.ndim == 3
                if single:
                    obs = obs[None]
                expected = self.cfg.img_shape
                if obs.ndim != 4 or obs.shape[1:] != expected:
                    raise ValueError(
                        f"expected uint8 observations of shape {expected} "
                        f"(or batched (B, *{expected})), got {obs.shape}")
                if len(obs) == 0:
                    return np.zeros((0, self.cfg.state_dim), np.float32)
            chunk = self._eager_chunk
            if self.device.type == "cuda" and not self.model.training:
                chunk = self._replayed_chunk
            out = [chunk(obs[start:start + self.max_batch])
                   for start in range(0, len(obs), self.max_batch)]
            with span("srl.encode.readback"):
                states = out[0] if len(out) == 1 else np.concatenate(out)
                states = states.astype(np.float32, copy=False)
                return states[0] if single else states

    def counts(self) -> Dict[str, int]:
        """The chunks replayed, the graphs captured and the chunks
        dispatched eagerly."""
        return {"replays": self.replays, "captures": self.captures,
                "eager_chunks": self.eager_chunks}

    # ---- the eager route ---------------------------------------------------
    def _eager_chunk(self, obs: np.ndarray) -> np.ndarray:
        """One chunk dispatched op by op; its states on the host."""
        with span("srl.encode.upload"):
            chunk = torch.from_numpy(np.require(
                obs, requirements="CW")).to(self.device)
        with span("srl.encode.launch"):
            ident = np.arange(len(chunk))
            x = gather_normalize(chunk, ident, self.cfg.normalize_mode)
            states = self.model.encode(x)
        with span("srl.encode.readback"):
            states = states.cpu().numpy()
        with self._lock:
            self.eager_chunks += 1
        return states

    # ---- the graph route ---------------------------------------------------
    def _replayed_chunk(self, obs: np.ndarray) -> np.ndarray:
        """One chunk as one replay of its row count's graph (captured
        here at the first such chunk); its states in a fresh array."""
        rows = len(obs)
        with self._lock:
            with span("srl.encode.upload"):
                if self._static is None:
                    self._allocate()
                host_in, _, _, host_out = self._static
                # one thread's copy: torch's, spread over the intra-op
                # threads, took a seventh of its median on the H100's
                # host when hot, but five times its p95 after 2 ms of
                # other work (the threads' wake-up)
                np.copyto(host_in.numpy()[:rows], obs)
            with span("srl.encode.launch"):
                if rows not in self._graphs:
                    self._warm_and_capture(rows)
                graph, tally = self._graphs[rows]
                with span("srl.encode.replay"):
                    # the replay runs on the current stream of the
                    # encoder's device, which need not be the thread's
                    graph.replay()
                    self._done.record(torch.cuda.current_stream(
                        self.device))
                    tally.replayed()
                    self.replays += 1
            with span("srl.encode.readback"):
                self._done.synchronize()
                return host_out[:rows].numpy().copy()

    def _allocate(self) -> None:
        """The static buffers of ``max_batch`` rows (pinned on the host),
        and the side stream, the completion event and the graphs' memory
        pool."""
        shape = (self.max_batch,) + tuple(self.cfg.img_shape)
        host_in = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
        dev_in = torch.empty(shape, dtype=torch.uint8, device=self.device)
        idx = torch.arange(self.max_batch, device=self.device)
        host_out = torch.empty((self.max_batch, self.cfg.state_dim),
                               dtype=torch.float32, pin_memory=True)
        self._static = (host_in, dev_in, idx, host_out)
        self._stream = torch.cuda.Stream(self.device)
        self._done = torch.cuda.Event()
        self._pool = torch.cuda.graph_pool_handle()

    def _warm_and_capture(self, rows: int) -> None:
        """The graph of ``rows``-row chunks: its work run once eagerly
        (on the side stream, ordered after the current stream's work and
        before its next), then captured into the shared pool."""
        host_in, dev_in, idx, host_out = self._static
        mode = self.cfg.normalize_mode

        def body():
            dev_in[:rows].copy_(host_in[:rows], non_blocking=True)
            x = gather_normalize_device(dev_in[:rows], idx[:rows], mode)
            host_out[:rows].copy_(self.model.encode(x), non_blocking=True)
        _build.run_on(self._stream, body)
        self._graphs[rows] = _build.capture(body, self._stream, self._pool)
        self.captures += 1
