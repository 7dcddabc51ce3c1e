"""The whole-epoch runner of the cached phases (port of
``srl_zoo_tpu/training/train_step.py`` ``train_epoch`` / ``eval_epoch``).

The JAX package runs a cached phase (the whole resident store, a hybrid
store's hot phase) as one jitted ``lax.scan`` over the phase's index
batches, stacked on the host: one device program per phase, and the
phase's host traffic one upload of a few KB of indices. Here a phase's
batches are stacked the same way (training/learner.py ``stack_batches``:
(n_steps, B, ...) arrays of ``train_step.step_keys``, every index
range-checked there, once) and go up in one pinned non-blocking copy a
key into static device buffers. A device step counter picks each step's
row of them: the step (``train_step.cached_train_step``,
``cached_eval_step``) gathers its frames by that device index (K2's
device-index form), computes its metrics into a per-phase device buffer
at the counter's column and counts the counter on.

On a CUDA device each kind of step is captured once into a
``torch.cuda.CUDAGraph``, and a step is then one replay: the host selects
nothing, uploads nothing and waits for nothing. The kinds: the eval step;
the train step that steps the Adams; and, with ``--grad-accum k``, the
train step that only accumulates its gradient, the optimizer's host count
choosing which graph a micro-step replays. The capture needs a warm-up
(the kernels' build, cuDNN's and cuBLAS's lazy set-up, Adam's state): the
steps run eagerly on the capture stream, as real steps of the phase,
until each kind the phase needs ran once; then every kind is captured
(the capture runs nothing) and the later steps replay. So no step runs
twice and none is skipped, and BatchNorm's running statistics and the
generator's offset move once a step. The learner's ``torch.Generator`` is
registered with each train graph, so that replay i draws what eager step
i draws (the VAE's eps, the DAE's corruption). A capture that fails raises: nothing
drops back to the eager loop. The graphs read the store, the parameters,
the gradients, the optimizer state and the buffers at fixed addresses:
the hybrid store adopts rows in place (data/hybrid.py), Adam and the
gradients' clearing write in place (training/state.py), and a phase with
more steps than the buffers hold, another store or other shapes makes new
buffers and new graphs. The kernels' launch counters count what ran: a
graph's captured launches once for each replay (ops/_build.py).

On the CPU the same steps run eagerly, from the same buffers and counter:
the plain form the tests hold against the JAX package's ``train_epoch``
and ``eval_epoch`` and against the per-step loop.

JAX pads the step axis to a bucket (to reuse compiled programs) and skips
the padded steps; here only the real steps run, which is the same
function.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from srl_zoo_tpu_torch.ops import _build
from srl_zoo_tpu_torch.training.train_step import (cached_eval_step,
                                                   cached_train_step,
                                                   step_keys)
from srl_zoo_tpu_torch.utils.spans import span

# the kinds of step, and which a phase needs
EVAL, STEP, ACCUMULATE = "eval", "step", "accumulate"


def _store_key(store) -> tuple:
    """The addresses and shapes of a store's tensors (a whole or hybrid
    store's dict, or a sharded store's views)."""
    views = getattr(store, "views", store)
    return tuple((k, v.data_ptr(), tuple(v.shape))
                 for k, v in sorted(views.items()))


class _Program:
    """One mode's (train or eval) static buffers, counter, metrics buffer
    and graphs, for one store and one set of step shapes."""

    def __init__(self, key, keys: Dict[str, torch.dtype], shapes: Dict,
                 capacity: int, device: torch.device):
        self.key = key
        self.device = device
        self.counter = torch.zeros(1, dtype=torch.int64, device=device)
        self.bufs = {k: torch.empty((capacity,) + shapes[k], dtype=dt,
                                    device=device)
                     for k, dt in keys.items()}
        self.names = None  # the metrics' names, in the buffer's order
        self.metrics = None  # (n_metrics, capacity) float32
        self.graphs: Dict[str, tuple] = {}  # kind -> (graph, LaunchTally)
        self.warm = set()  # the kinds that ran once eagerly

    @property
    def capacity(self) -> int:
        return next(iter(self.bufs.values())).shape[0]

    def grow(self, n: int) -> None:
        """Buffers for ``n`` steps, and no graph (they read the old
        ones)."""
        cap = max(n, self.capacity + self.capacity // 4)
        self.bufs = {k: torch.empty((cap,) + tuple(b.shape[1:]),
                                    dtype=b.dtype, device=self.device)
                     for k, b in self.bufs.items()}
        if self.metrics is not None:
            self.metrics = torch.zeros((len(self.names), cap),
                                       dtype=torch.float32,
                                       device=self.device)
        self.graphs = {}

    def load(self, stacked: Dict[str, np.ndarray]) -> int:
        """The phase's stacked arrays into the buffers, one copy a key
        (pinned and non-blocking to a CUDA device), and the counter to
        step 0; returns the step count."""
        n = len(stacked["valid"])
        with span("srl.runner.load"):
            if n > self.capacity:
                self.grow(n)
            for k, buf in self.bufs.items():
                src = torch.from_numpy(np.ascontiguousarray(stacked[k])).to(
                    buf.dtype)
                if self.device.type == "cuda":
                    buf[:n].copy_(src.pin_memory(), non_blocking=True)
                else:
                    buf[:n].copy_(src)
            self.counter.zero_()
        return n

    def inputs(self) -> Dict[str, torch.Tensor]:
        """The current step's row of each buffer, read through the device
        counter."""
        return {k: b.index_select(0, self.counter)[0]
                for k, b in self.bufs.items()}

    def record(self, metrics: Dict[str, torch.Tensor]) -> None:
        """The step's metrics into the metrics buffer's counter column,
        and the counter on by one."""
        if self.names is None:
            self.names = list(metrics)
            self.metrics = torch.zeros((len(self.names), self.capacity),
                                       dtype=torch.float32,
                                       device=self.device)
        vals = torch.stack([metrics[k].float() for k in self.names])
        self.metrics.index_copy_(1, self.counter, vals[:, None])
        self.counter.add_(1)

    def results(self, n: int) -> Dict[str, torch.Tensor]:
        """The phase's per-step metrics, (n,) each, copied out of the
        buffer that the next phase overwrites."""
        out = self.metrics[:, :n].clone()
        return {k: out[j] for j, k in enumerate(self.names)}


class EpochRunner:
    """Runs a learner's cached phases whole: ``train_epoch`` and
    ``eval_epoch``. Counts the steps it ran eagerly (``eager_steps``),
    its replays (``replays``) and its captures (``captures``)."""

    def __init__(self, model, optimizer, generator: torch.Generator,
                 frozen_dae=None):
        self.model = model
        self.optimizer = optimizer
        self.generator = generator
        self.frozen_dae = frozen_dae
        self.device = next(model.parameters()).device
        self.on_cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.on_cuda \
            else None
        self.programs: Dict[str, _Program] = {}
        self.eager_steps = 0
        self.replays = 0
        self.captures = 0

    # ---- the two entry points ----------------------------------------------
    def train_epoch(self, store, stacked: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
        """Train over a cached phase's stacked batches; returns the
        per-step metrics, (n_steps,) on the device."""
        every = self.optimizer.every
        needed = (ACCUMULATE, STEP) if every > 1 else (STEP,)
        prog = self._program("train", store, stacked, None)
        n = prog.load(stacked)
        # the optimizer's host count picks each micro-step's kind
        kinds = [STEP if self.optimizer.advance() else ACCUMULATE
                 for _ in range(n)]

        def body(kind):
            prog.record(cached_train_step(
                self.model, self.optimizer, store, prog.inputs(),
                self.generator, self.frozen_dae, apply=kind == STEP))
        self._run(prog, body, kinds, needed)
        return prog.results(n)

    def eval_epoch(self, store, stacked: Dict[str, np.ndarray],
                   corruption=None) -> Dict[str, torch.Tensor]:
        """Evaluate a cached phase's stacked batches (a DAE's with the
        run's validation draw ``corruption``); returns the per-step
        metrics, (n_steps,) on the device."""
        prog = self._program("eval", store, stacked, corruption)
        n = prog.load(stacked)

        def body(_):
            prog.record(cached_eval_step(self.model, store, prog.inputs(),
                                         corruption, self.frozen_dae))
        self._run(prog, body, [EVAL] * n, (EVAL,))
        return prog.results(n)

    # ---- programs, capture and replay --------------------------------------
    def _program(self, mode: str, store, stacked, corruption) -> _Program:
        """The mode's program for this store and these step shapes (a new
        one where either changed)."""
        keys = step_keys(self.model.cfg)
        shapes = {k: tuple(np.shape(stacked[k])[1:]) for k in keys}
        ptr = None
        if isinstance(corruption, torch.Tensor):
            ptr = corruption.data_ptr()
        elif corruption is not None:
            ptr = tuple(t.data_ptr() for t in corruption)
        key = (_store_key(store), tuple(sorted(shapes.items())), ptr)
        prog = self.programs.get(mode)
        if prog is None or prog.key != key:
            prog = _Program(key, keys, shapes, len(stacked["valid"]),
                            self.device)
            self.programs[mode] = prog
        return prog

    def _run(self, prog: _Program, body, kinds, needed) -> None:
        """Each step of ``kinds``. Until every kind of ``needed`` ran once
        in the program, and while the program has no graphs, the steps
        warm it (``srl.runner.warm``): on a CUDA device eagerly on the
        capture stream. Then on the CPU the rest run eagerly; on a CUDA
        device the kinds are captured, and each later step is a replay
        (``srl.runner.replay``, one span for the phase's replays)."""
        i = 0
        while i < len(kinds) and kinds[i] not in prog.graphs \
                and not prog.warm.issuperset(needed):
            with span("srl.runner.warm"):
                self._eager(body, kinds[i])
            prog.warm.add(kinds[i])
            i += 1
        rest = kinds[i:]
        if not self.on_cuda:
            for kind in rest:
                body(kind)
            self.eager_steps += len(rest)
            return
        if rest and rest[0] not in prog.graphs:
            self._capture(prog, body, needed)
        replays = dict.fromkeys(needed, 0)
        try:
            with span("srl.runner.replay"):
                for kind in rest:
                    prog.graphs[kind][0].replay()
                    replays[kind] += 1
        finally:
            for kind, n in replays.items():
                if n:
                    prog.graphs[kind][1].replayed(n)
            self.replays += sum(replays.values())

    def _eager(self, body, kind) -> None:
        """One step run eagerly: on a CUDA device on the capture stream,
        ordered after the main stream's work and before its next."""
        self.eager_steps += 1
        if not self.on_cuda:
            body(kind)
            return
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            body(kind)
        main.wait_stream(self.stream)

    def _capture(self, prog: _Program, body, kinds) -> None:
        """One graph of each of ``kinds``, on the capture stream; the
        train graphs draw from the learner's generator. The capture runs
        nothing: the counter, the statistics and the generator stay."""
        with span("srl.runner.capture"):
            for kind in kinds:
                graph = torch.cuda.CUDAGraph()
                if kind != EVAL:
                    graph.register_generator_state(self.generator)
                with _build.tally_launches() as tally, torch.cuda.graph(
                        graph, stream=self.stream,
                        capture_error_mode="thread_local"):
                    body(kind)
                prog.graphs[kind] = (graph, tally)
                self.captures += 1

    def counts(self) -> Dict[str, int]:
        return {"eager_steps": self.eager_steps, "replays": self.replays,
                "captures": self.captures}

