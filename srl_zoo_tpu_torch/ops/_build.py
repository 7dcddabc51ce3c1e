"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/srl_zoo_tpu_torch/lib<name>_<hash>.so`` at the repository
root (the hash covers the source and the flags, so an edited source
rebuilds). Nothing is built when the package is imported: the first kernel
launch builds every source, all nvcc processes started together, and a
failed build raises. A kernel is only ever built and run on a machine with
an NVIDIA GPU and the CUDA toolkit.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a nonzero code into an exception.

Each wrapper counts its launches on attributes of its own function
(``launches``, and beside it ``vector_launches`` or ``bf16_launches``)
through :func:`count`. A launch made while a CUDA graph is captured runs
only when the graph is replayed, so inside :func:`tally_launches` the
counts go to the capture's :class:`LaunchTally` instead, and
``LaunchTally.replayed(n)`` adds the captured counts n times: the
counters count what ran. :func:`capture` records a CUDA graph inside its
own tally, and :func:`run_on` runs its work once eagerly beforehand, on
the capture stream: the epoch runner's steps and the state encoder's
chunks are captured through both.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "srl_zoo_tpu_torch"
SOURCES = ("fused_pool", "fused_pool_bwd", "gather_norm", "knn_topk",
           "pairwise")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.POINTER(ctypes.c_float)
# the entry points of each library and their argument types; the first is
# the library's kernel launch
SIGNATURES = {
    "fused_pool": {"srl_relu_max_pool_fwd":
                   [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]},
    "fused_pool_bwd": {"srl_relu_max_pool_bwd":
                       [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P]},
    "gather_norm": {"srl_gather_normalize":
                    [_P, _P, _P, _L, _L, _L, _I, _F, _F, _I, _I, _P]},
    "knn_topk": {"srl_knn_topk":
                 [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                 "srl_knn_blocks_per_sm": [_I, _I]},
    "pairwise": {"srl_pairwise_sqdist": [_P, _P, _P, _I, _I, _I, _P]},
}

_lock = threading.Lock()
_entries: dict = {}
# the tallies of the captures under way, innermost last: a capture's
# backward launches from the autograd engine's device thread, so the
# stack is the process's, not a thread's
_tallies: list = []


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Compile every source that has no up-to-date library, in parallel.

    Returns {name: library path}. Raises KernelBuildError with nvcc's output
    when a compile fails."""
    targets = {name: _target(name) for name in SOURCES}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, target in todo.items():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, target)
        failed = []
        for name, (proc, tmp, target) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, target)  # atomic: no reader sees half a file
        if failed:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return targets


def entry(name: str, fn_name: str | None = None):
    """The ctypes function ``fn_name`` (default: the kernel launch) of
    ``csrc/<name>.cu``, building every library on first use; later calls
    skip the lock."""
    key = (name, fn_name or next(iter(SIGNATURES[name])))
    fn = _entries.get(key)
    if fn is not None:
        return fn
    with _lock:
        if not _entries:
            for lib_name, path in build_all().items():
                lib = ctypes.CDLL(str(path))
                for fname, argtypes in SIGNATURES[lib_name].items():
                    f = getattr(lib, fname)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                    _entries[(lib_name, fname)] = f
        return _entries[key]


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device (grids are sized to it)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def launch(fn, t, *args) -> int:
    """Call a kernel entry point on tensor ``t``'s device and its current
    stream (the last argument); only a tensor on another device than the
    current one pays for switching devices."""
    if t.get_device() == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(t.device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelLaunchError(f"{what} launch failed with CUDA error "
                                f"{code}")


class LaunchTally:
    """The counts of the launches captured into a CUDA graph, by wrapper
    and counter: {(function, attribute): amount}."""

    def __init__(self):
        self.counts: dict = {}

    def replayed(self, times: int = 1) -> None:
        """Add the captured counts ``times`` times to the wrappers'
        counters: the graph ran ``times`` times."""
        for (fn, attr), n in self.counts.items():
            setattr(fn, attr, getattr(fn, attr) + n * times)


@contextlib.contextmanager
def tally_launches():
    """Count the launches made until the block ends, in any thread, into a
    new :class:`LaunchTally` (yielded) instead of the wrappers' counters:
    the launches of a graph capture."""
    tally = LaunchTally()
    with _lock:
        _tallies.append(tally)
    try:
        yield tally
    finally:
        with _lock:
            _tallies.remove(tally)


def count(fn, **amounts) -> None:
    """Add each of ``amounts`` to the counter attribute of the wrapper
    ``fn`` it names (``launches=1``, ``vector_launches=...``), or to the
    innermost capture's tally inside :func:`tally_launches`."""
    with _lock:
        counts = _tallies[-1].counts if _tallies else None
        for attr, n in amounts.items():
            if counts is None:
                setattr(fn, attr, getattr(fn, attr) + int(n))
            else:
                counts[(fn, attr)] = counts.get((fn, attr), 0) + int(n)


def run_on(stream: torch.cuda.Stream, body) -> None:
    """Run ``body`` eagerly on the side ``stream``: after the work queued
    on the current stream of the stream's device, and before the work
    queued there next (the warm-up before a :func:`capture` on it)."""
    main = torch.cuda.current_stream(stream.device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        body()
    main.wait_stream(stream)


def capture(body, stream: torch.cuda.Stream, pool=None, generators=()):
    """A CUDA graph of ``body``'s device work (recorded, not run), captured
    on ``stream``, into the memory pool ``pool`` where one is given, with
    the state of each of ``generators`` registered with it; and the
    :class:`LaunchTally` of the launches it holds. A failed capture
    raises."""
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    with tally_launches() as tally, torch.cuda.graph(
            graph, pool=pool, stream=stream,
            capture_error_mode="thread_local"):
        body()
    return graph, tally
