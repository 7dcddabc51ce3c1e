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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

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
# argument types of each library's one entry point
SIGNATURES = {
    "fused_pool": ("srl_relu_max_pool_fwd",
                   [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "fused_pool_bwd": ("srl_relu_max_pool_bwd",
                       [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P]),
    "gather_norm": ("srl_gather_normalize",
                    [_P, _P, _P, _P, _L, _L, _L, _I, _F, _F, _P]),
    "knn_topk": ("srl_knn_topk",
                 [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "pairwise": ("srl_pairwise_sqdist", [_P, _P, _P, _I, _I, _I, _P]),
}

_lock = threading.Lock()
_entries: dict = {}


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


def entry(name: str):
    """The ctypes function of ``csrc/<name>.cu``, building on first use."""
    with _lock:
        if not _entries:
            for lib_name, path in build_all().items():
                fn_name, argtypes = SIGNATURES[lib_name]
                fn = getattr(ctypes.CDLL(str(path)), fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _entries[lib_name] = fn
        return _entries[name]


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelLaunchError(f"{what} launch failed with CUDA error "
                                f"{code}")
