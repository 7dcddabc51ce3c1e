"""ctypes binding of the port's native host runtime (``srlhost.cpp`` beside
this file): batched frame gather, bilinear resize and threaded JPEG decode,
one C call per batch.

The library is built with g++ on first use into
``build/srl_zoo_tpu_torch/libsrlhost_<hash>.so`` at the repository root
(the hash covers the source and the flags, so an edited source rebuilds);
it needs g++, and libjpeg's headers (``jpeglib.h``) for the JPEG decoder.
Each process links to a temporary file of its own and renames it into
place, so processes that build at once never load half a file. Where the
build with libjpeg fails, the compiler's output is printed once to stderr
and the library is built again without the decoder
(``-DSRLHOST_NO_JPEG``): ``has_jpeg`` is then False and
``decode_jpeg_batch`` raises, so that the loader decodes with cv2. Where
g++ fails too, every entry point falls back: the gather to numpy, the
resize to cv2's bilinear filter.

``counts`` records which route served each call, as images handled:
``gather_native`` / ``gather_numpy``, ``resize_native`` / ``resize_cv2``,
``jpeg_native`` / ``jpeg_cv2`` (the last counted by the loader's cv2
decode, data/loader.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "srlhost.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "srl_zoo_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
# (extra flags, libraries) of the two builds, the first that builds is used
VARIANTS = (((), ("-ljpeg", "-lpthread")),
            (("-DSRLHOST_NO_JPEG",), ("-lpthread",)))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False
build_error: Optional[str] = None  # the compiler's output of a failed build
has_jpeg = False  # whether the loaded library has the JPEG decoder

counts = {"gather_native": 0, "gather_numpy": 0, "resize_native": 0,
          "resize_cv2": 0, "jpeg_native": 0, "jpeg_cv2": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _target(flags, libs) -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + flags + libs).encode())
    return BUILD_DIR / f"libsrlhost_{h.hexdigest()[:12]}.so"


def _build(target: Path, flags, libs) -> None:
    """Compile the source into ``target``; raises RuntimeError with the
    compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, *flags, "-o", str(tmp),
                               str(SRC), *libs], capture_output=True,
                              text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as err:
        raise RuntimeError(f"g++ could not run: {err}") from err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(proc.stdout + proc.stderr)
    os.replace(tmp, target)  # atomic: no process loads half a file


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None when it cannot be built
    or loaded (the reason is in ``build_error``, printed once)."""
    global _lib, _failed, build_error, has_jpeg
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        lib, errors = None, []
        for flags, libs in VARIANTS:
            target = _target(flags, libs)
            try:
                if not target.exists():
                    _build(target, flags, libs)
                lib = ctypes.CDLL(str(target))
                break
            except (RuntimeError, OSError) as err:  # g++'s or dlopen's
                errors.append(f"g++ {' '.join(flags + libs)}:\n{err}")
        if errors:
            build_error = "\n".join(errors)
            fallback = ("JPEG files are decoded by cv2" if lib is not None
                        else "gathers fall back to numpy, resizes and JPEG "
                             "decodes to cv2")
            print(f"srl_zoo_tpu_torch.native: {SRC.name} did not build or "
                  f"load with every part ({fallback}):\n{build_error}",
                  file=sys.stderr)
        if lib is None:
            _failed = True
            return None
        has_jpeg = hasattr(lib, "batch_decode_jpeg")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.batch_gather_u8.argtypes = [u8p, ctypes.c_int64, i32p,
                                        ctypes.c_int64, ctypes.c_int64, u8p]
        lib.batch_resize_bilinear_u8.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u8p, ctypes.c_int, ctypes.c_int]
        lib.batch_gather_u8.restype = ctypes.c_int
        lib.batch_resize_bilinear_u8.restype = ctypes.c_int
        if has_jpeg:
            lib.batch_decode_jpeg.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, u8p, ctypes.c_int]
            lib.batch_decode_jpeg.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def gather_frames(frames: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """out[k] = frames[idx[k]] for a (N, ...) uint8 store (a memmap is
    fine)."""
    idx = np.ascontiguousarray(idx, np.int32)
    lib = get_lib()
    if (lib is None or frames.dtype != np.uint8 or frames.ndim < 2
            or not frames.flags["C_CONTIGUOUS"]):
        counts["gather_numpy"] += len(idx)
        return np.asarray(frames[idx])
    out = np.empty((len(idx),) + tuple(frames.shape[1:]), np.uint8)
    rc = lib.batch_gather_u8(
        _u8ptr(frames), frames.shape[0],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(idx),
        int(np.prod(frames.shape[1:])), _u8ptr(out))
    if rc != 0:
        raise IndexError("gather_frames: index out of range")
    counts["gather_native"] += len(idx)
    return out


def resize_batch(imgs: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Bilinear-resize (N, H, W, C) uint8 -> (N, dh, dw, C)."""
    lib = get_lib()
    n, sh, sw, c = imgs.shape
    if lib is None or imgs.dtype != np.uint8:
        import cv2
        counts["resize_cv2"] += n
        return np.stack([cv2.resize(im, (dw, dh),
                                    interpolation=cv2.INTER_LINEAR)
                         for im in imgs])
    imgs = np.ascontiguousarray(imgs)
    out = np.empty((n, dh, dw, c), np.uint8)
    rc = lib.batch_resize_bilinear_u8(_u8ptr(imgs), n, sh, sw, c,
                                      _u8ptr(out), dh, dw)
    if rc != 0:
        raise ValueError(f"resize_batch: bad geometry "
                         f"({n}x{sh}x{sw}x{c} -> {dh}x{dw})")
    counts["resize_native"] += n
    return out


def default_threads() -> int:
    return min(8, (os.cpu_count() or 1) * 2)


def jpeg_available() -> bool:
    return get_lib() is not None and has_jpeg


def decode_jpeg_batch(paths: Sequence[str], dh: int, dw: int,
                      n_threads: int = 0) -> np.ndarray:
    """Decode and resize JPEG files to (N, dh, dw, 3) RGB uint8 on
    ``n_threads`` threads (0: the default). RuntimeError when the library
    or its decoder is unavailable; FileNotFoundError naming the first file
    that failed."""
    if not jpeg_available():
        raise RuntimeError("the native JPEG decoder is unavailable")
    lib = get_lib()
    n = len(paths)
    out = np.empty((n, dh, dw, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.batch_decode_jpeg(arr, n, dh, dw, _u8ptr(out),
                               n_threads if n_threads > 0
                               else default_threads())
    if rc != 0:
        raise FileNotFoundError(f"JPEG decode failed for {paths[rc - 1]!r}")
    counts["jpeg_native"] += n
    return out
