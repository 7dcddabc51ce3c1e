#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's inference and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --pools-of CHECKOUT

Needs one CUDA card, nvcc (CUDA_HOME or PATH) and this checkout; it builds
the kernels of ``srl_zoo_tpu_torch/csrc`` itself. Phases, each of which
must pass (else the exit code is 1 and no result line is printed); each
prints its wall time:

1. The card's name and power limit (nvidia-smi); the kernels' build time.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it, timed beside its bound:
   relu + pool (K1f) at the three pools of a config-1 forward, at the
   serve and training batch (32; f32 and bf16) and the export batch (256;
   f32), y and argmax exact; its backward (K1b) at the three pools of a
   batch-32 train step, exact on integer-valued inputs (f32 and bf16) and
   within 1e-6 of the largest |g| on random floats. Both pools must take
   their vector path there, and each is timed twice: the kernel alone
   (torch.profiler's device time over 10 calls) and the wrapper (CUDA
   events over 100 calls, Python included), K1f also as the training
   forward (with the index plane, at batch 32). Then both pools, exact,
   at edge shapes that reach the scalar path and the tile edges (C 3, 12,
   66 and 64 in f32, 12 and 64 in bf16; 9x13 and 1x1 images, B 1, pads
   of 0, 2 and 1 per side; slices at an odd storage offset), each on the
   path its shape selects. Gather + normalize (K2) of 256 random rows of
   a 20,000-frame 224x224x3 store, both modes, and of 32 rows (the
   training batch), 1e-6, device and wrapper time; distance +
   top-k (K3) at Q=4,096, N=20,000, D=200, k=6, distances within 1e-4
   relative and indices equal except at ties within that tolerance
   (counted); pairwise distances (K4) at the same Q, N, D, each element
   within 1e-5 of |x|^2 + |y|^2 against the plain version (and at four
   ragged shapes) and against float64 on a 512 x 512 corner, timed
   beside ``torch.cdist`` (the
   library call), and the ``full`` route's top-6 indices against K3's,
   equal except at counted near ties.
3. The inference path at the full width of config 1 (custom_cnn,
   224x224x3, state_dim 200), from a seeded random model saved as a run
   folder: the HTTP server (coalescing 5 ms, max batch 32) answers two
   rounds of 8 concurrent single frames and 2 batches of 16, the first as
   a fresh server's first clients see it; states are exported for the
   20,000-frame store in batches of 256; KNN-MSE (k=5) scores 4,096
   sampled queries with the fused kernel, and the ``full`` route (K4 and a
   stable sort) finds the same queries' 6 nearest. Kernel launch counts
   are zeroed just before and read just after; K1, K2, K3 and K4 must have
   run, and every pool launch must have taken the vector path. Then the
   replies are held against a direct encode (1e-5), 64
   exported rows against a direct encode (1e-5), the score against the
   plain top-k's (1e-6), the ``full`` route's indices against the fused
   route's (equal but at counted near ties) and its score against the
   fused one's (1e-6), and an export of 2,048 rows is profiled (device
   time by kernel, busy share).
4. Training of BASELINE configs 1-4 (custom_cnn, 224x224x3, state_dim 200,
   batch 32, lr 5e-3, BN momentum 0.9): 1 autoencoder, 2 vae, 3 priors,
   4 ``autoencoder:1:100 inverse:2:50 forward:1:25 reward:1:25``. For
   each: one train step on the card against the same step on the CPU
   (plain versions) and in float64, batch 8, from the same weights (and
   the VAE's same eps): loss and gradients within twice the CPU f32
   step's deviation from float64. A 4,096-frame 224x224x3 dataset folder
   with structure is written, and the train CLI
   (``srl_zoo_tpu_torch.train.main``) trains each config on it (config 1
   for 3 epochs, configs 2-4 for 2), exports its states and scores GTC;
   KNN-MSE of the exported states is then scored through both neighbour
   routes (K3 and K4). Launch counts are zeroed just before and read just
   after; K1, K1b, K2, K3 and K4 must have run, the pools on their vector
   path. The training loss must
   fall, the exported states must match a direct encode (1e-5), and the
   two routes' scores must agree (1e-6); train images/s and export
   states/s are printed. Then each pool's input must be channels_last
   (the pool reads it in place), and 8 train steps of config 1 are
   profiled (device time by kernel, busy share, layout transposes and the
   operations that launch them).
5. A ``{"kernels": [...]}`` line (launches summed over all the paths;
   K1f and K1b with ``device_ms`` beside ``ms``), the nvidia-smi line, and
   last ``{"ok": true, "device": {...}}``.

With ``--pools-of CHECKOUT`` it imports the port package of another
checkout (e.g. a ``git archive`` of the parent commit), builds that
checkout's kernels into its own ``build/``, runs phase 2's K1f and K1b
main-shape checks and timings alone on them, and prints a ``{"tree": ...,
"pool_times": [...]}`` line and the card, so that the device times of two
trees' pools can be compared in one run on one card.

Bounds use the H100 SXM data-sheet rates at 700 W: 3.35 TB/s of device
memory and 67 TFLOP/s of float32 outside the tensor cores. No single
PyTorch call computes K1f's, K1b's, K2's or K3's function (K1b:
``max_pool2d_with_indices_backward`` takes int64 indices and has no relu
mask), so their ``library_ms`` is null; K4's is ``torch.cdist(x, y,
compute_mode="use_mm_for_euclid_dist")``, the same product and norms plus
a square root.
"""

from __future__ import annotations

import io
import json
import os
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
# BASELINE configs 1-4: name, --losses tokens, epochs here (30 in the
# configs; cut to stay well inside the script's time limit)
TRAIN_CONFIGS = (
    ("autoencoder", ("autoencoder",), 3),
    ("vae", ("vae",), 2),
    ("priors", ("priors",), 2),
    ("splits", ("autoencoder:1:100", "inverse:2:50", "forward:1:25",
                "reward:1:25"), 2),
)
INFERENCE_KERNELS = ("relu_max_pool", "gather_normalize", "knn_topk",
                     "pairwise_sqdist")
TRAINING_KERNELS = ("relu_max_pool", "relu_max_pool_bwd", "gather_normalize",
                    "knn_topk", "pairwise_sqdist")


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

def device_ms(fn, kernel: str, iters: int = 10) -> float:
    """Device time of one call of ``fn``: torch.profiler's (CUPTI's) device
    time of the kernels whose name holds ``kernel`` over ``iters`` calls
    after a warm-up call, over the calls. Fails unless each call launched
    one such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and kernel in e.key]
    n = sum(e.count for e in evs)
    if n != iters:
        raise AssertionError(f"{n} launches of a {kernel} kernel in "
                             f"{iters} calls")
    return sum(e.self_device_time_total for e in evs) / iters / 1e3


def vector_count(fn):
    """A pool wrapper's vector-path launches so far (None for a tree whose
    kernels have no vector path)."""
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
    """K1f at its nine main-path shapes, the three pools of a config-1
    forward at the serve and training batch (32; f32 and bf16) and at the
    export batch (256; f32): y and idx equal to the plain version's, the
    vector path taken; then the device time (torch.profiler) and the
    wrapper time (CUDA events over WRAPPER_CALLS calls, Python included)
    of the inference call, and at batch 32 in f32 also of the training
    call (with the index plane, from an input that requires grad).
    Appends one record per timing to ``times``. Returns the f32 sums of
    the three pools: {"serve": ..., "export": ...}."""
    import torch
    from srl_zoo_tpu_torch.evaluation.predict_dataset import BATCH
    from srl_zoo_tpu_torch.ops.fused_pool import (relu_max_pool,
                                                  relu_max_pool_plain)
    batches = {SERVE_BATCH: "serve", BATCH: "export"}
    cases = [((b, hw, hw, 64), dtype)
             for b, dtypes in ((SERVE_BATCH, (torch.float32, torch.bfloat16)),
                               (BATCH, (torch.float32,)))
             for hw in POOLS for dtype in dtypes]
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
        if shape[0] == TRAIN_BATCH and dtype == torch.float32:
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
            if dtype == torch.float32 and not index:
                t = totals.setdefault(batches[shape[0]], dict.fromkeys(
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
        log(f"K1f relu_max_pool f32, the three pools of a {path} batch: "
            f"device {t['device_ms']:.4f} ms, wrapper {t['ms']:.4f} ms "
            f"(plain {t['plain_ms']:.4f} ms), bound {b:.4f} ms by {by}")
    return totals


def check_pool_bwd(dev, g, times: list) -> dict:
    """K1b at the three pools of a config-1 train step (batch 32): exact on
    integer-valued inputs and cotangents (every sum exact) in f32 and bf16,
    and within 1e-6 of the largest |g| on random floats in f32 (both add
    the nine window positions in raster order in f32, so 0 is expected);
    the vector path taken; the device time (torch.profiler) and the
    wrapper time (CUDA events over WRAPPER_CALLS calls) in f32. Appends
    one record per timing to ``times``. Returns the f32 sums of the three
    pools."""
    import torch
    from srl_zoo_tpu_torch.ops.fused_pool import (relu_max_pool_bwd,
                                                  relu_max_pool_bwd_plain,
                                                  relu_max_pool_plain)
    t = dict.fromkeys(("ms", "device_ms", "plain_ms", "bytes", "ops", "err"),
                      0.0)
    for hw in POOLS:
        shape = (TRAIN_BATCH, hw, hw, 64)
        for kind, dtype in (("integer", torch.float32),
                            ("random", torch.float32),
                            ("integer", torch.bfloat16)):
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
            if dtype != torch.float32 or kind != "random":
                continue
            call = lambda: relu_max_pool_bwd(gy, idx, shape)  # noqa: E731
            dev_ms = device_ms(call, "relu_max_pool_bwd")
            ms = time_ms(call, iters=WRAPPER_CALLS)
            plain = time_ms(lambda: relu_max_pool_bwd_plain(gy, idx, shape))
            # read g and idx once per output, write dx once per input
            nbytes = gy.numel() * (4 + 1) + dx.numel() * 4
            ops = 8 * dx.numel()  # <= 4 compares and 4 adds per input
            b, by = bound(nbytes, ops)
            log(pool_line("K1b relu_max_pool_bwd", shape, dtype, dev_ms, ms,
                          plain, b, by)
                + f"; integer inputs exact in f32 and bf16, random max err "
                f"{err:.3g}, {path} path")
            times.append({"kernel": "K1b", "shape": list(shape),
                          "dtype": "float32", "index": True,
                          "device_ms": dev_ms, "ms": ms, "plain_ms": plain,
                          "bound_ms": b})
            t["ms"] += ms
            t["device_ms"] += dev_ms
            t["plain_ms"] += plain
            t["bytes"] += nbytes
            t["ops"] += ops
            t["err"] = max(t["err"], err)
    b, by = bound(t["bytes"], t["ops"])
    log(f"K1b relu_max_pool_bwd f32, the three pools of a train step: "
        f"device {t['device_ms']:.4f} ms, wrapper {t['ms']:.4f} ms (plain "
        f"{t['plain_ms']:.4f} ms), bound {b:.4f} ms by {by}, "
        f"{t['bytes'] / 1e6:.1f} MB")
    return t


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


def check_gather(store, dev, g) -> dict:
    """K2 against its plain version at the export batch (256 rows) in both
    modes, and in config 1's mode at the training batch (32 rows); device
    time (torch.profiler) beside the wrapper's (CUDA events, which include
    the wrapper's readback of the out-of-range flag). Returns the 256-row
    "tf" numbers."""
    import torch
    from srl_zoo_tpu_torch.ops.gather_norm import (gather_normalize,
                                                   gather_normalize_plain)
    n = store.shape[0]
    res = {}
    for rows, mode in ((256, "tf"), (256, "image_net"), (TRAIN_BATCH, "tf")):
        idx = torch.randint(0, n, (rows,), generator=g, device=dev)
        out = gather_normalize(store, idx, mode)
        ref = gather_normalize_plain(store, idx, mode)
        err = float((out - ref).abs().max())
        if err > 1e-6:
            raise AssertionError(f"gather_normalize {mode}: max err {err}")
        call = lambda: gather_normalize(store, idx, mode)  # noqa: E731
        dev_ms = device_ms(call, "gather_norm")
        ms = time_ms(call)
        plain = time_ms(lambda: gather_normalize_plain(store, idx, mode))
        nbytes = out.numel() * 5 + idx.numel() * 8
        b, by = bound(nbytes, 2 * out.numel())
        log(f"K2 gather_normalize {mode} B={rows} of N={n}: max err "
            f"{err:.3g}; device {dev_ms:.4f} ms, wrapper {ms:.4f} ms (plain "
            f"{plain:.4f} ms), bound {b:.4f} ms by {by}")
        if rows == 256 and mode == "tf":  # config 1's mode, export batch
            res = {"ms": ms, "plain_ms": plain, "bytes": nbytes,
                   "ops": 2 * out.numel(), "err": err}
    try:
        gather_normalize(store, torch.tensor([0, n], device=dev))
    except IndexError:
        pass
    else:
        raise AssertionError("gather_normalize accepted an index == N")
    return res


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


def check_knn(dev, g) -> dict:
    import torch
    from srl_zoo_tpu_torch.ops.knn_topk import (knn_topk_plain,
                                                knn_topk_with_dist)
    nq, n, d, k = KNN_QUERIES, N_FRAMES, STATE_DIM, 6
    q = torch.randn((nq, d), generator=g, device=dev)
    refs = torch.randn((n, d), generator=g, device=dev)
    kd, ki = knn_topk_with_dist(q, refs, k)
    pd, pi = knn_topk_plain(q, refs, k)
    torch.cuda.synchronize()
    rel = float(((kd - pd).abs() / pd.abs().clamp_min(1e-30)).max())
    if rel > 1e-4:
        raise AssertionError(f"knn_topk distances: max rel err {rel}")
    ties = near_tie_mismatches(q, refs, ki, pi, 1e-4)
    ms = time_ms(lambda: knn_topk_with_dist(q, refs, k))
    plain = time_ms(lambda: knn_topk_plain(q, refs, k), iters=5)
    nbytes = 4 * (nq + n) * d + nq * k * 12
    ops = 2 * nq * n * d + 2 * (nq + n) * d
    b, by = bound(nbytes, ops)
    log(f"K3 knn_topk Q={nq} N={n} D={d} k={k}: max rel err {rel:.3g}, "
        f"{ties} index mismatches at near-ties; {ms:.4f} ms (plain "
        f"{plain:.4f} ms, bound {b:.4f} ms by {by}, "
        f"{ops / ms / 1e9:.1f} TFLOP/s)")
    return {"ms": ms, "plain_ms": plain, "bytes": nbytes, "ops": ops,
            "err": float((kd - pd).abs().max())}


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
    ms = time_ms(lambda: pairwise_sqdist(x, y))
    plain = time_ms(lambda: pairwise_sqdist_plain(x, y))
    lib = time_ms(lambda: torch.cdist(
        x, y, compute_mode="use_mm_for_euclid_dist"))
    nbytes = 4 * (nq + n) * d + 4 * nq * n
    ops = 2 * nq * n * d
    b, by = bound(nbytes, ops)
    log(f"K4 pairwise_sqdist Q={nq} N={n} D={d}: max err {rel:.3g} of "
        f"|x|^2+|y|^2 vs plain, {rel64:.3g} vs float64 on a {c}x{c} corner, "
        f"{edge:.3g} at four ragged shapes; "
        f"{ms:.4f} ms (plain {plain:.4f} ms, torch.cdist {lib:.4f} ms, "
        f"bound {b:.4f} ms by {by}, {ops / ms / 1e9:.1f} TFLOP/s)")
    k = 6
    fd, fi = knn_topk_with_dist(x, y, k, impl="full")
    kd, ki = knn_topk_with_dist(x, y, k)
    torch.cuda.synchronize()
    ties = near_tie_mismatches(x, y, fi, ki, 1e-4)
    full_ms = time_ms(lambda: knn_topk_with_dist(x, y, k, impl="full"),
                      iters=5)
    log(f"full route (K4 + stable sort) top-{k}: {ties} index mismatches "
        f"against K3 at near-ties; {full_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bytes": nbytes,
            "ops": ops, "err": err}


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


def profile_export(encoder, store, rows: int = 2048) -> None:
    """Device time by kernel, and the device's busy share of the wall
    time, over an export of ``rows`` rows (torch.profiler, CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from srl_zoo_tpu_torch.evaluation.predict_dataset import predict_states
    idx = np.arange(min(rows, store.shape[0]))
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
        if hasattr(c, "vector_launches"):
            c.vector_launches = 0


def read_counts(counters, path: str) -> dict:
    """Launch counts by kernel; fails unless every pool launch of the path
    took the vector path."""
    launches = {k: c.launches for k, c in counters.items()}
    vector = {k: c.vector_launches for k, c in counters.items()
              if hasattr(c, "vector_launches")}
    log(f"{path} launches: {launches}; pools on the vector path: {vector}")
    if any(vector[k] != launches[k] for k in vector):
        raise AssertionError(f"a pool launch of the {path} took the scalar "
                             f"path: {vector} of {launches}")
    return launches


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

    def serve_round():
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

    try:
        # --- the main path, with the launch counts zeroed just before -----
        zero_counts(counters)
        # the first round is what the first clients of a fresh server see
        first_replies, first_s = serve_round()
        replies, serve_s = serve_round()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states = predict_states(encoder, store)
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
    profile_export(encoder, store)
    return launches


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------

def write_train_dataset(folder: str) -> None:
    """A dataset folder of TRAIN_FRAMES 224x224x3 frames in TRAIN_EPISODES
    episodes: a red square walks on a shaded background, and its centre
    (scaled to [0, 1]) is the ground truth; a reward of 1 near the middle."""
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
    frames = np.lib.format.open_memmap(os.path.join(folder, "frames.npy"),
                                       mode="w+", dtype=np.uint8,
                                       shape=(n, h, w, c))
    yy = np.arange(h)[None, :, None]
    xx = np.arange(w)[None, None, :]
    shade = (60 + 80 * yy / h + 40 * xx / w).astype(np.uint8)[0]
    for s in range(0, n, 256):
        p = pos[s:s + 256]
        sq = (np.abs(yy - p[:, 0, None, None]) < 12) & \
            (np.abs(xx - p[:, 1, None, None]) < 12)
        block = np.empty((len(p), h, w, c), np.uint8)
        block[:] = shade[None, :, :, None]
        block[sq] = (220, 40, 40)
        frames[s:s + 256] = block
    frames.flush()
    del frames


def train_config(tokens, batch_size: int):
    """SRLConfig of a --losses token list at the full width of the
    BASELINE configs (4 actions, 2 reward classes, as the dataset)."""
    from srl_zoo_tpu_torch.config import SRLConfig, parse_loss_arguments
    losses, splits = parse_loss_arguments(list(tokens), STATE_DIM)
    return SRLConfig(state_dim=STATE_DIM, img_height=IMG[0],
                     img_width=IMG[1], batch_size=batch_size, seed=SEED,
                     losses=tuple(losses.items()),
                     split_dims=tuple(splits.items()), n_actions=4,
                     n_reward_classes=2)


def check_train_step_on_cpu(dev, name: str, tokens) -> None:
    """One train-mode forward + backward of a config at 224 px, batch
    CPU_STEP_BATCH, from the same weights, frames, metadata and (VAE)
    noise on the card (kernels, f32), on the CPU (plain versions, f32)
    and on the CPU in float64. At this geometry the train-mode BatchNorm
    backwards cancel heavily, and f32 gradients stray from the float64
    ones by ~1e-3 of their scale on either device. So the card's step is
    held to the float64 one within twice the CPU f32 step's worst
    deviation (+1e-5): its loss, and each gradient relative to its
    tensor's largest float64 magnitude (a bias in front of a train-mode
    BatchNorm has an exact gradient of 0; there the scale is 1e-2 of the
    model's largest gradient)."""
    import copy

    import torch
    from srl_zoo_tpu_torch.data import samplers
    from srl_zoo_tpu_torch.training.state import make_model
    from srl_zoo_tpu_torch.training.train_step import _inputs, _loss
    cfg = train_config(tokens, CPU_STEP_BATCH)
    b = CPU_STEP_BATCH
    rng = np.random.RandomState(SEED)
    frames = torch.from_numpy(rng.randint(0, 256, (b + 1,) + IMG).astype(
        np.uint8))  # row b is the last row's next frame
    actions = rng.randint(0, 4, b).astype(np.int32)
    rewards = rng.randint(0, 2, b).astype(np.int32)
    batch = {"indices": np.arange(b, dtype=np.int32),
             "valid": np.ones(b, np.float32), "actions": actions,
             "reward_classes": rewards}
    (batch["same_action_partners"],
     batch["same_action_mask"]) = samplers.find_same_action_pairs(actions,
                                                                  rng)
    (batch["dissimilar_partners"],
     batch["dissimilar_mask"]) = samplers.find_dissimilar_pairs(
        actions, rewards, rng)
    eps = torch.randn((2, b, STATE_DIM),
                      generator=torch.Generator().manual_seed(SEED))
    cpu = make_model(cfg, torch.device("cpu"))
    runs = (("card", copy.deepcopy(cpu).to(
        dev, memory_format=torch.channels_last), dev, torch.float32),
        ("cpu", copy.deepcopy(cpu), torch.device("cpu"), torch.float32),
        ("f64", cpu.double(), torch.device("cpu"), torch.float64))
    res = {}
    for run, model, d, dt in runs:
        model.train()
        inputs = _inputs(model, frames.to(d), batch)
        for k in ("obs", "next_obs"):
            if inputs[k] is not None:
                inputs[k] = inputs[k].to(dt)
        if cfg.use_vae:
            inputs["noise"] = {"state": eps[0].to(d, dt),
                               "next_state": eps[1].to(d, dt)}
        loss = _loss(model, inputs)[0]
        loss.backward()
        res[run] = (float(loss.detach()),
                    {k: p.grad.detach().double().cpu()
                     for k, p in model.named_parameters()})
    l64, g64 = res["f64"]
    floor = 1e-2 * max(float(v.abs().max()) for v in g64.values())
    dev_of = {}
    for run in ("card", "cpu"):
        loss, grads = res[run]
        dev_of[run] = (abs(loss - l64) / abs(l64), max(
            float((grads[k] - g64[k]).abs().max())
            / max(float(g64[k].abs().max()), floor) for k in g64))
    (lc, gc), (lp, gp) = dev_of["card"], dev_of["cpu"]
    if lc > 2 * lp + 1e-5 or gc > 2 * gp + 1e-5:
        raise AssertionError(f"{name} train step against float64: card loss "
                             f"{lc:.3g} gradients {gc:.3g}, CPU f32 loss "
                             f"{lp:.3g} gradients {gp:.3g}")
    log(f"{name}: train step at batch {b}, {IMG[0]} px, against the "
        f"float64 step: card loss {lc:.3g}, gradients {gc:.3g} of their "
        f"scale; CPU f32 loss {lp:.3g}, gradients {gp:.3g}")


def profile_training(dev, data_folder: str) -> None:
    """Device time by kernel, and the device's busy share, over
    PROFILE_STEPS train steps of config 1 at batch 32 (torch.profiler),
    and the layout transposes among them (channels_last keeps them out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from srl_zoo_tpu_torch.config import SRLConfig
    from srl_zoo_tpu_torch.data.device_cache import build_cache
    from srl_zoo_tpu_torch.data.loader import DataLoader
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.state import make_model, make_optimizer
    from srl_zoo_tpu_torch.training.train_step import train_step
    cfg = SRLConfig(state_dim=STATE_DIM, img_height=IMG[0], img_width=IMG[1],
                    batch_size=TRAIN_BATCH, seed=SEED)
    dataset = load_dataset(data_folder)
    store = build_cache(dataset, dev)["frames"]
    model = make_model(cfg, dev)
    opt = make_optimizer(cfg, model)
    batches = iter(DataLoader(dataset, dataset.training_indices(),
                              TRAIN_BATCH, seed=SEED))
    gen = torch.Generator(device=dev).manual_seed(SEED)  # config 1 draws none
    train_step(model, opt, store, next(batches), gen)  # warm: cuDNN plans
    # each pool reads the NHWC view of its BatchNorm's output: that view
    # is the tensor itself (no copy) only if the output is channels_last
    layouts = []
    hooks = [bn.register_forward_hook(lambda m, i, out: layouts.append(
        out.is_contiguous(memory_format=torch.channels_last)))
        for bn in model.encoder.bns]
    train_step(model, opt, store, next(batches), gen)
    for h in hooks:
        h.remove()
    if layouts != [True] * len(model.encoder.bns):
        raise AssertionError(f"a pool's input is not channels_last, so the "
                             f"pool reads a copy: {layouts}")
    log(f"the {len(layouts)} pools read their BatchNorm outputs in place "
        "(channels_last)")
    steps = [next(batches) for _ in range(PROFILE_STEPS)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in steps:
            train_step(model, opt, store, batch, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # a range such as the optimizer's "Optimizer.step#Adam.step" shows on
    # the device as a span from its first to its last kernel, idle gaps
    # included; its kernels are listed on their own, so it is left out
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    busy = sum(e.self_device_time_total for e in kernels)
    log(f"profile train {PROFILE_STEPS} steps of batch {TRAIN_BATCH}: wall "
        f"{wall_us / 1e3:.2f} ms ({wall_us / 1e3 / PROFILE_STEPS:.2f} ms per "
        f"step), device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}%), idle "
        f"{100 * (1 - busy / wall_us):.1f}%")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms "
            f"{100 * e.self_device_time_total / busy:5.1f}% x{e.count:<4d} "
            f"{e.key[:90]}")
    layout = [e for e in kernels if is_transpose(e.key)]
    lt = sum(e.self_device_time_total for e in layout)
    log(f"  layout transposes (nchw<->nhwc): {sum(e.count for e in layout)} "
        f"launches of {len(layout)} kernels, {lt / 1e3:.3f} ms "
        f"({100 * lt / max(busy, 1e-9):.1f}% of busy)")

    # which operations launch them: one more step, with input shapes
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        train_step(model, opt, store, steps[0], gen)
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


def run_training(data_folder: str, run_dir: str, dev, counters, name: str,
                 tokens, epochs: int) -> dict:
    """A config trained through the CLI entry point at batch 32 on the
    card, then its states scored by KNN-MSE through both neighbour routes,
    with the launch counts zeroed just before and read just after; then
    its outputs are checked."""

    import torch
    from srl_zoo_tpu_torch import train as train_cli
    from srl_zoo_tpu_torch.data.device_cache import build_cache
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.evaluation.knn import centre, knn_mse
    from srl_zoo_tpu_torch.evaluation.predict_dataset import predict_states
    from srl_zoo_tpu_torch.inference import StateEncoder
    from srl_zoo_tpu_torch.ops.knn_topk import knn_topk
    dataset = load_dataset(data_folder)
    gt = dataset.ground_truth_states
    # --- the training path, with the launch counts zeroed just before -----
    zero_counts(counters)
    t0 = time.perf_counter()
    train_cli.main(["--data-folder", data_folder, "--losses", *tokens,
                    "--model-type", "custom_cnn", "--state-dim",
                    str(STATE_DIM), "-bs", str(TRAIN_BATCH), "--epochs",
                    str(epochs), "--log-folder", run_dir])
    train_s = time.perf_counter() - t0
    states = np.load(os.path.join(run_dir, "states_rewards.npz"))["states"]
    score, queries, _ = knn_mse(states, gt, k=5, n_samples=KNN_QUERIES,
                                seed=SEED)
    refs = centre(torch.from_numpy(states).to(dev))
    q = refs[torch.from_numpy(queries).to(dev)]
    full_idx = knn_topk(q, refs, 6, impl="full")
    torch.cuda.synchronize()
    launches = read_counts(counters, f"{name} training path")
    # --- end of the training path -----------------------------------------
    log(f"{name}: train CLI ({epochs} epochs, export, GTC) in "
        f"{train_s:.1f} s")
    if not all(launches[k] > 0 for k in TRAINING_KERNELS):
        raise AssertionError(f"a kernel never ran on the training path: "
                             f"{launches}")
    hist = np.load(os.path.join(run_dir, "loss_history.npz"))
    log(f"{name}: train/total by epoch: {hist['train/total'].tolist()}; "
        f"val/total: {hist['val/total'].tolist()}")
    if not hist["train/total"][-1] < hist["train/total"][0]:
        raise AssertionError(f"{name}: the training loss did not fall")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        ips = [json.loads(line)["images_per_sec"] for line in f]
    log(f"{name}: train images/s by epoch: {[round(v, 1) for v in ips]}")
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
    # algorithms: f32 rounding, relative to the states' scale
    direct = encoder.encode(np.asarray(dataset.frames[:64]))
    err = float(np.abs(states[:64] - direct).max() / np.abs(direct).max())
    if not err <= 1e-5:
        raise AssertionError(f"exported states differ from encode: {err} "
                             "of their largest magnitude")
    store = build_cache(dataset, encoder.device)["frames"]
    predict_states(encoder, store)  # warm; returns host arrays (synced)
    t0 = time.perf_counter()
    predict_states(encoder, store)
    export_s = time.perf_counter() - t0
    log(f"{name}: trained model: export vs direct encode max err {err:.3g} "
        f"of the largest |state|; {TRAIN_FRAMES / export_s:.0f} states/s "
        f"(export of {TRAIN_FRAMES} rows in batches of 256)")
    return launches


def pools_only(card: str, tree: str) -> int:
    """Phase 2's pool checks and timings alone, on the port package of
    ``tree`` (another checkout, for a parent-against-change comparison on
    one card), then one ``{"pool_times": [...]}`` line and the card."""
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
    print(json.dumps({"tree": tree, "pool_times": times}))
    print(card)
    return 0


def main(argv) -> int:
    tree = None
    if argv:
        if len(argv) != 2 or argv[0] != "--pools-of":
            print("usage: chip_smoke.py [--pools-of CHECKOUT]",
                  file=sys.stderr)
            return 2
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
        from srl_zoo_tpu_torch.ops import (_build, fused_pool, gather_norm,
                                           knn_topk, pairwise)
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
            return pools_only(card, tree)

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
        stats = {"relu_max_pool": check_pool(dev, g, times)["export"],
                 "relu_max_pool_bwd": check_pool_bwd(dev, g, times)}
        check_pool_edges(dev, g)
        stats |= {"gather_normalize": check_gather(store, dev, g),
                  "knn_topk": check_knn(dev, g),
                  "pairwise_sqdist": check_pairwise(dev, g)}
        log(f"phase 2 (kernels) in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        cfg = SRLConfig(state_dim=STATE_DIM, img_height=IMG[0],
                        img_width=IMG[1])
        counters = {"relu_max_pool": fused_pool.relu_max_pool,
                    "relu_max_pool_bwd": fused_pool.relu_max_pool_bwd,
                    "gather_normalize": gather_norm.gather_normalize,
                    "knn_topk": knn_topk.knn_topk_with_dist,
                    "pairwise_sqdist": pairwise.pairwise_sqdist}
        with tempfile.TemporaryDirectory() as run_dir:
            save_srl_model(run_dir, random_model(cfg, SEED))
            launches = run_slice(run_dir, frames_np, store, gt, counters)
        del store, frames_np
        log(f"phase 3 (inference) in {time.perf_counter() - t0:.1f} s")

        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            write_train_dataset(f"{tmp}/data")
            log(f"training dataset ({TRAIN_FRAMES} frames of "
                f"{TRAIN_EPISODES} episodes) written in "
                f"{time.perf_counter() - t0:.1f} s")
            for name, tokens, epochs in TRAIN_CONFIGS:
                t0 = time.perf_counter()
                check_train_step_on_cpu(dev, name, tokens)
                training = run_training(f"{tmp}/data", f"{tmp}/{name}", dev,
                                        counters, name, tokens, epochs)
                launches = {k: launches[k] + training[k] for k in counters}
                log(f"phase 4, {name} in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            profile_training(dev, f"{tmp}/data")
            log(f"training profile in {time.perf_counter() - t0:.1f} s")
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
        if "device_ms" in s:  # K1f, K1b: the kernels alone
            entry["device_ms"] = s["device_ms"]
        kernels.append(entry | {"plain_ms": s["plain_ms"], "bound_ms": b,
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
