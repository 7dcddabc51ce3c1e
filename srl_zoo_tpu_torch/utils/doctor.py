"""Environment doctor: the device, its memory, the host link and where a
dataset's frames would live (port of ``srl_zoo_tpu/utils/doctor.py``).

Training speed turns on one question: does the dataset fit the device's
frame-cache budget, and if not, how fast is the host link that streams
it? The doctor answers it before a long run does:

* the device, its total and free memory and the frame-cache budget
  (data/device_cache.py ``budget_bytes``);
* the pinned host-to-device bandwidth, measured under a time bound: a
  copy that hangs makes the doctor print a diagnosis and exit with code 2;
* for ``--data-folder`` at ``--img-size``, the store ``--device-cache
  auto`` opens (data/device_cache.py ``plan``: the whole store, a hybrid
  store of how many rows, or streaming) and the share of the rows that
  ``--device-cache sharded`` holds over all the host's GPUs.

    python -m srl_zoo_tpu_torch.utils.doctor [--data-folder data/<ds>]
        [--img-size 224] [-bs 32] [--skip-bandwidth] [--device cpu]
"""

from __future__ import annotations

import argparse
import threading
import time

import torch

from srl_zoo_tpu_torch.utils.misc import printGreen, printRed, printYellow

LINK_TIMEOUT_S = 240.0  # bound on the bandwidth probe
LINK_MIB = 64           # bytes the probe copies


class TransferTimeout(RuntimeError):
    """A bounded call did not return in time."""


def run_bounded(fn, timeout_s: float, what: str):
    """``fn()`` in a daemon thread: its result, its exception re-raised, or
    ``TransferTimeout`` after ``timeout_s``. The stuck thread keeps
    running, so the caller reports and exits rather than retry."""
    box = {}

    def call():
        try:
            box["result"] = fn()
        except BaseException as e:  # re-raised in the caller below
            box["error"] = e

    t = threading.Thread(target=call, daemon=True)
    t.start()
    t.join(timeout_s)
    if "error" in box:
        raise box["error"]
    if "result" not in box:
        raise TransferTimeout(f"{what} did not finish in {timeout_s:.0f} s")
    return box["result"]


def measure_link_bandwidth(device: torch.device, n_mib: int = LINK_MIB
                           ) -> float:
    """MB/s of one copy of ``n_mib`` MiB from pinned host memory to
    ``device``, after a warm-up copy, timed to the device's synchronise
    (on the CPU, a copy between two host buffers)."""
    cuda = device.type == "cuda"
    src = torch.zeros(n_mib * 2**20, dtype=torch.uint8, pin_memory=cuda)
    dst = torch.empty_like(src, device=device)
    dst.copy_(src, non_blocking=cuda)
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    dst.copy_(src, non_blocking=cuda)
    if cuda:
        torch.cuda.synchronize(device)
    return src.numel() / (time.perf_counter() - t0) / 1e6


def _report_device(device: torch.device):
    """Print the device, its memory and the budget; returns the budget."""
    from srl_zoo_tpu_torch.data.device_cache import BUDGET_ENV, budget_bytes
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        printGreen(f"device: {torch.cuda.get_device_name(device)} "
                   f"({torch.cuda.device_count()} GPU(s) on this host); "
                   f"memory {total / 2**30:.1f} GiB, "
                   f"{free / 2**30:.1f} GiB free")
    else:
        printGreen(f"device: {device} (no device memory limit)")
    budget = budget_bytes(device)
    printGreen("frame-cache budget: " + (
        "none" if budget is None else f"{budget / 2**30:.2f} GiB")
        + f" a device (override: {BUDGET_ENV})")
    return budget


def _report_dataset(folder: str, img_size: int, batch_size: int,
                    budget, n_gpus: int) -> None:
    from srl_zoo_tpu_torch.data import device_cache as dc
    from srl_zoo_tpu_torch.data.schema import load_dataset
    ds = load_dataset(folder)
    printGreen(f"dataset: {ds.n_samples} samples, {ds.n_actions} actions, "
               f"{ds.n_reward_classes} reward classes, "
               f"frames.npy={'yes' if ds.frames is not None else 'NO'}")
    second = ds.frames_2 is not None
    hw = (img_size, img_size)
    if ds.frames is not None:
        printGreen(f"frame store: {dc.cache_nbytes(ds, second) / 2**20:.0f} "
                   f"MiB at {ds.frames.shape[1]}x{ds.frames.shape[2]}")
    kind, rows = dc.plan(ds, hw, second, "auto", batch_size, budget)
    if kind == "whole":
        printGreen("mode: whole store (fits the device budget; the fastest "
                   "mode)")
    elif kind == "hybrid":
        printYellow(f"mode: hybrid store of {rows}/{ds.n_samples} rows "
                    f"({100 * rows / ds.n_samples:.0f}% resident), the rest "
                    "streams")
    else:
        printYellow(f"mode: streaming (no frames.npy at {img_size}x"
                    f"{img_size}, or fewer than two batches fit)")
    if kind != "whole" and rows and n_gpus > 1:
        share = min(1.0, n_gpus * rows / ds.n_samples)
        printYellow(f"on {n_gpus} GPUs, --device-cache sharded holds "
                    f"{100 * share:.0f}% of the rows")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-folder", type=str, default="")
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("-bs", "--batch-size", type=int, default=32)
    p.add_argument("--skip-bandwidth", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    from srl_zoo_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    budget = _report_device(device)

    if not args.skip_bandwidth:
        try:
            bw = run_bounded(lambda: measure_link_bandwidth(device),
                             LINK_TIMEOUT_S, "link-bandwidth measurement")
        except TransferTimeout as e:
            printRed(f"host->device link: MEASUREMENT HUNG ({e})")
            printRed("diagnosis: the device answers but a bulk copy to it "
                     "stalls. Caching the dataset and streaming it will "
                     "hang too; check the GPU with nvidia-smi, or run "
                     "with --device cpu.")
            return 2
        frame = args.img_size * args.img_size * 3
        link = "host->device link (pinned)" if device.type == "cuda" \
            else "host copy"
        msg = (f"{link}: {bw:.0f} MB/s => streaming ceiling "
               f"~{bw * 1e6 / frame:.0f} img/s at {args.img_size}px")
        (printGreen if bw > 1000 else printYellow)(msg)

    if args.data_folder:
        n_gpus = torch.cuda.device_count() if device.type == "cuda" else 1
        _report_dataset(args.data_folder, args.img_size, args.batch_size,
                        budget, n_gpus)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
