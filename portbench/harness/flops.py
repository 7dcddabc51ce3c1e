"""Operations and bytes, counted from shapes: a sample's FLOPs in a train
step, an eval step and an encode, and the bytes that K1f, K1b and K2 must
move for one launch. Rooflines and MFU are these counts over measured
device or wall time (the metric readers under ``portbench/metrics``).

Only convolutions, transposed convolutions and Dense layers are counted
(2 FLOPs a multiply-add), from the architecture's own list
(``reference/<arch>.py`` ``macs``): batch normalization, activations,
pools and the optimizer are left out. A train step runs each layer's
forward, its weight gradient and, where the layer's input takes a
gradient, its input gradient (the first convolution's input is the
frames, which take none): 2 or 3 times the forward's MACs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from portbench.harness import peaks

F32 = 4
INDEX_BYTES = 1  # the pools' int8 argmax plane


def part_flops(layers: Sequence[tuple], train: bool) -> int:
    """FLOPs of one sample through one part's ``(name, macs,
    input_grad)`` layers: forward only, or forward and backward."""
    total = 0
    for _, m, input_grad in layers:
        total += 2 * m * ((2 + bool(input_grad)) if train else 1)
    return total


def sample_flops(arch, cfg, train: bool) -> int:
    """FLOPs of one sample of a train (``train``) or eval step."""
    parts = arch.macs(cfg)
    return sum(part_flops(parts[p], train) for p in arch.step_parts(cfg))


def encode_flops(arch, cfg) -> int:
    """FLOPs of one frame's encode (the encoder's forward)."""
    return part_flops(arch.macs(cfg)["encoder"], False)


def pool_out(n: int) -> int:
    """Output size of the 3x3/2 pool on one axis: ceil(n / 2), the SAME
    pool's and the ResNet stem's (pads (1, 1)) alike."""
    return -(-n // 2)


def k1f_bytes(batch: int, h: int, w: int, c: int, plane: bool,
              elem: int = F32) -> int:
    """Bytes of one fused relu + pool forward: the input read once, the
    output and, with ``plane`` (a training forward), the int8 argmax
    plane written once."""
    out = batch * pool_out(h) * pool_out(w) * c
    return batch * h * w * c * elem + out * elem + \
        (out * INDEX_BYTES if plane else 0)


def k1b_bytes(batch: int, h: int, w: int, c: int, elem: int = F32) -> int:
    """Bytes of one pool backward: the output gradient and the argmax
    plane read once, the input gradient written once."""
    out = batch * pool_out(h) * pool_out(w) * c
    return out * elem + out * INDEX_BYTES + batch * h * w * c * elem


def k2_bytes(rows: int, frame_elems: int) -> int:
    """Bytes of one gather + normalize: uint8 frames read, float32
    written, and the int64 index."""
    return rows * frame_elems * (1 + F32) + rows * 8


def bound_s(nbytes: float, flops: float = 0.0,
            compute_dtype: str = "float32") -> float:
    """The least time the chip could take: the larger of the bytes over
    the HBM bandwidth and the operations over the peak."""
    return max(nbytes / peaks.HBM_BYTES_PER_S,
               flops / peaks.flops_peak(compute_dtype))


def roofline_share(kernel_s: List[float], bounds: List[float]
                   ) -> Optional[float]:
    """A kernel's percent of its roofline: the summed bound of the
    launches the work needed (``bounds``, one a launch) over the
    kernel's summed device time in the trace (``kernel_s``, one a traced
    launch). Where the two counts differ (a record the profiler dropped)
    it is taken per launch: mean bound over mean time. None where the
    trace holds no launch."""
    if not kernel_s or not bounds:
        return None
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(kernel_s)
                                                  / len(kernel_s))


def pool_launch_bounds(arch, cfg, batch: int, passes: int, plane: bool,
                       backward: bool = False) -> List[float]:
    """The bound of each pool launch of ``passes`` encoder passes at
    ``batch`` rows (forward, or with ``backward`` the backward)."""
    out = []
    for h, w, c in arch.pool_inputs(cfg):
        nbytes = k1b_bytes(batch, h, w, c) if backward else \
            k1f_bytes(batch, h, w, c, plane)
        out.append(bound_s(nbytes))
    return out * passes


def step_counts(n_train: int, n_val: int, batch: int) -> Dict[str, int]:
    """Train and eval steps of one epoch over splits of these sizes, as
    the port's loader makes them: training wraps its last partial batch
    around (a split under one batch is tiled to one), validation pads
    its last batch."""
    def steps(n):
        return 1 if n <= batch else -(-n // batch)
    return {"train": steps(n_train), "eval": steps(n_val) if n_val else 0}
