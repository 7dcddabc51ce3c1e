"""mfu.encode: the encoder's forward FLOPs of the traced run's calls
outside the profiled ones over their summed latency and the chip's peak
for the configuration's compute dtype; percent."""

from portbench.harness import flops, peaks


def read(r):
    lat = getattr(r, "latencies_s", None)
    if not lat:
        return None
    work = len(lat) * r.batch * flops.encode_flops(r.arch, r.config)
    return 100.0 * work / (sum(lat) * peaks.flops_peak(
        r.config["compute_dtype"]))
