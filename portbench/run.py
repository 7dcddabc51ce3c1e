"""One run of one cell of the srl_zoo_tpu_torch benchmark, on the CUDA
device of the machine it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared beside its limit); the last lines of standard error are
the same numbers. Without a CUDA device, or with fewer than the cell
asks for, it exits with code 2 and prints no result; if the run loaded
JAX or the JAX package, with code 3. portbench/README.md says more.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_compute")):
    os.environ[_var] = os.path.join(ROOT, "build", "portbench_cache", _sub)
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench.harness import core
    sys.exit(core.main(t0=T0))
