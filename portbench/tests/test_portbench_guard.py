"""The import guard compares top-level names whole."""

import subprocess
import sys

from portbench.harness import core, guard


def test_whole_top_level_names():
    assert guard.forbidden(["jax", "jax.numpy", "jaxlib.xla_client",
                            "flax.linen", "optax", "srl_zoo_tpu",
                            "srl_zoo_tpu.ops"]) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "optax",
         "srl_zoo_tpu", "srl_zoo_tpu.ops"])
    assert guard.forbidden(["srl_zoo_tpu_torch", "srl_zoo_tpu_torch.ops",
                            "jaxtyping", "flaxen", "torch", "numpy"]) == []


def test_a_run_imports_neither_jax_nor_the_jax_package():
    """Every module a run imports, in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from portbench.harness import core, train_cell, encode_cell, "
        "dp_cell, check, trace, flops, data;"
        "from portbench import calibrate;"
        "import portbench.reference.cnn_ae, "
        "portbench.reference.resnet18_triplet;"
        "from srl_zoo_tpu_torch.training.learner import SRL4robotics;"
        "from srl_zoo_tpu_torch.inference import StateEncoder;"
        "m = core.load_manifest();"
        "[core.load_reader(x['name']) for x in m['per_layer']];"
        "from portbench.harness import guard;"
        "print(guard.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_port():
    for path in (core.BENCH / "reference").glob("*.py"):
        text = path.read_text()
        for name in ("srl_zoo_tpu", "jax", "flax", "optax"):
            assert f"import {name}" not in text, path
            assert f"from {name}" not in text, path
