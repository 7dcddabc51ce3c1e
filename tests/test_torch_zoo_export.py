"""The port's self-contained torch encoder export
(``srl_zoo_tpu_torch/export/torch_export.py``) against the JAX package's
(``srl_zoo_tpu/export/torch_export.py``), on the CPU at 32-60 px.

The same JAX variables (random, with non-trivial BatchNorm statistics, as
tests/test_torch_export.py makes them) go to JAX's ``build_torch_encoder``
directly and to the port's through the weight bridge; the two modules'
states on the same uint8 frames agree within 1e-5 of their largest
magnitude (the same torch layers on the same float32 weights). The
artifact written from a port run folder is held to the port's own
``StateEncoder`` within 1e-5 (there the normalization rounds otherwise:
``x * scale + offset`` against ``(x - shift) / scale``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from srl_zoo_tpu.config import SRLConfig as JaxConfig
from srl_zoo_tpu.export import build_torch_encoder as jax_build
from srl_zoo_tpu_torch import bridge
from srl_zoo_tpu_torch.checkpoint import save_srl_model
from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.export.torch_export import (build_torch_encoder,
                                                   export_torch_encoder,
                                                   main)
from srl_zoo_tpu_torch.models.srl_modules import SRLModules
from test_torch_export import _random_variables
from test_torch_zoo_train import _cli, _close_rel_max

ONE_VIEW = {"losses": (("autoencoder", 1.0),),
            "split_dims": (("autoencoder", -1),)}
INVERSE = {"losses": (("inverse", 1.0),), "split_dims": (("inverse", -1),),
           "n_actions": 3}
# name: the JAX config's fields beside state_dim 6 (img 32 x 32 unless set)
CASES = {
    "custom_cnn": {"model_type": "custom_cnn", **ONE_VIEW},
    "resnet": {"model_type": "resnet", **INVERSE},
    "resnet-6ch": {"model_type": "resnet", "multi_view": True,
                   "losses": (("priors", 1.0),),
                   "split_dims": (("priors", -1),)},
    "mlp": {"model_type": "mlp", **ONE_VIEW},
    "linear": {"model_type": "linear", **INVERSE},
    "vae": {"losses": (("vae", 1.0),), "split_dims": (("vae", -1),)},
    "image_net": {"model_type": "mlp", "normalize_mode": "image_net",
                  **INVERSE},
    "image_net-resnet-6ch": {"model_type": "resnet", "multi_view": True,
                             "normalize_mode": "image_net",
                             "losses": (("priors", 1.0),),
                             "split_dims": (("priors", -1),)},
    "nonsquare": {"img_height": 36, "img_width": 60, **INVERSE},
    "bf16": {"compute_dtype": "bfloat16", **ONE_VIEW},
}


def _configs(name: str):
    kw = {"img_height": 32, "img_width": 32, **CASES[name]}
    jcfg = JaxConfig(state_dim=6, **kw)
    return jcfg, SRLConfig.from_exp_config(jcfg.to_exp_config())


def _frames(cfg, n: int = 3, seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, 256, (n,) + cfg.img_shape, dtype=np.uint8)


def _states(module, obs_u8: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return module(torch.from_numpy(obs_u8.astype(np.float32))).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_export_equals_the_jax_export(name):
    """The port's module from the bridged weights against JAX's
    ``build_torch_encoder`` on the JAX variables: custom_cnn, ResNet-18 at
    3 and 6 channels, mlp, linear, a VAE (mu), image_net, a non-square
    SAME-padded image and a bfloat16 run (float32 parameters, a float32
    module in both)."""
    jcfg, cfg = _configs(name)
    _, variables = _random_variables(jcfg, seed=len(name))
    sd, skipped = bridge.state_dict_from_jax(
        variables["params"], variables.get("batch_stats", {}))
    assert skipped == []
    obs = _frames(cfg)
    want = _states(jax_build(jcfg, variables), obs)
    module = build_torch_encoder(cfg, sd)
    assert not module.training
    got = _states(module, obs)
    assert got.shape == (3, 6) and got.dtype == np.float32
    assert np.abs(want).max() > 1e-3
    _close_rel_max(got, want, 1e-5)


def _port_run(tmp_path, name: str) -> tuple[str, SRLConfig]:
    """A port run folder (exp_config.json, srl_model.pth) of the case's
    config, from the JAX variables through the bridge."""
    jcfg, cfg = _configs(name)
    _, variables = _random_variables(jcfg, seed=3)
    sd, _ = bridge.state_dict_from_jax(variables["params"],
                                       variables.get("batch_stats", {}))
    model = SRLModules(cfg)
    model.load_state_dict(sd)
    run = str(tmp_path / name)
    save_srl_model(run, model)
    return run, cfg


@pytest.mark.parametrize("name", ["custom_cnn", "resnet-6ch", "vae", "mlp"])
def test_artifact_equals_the_ports_encoder(name, tmp_path):
    """The TorchScript artifact of a port run folder, loaded by
    ``torch.jit.load``, against the port's ``StateEncoder`` on the same
    run, and its meta file."""
    from srl_zoo_tpu_torch.inference import StateEncoder
    run, cfg = _port_run(tmp_path, name)
    path = export_torch_encoder(run, device="cpu")
    assert path == os.path.join(run, "encoder_torch.pt")
    obs = _frames(cfg, 5)
    want = StateEncoder.load(run, device="cpu").encode(obs)
    got = _states(torch.jit.load(path, map_location="cpu").eval(), obs)
    assert np.abs(want).max() > 1e-3
    _close_rel_max(got, want, 1e-5)
    with open(path + ".json") as f:
        meta = json.load(f)
    assert meta == {
        "input": f"float32 NHWC in [0, 255] (32x32x{cfg.n_channels})",
        "output": "float32 (B, 6) states",
        "normalization": "applied inside (tf)",
        "model_type": cfg.model_type, "torchscript": True}


@pytest.mark.parametrize("name", ["resnet", "custom_cnn"])
def test_state_dict_export_strips_the_normalizer(name, tmp_path):
    """``--state-dict`` writes a bare state dict without shift and scale;
    for ResNet-18 its keys are torchvision resnet18's (the port's encoder
    keys, num_batches_tracked included), and its weights are the run's."""
    run, cfg = _port_run(tmp_path, name)
    out = str(tmp_path / "sd.pt")
    assert main(["--log-folder", run, "--out", out, "--state-dict",
                 "--device", "cpu"]) == out
    sd = torch.load(out, weights_only=True)
    assert "shift" not in sd and "scale" not in sd
    enc = {k[len("encoder."):]: v
           for k, v in torch.load(os.path.join(run, "srl_model.pth"),
                                  weights_only=True).items()
           if k.startswith("encoder.")}
    assert sd.keys() == enc.keys()
    for k, v in sd.items():
        assert torch.equal(v, enc[k]), k
    if name == "resnet":
        for key in ("conv1.weight", "bn1.running_var",
                    "layer1.0.conv1.weight", "layer2.0.downsample.0.weight",
                    "layer4.1.bn2.num_batches_tracked", "fc.weight"):
            assert key in sd, key
    with open(out + ".json") as f:
        assert json.load(f)["normalization"] == "NOT applied — apply " \
                                                "yourself (tf)"


def test_cli_exports_a_trained_port_run(synthetic_dataset, tmp_path):
    """The train CLI's run folder exported by the export CLI on the CPU:
    the artifact's states equal the run's own exported states (the
    ``states_rewards.npz`` of the train CLI) within 1e-5; the default
    device is the GPU, which raises here."""
    run = _cli(synthetic_dataset.data_folder, str(tmp_path / "run"), 1)
    path = main(["--log-folder", run, "--device", "cpu"])
    frames = np.asarray(synthetic_dataset.frames)
    got = _states(torch.jit.load(path).eval(), frames)
    want = np.load(os.path.join(run, "states_rewards.npz"))["states"]
    _close_rel_max(got, want, 1e-5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_torch_encoder(run, str(tmp_path / "again.pt"))


def test_artifact_loads_with_torch_alone(tmp_path):
    """A subprocess outside the repository, importing torch only, loads
    the artifact and runs it: no module of either package is loaded, and
    the states equal this process's."""
    run, cfg = _port_run(tmp_path, "resnet-6ch")
    path = export_torch_encoder(run, device="cpu")
    obs = _frames(cfg, 2)
    np.save(tmp_path / "obs.npy", obs)
    code = (
        "import sys, numpy as np, torch\n"
        f"enc = torch.jit.load({path!r}, map_location='cpu').eval()\n"
        f"obs = np.load({str(tmp_path / 'obs.npy')!r})\n"
        "with torch.no_grad():\n"
        "    s = enc(torch.from_numpy(obs).float()).numpy()\n"
        f"np.save({str(tmp_path / 'states.npy')!r}, s)\n"
        "bad = [m for m in sys.modules if m.startswith('srl_zoo_tpu')\n"
        "       or m in ('jax', 'flax') or m.startswith('jax.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    _close_rel_max(np.load(tmp_path / "states.npy"),
                   _states(torch.jit.load(path), obs), 0.0)
