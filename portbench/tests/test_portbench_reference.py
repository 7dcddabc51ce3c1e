"""The plain references against the port's CPU path at 32 px: the same
weights and frames give the same states, loss and gradients."""

import numpy as np
import pytest
import torch

from portbench.harness import data
from portbench.harness.train_cell import load_weights
from portbench.tests.helpers import tiny_cell

CONFIGS = ["cnn_ae.resident", "resnet_triplet.resident"]


def _setup(cell_name):
    from srl_zoo_tpu_torch.models.srl_modules import SRLModules
    from portbench.harness.train_cell import srl_config
    cell = tiny_cell(cell_name)
    cfg = srl_config(cell, "")
    torch.manual_seed(0)
    model = SRLModules(cfg).double()
    weights = {k: v.double() for k, v in data.make_weights(
        cell.arch.param_spec(cell.config), 5, torch.device("cpu")).items()}
    load_weights(model, weights)
    rng = np.random.default_rng(1)
    frames = {k: torch.from_numpy(rng.integers(
        0, 256, (8, 32, 32, 3), dtype=np.uint8)) for k in ("obs", "pos",
                                                           "neg")}
    return cell, cfg, model, weights, frames


def _port_loss(cfg, model, frames):
    from srl_zoo_tpu_torch.losses.registry import compute_total_loss
    from srl_zoo_tpu_torch.ops.preproc import normalize_images
    x = {k: normalize_images(v, "tf").double() for k, v in frames.items()}
    out = model(x["obs"], pos_obs=x["pos"] if cfg.use_triplet else None,
                neg_obs=x["neg"] if cfg.use_triplet else None)
    return compute_total_loss(cfg, out, x["obs"], None,
                              model.parameters())[0]


@pytest.mark.parametrize("cell_name", CONFIGS)
def test_eval_states_match(cell_name):
    from srl_zoo_tpu_torch.ops.preproc import normalize_images
    cell, cfg, model, weights, frames = _setup(cell_name)
    model.eval()
    with torch.no_grad():
        got = model.encode(normalize_images(frames["obs"], "tf").double())
    want = cell.arch.encode(
        weights, normalize_images(frames["obs"], "tf").double(), cell.config,
        False)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("cell_name", CONFIGS)
def test_train_loss_and_gradients_match(cell_name):
    from srl_zoo_tpu_torch.ops.preproc import normalize_images
    cell, cfg, model, weights, frames = _setup(cell_name)
    model.train()
    loss = _port_loss(cfg, model, frames)
    loss.backward()
    step = {k: v for k, v in frames.items()}
    p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    orig = cell.arch.normalize_tf
    # both sides read the same float32 normalization, in float64
    cell.arch.normalize_tf = lambda u8: normalize_images(u8, "tf").double()
    try:
        ref = cell.arch.loss(p, step, cell.config)
    finally:
        cell.arch.normalize_tf = orig
    ref.backward()
    torch.testing.assert_close(loss, ref, rtol=1e-10, atol=1e-12)
    # the port's pool backward adds in float32 (its kernel's order), so
    # the encoder's gradients agree to float32's rounding, each held
    # against the larger of its own norm and the median leaf's (leaves
    # under BatchNorm, or that the loss cannot see, have none)
    grads = dict(model.named_parameters())
    norms = sorted(float(p[n].grad.norm()) for n in grads)
    floor = norms[len(norms) // 2]
    for name in grads:
        gap = float((grads[name].grad - p[name].grad).norm())
        assert gap <= 1e-6 * max(float(p[name].grad.norm()), floor), name


def test_adam_matches_torch_adam():
    """The reference's Adam, written out, is torch's Adam (optax's)."""
    from portbench.reference.common import adam_steps
    w = torch.randn(5, 3, dtype=torch.float64)
    xs = [torch.randn(3, dtype=torch.float64) for _ in range(3)]
    got = adam_steps({"w": w}, ["w"], lambda p, x: (p["w"] @ x).sin().sum(),
                     xs, 5e-3)
    q = w.clone().requires_grad_(True)
    opt = torch.optim.Adam([q], lr=5e-3, betas=(0.9, 0.999), eps=1e-8)
    for x in xs:
        opt.zero_grad()
        (q @ x).sin().sum().backward()
        opt.step()
    torch.testing.assert_close(got["params"]["w"], q.detach(), rtol=1e-12,
                               atol=1e-12)
