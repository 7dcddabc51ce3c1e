"""The plain references against the port's CPU path at 32 px: the same
weights and inputs give the same states, loss and gradients.

The cases are the configurations that the training cells of
BENCHMARK.json and ``helpers.PLANNED`` run, each at the tests' cut (its
own state width and loss splits). One step's inputs are built from the
seed by the names in the reference's ``INPUTS`` and handed to both
sides: the port's model takes the frames and actions its configuration
reads, its losses the actions and reward classes."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.harness import core, data
from portbench.harness.train_cell import load_weights, srl_config
from portbench.tests.helpers import tiny_cell, workloads
from portbench.tests.test_portbench_inputs import CONFIG4

ROWS = 8
FRAMES = ("obs", "pos", "neg", "next")


def _training_cells():
    """{configuration: the first training cell that runs it}: a training
    cell's kind plants a step that returns its state unchanged."""
    out = {}
    for w in workloads(core.load_manifest()):
        kind = core.load_kind(core.load_traffic(w["traffic"])["kind"])
        if "unchanged_state" in kind.FAULTS:
            out.setdefault(w["config"], w["name"])
    return out


CELLS = _training_cells()


class Recording:
    """A stand-in reference that names every input the harness builds
    and keeps the step its loss was handed."""
    INPUTS = ("obs", "pos", "neg", "next", "actions", "reward_classes")
    seen = []
    # the normalization that ``_reference_loss`` swaps in
    normalize_tf = None

    @classmethod
    def loss(cls, p, step, cfg):
        cls.seen.append(step)
        return torch.zeros((), dtype=torch.float64, requires_grad=True)


def _step(cell, cfg):
    """One step's inputs, from the seed, by the reference's ``INPUTS``:
    uint8 frames of the port's input shape, int64 actions below
    ``n_actions`` and reward classes below ``n_reward_classes``."""
    rng = np.random.default_rng(1)
    shape = (ROWS,) + cfg.img_shape
    make = {"actions": lambda: rng.integers(0, cfg.n_actions, ROWS),
            "reward_classes": lambda: rng.integers(
                0, cfg.n_reward_classes, ROWS)}
    for k in FRAMES:
        make[k] = lambda: rng.integers(0, 256, shape, dtype=np.uint8)
    return {k: torch.from_numpy(make[k]()) for k in cell.arch.INPUTS}


def _setup(cell, weights=True):
    """(port config, float64 model, float64 weights, step) of ``cell``:
    the benchmark's weights loaded into the model, or (``weights``
    False) the model's own."""
    from srl_zoo_tpu_torch.models.srl_modules import SRLModules
    cfg = srl_config(cell, "")
    torch.manual_seed(0)
    model = SRLModules(cfg).double()
    p = None
    if weights:
        p = {k: v.double() for k, v in data.make_weights(
            cell.arch.param_spec(cell.config), 5, torch.device("cpu")
        ).items()}
        load_weights(model, p)
    return cfg, model, p, _step(cell, cfg)


def _config4():
    """Config 4's losses on the cnn_ae architecture at the tests' cut,
    read by a ``Recording`` reference: (cell, config, own model, step)."""
    cell = dataclasses.replace(tiny_cell("cnn_ae.resident", **CONFIG4),
                               arch=Recording)
    cfg, model, _, step = _setup(cell, weights=False)
    return cell, cfg, model, step


def _port_loss(cfg, model, step):
    """The port's loss of ``step``: the model takes the frames and the
    actions its configuration reads (a KeyError where the step lacks
    one), the losses every action and reward class of the step."""
    from srl_zoo_tpu_torch.losses import registry
    from srl_zoo_tpu_torch.ops.preproc import normalize_images
    x = {k: normalize_images(step[k], "tf").double() for k in FRAMES
         if k in step}
    out = model(x["obs"],
                next_obs=x["next"] if cfg.needs_next_obs else None,
                actions=step["actions"] if cfg.use_forward else None,
                pos_obs=x["pos"] if cfg.use_triplet else None,
                neg_obs=x["neg"] if cfg.use_triplet else None)
    batch = {k: step[k] for k in ("actions", "reward_classes") if k in step}
    return registry.compute_total_loss(cfg, out, x["obs"], None,
                                       model.parameters(), batch=batch)[0]


def _reference_loss(cell, weights, step):
    """The reference's loss of the same ``step`` dict, from ``weights``
    that take a gradient, with the port's float32 normalization in
    float64 on both sides."""
    from srl_zoo_tpu_torch.ops.preproc import normalize_images
    p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    orig = cell.arch.normalize_tf
    cell.arch.normalize_tf = lambda u8: normalize_images(u8, "tf").double()
    try:
        return p, cell.arch.loss(p, step, cell.config)
    finally:
        cell.arch.normalize_tf = orig


@pytest.mark.parametrize("config", sorted(CELLS))
def test_eval_states_match(config):
    from srl_zoo_tpu_torch.ops.preproc import normalize_images
    cell = tiny_cell(CELLS[config])
    cfg, model, weights, step = _setup(cell)
    model.eval()
    x = normalize_images(step["obs"], "tf").double()
    with torch.no_grad():
        got = model.encode(x)
    want = cell.arch.encode(weights, x, cell.config, False)
    assert got.shape == (ROWS, cell.config["state_dim"])
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("config", sorted(CELLS))
def test_train_loss_and_gradients_match(config):
    cell = tiny_cell(CELLS[config])
    cfg, model, weights, step = _setup(cell)
    model.train()
    loss = _port_loss(cfg, model, step)
    loss.backward()
    p, ref = _reference_loss(cell, weights, step)
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


def test_every_trained_configuration_is_a_case():
    """The ``train`` and ``dp`` kinds train and the ``encode`` kind does
    not, so every configuration that a ``train`` cell runs is a case."""
    trained = {w["config"] for w in workloads(core.load_manifest())
               if core.load_traffic(w["traffic"])["kind"] == "train"}
    assert trained and trained <= set(CELLS)
    assert "unchanged_state" in core.load_kind("dp").FAULTS
    assert "unchanged_state" not in core.load_kind("encode").FAULTS


def test_transitions_reach_both_sides(monkeypatch):
    """A reference that names all six inputs, under config 4's losses:
    the port's model is handed the step's ``next`` frames and
    ``actions``, its losses the same ``actions`` and ``reward_classes``,
    and the reference the same step dict."""
    from srl_zoo_tpu_torch.losses import registry
    from srl_zoo_tpu_torch.models.srl_modules import SRLModules
    from srl_zoo_tpu_torch.ops.preproc import normalize_images
    cell, cfg, model, step = _config4()
    assert set(step) == set(Recording.INPUTS)
    got = {}
    forward, total = SRLModules.forward, registry.compute_total_loss

    def record_forward(self, obs, **kw):
        got["model"] = kw
        return forward(self, obs, **kw)

    def record_total(*args, batch=None, **kw):
        got["batch"] = batch
        return total(*args, batch=batch, **kw)
    monkeypatch.setattr(SRLModules, "forward", record_forward)
    monkeypatch.setattr(registry, "compute_total_loss", record_total)
    _port_loss(cfg, model, step)
    Recording.seen.clear()
    _reference_loss(cell, {}, step)
    assert len(Recording.seen) == 1 and Recording.seen[0] is step
    assert torch.equal(got["model"]["next_obs"],
                       normalize_images(step["next"], "tf").double())
    assert not torch.equal(step["next"], step["obs"])
    assert got["model"]["actions"] is step["actions"]
    assert got["batch"]["actions"] is step["actions"]
    assert got["batch"]["reward_classes"] is step["reward_classes"]
    for k, n in (("actions", cfg.n_actions),
                 ("reward_classes", cfg.n_reward_classes)):
        assert step[k].dtype == torch.int64
        assert 0 <= int(step[k].min()) and int(step[k].max()) < n
    # a configuration that reads a transition cannot do without one
    cut = {k: v for k, v in step.items() if k != "next"}
    with pytest.raises(KeyError):
        _port_loss(cfg, model, cut)


def test_config4_splits_survive_the_cut():
    """Config 4's losses on the cnn_ae architecture, at the tests' cut:
    the state keeps its width of 200 and its four slices, and one train
    step of the port moves every head."""
    cell, cfg, model, step = _config4()
    assert cfg.state_dim == cell.config["state_dim"] == 200
    # (start, width) of each loss's slice: [0, 100), [100, 150),
    # [150, 175), [175, 200)
    assert cfg.slices == {"autoencoder": (0, 100), "inverse": (100, 50),
                          "forward": (150, 25), "reward": (175, 25)}
    model.train()
    loss = _port_loss(cfg, model, step)
    assert torch.isfinite(loss)
    loss.backward()
    for head in ("encoder", "decoder", "inverse_model", "forward_model",
                 "reward_model"):
        leaves = [q for n, q in model.named_parameters()
                  if n.startswith(head + ".")]
        assert leaves and all(q.grad is not None for q in leaves), head
        assert sum(float(q.grad.norm()) for q in leaves) > 0, head


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
