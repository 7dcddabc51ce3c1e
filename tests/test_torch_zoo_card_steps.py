"""Whole train and eval steps on the card, at config 1's width (224 px,
state_dim 200): no step synchronises the host with the device, and one
train step of each config matches the same step on the CPU and in
float64.

Every test needs a CUDA device and skips without one; this file imports
no JAX, so on the card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q -m chip \\
        tests/test_torch_zoo_card_steps.py
"""

from __future__ import annotations

import copy
import threading

import numpy as np
import pytest
import torch

from torch_card_lib import cuda  # noqa: F401 (a fixture)
from torch_card_lib import (ALL_CONFIGS, BATCH, IMG, N_FRAMES, SEED,
                            STATE_DIM, assert_no_sync, train_config)

pytestmark = pytest.mark.chip
CONFIG = {name: (tokens, kw) for name, tokens, _, kw in ALL_CONFIGS}
CPU_STEP_BATCH = 8
U_BF16 = 2.0 ** -9  # bfloat16's unit roundoff
# each encoder's first layer (and its BatchNorm): the ResNet stem's
# tensors, which only the stem pool's routing reaches
STEMS = {"resnet": ("encoder.conv1.", "encoder.bn1."),
         "custom_cnn": ("encoder.convs.0.", "encoder.bns.0."),
         "mlp": ("encoder.layers.0.",), "linear": ("encoder.layers.0.",)}


@pytest.fixture(scope="module")
def views(cuda):
    """Both views of a 20,000-frame random store (the same tensor)."""
    g = torch.Generator(device=cuda).manual_seed(SEED)
    store = torch.randint(0, 256, (N_FRAMES,) + IMG, generator=g,
                          device=cuda, dtype=torch.uint8)
    return {"frames": store, "frames_2": store}


def step_batch(indices: np.ndarray, rng, n_rows: int) -> dict:
    """A loader-style batch of the store rows ``indices``, with the
    metadata of every loss (actions, rewards, the priors' pairs, the
    triplet's negatives among ``n_rows`` rows, the episode prior's pairs
    of rows in four episodes, a 2-wide ground truth)."""
    from srl_zoo_tpu_torch.data import samplers
    b = len(indices)
    actions = rng.randint(0, 4, b).astype(np.int32)
    rewards = rng.randint(0, 2, b).astype(np.int32)
    batch = {"indices": indices.astype(np.int32),
             "valid": np.ones(b, np.float32), "actions": actions,
             "reward_classes": rewards,
             "neg_indices": rng.randint(0, n_rows, b).astype(np.int32)}
    (batch["same_action_partners"],
     batch["same_action_mask"]) = samplers.find_same_action_pairs(actions,
                                                                  rng)
    (batch["dissimilar_partners"],
     batch["dissimilar_mask"]) = samplers.find_dissimilar_pairs(
        actions, rewards, rng)
    batch["rewards"] = rewards.astype(np.float32)
    (batch["episode_partners"],
     batch["episode_labels"]) = samplers.episode_prior_pairs(
        rng.randint(0, 4, b), rng)
    batch["gt_states"] = rng.uniform(0, 1, (b, 2)).astype(np.float32)
    return batch


def random_dae(batch_size: int, device, seed: int = SEED):
    """A frozen DAE of config 1's width with seeded random weights, for
    the perceptual loss."""
    from srl_zoo_tpu_torch.training.state import make_model
    cfg = train_config(("dae",), batch_size).replace(seed=seed)
    return make_model(cfg, device).eval().requires_grad_(False)


def step_calls(name: str, views, cuda) -> tuple:
    """A whole ``train_step`` (a full cycle of micro-steps under
    ``--grad-accum``) and ``eval_step`` of config ``name`` at batch 32:
    inputs, forward, loss, backward, Adam; the DAE with its validation
    draw, the perceptual loss through a frozen DAE; and the model,
    optimizer and generator they step."""
    from srl_zoo_tpu_torch.training.state import make_model, make_optimizer
    from srl_zoo_tpu_torch.training.train_step import (draw_corruption,
                                                       eval_step, train_step)
    tokens, kw = CONFIG[name]
    cfg = train_config(tokens, BATCH, kw)
    model = make_model(cfg, cuda)
    opt = make_optimizer(cfg, model)
    gen = torch.Generator(device=cuda).manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    batch = step_batch(rng.choice(N_FRAMES, BATCH, replace=False), rng,
                       N_FRAMES)
    dae = random_dae(BATCH, cuda) if "perceptual" in cfg.loss_names else None
    held = draw_corruption(cfg, gen, BATCH, cuda) if cfg.use_dae else None

    def train():
        for _ in range(cfg.grad_accum):
            train_step(model, opt, views, batch, gen, dae)
    return [(f"train_step of {name}", train),
            (f"eval_step of {name}",
             lambda: eval_step(model, views, batch, held, dae))], \
        (model, opt, gen)


SYNC_CONFIGS = ("autoencoder", "priors", "triplet", "autoencoder-bf16",
                "triplet-bf16", "mlp", "dae", "perceptual", "episode-prior",
                "grad-accum")


@pytest.mark.parametrize("name", SYNC_CONFIGS)
def test_steps_do_not_synchronise(cuda, views, name):
    """Configs 1, 3 and 5, configs 1 and 5 at ``--dtype bfloat16``,
    config 1's loss on the mlp, the DAE, the perceptual loss, the episode
    prior and ``--grad-accum 4``: a whole train step and eval step
    complete without a synchronise. Each runs once before, outside the
    mode, for its first-use work (the build, cuDNN's plans, Adam's
    state)."""
    calls, _ = step_calls(name, views, cuda)
    for _, call in calls:
        call()
    assert_no_sync(calls)


@pytest.mark.parametrize("name", ["autoencoder", "triplet",
                                  "autoencoder-bf16", "triplet-bf16", "dae",
                                  "perceptual"])
def test_pools_read_their_batchnorm_outputs_in_place(cuda, views, name):
    """Each pool reads the NHWC view of its BatchNorm's output, which is
    the tensor itself (no copy) only if that output is channels_last in
    the model's compute dtype; that needs the encoder's input in NHWC, a
    DAE's corrupted frames too. One record a pool BatchNorm and encoder
    pass of a train step: obs, next obs where a loss reads it, and the
    triplet's positive and negative."""
    calls, (model, _, _) = step_calls(name, views, cuda)
    calls[0][1]()  # first-use work
    enc, cfg = model.encoder, model.cfg
    bns = list(enc.bns) if hasattr(enc, "bns") else [enc.bn1]
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    layouts = []
    hooks = [bn.register_forward_hook(lambda m, i, out: layouts.append(
        (out.is_contiguous(memory_format=torch.channels_last), out.dtype)))
        for bn in bns]
    try:
        calls[0][1]()
    finally:
        for h in hooks:
            h.remove()
    passes = (1 + cfg.needs_next_obs + 2 * cfg.use_triplet) * cfg.grad_accum
    assert layouts == [(True, dtype)] * (len(bns) * passes), layouts


def test_gather_from_a_host_index_does_not_synchronise(cuda, views):
    """K2 at the export and the training batch from a host index."""
    from srl_zoo_tpu_torch.ops.gather_norm import gather_normalize
    rng = np.random.RandomState(SEED)
    calls = [(f"K2 B={rows}", lambda rows=rows: gather_normalize(
        views["frames"], rng.randint(0, N_FRAMES, rows)))
        for rows in (256, BATCH)]
    for _, call in calls:
        call()
    assert_no_sync(calls)


def test_checkpoint_submits_do_not_synchronise(cuda, views, tmp_path,
                                               monkeypatch):
    """Config 5's ``AsyncCheckpointer.save_model`` and ``save_state``
    queue their snapshots without a synchronise (the worker's host
    copies wait until the mode is off)."""
    from srl_zoo_tpu_torch import checkpoint as ckpt
    calls, (model, opt, gen) = step_calls("triplet", views, cuda)
    calls[0][1]()  # Adam's state
    quiet = threading.Event()
    quiet.set()
    for f in ("write_train_state", "write_state_dict"):
        def gated(*args, fn=getattr(ckpt, f)):
            assert quiet.wait(60), "the sync check never ended"
            return fn(*args)
        monkeypatch.setattr(ckpt, f, gated)
    writers = []

    def submits():
        writers.append(ckpt.AsyncCheckpointer(str(tmp_path), cuda))
        writers[-1].save_model(model, model.state_dict())
        writers[-1].save_state(model, opt, gen, 1, 1, 0.5)
    try:
        submits()
        writers[-1].close()
        quiet.clear()
        assert_no_sync([("checkpoint submits of triplet", submits)])
    finally:
        quiet.set()
        for w in writers:
            w.close()


def step_limits(dev_of: dict, bf16: bool) -> dict:
    """The limit of each held measure of a card step: twice the CPU runs'
    largest deviation (the whole gradient and the stem where the step has
    them, else the worst tensor), and for a bf16 loss at least twice
    bfloat16's unit roundoff."""
    cpus = [d for run, d in dev_of.items() if run != "card"]
    held = ("loss", "l2", "stem_l2") if "stem_l2" in dev_of["card"] else (
        "loss", "worst")
    return {m: 2 * max(max(d[m] for d in cpus),
                       U_BF16 if bf16 and m == "loss" else 0.0)
            for m in held}


@pytest.mark.parametrize("name", [n for n, *_ in ALL_CONFIGS
                                  if n != "random"])
def test_card_step_matches_the_cpu_and_float64(cuda, name):
    """One train-mode forward + backward at 224 px, batch 8, from the same
    weights, frames (a second view where the config reads one), metadata,
    VAE noise, DAE corruption and frozen DAE, on the card (kernels), on
    the CPU (plain versions) and on the CPU in float64. At this geometry
    the train-mode BatchNorm backwards cancel heavily, and f32 gradients
    stray from float64 by ~1e-3 of their scale on either device, so the
    card's step is held to float64 within twice the CPU f32 step's
    deviation (+1e-5): its loss, and each gradient relative to its
    tensor's largest float64 magnitude (at least 1e-2 of the model's
    largest gradient), the worst tensor.

    A ResNet-18 step routes ReLU inputs within rounding of 0 by its order
    of summation, so it is held by the relative L2 deviation of the whole
    gradient and of the stem's tensors (conv1, bn1), against the larger
    of two CPU orders (all cores and one thread). A ``--dtype bfloat16``
    step is held the same way against the float32 config in float64,
    its loss limit at least twice bfloat16's unit roundoff; "stem" is then
    the encoder's first layer and its BatchNorm."""
    from srl_zoo_tpu_torch.training.state import make_model
    from srl_zoo_tpu_torch.training.train_step import (_inputs, _loss,
                                                       draw_corruption)
    tokens, kw = CONFIG[name]
    cfg = train_config(tokens, CPU_STEP_BATCH, kw)
    b = CPU_STEP_BATCH
    rng = np.random.RandomState(SEED)
    frames = torch.from_numpy(rng.randint(0, 256, (b + 1,) + IMG).astype(
        np.uint8))  # row b is the last row's next frame
    store = {"frames": frames, "frames_2": frames.flip(2, 3).contiguous()}
    batch = step_batch(np.arange(b), rng, b + 1)
    eps = torch.randn((2, b, STATE_DIM),
                      generator=torch.Generator().manual_seed(SEED))
    corruption = draw_corruption(cfg, torch.Generator().manual_seed(SEED),
                                 b, "cpu") if cfg.use_dae else None
    host = torch.device("cpu")
    dae = random_dae(b, host) if "perceptual" in cfg.loss_names else None
    cpu = make_model(cfg, host)
    bf16 = cfg.compute_dtype == "bfloat16"
    whole = cfg.model_type == "resnet" or bf16
    runs = [("card", copy.deepcopy(cpu).to(
        cuda, memory_format=torch.channels_last), cuda, torch.float32, 0),
        ("cpu", copy.deepcopy(cpu), host, torch.float32, 0)]
    if whole:
        runs.append(("cpu, one thread", copy.deepcopy(cpu), host,
                     torch.float32, 1))
    f64 = make_model(cfg.replace(compute_dtype="float32"), host)
    f64.load_state_dict(cpu.state_dict())
    runs.append(("f64", f64.double(), host, torch.float64, 0))
    res = {}
    threads = torch.get_num_threads()
    try:
        for run, model, d, dt, n_threads in runs:
            torch.set_num_threads(n_threads or threads)
            model.train()
            inputs = _inputs(model, {k: v.to(d) for k, v in store.items()},
                             batch)
            for k in ("obs", "next_obs", "pos_obs", "neg_obs"):
                if inputs[k] is not None:
                    inputs[k] = inputs[k].to(dt)
            if cfg.use_vae:
                inputs["noise"] = {"state": eps[0].to(d, dt),
                                   "next_state": eps[1].to(d, dt)}
            if corruption is not None:
                inputs["corruption"] = tuple(c.to(d) for c in corruption) \
                    if isinstance(corruption, tuple) \
                    else corruption.to(d, dt)
            frozen = None if dae is None else copy.deepcopy(dae).to(d, dt)
            loss = _loss(model, inputs, frozen)[0]
            loss.backward()
            res[run] = (float(loss.detach()),
                        {k: p.grad.detach().double().cpu()
                         for k, p in model.named_parameters()})
    finally:
        torch.set_num_threads(threads)
    l64, g64 = res.pop("f64")
    floor = 1e-2 * max(float(v.abs().max()) for v in g64.values())

    def rel_l2(grads, keys) -> float:
        return float(torch.cat([(grads[k] - g64[k]).ravel() for k in keys])
                     .norm() / torch.cat([g64[k].ravel() for k in keys])
                     .norm())

    stem = [k for k in g64 if k.startswith(STEMS[cfg.model_type])] \
        if whole else []
    dev_of = {}
    for run, (loss, grads) in res.items():
        dev_of[run] = {"loss": abs(loss - l64) / abs(l64), "worst": max(
            float((grads[k] - g64[k]).abs().max())
            / max(float(g64[k].abs().max()), floor) for k in g64),
            "l2": rel_l2(grads, list(g64))}
        if stem:
            dev_of[run]["stem_l2"] = rel_l2(grads, stem)
    limits = step_limits(dev_of, bf16)
    over = [m for m in limits if dev_of["card"][m] > limits[m] + 1e-5]
    assert not over, (over, dev_of)
