"""The epoch runner's CUDA graphs (srl_zoo_tpu_torch/training/epoch.py)
with cuDNN's timed plan choice on (``use_strict_float32`` sets
``cudnn.benchmark``): config 1 at 224 px, whose convolutions each search
their plan in the runner's eager warm-up, before the capture, held bit
for bit against the per-step eager loop; then, on the two-camera
training dataset with both views resident, configs 1 and 5 in f32 and
bf16, the DAE and the VAE (random draws in the step), config 3 (pairs),
``--grad-accum 4`` (two graphs) and config 3's hot phase on a hybrid
store of 2,048 rows (by slot): replays against the eager steps, a
replayed phase without a synchronise, and a traced phase whose kernel
launches equal the launch counters.

Where replays are held against eager steps, cuDNN runs its
deterministic plans: its default weight gradients add in a varying
order, and two eager runs then part. Every test here needs a CUDA device
and skips without one; this file imports no JAX, so on the card it runs
alone:

    python -m pytest --noconftest -p no:cacheprovider -q -m chip \\
        tests/test_torch_zoo_epoch_card.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from srl_zoo_tpu_torch.config import SRLConfig, parse_loss_arguments
from torch_card_lib import cuda, train_data  # noqa: F401 (fixtures)
from torch_card_lib import (BF16, HYBRID_ROWS, RESNET_VIEWS, SEED, TRACED,
                            assert_no_sync, launches, train_config)

IMG = 224
STATE_DIM = 200
BATCH = 32
ROWS = 256
TRAIN_REPLAYS = 8
EVAL_REPLAYS = 3


@pytest.fixture
def strict_deterministic():
    """``use_strict_float32`` with cuDNN's deterministic plans, the
    process's switches restored after."""
    from srl_zoo_tpu_torch.utils.device import use_strict_float32
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    switches = ((cudnn, "benchmark"), (cudnn, "deterministic"),
                (cudnn, "allow_tf32"), (matmul, "allow_tf32"),
                (matmul, "allow_bf16_reduced_precision_reduction"))
    saved = [getattr(owner, name) for owner, name in switches]
    use_strict_float32()
    cudnn.deterministic = True
    try:
        yield
    finally:
        for (owner, name), value in zip(switches, saved):
            setattr(owner, name, value)


def _config_1() -> SRLConfig:
    losses, splits = parse_loss_arguments(["autoencoder"], STATE_DIM)
    return SRLConfig(state_dim=STATE_DIM, img_height=IMG, img_width=IMG,
                     batch_size=BATCH, seed=0, losses=tuple(losses.items()),
                     split_dims=tuple(splits.items()), n_actions=4,
                     n_reward_classes=2)


def _batches(n: int, rng) -> list:
    return [{"indices": rng.choice(ROWS, BATCH, replace=False),
             "valid": np.ones(BATCH, np.float32)} for _ in range(n)]


def _unequal(pairs) -> list:
    """The names of the pairs (name, a, b) that differ in any bit."""
    return [name for name, a, b in pairs if not torch.equal(a, b)]


@pytest.mark.chip
def test_captured_steps_equal_the_eager_loop_with_timed_plans(
        cuda, strict_deterministic):
    """A train phase of one eager warm-up step and 8 replays, then an
    eval phase of one warm-up step and 3 replays, against ``train_step``
    and ``eval_step`` run eagerly from the same weights on the same
    batches: every step's metrics, every parameter, buffer and Adam
    state, bit for bit; each phase captured once, and the capture
    raised nothing; the decoder's last layer ran on K5 in every step."""
    from srl_zoo_tpu_torch.training.epoch import EpochRunner
    from srl_zoo_tpu_torch.training.learner import stack_batches
    from srl_zoo_tpu_torch.training.state import make_model, make_optimizer
    from srl_zoo_tpu_torch.training.train_step import eval_step, train_step
    assert torch.backends.cudnn.benchmark
    cfg = _config_1()
    gen = torch.Generator(device=cuda).manual_seed(1)
    store = {"frames": torch.randint(0, 256, (ROWS, IMG, IMG, 3),
                                     dtype=torch.uint8, device=cuda,
                                     generator=gen)}
    rng = np.random.default_rng(2)
    train = _batches(1 + TRAIN_REPLAYS, rng)
    val = _batches(1 + EVAL_REPLAYS, rng)

    def fresh():
        model = make_model(cfg, cuda)
        return (model, make_optimizer(cfg, model),
                torch.Generator(device=cuda).manual_seed(3))

    m1, o1, g1 = fresh()
    eager_train = [train_step(m1, o1, store, b, g1) for b in train]
    eager_val = [eval_step(m1, store, b) for b in val]
    m2, o2, g2 = fresh()
    runner = EpochRunner(m2, o2, g2)
    with launches() as ran:
        got_train = runner.train_epoch(store, stack_batches(train, cfg,
                                                            ROWS))
        got_val = runner.eval_epoch(store, stack_batches(val, cfg, ROWS))
        torch.cuda.synchronize()

    assert runner.counts() == {"eager_steps": 2,
                               "replays": TRAIN_REPLAYS + EVAL_REPLAYS,
                               "captures": 2}
    # the decoder's last layer on K5, counted once a step, replays too
    assert (ran["deconv_out_tanh"], ran["deconv_out_tanh_bwd"]) == (
        1 + TRAIN_REPLAYS + 1 + EVAL_REPLAYS, 1 + TRAIN_REPLAYS), ran
    pairs = []
    for phase, eager, got in (("train", eager_train, got_train),
                              ("eval", eager_val, got_val)):
        assert set(got) == set(eager[0])
        pairs += [(f"{phase} metric {k}",
                   torch.stack([m[k] for m in eager]).float(), got[k])
                  for k in got]
    pairs += [(f"parameter {n}", p, q) for (n, p), (_, q) in zip(
        m1.named_parameters(), m2.named_parameters())]
    pairs += [(f"buffer {n}", p, q) for (n, p), (_, q) in zip(
        m1.named_buffers(), m2.named_buffers())]
    for i, (a1, a2) in enumerate(zip(o1.adams, o2.adams)):
        for p1, p2 in zip(a1.param_groups[0]["params"],
                          a2.param_groups[0]["params"]):
            pairs += [(f"adam {i} {k}", v, a2.state[p2][k])
                      for k, v in a1.state[p1].items()]
    pairs.append(("generator state", g1.get_state(), g2.get_state()))
    assert len(pairs) > 40
    bad = _unequal(pairs)
    assert bad == [], bad


# ---------------------------------------------------------------------------
# on the training dataset
# ---------------------------------------------------------------------------

# name, --losses tokens and config fields
EPOCH_CASES = {
    "autoencoder": (("autoencoder",), {}),
    "autoencoder-bf16": (("autoencoder",), BF16),
    "triplet": (("triplet",), RESNET_VIEWS),
    "triplet-bf16": (("triplet",), {**RESNET_VIEWS, **BF16}),
    "dae": (("dae",), {}),
    "vae": (("vae",), {"beta": 0.5}),
    "priors": (("priors",), {}),
    "grad-accum": (("autoencoder",), {"grad_accum": 4}),
    "hybrid": (("priors",), {}),  # the hot phase of a hybrid store
}
# where capture and eager are shown to differ: the allowed deviation, of
# a tensor's largest magnitude
EPOCH_TOL = 1e-6


@pytest.fixture(scope="module")
def resident(cuda, train_data):
    """The training dataset and both its views resident on the card."""
    from srl_zoo_tpu_torch.data.device_cache import build_cache
    from srl_zoo_tpu_torch.data.schema import load_dataset
    dataset = load_dataset(train_data)
    return dataset, build_cache(dataset, cuda, second_view=True)


def _case(name: str, resident, cuda):
    """The config of case ``name``, its store, an endless cycle of a
    training epoch's batches (by slot on the hybrid store's trainable
    rows), the store's rows and a fresh (model, optimizer, generator)
    maker."""
    import itertools
    from srl_zoo_tpu_torch.data.device_cache import store_rows
    from srl_zoo_tpu_torch.data.loader import DataLoader, batch_flags
    from srl_zoo_tpu_torch.training.state import make_model, make_optimizer
    dataset, store = resident
    tokens, kw = EPOCH_CASES[name]
    cfg = train_config(tokens, BATCH, kw)
    rows, slots = np.arange(dataset.n_samples - 1), None
    if name == "hybrid":
        from srl_zoo_tpu_torch.data.hybrid import RotatingHotStore
        hot = RotatingHotStore(dataset, cuda, cfg, HYBRID_ROWS,
                               second_view=cfg.needs_second_view)
        store, slots, rows = hot.cache, hot.slot_of, \
            rows[hot.trainable_mask(rows)]
    pool = itertools.cycle(list(DataLoader(dataset, rows, BATCH, seed=SEED,
                                           slot_map=slots,
                                           **batch_flags(cfg))))

    def fresh():
        model = make_model(cfg, cuda)
        return (model, make_optimizer(cfg, model),
                torch.Generator(device=cuda).manual_seed(SEED))
    return cfg, store, pool, store_rows(store), fresh


def _take(pool, n: int) -> list:
    return [next(pool) for _ in range(n)]


@pytest.mark.chip
@pytest.mark.parametrize("name", [n for n in EPOCH_CASES
                                  if n != "autoencoder"])
def test_replays_equal_the_eager_steps_on_the_dataset(
        cuda, resident, strict_deterministic, name):
    """From the same seeded state: a train phase whose first step (the
    first 4 under ``--grad-accum 4``) runs eagerly before the capture and
    whose next 8 steps are replays, against the same steps of the
    per-step ``train_step``: every per-step metric, parameter, buffer,
    Adam state and the generator's state (so its draws) equal, or within
    1e-6 of the tensor's largest magnitude where capture and eager
    differ. (Config 1 is held bit for bit, with an eval phase, by
    ``test_captured_steps_equal_the_eager_loop_with_timed_plans``.)"""
    from srl_zoo_tpu_torch.training.epoch import EpochRunner
    from srl_zoo_tpu_torch.training.learner import stack_batches
    from srl_zoo_tpu_torch.training.train_step import train_step
    cfg, store, pool, n_rows, fresh = _case(name, resident, cuda)
    warm = cfg.grad_accum  # eager steps before the capture
    batches = _take(pool, warm + TRAIN_REPLAYS)
    m1, o1, g1 = fresh()
    eager = [train_step(m1, o1, store, b, g1) for b in batches]
    m2, o2, g2 = fresh()
    runner = EpochRunner(m2, o2, g2)
    got = runner.train_epoch(store, stack_batches(batches, cfg, n_rows))
    torch.cuda.synchronize()
    assert (runner.eager_steps, runner.replays, runner.captures) == (
        warm, TRAIN_REPLAYS, 1 + (warm > 1)), runner.counts()
    pairs = [(f"metric {k}", torch.stack([m[k] for m in eager]).float(),
              got[k]) for k in got]
    pairs += [(f"parameter {n}", p, q) for (n, p), (_, q) in zip(
        m1.named_parameters(), m2.named_parameters())]
    pairs += [(f"buffer {n}", p, q) for (n, p), (_, q) in zip(
        m1.named_buffers(), m2.named_buffers())]
    for i, (a1, a2) in enumerate(zip(o1.adams, o2.adams)):
        for p1, p2 in zip(a1.param_groups[0]["params"],
                          a2.param_groups[0]["params"]):
            pairs += [(f"adam {i} {k}", v, a2.state[p2][k])
                      for k, v in a1.state[p1].items()]
    pairs.append(("generator state", g1.get_state(), g2.get_state()))
    over = []
    for what in _unequal(pairs):
        a, b = next((a.double(), b.double()) for n, a, b in pairs
                    if n == what)
        dev = float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))
        if dev > EPOCH_TOL:
            over.append((what, dev))
    assert over == [], over


@pytest.mark.chip
@pytest.mark.parametrize("name", EPOCH_CASES)
def test_replayed_phases_do_not_synchronise_and_trace_their_launches(
        cuda, resident, name):
    """On cuDNN's default plans, as the learner runs: a runner warmed by
    one phase, then a phase of 8 replays under
    ``torch.cuda.set_sync_debug_mode("error")``, then a traced phase of 8
    replays (after a phase in the profiler's warm-up) whose K1f, K1b and
    K2 launches in the trace equal the launch counters (a captured launch
    counts once a replay). CUPTI now and then drops a kernel record, so a
    trace with other counts is taken again, up to three times. No phase
    after the first captures."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from srl_zoo_tpu_torch.training.epoch import EpochRunner
    from srl_zoo_tpu_torch.training.learner import stack_batches
    cfg, store, pool, n_rows, fresh = _case(name, resident, cuda)
    warm = cfg.grad_accum
    runner = EpochRunner(*fresh())

    def phase(n: int):
        return stack_batches(_take(pool, n), cfg, n_rows)
    runner.train_epoch(store, phase(warm + TRAIN_REPLAYS))
    captured = runner.captures
    stacked = phase(TRAIN_REPLAYS)
    assert_no_sync([(f"a replayed phase of {name}",
                     lambda: runner.train_epoch(store, stacked))])
    tries = []
    for _ in range(3):
        first, stacked = phase(warm), phase(TRAIN_REPLAYS)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            runner.train_epoch(store, first)
            torch.cuda.synchronize()
            prof.step()
            with launches() as counted:
                runner.train_epoch(store, stacked)
                torch.cuda.synchronize()
            prof.step()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        traced = {k: sum(e.count for e in kernels if key in e.key)
                  for k, key in TRACED.items()}
        tries.append((traced, {k: counted[k] for k in TRACED}))
        if traced == tries[-1][1] and all(traced.values()):
            break
    else:
        raise AssertionError(f"traced against counted launches: {tries}")
    assert runner.captures == captured, runner.counts()
