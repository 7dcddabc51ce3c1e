"""The epoch runner's CUDA graphs (srl_zoo_tpu_torch/training/epoch.py)
with cuDNN's timed plan choice on (``use_strict_float32`` sets
``cudnn.benchmark``): config 1 at 224 px, whose convolutions each search
their plan in the runner's eager warm-up, before the capture, held bit
for bit against the per-step eager loop.

cuDNN runs its deterministic plans here, as chip_smoke's phase 4e runs
them: its default weight gradients add in a varying order, and two eager
runs then part. Every test here needs a CUDA device and skips without
one; this file imports no JAX, so on the card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q -m chip \\
        tests/test_torch_zoo_epoch_card.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from srl_zoo_tpu_torch.config import SRLConfig, parse_loss_arguments

IMG = 224
STATE_DIM = 200
BATCH = 32
ROWS = 256
TRAIN_REPLAYS = 8
EVAL_REPLAYS = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


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
    raised nothing."""
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
    got_train = runner.train_epoch(store, stack_batches(train, cfg, ROWS))
    got_val = runner.eval_epoch(store, stack_batches(val, cfg, ROWS))
    torch.cuda.synchronize()

    assert runner.counts() == {"eager_steps": 2,
                               "replays": TRAIN_REPLAYS + EVAL_REPLAYS,
                               "captures": 2}
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
