"""The port's whole-epoch runner of the cached phases
(``srl_zoo_tpu_torch/training/epoch.py``: JAX's ``train_epoch`` /
``eval_epoch``), K2's device-index form and the launch counters of
captured steps, on the CPU at 32 px (state_dim 4, 8 for the configs with
heads, batch 16), where the runner runs its static-input steps eagerly.

Tolerances, each with its reason:

* the runner against the port's per-step loop: bit for bit (the same
  operations on the same inputs, in the same order; the learner's epoch
  means, its exported model and its optimizer state);
* the runner against JAX's ``train_epoch`` / ``eval_epoch`` over the same
  stacked batches (five train steps, which JAX pads to a bucket of six and
  skips the sixth), config 1 and the priors in float32, config 5 with its
  ResNet-18 encoder in float64 (float32 there routes a ReLU or pool input
  within rounding of its switch point one way in one package and the
  other way in the other, test_torch_zoo_train.py): each validation
  step's metrics on the initial weights within 1e-6 relative, the first
  train step's loss within 1e-5 relative, and each parameter after the
  epoch within lr a step of JAX's. Adam moves an element whose gradient
  sits at rounding level (a bias in front of BatchNorm, the priors'
  shift-invariant bias) by about lr in the direction of its noise in
  either package, and the later steps carry those moves on, so the same
  epoch is also run at lr 0, where the parameters stay and BatchNorm's
  statistics and Adam's moments move: every step's metrics within 1e-5
  relative, the running statistics within 1e-5, the parameters exactly;
* K2's device-index form against the host-index form: exact;
* a resumed run against a straight one: bit for bit;
* the launch counters: exact counts.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_zoo_tpu_torch import bridge
from srl_zoo_tpu_torch.config import SRLConfig
from test_torch_zoo_train import (_jax_state, _jcfg,  # noqa: F401
                                  _np_batch, _one_torch_thread,
                                  _port_model, _second_view,
                                  two_pass_bn_variance)

BS = 16
STATE_DIM = 4


# ---------------------------------------------------------------------------
# (a) the runner against the port's per-step loop, through the learner
# ---------------------------------------------------------------------------

# name: (--losses with split dims, config fields, dataset, hybrid rows)
LOOP_CASES = {
    "autoencoder": ((("autoencoder", -1),), {}, "one", None),
    "vae": ((("vae", -1),), {}, "one", None),
    "dae": ((("dae", -1),), {}, "one", None),
    "dae-gaussian": ((("dae", -1),), {"noise_type": "gaussian",
                                      "noise_std": 0.3}, "one", None),
    "priors": ((("priors", -1),), {}, "one", None),
    "splits": ((("autoencoder", 4), ("inverse", 2), ("forward", 1),
                ("reward", 1)), {"state_dim": 8}, "one", None),
    "episode-prior": ((("episode-prior", -1), ("autoencoder", -1)), {},
                      "one", None),
    "triplet": ((("triplet", -1),), {"model_type": "resnet",
                                     "multi_view": True}, "two", None),
    "grad-accum": ((("autoencoder", -1),), {"grad_accum": 3}, "one", None),
    "hybrid": ((("priors", -1),), {"device_cache": "hybrid"}, "one", 40),
}


def _cfg(losses, **kw) -> SRLConfig:
    fields = {"state_dim": STATE_DIM, "img_height": 32, "img_width": 32,
              "batch_size": BS, "n_actions": 4, "n_reward_classes": 3,
              "epochs": 2, "seed": 3, "learning_rate": 1e-3, "num_cpu": 2,
              # 39 training rows (three steps an epoch, the last wrapped)
              # and 9 validation rows (one padded step)
              "training_set_size": 48,
              "losses": tuple((n, 1.0) for n, _ in losses),
              "split_dims": tuple(losses)}
    return SRLConfig(**(fields | kw))


def _learn(cfg, folder, log, monkeypatch, per_step=False, resume=False,
           hot_n=None):
    """A learner's run of ``cfg`` on the CPU: the learner, its returned
    validation metrics and its loss history. ``per_step`` makes every
    phase take the per-step loop."""
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    with monkeypatch.context() as mp:
        if per_step:
            mp.setattr(SRL4robotics, "_whole", lambda self, cached: False)
        if hot_n:
            views = 2 if cfg.needs_second_view else 1
            mp.setenv("SRL_ZOO_CACHE_BUDGET_MB",
                      str((hot_n + 0.5) * 32 * 32 * 3 * views / 2**20))
        learner = SRL4robotics(cfg, log_folder=log, device="cpu")
        with _one_torch_thread():
            val = learner.learn(load_dataset(folder), resume=resume)
    history = np.load(os.path.join(log, "loss_history.npz"))
    return learner, val, {k: history[k] for k in history.files}


def _assert_same_run(a, b):
    """Two learner runs equal bit for bit: the validation metrics, the
    loss history, the model and the optimizer state."""
    (la, va, ha), (lb, vb, hb) = a, b
    assert va == vb
    assert set(ha) == set(hb)
    for k in ha:
        np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)
    sa, sb = la.model.state_dict(), lb.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = la.optimizer.state_dict(), lb.optimizer.state_dict()
    assert oa["micro_step"] == ob["micro_step"]
    for adam_a, adam_b in zip(oa["adams"], ob["adams"]):
        for i, st in adam_a["state"].items():
            for k, v in st.items():
                assert torch.equal(v, adam_b["state"][i][k]), (i, k)


@pytest.mark.parametrize("name", list(LOOP_CASES))
def test_runner_equals_the_per_step_loop(name, synthetic_dataset,
                                         synthetic_dataset_mv, tmp_path,
                                         monkeypatch):
    """Two epochs of the learner with its cached phases through the
    runner, and again with every phase through the per-step loop: equal
    bit for bit. The hybrid case runs its hot phases through the runner
    and its cold ones through the loop, adopting between them."""
    losses, extra, data, hot_n = LOOP_CASES[name]
    folder = (synthetic_dataset_mv if data == "two"
              else synthetic_dataset).data_folder
    cfg = _cfg(losses, **extra)
    whole = _learn(cfg, folder, str(tmp_path / "whole"), monkeypatch,
                   hot_n=hot_n)
    loop = _learn(cfg, folder, str(tmp_path / "loop"), monkeypatch,
                  per_step=True, hot_n=hot_n)
    _assert_same_run(whole, loop)
    runner = whole[0].runner
    assert runner.eager_steps > 0 and runner.replays == 0
    assert loop[0].runner.eager_steps == 0
    if hot_n:
        assert whole[0]._hot_store.hot_n == hot_n
        assert whole[0].loop_steps > 0  # the cold phases
    else:
        assert whole[0].loop_steps == 0


def test_resumed_runner_run_equals_a_straight_one(synthetic_dataset,
                                                  tmp_path, monkeypatch):
    """Three epochs with ``--grad-accum 4`` (three train steps an epoch,
    so the first two end inside a cycle) against one epoch, then one more and
    then the last, each resumed from the runner's checkpoint: bit for
    bit."""
    cfg = _cfg((("autoencoder", -1),), grad_accum=4, epochs=3)
    folder = synthetic_dataset.data_folder
    straight = _learn(cfg, folder, str(tmp_path / "straight"), monkeypatch)
    log = str(tmp_path / "resumed")
    for epochs in (1, 2):
        learner, _, _ = _learn(cfg.replace(epochs=epochs), folder, log,
                               monkeypatch, resume=epochs > 1)
        assert learner.optimizer.micro_step != 0
    resumed = _learn(cfg, folder, log, monkeypatch, resume=True)
    _assert_same_run(straight, resumed)


def test_optimizer_state_resumes_across_adam_forms():
    """A state saved by the CPU's Adams loads into capturable ones (the
    card's: the saved groups' ``capturable`` would otherwise switch them
    off, and the capture of their step would fail) and back: each keeps
    its form, the step counts and moments as saved. On the CPU a
    capturable Adam cannot step, so its form is set by hand here."""
    from srl_zoo_tpu_torch.training.state import AccumulatingAdam
    cfg = _cfg((("autoencoder", -1),), grad_accum=2)
    model = torch.nn.Linear(3, 2)
    plain = AccumulatingAdam(cfg, model)
    for _ in range(3):
        plain.backward(model(torch.ones(4, 3)).square().sum())
        plain.step()
    saved = plain.state_dict()
    capturable = AccumulatingAdam(cfg, model)
    capturable.capturable = True
    capturable.adams = [torch.optim.Adam(model.parameters(), lr=1e-3,
                                         capturable=True)]
    capturable.load_state_dict(saved)
    back = AccumulatingAdam(cfg, torch.nn.Linear(3, 2))
    back.load_state_dict(capturable.state_dict())
    for opt, form in ((capturable, True), (back, False)):
        assert opt.micro_step == plain.micro_step == 1
        assert all(g["capturable"] is form
                   for g in opt.adams[0].param_groups)
        for i, st in opt.adams[0].state_dict()["state"].items():
            want = saved["adams"][0]["state"][i]
            assert st["step"].dtype == torch.float32 and \
                float(st["step"]) == float(want["step"]) == 1.0
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(st[k], want[k])


# ---------------------------------------------------------------------------
# (b) which phases go through the runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "off"])
def test_cached_phases_take_the_runner_streamed_ones_the_loop(
        mode, synthetic_dataset, tmp_path, monkeypatch):
    """Counted steps: with the whole store every train and validation step
    runs in the runner and none in the loop; streamed, none in the runner
    (the hybrid store's split is held by the loop-equality test)."""
    cfg = _cfg((("autoencoder", -1),), device_cache=mode)
    learner, _, history = _learn(cfg, synthetic_dataset.data_folder,
                                 str(tmp_path / "run"), monkeypatch)
    from srl_zoo_tpu_torch.training.learner import split_indices
    from srl_zoo_tpu_torch.data.schema import load_dataset
    train, val = split_indices(load_dataset(synthetic_dataset.data_folder),
                               cfg)
    steps = cfg.epochs * (-(-len(train) // BS) + -(-len(val) // BS))
    ran = (learner.runner.eager_steps, learner.loop_steps)
    assert ran == ((steps, 0) if mode == "auto" else (0, steps))
    assert len(history["train/total"]) == cfg.epochs


def test_process_group_keeps_the_per_step_loop(monkeypatch):
    """In a process group no phase runs through the runner (capturing the
    group's step with its collectives is ROADMAP A14b); without one the
    cached phases do."""
    from srl_zoo_tpu_torch.parallel import mesh
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    learner = SRL4robotics(_cfg((("autoencoder", -1),)), device="cpu")
    assert learner._whole(True) and not learner._whole(False)
    monkeypatch.setattr(mesh, "active", lambda: True)
    assert not learner._whole(True) and not learner._whole(False)


# ---------------------------------------------------------------------------
# (c) K2's device-index form, and the range check at stacking
# ---------------------------------------------------------------------------

def test_gather_device_index_equals_host_index():
    from srl_zoo_tpu_torch.ops.gather_norm import (gather_normalize,
                                                   gather_normalize_device)
    rng = np.random.RandomState(5)
    for c in (3, 6):
        frames = torch.from_numpy(rng.randint(0, 256, (20, 9, 13, c)
                                              ).astype(np.uint8))
        idx = rng.randint(0, 20, 7)
        for mode in ("tf", "image_net"):
            want = gather_normalize(frames, idx, mode)
            got = gather_normalize_device(frames, torch.from_numpy(idx),
                                          mode)
            assert got.dtype == torch.float32
            assert torch.equal(got, want)
    with pytest.raises(ValueError, match="int64"):
        gather_normalize_device(frames, torch.from_numpy(idx).int())
    with pytest.raises(ValueError, match="device"):
        gather_normalize_device(frames.to("meta"), torch.zeros(1).long())


@pytest.mark.parametrize("key", ["indices", "neg_indices",
                                 "same_action_partners"])
def test_out_of_range_row_is_refused_at_stacking(key, monkeypatch):
    """An index batch with a row outside the store (or a pair partner
    outside the batch) raises IndexError at stacking, before anything
    gathers."""
    from srl_zoo_tpu_torch.ops import gather_norm
    from srl_zoo_tpu_torch.training.learner import stack_batches
    cfg = _cfg((("triplet", -1), ("priors", -1)), model_type="resnet",
               multi_view=True)
    rng = np.random.RandomState(6)
    actions = rng.randint(0, 4, 40).astype(np.int32)
    rewards = rng.randint(0, 3, 40).astype(np.int32)
    batches = [_np_batch(rng.choice(40, BS, replace=False), actions,
                         rewards, rng) for _ in range(3)]
    for b in batches:
        b["neg_indices"] = rng.randint(0, 40, BS).astype(np.int32)
    stacked = stack_batches(batches, cfg, 40)
    assert stacked["rows"].shape == (3, BS)
    np.testing.assert_array_equal(stacked["next_rows"],
                                  np.minimum(stacked["rows"] + 1, 39))
    calls = []
    monkeypatch.setattr(gather_norm, "_launch", calls.append)
    batches[2][key] = batches[2][key].copy()
    batches[2][key][3] = 40 if key.endswith("indices") else BS
    with pytest.raises(IndexError):
        stack_batches(batches, cfg, 40)
    assert not calls


# ---------------------------------------------------------------------------
# (d) launch counters of captured launches
# ---------------------------------------------------------------------------

def test_captured_launches_count_once_per_replay():
    """Through stand-in wrappers: a launch counts on its wrapper at once,
    a launch inside ``tally_launches`` (a capture) only when the tally is
    replayed, times the replays; a nested tally takes the launches of its
    own capture."""
    from srl_zoo_tpu_torch.ops import _build

    def pool():
        """stand-in"""

    def gather():
        """stand-in"""
    pool.launches = pool.vector_launches = pool.bf16_launches = 0
    gather.launches = gather.vector_launches = 0
    _build.count(pool, launches=1, vector_launches=True, bf16_launches=0)
    with _build.tally_launches() as tally:
        for _ in range(3):  # a captured step: three pools, one gather
            _build.count(pool, launches=1, vector_launches=True,
                         bf16_launches=True)
        _build.count(gather, launches=1, vector_launches=False)
        with _build.tally_launches() as inner:
            _build.count(gather, launches=1, vector_launches=True)
    assert (pool.launches, pool.vector_launches, pool.bf16_launches) == \
        (1, 1, 0)
    assert gather.launches == 0
    tally.replayed(7)
    assert (pool.launches, pool.vector_launches, pool.bf16_launches) == \
        (1 + 21, 1 + 21, 21)
    assert (gather.launches, gather.vector_launches) == (7, 0)
    inner.replayed(2)
    assert (gather.launches, gather.vector_launches) == (9, 2)
    _build.count(gather, launches=1, vector_launches=True)
    assert (gather.launches, gather.vector_launches) == (10, 3)


def test_wrappers_count_once_per_replay(monkeypatch):
    """K1f's, K1b's and K2's wrappers, their launches stood in for (the
    build, the launch and the card's SM count replaced, and device-less
    meta tensors where the card's would be): called inside a capture's
    tally they leave their counters alone, and each replay of the tally
    adds one launch of each, on the vector path, the pools in bf16."""
    from srl_zoo_tpu_torch.ops import _build, fused_pool, gather_norm
    launched = []
    monkeypatch.setattr(_build, "entry", lambda *a: None)
    monkeypatch.setattr(_build, "launch",
                        lambda fn, t, *args: launched.append(t) or 0)
    monkeypatch.setattr(_build, "sm_count", lambda i: 132)
    monkeypatch.setattr(fused_pool, "_check_cuda", lambda *a: None)
    x = torch.empty((2, 16, 16, 64), dtype=torch.bfloat16, device="meta")
    frames = torch.empty((9, 8, 8, 3), dtype=torch.uint8, device="meta")
    counters = {fn: {k: getattr(fn, k) for k in ("launches",
                                                  "vector_launches")}
                for fn in (fused_pool.relu_max_pool,
                           fused_pool.relu_max_pool_bwd,
                           gather_norm.gather_normalize)}
    with _build.tally_launches() as tally:
        y, idx = fused_pool._fwd_kernel(x, "SAME", True)
        fused_pool.relu_max_pool_bwd(torch.empty_like(y), idx, x.shape)
        gather_norm._launch(frames, torch.empty(4, dtype=torch.int64,
                                                device="meta"), "tf")
    assert len(launched) == 3
    for fn, was in counters.items():
        assert {k: getattr(fn, k) for k in was} == was
    tally.replayed(5)
    for fn, was in counters.items():
        assert {k: getattr(fn, k) - n for k, n in was.items()} == \
            {"launches": 5, "vector_launches": 5}
    assert fused_pool.relu_max_pool.bf16_launches >= 5


# ---------------------------------------------------------------------------
# (e) against JAX's train_epoch / eval_epoch
# ---------------------------------------------------------------------------

N_TRAIN, N_VAL = 5, 3  # JAX pads 5 steps to its bucket of 6


def _batches(name, frames, jcfg):
    """Five train batches and three validation batches (the last with
    three padded rows), with the config's metadata."""
    rng = np.random.RandomState(21)
    n = len(frames)
    actions = rng.randint(0, 4, n).astype(np.int32)
    rewards = rng.randint(0, 3, n).astype(np.int32)
    out = []
    for k in range(N_TRAIN + N_VAL):
        batch = _np_batch(rng.choice(n, BS, replace=False), actions,
                          rewards, rng if jcfg.use_priors else None)
        if jcfg.use_triplet:
            batch["neg_indices"] = rng.randint(0, n, BS).astype(np.int32)
        if k == N_TRAIN + N_VAL - 1:
            batch["valid"][-3:] = 0.0
        out.append(batch)
    return out[:N_TRAIN], out[N_TRAIN:]


def _jax_epochs(jcfg, jmodel, state, frames, train, val, float64, lrs):
    """JAX's per-step validation metrics on the initial weights, then for
    each learning rate of ``lrs`` its per-step train metrics and its state
    after the train epoch from those weights. The package's Adam
    (``training/state.py``: ``optax.adam(lr, b1=0.9, b2=0.999,
    eps=1e-8)``) takes its learning rate as a hyperparameter of its state,
    so that one compiled epoch serves every rate."""
    import optax
    from srl_zoo_tpu.models import srl_modules
    from srl_zoo_tpu.models.srl_modules import SRLModules as JaxModules
    from srl_zoo_tpu.training.learner import _stack_batches
    from srl_zoo_tpu.training.train_step import build_steps

    def run(state):
        model = JaxModules(jcfg) if float64 else jmodel
        tx = optax.inject_hyperparams(optax.adam)(
            learning_rate=jcfg.learning_rate, b1=0.9, b2=0.999, eps=1e-8)
        _, _, _, train_epoch, eval_epoch = build_steps(jcfg, model, tx)
        cache = {"frames": jnp.asarray(frames),
                 "frames_2": jnp.asarray(_second_view(frames))}
        key = jax.random.PRNGKey(0)
        up = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa
        stacked = _stack_batches(train)
        assert len(stacked["step_valid"]) == N_TRAIN + 1
        vstacked = _stack_batches(val)
        assert "step_valid" in vstacked and len(vstacked["valid"]) == N_VAL
        vm = eval_epoch(state, up(vstacked), key, cache)
        out = []
        for lr in lrs:
            fresh = jax.tree_util.tree_map(
                lambda v: jnp.array(v, copy=True), state)
            opt = tx.init(fresh.params)
            opt.hyperparams["learning_rate"] = jnp.asarray(
                lr, opt.hyperparams["learning_rate"].dtype)
            out.append(train_epoch(fresh.replace(opt_state=opt),
                                   up(stacked), key, cache))
        return jax.device_get((vm, out))
    if not float64:
        return run(state)
    make = srl_modules.make_encoder
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(srl_modules, "make_encoder", lambda *a, **k: make(
            *a, **{**k, "dtype": jnp.float64}))
        # the float64 encoder's statistics are float64: so are the skipped
        # step's, which lax.cond requires
        return run(state.replace(batch_stats=jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, jnp.float64), state.batch_stats)))


def _port_epochs(jcfg, state, frames, train, val, float64, monkeypatch,
                 lr=None):
    """The port's runner over the same batches, from the same weights:
    (per-step validation metrics, per-step train metrics, model, Adam)."""
    from srl_zoo_tpu_torch.ops import gather_norm
    from srl_zoo_tpu_torch.training.epoch import EpochRunner
    from srl_zoo_tpu_torch.training.learner import stack_batches
    from srl_zoo_tpu_torch.training.state import make_optimizer
    cfg, model = _port_model(jcfg, state)
    if lr is not None:
        cfg = cfg.replace(learning_rate=lr)
    if float64:
        # the encoder in float64, its input the float32 frames cast up
        model.double()
        plain = gather_norm.gather_normalize_plain
        monkeypatch.setattr(gather_norm, "gather_normalize_plain",
                            lambda *a: plain(*a).double())
    opt = make_optimizer(cfg, model)
    runner = EpochRunner(model, opt, torch.Generator().manual_seed(0))
    store = {"frames": torch.from_numpy(frames),
             "frames_2": torch.from_numpy(_second_view(frames))}
    with _one_torch_thread():
        vm = runner.eval_epoch(store, stack_batches(val, cfg, len(frames)))
        m = runner.train_epoch(store, stack_batches(train, cfg,
                                                    len(frames)))
    assert runner.eager_steps == N_TRAIN + N_VAL
    assert int(opt.adams[0].state_dict()["state"][0]["step"]) == N_TRAIN
    return vm, m, model, cfg


CONFIGS = ["autoencoder", "priors", "triplet"]
# encoder passes of a train step: the frames; with the priors the next
# frames; with the triplet the positives and the negatives
PASSES = {"autoencoder": 1, "priors": 2, "triplet": 3}


@pytest.mark.parametrize("name", CONFIGS)
def test_runner_matches_jax_train_and_eval_epoch(name, two_pass_bn_variance,
                                                 monkeypatch):
    """Validation (three steps, the last with three padded rows) on the
    initial weights, then a train epoch of five steps, which JAX pads to
    six and skips the sixth, from those weights at the config's learning
    rate and again at lr 0, in both packages (config 5's encoder in
    float64).

    At the config's rate: the validation steps' metrics and the first
    train step's loss against JAX's, and each parameter within lr a step
    of JAX's after the epoch (Adam moves an element whose gradient sits at
    rounding level by about lr in the direction of its noise; the later
    steps' losses carry those moves on). At lr 0 the parameters stay,
    BatchNorm's statistics and Adam's moments move: every train step's
    metrics within 1e-5 relative, the running statistics after the epoch
    within 1e-5, the parameters exactly, and each encoder BatchNorm's
    count one a pass of each real step."""
    frames = np.random.RandomState(17).randint(0, 256, (64, 32, 32, 3)
                                               ).astype(np.uint8)
    jcfg = _jcfg(name)
    jmodel, state, _ = _jax_state(jcfg, seed=2)
    train, val = _batches(name, frames, jcfg)
    float64 = jcfg.model_type == "resnet"
    lr = jcfg.learning_rate
    want_vm, ((new, want_m), (new0, want_m0)) = _jax_epochs(
        jcfg, jmodel, state, frames, train, val, float64, (lr, 0.0))
    for m, st in ((want_m, new), (want_m0, new0)):
        # the padded sixth step: skipped, zero metrics, no update
        assert float(m["_n_valid"][N_TRAIN]) == 0.0
        assert int(st.step) == N_TRAIN
    got_vm, got_m, model, _ = _port_epochs(jcfg, state, frames, train, val,
                                           float64, monkeypatch)
    assert set(got_vm) == set(want_vm)
    for k, v in want_vm.items():
        np.testing.assert_allclose(got_vm[k].numpy(), v, rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(got_vm["_n_valid"].numpy(),
                                  [BS, BS, BS - 3])
    np.testing.assert_allclose(float(got_m["total"][0]),
                               float(want_m["total"][0]), rtol=1e-5)
    want_sd, _ = bridge.state_dict_from_jax(new.params, new.batch_stats)
    deltas = np.concatenate([
        np.abs(p.detach().numpy() - want_sd[n].numpy()).ravel()
        for n, p in model.named_parameters()])
    assert deltas.max() <= N_TRAIN * lr, deltas.max()

    _, got_m0, model, _ = _port_epochs(jcfg, state, frames, train, val,
                                       float64, monkeypatch, lr=0.0)
    assert set(got_m0) == set(want_m0)
    for k, v in got_m0.items():
        np.testing.assert_allclose(v.numpy(), want_m0[k][:N_TRAIN],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    want_sd, _ = bridge.state_dict_from_jax(new0.params, new0.batch_stats)
    for n, t in model.named_buffers():
        if "running" in n:
            np.testing.assert_allclose(t.numpy(), want_sd[n].numpy(),
                                       rtol=0, atol=1e-5, err_msg=n)
        elif n.startswith("encoder."):
            assert int(t) == N_TRAIN * PASSES[name], (n, int(t))
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      want_sd[n].numpy(), err_msg=n)
