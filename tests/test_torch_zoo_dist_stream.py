"""Streaming and the hybrid store across processes (ROADMAP.md A8b), and
the store plan that every rank of a process group agrees on.

Two ``gloo`` ranks on the CPU (world size 2, one torch thread each) train
config 1 (autoencoder, state dim 8, batch 16, 8 rows a rank) for two
epochs at 32 px through the port's learner, from JAX's initial weights,
in each store mode in turn: the whole store (``on``), streamed from
``frames.npy`` (``off``, and ``off`` with ``--stream-overlap``), streamed
from the JPEGs of a folder without ``frames.npy`` (and, as its reference,
the whole store of a ``frames.npy`` decoded from those JPEGs), a rotating
hybrid store of 40 of the 96 rows, a static one, and the rotating one
resumed after its first epoch; then the triplet loss on two camera views
and the robotic priors (from the port's own initial weights) with the
whole store and streamed, the triplet also through a rotating hybrid
store. The ranks run once for the module
(``stream_runs``; one xdist worker computes them and the others read its
results). Tolerances, each with its reason:

* streamed against the whole store at world size 2: losses bit for bit
  (each rank's rows reach the same K2 arithmetic and the same model, as
  test_torch_zoo_data.py's
  ``test_streamed_and_slot_steps_equal_the_cached_step`` holds one
  process), exported states within 1e-5 (an export batch of
  other rows may block the convolutions differently, as
  ``test_export_hybrid_equals_streamed_and_cached`` holds);
* against JAX's learner in the same mode: epoch means within 2e-2, the
  learner tests' tolerance (test_torch_zoo_data.py
  ``test_two_epochs_match_jax_in_the_same_mode``), rotating hybrid on its
  training means only (ROADMAP.md section C);
* the hybrid store's bookkeeping on the two ranks, and a resumed run
  against a straight one: exact.
"""

from __future__ import annotations

import contextlib
import fcntl
import io
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_zoo_dist import (_close_rel_max, _spawn,  # noqa: F401
                                 two_pass_bn_variance)

WORLD = 2
BS = 16
STATE_DIM = 8
LR = 5e-3
SEED = 4
HOT_ROWS = 40  # hybrid store rows: under half of the 96
FRAME_BYTES = 32 * 32 * 3
# the ranks' runs take ~40 s alone; xdist's other workers share the
# cores meanwhile
RANKS_TIMEOUT_S = 600
# the triplet loss on two camera views (config 5's loss on config 1's
# encoder): the loader's pos_obs and neg_obs, the store's second view
TRIPLET = {"losses": (("triplet", 1.0),), "split_dims": (("triplet", -1),),
           "multi_view": True}
# the robotic priors (config 3's loss): the loader's next_obs
PRIORS = {"losses": (("priors", 1.0),), "split_dims": (("priors", -1),)}

# mode: (dataset, SRLConfig fields, hybrid rows, epochs of each learn call)
MODES = {
    "on": ("frames", {"device_cache": "on"}, None, (2,)),
    "off": ("frames", {"device_cache": "off"}, None, (2,)),
    "off-overlap": ("frames", {"device_cache": "off",
                               "stream_overlap": True}, None, (2,)),
    "jpeg-cached": ("decoded", {"device_cache": "on"}, None, (2,)),
    "jpeg": ("jpeg", {"device_cache": "off"}, None, (2,)),
    "hybrid": ("frames", {"device_cache": "hybrid"}, HOT_ROWS, (2,)),
    "hybrid-static": ("frames", {"device_cache": "hybrid",
                                 "hybrid_rotation": False}, HOT_ROWS, (2,)),
    "hybrid-resumed": ("frames", {"device_cache": "hybrid"}, HOT_ROWS,
                       (1, 2)),
    "priors-on": ("frames", {"device_cache": "on", **PRIORS}, None, (2,)),
    "priors-off": ("frames", {"device_cache": "off", **PRIORS}, None, (2,)),
    "triplet-on": ("views", {"device_cache": "on", **TRIPLET}, None, (2,)),
    "triplet-off": ("views", {"device_cache": "off", **TRIPLET}, None, (2,)),
    "triplet-hybrid": ("views", {"device_cache": "hybrid", **TRIPLET},
                       HOT_ROWS, (2,)),
}
# streamed mode: the whole-store run it equals
STREAMED = {"off": "on", "off-overlap": "on", "jpeg": "jpeg-cached",
            "priors-off": "priors-on", "triplet-off": "triplet-on"}
# the modes that fetch pixels on the host
FETCHING = [m for m, (_, kw, _, _) in MODES.items()
            if kw["device_cache"] != "on"]


def _budget_mb(rows, views: int = 1) -> str:
    """SRL_ZOO_CACHE_BUDGET_MB that holds ``rows`` 32 px frames of
    ``views`` camera views."""
    return str((rows + 0.5) * FRAME_BYTES * views / 2**20)


def _jax_config(mode: str = "on"):
    """JAX's config 1 of the mode (test_torch_zoo_data.py's two-epoch
    settings)."""
    from srl_zoo_tpu.config import SRLConfig as JaxConfig
    _, kw, _, _ = MODES[mode]
    return JaxConfig(state_dim=STATE_DIM, losses=(("autoencoder", 1.0),),
                     split_dims=(("autoencoder", -1),), img_height=32,
                     img_width=32, batch_size=BS, n_actions=4,
                     n_reward_classes=3, epochs=2, seed=SEED,
                     learning_rate=LR, num_cpu=2,
                     device_cache=kw["device_cache"],
                     hybrid_rotation=kw.get("hybrid_rotation", True))


def _jax_initial_weights(jlearner):
    import jax
    from srl_zoo_tpu_torch import bridge
    sd, _ = bridge.state_dict_from_jax(
        jax.device_get(jlearner.state.params),
        jax.device_get(jlearner.state.batch_stats))
    return sd


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _store_holds_its_rows(store) -> bool:
    """Every resident row's slot holds that row's frame, in each view."""
    resident = np.nonzero(store.slot_of >= 0)[0]
    return all(np.array_equal(
        frames.numpy()[store.slot_of[resident]],
        np.asarray(getattr(store.ds, view)[resident]))
        for view, frames in store.cache.items())


def _instrument(record):
    """Wrap the loader's pixel fetch and the hybrid store's hold and
    advance to record, in ``record``, every fetch's (batch size, rows) and
    every epoch's bookkeeping: the held slots, the adopted and swept rows,
    then the slot map, the window start and whether every resident slot
    holds its row's bytes."""
    from srl_zoo_tpu_torch.data.hybrid import RotatingHotStore
    from srl_zoo_tpu_torch.data.loader import DataLoader
    fetch, hold, advance = (DataLoader._fetch_images, RotatingHotStore.hold,
                            RotatingHotStore.advance)

    def fetch_images(self, idx, view=0):
        record["fetches"].append((self.batch_size, len(idx)))
        return fetch(self, idx, view)

    def hold_rows(self, rows):
        hold(self, rows)
        record["held"].append(np.nonzero(self._held)[0])

    def advance_window(self):
        epoch = {"adopted": np.zeros(0, np.int64),
                 "swept": np.zeros(0, np.int64)}
        if self._pending_slot is not None:
            entering = self._entering
            epoch["adopted"] = np.nonzero(self._adopted)[0]
            epoch["swept"] = entering[~self._adopted[entering]]
        advance(self)
        epoch.update(
            slot_of=self.slot_of.copy(), start=self.start,
            adopted_rows=self.adopted_rows, swept_rows=self.swept_rows,
            bytes_ok=_store_holds_its_rows(self))
        record["epochs"].append(epoch)

    DataLoader._fetch_images = fetch_images
    RotatingHotStore.hold = hold_rows
    RotatingHotStore.advance = advance_window


def _rank_modes(exp_config, state_dict, folders, root):
    """Each mode of MODES on this rank: {mode: {"hist", "states",
    "weights", "kind", "slot_of", "bytes_ok", "counts", "fetches",
    "held", "epochs"}}."""
    import torch.distributed as dist
    from srl_zoo_tpu_torch.config import SRLConfig
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.parallel import mesh
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    base = SRLConfig.from_exp_config(exp_config)
    record = {}
    _instrument(record)
    out = {}
    for mode, (data, kw, hot_rows, calls) in MODES.items():
        if hot_rows:
            os.environ["SRL_ZOO_CACHE_BUDGET_MB"] = _budget_mb(
                hot_rows, 2 if kw.get("multi_view") else 1)
        else:
            os.environ.pop("SRL_ZOO_CACHE_BUDGET_MB", None)
        ds = load_dataset(folders[data])
        record.update(fetches=[], held=[], epochs=[])
        mesh.zero_counts()
        log = os.path.join(root, mode)
        for i, epochs in enumerate(calls):
            cfg = base.replace(epochs=epochs, **kw)
            if mesh.rank() == 0:
                cfg.save(log)
            learner = SRL4robotics(cfg, log_folder=log, device="cpu")
            if cfg.losses == base.losses:
                # JAX's initial weights fit config 1's model; the priors
                # and triplet runs keep the port's seeded ones
                learner.model.load_state_dict(state_dict)
            learner.learn(ds, resume=i > 0)
            # the resumed learner reads the checkpoint rank 0 has written
            dist.barrier()
        with np.load(os.path.join(mesh.rank_folder(log),
                                  "loss_history.npz")) as hist:
            hist = dict(hist)
        hot = learner._hot_store
        out[mode] = {
            "hist": hist, "states": learner.predict_states(ds),
            "weights": {k: v.clone()
                        for k, v in learner.model.state_dict().items()},
            "kind": "stream" if learner._cache is None else
                    "whole" if hot is None else "hybrid",
            "slot_of": None if hot is None else hot.slot_of.copy(),
            "bytes_ok": hot is not None and _store_holds_its_rows(hot),
            "counts": dict(mesh.counts),
            **{k: list(v) for k, v in record.items()}}
    return out


def _shared_dir(tmp_path_factory, name: str) -> str:
    """A directory that every xdist worker of this pytest run shares (the
    run's own without xdist)."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    return str(base.parent / f"{name}_{run}" if run else base / name)


@pytest.fixture(scope="module")
def stream_runs(tmp_path_factory):
    """(folders (the datasets and "runs", rank 0's run folders), JAX's
    initial weights, [each rank's results]) of the ranks' runs, computed
    once for the whole pytest run: the first worker to take the lock
    spawns the ranks, the others wait and load."""
    root = _shared_dir(tmp_path_factory, "dist_stream")
    os.makedirs(root, exist_ok=True)
    done = os.path.join(root, "results.pt")
    with open(os.path.join(root, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(done):
                torch.save(_run_ranks(root), done)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return torch.load(done, weights_only=False)


def _run_ranks(root: str):
    from srl_zoo_tpu.training.learner import SRL4robotics as JaxLearner
    from srl_zoo_tpu_torch.data.loader import decode_images
    from srl_zoo_tpu_torch.data.schema import load_dataset, resolve_image_path
    from srl_zoo_tpu_torch.data.synthetic import generate_dataset
    folders = {"frames": os.path.join(root, "data")}
    generate_dataset(folders["frames"], n_episodes=4, episode_len=24,
                     img_size=32, seed=0, save_jpgs=True)
    folders["views"] = generate_dataset(
        os.path.join(root, "views"), n_episodes=4, episode_len=24,
        img_size=32, seed=0, multi_view=True)
    folders["jpeg"] = os.path.join(root, "jpeg")
    shutil.copytree(folders["frames"], folders["jpeg"],
                    ignore=shutil.ignore_patterns("frames*.npy"))
    # the JPEGs decoded by the loader's own chain into a frames cache: the
    # whole store that a JPEG-streamed run equals
    folders["decoded"] = os.path.join(root, "decoded")
    shutil.copytree(folders["jpeg"], folders["decoded"])
    ds = load_dataset(folders["jpeg"])
    np.save(os.path.join(folders["decoded"], "frames.npy"), decode_images(
        [resolve_image_path(ds.data_folder, p) for p in ds.images_path],
        (32, 32), 2))
    jcfg = _jax_config()
    sd = _jax_initial_weights(JaxLearner(jcfg,
                                         log_folder=os.path.join(root, "j")))
    folders["runs"] = os.path.join(root, "runs")
    ranks = _spawn(_rank_modes, os.path.join(root, "ranks"),
                   jcfg.to_exp_config(), sd, folders, folders["runs"],
                   timeout=RANKS_TIMEOUT_S)
    return folders, sd, ranks


# ---------------------------------------------------------------------------
# (i) streamed runs against the whole store, and (vi) the streamed export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(STREAMED))
def test_streamed_runs_equal_the_whole_store(stream_runs, mode):
    """At world size 2 a streamed run (from frames.npy, overlapped, from
    JPEGs; the priors' next frames, the triplet's anchors, positives of
    the second view and negatives, each fetched at the rank's positions)
    trains as the whole
    store does: every epoch mean of its loss
    history bit for bit, the trained weights bit for bit, the exported
    states within 1e-5 of the largest |state|; on both ranks alike."""
    _, _, ranks = stream_runs
    for r in ranks:
        got, want = r[mode], r[STREAMED[mode]]
        assert (got["kind"], want["kind"]) == ("stream", "whole")
        assert set(got["hist"]) == set(want["hist"])
        for k, v in want["hist"].items():
            np.testing.assert_array_equal(got["hist"][k], v, err_msg=k)
        for k, v in want["weights"].items():
            assert torch.equal(got["weights"][k], v), k
        _close_rel_max(got["states"], want["states"], 1e-5)
    np.testing.assert_array_equal(ranks[0][mode]["states"],
                                  ranks[1][mode]["states"])


def test_streamed_export_equals_one_process(stream_runs):
    """The states that two ranks export by streaming (each encodes its
    rows of every export batch, and the states are gathered) equal one
    process's streamed export of the same trained model, within 1e-5 of
    the largest |state|."""
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.evaluation.predict_dataset import predict_streamed
    from srl_zoo_tpu_torch.inference import StateEncoder
    folders, _, ranks = stream_runs
    # rank 0's run folder: the config and the trained (best) weights
    encoder = StateEncoder.load(os.path.join(folders["runs"], "off"),
                                device="cpu")
    for k, v in ranks[0]["off"]["weights"].items():
        assert torch.equal(encoder.model.state_dict()[k], v), k
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        states = predict_streamed(encoder, load_dataset(folders["frames"]))
    finally:
        torch.set_num_threads(n)
    for r in ranks:
        _close_rel_max(r["off"]["states"], states, 1e-5)


# ---------------------------------------------------------------------------
# (ii) against JAX's learner in the same mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["off", "jpeg", "hybrid", "hybrid-static"])
def test_two_ranks_match_jax_in_the_same_mode(mode, request, monkeypatch,
                                              two_pass_bn_variance):
    """The two-rank run's epoch means within 2e-2 of JAX's learner in the
    same mode, from the same initial weights (JAX's, checked equal): the
    training and validation means, and the same best epoch; for the
    rotating hybrid store the training means only (JAX's validation reads
    overwritten slots, ROADMAP.md section C). JAX's hybrid store holds the
    port's 40 rows and ends on the same slot map. JAX's run goes first, so
    that the ranks run meanwhile on another worker."""
    from srl_zoo_tpu.data import device_cache as jdc
    from srl_zoo_tpu.data.schema import load_dataset as jax_load
    from srl_zoo_tpu.training.learner import SRL4robotics as JaxLearner
    from srl_zoo_tpu_torch.data.synthetic import generate_dataset
    tmp = request.getfixturevalue("tmp_path")
    data, _, hot_rows, _ = MODES[mode]
    folder = generate_dataset(str(tmp / "data"), n_episodes=4,
                              episode_len=24, img_size=32, seed=0,
                              save_jpgs=True)
    if data == "jpeg":
        for f in os.listdir(folder):
            if f.startswith("frames"):
                os.remove(os.path.join(folder, f))
    if hot_rows:
        monkeypatch.setattr(jdc, "DEFAULT_MAX_BYTES", FRAME_BYTES * hot_rows)
    jl = JaxLearner(_jax_config(mode), log_folder=str(tmp / "j"))
    sd = _jax_initial_weights(jl)
    jl.learn(jax_load(folder))
    _, want_sd, ranks = request.getfixturevalue("stream_runs")
    for k, v in want_sd.items():
        assert torch.equal(sd[k], v), k
    want = np.load(tmp / "j" / "loss_history.npz")
    rotating = mode == "hybrid"
    held = ("train/",) if rotating else ("train/", "val/total")
    for r in ranks:
        got = r[mode]["hist"]
        assert set(got) == set(want.files)
        for k in want.files:
            if k.startswith(held):
                np.testing.assert_allclose(got[k], want[k], rtol=2e-2,
                                           err_msg=k)
        if not rotating:
            assert np.argmin(got["val/total"]) == np.argmin(want["val/total"])
        if hot_rows:
            assert jl._hot_store.hot_n == hot_rows
            np.testing.assert_array_equal(r[mode]["slot_of"],
                                          jl._hot_store.slot_of)


# ---------------------------------------------------------------------------
# (iii)-(v) the hybrid store's bookkeeping, the loaders' rows, a resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["hybrid", "hybrid-static",
                                  "hybrid-resumed", "triplet-hybrid"])
def test_hybrid_bookkeeping_is_equal_on_every_rank(stream_runs, mode):
    """After every epoch of a rotating store both ranks hold the same slot
    map and window start and held, adopted and swept the same rows; every
    rank's store holds the bytes of the rows its slot map names (both
    views for the triplet), after every epoch and after the export. A
    rotating store adopted rows from streamed batches, each through a
    uint8 all-gather of the batch's frames (and the triplet's positives,
    its second view) from both ranks; a static one never moved (the
    learner does not advance it) and gathered nothing."""
    _, _, ranks = stream_runs
    a, b = ranks[0][mode], ranks[1][mode]
    assert a["kind"] == b["kind"] == "hybrid"
    assert a["bytes_ok"] and b["bytes_ok"]
    rotating = mode != "hybrid-static"
    assert len(a["epochs"]) == len(b["epochs"]) == 2 * rotating
    for ea, eb in zip(a["epochs"], b["epochs"]):
        assert ea["bytes_ok"] and eb["bytes_ok"]
        assert ea["start"] == eb["start"]
        for k in ("slot_of", "adopted", "swept"):
            np.testing.assert_array_equal(ea[k], eb[k], err_msg=k)
    assert len(a["held"]) == len(b["held"])
    for ha, hb in zip(a["held"], b["held"]):
        np.testing.assert_array_equal(ha, hb)
    np.testing.assert_array_equal(a["slot_of"], b["slot_of"])
    if not rotating:
        assert a["counts"]["all_gather_frames"] == 0
        np.testing.assert_array_equal(a["slot_of"][:HOT_ROWS],
                                      np.arange(HOT_ROWS))
        assert (a["slot_of"][HOT_ROWS:] == -1).all()
    else:
        assert a["epochs"][-1]["adopted_rows"] > 0
        assert a["counts"]["all_gather_frames"] == \
            b["counts"]["all_gather_frames"] > 0
        assert [e["start"] for e in a["epochs"]] == [56, 16]


@pytest.mark.parametrize("mode", FETCHING)
def test_each_rank_fetches_only_its_rows(stream_runs, mode):
    """Every pixel fetch of a streamed batch, in training, validation and
    the export, reads B/world rows on each rank: the rank's positions of
    the global batch, never the whole batch."""
    _, _, ranks = stream_runs
    for r in ranks:
        fetches = r[mode]["fetches"]
        assert fetches
        assert all(rows == bs // WORLD for bs, rows in fetches), fetches
        assert {bs for bs, _ in fetches} == {BS, 256}


def test_resumed_hybrid_run_equals_a_straight_run(stream_runs):
    """A rotating hybrid run stopped after one epoch and resumed to two
    (the window replayed to its epoch, the checkpoint read on both ranks)
    equals the straight run: loss history, weights, slot map, window and
    exported states, bit for bit, on both ranks."""
    _, _, ranks = stream_runs
    for r in ranks:
        a, b = r["hybrid"], r["hybrid-resumed"]
        for k, v in a["hist"].items():
            np.testing.assert_array_equal(b["hist"][k], v, err_msg=k)
        for k, v in a["weights"].items():
            assert torch.equal(b["weights"][k], v), k
        np.testing.assert_array_equal(a["slot_of"], b["slot_of"])
        assert a["epochs"][-1]["start"] == b["epochs"][-1]["start"]
        np.testing.assert_array_equal(a["states"], b["states"])


# ---------------------------------------------------------------------------
# one store plan for the whole group
# ---------------------------------------------------------------------------

def _rank_plans(budget_rows, mode):
    """This rank's budget from SRL_ZOO_CACHE_BUDGET_MB (its entry of
    ``budget_rows`` and half a row); the (kind, rows) that ``plan`` gives
    on that budget alone, the one ``open_store`` opened, the collectives,
    and the doctor's mode line."""
    from srl_zoo_tpu_torch.config import SRLConfig
    from srl_zoo_tpu_torch.data import device_cache as dc
    from srl_zoo_tpu_torch.data.synthetic import generate_dataset
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.parallel import mesh
    from srl_zoo_tpu_torch.utils import doctor
    r = mesh.rank()
    os.environ[dc.BUDGET_ENV] = _budget_mb(budget_rows[r])
    folder = os.path.join(os.environ["PLAN_DATA"], f"rank{r}")
    ds = load_dataset(generate_dataset(folder, n_episodes=4, episode_len=24,
                                       img_size=32, seed=0))
    cfg = SRLConfig(state_dim=4, img_height=32, img_width=32, batch_size=BS,
                    device_cache=mode)
    cpu = torch.device("cpu")
    own = dc.plan(ds, (32, 32), False, mode, BS, dc.budget_bytes(cpu),
                  mesh.world())
    planned = []
    real = dc.plan
    dc.plan = lambda *a, **k: planned.append(real(*a, **k)) or planned[-1]
    try:
        dc.open_store(ds, cfg, cpu)
    finally:
        dc.plan = real
    counts = dict(mesh.counts)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        doctor.main(["--data-folder", folder, "--img-size", "32", "-bs",
                     str(BS), "--skip-bandwidth", "--device", "cpu"])
    mode = [ln for ln in out.getvalue().splitlines() if "mode:" in ln]
    return own, planned[0], counts, mode


@pytest.mark.parametrize("mode", ["auto", "hybrid"])
def test_ranks_with_different_budgets_agree_on_one_plan(tmp_path,
                                                        monkeypatch, mode):
    """Rank 0's budget holds the whole store (100.5 rows), rank 1's 40.5
    rows: on its own budget rank 0 would open the whole store in ``auto``
    and a 96-row (whole) store in ``hybrid``, rank 1 a 40-row hybrid
    store. ``open_store`` plans both on the least budget, one all-reduce:
    both open the 40-row hybrid store, and the doctor, run in the group,
    reports that store (``auto``) on both."""
    monkeypatch.setenv("PLAN_DATA", str(tmp_path / "data"))
    ranks = _spawn(_rank_plans, tmp_path / "ranks", (100, 40), mode)
    (own0, plan0, counts0, mode0), (own1, plan1, _, mode1) = ranks
    assert own0 == ("whole", 96) and own1 == ("hybrid", 40)
    assert plan0 == plan1 == ("hybrid", 40)
    assert counts0["all_reduce"] == 1
    assert len(mode0) == 1 and mode0 == mode1
    assert "hybrid store of 40/96 rows" in mode0[0]
