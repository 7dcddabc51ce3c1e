"""The port's data layer (native host runtime, recorder and preprocessing,
image-mode loader, hybrid store, streamed and slot-addressed steps, the
learner's cache modes) against the JAX package, on the CPU at 32 px with
state_dim 4 (8 for the two-view configs).

Tolerances, each with its reason:

* the native runtime, the recorded files, preprocessing, the frames
  caches, the loader's batches and the hybrid store's bookkeeping: exact
  (both packages build the same C++ source against one libjpeg and draw
  from one numpy generator);
* a streamed and a slot-addressed step against the cached step: exact
  (the same rows reach the same gather kernel arithmetic, and then the
  same model);
* two epochs against JAX in the same cache mode: epoch means within 2e-2
  relative, as the learner tests of test_torch_zoo_train.py hold the
  cached mode;
* states exported through a hybrid store, streamed and cached: 1e-5 (a
  batch of other rows around a row changes the order of no sum but may
  change the convolution's blocking);
* a resumed hybrid run against a straight one: exact.
"""

import contextlib
import copy
import glob
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from srl_zoo_tpu.config import SRLConfig as JaxConfig
from srl_zoo_tpu_torch import bridge, native
from srl_zoo_tpu_torch.config import SRLConfig

STATE_DIM = 4
BS = 16


@contextlib.contextmanager
def _one_torch_thread():
    """One intra-op thread for a learner or CLI run: pytest-xdist runs
    several workers at once, and a thread per core in each oversubscribes
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def two_pass_bn_variance(monkeypatch):
    """JAX's BatchNorm with the two-pass batch variance that torch takes
    (flax's one-pass variance strays in float32; test_torch_zoo_train.py)."""
    from flax.linen import normalization
    one_pass = normalization._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return one_pass(*args, **kwargs)

    monkeypatch.setattr(normalization, "_compute_stats", two_pass)


def _write_jpegs(folder, n, shape, seed=0):
    import cv2
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        img = cv2.GaussianBlur(img, (5, 5), 0)  # JPEG-like content
        paths.append(os.path.join(folder, f"f{i}.jpg"))
        cv2.imwrite(paths[-1], img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    return paths


@pytest.fixture(scope="module")
def jpeg_dataset(tmp_path_factory):
    """A two-camera 32 px dataset with its JPEGs and frames caches."""
    from srl_zoo_tpu.data.synthetic import generate_dataset
    folder = str(tmp_path_factory.mktemp("data") / "jpeg_mv")
    generate_dataset(folder, n_episodes=4, episode_len=24, img_size=32,
                     seed=0, save_jpgs=True, multi_view=True)
    return folder


def _without_frames(src, dst):
    """A copy of a dataset folder without its frames caches."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("frames*.npy"))
    return str(dst)


# ---------------------------------------------------------------------------
# the native host runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["gather", "resize", "jpeg", "jpeg-scaled"])
def test_native_runtime_equals_jax(op, tmp_path):
    """Gather, resize and JPEG decode (at the file's size, and with
    libjpeg's DCT scaling plus resize) equal the JAX package's library
    bit for bit, and count their route."""
    from srl_zoo_tpu import native as jnative
    assert native.available() and native.has_jpeg, native.build_error
    assert jnative.available()
    native.reset_counts()
    rng = np.random.RandomState(3)
    if op == "gather":
        frames = rng.randint(0, 256, (40, 12, 10, 3)).astype(np.uint8)
        idx = rng.randint(0, 40, 17)
        got = native.gather_frames(frames, idx)
        np.testing.assert_array_equal(got, jnative.gather_frames(frames, idx))
        np.testing.assert_array_equal(got, frames[idx])
        with pytest.raises(IndexError):
            native.gather_frames(frames, np.array([40]))
        key = "gather_native"
    elif op == "resize":
        imgs = rng.randint(0, 256, (5, 48, 40, 3)).astype(np.uint8)
        got = native.resize_batch(imgs, 32, 24)
        np.testing.assert_array_equal(got,
                                      jnative.resize_batch(imgs, 32, 24))
        key = "resize_native"
    else:
        paths = _write_jpegs(str(tmp_path), 9, (128, 96, 3)
                             if op == "jpeg-scaled" else (32, 32, 3))
        got = native.decode_jpeg_batch(paths, 32, 32, n_threads=3)
        np.testing.assert_array_equal(
            got, jnative.decode_jpeg_batch(paths, 32, 32, n_threads=2))
        with pytest.raises(FileNotFoundError, match="nope.jpg"):
            native.decode_jpeg_batch([paths[0], str(tmp_path / "nope.jpg")],
                                     32, 32)
        key = "jpeg_native"
    assert native.counts[key] > 0
    assert sum(native.counts.values()) == native.counts[key]


@pytest.mark.parametrize("scaled", [False, True])
def test_cv2_decode_route_equals_jax(scaled, tmp_path, monkeypatch):
    """Without the native decoder the loader decodes with cv2 (area
    filter) on the shared pool, as the JAX loader's fallback does, and
    counts the cv2 route; a resize without the library is cv2's bilinear
    filter."""
    import cv2
    from srl_zoo_tpu.data.loader import _decode_resize
    from srl_zoo_tpu_torch.data.loader import decode_images
    paths = _write_jpegs(str(tmp_path), 6, (64, 48, 3) if scaled
                         else (32, 32, 3), seed=1)
    monkeypatch.setattr(native, "jpeg_available", lambda: False)
    native.reset_counts()
    got = decode_images(paths, (32, 32), 2)
    want = np.stack([_decode_resize(p, (32, 32)) for p in paths])
    np.testing.assert_array_equal(got, want)
    assert native.counts["jpeg_cv2"] == 6 and native.counts["jpeg_native"] \
        == 0
    monkeypatch.setattr(native, "get_lib", lambda: None)
    imgs = np.random.RandomState(0).randint(0, 256, (3, 20, 30, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(
        native.resize_batch(imgs, 10, 12),
        np.stack([cv2.resize(im, (12, 10), interpolation=cv2.INTER_LINEAR)
                  for im in imgs]))
    np.testing.assert_array_equal(native.gather_frames(imgs, [2, 0]),
                                  imgs[[2, 0]])
    assert native.counts["resize_cv2"] == 3 and \
        native.counts["gather_numpy"] == 2


@pytest.mark.parametrize("fault", ["no-libjpeg", "no-compiler"])
def test_build_failure_prints_the_compiler_output_once(fault, tmp_path,
                                                       monkeypatch, capfd):
    """A source that does not build with libjpeg is built again without
    the decoder (JPEGs then go to cv2); one that does not build at all
    leaves every entry point on its fallback. Either way the compiler's
    output is printed once, into build/ and never next to the source."""
    src = tmp_path / "srlhost.cpp"
    body = open(native.SRC).read()
    poison = "#error srlhost_test_fault\n"
    if fault == "no-libjpeg":
        body = body.replace("#include <jpeglib.h>",
                            "#include <jpeglib.h>\n" + poison)
    else:
        body = poison + body
    src.write_text(body)
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    monkeypatch.setattr(native, "has_jpeg", False)
    monkeypatch.setattr(native, "build_error", None)
    lib = native.get_lib()
    assert native.get_lib() is lib  # built (or given up on) once
    err = capfd.readouterr().err
    assert err.count("srl_zoo_tpu_torch.native:") == 1
    assert err.count("error: #error srlhost_test_fault") == \
        (1 if fault == "no-libjpeg" else 2)  # one per failed build
    assert "srlhost_test_fault" in native.build_error
    assert not native.jpeg_available()
    with pytest.raises(RuntimeError):
        native.decode_jpeg_batch(["x.jpg"], 8, 8)
    assert (lib is not None) == (fault == "no-libjpeg")
    assert sorted(os.listdir(tmp_path)) == ["build", "srlhost.cpp"]
    frames = np.arange(2 * 4 * 4 * 3, dtype=np.uint8).reshape(2, 4, 4, 3)
    native.reset_counts()
    np.testing.assert_array_equal(native.gather_frames(frames, [1]),
                                  frames[[1]])
    route = "gather_native" if lib is not None else "gather_numpy"
    assert native.counts[route] == 1


# ---------------------------------------------------------------------------
# recorder and preprocessing
# ---------------------------------------------------------------------------

def _record(recorder_cls, folder, two_views=True):
    rng = np.random.RandomState(7)
    rec = recorder_cls(folder)
    for ep in range(3):
        rec.new_episode()
        for t in range(6 + ep):
            img = rng.randint(0, 256, (40, 48, 3)).astype(np.uint8)
            rec.record(img, int(rng.randint(4)), float(rng.rand() < 0.3),
                       rng.randn(2).astype(np.float32),
                       obs_2=img[::-1].copy() if two_views else None)
    rec.close()


@pytest.mark.parametrize("two_views", [False, True])
def test_recorder_and_preprocessing_equal_jax(two_views, tmp_path):
    """The recorded files, the two npz files of preprocessing (reward
    shift and the _2 pattern included) and the frames caches of both views
    equal the JAX package's on the same episodes."""
    from srl_zoo_tpu.data.record import DatasetRecorder as JaxRecorder
    from srl_zoo_tpu.preprocessing import preprocess as jpre
    from srl_zoo_tpu_torch.data.record import DatasetRecorder
    from srl_zoo_tpu_torch.preprocessing import preprocess as pre
    jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
    _record(JaxRecorder, jdir, two_views)
    _record(DatasetRecorder, pdir, two_views)
    files = sorted(os.path.relpath(f, pdir) for f in
                   glob.glob(os.path.join(pdir, "*", "*")))
    assert files == sorted(os.path.relpath(f, jdir) for f in
                           glob.glob(os.path.join(jdir, "*", "*")))
    for f in files:
        if f.endswith(".jpg"):
            with open(os.path.join(pdir, f), "rb") as a, \
                    open(os.path.join(jdir, f), "rb") as b:
                assert a.read() == b.read(), f
    jpre.main(["--data-folder", jdir, "--img-size", "32"])
    pre.main(["--data-folder", pdir, "--img-size", "32"])
    for name in ("preprocessed_data.npz", "ground_truth.npz"):
        got = np.load(os.path.join(pdir, name))
        want = np.load(os.path.join(jdir, name))
        assert got.files == want.files
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    views = ["frames.npy"] + (["frames_2.npy"] if two_views else [])
    assert sorted(f for f in os.listdir(pdir) if f.endswith(".npy")) == \
        sorted(f for f in os.listdir(jdir) if f.endswith(".npy")) == views
    for name in views:
        np.testing.assert_array_equal(np.load(os.path.join(pdir, name)),
                                      np.load(os.path.join(jdir, name)))
    pre_rewards = np.load(os.path.join(pdir, "preprocessed_data.npz"))
    assert pre_rewards["rewards"][0] == 0.0
    for size, n in ((32, None), (16, None), (32, 3)):
        assert pre.frames_cache_stale(os.path.join(pdir, "frames.npy"),
                                      size, n) == \
            jpre.frames_cache_stale(os.path.join(jdir, "frames.npy"), size,
                                    n)
    assert pre.dataset_length(pdir) == jpre._dataset_length(jdir)


# ---------------------------------------------------------------------------
# the image-mode loader
# ---------------------------------------------------------------------------

LOADER_CASES = {
    # name: (losses, JaxConfig fields, dataset source)
    "autoencoder": ((("autoencoder", 1.0),), {}, "frames"),
    "priors-6ch": ((("priors", 1.0),), {"multi_view": True}, "frames"),
    "triplet": ((("triplet", 1.0),), {"multi_view": True}, "frames"),
    "episode-prior": ((("episode-prior", 1.0), ("autoencoder", 1.0),
                       ("supervised", 1.0)), {}, "frames"),
    "balanced": ((("priors", 1.0), ("reward", 1.0)),
                 {"balanced_sampling": True}, "frames"),
    "jpeg": ((("triplet", 1.0), ("priors", 1.0)), {"multi_view": True},
             "jpeg"),
    "resize": ((("forward", 1.0), ("inverse", 1.0)), {}, "resize"),
}


def _loader_dataset(source, folder, tmp_path):
    """(port dataset, JAX dataset) of one folder: as written, without its
    frames caches (JPEG decode), or with 40 px caches (resized per
    batch)."""
    from srl_zoo_tpu.data.schema import load_dataset as jax_load
    from srl_zoo_tpu_torch.data.schema import load_dataset
    if source == "jpeg":
        folder = _without_frames(folder, tmp_path / "nf")
    elif source == "resize":
        from srl_zoo_tpu.preprocessing.preprocess import build_frames_cache
        folder = _without_frames(folder, tmp_path / "rs")
        build_frames_cache(folder, 40)
        build_frames_cache(folder, 40, view_suffix="_2")
    return load_dataset(folder), jax_load(folder)


@pytest.mark.parametrize("name", list(LOADER_CASES))
def test_image_loader_equals_jax(name, jpeg_dataset, tmp_path):
    """Every key of every batch of two epochs (training and eval loaders,
    the last batch wrapped or padded) equals the JAX loader's with
    emit_images=True, and of index-mode loaders with a slot map and a
    negative pool."""
    from srl_zoo_tpu.data.loader import DataLoader as JaxLoader
    from srl_zoo_tpu_torch.data.loader import DataLoader, batch_flags
    losses, extra, source = LOADER_CASES[name]
    ds, jds = _loader_dataset(source, jpeg_dataset, tmp_path)
    jcfg = JaxConfig(state_dim=4, losses=losses,
                     split_dims=tuple((n, -1) for n, _ in losses),
                     img_height=32, img_width=32, batch_size=BS,
                     num_cpu=2, **extra)
    cfg = SRLConfig.from_exp_config(jcfg.to_exp_config())
    idx = np.random.RandomState(5).permutation(ds.n_samples - 1)[:53]
    pool = idx[::2]
    slot_map = np.random.RandomState(6).permutation(ds.n_samples).astype(
        np.int32)
    slot_map[::7] = -1
    for emit, kw in ((True, {}), (True, {"neg_pool": pool}),
                     (False, {"neg_pool": pool, "slot_map": slot_map})):
        for train in (True, False):
            common = dict(shuffle=train, seed=11, wraparound=train, **kw)
            want = JaxLoader(jds, idx, jcfg, emit_images=emit,
                             num_threads=2, **common)
            got = DataLoader(ds, idx, BS, emit_images=emit,
                             **batch_flags(cfg), **common)
            for _ in range(2):
                wb, gb = list(want), list(got)
                assert len(gb) == len(wb) == len(got)
                for w, g in zip(wb, gb):
                    assert list(g) == list(w)
                    for k in w:
                        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_image_loader_stops_its_producer_when_abandoned(jpeg_dataset):
    """A consumer that stops after one batch leaves no producer thread
    behind, and a fetch error reaches the consumer."""
    import threading
    from srl_zoo_tpu_torch.data.loader import DataLoader
    from srl_zoo_tpu_torch.data.schema import load_dataset
    ds = load_dataset(jpeg_dataset)
    before = threading.active_count()
    loader = DataLoader(ds, np.arange(90), 4, emit_images=True,
                        img_hw=(32, 32))
    it = iter(loader)
    next(it)
    it.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before
    bad = DataLoader(ds, np.arange(90), 4, emit_images=True,
                     img_hw=(32, 32), stack_views=True)
    bad.ds = copy.copy(ds)
    bad.ds.frames_2 = bad.ds.images_path_2 = None
    with pytest.raises(ValueError, match="view-2"):
        list(bad)


# ---------------------------------------------------------------------------
# the rotating hybrid store
# ---------------------------------------------------------------------------

def _store_matches_dataset(store, ds):
    """Every resident row's slot holds its frame's bytes (both views)."""
    resident = np.nonzero(store.slot_of >= 0)[0]
    assert len(resident) == store.hot_n
    for name in ("frames", "frames_2")[:1 + store.needs_view2]:
        np.testing.assert_array_equal(
            store.cache[name].cpu().numpy()[store.slot_of[resident]],
            np.asarray(getattr(ds, name)[resident]), err_msg=name)


@pytest.mark.parametrize("losses,multi_view", [
    ((("autoencoder", 1.0),), False),
    ((("priors", 1.0),), True),
    ((("triplet", 1.0),), True),
])
def test_hybrid_store_bookkeeping_equals_jax(losses, multi_view,
                                            jpeg_dataset):
    """Over five epochs the port's store picks JAX's entering and leaving
    rows, slot pairing, slot map and window start, with adoption from
    streamed batches; the store invariant holds after every advance, and
    a replayed store lands on the same map and bytes."""
    from srl_zoo_tpu.data.hybrid import RotatingHotStore as JaxStore
    from srl_zoo_tpu.data.schema import load_dataset as jax_load
    from srl_zoo_tpu.parallel.mesh import make_mesh
    from srl_zoo_tpu_torch.data.hybrid import RotatingHotStore
    from srl_zoo_tpu_torch.data.loader import DataLoader, batch_flags
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.data.transfer import stream_batches
    ds, jds = load_dataset(jpeg_dataset), jax_load(jpeg_dataset)
    jcfg = JaxConfig(state_dim=4, losses=losses,
                     split_dims=((losses[0][0], -1),), img_height=32,
                     img_width=32, batch_size=8, multi_view=multi_view)
    cfg = SRLConfig.from_exp_config(jcfg.to_exp_config())
    cpu = torch.device("cpu")
    jstore = JaxStore(jds, make_mesh(jax.devices()[:1]), jcfg, hot_n=37)
    store = RotatingHotStore(ds, cpu, cfg, hot_n=37)
    rng = np.random.RandomState(0)
    for epoch in range(5):
        jstore.begin_epoch()
        store.begin_epoch()
        np.testing.assert_array_equal(store._entering, jstore._entering)
        np.testing.assert_array_equal(store._leaving, jstore._leaving)
        np.testing.assert_array_equal(store._pending_slot,
                                      jstore._pending_slot)
        # stream some cold rows; each store adopts its own batch
        cold = np.nonzero(store.slot_of < 0)[0]
        rows = rng.choice(cold, size=min(20, len(cold)), replace=False)
        loader = DataLoader(ds, rows, 8, shuffle=False, wraparound=False,
                            emit_images=True, **batch_flags(cfg))
        for batch in stream_batches(loader, cpu):
            store.maybe_adopt(batch["indices"], batch)
            jstore.maybe_adopt(batch["indices"], {
                k: jax.numpy.asarray(np.asarray(batch[k]))
                for k in ("obs", "pos_obs") if k in batch})
        np.testing.assert_array_equal(store._adopted, jstore._adopted)
        jstore.advance()
        store.advance()
        assert store.start == jstore.start and store.epoch == epoch + 1
        np.testing.assert_array_equal(store.slot_of, jstore.slot_of)
        _store_matches_dataset(store, ds)
    replayed = RotatingHotStore(ds, cpu, cfg, hot_n=37)
    replayed.replay_to(5)
    np.testing.assert_array_equal(replayed.slot_of, store.slot_of)
    assert replayed.start == store.start
    _store_matches_dataset(replayed, ds)
    idx = np.arange(ds.n_samples)
    np.testing.assert_array_equal(store.trainable_mask(idx),
                                  jstore.trainable_mask(idx))
    np.testing.assert_array_equal(store.slots(idx), jstore.slots(idx))


def test_hybrid_hold_keeps_validation_slots(jpeg_dataset):
    """A held leaving row keeps its bytes through adoption until release;
    the entering row that would have taken its slot is swept instead, and
    the store invariant holds after advance."""
    from srl_zoo_tpu_torch.data.hybrid import RotatingHotStore
    from srl_zoo_tpu_torch.data.schema import load_dataset
    ds = load_dataset(jpeg_dataset)
    cfg = SRLConfig(state_dim=4, img_height=32, img_width=32)
    store = RotatingHotStore(ds, torch.device("cpu"), cfg, hot_n=40)
    store.begin_epoch()
    held = store._leaving[:5]
    store.hold(held)
    entering = store._entering
    batch = {"obs": torch.from_numpy(np.asarray(ds.frames[entering]))}
    store.maybe_adopt(entering, batch)
    frames = store.cache["frames"].numpy()
    np.testing.assert_array_equal(frames[store.slot_of[held]],
                                  np.asarray(ds.frames[held]))
    assert store.adopted_rows == len(entering) - 5
    store.advance()
    assert store.swept_rows == 5
    _store_matches_dataset(store, ds)


# ---------------------------------------------------------------------------
# streamed and slot-addressed steps against the cached step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("losses,multi_view,model_type", [
    ((("autoencoder", 1.0),), False, "custom_cnn"),
    ((("priors", 1.0), ("forward", 1.0)), True, "custom_cnn"),
    ((("triplet", 1.0),), True, "resnet"),
    ((("vae", 1.0),), False, "custom_cnn"),
])
def test_streamed_and_slot_steps_equal_the_cached_step(
        losses, multi_view, model_type, jpeg_dataset):
    """A train step and an eval step on a streamed batch (its uint8 pixels
    normalized by the gather kernel over the identity index) and on a
    hybrid store's slot batch compute what the cached step computes on
    the same rows, bit for bit: the metrics and every parameter after
    the step."""
    from srl_zoo_tpu_torch.data.device_cache import build_cache
    from srl_zoo_tpu_torch.data.hybrid import RotatingHotStore
    from srl_zoo_tpu_torch.data.loader import DataLoader, batch_flags
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.data.transfer import stream_batches
    from srl_zoo_tpu_torch.training.state import make_model, make_optimizer
    from srl_zoo_tpu_torch.training.train_step import eval_step, train_step
    ds = load_dataset(jpeg_dataset)
    cfg = SRLConfig(state_dim=8, losses=losses,
                    split_dims=tuple((n, -1) for n, _ in losses),
                    img_height=32, img_width=32, batch_size=BS,
                    multi_view=multi_view, model_type=model_type,
                    n_actions=4, n_reward_classes=3)
    cpu = torch.device("cpu")
    hot = RotatingHotStore(ds, cpu, cfg, hot_n=50)
    for _ in range(2):  # a window that wraps, so slots differ from rows
        hot.begin_epoch()
        hot.advance()
    rows = np.nonzero(hot.trainable_mask(np.arange(ds.n_samples - 1)))[0]
    rows = rows[:BS]
    pool = np.nonzero(hot.resident_mask(np.arange(ds.n_samples)))[0]
    assert not np.array_equal(hot.slots(rows), rows)
    common = dict(shuffle=False, seed=3, wraparound=True, neg_pool=pool,
                  **batch_flags(cfg))
    full = build_cache(ds, cpu, cfg.needs_second_view)
    routes = {
        "cached": (full, next(iter(DataLoader(ds, rows, BS, **common)))),
        "slots": (hot.cache, next(iter(DataLoader(
            ds, rows, BS, slot_map=hot.slot_of, **common)))),
        "streamed": (None, next(stream_batches(DataLoader(
            ds, rows, BS, emit_images=True, **common), cpu))),
    }
    assert "cache_slots" in routes["slots"][1]
    torch.manual_seed(0)
    model0 = make_model(cfg, cpu)
    got = {}
    for route, (store, batch) in routes.items():
        model = copy.deepcopy(model0)
        opt = make_optimizer(cfg, model)
        with _one_torch_thread():
            metrics = train_step(model, opt, store, batch,
                                 torch.Generator().manual_seed(1))
            evals = eval_step(model, store, batch)
        got[route] = ({k: v.numpy() for k, v in metrics.items()},
                      {k: v.numpy() for k, v in evals.items()},
                      {k: v.detach().numpy()
                       for k, v in model.state_dict().items()})
    want = got.pop("cached")
    for route, result in got.items():
        for part, w in zip(result, want):
            assert list(part) == list(w)
            for k in w:
                np.testing.assert_array_equal(part[k], w[k],
                                              err_msg=f"{route} {k}")


# ---------------------------------------------------------------------------
# the learner in each cache mode
# ---------------------------------------------------------------------------

def _budget_mb(rows, multi_view):
    """SRL_ZOO_CACHE_BUDGET_MB that holds ``rows`` 32 px frames."""
    return str((rows + 0.5) * 32 * 32 * 3 * (2 if multi_view else 1)
               / 2**20)


TWO_EPOCH_CASES = {
    # name: (losses, JaxConfig fields, lr, device_cache, hot rows)
    "config1-streamed": ((("autoencoder", 1.0),), {}, 5e-3, "off", None),
    "config1-jpeg": ((("autoencoder", 1.0),), {}, 5e-3, "off", None),
    "config3-balanced": ((("priors", 1.0),), {"balanced_sampling": True},
                         1e-4, "auto", None),
    "config5-hybrid": ((("triplet", 1.0),),
                       {"model_type": "resnet", "multi_view": True}, 1e-5,
                       "hybrid", 40),
    "config5-hybrid-static": ((("triplet", 1.0),),
                              {"model_type": "resnet", "multi_view": True},
                              1e-5, "hybrid", 40),
}


@pytest.mark.parametrize("name", list(TWO_EPOCH_CASES))
def test_two_epochs_match_jax_in_the_same_mode(name, jpeg_dataset, tmp_path,
                                               monkeypatch,
                                               two_pass_bn_variance):
    """Two epochs from JAX's initial weights, in the same cache mode on
    both sides: the epoch means of the loss history within 2e-2 and the
    same best epoch. Config 1 streams from frames.npy and from the JPEGs
    (a folder without frames.npy), config 3 samples balanced reward
    classes, config 5 trains through a hybrid store of 40 of 96 rows,
    rotating and static. The learning rates are the learner tests' (the
    configs are chaotic at this size at higher ones).

    Under rotation the JAX learner's validation hot phase reads slots that
    its training cold phase has already handed to entering rows (ROADMAP
    section C); the port holds them. So with rotation only the training
    means are held to JAX's, and the validation total to the static
    store's JAX run, where no slot moves."""
    from srl_zoo_tpu.data import device_cache as jdc
    from srl_zoo_tpu.data.schema import load_dataset as jax_load
    from srl_zoo_tpu.training.learner import SRL4robotics as JaxLearner
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    losses, extra, lr, mode, hot_n = TWO_EPOCH_CASES[name]
    folder = jpeg_dataset
    if name == "config1-jpeg":
        folder = _without_frames(folder, tmp_path / "nf")
    rotate = not name.endswith("static")
    jcfg = JaxConfig(state_dim=8, losses=losses,
                     split_dims=((losses[0][0], -1),), img_height=32,
                     img_width=32, batch_size=BS, n_actions=4,
                     n_reward_classes=3, epochs=2, seed=4, learning_rate=lr,
                     device_cache=mode, hybrid_rotation=rotate, num_cpu=2,
                     **extra)
    if hot_n:
        per = 32 * 32 * 3 * 2
        monkeypatch.setattr(jdc, "DEFAULT_MAX_BYTES", per * hot_n)
        monkeypatch.setenv("SRL_ZOO_CACHE_BUDGET_MB", _budget_mb(hot_n,
                                                                 True))
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jl = JaxLearner(jcfg, log_folder=jdir)
    pl = SRL4robotics(SRLConfig.from_exp_config(jcfg.to_exp_config()),
                      log_folder=tdir, device="cpu")
    sd, _ = bridge.state_dict_from_jax(jax.device_get(jl.state.params),
                                       jax.device_get(jl.state.batch_stats))
    pl.model.load_state_dict(sd)
    jl.learn(jax_load(folder))
    with _one_torch_thread():
        pl.learn(load_dataset(folder))
    assert (pl._hot_store is None) == (jl._hot_store is None)
    if hot_n:
        assert pl._hot_store.hot_n == jl._hot_store.hot_n == hot_n
        assert pl._hot_store.rotate == rotate
        np.testing.assert_array_equal(pl._hot_store.slot_of,
                                      jl._hot_store.slot_of)
    assert (pl._cache is None) == (mode == "off")
    want = np.load(os.path.join(jdir, "loss_history.npz"))
    got = np.load(os.path.join(tdir, "loss_history.npz"))
    assert set(got.files) == set(want.files)
    held = ("train/",) if rotate and hot_n else ("train/", "val/total")
    for k in got.files:
        if k.startswith(held):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-2, err_msg=k)
    if not (rotate and hot_n):
        assert np.argmin(got["val/total"]) == np.argmin(want["val/total"])


def test_export_hybrid_equals_streamed_and_cached(jpeg_dataset, tmp_path,
                                                  monkeypatch):
    """States exported through a rotated hybrid store (the resident rows
    by slot, the rest streamed, put back in the caller's order), streamed
    and from the whole store agree within 1e-5; the learner in auto mode
    goes hybrid under a small budget, and the store invariant holds after
    training."""
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    ds = load_dataset(jpeg_dataset)
    cfg = SRLConfig(state_dim=8, losses=(("triplet", 1.0),),
                    split_dims=(("triplet", -1),), img_height=32,
                    img_width=32, batch_size=8, epochs=3, multi_view=True,
                    n_actions=4, n_reward_classes=3, learning_rate=1e-4)
    monkeypatch.setenv("SRL_ZOO_CACHE_BUDGET_MB", _budget_mb(40, True))
    learner = SRL4robotics(cfg, log_folder=str(tmp_path / "run"),
                           device="cpu")
    learner.time_phases = True
    with _one_torch_thread():
        learner.learn(ds)
    store = learner._hot_store
    assert store is not None and store.rotate and store.epoch == 3
    assert store.adopted_rows > 0
    _store_matches_dataset(store, ds)
    # the synchronised phase timing: each epoch's phases, its adoptions
    # and its rotation with the rows it swept
    for epoch in range(3):
        log = [r for r in learner.phase_log if r["epoch"] == epoch]
        phases = [r["what"] for r in log if r["what"] != "adopt"]
        assert phases == ["train hot", "train cold", "val hot", "val cold",
                          "advance"], phases
        rows = sum(r["rows"] for r in log if r["what"].startswith("train"))
        assert rows % 8 == 0 and rows >= 74  # whole batches, every row
        assert any(r["what"] == "adopt" for r in log)
        assert all(r["s"] >= 0 for r in log)
    order = np.random.RandomState(0).permutation(ds.n_samples)
    hybrid = learner.predict_states(ds, order)
    monkeypatch.delenv("SRL_ZOO_CACHE_BUDGET_MB")
    states = {}
    for mode in ("off", "on"):
        learner.cfg = cfg.replace(device_cache=mode)
        learner._cache_of = None
        states[mode] = learner.predict_states(ds, order)
        assert (learner._hot_store, learner._cache is None) == \
            (None, mode == "off")
    np.testing.assert_allclose(hybrid, states["off"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(hybrid, states["on"], rtol=0, atol=1e-5)


def test_hybrid_resume_equals_a_straight_run(jpeg_dataset, tmp_path,
                                             monkeypatch):
    """One epoch, then a resume to three, leaves the loss history, the
    window and the weights of three epochs straight through."""
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    ds = load_dataset(jpeg_dataset)
    monkeypatch.setenv("SRL_ZOO_CACHE_BUDGET_MB", _budget_mb(40, False))
    cfg = SRLConfig(state_dim=4, img_height=32, img_width=32, batch_size=8,
                    epochs=3, n_actions=4, n_reward_classes=3,
                    losses=(("priors", 1.0),), split_dims=(("priors", -1),),
                    learning_rate=1e-3, device_cache="hybrid")
    runs = {}
    with _one_torch_thread():
        for name, epochs in (("straight", (3,)), ("resumed", (1, 3))):
            folder = str(tmp_path / name)
            for i, n in enumerate(epochs):
                c = cfg.replace(epochs=n)
                c.save(folder)
                learner = SRL4robotics(c, log_folder=folder, device="cpu")
                learner.learn(ds, resume=i > 0)
            runs[name] = learner
    a, b = runs["straight"], runs["resumed"]
    assert a._hot_store.epoch == b._hot_store.epoch == 3
    assert a._hot_store.start == b._hot_store.start
    np.testing.assert_array_equal(a._hot_store.slot_of, b._hot_store.slot_of)
    _store_matches_dataset(b._hot_store, ds)
    ha = np.load(tmp_path / "straight" / "loss_history.npz")
    hb = np.load(tmp_path / "resumed" / "loss_history.npz")
    for k in ha.files:
        np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_train_cli_streams_a_folder_without_frames(jpeg_dataset, tmp_path):
    """A folder without frames.npy trains from its JPEGs (at the CLI's
    224 x 224) with --device-cache auto, and exports by streaming."""
    from srl_zoo_tpu_torch.train import main
    folder = _without_frames(jpeg_dataset, tmp_path / "nf")
    native.reset_counts()
    with _one_torch_thread():
        run = main(["--data-folder", folder, "--losses", "autoencoder",
                    "--state-dim", "4", "-bs", "16", "--epochs", "1",
                    "--training-set-size", "40", "--log-folder",
                    str(tmp_path / "run"), "--device", "cpu",
                    "--num-cpu", "2"])
    assert SRLConfig.load(run).img_height == 224
    states = np.load(os.path.join(run, "states_rewards.npz"))["states"]
    assert states.shape == (96, 4) and np.isfinite(states).all()
    assert native.counts["jpeg_native"] >= 96


def test_pipeline_preprocesses_recorded_episodes(tmp_path, monkeypatch):
    """The port's pipeline takes a folder of record_* episodes: it
    preprocesses them, builds both frames caches at --img-size and runs
    its grid on them."""
    from srl_zoo_tpu_torch.data.record import DatasetRecorder
    from srl_zoo_tpu_torch.pipeline import main
    folder = str(tmp_path / "data" / "rec")
    _record(DatasetRecorder, folder)
    monkeypatch.chdir(tmp_path)
    with _one_torch_thread():
        results = main(["--data-folder", folder, "--losses", "autoencoder",
                        "--state-dims", "4", "--epochs", "1", "-bs", "8",
                        "--img-size", "32", "--no-grids", "--device",
                        "cpu"])
    for name in ("preprocessed_data.npz", "ground_truth.npz", "frames.npy",
                 "frames_2.npy"):
        assert os.path.exists(os.path.join(folder, name)), name
    assert np.load(os.path.join(folder, "frames.npy")).shape == \
        (21, 32, 32, 3)
    assert len(results) == 1 and np.isfinite(results[0]["knn_mse"])


def test_jax_hybrid_validation_reads_overwritten_slots(jpeg_dataset,
                                                       tmp_path,
                                                       monkeypatch):
    """The JAX learner's rotating hybrid store hands the slots of leaving
    validation rows to entering training rows during the training cold
    phase, and its validation hot phase then reads those slots: some of
    its validation rows see another row's frame (ROADMAP section C). The
    port holds those slots until validation's hot phase is done, and
    every row it reads there holds its own frame."""
    from srl_zoo_tpu.data import device_cache as jdc
    from srl_zoo_tpu.data.schema import load_dataset as jax_load
    from srl_zoo_tpu.training.learner import SRL4robotics as JaxLearner
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.training.learner import SRL4robotics
    ds = load_dataset(jpeg_dataset)
    kw = dict(state_dim=4, img_height=32, img_width=32, batch_size=8,
              epochs=2, n_actions=4, n_reward_classes=3,
              device_cache="hybrid")
    monkeypatch.setattr(jdc, "DEFAULT_MAX_BYTES", 32 * 32 * 3 * 40)
    monkeypatch.setenv("SRL_ZOO_CACHE_BUDGET_MB", _budget_mb(40, False))
    wrong = {}

    def checked(learner, frames_of, name):
        real = learner._run_eval

        def run_eval(phases, *args):
            store = learner._hot_store
            frames = frames_of(store)
            for loader, cached in phases:
                if cached:
                    rows = loader.indices
                    got = frames[store.slot_of[rows]]
                    bad = (got != np.asarray(ds.frames[rows])).any(
                        axis=(1, 2, 3))
                    wrong[name] = wrong.get(name, 0) + int(bad.sum())
            return real(phases, *args)
        learner._run_eval = run_eval

    jl = JaxLearner(JaxConfig(**kw, log_folder=str(tmp_path / "j")),
                    log_folder=str(tmp_path / "j"))
    checked(jl, lambda st: np.asarray(jax.device_get(st.cache["frames"])),
            "jax")
    jl.learn(jax_load(jpeg_dataset))
    pl = SRL4robotics(SRLConfig(**kw), log_folder=str(tmp_path / "p"),
                      device="cpu")
    checked(pl, lambda st: st.cache["frames"].numpy(), "port")
    with _one_torch_thread():
        pl.learn(ds)
    assert wrong["jax"] > 0 and wrong["port"] == 0, wrong
