"""The port's inference slice against the JAX package, on the CPU.

One trained JAX run (the shared ``trained_ae_cli_run``, copied so the
bridge can write into it) goes through the bridge CLI into the port; the
port's encode, export, KNN-MSE and server are then held against the JAX
package on the same weights and inputs. Tolerances: states 1e-4 absolute
(f32 convolutions sum in another order), KNN-MSE 1e-6 relative.
"""

import io
import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from srl_zoo_tpu_torch import bridge
from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.inference import StateEncoder
from srl_zoo_tpu_torch.ops.knn_topk import knn_topk_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_run(trained_ae_cli_run, tmp_path_factory):
    """A copy of the JAX run with srl_model.pth written by the bridge CLI."""
    run = str(tmp_path_factory.mktemp("torch_zoo") / "run")
    shutil.copytree(trained_ae_cli_run, run)
    bridge.main(["--log-folder", run])
    return run


@pytest.fixture(scope="module")
def jax_states(trained_ae_cli_run, synthetic_dataset):
    from srl_zoo_tpu.training.learner import SRL4robotics
    return SRL4robotics.load(trained_ae_cli_run).predict_states(
        synthetic_dataset)


def test_bridge_cli_encode_matches_jax(trained_ae_cli_run, port_run,
                                       synthetic_dataset):
    from srl_zoo_tpu.inference import StateEncoder as JaxStateEncoder
    frames = np.asarray(synthetic_dataset.frames[:20])
    want = JaxStateEncoder.load(trained_ae_cli_run).encode(frames)
    enc = StateEncoder.load(port_run, device="cpu")
    got = enc.encode(frames)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(enc.encode(frames[3]), want[3], rtol=0,
                               atol=1e-4)
    assert enc.encode(frames[:0]).shape == (0, enc.cfg.state_dim)
    with pytest.raises(ValueError, match="expected uint8 observations"):
        enc.encode(frames[:, :16])


def test_bridge_reads_flax_msgpack_and_skips_decoder(trained_ae_cli_run):
    import flax.serialization
    path = os.path.join(trained_ae_cli_run, "srl_model.msgpack")
    with open(path, "rb") as f:
        want = flax.serialization.msgpack_restore(f.read())
    tree = bridge.read_flax_msgpack(path)
    flat_got = bridge._flatten(tree)
    flat_want = bridge._flatten(want)
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], np.asarray(flat_want[k]))
    sd, skipped = bridge.state_dict_from_jax(tree["params"],
                                             tree["batch_stats"])
    # the decoder is ported now: a config-1 run skips no key
    assert skipped == []
    assert sd["encoder.convs.0.weight"].shape == (64, 3, 7, 7)
    assert sd["decoder.deconvs.0.weight"].shape == (64, 64, 4, 4)


def test_export_cli_matches_jax_predict_states(port_run, synthetic_dataset,
                                               jax_states):
    from srl_zoo_tpu_torch.evaluation import predict_dataset
    path = predict_dataset.main(["--log-folder", port_run, "--data-folder",
                                 synthetic_dataset.data_folder, "--device",
                                 "cpu"])
    out = np.load(path)
    assert out["states"].shape == jax_states.shape
    np.testing.assert_allclose(out["states"], jax_states, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out["rewards"], synthetic_dataset.rewards)


def test_predict_states_follows_the_index_order(port_run, synthetic_dataset,
                                                jax_states):
    from srl_zoo_tpu_torch.data.device_cache import build_cache
    from srl_zoo_tpu_torch.data.schema import load_dataset
    from srl_zoo_tpu_torch.evaluation.predict_dataset import predict_states
    enc = StateEncoder.load(port_run, device="cpu")
    store = build_cache(load_dataset(synthetic_dataset.data_folder),
                        enc.device)
    n = len(store["frames"])
    order = np.random.RandomState(4).permutation(n)[:30]
    np.testing.assert_allclose(predict_states(enc, store, order),
                               jax_states[order], rtol=0, atol=1e-4)
    with pytest.raises(IndexError):
        predict_states(enc, store, [0, n])


@pytest.mark.parametrize("n_samples,seed", [(None, 0), (50, 3)])
def test_knn_mse_matches_jax(synthetic_dataset, jax_states, n_samples, seed):
    from srl_zoo_tpu.evaluation.knn import knn_mse as jax_knn_mse
    from srl_zoo_tpu_torch.evaluation.knn import knn_mse
    gt = synthetic_dataset.ground_truth_states
    want, want_q, want_nb = jax_knn_mse(jax_states, gt, k=5,
                                        n_samples=n_samples, seed=seed)
    got, got_q, got_nb = knn_mse(jax_states, gt, k=5, n_samples=n_samples,
                                 seed=seed, device="cpu")
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(got_nb, want_nb)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_knn_mse_keeps_the_neighbour_order_of_states_far_from_origin():
    """States 1e3 from the origin with neighbours ~1e-2 apart: in float32,
    |q|^2 + |r|^2 - 2 q.r loses the neighbour order to cancellation, and
    the port's knn_mse centres the states first. The score must be the
    exact (float64) one; the uncentred top-k shows the fault it avoids,
    and the JAX package, which does not centre, shows it too."""
    from srl_zoo_tpu.evaluation.knn import knn_mse as jax_knn_mse
    from srl_zoo_tpu_torch.evaluation.knn import centre, knn_mse
    rng = np.random.RandomState(7)
    n, d, k = 300, 16, 5
    states = (1e3 + 1e-2 * rng.randn(n, d)).astype(np.float32)
    gt = rng.randn(n, 3).astype(np.float32)
    s64 = states.astype(np.float64)
    d2 = ((s64[:, None, :] - s64[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    exact_nb = np.argsort(d2, axis=1, kind="stable")[:, :k]
    exact = float(np.mean(np.square(gt[:, None, :] - gt[exact_nb])))

    score, _, nbrs = knn_mse(states, gt, k=k, device="cpu")
    np.testing.assert_array_equal(nbrs, exact_nb)
    np.testing.assert_allclose(score, exact, rtol=1e-6)

    t = torch.from_numpy(states)
    raw = knn_topk_plain(t, t, k + 1)[1].numpy()
    centred = knn_topk_plain(centre(t), centre(t), k + 1)[1].numpy()
    want = np.concatenate([np.arange(n)[:, None], exact_nb], axis=1)
    np.testing.assert_array_equal(centred, want)
    assert (raw != want).any(axis=1).mean() > 0.5
    jax_score, _, jax_nbrs = jax_knn_mse(states, gt, k=k)
    assert (jax_nbrs != exact_nb).any(axis=1).mean() > 0.5
    assert abs(jax_score - exact) > 0.05 * exact


def test_knn_mse_takes_k_above_the_kernel_limit_on_cpu():
    """k + 1 > MAX_K: the GPU kernel (and the JAX package) refuse it, the
    CPU path does not. Small integer states with a mean of exactly 0 (so
    centring moves nothing) make every float32 distance exact, so the
    float64 order (ties to the lowest index) is the answer."""
    from srl_zoo_tpu_torch.evaluation.knn import knn_mse
    from srl_zoo_tpu_torch.ops.knn_topk import MAX_K
    rng = np.random.RandomState(8)
    n, k = 200, MAX_K
    half = rng.randint(-4, 5, (n // 2, 8)).astype(np.float32)
    states = np.concatenate([half, -half])
    gt = rng.randn(n, 3).astype(np.float32)
    s64 = states.astype(np.float64)
    d2 = ((s64[:, None, :] - s64[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, -1.0)  # self first, then dropped
    exact_nb = np.argsort(d2, axis=1, kind="stable")[:, 1:k + 1]
    exact = float(np.mean(np.square(gt[:, None, :] - gt[exact_nb])))
    score, _, nbrs = knn_mse(states, gt, k=k, device="cpu")
    np.testing.assert_array_equal(nbrs, exact_nb)
    np.testing.assert_allclose(score, exact, rtol=1e-6)


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server(port_run):
    from srl_zoo_tpu_torch.serve import build_server
    srv = build_server(port_run, port=0, coalesce_ms=5, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(10)
    assert not t.is_alive()


def _post(url, arr, timeout=60):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(f"{url}/encode", data=buf.getvalue(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, np.load(io.BytesIO(r.read()))
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_server_single_and_batched(server, port_run, synthetic_dataset):
    frames = np.asarray(synthetic_dataset.frames[:6])
    want = StateEncoder.load(port_run, device="cpu").encode(frames)
    with urllib.request.urlopen(f"{server}/healthz", timeout=30) as r:
        info = json.loads(r.read())
    assert info["state_dim"] == want.shape[1] and info["device"] == "cpu"
    code, one = _post(server, frames[0])
    assert code == 200 and one.shape == (want.shape[1],)
    np.testing.assert_allclose(one, want[0], rtol=0, atol=1e-5)
    code, many = _post(server, frames)
    assert code == 200
    np.testing.assert_allclose(many, want, rtol=0, atol=1e-5)


def test_server_coalesces_concurrent_requests(server, port_run,
                                              synthetic_dataset):
    frames = np.asarray(synthetic_dataset.frames[:8])
    want = StateEncoder.load(port_run, device="cpu").encode(frames)
    results = [None] * 8

    def client(i):
        results[i] = _post(server, frames[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    for i, (code, states) in enumerate(results):
        assert code == 200
        np.testing.assert_allclose(states, want[i], rtol=0, atol=1e-5)


@pytest.mark.parametrize("payload,needle", [
    (np.zeros((2, 32, 32, 3), np.float32), "uint8"),
    (np.zeros((2, 16, 32, 3), np.uint8), "expected uint8 observations"),
    (np.zeros((32, 32), np.uint8), "expected uint8 observations"),
])
def test_server_rejects_malformed_requests(server, payload, needle):
    code, msg = _post(server, payload)
    assert code == 400 and needle in msg


def test_server_rejects_a_body_that_is_not_npy(server):
    req = urllib.request.Request(f"{server}/encode", data=b"junk",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


@pytest.mark.parametrize("coalesce_ms", [0, 5])
def test_server_encodes_on_one_warmed_thread(port_run, synthetic_dataset,
                                             monkeypatch, coalesce_ms):
    """Warm-up and requests encode on the same long-lived thread, so a
    client never pays for the per-thread cuDNN state the warm-up built."""
    from srl_zoo_tpu_torch.serve import build_server
    threads = []
    encode = StateEncoder.encode

    def recording_encode(self, obs):
        threads.append(threading.get_ident())
        return encode(self, obs)

    monkeypatch.setattr(StateEncoder, "encode", recording_encode)
    srv = build_server(port_run, port=0, max_batch=4,
                       coalesce_ms=coalesce_ms, device="cpu")
    assert len(threads) == 4 and threading.get_ident() not in threads
    assert srv.request_queue_size >= 64  # a burst of clients is not dropped
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        frames = np.asarray(synthetic_dataset.frames[:3])
        code, one = _post(url, frames[0])
        assert code == 200
        code, many = _post(url, frames)
        assert code == 200
        np.testing.assert_allclose(many[0], one, rtol=0, atol=1e-5)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(10)
    assert len(threads) == 6 and len(set(threads)) == 1


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_the_jax_package(port_run,
                                                      synthetic_dataset):
    """After importing every module of the port (found by walking the
    package) and the card test modules, which run alone on the card, and
    a CPU encode, neither jax nor srl_zoo_tpu is loaded."""
    np.save(os.path.join(port_run, "_probe.npy"),
            np.asarray(synthetic_dataset.frames[:2]))
    code = (
        "import importlib, pkgutil, sys, numpy as np\n"
        "sys.path.insert(0, 'tests')\n"
        "import srl_zoo_tpu_torch\n"
        "for card in ('card_kernels', 'card_steps', 'card_paths',\n"
        "             'epoch_card', 'encode_graph'):\n"
        "    importlib.import_module('test_torch_zoo_' + card)\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    srl_zoo_tpu_torch.__path__, 'srl_zoo_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'srl_zoo_tpu_torch.pipeline' in names, names\n"
        "assert 'srl_zoo_tpu_torch.plotting.raster' in names, names\n"
        "for new in ('data.synthetic', 'parallel.mesh', 'ops.sharded_store',\n"
        "            'utils.doctor', 'utils.profiling', 'ops.pooling',\n"
        "            'ops.subpixel', 'export.torch_export'):\n"
        "    assert 'srl_zoo_tpu_torch.' + new in names, names\n"
        "from srl_zoo_tpu_torch.evaluation.knn import knn_mse\n"
        "from srl_zoo_tpu_torch.inference import StateEncoder\n"
        f"run = {port_run!r}\n"
        "enc = StateEncoder.load(run, device='cpu')\n"
        "s = enc.encode(np.load(run + '/_probe.npy'))\n"
        "knn_mse(np.random.rand(10, 3), np.random.rand(10, 2), device='cpu')\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax') or\n"
        "       m.startswith(('jax.', 'flax.', 'optax.')) or\n"
        "       m == 'srl_zoo_tpu' or m.startswith('srl_zoo_tpu.')]\n"
        "print(s.shape, bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().startswith("(2, ")


def test_resolve_device_none_raises_without_a_gpu():
    from srl_zoo_tpu_torch.utils.device import resolve_device
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_strict_float32_times_the_convolution_plans_with_tf32_off():
    """``use_strict_float32`` turns on cuDNN's timed plan choice and keeps
    TF32 and the bfloat16 reduced-precision reduction off, whatever the
    switches were before, and leaves ``cudnn.deterministic`` as it was;
    the process's switches are restored after."""
    from srl_zoo_tpu_torch.utils.device import use_strict_float32
    switches = ((torch.backends.cudnn, "benchmark"),
                (torch.backends.cudnn, "deterministic"),
                (torch.backends.cudnn, "allow_tf32"),
                (torch.backends.cuda.matmul, "allow_tf32"),
                (torch.backends.cuda.matmul,
                 "allow_bf16_reduced_precision_reduction"))
    saved = [getattr(owner, name) for owner, name in switches]
    try:
        for owner, name in switches:
            setattr(owner, name, name != "benchmark")
        use_strict_float32()
        assert torch.backends.cudnn.benchmark is True
        assert torch.backends.cudnn.deterministic is True
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul \
            .allow_bf16_reduced_precision_reduction is False
    finally:
        for (owner, name), value in zip(switches, saved):
            setattr(owner, name, value)


@pytest.mark.parametrize("model_type", ["mlp", "linear"])
def test_config_takes_the_dense_model_types(model_type):
    """The mlp and linear types, once refused, configure at either
    compute dtype; an unknown type or dtype still raises."""
    for dtype in ("float32", "bfloat16"):
        cfg = SRLConfig(model_type=model_type, compute_dtype=dtype)
        assert (cfg.model_type, cfg.compute_dtype) == (model_type, dtype)
    with pytest.raises(ValueError, match="Unknown model type"):
        SRLConfig(model_type=f"{model_type}2")
    with pytest.raises(ValueError, match="Unknown compute dtype"):
        SRLConfig(model_type=model_type, compute_dtype="float16")
