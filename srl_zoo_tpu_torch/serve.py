#!/usr/bin/env python
"""Serve a trained SRL encoder over HTTP on the GPU (port of ``serve.py``).

POST raw npy bytes of a uint8 observation (H, W, C) or batch (B, H, W, C)
to ``/encode`` and receive npy bytes of float32 states; GET /healthz returns
run metadata. Requests are encoded one at a time, or grouped by the
coalescer (``--coalesce-ms``) into one device batch of up to
``--max-batch`` rows. Either way every encode runs on one long-lived
thread, which the server warms before it returns, at every batch size
from 1 to ``--max-batch`` (on a GPU that also captures each size's CUDA
graph): PyTorch gives each thread its own cuDNN and cuBLAS handles, so
the first encode on a fresh thread pays for them again.

  python -m srl_zoo_tpu_torch.serve --log-folder logs/<run> --port 8080
  # client:
  #   buf = io.BytesIO(); np.save(buf, obs)
  #   states = np.load(io.BytesIO(requests.post(url, data=buf.getvalue()).content))

Status codes: 400 for a malformed request (not npy, not uint8, wrong
shape), 413 for a body over ``--max-body-mb``, 500 for a server fault.
Every request is validated before it is enqueued, so one malformed request
fails alone.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from srl_zoo_tpu_torch.inference import StateEncoder


class CoalescedEncodeError(RuntimeError):
    """A coalesced group's shared encode failed server-side.

    Raised (wrapping the original) instead of re-raising the worker's
    exception directly: every row was geometry-validated BEFORE enqueue, so
    anything escaping the group encode — even a ValueError/TypeError from
    np.concatenate or the model — is OUR fault, and must not fall
    into the handler's (ValueError, TypeError) -> 400 client-error branch
    (a 400 here would blind load balancers to a genuinely sick server)."""


class BatchCoalescer:
    """Group concurrent /encode requests into one device batch.

    With the plain lock, N concurrent clients run the GPU at batch 1, N
    times. The coalescer holds the first request for up to ``window_ms``
    while more arrive, concatenates up to
    ``max_batch`` rows, encodes ONCE, and hands each caller its slice.
    Single-client latency cost is bounded by window_ms; zero when a full
    batch forms sooner. Thread-safe; used instead of the lock when
    --coalesce-ms > 0."""

    def __init__(self, encoder, window_ms: float = 2.0):
        self.encoder = encoder
        self.window_s = window_ms / 1000.0
        self.max_rows = encoder.max_batch
        self._lock = threading.Lock()
        self._queue: list = []  # [(obs_batch, event, slot_dict)]
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="srl-serve-coalescer")
        self._wake = threading.Event()
        self._thread.start()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker thread; fail any still-queued requests.

        Without this the daemon worker (and the StateEncoder it pins)
        outlives server_close(), leaking one thread + model per retired
        server in long-lived processes."""
        with self._lock:
            self._closed = True
            pending, self._queue = self._queue, []
        self._wake.set()
        for _, done, slot in pending:
            slot["err"] = CoalescedEncodeError("server shutting down")
            done.set()
        self._thread.join(timeout)

    def encode(self, obs: np.ndarray) -> np.ndarray:
        """Validate + enqueue one request; blocks until its states arrive."""
        single = obs.ndim == 3
        batch = obs[None] if single else obs
        # validate geometry HERE so one malformed request fails alone,
        # never the whole coalesced group
        expected = (self.encoder.cfg.img_height, self.encoder.cfg.img_width,
                    self.encoder.cfg.n_channels)
        if batch.ndim != 4 or batch.shape[1:] != expected:
            raise ValueError(
                f"expected uint8 observations of shape {expected} "
                f"(or batched (B, *{expected})), got {obs.shape}")
        done = threading.Event()
        slot: dict = {}
        with self._lock:
            if self._closed:
                raise CoalescedEncodeError("coalescer is closed")
            self._queue.append((np.asarray(batch, np.uint8), done, slot))
        self._wake.set()
        done.wait()
        if "err" in slot:
            err = slot["err"]
            if isinstance(err, CoalescedEncodeError):
                raise err
            raise CoalescedEncodeError(
                f"group encode failed: {type(err).__name__}: {err}") from err
        states = slot["states"]
        return states[0] if single else states

    def _run(self):
        while True:
            self._wake.wait()
            with self._lock:
                if self._closed:
                    return
                if not self._queue:
                    self._wake.clear()
                    continue
            # first request opens the window
            deadline = time.monotonic() + self.window_s
            while time.monotonic() < deadline:
                with self._lock:
                    if sum(len(b) for b, _, _ in self._queue) >= self.max_rows:
                        break
                time.sleep(self.window_s / 10.0)
            with self._lock:
                group, self._queue = self._queue, []
                if not self._closed:  # keep close()'s wake-up visible
                    self._wake.clear()  # queue drained; next append re-sets
            if not group:
                continue
            try:
                stacked = np.concatenate([b for b, _, _ in group])
                states = self.encoder.encode(stacked)
                off = 0
                for b, done, slot in group:
                    slot["states"] = states[off:off + len(b)]
                    off += len(b)
                    done.set()
            except BaseException as e:
                # deliver the failure to the WHOLE group: a worker that died
                # without setting the events would wedge every pending and
                # future request forever (encode()'s done.wait() is
                # unbounded by design — requests must not time out under
                # a kernel build at first use)
                for _, done, slot in group:
                    slot["err"] = e
                    done.set()
                if not isinstance(e, Exception):
                    # SystemExit/KeyboardInterrupt-class escaping library
                    # code: close the coalescer so future encodes raise
                    # instead of enqueueing onto a dead worker, fail the
                    # queue, and exit (the error already reached every
                    # caller via its slot; re-raising in a daemon thread
                    # reaches only the threading excepthook)
                    with self._lock:
                        self._closed = True
                        pending, self._queue = self._queue, []
                    for _, done, slot in pending:
                        slot["err"] = CoalescedEncodeError(
                            f"coalescer worker died: {e!r}")
                        done.set()
                    return


def make_handler(encoder, info: dict, run_encode, max_body_mb: int = 256):
    """``run_encode(obs)`` encodes one validated request."""
    max_body = max_body_mb * 1024 * 1024

    class Handler(BaseHTTPRequestHandler):
        timeout = 60  # a stalled client must not pin a handler thread

        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code: int, body: bytes,
                   ctype: str = "application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, json.dumps(info).encode(),
                            "application/json")
            else:
                self._reply(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/encode":
                self._reply(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > max_body:
                    # bound memory: one oversized request must not OOM the
                    # server (requests serialize through the encode thread)
                    self._reply(413, f"body {length} B exceeds the "
                                     f"{max_body_mb} MiB limit".encode(),
                                "text/plain")
                    return
                obs = np.load(io.BytesIO(self.rfile.read(length)),
                              allow_pickle=False)
                if obs.dtype != np.uint8:
                    # np.asarray(..., uint8) would truncate float images to
                    # ~all-zeros and return garbage states with a 200
                    self._reply(400, f"expected uint8 pixels, got "
                                     f"{obs.dtype}".encode(), "text/plain")
                    return
                # geometry validated HERE, on both the serial and coalescer
                # paths: after this point any ValueError/TypeError escaping
                # the encoder is a SERVER fault and must be a 500, or load
                # balancers can't see a sick server
                expected = (encoder.cfg.img_height, encoder.cfg.img_width,
                            encoder.cfg.n_channels)
                if obs.shape != expected and (
                        obs.ndim != 4 or obs.shape[1:] != expected):
                    self._reply(400, f"expected uint8 observations of shape "
                                     f"{expected} (or batched (B, "
                                     f"*{expected})), got "
                                     f"{obs.shape}".encode(), "text/plain")
                    return
            except Exception as e:  # malformed payload: the client's fault
                self._reply(400, str(e).encode(), "text/plain")
                return
            try:
                states = run_encode(obs)
                buf = io.BytesIO()
                np.save(buf, np.asarray(states, np.float32))
                self._reply(200, buf.getvalue())
            except Exception as e:  # encoder/backend failure: OUR fault —
                self._reply(500, str(e).encode(), "text/plain")  # let LBs see it

    return Handler


def build_server(log_folder: str, host: str = "127.0.0.1", port: int = 8080,
                 max_batch: int = 32,
                 max_body_mb: int = 256,
                 coalesce_ms: float = 0.0,
                 device=None) -> ThreadingHTTPServer:
    """The server on ``device`` (None = cuda); call serve_forever()."""
    encoder = StateEncoder.load(log_folder, max_batch=max_batch,
                                device=device)
    cfg = encoder.cfg
    info = {"log_folder": log_folder, "state_dim": cfg.state_dim,
            "model_type": cfg.model_type,
            "img_shape": [cfg.img_height, cfg.img_width, cfg.n_channels],
            "losses": dict(cfg.losses), "device": str(encoder.device)}
    if coalesce_ms > 0:
        coalescer = BatchCoalescer(encoder, coalesce_ms)
        run_encode, close = coalescer.encode, coalescer.close
    else:
        coalescer = None
        worker = ThreadPoolExecutor(1, thread_name_prefix="srl-serve-encode")
        close = worker.shutdown

        def run_encode(obs):
            return worker.submit(encoder.encode, obs).result()
    # not on a client's clock: the first encode builds the kernels, and the
    # first encode of each batch size picks its cuDNN plans and, on a GPU,
    # captures that size's CUDA graph (inference.py), which takes far
    # longer than the encode. Warm on the encode thread, which holds the
    # handles. Every chunk the encoder runs has 1..max_batch rows, so
    # after this loop every request replays a graph.
    blank = np.zeros((max_batch,) + cfg.img_shape, np.uint8)
    try:
        for rows in range(1, max_batch + 1):
            run_encode(blank[:rows])
    except BaseException:
        close()
        raise

    class _Server(ThreadingHTTPServer):
        # socketserver's default listen backlog of 5 drops the SYNs of a
        # burst of concurrent clients, which then wait ~1 s to retry
        request_queue_size = 128

        def server_close(self):  # stop the encode thread with the server
            close()
            super().server_close()

    server = _Server(
        (host, port), make_handler(encoder, info, run_encode, max_body_mb))
    server.coalescer = coalescer  # introspectable (tests, ops tooling)
    return server


def main(argv=None):
    p = argparse.ArgumentParser(description="Serve a trained SRL encoder")
    p.add_argument("--log-folder", type=str, required=True)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-body-mb", type=int, default=256,
                   help="Reject request bodies over this size (HTTP 413)")
    p.add_argument("--coalesce-ms", type=float, default=0.0,
                   help="Group concurrent requests arriving within this "
                        "window into one device batch (up to --max-batch "
                        "rows). 0 = off. Under N concurrent clients this "
                        "turns N batch-1 encodes into one batched encode; "
                        "single-client latency grows by at most the "
                        "window")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    args = p.parse_args(argv)
    server = build_server(args.log_folder, args.host, args.port,
                          args.max_batch, args.max_body_mb,
                          args.coalesce_ms, args.device)
    print(f"Serving {args.log_folder} on http://{args.host}:{args.port} "
          "(POST /encode, GET /healthz)")
    server.serve_forever()


if __name__ == "__main__":
    main()
