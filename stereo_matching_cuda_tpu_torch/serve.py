"""Long-lived stereo serving mode, stdlib HTTP (counterpart of
``stereo_matching_cuda_tpu/serve.py``).

One worker thread owns the device (the card unless the server is made
with ``device="cpu"``); handler threads decode the images, queue the
request and wait.  Whatever same-shape, same-config requests are queued
when the device frees up run as ONE ``stereo_pipeline_batch`` call of N
frames (one launch of each kernel of the route for the group), so N
concurrent clients share one device pass.  The kernels are built at
first use and compile nothing per shape, so groups are not padded.

Protocol (JSON over HTTP, images base64):

  GET  /healthz             → {"status", "backend" ("cuda" | "cpu"),
                               "device", "frames_served", "uptime_s"}
  POST /disparity           body {"left": b64, "right": b64,
                               optional "d_min", "d_max"}
       → {"disparity_png": b64 uint8 PNG (write_mat-normalized, the
          reference's artifact convention), "disparity_pfm": b64 PFM
          (raw float disparities incl. the -115 occlusion fill),
          "height", "width", "occluded_pixels", "occluded_pct",
          "seconds", "batched_n"}

Request bodies above 256 MB are rejected with 413 before reading.
Per-request "d_min"/"d_max" overrides are honored; ``allowed_d_ranges``
(CLI ``--serve-ranges``) limits them to a set of (d_min, d_max) pairs,
and others get 403.  Any format ``read_image`` decodes works (TGA too);
float and 16-bit inputs reach the 8-bit validation error.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import tempfile
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .config import StereoConfig
from .metrics import occlusion_stats

# One POST buffers the raw body plus its base64-decoded copy before any
# validation; cap it so a single oversized request cannot exhaust the
# long-lived serving process's memory (a 6 MP RGB pair is ~50 MB as
# base64 PNG).
_MAX_BODY_BYTES = 256 << 20


def _decode_image(b64: str) -> np.ndarray:
    """base64 bytes → image array via the magic-sniffing reader (the
    readers are file-path based; round-trip through a temp file)."""
    raw = base64.b64decode(b64, validate=True)
    fd, path = tempfile.mkstemp(suffix=".img")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(raw)
        from .utils.io import read_image

        try:
            return read_image(path)
        except ValueError:
            from .utils.imagefmt import read_tga

            return read_tga(path)   # TGA has no magic; last resort
    finally:
        os.unlink(path)


def _encode_file(write_fn, arr) -> str:
    fd, path = tempfile.mkstemp(suffix=".out")
    os.close(fd)
    try:
        write_fn(path, arr)
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode("ascii")
    finally:
        os.unlink(path)


class _Request:
    """One queued /disparity request awaiting device time."""

    __slots__ = ("left", "right", "cfg", "event", "result", "error",
                 "batched_n")

    def __init__(self, left, right, cfg):
        self.left = left
        self.right = right
        self.cfg = cfg
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.batched_n = 1


class BatchExecutor:
    """Micro-batching device executor.

    One worker thread owns the device; handler threads submit requests
    and block on a per-request event.  All queued requests with the
    SAME frame shape and config coalesce into one
    ``stereo_pipeline_batch`` call of up to ``max_batch`` frames; a lone
    request runs ``compute_disparity_stacked``.  Whatever raises while
    requests are dequeued, grouped or run is handed to every request it
    leaves unanswered, and the worker lives on.

    ``window_s`` optionally sleeps after the first dequeue so near-
    simultaneous requests can coalesce; the default 0 adds no latency
    (whatever is already queued when the device frees up batches).
    """

    _KEYS = ("occlusion_filled", "occlusion")

    def __init__(self, max_batch: int = 8, window_s: float = 0.0,
                 device: torch.device | str = "cuda"):
        self.max_batch = max(1, int(max_batch))
        self.window_s = window_s
        self.device = torch.device(device)
        self._q: list[_Request] = []
        self._cv = threading.Condition()
        self._thread = None

    def submit(self, left, right, cfg) -> _Request:
        """Blocks until the request is served; returns it with
        ``result`` (dict of numpy outputs) or ``error`` set."""
        req = _Request(left, right, cfg)
        with self._cv:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, daemon=True,
                    name="stereo-batch-executor")
                self._thread.start()
            self._q.append(req)
            self._cv.notify()
        req.event.wait()
        return req

    # ---- worker side -------------------------------------------------
    def _worker(self):
        while True:
            with self._cv:
                while not self._q:
                    self._cv.wait()
            items = []
            try:
                if self.window_s:
                    time.sleep(self.window_s)
                with self._cv:
                    items, self._q = self._q, []
                # group by (shape, cfg) in first-arrival order
                groups: dict = {}
                for it in items:
                    groups.setdefault((it.left.shape, it.cfg), []).append(it)
                for (_, cfg), reqs in groups.items():
                    for i in range(0, len(reqs), self.max_batch):
                        self._run_group(reqs[i:i + self.max_batch], cfg)
            except Exception as e:   # the worker must outlive any request
                traceback.print_exc()
                for r in items:
                    if not r.event.is_set():
                        r.error = e
                        r.event.set()

    def _run_group(self, reqs: list, cfg: StereoConfig):
        from .pipeline import (compute_disparity_stacked, labels_to_host,
                               stereo_pipeline_batch)

        try:
            if len(reqs) == 1:
                r = reqs[0]
                r.result = compute_disparity_stacked(
                    r.left, r.right, cfg, self.device, keys=self._KEYS,
                    compact=True)
                r.event.set()
                return
            lefts, rights = (torch.from_numpy(np.stack([getattr(r, k) for r in reqs]))
                             .to(self.device) for k in ("left", "right"))
            out = stereo_pipeline_batch(lefts, rights, cfg)
            # whole group, both outputs: ONE device-to-host copy
            arr = labels_to_host(torch.stack([out[k] for k in self._KEYS]), cfg)
            for i, r in enumerate(reqs):
                r.result = {k: arr[j][i] for j, k in enumerate(self._KEYS)}
                r.batched_n = len(reqs)
                r.event.set()
        except Exception as e:   # surface to every waiting handler
            for r in reqs:
                if not r.event.is_set():
                    r.error = e
                    r.event.set()


def _device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, else the device type."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class StereoServer(ThreadingHTTPServer):
    """HTTP server holding the config, the micro-batching device
    executor and serving stats.  Port 0 picks an ephemeral port
    (tests)."""

    daemon_threads = True
    # Connections the listening socket queues before accept (socketserver
    # keeps 5): past it a burst's extra connects are dropped and retried
    # by the client's TCP a second later.
    request_queue_size = 128

    def __init__(self, addr, cfg: StereoConfig, allowed_d_ranges=None,
                 max_batch: int = 8, batch_window_s: float = 0.0,
                 device: torch.device | str = "cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("serving on cuda, but torch finds no CUDA device")
        super().__init__(addr, _Handler)
        self.cfg = cfg
        self.device = device
        self.executor = BatchExecutor(max_batch, batch_window_s, device)
        self.stats_lock = threading.Lock()
        self.frames_served = 0
        self.t_start = time.time()
        # None = any override allowed; else a collection of permitted
        # (d_min, d_max) pairs.
        self.allowed_d_ranges = (
            None if allowed_d_ranges is None
            else {(int(a), int(b)) for a, b in allowed_d_ranges})


class _Handler(BaseHTTPRequestHandler):
    server: StereoServer
    # A reply is two writes (headers, body): with Nagle's algorithm the
    # body waits for the client's delayed ACK of the headers.
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):   # structured one-line log
        print(f"serve: {self.address_string()} {fmt % args}", flush=True)

    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path != "/healthz":
            return self._reply(404, {"error": f"unknown path {self.path}"})
        self._reply(200, {
            "status": "ok",
            "backend": self.server.device.type,
            "device": _device_name(self.server.device),
            "frames_served": self.server.frames_served,
            "uptime_s": round(time.time() - self.server.t_start, 1),
        })

    def do_POST(self):
        if self.path != "/disparity":
            return self._reply(404, {"error": f"unknown path {self.path}"})
        try:
            n = int(self.headers.get("Content-Length", "0"))
            if n > _MAX_BODY_BYTES:
                return self._reply(413, {
                    "error": f"body {n} bytes exceeds the "
                             f"{_MAX_BODY_BYTES}-byte limit"})
            req = json.loads(self.rfile.read(n))
            left = _decode_image(req["left"])
            right = _decode_image(req["right"])
        except KeyError as e:
            return self._reply(400, {"error": f"missing field {e}"})
        except Exception as e:  # bad b64 / undecodable image / bad json
            return self._reply(400, {"error": f"bad request: {e}"})
        cfg = self.server.cfg
        try:
            if "d_min" in req or "d_max" in req:
                d_min = req.get("d_min", cfg.d_min)
                d_max = req.get("d_max", cfg.d_max)
                if not all(isinstance(v, int) and not isinstance(v, bool)
                           for v in (d_min, d_max)):
                    raise ValueError(
                        f"d_min/d_max must be integers, got "
                        f"{d_min!r}/{d_max!r}")
                allowed = self.server.allowed_d_ranges
                if allowed is not None and (d_min, d_max) not in allowed:
                    return self._reply(403, {
                        "error": f"disparity range ({d_min}, {d_max}) not "
                                 f"in the server allowlist "
                                 f"{sorted(allowed)}"})
                cfg = dataclasses.replace(cfg, d_min=d_min, d_max=d_max)
            if left.ndim != 3 or left.shape != right.shape:
                raise ValueError(
                    f"need same-shaped color pairs, got {left.shape} vs "
                    f"{right.shape}")
            if left.dtype != np.uint8:
                raise ValueError(f"images must be 8-bit, got {left.dtype}")
            t0 = time.time()
            # the executor serializes device work and coalesces
            # concurrent same-shape requests into one batched pass;
            # it fetches only the outputs the response uses
            req_item = self.server.executor.submit(left, right, cfg)
            if req_item.error is not None:
                raise req_item.error
            out = req_item.result
            dt = time.time() - t0
        except (ValueError, NotImplementedError) as e:
            return self._reply(400, {"error": str(e)})
        except Exception as e:  # unexpected (CUDA error, OOM, ...): the
            # request must still get an HTTP response, not a dropped socket
            return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
        filled = out["occlusion_filled"].astype(np.float32)

        from .utils.io import write_mat_normalize, write_png
        from .utils.pnm import write_pfm

        png_b64 = _encode_file(write_png, write_mat_normalize(filled))
        pfm_b64 = _encode_file(write_pfm, filled)
        with self.server.stats_lock:
            self.server.frames_served += 1
        self._reply(200, {
            "disparity_png": png_b64,
            "disparity_pfm": pfm_b64,
            "height": int(filled.shape[0]),
            "width": int(filled.shape[1]),
            "seconds": round(dt, 4),
            "batched_n": req_item.batched_n,
            **occlusion_stats(out["occlusion"], cfg.v_min),
        })


def make_server(host: str, port: int, cfg: StereoConfig,
                allowed_d_ranges=None, max_batch: int = 8,
                batch_window_s: float = 0.0,
                device: torch.device | str = "cuda") -> StereoServer:
    return StereoServer((host, port), cfg, allowed_d_ranges,
                        max_batch, batch_window_s, device)


def warmup(cfg: StereoConfig, h: int, w: int, max_batch: int = 1,
           device: torch.device | str = "cuda") -> float:
    """Before the first request: build the kernels (nvcc at first use)
    and run one (h, w) frame the way a lone request runs, and, with
    ``max_batch`` > 1, one batch of ``max_batch`` frames the way a group
    runs.  Returns the seconds taken."""
    from .pipeline import (compute_disparity_stacked, labels_to_host,
                           stereo_pipeline_batch)

    device = torch.device(device)
    rng = np.random.default_rng(0)
    pair = rng.integers(0, 256, size=(2, h, w, 3), dtype=np.uint8)
    t0 = time.time()
    compute_disparity_stacked(pair[0], pair[1], cfg, device,
                              keys=BatchExecutor._KEYS, compact=True)
    if max_batch > 1:
        lefts, rights = (torch.from_numpy(np.stack([p] * max_batch)).to(device)
                         for p in pair)
        out = stereo_pipeline_batch(lefts, rights, cfg)
        labels_to_host(torch.stack([out[k] for k in BatchExecutor._KEYS]), cfg)
    return time.time() - t0


def serve_forever(host: str, port: int, cfg: StereoConfig,
                  allowed_d_ranges=None, warmup_hw=None,
                  max_batch: int = 8, device: torch.device | str = "cuda") -> None:
    srv = make_server(host, port, cfg, allowed_d_ranges, max_batch,
                      device=device)
    if warmup_hw is not None:
        h, w = warmup_hw
        print(f"stereo server warming up {h}x{w} frames (kernel build; "
              f"batches of {max_batch})...", flush=True)
        dt = warmup(cfg, h, w, max_batch, srv.device)
        print(f"stereo server warmup done in {dt:.1f}s", flush=True)
    print(f"stereo server on {srv.server_address[0]}:"
          f"{srv.server_address[1]} (backend {srv.device.type}, "
          f"{_device_name(srv.device)}); POST /disparity, GET /healthz",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        print("stereo server shutting down", flush=True)
    finally:
        srv.server_close()
