"""Captioning HTTP server with dynamic micro-batching (counterpart of the
JAX ``server.py``).

A stdlib-only HTTP front end over :class:`.api.Captioner`. One background
batcher thread owns all device work: it drains the request queue, groups
requests by decode config (beam size, sampling config), concatenates up to
``max_batch`` rows, pads them to a power-of-two bucket (repeating the last
row), decodes once and scatters the rows back. Requests wait at most
``max_wait_ms`` for co-batching.

Endpoints:
  * ``POST /caption`` — JSON ``{"features": [[...]], "beam_size": 0}`` or
    ``{"images_b64": [...]}`` (base64 JPEG/PNG files, with a server started
    with ``--vgg_weights``: decoded on the handler thread, one co-batched
    forward of the backbone (VGG16, or CLIP's tower with ``--backbone
    clip-vit-l14-336``) a batch on the batcher thread, padded to an
    extraction bucket), or
    raw little-endian float32 rows as ``application/octet-stream`` with
    the beam size in ``X-Beam-Size`` -> ``{"captions": [...]}``. Sampling
    rides the same endpoint: JSON ``"sample": {"temperature": 0.8,
    "top_k": 0, "top_p": 0.9, "num_samples": 1, "seed": 0}``, or the
    ``X-Temperature`` / ``X-Top-K`` / ``X-Top-P`` / ``X-Num-Samples`` /
    ``X-Sample-Seed`` headers on the binary path; ``num_samples > 1``
    answers one list of captions per row. Beam search and sampling in one
    request answer 400;
  * ``GET /healthz`` — the torch device serving;
  * ``GET /stats`` — request counters, latency percentiles and each
    kernel's launch count.

:mod:`.client` wraps the wire formats.

    python -m image_captioning_through_rl_tpu_torch.server \\
        --model logs/<stamp>/a2cNetwork.ckpt --data_dir datasets/coco_captioning \\
        [--pretrained_path models_pretrained] [--device cuda] [--bidirectional]

takes the JAX server's flags (the model as ``.ckpt`` or ``.pt``, its
sub-network checkpoints under ``--pretrained_path``, the bundle for the
vocabulary); ``--model a2cNetwork.pt --vocab coco2014_vocab.json`` serves a
reference-layout ``.pt`` alone. ``--vgg_weights`` (a torchvision-layout
``.pt`` or a ``.ckpt``), ``--pca`` (the ``.npz`` ``cli/extract`` fits),
``--spmd`` shards each decode batch (and each VGG16 batch) over a mesh of
the process's cards (:mod:`.parallel`), each card running its rows through
its own kernels, as the JAX server's ``--spmd`` shards over its chips.
``--vgg_bf16`` and ``--extract_batch`` turn on the raw-image endpoint, as in
the JAX server; ``--backbone`` picks the front end that ``--vgg_weights``
holds. The console script
``image-caption-server-torch`` runs it.
"""

from __future__ import annotations

import collections
import json
import math
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from .api import Captioner
from .ops.fused_beam import MAX_BEAM, fused_beam_search
from .ops.fused_decode import fused_greedy_decode, token_gate_table
from .ops.fused_sample import fused_sample_decode

_SAMPLE_HEADERS = {"temperature": "X-Temperature", "top_k": "X-Top-K", "top_p": "X-Top-P",
                   "num_samples": "X-Num-Samples", "seed": "X-Sample-Seed"}
_SAMPLE_KEYS = tuple(_SAMPLE_HEADERS)


def kernel_launches() -> dict:
    """Launch counts of the port's kernels in this process."""
    return {"fused_greedy_decode": fused_greedy_decode.launches,
            "fused_beam_search": fused_beam_search.launches,
            "fused_sample_decode": fused_sample_decode.launches,
            "token_gate_table": token_gate_table.launches}


def _parse_beam(value) -> int:
    beam = int(value)
    if not 0 <= beam <= MAX_BEAM:
        raise ValueError(f"beam_size must be in [0, {MAX_BEAM}], got {beam}")
    return beam


def _parse_sample(src: dict, max_samples: int) -> tuple:
    """A sampling config (the JSON ``"sample"`` object or the header strings)
    -> the ``(temperature, top_k, top_p, num_samples, seed)`` tuple the
    batcher groups on. ``max_samples`` bounds ``num_samples``: a batch of
    ``bucket * R`` rows must not outgrow ``max_batch`` unchecked."""
    unknown = set(src) - set(_SAMPLE_KEYS)
    if unknown:
        raise ValueError(f"unknown sample keys: {sorted(unknown)} (allowed: {list(_SAMPLE_KEYS)})")
    t = float(src.get("temperature", 1.0))
    k = int(src.get("top_k", 0))
    p = float(src.get("top_p", 1.0))
    r = int(src.get("num_samples", 1))
    seed = int(src.get("seed", 0))
    # isfinite, not only the ranges: NaN passes `t < 0`, and inf samples uniformly
    if not math.isfinite(t) or t < 0:
        raise ValueError(f"temperature must be finite and >= 0, got {t}")
    if not math.isfinite(p) or not 0.0 < p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {p}")
    if r < 1:
        raise ValueError(f"num_samples must be >= 1, got {r}")
    if r > max_samples:
        raise ValueError(f"num_samples {r} exceeds the server limit of {max_samples} "
                         "(--max_samples)")
    return (t, k, p, r, seed)


class _Pending:
    __slots__ = ("features", "pixels", "beam_size", "sample", "event", "result", "error",
                 "t_enq", "t_taken")

    def __init__(self, features: Optional[np.ndarray], beam_size: int,
                 sample: Optional[tuple] = None, pixels: Optional[np.ndarray] = None):
        self.features = features
        self.pixels = pixels  # uint8 [N, S, S, 3] awaiting extraction (S the backbone's)
        self.beam_size = beam_size
        self.sample = sample  # (temperature, top_k, top_p, num_samples, seed) or None
        self.event = threading.Event()
        self.result: Optional[List[str]] = None
        self.error: Optional[str] = None
        self.t_enq = time.perf_counter()
        self.t_taken: Optional[float] = None  # when the batcher put it in a batch

    @property
    def rows(self) -> int:
        return (self.features if self.pixels is None else self.pixels).shape[0]


class CaptionServer:
    """Dynamic-batching caption service.

    >>> srv = CaptionServer(captioner, port=0)  # port 0: pick a free one
    >>> srv.start()
    >>> ... POST http://host:srv.port/caption ...
    >>> srv.stop()
    """

    def __init__(self, captioner: Captioner, host: str = "127.0.0.1", port: int = 8000,
                 max_batch: int = 1024, max_wait_ms: float = 5.0, min_bucket: int = 8,
                 extractor=None, extract_batch: int = 64, max_body_mb: float = 256.0,
                 max_samples: int = 64):
        """``extractor``: an optional :class:`.api.FeatureExtractor` that
        turns on the raw-image endpoint (``images_b64``); its output must be
        the model's input dimension, and Pillow must import (checked here,
        not per request)."""
        if extractor is not None:
            if extractor.dim != captioner.cfg.input_dim:
                raise ValueError(
                    f"extractor produces {extractor.dim}-d features but the model expects "
                    f"{captioner.cfg.input_dim}-d input — pass the matching PCA projection (or "
                    "none for raw-fc7 models)")
            try:
                import PIL  # noqa: F401
            except ImportError as e:
                raise ValueError("the raw-image endpoint needs Pillow to decode uploads") from e
        if extract_batch < 1:
            raise ValueError("extract_batch must be >= 1")
        if max_body_mb <= 0:
            raise ValueError("max_body_mb must be positive")
        if max_samples < 1:
            raise ValueError("max_samples must be >= 1")
        self._max_samples = max_samples
        self._cap = captioner
        self._max_body = int(max_body_mb * 2**20)
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1e3
        # power-of-two buckets: a bounded set of batch shapes, each of which
        # warmup can run once before traffic
        self._buckets = []
        b = max(1, min_bucket)
        while b < max_batch:
            self._buckets.append(b)
            b *= 2
        self._buckets.append(max_batch)
        # the VGG forward pads to a bucket too, at most extract_batch, so a
        # one-image request does not pay a 64-image forward
        self._extractor = extractor
        self._extract_buckets = [x for x in self._buckets if x < extract_batch] + [extract_batch]
        self._stop = threading.Event()
        self._carry: Optional[_Pending] = None
        self._stats_lock = threading.Lock()
        self.stats = {
            "requests": 0, "captions": 0, "batches": 0, "errors": 0, "images_extracted": 0,
            "max_batch_rows": 0,
            "latency_ms": collections.deque(maxlen=10_000),
            "queue_wait_ms": collections.deque(maxlen=10_000),
            "service_ms": collections.deque(maxlen=10_000),
        }
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet access log
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, server.health())
                elif self.path == "/stats":
                    self._reply(200, server.snapshot_stats())
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/caption":
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    self._reply(400, {"error": "bad Content-Length header"})
                    return
                if n < 0:  # a negative length would read to EOF
                    self._reply(400, {"error": "bad Content-Length header"})
                    return
                if n > server._max_body:
                    self._reply(413, {"error": f"request body {n} B exceeds the "
                                               f"{server._max_body} B limit (max_body_mb)"})
                    # drain a bounded amount of the in-flight body so the
                    # close does not reset the connection before the reply
                    left = min(n, 32 * 2**20)
                    while left > 0:
                        chunk = self.rfile.read(min(65536, left))
                        if not chunk:
                            break
                        left -= len(chunk)
                    return
                raw = self.rfile.read(n)  # read before any 400 (see above)
                ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip().lower()
                want = server._cap.cfg.input_dim
                pixels = None
                try:
                    if ctype == "application/octet-stream":
                        beam = _parse_beam(self.headers.get("X-Beam-Size", 0))
                        src = {k: self.headers[h] for k, h in _SAMPLE_HEADERS.items()
                               if h in self.headers}
                        sample = _parse_sample(src, server._max_samples) if src else None
                        if sample is not None and beam:
                            raise ValueError("beam search and sampling are mutually exclusive "
                                             "(drop X-Beam-Size or the X-Temperature/... headers)")
                        if not raw or len(raw) % (4 * want):
                            raise ValueError(
                                f"binary body must be [N, {want}] little-endian float32 rows "
                                f"({len(raw)} B is not a positive multiple of {4 * want})")
                        feats = np.frombuffer(raw, "<f4").reshape(-1, want)
                    else:
                        req = json.loads(raw)
                        beam = _parse_beam(req.get("beam_size", 0))
                        sample = None
                        if "sample" in req:
                            if not isinstance(req["sample"], dict):
                                raise ValueError("'sample' must be an object, e.g. "
                                                 '{"temperature": 0.8, "top_p": 0.9}')
                            sample = _parse_sample(req["sample"], server._max_samples)
                            if beam:
                                raise ValueError("beam_size and 'sample' are mutually exclusive")
                        if "images_b64" in req:
                            feats, pixels = None, server._decode_images(req)
                        else:
                            feats = np.asarray(req["features"], np.float32)
                            if feats.ndim == 1:
                                feats = feats[None, :]
                            if feats.ndim != 2 or feats.shape[0] == 0:
                                raise ValueError("features must be [N, F] with N > 0, or [F]")
                            if feats.shape[1] != want:
                                raise ValueError(f"feature dim {feats.shape[1]} != model's "
                                                 f"{want}")
                except Exception as e:  # malformed request
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                self._dispatch_and_reply(feats, beam, sample, pixels)

            def _dispatch_and_reply(self, feats, beam, sample, pixels=None):
                if server._stop.is_set():
                    self._reply(503, {"error": "server stopping"})
                    return
                pending = _Pending(feats, beam, sample, pixels)
                server._queue.put(pending)
                server._await(pending)
                if pending.error == "server stopped":
                    self._reply(503, {"error": pending.error})
                    return
                with server._stats_lock:
                    server.stats["requests"] += 1
                    if pending.error is not None:
                        server.stats["errors"] += 1
                    else:
                        server.stats["captions"] += len(pending.result)
                        now = time.perf_counter()
                        server.stats["latency_ms"].append((now - pending.t_enq) * 1e3)
                        server.stats["queue_wait_ms"].append(
                            (pending.t_taken - pending.t_enq) * 1e3)
                        server.stats["service_ms"].append((now - pending.t_taken) * 1e3)
                if pending.error is not None:
                    self._reply(500, {"error": pending.error})
                else:
                    self._reply(200, {"captions": pending.result})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._threads: List[threading.Thread] = []

    def _decode_images(self, req: dict) -> np.ndarray:
        """A request's ``images_b64`` decoded on the handler thread (the
        host's work) at the backbone's geometry
        (:meth:`.api.FeatureExtractor.load_images`) -> uint8 ``[N, S, S,
        3]``, with the JAX server's
        400s: both ``features`` and ``images_b64``, no extractor, an empty
        list, more images than the per-request limit (``max_batch``: the
        body cap does not bound the decoded pixels)."""
        if "features" in req:
            raise ValueError("send either 'features' or 'images_b64', not both")
        if self._extractor is None:
            raise ValueError("server has no feature extractor — start it with VGG weights "
                             "(--vgg_weights) to caption raw images")
        import base64
        import io

        blobs = req["images_b64"]
        if not isinstance(blobs, list) or not blobs:
            raise ValueError("images_b64 must be a non-empty list")
        if len(blobs) > self._max_batch:
            raise ValueError(f"{len(blobs)} images exceed the per-request limit of "
                             f"{self._max_batch}")
        return self._extractor.load_images([io.BytesIO(base64.b64decode(b)) for b in blobs])

    def _extract(self, group: List[_Pending]) -> List[_Pending]:
        """One co-batched forward of the backbone for the group's image requests,
        padded to an extraction bucket; their features filled in. Returns
        the requests that can decode (an extraction error answers its image
        requests)."""
        pix = [p for p in group if p.features is None]
        if not pix:
            return group
        try:
            pixels = np.concatenate([p.pixels for p in pix], axis=0)
            eb = next((x for x in self._extract_buckets if x >= pixels.shape[0]),
                      self._extract_buckets[-1])
            feats = self._extractor(pixels, batch_size=eb)
            off = 0
            for p in pix:
                k = p.pixels.shape[0]
                p.features = np.asarray(feats[off:off + k], np.float32)
                off += k
            with self._stats_lock:
                self.stats["images_extracted"] += int(pixels.shape[0])
        except Exception as e:
            for p in pix:
                p.error = f"{type(e).__name__}: {e}"
                p.event.set()
            return [p for p in group if p.features is not None]
        return group

    # ------------------------------------------------------------------
    def health(self) -> dict:
        dev = self._cap.device
        out = {"ok": True, "platform": dev.type, "device": str(dev),
               "devices": torch.cuda.device_count() if dev.type == "cuda" else 1}
        if dev.type == "cuda":
            out["name"] = torch.cuda.get_device_name(dev)
        return out

    def snapshot_stats(self) -> dict:
        """The counters, and the 50th and 95th percentiles of the answered
        requests' latency (queued to answered), of its queue wait (queued
        to taken into a batch by the batcher) and of its service time
        (taken to answered: the rest of the co-batching window, the decode
        and the answer)."""
        with self._stats_lock:
            times = {k: sorted(self.stats[k + "_ms"])
                     for k in ("latency", "queue_wait", "service")}
            snap = {k: v for k, v in self.stats.items() if not k.endswith("_ms")}
        for name, ms in times.items():
            if ms:
                snap[f"{name}_p50_ms"] = round(ms[len(ms) // 2], 3)
                snap[f"{name}_p95_ms"] = round(ms[int(len(ms) * 0.95)], 3)
        snap["kernel_launches"] = kernel_launches()
        return snap

    def _drain(self) -> List[_Pending]:
        """Block for one request, then co-batch whatever else arrives within
        ``max_wait`` without exceeding ``max_batch`` rows (a request that
        would overflow carries to the next batch)."""
        if self._carry is not None:
            first, self._carry = self._carry, None
        else:
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                return []
        first.t_taken = time.perf_counter()
        group = [first]
        rows = first.rows
        deadline = time.perf_counter() + self._max_wait
        while rows < self._max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if rows + nxt.rows > self._max_batch:
                self._carry = nxt
                break
            nxt.t_taken = time.perf_counter()
            group.append(nxt)
            rows += nxt.rows
        return group

    def _batcher(self):
        while not self._stop.is_set():
            group = self._extract(self._drain())
            # one decode per config; sampled requests co-batch only with equal
            # (temperature, top_k, top_p, num_samples, seed), and a row's draw
            # depends on its position in the batch (its noise counter), so
            # equal seeds reproduce per dispatch, not per row
            by_cfg = {}
            for p in group:
                by_cfg.setdefault((p.beam_size, p.sample), []).append(p)
            for (beam, sample), members in by_cfg.items():
                try:
                    feats = np.concatenate([m.features for m in members], axis=0)
                    n = feats.shape[0]
                    captions: List[str] = []
                    # oversized requests split into max_batch chunks; every
                    # dispatched shape is a bucket
                    for lo in range(0, n, self._max_batch):
                        chunk = feats[lo: lo + self._max_batch]
                        c = chunk.shape[0]
                        bucket = next(b for b in self._buckets if b >= c)
                        if bucket > c:
                            chunk = np.concatenate(
                                [chunk, np.repeat(chunk[-1:], bucket - c, axis=0)], axis=0)
                        captions += self._decode(chunk, beam, sample, lo)[:c]
                except Exception as e:  # the batcher must keep serving
                    for m in members:
                        m.error = f"{type(e).__name__}: {e}"
                        m.event.set()
                    continue
                with self._stats_lock:
                    self.stats["batches"] += 1
                    self.stats["max_batch_rows"] = max(self.stats["max_batch_rows"],
                                                       min(n, self._max_batch))
                off = 0
                for m in members:
                    k = m.features.shape[0]
                    m.result = captions[off: off + k]
                    off += k
                    m.event.set()

    def _decode(self, chunk: np.ndarray, beam: int, sample: Optional[tuple], lo: int) -> list:
        """Captions of one bucket-shaped chunk; a sampled chunk at row offset
        ``lo`` of its request draws under ``seed + lo``, so the chunks of one
        oversized request do not repeat each other's noise."""
        if sample is None:
            return self._cap.caption(chunk, beam_size=beam)
        t, k, p, r, seed = sample
        return self._cap.sample_captions(chunk, temperature=t, top_k=k, top_p=p,
                                         num_samples=r, seed=seed + lo)

    # ------------------------------------------------------------------
    def warmup(self, feature_dim: int, beam_sizes=(0,), buckets=None, image_buckets=None,
               sample_configs=()):
        """Decode one random batch per bucket, for each beam size and each
        sampling config (the wire format's ``"sample"`` objects, e.g.
        ``{"top_k": 40, "num_samples": 3}``), before traffic, so the first
        real requests pay neither the kernels' build nor the allocator's
        first growth. With a feature extractor, one forward of random pixels
        at the backbone's image size per extraction bucket too (``image_buckets``, default all;
        ``[]`` skips them). Call before or after :meth:`start`."""
        rng = np.random.default_rng(0)
        buckets = list(self._buckets) if buckets is None else buckets
        samples = [_parse_sample(dict(s), self._max_samples) for s in sample_configs]
        configs = [(beam, None) for beam in beam_sizes] + [(0, s) for s in samples]
        started = bool(self._threads) and self._threads[0].is_alive()
        if self._extractor is not None:
            for eb in list(self._extract_buckets) if image_buckets is None else image_buckets:
                size = self._extractor.image_size
                px = rng.integers(0, 255, size=(eb, size, size, 3)).astype(np.uint8)
                if started:
                    p = _Pending(None, 0, pixels=px)
                    self._queue.put(p)
                    self._await(p)
                    if p.error is not None:
                        raise RuntimeError(f"warmup failed: {p.error}")
                else:
                    self._extractor(px, batch_size=eb)
        for b in buckets:
            feats = rng.standard_normal((b, feature_dim)).astype(np.float32)
            for beam, sample in configs:
                if started:  # the batcher owns all device work once live
                    p = _Pending(feats, beam, sample)
                    self._queue.put(p)
                    self._await(p)
                    if p.error is not None:
                        raise RuntimeError(f"warmup failed: {p.error}")
                else:
                    self._decode(feats, beam, sample, 0)
        return self

    def _await(self, p: _Pending) -> None:
        """Wait for the batcher to resolve ``p``; a dead batcher with the
        event unset means stop() abandoned it."""
        while not p.event.wait(0.25):
            batcher = self._threads[0] if self._threads else None
            if batcher is None or not batcher.is_alive():
                p.error = p.error or "server stopped"
                break

    def start(self):
        self._threads = [
            threading.Thread(target=self._batcher, daemon=True),
            threading.Thread(target=self._httpd.serve_forever, daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self):
        self._stop.set()
        if self._threads:  # shutdown() blocks forever unless serve_forever runs
            self._httpd.shutdown()
        self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=5)
        leftovers = [] if self._carry is None else [self._carry]
        self._carry = None
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for p in leftovers:
            p.error = "server stopped"
            p.event.set()


def main(argv=None, block: bool = True):
    """``python -m image_captioning_through_rl_tpu_torch.server`` — serve a
    trained model over HTTP. ``block=False`` returns the started
    :class:`CaptionServer` instead of parking the main thread."""
    import argparse

    from .api import BACKBONES, load_captioner, load_captioner_pt

    ap = argparse.ArgumentParser(description="Caption serving over HTTP")
    ap.add_argument("--model", required=True,
                    help="a2cNetwork checkpoint (.ckpt or reference .pt)")
    ap.add_argument("--pretrained_path", default="models_pretrained",
                    help="dir holding the policy/value sub-network checkpoints")
    ap.add_argument("--data_dir", default="",
                    help="COCO bundle (for the vocab); required unless --vocab is given")
    ap.add_argument("--vocab", default="",
                    help="coco2014_vocab.json: serve a reference-layout .pt --model alone, "
                         "without the bundle or the sub-network checkpoints")
    ap.add_argument("--bidirectional", action="store_true", default=False,
                    help="the model's encoders are bidirectional (served by the eager "
                         "decodes: no decode kernel serves a bidirectional model)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to decode on (default cuda; there is no CPU "
                         "fallback when no GPU is found)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max_batch", type=int, default=1024)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--max_body_mb", type=float, default=256.0,
                    help="largest accepted request body (413 beyond it)")
    ap.add_argument("--no_warmup", action="store_true", default=False,
                    help="skip decoding one batch per bucket before serving")
    ap.add_argument("--warmup_beams", type=int, nargs="*", default=[0],
                    help="beam sizes to warm up (0 = greedy)")
    ap.add_argument("--warmup_samples", nargs="*", default=[],
                    help="sampling configs to warm up, as JSON objects in the wire format's "
                         '"sample" shape, e.g. \'{"top_k": 40, "num_samples": 3}\'')
    ap.add_argument("--max_samples", type=int, default=64,
                    help="largest accepted num_samples per request (a sampled batch is "
                         "bucket * num_samples rows)")
    ap.add_argument("--vgg_weights", default="",
                    help="the backbone's weights (VGG16: .pt torchvision layout or .ckpt; "
                         "CLIP: a transformers state dict); turns on the raw-image endpoint "
                         "(POST /caption with images_b64)")
    ap.add_argument("--backbone", default="vgg16", choices=BACKBONES,
                    help="the raw-image endpoint's front end: VGG16 fc7, or CLIP "
                         "ViT-L/14@336px's image embedding")
    ap.add_argument("--pca", default="",
                    help="fitted PCA projection .npz mapping fc7 to the model's input dim "
                         "(cli/extract writes one)")
    ap.add_argument("--vgg_bf16", action="store_true",
                    help="run the VGG16 stack in bfloat16 (features drift at bf16 rounding "
                         "level: use a PCA basis fitted on same-type features)")
    ap.add_argument("--extract_batch", type=int, default=64,
                    help="largest VGG extraction bucket; warmup runs one forward per "
                         "power-of-two bucket up to this")
    ap.add_argument("--spmd", action="store_true", default=False,
                    help="shard each decode batch over all of this process's cards")
    args = ap.parse_args(argv)
    if args.pca and not args.vgg_weights:
        # a long-running server must not caption with random VGG weights
        ap.error("--pca requires --vgg_weights: the raw-image endpoint needs real VGG16 weights")

    mesh = None
    if args.spmd:
        from .parallel import make_mesh

        mesh = make_mesh(device=args.device)
        print(f"[Serving] SPMD: batches sharded over {mesh}", flush=True)
    if args.vocab:
        cap = load_captioner_pt(args.model, args.vocab, device=args.device,
                                bidirectional=args.bidirectional, mesh=mesh)
    elif args.data_dir:
        import os

        from .data.coco import load_data
        from .utils.io import get_filename

        data = load_data(base_dir=args.data_dir, max_train=1)
        network_paths = {
            k: os.path.join(args.pretrained_path,
                            get_filename(f"{n}Network.ckpt", args.bidirectional, None))
            for k, n in (("policy_network", "policy"), ("value_network", "value"),
                         ("reward_network", "reward"))}
        cap = load_captioner(args.model, data, network_paths, args.bidirectional,
                             device=args.device, mesh=mesh)
    else:
        ap.error("one of --data_dir (the bundle) or --vocab (with a .pt --model) is required")
    extractor = None
    if args.vgg_weights:
        from .api import load_feature_extractor

        extractor = load_feature_extractor(weights=args.vgg_weights, pca=args.pca,
                                           bf16=args.vgg_bf16, device=args.device, mesh=mesh,
                                           backbone=args.backbone)
    srv = CaptionServer(cap, host=args.host, port=args.port, max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms, extractor=extractor,
                        extract_batch=args.extract_batch, max_body_mb=args.max_body_mb,
                        max_samples=args.max_samples)
    if not args.no_warmup:
        print("[Serving] warming decode buckets", flush=True)
        srv.warmup(cap.cfg.input_dim, beam_sizes=tuple(args.warmup_beams),
                   sample_configs=[json.loads(s) for s in args.warmup_samples])
    srv.start()
    print(f"[Serving] captioning on {cap.device} at http://{srv.host}:{srv.port} "
          "(POST /caption, GET /healthz, GET /stats)", flush=True)
    if not block:
        return srv
    # orchestrators stop services with SIGTERM: drain and answer queued work
    import signal

    terminated = threading.Event()
    prev = signal.signal(signal.SIGTERM, lambda *_: terminated.set())
    try:
        while not terminated.is_set():
            terminated.wait(3600)
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, prev)
        print("[Serving] shutting down", flush=True)
        srv.stop()


if __name__ == "__main__":
    main()
