"""Minimal stdlib client for the caption server (:mod:`.server`), a copy
of the JAX package's ``client.py`` with its wire formats:

  * dense features ride the binary path by default (raw little-endian
    float32 rows, ``Content-Type: application/octet-stream``), which skips
    the JSON float encoding;
  * ``sample`` switches a request to stochastic decode (the JSON
    ``"sample"`` object, or the ``X-Temperature`` / ``X-Top-K`` / ``X-Top-P``
    / ``X-Num-Samples`` / ``X-Sample-Seed`` headers on the binary path);
  * raw images ride JSON ``images_b64``; the port's server answers them
    with 400 until the image path is ported.

>>> client = CaptionClient("http://localhost:8000")
>>> client.caption(features)                  # [N, F] float array
>>> client.caption(features, sample={"temperature": 0.8, "top_p": 0.9, "seed": 7})
>>> client.healthz(); client.stats()
"""

from __future__ import annotations

import base64
import json
import urllib.request
from typing import List, Sequence

import numpy as np


class CaptionClient:
    def __init__(self, base_url: str, timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # ------------------------------------------------------------------
    def _get(self, path: str) -> dict:
        with urllib.request.urlopen(self.base_url + path,
                                    timeout=self.timeout) as r:
            return json.loads(r.read())

    def _post(self, data: bytes, headers: dict) -> dict:
        req = urllib.request.Request(
            self.base_url + "/caption", data=data, headers=headers)
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    # ------------------------------------------------------------------
    _SAMPLE_HEADERS = {"temperature": "X-Temperature", "top_k": "X-Top-K",
                       "top_p": "X-Top-P", "num_samples": "X-Num-Samples",
                       "seed": "X-Sample-Seed"}

    def caption(self, features, beam_size: int = 0,
                binary: bool = True, sample: dict | None = None) -> List:
        """Caption pre-extracted feature rows ``[N, F]`` (or one ``[F]``
        row). ``binary=False`` falls back to the JSON payload (e.g. for
        proxies that reject octet-stream bodies). ``sample`` switches to
        stochastic decode — a dict with any of ``temperature`` /
        ``top_k`` / ``top_p`` / ``num_samples`` / ``seed``; with
        ``num_samples > 1`` each row answers with a list of captions."""
        feats = np.asarray(features, np.float32)
        if feats.ndim == 1:
            feats = feats[None, :]
        if feats.ndim != 2:
            # the binary wire format is flat rows — a 3-D array would be
            # silently reinterpreted as N*K rows server-side, while the
            # JSON path would 400; enforce ONE contract client-side
            raise ValueError(f"features must be [N, F] or [F], got "
                             f"shape {feats.shape}")
        if binary:
            headers = {"Content-Type": "application/octet-stream"}
            if beam_size:
                headers["X-Beam-Size"] = str(beam_size)
            if sample is not None:
                unknown = set(sample) - set(self._SAMPLE_HEADERS)
                if unknown:
                    raise ValueError(f"unknown sample keys: {sorted(unknown)}")
                for k, v in sample.items():
                    headers[self._SAMPLE_HEADERS[k]] = str(v)
            body = np.ascontiguousarray(feats, dtype="<f4").tobytes()
        else:
            headers = {"Content-Type": "application/json"}
            payload = {"features": feats.tolist(), "beam_size": beam_size}
            if sample is not None:
                payload["sample"] = sample
            body = json.dumps(payload).encode()
        return self._post(body, headers)["captions"]

    def caption_images(self, images: Sequence, beam_size: int = 0,
                       sample: dict | None = None) -> List:
        """Caption raw image files: paths, open file objects, or bytes
        (``images_b64``; the port's server answers 400 until its image path
        is ported). ``sample`` as in :meth:`caption`."""
        blobs = []
        for im in images:
            if isinstance(im, (bytes, bytearray)):
                raw = bytes(im)
            elif hasattr(im, "read"):
                raw = im.read()
            else:
                with open(im, "rb") as f:
                    raw = f.read()
            blobs.append(base64.b64encode(raw).decode("ascii"))
        payload = {"images_b64": blobs, "beam_size": beam_size}
        if sample is not None:
            payload["sample"] = sample
        body = json.dumps(payload).encode()
        return self._post(body, {"Content-Type": "application/json"})["captions"]

    def healthz(self) -> dict:
        return self._get("/healthz")

    def stats(self) -> dict:
        return self._get("/stats")
