"""The port's Captioner and CaptionServer on the CPU, against the JAX
Captioner on the same weights.

The JAX side runs its XLA decode (``use_fused_kernel=False``) at
``precision="highest"``; the port's Captioner on the CPU decodes through
the kernels' plain versions with float32 weights. Caption strings must be
identical, greedy and beam-5, over JSON and binary requests.
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu.api import Captioner as JCaptioner
from image_captioning_through_rl_tpu.config import NetConfig as JNetConfig
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu.models.convert import a2c_to_torch
from image_captioning_through_rl_tpu_torch import server as server_mod
from image_captioning_through_rl_tpu_torch.api import Captioner, load_captioner
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.models import from_jax_params

torch.set_num_threads(1)

KW = dict(vocab_size=60, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=7)
WORDS = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(4, KW["vocab_size"])]
IDX_TO_WORD = dict(enumerate(WORDS))


@pytest.fixture(scope="module")
def models():
    jp = ja2c.init(jax.random.PRNGKey(0), JNetConfig(precision="highest", **KW))
    jcap = JCaptioner(jp, JNetConfig(precision="highest", **KW), IDX_TO_WORD)
    tcap = Captioner(from_jax_params(jax.tree.map(np.asarray, jp)), NetConfig(**KW),
                     IDX_TO_WORD)
    return jp, jcap, tcap


@pytest.fixture(scope="module")
def server(models):
    _, jcap, tcap = models
    srv = server_mod.CaptionServer(tcap, port=0, max_wait_ms=5, max_batch=64)
    srv.start()
    yield srv, jcap
    srv.stop()


def _feats(n, seed):
    return np.random.default_rng(seed).standard_normal((n, KW["input_dim"])).astype(np.float32)


def _post(srv, body: bytes, headers: dict):
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}/caption", data=body,
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())["captions"]


def _post_json(srv, payload):
    return _post(srv, json.dumps(payload).encode(), {"Content-Type": "application/json"})


def _post_bin(srv, feats, beam=None):
    headers = {"Content-Type": "application/octet-stream"}
    if beam is not None:
        headers["X-Beam-Size"] = str(beam)
    return _post(srv, np.ascontiguousarray(feats, "<f4").tobytes(), headers)


@pytest.mark.parametrize("beam", [0, 5])
def test_captioner_matches_jax_captioner(models, beam):
    _, jcap, tcap = models
    feats = _feats(11, seed=beam)
    want = jcap.caption(feats, beam_size=beam, use_fused_kernel=False)
    assert tcap.caption(feats, beam_size=beam) == want
    assert tcap.caption(torch.from_numpy(feats), beam_size=beam) == want


@pytest.mark.parametrize("beam", [0, 5])
def test_server_json_and_binary_match_jax(server, beam):
    srv, jcap = server
    feats = _feats(6, seed=10 + beam)
    want = jcap.caption(feats, beam_size=beam, use_fused_kernel=False)
    assert _post_json(srv, {"features": feats.tolist(), "beam_size": beam}) == want
    assert _post_bin(srv, feats, beam=beam) == want
    # a single vector is one caption
    assert _post_json(srv, {"features": feats[0].tolist(), "beam_size": beam}) == want[:1]


@pytest.mark.parametrize("payload", [
    {"features": [[0.0] * KW["input_dim"]], "sample": {"temperature": 0.8}},
    {"images_b64": ["aGVsbG8="]},
    {"features": [[0.0] * KW["input_dim"]], "beam_size": 9},
    {"features": "nope"},
    {"features": [[0.0] * 3]},
])
def test_server_rejects_unported_and_malformed_requests(server, payload):
    srv, _ = server
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post_json(srv, payload)
    assert ei.value.code == 400
    body = json.loads(ei.value.read())
    if "sample" in payload or "images_b64" in payload:
        assert "not yet ported" in body["error"]


def test_server_binary_sampling_and_bad_length_are_400(server):
    srv, _ = server
    for body, headers in (
        (_feats(1, 0).tobytes(), {"Content-Type": "application/octet-stream",
                                  "X-Temperature": "0.8"}),
        (b"\x00" * (4 * KW["input_dim"] + 3), {"Content-Type": "application/octet-stream"}),
    ):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, body, headers)
        assert ei.value.code == 400


def test_healthz_and_stats(server):
    srv, _ = server
    _post_json(srv, {"features": _feats(2, 3).tolist()})
    base = f"http://{srv.host}:{srv.port}"
    with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
        health = json.loads(r.read())
    assert health == {"ok": True, "platform": "cpu", "device": "cpu", "devices": 1}
    with urllib.request.urlopen(base + "/stats", timeout=10) as r:
        stats = json.loads(r.read())
    assert stats["requests"] >= 1 and stats["errors"] == 0 and "latency_p50_ms" in stats
    # on the CPU the plain versions serve: no kernel launches
    assert stats["kernel_launches"] == {"fused_greedy_decode": 0, "fused_beam_search": 0,
                                        "token_gate_table": 0}


def test_main_serves_from_pt_and_vocab(models, tmp_path):
    """``server.main --model a2c.pt --vocab vocab.json --device cpu``: load
    the reference-layout checkpoint, warm up, serve."""
    jp, _, _ = models
    model_pt = tmp_path / "a2cNetwork.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in a2c_to_torch(jp).items()},
               model_pt)
    vocab = tmp_path / "coco2014_vocab.json"
    vocab.write_text(json.dumps({"word_to_idx": {w: i for i, w in enumerate(WORDS)},
                                 "idx_to_word": WORDS}))
    cap = load_captioner(str(model_pt), str(vocab))
    assert cap.cfg.vocab_size == KW["vocab_size"] and cap.cfg.hidden_dim == KW["hidden_dim"]
    # the checkpoint carries no caption length: the loaded model decodes
    # the default 17 tokens
    kw = {k: v for k, v in KW.items() if k != "max_seq_len"}
    jcap17 = JCaptioner(jp, JNetConfig(precision="highest", **kw), IDX_TO_WORD)
    srv = server_mod.main(["--model", str(model_pt), "--vocab", str(vocab), "--device", "cpu",
                           "--port", "0", "--max_batch", "16", "--warmup_beams", "0", "5"],
                          block=False)
    try:
        feats = _feats(3, seed=42)
        assert _post_bin(srv, feats, beam=5) == jcap17.caption(feats, beam_size=5,
                                                               use_fused_kernel=False)
    finally:
        srv.stop()


def test_cuda_device_without_gpu_raises(models):
    """No quiet CPU fallback when CUDA is asked for and absent."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jp, _, _ = models
    with pytest.raises(RuntimeError, match="cuda"):
        Captioner(from_jax_params(jax.tree.map(np.asarray, jp)), NetConfig(**KW),
                  IDX_TO_WORD, device="cuda")
