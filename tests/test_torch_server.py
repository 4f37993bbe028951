"""The port's Captioner, CaptionServer and CaptionClient on the CPU, against
the JAX Captioner on the same weights.

The JAX side runs its XLA decode (``use_fused_kernel=False``) at
``precision="highest"``; the port's Captioner on the CPU decodes through
the kernels' plain versions with float32 weights. Caption strings must be
identical, greedy and beam-5, over JSON and binary requests; sampled
requests must equal ``Captioner.sample_captions`` at the same seed (which
``test_torch_sample.py`` holds to the JAX Captioner), an oversized one
chunk by chunk under ``seed + row offset``.
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
from image_captioning_through_rl_tpu_torch.api import Captioner, load_captioner_pt
from image_captioning_through_rl_tpu_torch.client import CaptionClient
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
                     IDX_TO_WORD, device="cpu")
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
    {"features": [[0.0] * KW["input_dim"]], "sample": {"temperature": 0.8}, "beam_size": 5},
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
    if "images_b64" in payload:  # a server started without --vgg_weights
        assert "no feature extractor" in body["error"]
    if "sample" in payload:
        assert "mutually exclusive" in body["error"]


def test_server_binary_sampling_and_bad_length_are_400(server):
    srv, _ = server
    for body, headers in (
        (_feats(1, 0).tobytes(), {"Content-Type": "application/octet-stream",
                                  "X-Temperature": "0.8", "X-Beam-Size": "5"}),
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
                                        "fused_sample_decode": 0, "token_gate_table": 0}


def test_stats_split_latency_into_queue_wait_and_service(models, monkeypatch):
    """``/stats`` splits each answered request's latency into its queue
    wait (queued to taken into a batch) and its service time (taken to
    answered): a request held in the queue while the batcher is kept from
    draining shows the hold as queue wait, not as service."""
    import threading
    import time

    _, _, tcap = models
    go = threading.Event()
    srv = server_mod.CaptionServer(tcap, port=0, max_wait_ms=1, max_batch=8)
    real_drain = srv._drain

    def held_drain():
        go.wait(timeout=30)
        return real_drain()

    monkeypatch.setattr(srv, "_drain", held_drain)
    hold_s = 0.3
    srv.start()
    try:
        answer = []
        client = threading.Thread(target=lambda: answer.append(
            _post_json(srv, {"features": _feats(3, 4).tolist()})))
        client.start()
        time.sleep(hold_s)
        go.set()
        client.join(timeout=60)
        assert not client.is_alive() and len(answer[0]) == 3
        stats = srv.snapshot_stats()
    finally:
        srv.stop()
    assert stats["requests"] == 1 and stats["errors"] == 0
    wait, service, latency = (stats[f"{k}_p50_ms"] for k in ("queue_wait", "service", "latency"))
    assert stats["queue_wait_p95_ms"] == wait and stats["service_p95_ms"] == service
    assert wait >= 0.8 * hold_s * 1e3 and service < wait
    assert wait + service == pytest.approx(latency, abs=0.01)


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
    cap = load_captioner_pt(str(model_pt), str(vocab), device="cpu")
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


SAMPLE = {"temperature": 0.9, "top_k": 5, "top_p": 0.8, "seed": 7}


@pytest.mark.parametrize("num_samples", [1, 3])
def test_server_sampling_matches_sample_captions(models, server, num_samples):
    """Sampled JSON and header requests through the port's client equal
    ``Captioner.sample_captions`` at the same seed, filtered or not."""
    _, _, tcap = models
    srv, _ = server
    client = CaptionClient(f"http://{srv.host}:{srv.port}", timeout=60)
    feats = _feats(6, seed=40 + num_samples)
    for sample in (dict(SAMPLE, num_samples=num_samples), {"num_samples": num_samples}):
        want = tcap.sample_captions(feats, **sample)
        assert len(want) == 6
        if num_samples > 1:
            assert all(len(row) == num_samples for row in want)
        assert client.caption(feats, sample=sample) == want           # headers
        assert client.caption(feats, sample=sample, binary=False) == want  # JSON
    # temperature 0 is greedy
    assert client.caption(feats, sample={"temperature": 0}) == tcap.caption(feats)


def test_oversized_sampled_request_draws_seed_plus_row_offset(models):
    """A sampled request of 16 rows at max_batch 8 runs as two chunks, the
    second under seed + 8, so equal rows in the two chunks draw apart."""
    _, _, tcap = models
    srv = server_mod.CaptionServer(tcap, port=0, max_wait_ms=1, max_batch=8)
    srv.start()
    try:
        feats = np.concatenate([_feats(8, seed=50)] * 2)
        got = CaptionClient(f"http://{srv.host}:{srv.port}", timeout=60).caption(
            feats, sample=SAMPLE)
    finally:
        srv.stop()
    kw = {k: v for k, v in SAMPLE.items() if k != "seed"}
    first = tcap.sample_captions(feats[:8], seed=SAMPLE["seed"], **kw)
    second = tcap.sample_captions(feats[8:], seed=SAMPLE["seed"] + 8, **kw)
    assert got == first + second
    assert second != first


@pytest.mark.parametrize("sample", [{"num_samples": 65}, {"temperature": float("nan")},
                                    {"top_p": 0.0}, {"temprature": 1.0}])
def test_bad_sample_configs_are_400(server, sample):
    srv, _ = server
    client = CaptionClient(f"http://{srv.host}:{srv.port}", timeout=60)
    for binary in (True, False):
        with pytest.raises((urllib.error.HTTPError, ValueError)) as ei:
            client.caption(_feats(1, 0), sample=sample, binary=binary)
        if isinstance(ei.value, urllib.error.HTTPError):
            assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        client.caption(_feats(1, 0), beam_size=5, sample={"temperature": 1.0})
    assert ei.value.code == 400


def test_warmup_runs_sample_configs(models):
    _, _, tcap = models
    srv = server_mod.CaptionServer(tcap, port=0, max_wait_ms=1, max_batch=16, max_samples=4)
    cfg = [{"top_k": 5, "num_samples": 2}, {"temperature": 0.5, "top_p": 0.9}]
    srv.warmup(KW["input_dim"], beam_sizes=(), sample_configs=cfg)  # before start
    srv.start()
    try:
        srv.warmup(KW["input_dim"], beam_sizes=(0,), buckets=[8], sample_configs=cfg)
        with pytest.raises(ValueError, match="num_samples"):
            srv.warmup(KW["input_dim"], buckets=[8], sample_configs=[{"num_samples": 5}])
    finally:
        srv.stop()


def test_client_round_trip_and_main_sampling_flags(models, tmp_path):
    """``server.main`` with ``--warmup_samples`` and ``--max_samples``, then
    the port's client: health, a greedy, a beam and a sampled request, and
    the sampling kernel's launch count in /stats (0 on the CPU)."""
    jp, _, _ = models
    model_pt = tmp_path / "a2cNetwork.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in a2c_to_torch(jp).items()},
               model_pt)
    vocab = tmp_path / "coco2014_vocab.json"
    vocab.write_text(json.dumps({"word_to_idx": {w: i for i, w in enumerate(WORDS)},
                                 "idx_to_word": WORDS}))
    srv = server_mod.main(["--model", str(model_pt), "--vocab", str(vocab), "--device", "cpu",
                           "--port", "0", "--max_batch", "8", "--max_samples", "2",
                           "--warmup_samples", '{"top_k": 5, "num_samples": 2}'], block=False)
    try:
        client = CaptionClient(f"http://{srv.host}:{srv.port}", timeout=60)
        assert client.healthz()["platform"] == "cpu"
        feats = _feats(3, seed=60)
        cap = srv._cap
        assert client.caption(feats) == cap.caption(feats)
        assert client.caption(feats, beam_size=5, binary=False) == cap.caption(feats, beam_size=5)
        sample = {"top_p": 0.9, "num_samples": 2, "seed": 3}
        assert client.caption(feats, sample=sample) == cap.sample_captions(feats, **sample)
        with pytest.raises(urllib.error.HTTPError) as ei:
            client.caption(feats, sample={"num_samples": 3})
        assert ei.value.code == 400
        stats = client.stats()
        assert stats["errors"] == 0 and stats["kernel_launches"]["fused_sample_decode"] == 0
    finally:
        srv.stop()


def test_main_serves_a_bidirectional_model(tmp_path):
    """``server.main --bidirectional`` on a bidirectional ``.pt``: greedy,
    beam-5 and sampled requests answer the JAX Captioner's captions (its XLA
    decodes, the only route the JAX package has for such a model)."""
    kw = {k: v for k, v in KW.items() if k != "max_seq_len"}
    jcfg = JNetConfig(precision="highest", bidirectional=True, **kw)
    jp = ja2c.init(jax.random.PRNGKey(4), jcfg)
    model_pt = tmp_path / "a2cNetwork_bidirectional.pt"
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in a2c_to_torch(jp, bidirectional=True).items()}, model_pt)
    vocab = tmp_path / "coco2014_vocab.json"
    vocab.write_text(json.dumps({"word_to_idx": {w: i for i, w in enumerate(WORDS)},
                                 "idx_to_word": WORDS}))
    with pytest.raises(ValueError, match="bidirectional=True"):
        load_captioner_pt(str(model_pt), str(vocab), device="cpu")
    srv = server_mod.main(["--model", str(model_pt), "--vocab", str(vocab), "--bidirectional",
                           "--device", "cpu", "--port", "0", "--max_batch", "8",
                           "--warmup_beams", "0", "5"], block=False)
    try:
        assert srv._cap.cfg.bidirectional and srv._cap.cfg.hidden_dim == KW["hidden_dim"]
        jcap = JCaptioner(jp, jcfg, IDX_TO_WORD)
        client = CaptionClient(f"http://{srv.host}:{srv.port}", timeout=60)
        feats = _feats(5, seed=70)
        assert client.caption(feats) == jcap.caption(feats, use_fused_kernel=False)
        want = jcap.caption(feats, beam_size=5, use_fused_kernel=False)
        assert client.caption(feats, beam_size=5) == want
        assert _post_json(srv, {"features": feats.tolist(), "beam_size": 5}) == want
        sample = {"temperature": 0.8, "top_k": 6, "num_samples": 2, "seed": 5}
        assert client.caption(feats, sample=sample) == jcap.sample_captions(feats, **sample)
        stats = client.stats()
        assert stats["errors"] == 0 and not any(stats["kernel_launches"].values())
    finally:
        srv.stop()


# ---- the raw-image endpoint (images_b64) ----
#
# Both packages' servers, started with the JAX server's command line and the
# same VGG16 ``.pt`` and PCA ``.npz``, answer the same PNGs with the same
# captions: the fc7 features agree to ~1e-6 relative (test_torch_vision.py),
# and the decodes are the XLA / plain ones above. The networks take the
# servers' default width (512), the features the PCA's 8 dimensions.

IMG_V, IMG_F, IMG_BATCH, IMG_EXTRACT = 40, 8, 8, 4


@pytest.fixture(scope="module")
def image_servers(tmp_path_factory):
    from image_captioning_through_rl_tpu import server as jserver
    from image_captioning_through_rl_tpu_torch.data import make_synthetic_coco
    from image_captioning_through_rl_tpu_torch.data.pca import PCAProjection
    from image_captioning_through_rl_tpu_torch.models import a2c as ta2c
    from image_captioning_through_rl_tpu_torch.models import policy as tpolicy
    from image_captioning_through_rl_tpu_torch.models import reward as treward
    from image_captioning_through_rl_tpu_torch.models import value as tvalue
    from image_captioning_through_rl_tpu_torch.models import vgg as tvgg
    from image_captioning_through_rl_tpu_torch.train import checkpoint as tckpt
    from PIL import Image

    d = tmp_path_factory.mktemp("image_server")
    coco = make_synthetic_coco(str(d / "coco"), num_train_images=6, num_val_images=3,
                               captions_per_image=2, vocab_size=IMG_V, feature_dim=IMG_F,
                               seed=12)
    cfg = NetConfig(vocab_size=IMG_V, input_dim=IMG_F)
    pre = d / "pre"
    pre.mkdir()
    for seed, (kind, mod) in enumerate((("reward", treward), ("policy", tpolicy),
                                        ("value", tvalue))):
        tckpt.save_network(kind, mod.init(torch.Generator().manual_seed(seed), cfg),
                           str(pre / f"{kind}Network.ckpt"))
    tckpt.save_network("a2c", ta2c.init(torch.Generator().manual_seed(3), cfg),
                       str(d / "a2cNetwork.ckpt"))
    torch.save(tvgg.init(torch.Generator().manual_seed(4)).state_dict(), d / "vgg16.pt")
    rng = np.random.default_rng(6)
    PCAProjection(torch.zeros(4096), torch.from_numpy(
        rng.standard_normal((4096, IMG_F)).astype(np.float32) * 0.01)).save(str(d / "pca.npz"))
    pngs = []
    for i, (h, w) in enumerate(((40, 60), (64, 48), (300, 200))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(d / f"{i}.png")
        pngs.append(str(d / f"{i}.png"))
    argv = ["--model", str(d / "a2cNetwork.ckpt"), "--data_dir", coco, "--pretrained_path",
            str(pre), "--port", "0", "--max_batch", str(IMG_BATCH), "--vgg_weights",
            str(d / "vgg16.pt"), "--pca", str(d / "pca.npz"), "--extract_batch",
            str(IMG_EXTRACT), "--no_warmup"]
    ours = server_mod.main(argv + ["--device", "cpu"], block=False)
    theirs = jserver.main(argv, block=False)
    yield ours, theirs, pngs
    ours.stop()
    theirs.stop()


def _b64(paths):
    import base64

    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(base64.b64encode(f.read()).decode("ascii"))
    return out


def _post_error(srv, payload):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post_json(srv, payload)
    return ei.value.code, json.loads(ei.value.read())["error"]


def test_image_servers_answer_alike(image_servers):
    """Greedy, beam-5 and sampled ``images_b64`` requests: the port's server
    answers the JAX server's captions, which are ``Captioner.caption_images``
    on the same files."""
    ours, theirs, pngs = image_servers
    assert ours._extractor.dim == IMG_F and ours._extract_buckets == [IMG_EXTRACT]
    for extra in ({"beam_size": 0}, {"beam_size": 5},
                  {"sample": {"temperature": 0.8, "num_samples": 2, "seed": 7}}):
        payload = {"images_b64": _b64(pngs), **extra}
        got = _post_json(ours, payload)
        assert got == _post_json(theirs, payload), extra
        assert len(got) == len(pngs)
    assert _post_json(ours, {"images_b64": _b64(pngs)}) == ours._cap.caption_images(
        pngs, ours._extractor, batch_size=IMG_EXTRACT)


def test_image_requests_400_as_the_jax_server(image_servers):
    """Both ``features`` and ``images_b64``, an empty list, more images than
    the per-request limit: the JAX server's 400s, word for word."""
    ours, theirs, pngs = image_servers
    for payload in ({"features": [[0.0] * IMG_F], "images_b64": _b64(pngs[:1])},
                    {"images_b64": []},
                    {"images_b64": _b64(pngs[:1]) * (IMG_BATCH + 1)}):
        code, msg = _post_error(ours, payload)
        assert (code, msg) == _post_error(theirs, payload)
        assert code == 400
    # a server started without --vgg_weights (the features-only fixture above)
    # answers images with the JAX server's 400 too


def test_features_and_images_cobatch(image_servers):
    """An image request and a feature request in flight together: each gets
    its own captions, and the image rows count as extracted."""
    import threading

    ours, _, pngs = image_servers
    feats = np.random.default_rng(8).standard_normal((3, IMG_F)).astype(np.float32)
    before = ours.snapshot_stats()["images_extracted"]
    out = {}
    threads = [threading.Thread(target=lambda: out.__setitem__(
                   "img", _post_json(ours, {"images_b64": _b64(pngs)}))),
               threading.Thread(target=lambda: out.__setitem__(
                   "feat", _post_json(ours, {"features": feats.tolist()})))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out["feat"] == ours._cap.caption(feats)
    assert out["img"] == ours._cap.caption_images(pngs, ours._extractor,
                                                  batch_size=IMG_EXTRACT)
    stats = ours.snapshot_stats()
    assert stats["images_extracted"] - before == len(pngs) and stats["errors"] == 0


def test_image_bucket_warmup_and_client(image_servers):
    """``warmup`` runs one VGG16 forward per extraction bucket (through the
    batcher once the server is live); the port's ``CaptionClient`` posts
    paths, file objects and bytes alike."""
    ours, _, pngs = image_servers
    before = ours.snapshot_stats()["images_extracted"]
    ours.warmup(IMG_F, beam_sizes=(), buckets=[])
    assert ours.snapshot_stats()["images_extracted"] - before == IMG_EXTRACT
    client = CaptionClient(f"http://{ours.host}:{ours.port}", timeout=120)
    want = client.caption_images(pngs)
    with open(pngs[0], "rb") as f:
        raw = f.read()
    with open(pngs[1], "rb") as f:
        assert client.caption_images([raw, f, pngs[2]]) == want
    assert client.caption_images(pngs, beam_size=5) == _post_json(
        ours, {"images_b64": _b64(pngs), "beam_size": 5})
