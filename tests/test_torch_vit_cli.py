"""The CLIP front end behind the port's command lines and server, on the CPU:
``cli/extract --backbone clip-vit-l14-336`` writes CLIP-named tables and
projection equal to the extractor's own features; ``cli/caption
--backbone`` and the image server started with ``--backbone`` answer PNGs
as ``Captioner.caption_images`` does through the same extractor, the
server's warm-up at the tower's image size. A tiny tower (width 64, 2
layers, 56 px) in the ``transformers`` layout stands in for the published
weights; its heads are width / 64, as the loader takes them."""

import base64
import json
import urllib.request

import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu_torch import server as server_mod
from image_captioning_through_rl_tpu_torch.api import Captioner, load_feature_extractor
from image_captioning_through_rl_tpu_torch.cli import caption as ccli
from image_captioning_through_rl_tpu_torch.cli import extract as ecli
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.data import make_synthetic_coco
from image_captioning_through_rl_tpu_torch.data.coco import load_vocab
from image_captioning_through_rl_tpu_torch.data.hdf5 import read_h5
from image_captioning_through_rl_tpu_torch.data.pca import PCAProjection
from image_captioning_through_rl_tpu_torch.models import a2c, convert, policy, reward, value, vit
from image_captioning_through_rl_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)

V, F = 40, 8
CLIP = "clip-vit-l14-336"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny CLIP tower's ``.pt``, a PCA of its 32-d embedding to 8, PNGs of
    three sizes, a synthetic bundle and the networks' checkpoints."""
    from PIL import Image

    d = tmp_path_factory.mktemp("clip")
    tower = vit.init(torch.Generator().manual_seed(5), image_size=56, patch=14, width=64,
                     layers=2, mlp=256, output_dim=32)
    torch.save(convert.clip_vision_to_state_dict(tower), d / "clip.pt")
    rng = np.random.default_rng(6)
    comps, _ = np.linalg.qr(rng.standard_normal((32, F)))
    PCAProjection(torch.zeros(32), torch.from_numpy(comps.astype(np.float32))).save(
        str(d / "pca.npz"))
    imgs = d / "images"
    imgs.mkdir()
    for i, (h, w) in enumerate(((40, 60), (64, 48), (300, 200))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(imgs / f"{i}.png")
    coco = make_synthetic_coco(str(d / "coco"), num_train_images=6, num_val_images=3,
                               captions_per_image=2, vocab_size=V, feature_dim=F, seed=12)
    cfg = NetConfig(vocab_size=V, input_dim=F)
    pre = d / "pre"
    pre.mkdir()
    for seed, (kind, mod) in enumerate((("reward", reward), ("policy", policy),
                                        ("value", value))):
        ckpt.save_network(kind, mod.init(torch.Generator().manual_seed(seed), cfg),
                          str(pre / f"{kind}Network.ckpt"))
    ckpt.save_network("a2c", a2c.init(torch.Generator().manual_seed(3), cfg),
                      str(d / "a2cNetwork.ckpt"))
    paths = sorted(str(p) for p in imgs.iterdir())
    return d, coco, paths


def _extractor(d, pca=True):
    return load_feature_extractor(str(d / "clip.pt"), str(d / "pca.npz") if pca else "",
                                  device="cpu", backbone=CLIP)


def _captioner(d, coco):
    word_to_idx, idx_to_word = load_vocab(f"{coco}/coco2014_vocab.json")
    cfg = NetConfig.for_vocab(word_to_idx, input_dim=F)
    params = {k: ckpt.load_network(k, str(d / "pre" / f"{k}Network.ckpt"), "cpu", cfg)
              for k in ("policy", "value")}
    params.update(ckpt.load_network("a2c", str(d / "a2cNetwork.ckpt"), "cpu", cfg))
    return Captioner(params, cfg, idx_to_word, device="cpu")


def test_extract_cli_writes_clip_tables(files, tmp_path):
    d, _, paths = files
    out = tmp_path / "out"
    ecli.main(["--images_dir", str(d / "images"), "--out_dir", str(out), "--backbone", CLIP,
               "--weights", str(d / "clip.pt"), "--batch_size", "2", "--pca_components", "2",
               "--device", "cpu"])
    raw = read_h5(str(out / "val2014_clip_vit_l14_336.h5"))["features"]
    want = _extractor(d, pca=False)(paths, batch_size=2)
    np.testing.assert_array_equal(raw, want)
    assert raw.shape == (3, 32)
    proj = PCAProjection.load(str(out / "clip_vit_l14_336_pca.npz"))
    pca = read_h5(str(out / "val2014_clip_vit_l14_336_pca.h5"))["features"]
    np.testing.assert_allclose(pca, proj.apply(want), rtol=1e-5, atol=1e-6)
    assert not (out / "val2014_vgg16_fc7.h5").exists()


def test_caption_cli_with_the_clip_backbone(files, tmp_path):
    d, coco, paths = files
    out = tmp_path / "captions.txt"
    ccli.main([*paths, "--model", str(d / "a2cNetwork.ckpt"), "--vocab", coco,
               "--policy_model", str(d / "pre" / "policyNetwork.ckpt"),
               "--value_model", str(d / "pre" / "valueNetwork.ckpt"), "--backbone", CLIP,
               "--vgg_weights", str(d / "clip.pt"), "--pca", str(d / "pca.npz"),
               "--beam_size", "3", "--batch_size", "2", "--device", "cpu", "--out", str(out)])
    want = _captioner(d, coco).caption_images(paths, _extractor(d), batch_size=2, beam_size=3)
    assert out.read_text().splitlines() == [f"{p}\t{c}" for p, c in zip(paths, want)]


def _post(srv, payload):
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}/caption",
                                 json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())["captions"]


def test_image_server_with_the_clip_backbone(files):
    """``--backbone clip-vit-l14-336``: the warm-up runs one forward at 56 px
    in its extraction bucket; greedy and beam-3 ``images_b64`` requests answer
    as ``caption_images``."""
    d, coco, paths = files
    srv = server_mod.main(["--model", str(d / "a2cNetwork.ckpt"), "--data_dir", coco,
                           "--pretrained_path", str(d / "pre"), "--port", "0", "--max_batch", "8",
                           "--backbone", CLIP, "--vgg_weights", str(d / "clip.pt"), "--pca",
                           str(d / "pca.npz"), "--extract_batch", "4", "--no_warmup",
                           "--device", "cpu"], block=False)
    try:
        assert srv._extractor.image_size == 56 and srv._extractor.backbone == CLIP
        before = srv.snapshot_stats()["images_extracted"]
        srv.warmup(F, beam_sizes=(), buckets=[])
        assert srv.snapshot_stats()["images_extracted"] - before == 4  # one bucket, of 4
        blobs = [base64.b64encode(open(p, "rb").read()).decode("ascii") for p in paths]
        cap, ext = _captioner(d, coco), _extractor(d)
        for beam in (0, 3):
            assert _post(srv, {"images_b64": blobs, "beam_size": beam}) == cap.caption_images(
                paths, ext, batch_size=4, beam_size=beam)
    finally:
        srv.stop()
