"""The port's repairs of faults F1-F3 against the JAX package, on the CPU.

  * F1: ``api.load_captioner`` takes the JAX package's arguments and reads
    ``.ckpt`` files; ``server.main`` takes the JAX server's flags. A port
    CLI run writes ``a2cNetwork.ckpt``; the port's server, started with the
    JAX server's command line on it, answers greedy and beam-5 requests
    with the JAX server's captions (the JAX server on the same files), and
    ``load_captioner(mesh=...)`` raises naming ROADMAP §1 item 8;
  * F2: a trainer's ``<log_dir>/runs`` TensorBoard events hold the JSONL
    log's tags, steps and values; with ``torch.utils.tensorboard`` failing
    to import, the JSONL log is written alone: no ``runs/``, no raise;
  * F3: ``CocoData.vocab_size`` equals the JAX package's.
"""

import importlib
import json
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import server as jserver
from image_captioning_through_rl_tpu.data import load_data as jload_data
from image_captioning_through_rl_tpu.data.synthetic import make_synthetic_coco
from image_captioning_through_rl_tpu_torch import api as tapi
from image_captioning_through_rl_tpu_torch import server as tserver
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.data import load_data
from image_captioning_through_rl_tpu_torch.data.coco import CocoData, caption_lengths
from image_captioning_through_rl_tpu_torch.models import policy as tpolicy
from image_captioning_through_rl_tpu_torch.models import reward as treward
from image_captioning_through_rl_tpu_torch.models import value as tvalue
from image_captioning_through_rl_tpu_torch.parallel import make_mesh
from image_captioning_through_rl_tpu_torch.train import checkpoint as tckpt
from image_captioning_through_rl_tpu_torch.train import loops as tloops
from image_captioning_through_rl_tpu_torch.utils.logging import make_metrics_writer

torch.set_num_threads(1)

V, F = 40, 32
WIDTH = 512  # the servers take no width flags: the networks' default widths


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return make_synthetic_coco(str(tmp_path_factory.mktemp("coco")), num_train_images=12,
                               num_val_images=6, captions_per_image=2, vocab_size=V,
                               feature_dim=F, seed=11)


def test_vocab_size_equals_jax(coco):
    """F3."""
    ours, theirs = load_data(coco), jload_data(coco)
    assert ours.vocab_size == theirs.vocab_size == len(ours.word_to_idx) == V


def _post(srv, payload):
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}/caption",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())["captions"]


def test_server_takes_the_jax_servers_arguments(coco, tmp_path, monkeypatch):
    """F1: the port CLI trains A2C one epoch from sub-network checkpoints
    (the default widths, which the servers assume) under
    ``--pretrained_path`` and writes ``logs/<stamp>/a2cNetwork.ckpt``;
    both packages' servers, started with the JAX server's flags on it,
    answer the same greedy and beam-5 captions."""
    tmain = importlib.import_module("image_captioning_through_rl_tpu_torch.cli.main")
    cfg = NetConfig(vocab_size=V, input_dim=F, wordvec_dim=WIDTH, hidden_dim=WIDTH)
    pre = tmp_path / "pre"
    pre.mkdir()
    for seed, (kind, mod) in enumerate((("reward", treward), ("policy", tpolicy),
                                        ("value", tvalue))):
        tckpt.save_network(kind, mod.init(torch.Generator().manual_seed(seed), cfg),
                           str(pre / f"{kind}Network.ckpt"))
    monkeypatch.chdir(tmp_path)
    out = tmain.main(tmain.parse_args_with_config(tmain.build_arg_parser(), [
        "--data_dir", coco, "--pretrained_path", str(pre), "--epochs", "1", "--batch_size",
        "8", "--test_size", "20", "--device", "cpu",
        # the faithful eval decodes its 20 draws unpadded: cheap at width 512 on the CPU
        "--faithful_beam"]))
    model = os.path.join(out["log_dir"], "a2cNetwork.ckpt")
    argv = ["--model", model, "--data_dir", coco, "--pretrained_path", str(pre), "--port", "0",
            "--max_batch", "8"]
    ours = tserver.main(argv + ["--device", "cpu", "--no_warmup"], block=False)
    theirs = jserver.main(argv + ["--no_warmup"], block=False)
    try:
        feats = np.random.default_rng(3).standard_normal((5, F)).astype(np.float32)
        got = {}
        for beam in (0, 5):
            got[beam] = _post(ours, {"features": feats.tolist(), "beam_size": beam})
            assert got[beam] == _post(theirs, {"features": feats.tolist(), "beam_size": beam})
            assert len(got[beam]) == 5 and all(isinstance(c, str) for c in got[beam])
    finally:
        ours.stop()
        theirs.stop()
    data = load_data(coco, max_train=1)
    paths = {f"{k}_network": str(pre / f"{k}Network.ckpt") for k in ("policy", "value")}
    cap = tapi.load_captioner(model, data, paths, device="cpu")
    assert cap.caption(feats) == got[0] and cap.caption(feats, beam_size=5) == got[5]
    # sharded over a mesh of two CPU entries: the same captions
    sharded = tapi.load_captioner(model, data, paths, mesh=make_mesh(devices=["cpu"] * 2),
                                  device="cpu")
    assert sharded.caption(feats) == got[0] and sharded.caption(feats, beam_size=5) == got[5]
    assert (sharded.sample_captions(feats, num_samples=2, temperature=0.9, top_k=5, seed=3)
            == cap.sample_captions(feats, num_samples=2, temperature=0.9, top_k=5, seed=3))


def test_server_needs_a_bundle_or_a_vocabulary(capsys):
    with pytest.raises(SystemExit):
        tserver.main(["--model", "a2cNetwork.ckpt", "--device", "cpu"], block=False)
    assert "--data_dir" in capsys.readouterr().err


def _small_trainer_run(log_dir):
    """The policy pretrainer, two epochs of two minibatches, logging to
    ``log_dir``."""
    rng = np.random.default_rng(0)
    caps = rng.integers(4, V, size=(16, 9)).astype(np.int32)
    caps[:, 0], caps[:, -1] = 1, 2
    words = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(4, V)]
    feats = rng.standard_normal((8, F)).astype(np.float32)
    idxs = rng.integers(0, 8, size=16).astype(np.int32)
    urls = np.array([f"{i}.jpg" for i in range(8)])
    data = CocoData(caps, idxs, caps[:2], idxs[:2], feats, feats,
                    {w: i for i, w in enumerate(words)}, dict(enumerate(words)), urls, urls,
                    caption_lengths(caps), caption_lengths(caps[:2]))
    tloops.train_policy_network(data, {"policy_network": os.path.join(log_dir, "p.ckpt")},
                                log_dir, False, epochs=2, batch_size=8, device="cpu",
                                net_dims={"hidden_dim": 8, "wordvec_dim": 8})


def test_tensorboard_runs_hold_the_jsonl_scalars(tmp_path):
    """F2: the trainers tee the JSONL log into TensorBoard's ``runs/``."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    _small_trainer_run(str(tmp_path))
    jsonl = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert len(jsonl) == 4
    acc = EventAccumulator(str(tmp_path / "runs"))
    acc.Reload()
    assert acc.Tags()["scalars"] == ["Policy Network-loss"]
    events = [(e.step, e.value) for e in acc.Scalars("Policy Network-loss")]
    assert events == [(r["step"], float(np.float32(r["value"]))) for r in jsonl]


def test_no_tensorboard_writes_jsonl_alone(tmp_path, monkeypatch):
    """F2: with the TensorBoard import failing, no ``runs/`` and no raise."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import raises
    writer = make_metrics_writer(str(tmp_path / "w"))
    writer.add_scalar("tag", 1.5, 3)
    writer.close()
    assert os.listdir(tmp_path / "w") == ["metrics.jsonl"]
    _small_trainer_run(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["metrics.jsonl", "p.ckpt", "p.ckpt.trainstate", "w"]
