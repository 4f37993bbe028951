"""The port's program spans (``utils/profiling.annotate``) on the CPU: the
Captioner's and the trainers' phases as named host ranges on
``torch.profiler``'s timeline, siblings and never nested, and no
``record_function`` made while no profiler runs."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from image_captioning_through_rl_tpu_torch.api import Captioner
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.data.coco import CocoData, caption_lengths
from image_captioning_through_rl_tpu_torch.models import policy, value
from image_captioning_through_rl_tpu_torch.models import reward as reward_mod
from image_captioning_through_rl_tpu_torch.train import loops
from image_captioning_through_rl_tpu_torch.train.optim import adam
from image_captioning_through_rl_tpu_torch.utils import profiling

torch.set_num_threads(1)

KW = dict(vocab_size=30, input_dim=12, wordvec_dim=10, hidden_dim=12, max_seq_len=7)
WORDS = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(4, KW["vocab_size"])]
CAPTION = ("caption.features_in", "caption.search", "caption.tokens_out", "caption.strings")


def _spans(prof, prefix: str) -> list:
    """``(name, start_us, end_us)`` of the profiled host ranges whose name
    starts with ``prefix``, in the order they started."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(prefix) and e.device_type() == torch.autograd.DeviceType.CPU:
            start = e.start_ns() / 1e3
            out.append((e.name(), start, start + e.duration_ns() / 1e3))
    return sorted(out, key=lambda s: s[1])


def _siblings(spans: list) -> bool:
    """No span starts before the one before it has ended."""
    return all(b[1] >= a[2] for a, b in zip(spans, spans[1:]))


@pytest.fixture(scope="module")
def captioner():
    cfg = NetConfig(**KW)
    gen = torch.Generator().manual_seed(0)
    params = {"policy": policy.init(gen, cfg), "value": value.init(gen, cfg)}
    return Captioner(params, cfg, dict(enumerate(WORDS)), device="cpu")


def _feats(n=5):
    return np.random.default_rng(1).standard_normal((n, KW["input_dim"])).astype(np.float32)


@pytest.mark.parametrize("route", ["greedy", "beam", "sampled"])
def test_caption_call_emits_its_four_spans_in_order(captioner, route):
    """One caption call on the plain CPU path emits each ``caption.*`` span
    once, in the order of its phases, none inside another."""
    call = {"greedy": lambda f: captioner.caption(f),
            "beam": lambda f: captioner.caption(f, beam_size=3),
            "sampled": lambda f: captioner.sample_captions(f, temperature=0.8, seed=2)}[route]
    feats = _feats()
    want = call(feats)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = call(feats)
    assert got == want
    spans = _spans(prof, "caption.")
    assert [s[0] for s in spans] == list(CAPTION)
    assert _siblings(spans)


def test_spans_cost_one_check_without_a_profiler(captioner, monkeypatch):
    """With no profiler active ``annotate`` makes no ``record_function``:
    it hands back one shared no-op context, through a whole caption call
    too; under a profiler it makes one."""

    def refuse(*a, **k):
        raise AssertionError("record_function made with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = profiling.annotate("caption.search")
    assert first is profiling.annotate("train.dispatch")
    with first:
        pass
    captioner.caption(_feats(), beam_size=3)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler active"):
            profiling.annotate("caption.search")


def _data(n_img=12, n_cap=26, t=9, v=40, f=16):
    rng = np.random.default_rng(0)
    words = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(4, v)]
    caps = rng.integers(4, v, size=(n_cap, t)).astype(np.int32)
    caps[:, 0] = 1
    lens = rng.integers(3, t + 1, size=n_cap)
    caps[np.arange(n_cap), lens - 1] = 2
    caps[np.arange(t)[None, :] >= lens[:, None]] = 0
    urls = np.array([f"img{i}.jpg" for i in range(n_img)])
    feats = rng.standard_normal((n_img, f)).astype(np.float32)
    idxs = rng.integers(0, n_img, size=n_cap).astype(np.int32)
    return CocoData(train_captions=caps, train_image_idxs=idxs, val_captions=caps[:4],
                    val_image_idxs=idxs[:4], train_features=feats, val_features=feats,
                    word_to_idx={w: i for i, w in enumerate(words)},
                    idx_to_word=dict(enumerate(words)), train_urls=urls, val_urls=urls,
                    train_captions_lens=caption_lengths(caps),
                    val_captions_lens=caption_lengths(caps[:4]))


DIMS = {"wordvec_dim": 16, "hidden_dim": 16}


@pytest.mark.parametrize("chunk_steps", [2, 1], ids=["chunked", "per_step"])
def test_pretrainer_walks_emit_the_train_spans(tmp_path, chunk_steps):
    """The policy pretrainer's chunked walk (eager chunks on the CPU: 26
    captions at batch 8, a chunk of 2, one of 1 and a ragged tail) and its
    per-step walk emit the ``train.*`` spans as siblings: per epoch one
    permutation and one snapshot, a gather and a dispatch a chunk or step,
    and the best-loss save when the first loss improves on none."""
    epochs = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loops.train_policy_network(_data(), {"policy_network": str(tmp_path / "p.ckpt")}, None,
                                   False, epochs=epochs, batch_size=8, seed=3, device="cpu",
                                   chunk_steps=chunk_steps, net_dims=DIMS)
    spans = _spans(prof, "train.")
    assert _siblings(spans)
    count = {n: sum(s[0] == n for s in spans) for n in
             ("train.permute", "train.gather", "train.dispatch", "train.losses",
              "train.save_best", "train.snapshot", "train.capture")}
    dispatches = 3 if chunk_steps == 2 else 4  # chunks of 2 and 1, a tail; or 4 steps
    assert count["train.permute"] == count["train.snapshot"] == epochs
    assert count["train.gather"] == count["train.dispatch"] == epochs * dispatches
    assert count["train.losses"] >= epochs * dispatches and count["train.save_best"] >= 1
    assert count["train.capture"] == 0  # eager chunks capture nothing
    assert {s[0] for s in spans} <= set(count)
    snapshots = [s for s in spans if s[0] == "train.snapshot"]
    assert spans[-1] == snapshots[-1]  # an epoch ends with its snapshot


def test_a2c_epochs_emit_the_train_spans(tmp_path):
    """Chunked A2C (two chunks of 2 minibatches an epoch) emits the
    ``train.*`` spans as siblings, its saves and snapshot in one
    ``train.snapshot`` an epoch."""
    data = _data(n_cap=32)
    cfg = loops._cfg_for(data, False, DIMS)
    params = {"value": value.init(torch.Generator().manual_seed(0), cfg),
              "policy": policy.init(torch.Generator().manual_seed(1), cfg)}
    rparams = reward_mod.init(torch.Generator().manual_seed(9), cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loops.a2c_training(data, params, rparams, adam(1e-3, params), cfg, None,
                           [str(tmp_path / "a2c.ckpt")], batch_size=8, epochs=2, seed=2,
                           chunk_steps=2, fused_rollout=False,
                           train_state_path=str(tmp_path / "a2c.trainstate"))
    spans = _spans(prof, "train.")
    assert _siblings(spans)
    names = [s[0] for s in spans]
    assert names.count("train.permute") == names.count("train.snapshot") == 2
    assert names.count("train.gather") == names.count("train.dispatch") == 4
    assert names.count("train.losses") == 4
