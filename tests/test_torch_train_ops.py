"""PyTorch port vs the JAX package: the GRU, the reward network, the
pretraining losses and rewards, the reward checkpoint layout, and the
training utilities (data iterators, optimiser, guard, metric log).

Weights come from the JAX initialisers and cross as numpy
(``from_jax_params``); inputs come from a seeded numpy generator. The JAX
side runs at ``precision="highest"`` (float32), so the two agree to float32
rounding: atol = rtol = 1e-5.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import config as jconfig
from image_captioning_through_rl_tpu.data import coco as jcoco
from image_captioning_through_rl_tpu.models import reward as jreward
from image_captioning_through_rl_tpu.models.convert import reward_from_torch, reward_to_torch
from image_captioning_through_rl_tpu.models.initializers import embedding_init as jembedding_init
from image_captioning_through_rl_tpu.models.initializers import gru_init as jgru_init
from image_captioning_through_rl_tpu.ops import losses as jlosses
from image_captioning_through_rl_tpu.ops import rnn as jrnn
from image_captioning_through_rl_tpu.ops.reward_ops import cosine_embedding_reward as jcosine
from image_captioning_through_rl_tpu.train import checkpoint as jckpt
from image_captioning_through_rl_tpu_torch import config as tconfig
from image_captioning_through_rl_tpu_torch.data import coco as tcoco
from image_captioning_through_rl_tpu_torch.models import (
    from_jax_params,
    reward,
    reward_from_state_dict,
    reward_to_state_dict,
)
from image_captioning_through_rl_tpu_torch.models import policy as tpolicy
from image_captioning_through_rl_tpu_torch.models.initializers import gru_init
from image_captioning_through_rl_tpu_torch.ops import losses, rnn
from image_captioning_through_rl_tpu_torch.ops.reward_ops import cosine_embedding_reward
from image_captioning_through_rl_tpu_torch.train import checkpoint as tckpt
from image_captioning_through_rl_tpu_torch.train.guard import TrainingDiverged, check_finite
from image_captioning_through_rl_tpu_torch.train.optim import adam
from image_captioning_through_rl_tpu_torch.utils.io import global_minibatch_number
from image_captioning_through_rl_tpu_torch.utils.logging import make_metrics_writer

torch.set_num_threads(1)

KW = dict(vocab_size=60, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=7)
JCFG = jconfig.NetConfig(precision="highest", **KW)
TCFG = tconfig.NetConfig(**KW)
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _caps(rng, n=6, t=7, vocab=60):
    caps = rng.integers(4, vocab, size=(n, t)).astype(np.int32)
    caps[:, 0] = 1
    lens = rng.integers(3, t + 1, size=n)
    caps[np.arange(n), lens - 1] = 2
    caps[np.arange(t)[None, :] >= lens[:, None]] = 0
    return caps


@pytest.fixture(scope="module")
def reward_params():
    jp = jreward.init(jax.random.PRNGKey(0), JCFG)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def test_gru_cell_and_scan_match_jax():
    rng = np.random.default_rng(0)
    jp = jgru_init(jax.random.PRNGKey(1), 12, 14)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    xs = rng.standard_normal((5, 7, 12)).astype(np.float32)
    h0 = rng.standard_normal((7, 14)).astype(np.float32)
    want = jrnn.gru_cell(jp, jnp.asarray(xs[0]), jnp.asarray(h0), precision="highest")
    np.testing.assert_allclose(rnn.gru_cell(tp, _t(xs[0]), _t(h0)).numpy(), want, **TOL)
    jhs, jfinal = jrnn.gru_scan(jp, jnp.asarray(xs), jnp.asarray(h0), precision="highest")
    ths, tfinal = rnn.gru_scan(tp, _t(xs), _t(h0))
    np.testing.assert_allclose(ths.numpy(), np.asarray(jhs), **TOL)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), **TOL)


def test_reward_forward_rewards_and_step_match_jax(reward_params):
    jp, tp = reward_params
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((6, KW["input_dim"])).astype(np.float32)
    caps = _caps(rng)
    jve, jse = jreward.forward(jp, JCFG, jnp.asarray(feats), jnp.asarray(caps))
    tve, tse = reward.forward(tp, TCFG, _t(feats), _t(caps).long())
    np.testing.assert_allclose(tve.numpy(), np.asarray(jve), **TOL)
    np.testing.assert_allclose(tse.numpy(), np.asarray(jse), **TOL)
    np.testing.assert_allclose(
        reward.get_rewards(tp, TCFG, _t(feats), _t(caps).long()).numpy(),
        np.asarray(jreward.get_rewards(jp, JCFG, jnp.asarray(feats), jnp.asarray(caps))), **TOL)
    jh = jreward.zero_rnn_state(JCFG, 6)
    th = reward.zero_rnn_state(TCFG, 6)
    for t in range(caps.shape[1]):
        jh = jreward.rnn_step(jp, JCFG, jnp.asarray(caps[:, t]), jh)
        th = reward.rnn_step(tp, TCFG, _t(caps[:, t]).long(), th)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(reward.embed_pair(tp, TCFG, _t(feats), th)[1].numpy(),
                               np.asarray(jse), **TOL)


def test_losses_and_cosine_reward_match_jax():
    rng = np.random.default_rng(2)
    ve, se = (rng.standard_normal((9, 16)).astype(np.float32) for _ in range(2))
    se[3] = 0.0  # a zero vector: the eps clamp keeps it finite
    for beta in (0.2, 1.5):
        np.testing.assert_allclose(
            float(losses.visual_semantic_embedding_loss(_t(ve), _t(se), beta)),
            float(jlosses.visual_semantic_embedding_loss(jnp.asarray(ve), jnp.asarray(se), beta,
                                                         precision="highest")), rtol=1e-5)
    np.testing.assert_allclose(cosine_embedding_reward(_t(ve), _t(se)).numpy(),
                               np.asarray(jcosine(jnp.asarray(ve), jnp.asarray(se))), **TOL)
    logits = 3 * rng.standard_normal((6, 7, 60)).astype(np.float32)
    caps = _caps(rng, t=8)
    lens = tcoco.caption_lengths(caps)
    np.testing.assert_allclose(
        float(losses.weighted_caption_xe_loss(_t(logits), _t(caps[:, 1:]), _t(lens))),
        float(jlosses.weighted_caption_xe_loss(jnp.asarray(logits), jnp.asarray(caps[:, 1:]),
                                               jnp.asarray(lens))), rtol=1e-5)


def test_reward_pt_round_trip_is_bit_exact(reward_params, tmp_path):
    """JAX reward_to_torch -> .pt -> port load -> port save -> JAX
    load_network gives back the JAX arrays bit for bit (the GRU keeps both
    biases)."""
    jp, _ = reward_params
    src = tmp_path / "src.pt"
    torch.save({k: _t(np.array(v)) for k, v in reward_to_torch(jp).items()}, src)
    loaded = tckpt.load_network("reward", str(src), device="cpu")
    assert set(loaded["gru"]) == {"wi", "wh", "bi", "bh"}
    out = tmp_path / "rewardNetwork.pt"
    tckpt.save_network_pt("reward", loaded, str(out))
    back = jckpt.load_network("reward", str(out))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    sd = reward_to_state_dict(loaded)
    assert set(sd) == set(reward_to_torch(jp))
    again = reward_from_state_dict(sd)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(loaded)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(reward_from_torch({k: v.numpy() for k, v in sd.items()})[
        "gru"]["bh"], np.asarray(jp["gru"]["bh"]))


@pytest.mark.parametrize("kind", ["policy", "value", "reward"])
def test_checkpoints_reject_native_paths(kind, tmp_path):
    """Native ``.ckpt`` paths are read and written (the msgpack tree) since
    the CLI slice; a missing one raises ``FileNotFoundError`` (the trainers
    then train the network), and one holding another kind of network is
    rejected, naming the file."""
    path = str(tmp_path / f"{kind}Network.ckpt")
    with pytest.raises(FileNotFoundError):
        tckpt.load_network(kind, path, device="cpu")
    other, init = ("reward", reward.init) if kind != "reward" else ("policy", tpolicy.init)
    tckpt.save_network(other, init(torch.Generator().manual_seed(0), TCFG), path)
    with pytest.raises(ValueError, match=rf"{path}: not a {kind} network"):
        tckpt.load_network(kind, path, device="cpu")


def test_reward_init_matches_jax_shapes_and_pretrained_embeddings():
    gen = torch.Generator().manual_seed(0)
    tp = reward.init(gen, TCFG)
    jp = jreward.init(jax.random.PRNGKey(0), JCFG)
    assert jax.tree.map(np.shape, jp) == jax.tree.map(lambda t: tuple(t.shape), tp)
    vecs = np.random.default_rng(3).standard_normal((60, 10)).astype(np.float32)
    tp = reward.init(gen, TCFG, vecs)
    np.testing.assert_array_equal(tp["embedding"].numpy(), vecs)
    assert tp["gru"]["wi"].shape == (10, 48)
    assert gru_init(gen, 10, 16)["bh"].shape == (48,)


def test_coco_data_and_iterators_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(tcoco.CocoData)] == [
        (f.name, f.default) for f in dataclasses.fields(jcoco.CocoData)]
    rng = np.random.default_rng(4)
    caps = _caps(rng, n=11, t=9)
    fields = dict(train_captions=caps, train_image_idxs=rng.integers(0, 5, 11),
                  val_captions=caps, val_image_idxs=rng.integers(0, 5, 11),
                  train_features=rng.standard_normal((5, 4)).astype(np.float32),
                  val_features=rng.standard_normal((5, 4)).astype(np.float32),
                  word_to_idx={"a": 0}, idx_to_word={0: "a"},
                  train_urls=np.array([f"u{i}" for i in range(5)]),
                  val_urls=np.array([f"u{i}" for i in range(5)]),
                  train_captions_lens=jcoco.caption_lengths(caps),
                  val_captions_lens=jcoco.caption_lengths(caps))
    tdata, jdata = tcoco.CocoData(**fields), jcoco.CocoData(**fields)
    got = list(tcoco.get_coco_minibatches(tdata, 4, rng=np.random.default_rng(7)))
    want = list(jcoco.get_coco_minibatches(jdata, 4, rng=np.random.default_rng(7)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tcoco.get_coco_batch(tdata, 5, "val", np.random.default_rng(8)),
                    jcoco.get_coco_batch(jdata, 5, "val", np.random.default_rng(8))):
        np.testing.assert_array_equal(a, b)
    got = [m.tolist() for m in tcoco.epoch_minibatch_indices(10, 4, np.random.default_rng(9))]
    assert got == [m.tolist() for m in jcoco.epoch_minibatch_indices(
        10, 4, np.random.default_rng(9))]
    assert [len(m) for m in got] == [4, 4, 2]
    assert global_minibatch_number(3, 5, 512) == 3 * 512 + 5  # Q10


def test_adam_freezes_embeddings_and_matches_torch_defaults():
    params = {"embedding": torch.randn(5, 3), "lstm": {"wi": torch.randn(3, 8)}}
    opt = adam(1e-3, params, freeze_embeddings=True)
    assert not params["embedding"].requires_grad and params["lstm"]["wi"].requires_grad
    assert [p for g in opt.param_groups for p in g["params"]] == [params["lstm"]["wi"]]
    group = opt.param_groups[0]
    assert (group["betas"], group["eps"], group["lr"]) == ((0.9, 0.999), 1e-8, 1e-3)
    opt = adam(1e-3, params)
    assert params["embedding"].requires_grad and len(opt.param_groups[0]["params"]) == 2


def test_guard_raises_and_dumps(tmp_path, monkeypatch):
    check_finite(1.5, "X", "here")
    dumped = []
    with pytest.raises(TrainingDiverged, match="dumped"):
        check_finite(float("nan"), "X", "epoch 1", dump=dumped.append,
                     dump_path=str(tmp_path / "x.pt"))
    assert dumped == [str(tmp_path / "x.pt")]
    monkeypatch.setenv("ICRL_NO_NAN_GUARD", "1")
    check_finite(float("inf"), "X", "here")
    monkeypatch.setenv("ICRL_NO_NAN_GUARD", "0")
    with pytest.raises(TrainingDiverged):
        check_finite(float("inf"), "X", "here")


def test_metrics_writer_jsonl(tmp_path):
    w = make_metrics_writer(str(tmp_path))
    w.add_scalar("Policy Network-loss", 2.5, 7)
    w.close()
    assert [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()] == [
        {"tag": "Policy Network-loss", "value": 2.5, "step": 7}]
    make_metrics_writer(None).add_scalar("x", 1.0, 0)
