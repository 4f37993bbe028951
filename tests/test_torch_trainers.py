"""The port's trainers vs the JAX package's, end to end on a tiny bundle.

Each port trainer runs with its network's ``init`` replaced by the JAX
initialiser's weights (carried across as numpy); the JAX trainer runs its
plain XLA step (``fused_chain=False``, ``chunk_steps=1``,
``device_data=False``). Both walk the same minibatches (the same numpy
seeds) and, for the value trainer, the same prefix lengths and the same
frozen reward and policy ``.pt`` files. Compared: every per-minibatch loss
in the JSONL metric logs (tag, step and value, rtol 1e-4: a few Adam steps
of float32 noise, see ``test_torch_steps.py``), and the Q12 checkpoint —
the port's ``.pt`` read by the JAX package's own ``load_network`` against
the JAX trainer's ``.ckpt``, atol 2e-5 (and, for the policy trainer, the
port's own native ``.ckpt``).

A2C (plain, and the curriculum ``[4]`` with its appended level 16) runs the
JAX trainer's plain XLA step (``fused_rollout=False``) and the port's plain
step; both load the same three sub-network ``.pt`` files, draw the same
threefry keys and walk the same minibatches. At T = 9 level 16 gives
``curr_seq_len = caplen - 16 < 1`` for every minibatch, so that level
exercises the skip rule: a key is drawn, nothing is logged or updated.
Compared: the JSONL loss, mean-reward and mean-advantage tags (rtol 1e-4),
the a2c ``.pt`` (read by the JAX package's ``load_network("a2c", ...)``)
against the JAX trainer's checkpoint (atol 2e-5), and the results file.
"""

import json

import jax
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu.data.coco import CocoData as JCocoData
from image_captioning_through_rl_tpu.models import policy as jpolicy
from image_captioning_through_rl_tpu.models import reward as jreward
from image_captioning_through_rl_tpu.models import value as jvalue
from image_captioning_through_rl_tpu.train import checkpoint as jckpt
from image_captioning_through_rl_tpu.train import loops as jloops
from image_captioning_through_rl_tpu_torch import api as tapi
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.data.coco import CocoData, caption_lengths
from image_captioning_through_rl_tpu_torch.models import a2c as ta2c
from image_captioning_through_rl_tpu_torch.models import a2c_to_state_dict
from image_captioning_through_rl_tpu_torch.models import policy as tpolicy
from image_captioning_through_rl_tpu_torch.models import reward as treward
from image_captioning_through_rl_tpu_torch.models import value as tvalue
from image_captioning_through_rl_tpu_torch.models.convert import from_jax_params
from image_captioning_through_rl_tpu_torch.ops import prng as tprng
from image_captioning_through_rl_tpu_torch.train import checkpoint as tckpt
from image_captioning_through_rl_tpu_torch.train import loops as tloops

torch.set_num_threads(1)

V, F, T = 40, 16, 9
DIMS = {"wordvec_dim": 16, "hidden_dim": 16}
SEED = 3
KW = dict(epochs=2, batch_size=8, seed=SEED, net_dims=DIMS)


def _fields(seed=0, n_img=12, n_cap=24):
    rng = np.random.default_rng(seed)
    words = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(4, V)]
    caps = rng.integers(4, V, size=(n_cap, T)).astype(np.int32)
    caps[:, 0] = 1
    lens = rng.integers(3, T + 1, size=n_cap)
    caps[np.arange(n_cap), lens - 1] = 2
    caps[np.arange(T)[None, :] >= lens[:, None]] = 0
    urls = np.array([f"img{i}.jpg" for i in range(n_img)])
    feats = rng.standard_normal((n_img, F)).astype(np.float32)
    idxs = rng.integers(0, n_img, size=n_cap).astype(np.int32)
    return dict(train_captions=caps, train_image_idxs=idxs, val_captions=caps[:4],
                val_image_idxs=idxs[:4], train_features=feats, val_features=feats,
                word_to_idx={w: i for i, w in enumerate(words)},
                idx_to_word=dict(enumerate(words)), train_urls=urls, val_urls=urls,
                train_captions_lens=caption_lengths(caps),
                val_captions_lens=caption_lengths(caps[:4]))


INITS = {"reward": (jreward, treward, 0), "policy": (jpolicy, tpolicy, 1),
         "value": (jvalue, tvalue, 2)}


def _log(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("kind", ["reward", "policy", "value"])
def test_trainer_matches_jax_trainer(kind, tmp_path, monkeypatch):
    fields = _fields()
    jdata, tdata = JCocoData(**fields), CocoData(**fields)
    jcfg = jloops._cfg_for(jdata, False, DIMS)
    jmod, tmod, offset = INITS[kind]
    jinit = jmod.init(jax.random.PRNGKey(SEED + offset), jcfg)
    monkeypatch.setattr(tmod, "init", lambda gen, cfg, emb=None: from_jax_params(
        jax.tree.map(np.asarray, jinit)))

    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpaths = {f"{kind}_network": str(tmp_path / "j" / f"{kind}Network.ckpt")}
    tpaths = {f"{kind}_network": str(tmp_path / "t" / f"{kind}Network.pt")}
    if kind == "value":  # frozen reward and policy networks, one .pt each, read by both
        for other, key in (("reward", 5), ("policy", 6)):
            path = str(tmp_path / f"{other}Network.pt")
            jckpt.save_network_pt(other, INITS[other][0].init(jax.random.PRNGKey(key), jcfg), path)
            jpaths[f"{other}_network"] = tpaths[f"{other}_network"] = path

    jtrain = getattr(jloops, f"train_{kind}_network")
    extra = {} if kind == "value" else {"fused_chain": False}
    jparams = jtrain(jdata, jpaths, str(tmp_path / "j"), False, device_data=False, chunk_steps=1,
                     **extra, **KW)
    getattr(tloops, f"train_{kind}_network")(tdata, tpaths, str(tmp_path / "t"), False,
                                             device="cpu", fused_chain=False, **KW)

    want = _log(tmp_path / "j" / "metrics.jsonl")
    got = _log(tmp_path / "t" / "metrics.jsonl")
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    assert len(got) == 2 * 3
    np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want], rtol=1e-4)

    saved_j = jckpt.load_network(kind, jpaths[f"{kind}_network"], template=jparams)
    saved_t = jckpt.load_network(kind, tpaths[f"{kind}_network"])
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(saved_j),
                            jax.tree.leaves(saved_t)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_policy_trainer_native_checkpoint_matches_jax(tmp_path, monkeypatch):
    """The policy trainer's Q12 checkpoint at a ``.ckpt`` path is the native
    format: both packages' ``load_network`` read it, equal to the JAX
    trainer's ``.ckpt`` within atol 2e-5."""
    fields = _fields()
    jdata, tdata = JCocoData(**fields), CocoData(**fields)
    jcfg = jloops._cfg_for(jdata, False, DIMS)
    jinit = jpolicy.init(jax.random.PRNGKey(SEED + 1), jcfg)
    monkeypatch.setattr(tpolicy, "init", lambda gen, cfg, emb=None: from_jax_params(
        jax.tree.map(np.asarray, jinit)))
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "policyNetwork.ckpt")
    jparams = jloops.train_policy_network(jdata, {"policy_network": jpath}, None, False,
                                          device_data=False, chunk_steps=1, fused_chain=False,
                                          **KW)
    tloops.train_policy_network(tdata, {"policy_network": tpath}, None, False, device="cpu",
                                fused_chain=False, **KW)
    saved_j = jckpt.load_network("policy", jpath, template=jparams)
    saved_t = jckpt.load_network("policy", tpath, template=jparams)
    port_t = tckpt.load_network("policy", tpath, device="cpu",
                                cfg=NetConfig(vocab_size=V, input_dim=F, **DIMS))
    for (path, a), b, c in zip(jax.tree_util.tree_leaves_with_path(saved_j),
                               jax.tree.leaves(saved_t), jax.tree.leaves(port_t)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))
        np.testing.assert_array_equal(c.numpy(), np.asarray(b))


@pytest.mark.parametrize("curriculum", [None, [4]], ids=["plain", "curriculum"])
def test_a2c_trainer_matches_jax_trainer(curriculum, tmp_path):
    fields = _fields()
    jdata, tdata = JCocoData(**fields), CocoData(**fields)
    jcfg = jloops._cfg_for(jdata, False, DIMS)
    nets = {}
    for kind, (jmod, _, _), key in zip(("reward", "policy", "value"), INITS.values(), (5, 6, 7)):
        path = str(tmp_path / f"{kind}Network.pt")
        jckpt.save_network_pt(kind, jmod.init(jax.random.PRNGKey(key), jcfg), path)
        nets[f"{kind}_network"] = path
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpaths = dict(nets, a2c_network=str(tmp_path / "j" / "a2cNetwork.ckpt"))
    tpaths = dict(nets, a2c_network=str(tmp_path / "t" / "a2cNetwork.pt"))
    saves = {side: {"model_path": str(tmp_path / side / f"model.{ext}"),
                    "results_path": str(tmp_path / side / "results.txt")}
             for side, ext in (("j", "ckpt"), ("t", "pt"))}
    kw = dict(KW, curriculum=curriculum)
    jparams, _, _ = jloops.train_a2c_network(jdata, saves["j"], jpaths, str(tmp_path / "j"),
                                             False, fused_rollout=False, chunk_steps=1, **kw)
    tparams, _, _ = tloops.train_a2c_network(tdata, saves["t"], tpaths, str(tmp_path / "t"),
                                             False, fused_rollout=False, device="cpu", **kw)

    want = _log(tmp_path / "j" / "metrics.jsonl")
    got = _log(tmp_path / "t" / "metrics.jsonl")
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    prefix = "A2C Network-episodic" if curriculum is None else "A2C Curriculum Level-4"
    # 3 minibatches x 2 epochs x 3 tags; level 16 logs nothing (all skipped)
    assert len(got) == 18 and all(r["tag"].startswith(prefix) for r in got)
    np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want], rtol=1e-4)

    saved_j = jckpt.load_network("a2c", jpaths["a2c_network"], template=jparams)
    for path in (tpaths["a2c_network"], saves["t"]["model_path"]):
        saved_t = jckpt.load_network("a2c", path)
        for (key, a), b in zip(jax.tree_util.tree_leaves_with_path(saved_j),
                               jax.tree.leaves(saved_t)):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=2e-5,
                                       err_msg=jax.tree_util.keystr(key))
    assert ((tmp_path / "t" / "results.txt").read_text()
            == (tmp_path / "j" / "results.txt").read_text())


def _entry_points(tmp_path):
    data = CocoData(**_fields())
    cfg = NetConfig(vocab_size=V, input_dim=F, max_seq_len=T, **DIMS)
    model_pt = tmp_path / "a2cNetwork.pt"
    torch.save(a2c_to_state_dict(ta2c.init(torch.Generator().manual_seed(0), cfg)), model_pt)
    vocab = tmp_path / "coco2014_vocab.json"
    words = [data.idx_to_word[i] for i in range(V)]
    vocab.write_text(json.dumps({"word_to_idx": {w: i for i, w in enumerate(words)},
                                 "idx_to_word": words}))
    paths = {f"{k}_network": str(tmp_path / f"{k}Network.pt")
             for k in ("reward", "policy", "value", "a2c")}
    saves = {"model_path": str(tmp_path / "model.pt"), "results_path": str(tmp_path / "r.txt")}
    return {
        "load_captioner": lambda: tapi.load_captioner(str(model_pt), data, paths),
        "load_captioner_pt": lambda: tapi.load_captioner_pt(str(model_pt), str(vocab)),
        "train_reward_network": lambda: tloops.train_reward_network(data, paths, None, False),
        "train_policy_network": lambda: tloops.train_policy_network(data, paths, None, False),
        "train_value_network": lambda: tloops.train_value_network(data, paths, None, False),
        "train_a2c_network": lambda: tloops.train_a2c_network(data, saves, paths, None, False,
                                                              epochs=1, batch_size=8),
        "load_network": lambda: tckpt.load_network("a2c", str(model_pt)),
        "gumbel_noise": lambda: tprng.gumbel_noise(tprng.split(tprng.PRNGKey(0), 2), (2, 3)),
        "gumbel": lambda: tprng.gumbel(tprng.PRNGKey(0), (2, 3)),
    }


@pytest.mark.parametrize("entry", ["load_captioner", "load_captioner_pt", "train_reward_network",
                                   "train_policy_network", "train_value_network",
                                   "train_a2c_network", "load_network", "gumbel_noise",
                                   "gumbel"])
def test_default_device_is_the_card(entry, tmp_path, monkeypatch):
    """The entry points run on the card unless the caller asks for the CPU:
    with no CUDA device their default raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_points(tmp_path)[entry]()
    assert not (tmp_path / "metrics.jsonl").exists()
