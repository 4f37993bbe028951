"""Exact resume in the port: ``.trainstate`` snapshots in the JAX package's
layout (``train/checkpoint.py``) and the trainers' ``resume``, on the CPU.

Mirrors the JAX package's ``tests/test_resume.py`` case for case where a
case applies (typed jax keys do not exist in the port, and it has no kernel
probe to pin; it records its route instead):

  * the snapshot's bytes equal the JAX package's ``save_train_state`` for
    the same state, for ``adam(lr)`` and for ``freeze_embeddings=True``
    (``multi_transform``'s tree); a round trip restores the weights, both
    Adam moments, the count, the key, the generator and the meta;
  * a JAX snapshot resumed by the port, and a port snapshot resumed by the
    JAX package, each finishing within rtol 1e-4 (losses) and atol 2e-5
    (weights) of the other package's uninterrupted run;
  * the port's resume bit-identical to its uninterrupted run for every
    trainer: the three pretrainers (chunked, the value trainer's prefix
    stream included), plain A2C, the curriculum interrupted mid-level, at a
    level boundary and in the second level, and ``train_a2c_network``: the
    weights, the JSONL scalars, the Q12 checkpoint and the snapshot;
  * the wrong-kind, wrong-levels, wrong-shape, wrong-version and
    completed-run cases, the weights-only fallback, a resume without a
    snapshot, the route recorded and a changed route reported;
  * ``--resume`` through ``cli/main``.
"""

import importlib
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu.config import NetConfig as JNetConfig
from image_captioning_through_rl_tpu.data.coco import CocoData as JCocoData
from image_captioning_through_rl_tpu.data.synthetic import make_synthetic_coco
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu.models import policy as jpolicy
from image_captioning_through_rl_tpu.models import reward as jreward
from image_captioning_through_rl_tpu.models import value as jvalue
from image_captioning_through_rl_tpu.train import checkpoint as jckpt
from image_captioning_through_rl_tpu.train import loops as jloops
from image_captioning_through_rl_tpu.train import optim as joptim
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.data.coco import CocoData, caption_lengths
from image_captioning_through_rl_tpu_torch.models import a2c as ta2c
from image_captioning_through_rl_tpu_torch.models import policy as tpolicy
from image_captioning_through_rl_tpu_torch.models import reward as treward
from image_captioning_through_rl_tpu_torch.models import value as tvalue
from image_captioning_through_rl_tpu_torch.models.convert import from_jax_params
from image_captioning_through_rl_tpu_torch.ops.prng import PRNGKey, split
from image_captioning_through_rl_tpu_torch.train import checkpoint as tckpt
from image_captioning_through_rl_tpu_torch.train import loops as tloops
from image_captioning_through_rl_tpu_torch.train.optim import adam

torch.set_num_threads(1)

V, F, T = 40, 16, 9
DIMS = {"wordvec_dim": 16, "hidden_dim": 16}
CFG = NetConfig(vocab_size=V, input_dim=F, max_seq_len=T, **DIMS)
JCFG = JNetConfig(vocab_size=V, input_dim=F, max_seq_len=T, **DIMS)
KW = dict(batch_size=8, seed=2, net_dims=DIMS)
MODS = {"reward": (treward, jreward), "policy": (tpolicy, jpolicy), "value": (tvalue, jvalue)}


def _fields(seed=0, n_img=12, n_cap=26):
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


DATA = CocoData(**_fields())
JDATA = JCocoData(**_fields())


def _leaves(tree):
    return [leaf for k in sorted(tree)
            for leaf in (_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def _trees_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert torch.equal(x.detach(), y.detach())


def _close_to_jax(port_tree, jax_tree):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jax_tree),
                            _leaves(port_tree), strict=True):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=0, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))


def _log(path):
    return [json.loads(line) for line in open(path).read().splitlines()]


# ---- the snapshot format ----


@pytest.mark.parametrize("freeze", [False, True], ids=["adam", "freeze_embeddings"])
def test_train_state_bytes_equal_jax(freeze, tmp_path):
    """One Adam update in optax, its state set into ``torch.optim.Adam`` by
    hand; both packages' snapshots of it are the same bytes, and each reads
    the other's."""
    jp = ja2c.init(jax.random.PRNGKey(0), JCFG)
    tx = joptim.adam(1e-3, jp, freeze)
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.1) * jnp.arange(x.size).reshape(x.shape)
                         / x.size, jp)
    _, opt_state = tx.update(grads, tx.init(jp), jp)
    rng = np.random.default_rng(7)
    rng.standard_normal(100)  # the generator's position must survive
    key = split(PRNGKey(3))[0]
    meta = {"kind": "a2c", "epoch_done": 4, "best": float("inf"), "fused": False,
            "rng_state": rng.bit_generator.state}
    jckpt.save_train_state(str(tmp_path / "j.trainstate"), jp, opt_state, jnp.asarray(key), meta)

    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    opt = adam(1e-3, tp, freeze)
    inner = opt_state.inner_states["train"].inner_state if freeze else opt_state
    adam_state = inner[0]
    mu, nu = (jax.tree.leaves(t) for t in (adam_state.mu, adam_state.nu))
    trained = {id(p) for p in opt.param_groups[0]["params"]}
    # optax's masked (frozen) leaves hold no moments
    for p, m, v in zip([p for p in _leaves(tp) if id(p) in trained], mu, nu, strict=True):
        opt.state[p] = {"step": torch.tensor(1.0), "exp_avg": torch.from_numpy(np.array(m)),
                        "exp_avg_sq": torch.from_numpy(np.array(v))}
    assert freeze == (len(trained) < len(_leaves(tp)))
    tckpt.save_train_state(str(tmp_path / "t.trainstate"), tp, opt, key, meta)
    assert (tmp_path / "t.trainstate").read_bytes() == (tmp_path / "j.trainstate").read_bytes()

    got = jckpt.load_train_state(str(tmp_path / "t.trainstate"), jp, tx.init(jp))
    for a, b in zip(jax.tree.leaves(got["opt_state"]), jax.tree.leaves(opt_state), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back = tckpt.load_train_state(str(tmp_path / "j.trainstate"), tp)
    tp2 = ta2c.init(torch.Generator().manual_seed(5), CFG)
    opt2 = adam(1e-3, tp2, freeze)
    tckpt.restore_train_state(back, tp2, opt2)
    _trees_equal(tp2, tp)
    for p, q in zip(_leaves(tp), _leaves(tp2)):
        assert (p in opt.state) == (q in opt2.state)
        if p in opt.state:
            assert all(torch.equal(opt.state[p][n], opt2.state[q][n])
                       for n in ("step", "exp_avg", "exp_avg_sq"))
    np.testing.assert_array_equal(back["key"], key)
    r2 = np.random.default_rng(0)
    r2.bit_generator.state = back["meta"]["rng_state"]
    assert r2.standard_normal() == rng.standard_normal()
    assert back["meta"]["best"] == float("inf") and back["meta"]["epoch_done"] == 4


def test_train_state_before_the_first_step(tmp_path):
    """A fresh optimiser's snapshot holds zero moments and count 0, as
    optax's ``init`` does; restoring it leaves Adam's state empty."""
    jp = ja2c.init(jax.random.PRNGKey(0), JCFG)
    tx = joptim.adam(1e-3)
    jckpt.save_train_state(str(tmp_path / "j"), jp, tx.init(jp), jnp.zeros(2, jnp.uint32),
                           {"kind": "a2c"})
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    opt = adam(1e-3, tp)
    tckpt.save_train_state(str(tmp_path / "t"), tp, opt, np.zeros(2, np.uint32),
                           {"kind": "a2c"})
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    tckpt.restore_train_state(tckpt.load_train_state(str(tmp_path / "j"), tp), tp, opt)
    assert not opt.state


def test_train_state_version_gate(tmp_path, monkeypatch):
    tp = ta2c.init(torch.Generator().manual_seed(0), CFG)
    path = str(tmp_path / "a2c.trainstate")
    monkeypatch.setattr(tckpt, "_TRAIN_STATE_VERSION", 99)
    tckpt.save_train_state(path, tp, adam(1e-3, tp), np.zeros(2, np.uint32), {"kind": "a2c"})
    monkeypatch.undo()
    with pytest.raises(ValueError, match="version"):
        tckpt.load_train_state(path, tp)


def test_train_state_rejects_wrong_architecture(tmp_path):
    tp = ta2c.init(torch.Generator().manual_seed(0), CFG)
    path = str(tmp_path / "a2c.trainstate")
    tckpt.save_train_state(path, tp, adam(1e-3, tp), np.zeros(2, np.uint32),
                           {"kind": "a2c", "epoch_done": 1})
    big = NetConfig(vocab_size=V, input_dim=F, wordvec_dim=16, hidden_dim=28)
    with pytest.raises(ValueError, match="architecture"):
        tckpt.load_train_state(path, ta2c.init(torch.Generator().manual_seed(1), big))
    with pytest.raises(ValueError, match="another network"):
        tckpt.load_train_state(path, tpolicy.init(torch.Generator().manual_seed(1), CFG))


# ---- the pretrainers ----


def _frozen(tmp_path):
    paths = {}
    for kind, seed in (("reward", 11), ("policy", 12)):
        path = str(tmp_path / f"frozen_{kind}.ckpt")
        tckpt.save_network(kind, MODS[kind][0].init(torch.Generator().manual_seed(seed), CFG),
                           path)
        paths[f"{kind}_network"] = path
    return paths


def _pretrain(kind, tmp_path, tag, epochs, resume=False, **kw):
    d = tmp_path / tag
    d.mkdir(exist_ok=True)
    paths = dict(_frozen(tmp_path), **{f"{kind}_network": str(d / f"{kind}.ckpt")})
    return getattr(tloops, f"train_{kind}_network")(
        DATA, paths, str(d), False, epochs=epochs, resume=resume, device="cpu",
        **dict(dict(KW, chunk_steps=2), **kw)), d


@pytest.mark.parametrize("kind", ["reward", "policy", "value"])
def test_pretrainer_resume_bit_identical(kind, tmp_path):
    """Three epochs against one and a resume to three (chunked, with a
    ragged tail): the weights, the JSONL scalars (the split run appends to
    the same log), the Q12 checkpoint and the snapshot bit for bit; the
    value trainer's stdlib prefix-length stream rides in the snapshot."""
    full, dfull = _pretrain(kind, tmp_path, "full", 3)
    _pretrain(kind, tmp_path, "split", 1)
    resumed, dsplit = _pretrain(kind, tmp_path, "split", 3, resume=True)
    _trees_equal(full, resumed)
    for name in ("metrics.jsonl", f"{kind}.ckpt", f"{kind}.ckpt.trainstate"):
        assert (dsplit / name).read_bytes() == (dfull / name).read_bytes(), name


def test_pretrainer_resume_without_snapshot_is_fresh(tmp_path):
    a, _ = _pretrain("policy", tmp_path, "a", 1)
    b, _ = _pretrain("policy", tmp_path, "b", 1, resume=True)
    _trees_equal(a, b)


def test_pretrainer_rejects_wrong_tag(tmp_path):
    _, d = _pretrain("policy", tmp_path, "p", 1)
    os.rename(d / "policy.ckpt.trainstate", d / "reward.ckpt.trainstate")
    with pytest.raises(ValueError, match="not 'Reward Network-loss'"):
        _pretrain("reward", tmp_path, "p", 1, resume=True)


def test_completed_pretrainer_resume_is_a_noop(tmp_path, monkeypatch, capsys):
    done, _ = _pretrain("policy", tmp_path, "cp", 2)

    def must_not_run(*a, **k):
        raise AssertionError("a completed trainer must not build its steps")

    monkeypatch.setattr(tloops.steps, "make_policy_step", must_not_run)
    capsys.readouterr()
    again, _ = _pretrain("policy", tmp_path, "cp", 2, resume=True)
    assert "nothing to resume" in capsys.readouterr().out
    _trees_equal(done, again)


def test_snapshot_records_the_route_and_a_changed_route_is_reported(tmp_path, capsys):
    _, d = _pretrain("policy", tmp_path, "r", 1)
    path = str(d / "policy.ckpt.trainstate")
    tmpl = tpolicy.init(torch.Generator().manual_seed(0), CFG)
    state = tckpt.load_train_state(path, tmpl)
    assert state["meta"]["fused"] is False  # the CPU's plain steps
    opt = adam(1e-3, tmpl)
    tckpt.restore_train_state(state, tmpl, opt)
    tckpt.save_train_state(path, tmpl, opt, state["key"], dict(state["meta"], fused=True))
    capsys.readouterr()
    _pretrain("policy", tmp_path, "r", 2, resume=True)
    assert "NOT bit-identical" in capsys.readouterr().out


# ---- A2C ----


def _a2c_start(seed=0):
    params = {"value": tvalue.init(torch.Generator().manual_seed(seed), CFG),
              "policy": tpolicy.init(torch.Generator().manual_seed(seed + 1), CFG)}
    return params, treward.init(torch.Generator().manual_seed(seed + 2), CFG)


def _a2c(tmp_path, tag, epochs, resume=False, curriculum=None, chunk_steps=2):
    params, rparams = _a2c_start()
    d = tmp_path / tag
    d.mkdir(exist_ok=True)
    common = dict(plot_dir=str(d), save_paths=[str(d / "a2c.ckpt")], batch_size=8,
                  epochs=epochs, chunk_steps=chunk_steps,
                  train_state_path=str(d / "a2c.trainstate"), resume=resume)
    if curriculum is None:
        return tloops.a2c_training(DATA, params, rparams, adam(1e-3, params), CFG, seed=3,
                                   **common), d
    return tloops.a2c_curriculum_training(DATA, params, rparams, adam(1e-3, params), CFG,
                                          curriculum=curriculum, seed=4, **common), d


@pytest.mark.parametrize("chunk_steps", [1, 2], ids=["per_step", "chunked"])
def test_a2c_resume_bit_identical(chunk_steps, tmp_path):
    full, dfull = _a2c(tmp_path, "full", 3, chunk_steps=chunk_steps)
    _a2c(tmp_path, "split", 1, chunk_steps=chunk_steps)
    resumed, dsplit = _a2c(tmp_path, "split", 3, resume=True, chunk_steps=chunk_steps)
    _trees_equal(full, resumed)
    for name in ("metrics.jsonl", "a2c.ckpt", "a2c.trainstate"):
        assert (dsplit / name).read_bytes() == (dfull / name).read_bytes(), name


@pytest.mark.parametrize("interrupt_after", [1, 2, 3])
def test_curriculum_resume_bit_identical(interrupt_after, tmp_path, monkeypatch):
    """A [3, 6] x 2-epoch curriculum interrupted after 1 epoch (mid-level),
    2 (the level boundary) or 3 (mid second level), then resumed: equal to
    the uninterrupted run bit for bit."""
    levels = [3, 6]
    full, dfull = _a2c(tmp_path, "full", 2, curriculum=levels)
    real = tloops._drive_a2c_epoch
    calls = {"n": 0}

    def interrupting(**kw):
        # raise on entering the next epoch: its snapshot is not written
        if calls["n"] >= interrupt_after:
            raise KeyboardInterrupt
        calls["n"] += 1
        return real(**kw)

    monkeypatch.setattr(tloops, "_drive_a2c_epoch", interrupting)
    with pytest.raises(KeyboardInterrupt):
        _a2c(tmp_path, "split", 2, curriculum=levels)
    monkeypatch.undo()
    resumed, dsplit = _a2c(tmp_path, "split", 2, resume=True, curriculum=levels)
    _trees_equal(full, resumed)
    assert (dsplit / "a2c.trainstate").read_bytes() == (dfull / "a2c.trainstate").read_bytes()


def test_curriculum_rejects_mismatched_levels_and_plain_rejects_curriculum(tmp_path):
    _, d = _a2c(tmp_path, "c", 1, curriculum=[3, 6])
    params, rparams = _a2c_start()
    kw = dict(save_paths=[], batch_size=8, epochs=1, train_state_path=str(d / "a2c.trainstate"),
              resume=True)
    with pytest.raises(ValueError, match="curriculum .* does not match"):
        tloops.a2c_curriculum_training(DATA, params, rparams, adam(1e-3, params), CFG, None,
                                       curriculum=[4, 6], **kw)
    with pytest.raises(ValueError, match="cannot resume a plain"):
        tloops.a2c_training(DATA, params, rparams, adam(1e-3, params), CFG, None, **kw)


def test_completed_a2c_resume_is_a_noop(tmp_path, monkeypatch, capsys):
    done, d = _a2c(tmp_path, "done", 2)
    monkeypatch.setattr(tloops.steps, "make_a2c_step",
                        lambda *a, **k: (_ for _ in ()).throw(AssertionError("no step")))
    capsys.readouterr()
    again, _ = _a2c(tmp_path, "done", 2, resume=True)
    assert "nothing to resume" in capsys.readouterr().out
    _trees_equal(done, again)


def _orchestrated(tmp_path, epochs, resume=False, curriculum=None):
    paths = {f"{k}_network": str(tmp_path / f"{k}.ckpt")
             for k in ("reward", "policy", "value", "a2c")}
    for seed, kind in enumerate(("reward", "policy", "value")):
        if not os.path.exists(paths[f"{kind}_network"]):
            tckpt.save_network(kind, MODS[kind][0].init(torch.Generator().manual_seed(seed), CFG),
                               paths[f"{kind}_network"])
    saves = {"model_path": str(tmp_path / "model.ckpt"),
             "results_path": str(tmp_path / "results.txt")}
    params, _, _ = tloops.train_a2c_network(DATA, saves, paths, None, False, epochs=epochs,
                                            resume=resume, curriculum=curriculum,
                                            device="cpu", **KW)
    return params, paths


def test_train_a2c_network_resume_roundtrip(tmp_path, capsys):
    (tmp_path / "full").mkdir()
    (tmp_path / "split").mkdir()
    full, _ = _orchestrated(tmp_path / "full", 3)
    _orchestrated(tmp_path / "split", 1)
    capsys.readouterr()
    resumed, paths = _orchestrated(tmp_path / "split", 3, resume=True)
    assert "resumed full A2C train state (epoch 1 done)" in capsys.readouterr().out
    _trees_equal(full, resumed)
    assert ((tmp_path / "split" / "a2c.ckpt").read_bytes()
            == (tmp_path / "full" / "a2c.ckpt").read_bytes())


def test_train_a2c_network_weights_only_fallback(tmp_path, capsys):
    _, paths = _orchestrated(tmp_path, 1)
    os.remove(paths["a2c_network"] + ".trainstate")  # a checkpoint without a snapshot
    capsys.readouterr()
    _orchestrated(tmp_path, 1, resume=True)
    assert "resumed A2C weights from checkpoint" in capsys.readouterr().out


# ---- across the packages ----


def _jax_policy(tmp_path, tag, epochs, resume=False):
    d = tmp_path / tag
    d.mkdir(exist_ok=True)
    return jloops.train_policy_network(JDATA, {"policy_network": str(d / "policy.ckpt")},
                                       str(d), False, epochs=epochs, chunk_steps=2,
                                       fused_chain=False, resume=resume, **KW), d


def test_port_resumes_jax_policy_snapshot(tmp_path, monkeypatch):
    full, dfull = _jax_policy(tmp_path, "jfull", 2)
    _, dsplit = _jax_policy(tmp_path, "split", 1)
    resumed, _ = _pretrain("policy", tmp_path, "split", 2, resume=True)
    _close_to_jax(resumed, full)
    want, got = _log(dfull / "metrics.jsonl"), _log(dsplit / "metrics.jsonl")
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want], rtol=1e-4)


def test_jax_resumes_port_policy_snapshot(tmp_path):
    full, dfull = _pretrain("policy", tmp_path, "tfull", 2)
    _, dsplit = _pretrain("policy", tmp_path, "split", 1)
    resumed, _ = _jax_policy(tmp_path, "split", 2, resume=True)
    _close_to_jax(full, resumed)
    want, got = _log(dfull / "metrics.jsonl"), _log(dsplit / "metrics.jsonl")
    np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want], rtol=1e-4)


def _jax_start():
    return ({"value": jvalue.init(jax.random.PRNGKey(0), JCFG),
             "policy": jpolicy.init(jax.random.PRNGKey(1), JCFG)},
            jreward.init(jax.random.PRNGKey(2), JCFG))


def _jax_a2c(tmp_path, tag, epochs, resume=False):
    jp, jr = _jax_start()
    tx = joptim.adam(1e-3)
    d = tmp_path / tag
    d.mkdir(exist_ok=True)
    state_path = str(d / "a2c.trainstate")
    rs = jckpt.load_train_state(state_path, jp, tx.init(jp)) if resume else None
    out = jloops.a2c_training(JDATA, jp, jr, tx, tx.init(jp), JCFG, str(d),
                              [str(d / "a2c.ckpt")], batch_size=8, epochs=epochs, seed=3,
                              chunk_steps=2, fused_rollout=False, train_state_path=state_path,
                              resume_state=rs)
    return out, d


@pytest.mark.parametrize("direction", ["port_resumes_jax", "jax_resumes_port"])
def test_a2c_snapshot_across_packages(direction, tmp_path, monkeypatch):
    """Plain A2C from the same initial weights (the JAX initialisers'): one
    package's one-epoch snapshot resumed by the other to two epochs, against
    the other package's uninterrupted two epochs."""
    jp, jr = _jax_start()

    def start(seed=0):
        return (from_jax_params(jax.tree.map(np.array, jp)),
                from_jax_params(jax.tree.map(np.array, jr)))

    monkeypatch.setitem(globals(), "_a2c_start", start)
    if direction == "port_resumes_jax":
        full, dfull = _jax_a2c(tmp_path, "full", 2)
        _jax_a2c(tmp_path, "split", 1)
        resumed, dsplit = _a2c(tmp_path, "split", 2, resume=True)
        _close_to_jax(resumed, full)
    else:
        full, dfull = _a2c(tmp_path, "full", 2)
        _a2c(tmp_path, "split", 1)
        resumed, dsplit = _jax_a2c(tmp_path, "split", 2, resume=True)
        _close_to_jax(full, resumed)
    want, got = _log(dfull / "metrics.jsonl"), _log(dsplit / "metrics.jsonl")
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want], rtol=1e-4)


# ---- the CLI ----


def test_cli_resume(tmp_path, monkeypatch):
    """``--epochs 2`` against ``--epochs 1`` then ``--epochs 2 --resume``,
    each from the same sub-network checkpoints: the a2c checkpoint and the
    snapshot bit for bit."""
    tmain = importlib.import_module("image_captioning_through_rl_tpu_torch.cli.main")
    coco = make_synthetic_coco(str(tmp_path / "coco"), num_train_images=12, num_val_images=6,
                               captions_per_image=2, vocab_size=V, feature_dim=F, seed=11)
    models = tmp_path / "models"
    models.mkdir()
    for kind in ("reward", "policy", "value"):
        tckpt.save_network(kind, MODS[kind][0].init(torch.Generator().manual_seed(1), CFG),
                           str(models / f"{kind}Network.ckpt"))
    runs = {}
    for side, plan in (("full", [["--epochs", "2"]]),
                       ("split", [["--epochs", "1"], ["--epochs", "2", "--resume"]])):
        d = tmp_path / side
        shutil.copytree(models, d)
        monkeypatch.chdir(d)
        for extra in plan:
            tmain.main(tmain.parse_args_with_config(tmain.build_arg_parser(), [
                "--data_dir", coco, "--pretrained_path", ".", "--batch_size", "8",
                "--test_size", "20", "--hidden_dim", "16", "--wordvec_dim", "16",
                "--device", "cpu", *extra]))
        runs[side] = d
    for name in ("a2cNetwork.ckpt", "a2cNetwork.ckpt.trainstate"):
        assert (runs["split"] / name).read_bytes() == (runs["full"] / name).read_bytes(), name
