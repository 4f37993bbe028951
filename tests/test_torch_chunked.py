"""The port's chunked steps and chunked trainers (K minibatch updates per
host dispatch, the Q12 best-loss bookkeeping on the device) on the CPU.

Mirrors the JAX package's ``tests/test_chunked_pretrain.py`` case for case
where a case applies, with the port's own bound: on one device a chunk runs
the same arithmetic as its K single steps, so the port holds it **bit for
bit** (losses, final weights, ``best_prev`` = the weights entering the first
minibatch attaining the minimum), where the JAX package allows float noise
between its scan and its per-step jit. Beside that:

  * each chunked trainer (reward, policy, value, A2C plain and curriculum)
    against its own per-step run (``chunk_steps=1``), bit for bit: the
    JSONL scalars, the Q12 checkpoint's bytes and the final weights, over
    two epochs with a ragged tail;
  * each chunked trainer against the JAX package's chunked trainer on the
    same seed and initial weights: losses rtol 1e-4, weights atol 2e-5 (the
    bounds of ``tests/test_torch_trainers.py``), the Q12 checkpoint taken
    at the same minibatch;
  * the one-epoch chunked A2C run's stats are finite (tier 1); the slow
    tier holds that its mean reward rises over a few epochs.
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
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.data.coco import CocoData, caption_lengths
from image_captioning_through_rl_tpu_torch.models import policy as tpolicy
from image_captioning_through_rl_tpu_torch.models import reward as treward
from image_captioning_through_rl_tpu_torch.models import value as tvalue
from image_captioning_through_rl_tpu_torch.models.convert import from_jax_params
from image_captioning_through_rl_tpu_torch.train import checkpoint as tckpt
from image_captioning_through_rl_tpu_torch.train import loops as tloops
from image_captioning_through_rl_tpu_torch.train import steps as tsteps
from image_captioning_through_rl_tpu_torch.train.guard import TrainingDiverged
from image_captioning_through_rl_tpu_torch.train.optim import adam

torch.set_num_threads(1)

CFG = NetConfig(vocab_size=29, input_dim=12, wordvec_dim=10, hidden_dim=12, max_seq_len=8)
K = 5
V, F, T = 40, 16, 9
DIMS = {"wordvec_dim": 16, "hidden_dim": 16}
SEED = 3
# 26 captions at batch 8 with chunks of 2: a chunk of 2, one of 1, a ragged tail of 2
KW = dict(epochs=2, batch_size=8, seed=SEED, net_dims=DIMS)
MODS = {"reward": (treward, jreward, 0), "policy": (tpolicy, jpolicy, 1),
        "value": (tvalue, jvalue, 2)}


def _minibatches(rng, k, n, cfg=CFG):
    feats = rng.standard_normal((k, n, cfg.input_dim)).astype(np.float32)
    caps = rng.integers(4, cfg.vocab_size, size=(k, n, cfg.max_seq_len))
    caps[:, :, 0] = 1
    caps[:, :, -1] = 2
    return torch.from_numpy(feats), torch.from_numpy(caps)


def _leaves(tree):
    return [leaf for k in sorted(tree)
            for leaf in (_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def _trees_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert torch.equal(x.detach(), y.detach())


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone() for k, v in tree.items()}


def _init(kind, seed):
    return {"reward": treward, "policy": tpolicy, "value": tvalue}[kind].init(
        torch.Generator().manual_seed(seed), CFG)


@pytest.mark.parametrize("kind, fused", [("reward", False), ("reward", True),
                                         ("policy", False), ("policy", True),
                                         ("value", False), ("value", True)])
def test_chunk_matches_per_step(kind, fused):
    """K single steps and one chunk of K from the same weights: the same
    losses, weights and Adam state bit for bit, and ``best_prev`` the weights
    entering the first minibatch attaining the minimum loss. ``fused=True``
    runs the kernels' plain versions (CPU tensors)."""
    feats, caps = _minibatches(np.random.default_rng(0), K, 6)
    prefix_lens = [1, 5, 3, 7, 2]
    frozen = {}
    if kind == "value":
        frozen = {"pparams": _init("policy", 3), "rparams": _init("reward", 4)}
    params_a, params_b = _init(kind, 1), _init(kind, 1)
    opt_a, opt_b = adam(1e-3, params_a), adam(1e-3, params_b)
    if kind == "value":
        step = tsteps.make_value_step(CFG, opt_a, frozen["pparams"], frozen["rparams"],
                                      fused=fused)
        chunk = tsteps.make_value_chunk_step(CFG, opt_b, params_b, **frozen, fused=fused)
        extras = [(p,) for p in prefix_lens]
    else:
        step = getattr(tsteps, f"make_{kind}_step")(CFG, opt_a, fused=fused)
        chunk = getattr(tsteps, f"make_{kind}_chunk_step")(CFG, opt_b, params_b, fused=fused)
        extras = None
    losses, entering = [], []
    for j in range(K):
        entering.append(_clone(params_a))
        args = (params_a, feats[j], caps[j]) + (extras[j] if extras else ())
        losses.append(step(*args))
    closs, best_prev, best, improved = chunk(float("inf"), feats, caps, extras)
    assert torch.equal(closs, torch.stack(losses))
    _trees_equal(params_a, params_b)
    for pa, pb in zip(_leaves(params_a), _leaves(params_b)):
        sa, sb = opt_a.state[pa], opt_b.state[pb]
        assert all(torch.equal(sa[n], sb[n]) for n in ("step", "exp_avg", "exp_avg_sq"))
    assert bool(improved) and float(best) == float(closs.min())
    _trees_equal(best_prev, entering[int(torch.argmin(closs))])


def test_embedding_grad_onehot_matches_index_add():
    """The card's embedding gradient (a one-hot product, fixed-order sums,
    capturable) and ``index_add_`` (the CPU's) against the float64 sums,
    Zipf-like tokens with a heavy head: each entry within 1e-6 of its row's
    sum of magnitudes (float32 sums in two orders)."""
    from image_captioning_through_rl_tpu_torch.ops.fused_lstm import (embedding_grad,
                                                                      embedding_grad_onehot)

    gen = torch.Generator().manual_seed(0)
    dx = torch.randn(17 * 64, 24, generator=gen)
    tok = (torch.rand((17, 64), generator=gen) ** 4 * 40).long()  # token 0 ~ 40% of rows
    exact = torch.zeros(40, 24, dtype=torch.float64).index_add_(0, tok.reshape(-1), dx.double())
    bound = 1e-6 * torch.zeros(40, 24, dtype=torch.float64).index_add_(
        0, tok.reshape(-1), dx.double().abs()) + 1e-7
    got = embedding_grad_onehot(dx, tok, 40)
    for value in (got, embedding_grad(dx, tok, 40)):
        assert bool(((value.double() - exact).abs() <= bound).all())
    assert torch.equal(got, embedding_grad_onehot(dx, tok, 40))


def test_chunk_no_improvement_flag():
    params = _init("reward", 1)
    feats, caps = _minibatches(np.random.default_rng(1), 3, 6)
    chunk = tsteps.make_reward_chunk_step(CFG, adam(1e-4, params), params)
    closs, _, best, improved = chunk(-1.0, feats, caps)
    assert not bool(improved)
    assert float(best) == -1.0  # untouched: every loss >= the bar
    assert closs.shape == (3,) and bool(torch.isfinite(closs).all())


def test_chunk_step_refusals():
    bidi = NetConfig(vocab_size=29, input_dim=12, wordvec_dim=10, hidden_dim=12,
                     bidirectional=True)
    params = tpolicy.init(torch.Generator().manual_seed(0), bidi)
    for make in (tsteps.make_reward_chunk_step, tsteps.make_policy_chunk_step):
        with pytest.raises(ValueError, match="unidirectional"):
            make(bidi, adam(1e-3, params), params)
    params = _init("policy", 0)
    with pytest.raises(ValueError, match="CUDA"):
        tsteps.make_policy_chunk_step(CFG, adam(1e-3, params), params, graph=True)


# ---- the trainers ----


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


def _log(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _frozen_nets(tmp_path, jcfg, kinds=("reward", "policy")):
    paths = {}
    for kind, key in zip(kinds, (5, 6, 7)):
        path = str(tmp_path / f"{kind}Network.pt")
        jckpt.save_network_pt(kind, MODS[kind][1].init(jax.random.PRNGKey(key), jcfg), path)
        paths[f"{kind}_network"] = path
    return paths


@pytest.mark.parametrize("kind", ["reward", "policy", "value"])
def test_pretrainer_chunked_matches_per_step_and_jax(kind, tmp_path, monkeypatch):
    fields = _fields()
    jdata, tdata = JCocoData(**fields), CocoData(**fields)
    jcfg = jloops._cfg_for(jdata, False, DIMS)
    tmod, jmod, offset = MODS[kind]
    jinit = jmod.init(jax.random.PRNGKey(SEED + offset), jcfg)
    monkeypatch.setattr(tmod, "init", lambda gen, cfg, emb=None: from_jax_params(
        jax.tree.map(np.asarray, jinit)))
    frozen = _frozen_nets(tmp_path, jcfg) if kind == "value" else {}
    runs = {}
    for side in ("j", "chunked", "per_step"):
        (tmp_path / side).mkdir()
        paths = dict(frozen, **{f"{kind}_network": str(tmp_path / side / f"{kind}Network.ckpt")})
        if side == "j":
            extra = {} if kind == "value" else {"fused_chain": False}
            jparams = getattr(jloops, f"train_{kind}_network")(
                jdata, paths, str(tmp_path / side), False, chunk_steps=2, **extra, **KW)
        else:
            runs[side] = getattr(tloops, f"train_{kind}_network")(
                tdata, paths, str(tmp_path / side), False, device="cpu",
                chunk_steps=2 if side == "chunked" else 1, **KW)

    chunked, per_step = (_log(tmp_path / s / "metrics.jsonl") for s in ("chunked", "per_step"))
    assert chunked == per_step and len(chunked) == 2 * 4  # bit-equal values, tags and steps
    ckpt_name = f"{kind}Network.ckpt"
    assert ((tmp_path / "chunked" / ckpt_name).read_bytes()
            == (tmp_path / "per_step" / ckpt_name).read_bytes())
    _trees_equal(runs["chunked"], runs["per_step"])

    want = _log(tmp_path / "j" / "metrics.jsonl")
    assert [(r["tag"], r["step"]) for r in chunked] == [(r["tag"], r["step"]) for r in want]
    np.testing.assert_allclose([r["value"] for r in chunked], [r["value"] for r in want],
                               rtol=1e-4)
    saved_j = jckpt.load_network(kind, str(tmp_path / "j" / ckpt_name), template=jparams)
    saved_t = jckpt.load_network(kind, str(tmp_path / "chunked" / ckpt_name), template=jparams)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(saved_j),
                            jax.tree.leaves(saved_t)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))


def _a2c_nets(tmp_path, jcfg):
    return _frozen_nets(tmp_path, jcfg, ("reward", "policy", "value"))


@pytest.mark.parametrize("curriculum", [None, [4]], ids=["plain", "curriculum"])
def test_a2c_chunked_matches_per_step_and_jax(curriculum, tmp_path):
    """A2C chunked (K = 2, a ragged tail) against its per-step run, bit for
    bit, and against the JAX chunked trainer. The curriculum's appended
    level 16 skips every minibatch (T = 9): keys are drawn, nothing logged."""
    fields = _fields()
    jdata, tdata = JCocoData(**fields), CocoData(**fields)
    jcfg = jloops._cfg_for(jdata, False, DIMS)
    nets = _a2c_nets(tmp_path, jcfg)
    out = {}
    for side in ("j", "chunked", "per_step"):
        d = tmp_path / side
        d.mkdir()
        paths = dict(nets, a2c_network=str(d / "a2cNetwork.ckpt"))
        saves = {"model_path": str(d / "model.ckpt"), "results_path": str(d / "results.txt")}
        kw = dict(KW, curriculum=curriculum)
        if side == "j":
            out[side], _, _ = jloops.train_a2c_network(jdata, saves, paths, str(d), False,
                                                      fused_rollout=False, chunk_steps=2, **kw)
        else:
            out[side], _, _ = tloops.train_a2c_network(
                tdata, saves, paths, str(d), False, fused_rollout=False, device="cpu",
                chunk_steps=2 if side == "chunked" else 1, **kw)
    chunked, per_step = (_log(tmp_path / s / "metrics.jsonl") for s in ("chunked", "per_step"))
    assert chunked == per_step and chunked
    for name in ("a2cNetwork.ckpt", "model.ckpt", "a2cNetwork.ckpt.trainstate"):
        assert ((tmp_path / "chunked" / name).read_bytes()
                == (tmp_path / "per_step" / name).read_bytes()), name
    _trees_equal(out["chunked"], out["per_step"])

    want = _log(tmp_path / "j" / "metrics.jsonl")
    assert [(r["tag"], r["step"]) for r in chunked] == [(r["tag"], r["step"]) for r in want]
    np.testing.assert_allclose([r["value"] for r in chunked], [r["value"] for r in want],
                               rtol=1e-4)
    for (key, a), b in zip(jax.tree_util.tree_leaves_with_path(out["j"]),
                           jax.tree.leaves(tckpt._numpy(out["chunked"]))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(key))


def _a2c_run(tmp_path, epochs, tag):
    """A chunked A2C run of ``epochs`` on a synthetic bundle of 64 captions
    (eight minibatches of 8, two chunks of 4): its per-epoch mean rewards."""
    fields = _fields(seed=1, n_img=16, n_cap=64)
    data = CocoData(**fields)
    cfg = tloops._cfg_for(data, False, DIMS)
    params = {kind: mod.init(torch.Generator().manual_seed(i), cfg)
              for i, (kind, mod) in enumerate((("value", tvalue), ("policy", tpolicy)))}
    rparams = treward.init(torch.Generator().manual_seed(9), cfg)
    d = tmp_path / tag
    tloops.a2c_training(data, params, rparams, adam(1e-3, params), cfg, str(d),
                        [str(d / "a2c.ckpt")], batch_size=8, epochs=epochs, seed=2,
                        chunk_steps=4, fused_rollout=False)
    rows = [r for r in _log(d / "metrics.jsonl") if r["tag"].endswith("mean-rewards")]
    return [np.mean([r["value"] for r in rows if r["step"] // 8 == e]) for e in range(epochs)], \
        _log(d / "metrics.jsonl")


def test_chunked_a2c_one_epoch_stats_finite(tmp_path):
    rewards, log = _a2c_run(tmp_path, 1, "one")
    assert len(log) == 8 * 3 and all(np.isfinite(r["value"]) for r in log)
    assert np.isfinite(rewards[0])


@pytest.mark.slow
def test_chunked_a2c_mean_reward_rises(tmp_path):
    """Over eight epochs the chunked A2C run raises its mean reward: the
    last two epochs' mean above the first two's."""
    rewards, _ = _a2c_run(tmp_path, 8, "eight")
    assert np.mean(rewards[-2:]) > np.mean(rewards[:2]), rewards


def test_chunked_walk_is_the_default(tmp_path, monkeypatch):
    """The trainers chunk by default (``chunk_steps=16``, ``device_data``):
    the chunk step runs and the per-step walk's clone of the weights does
    not, except for the ragged tail."""
    calls = {"chunk": 0, "clone": 0}
    real_call, real_clone = tsteps.BestLossChunk.__call__, tloops._clone

    def counting_call(self, *a, **k):
        calls["chunk"] += 1
        return real_call(self, *a, **k)

    def counting_clone(tree):
        calls["clone"] += "lstm" in tree  # the whole tree, not its nested calls
        return real_clone(tree)

    monkeypatch.setattr(tsteps.BestLossChunk, "__call__", counting_call)
    monkeypatch.setattr(tloops, "_clone", counting_clone)
    data = CocoData(**_fields())
    tloops.train_policy_network(data, {"policy_network": str(tmp_path / "p.ckpt")}, None,
                                False, device="cpu", **KW)
    assert calls == {"chunk": 2, "clone": 2}  # per epoch: a chunk of 3, a tail of 2 rows
    calls.update(chunk=0, clone=0)
    tloops.train_policy_network(data, {"policy_network": str(tmp_path / "q.ckpt")}, None,
                                False, device="cpu", device_data=False, **KW)
    assert calls == {"chunk": 0, "clone": 8}


def test_divergence_guard_dumps_the_post_chunk_tree(tmp_path, monkeypatch):
    """A non-finite loss inside a chunk halts the run at its minibatch and
    dumps the post-chunk weights next to the checkpoint, as the JAX
    package's chunked walk does."""
    real = tsteps.policy_loss

    def nan_third(params, cfg, f, c, lens, calls=[0]):
        calls[0] += 1
        loss = real(params, cfg, f, c, lens)
        return loss * float("nan") if calls[0] == 3 else loss

    monkeypatch.setattr(tsteps, "policy_loss", nan_third)
    data = CocoData(**_fields())
    path = tmp_path / "p.ckpt"
    with pytest.raises(TrainingDiverged, match="minibatch 2"):
        tloops.train_policy_network(data, {"policy_network": str(path)}, None, False,
                                    device="cpu", fused_chain=False, **KW)
    dumped = tckpt.load_pytree(str(path) + ".diverged")
    assert sorted(dumped) == ["cnn2linear", "embedding", "head", "lstm"]
    assert not (tmp_path / "p.ckpt.trainstate").exists()  # no epoch finished
