"""Bidirectional networks: the port against the JAX package, on the CPU.

Small widths (V = 25, F = 12, E = 14, H = 16 per direction, T = 7, as
``tests/test_bidirectional.py``); weights from the JAX initialisers carried
across with ``from_jax_params``, inputs from a seeded numpy generator, the
JAX side at ``precision="highest"``. Held:

  * ``bilstm_scan`` and the reversed GRU scan: hs and finals to 1e-5;
  * the three networks' ``forward`` and ``encode`` to 1e-5, and the stepped
    states (policy, critic) against the batched forward's last position;
  * ``.pt`` files both ways (the JAX ``to_torch_state_dict(...,
    bidirectional=True)``), a ``.ckpt`` byte-equal to flax's for the same
    tree, and a state dict whose ``_reverse`` keys disagree with the flag
    raising;
  * greedy, beam-5 and sampled tokens (top-k and nucleus, one key) equal to
    the JAX decodes and to the port's full-prefix oracles, exactly;
  * the reward, policy and value losses and gradients, and
    ``a2c_rollout_loss_full`` (loss, stats, gradients, sampled actions),
    to the tolerances of ``test_torch_steps.py`` and
    ``test_torch_rollout.py`` (loss rtol 1e-5, gradients rtol 1e-4, atol
    1e-6); three Adam steps of each step builder to rtol 1e-5 (losses) and
    atol 2e-5 (weights);
  * one epoch of each trainer (reward, policy, value, A2C plain) against
    the JAX trainers: the JSONL losses to rtol 1e-4 and the checkpoints to
    atol 2e-5, as ``test_torch_trainers.py``;
  * ``test_a2c_network``'s dumps byte-identical to the JAX one's;
  * the ``Captioner`` against the JAX ``Captioner``: greedy, beam-5 and
    sampled tokens equal;
  * ``use_fused_kernel=True``, ``fused_chain=True`` and ``fused_rollout=True``
    raising ``ValueError`` for a bidirectional config, and auto mode running
    the plain steps on the device it was given.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import api as japi
from image_captioning_through_rl_tpu import config as jconfig
from image_captioning_through_rl_tpu.data.coco import CocoData as JCocoData
from image_captioning_through_rl_tpu.decode import beam_search as jbeam
from image_captioning_through_rl_tpu.decode import greedy_decode as jgreedy
from image_captioning_through_rl_tpu.decode import sample_decode as jsample
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu.models import policy as jpolicy
from image_captioning_through_rl_tpu.models import reward as jreward
from image_captioning_through_rl_tpu.models import value as jvalue
from image_captioning_through_rl_tpu.models.convert import to_torch_state_dict
from image_captioning_through_rl_tpu.ops import reward_ops as jreward_ops
from image_captioning_through_rl_tpu.ops import rnn as jrnn
from image_captioning_through_rl_tpu.train import checkpoint as jckpt
from image_captioning_through_rl_tpu.train import loops as jloops
from image_captioning_through_rl_tpu.train import optim as joptim
from image_captioning_through_rl_tpu.train import steps as jsteps
from image_captioning_through_rl_tpu_torch import api as tapi
from image_captioning_through_rl_tpu_torch import config as tconfig
from image_captioning_through_rl_tpu_torch.data.coco import CocoData, caption_lengths
from image_captioning_through_rl_tpu_torch.decode import (
    beam_search,
    beam_search_full_prefix,
    greedy_decode,
    greedy_decode_full_prefix,
    sample_decode,
    sample_decode_full_prefix,
)
from image_captioning_through_rl_tpu_torch.models import (
    from_jax_params,
    network_from_state_dict,
    network_to_state_dict,
    policy,
    reward,
    value,
)
from image_captioning_through_rl_tpu_torch.models import a2c as ta2c
from image_captioning_through_rl_tpu_torch.ops import prng, rnn
from image_captioning_through_rl_tpu_torch.train import checkpoint as tckpt
from image_captioning_through_rl_tpu_torch.train import loops as tloops
from image_captioning_through_rl_tpu_torch.train import steps as tsteps
from image_captioning_through_rl_tpu_torch.train.optim import adam

torch.set_num_threads(1)

V, F, E, H, T = 25, 12, 14, 16, 7
KW = dict(vocab_size=V, input_dim=F, wordvec_dim=E, hidden_dim=H, max_seq_len=T,
          bidirectional=True)
JCFG = jconfig.NetConfig(precision="highest", **KW)
TCFG = tconfig.NetConfig(**KW)
N = 9
TOL = dict(atol=1e-5, rtol=1e-5)
JMODS = {"policy": jpolicy, "value": jvalue, "reward": jreward, "a2c": ja2c}
WORDS = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(4, V)]


def _jax_tree(kind, key=0):
    return JMODS[kind].init(jax.random.PRNGKey(key), JCFG)


def _pair(kind, key=0):
    jp = _jax_tree(kind, key)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _batch(seed, n=N):
    """<START> w* <END> <NULL>* captions of length T and features."""
    rng = np.random.default_rng(seed)
    caps = rng.integers(4, V, size=(n, T)).astype(np.int32)
    caps[:, 0] = 1
    lens = rng.integers(3, T + 1, size=n)
    caps[np.arange(n), lens - 1] = 2
    caps[np.arange(T)[None, :] >= lens[:, None]] = 0
    return rng.standard_normal((n, F)).astype(np.float32), caps


def _named(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x))
    return t if dtype is None else t.to(dtype)


# --------------------------------------------------------------------------
# scans and networks
# --------------------------------------------------------------------------

def test_bilstm_scan_and_reversed_gru_scan_match_jax():
    k = jax.random.split(jax.random.PRNGKey(0), 3)
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((T, N, E)).astype(np.float32)
    init = [rng.standard_normal((N, H)).astype(np.float32) for _ in range(4)]
    jp = {"f": jax.tree.map(np.asarray, jpolicy.lstm_init(k[0], E, H)),
          "b": jax.tree.map(np.asarray, jpolicy.lstm_init(k[1], E, H)),
          "g": jax.tree.map(np.asarray, jreward.gru_init(k[2], E, H))}
    tp = from_jax_params(jp)
    jhs, (jff, jfb) = jrnn.bilstm_scan(jp["f"], jp["b"], xs, tuple(init[:2]), tuple(init[2:]),
                                       precision="highest")
    ths, (tff, tfb) = rnn.bilstm_scan(tp["f"], tp["b"], _t(xs), tuple(map(_t, init[:2])),
                                      tuple(map(_t, init[2:])))
    assert ths.shape == (T, N, 2 * H)
    _close(ths, jhs)
    for a, b in zip(tff + tfb, jff + jfb):
        _close(a, b)
    for reverse in (False, True):
        jhs, jh = jrnn.gru_scan(jp["g"], xs, init[0], precision="highest", reverse=reverse)
        ths, th = rnn.gru_scan(tp["g"], _t(xs), _t(init[0]), reverse=reverse)
        _close(ths, jhs)
        _close(th, jh)
    # the reversed scan's hs[0] is its final state
    _close(ths[0], th)


def test_networks_forward_and_encode_match_jax():
    feats, caps = _batch(1)
    (jp, tp), (jv, tv), (jr, tr) = _pair("policy", 1), _pair("value", 2), _pair("reward", 3)
    f, c = _t(feats), _t(caps, torch.long)
    _close(policy.forward(tp, TCFG, f, c), jpolicy.forward(jp, JCFG, feats, caps))
    _close(value.encode(tv, TCFG, c), jvalue.encode(jv, JCFG, caps))
    _close(value.forward(tv, TCFG, f, c), jvalue.forward(jv, JCFG, feats, caps))
    _close(reward.encode(tr, TCFG, c), jreward.encode(jr, JCFG, caps))
    for a, b in zip(reward.forward(tr, TCFG, f, c), jreward.forward(jr, JCFG, feats, caps)):
        _close(a, b)
    _close(reward.get_rewards(tr, TCFG, f, c), jreward.get_rewards(jr, JCFG, feats, caps))
    with pytest.raises(ValueError, match="unidirectional"):
        reward.rnn_step(tr, TCFG, c[:, 0], reward.zero_rnn_state(TCFG, N))


def test_stepped_states_match_the_batched_forward():
    """Policy and critic stepped token by token equal the batched forward
    of each prefix at its last position (and the JAX step's values)."""
    feats, caps = _batch(2)
    (jp, tp), (jv, tv) = _pair("policy", 4), _pair("value", 5)
    f, c = _t(feats), _t(caps, torch.long)
    state = policy.init_decode_state(tp, TCFG, f)
    jstate = jpolicy.init_decode_state(jp, JCFG, feats)
    vstate = value.zero_rnn_state(TCFG, N)
    for t in range(T):
        logits, state = policy.step(tp, TCFG, c[:, t], state)
        jlogits, jstate = jpolicy.step(jp, JCFG, caps[:, t], jstate)
        _close(logits, jlogits)
        _close(logits, policy.forward(tp, TCFG, f, c[:, :t + 1])[:, -1])
        vstate = value.rnn_step(tv, TCFG, c[:, t], vstate)
        _close(value.value_from_state(tv, TCFG, f, vstate),
               value.forward(tv, TCFG, f, c[:, :t + 1]))
    # the beam's leading shape [N, B, B, E]
    x = tv["embedding"][c[:, :4].reshape(N, 2, 2)]
    z = torch.zeros((N, 2, 2, H))
    (hf, cf), hb = value.rnn_step_emb(tv, TCFG, x, ((z, z), z))
    assert hf.shape == cf.shape == hb.shape == (N, 2, 2, H)


# --------------------------------------------------------------------------
# weight interchange
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["policy", "value", "reward", "a2c"])
def test_pt_round_trip_both_ways(kind, tmp_path):
    jp = jax.tree.map(np.asarray, _jax_tree(kind, 6))
    jsd = to_torch_state_dict(kind, jp, bidirectional=True)
    assert any(k.endswith("_reverse") for k in jsd)
    tp = network_from_state_dict(kind, {k: torch.from_numpy(np.array(v))
                                        for k, v in jsd.items()}, bidirectional=True)
    for name, leaf in _named(from_jax_params(jp)):
        assert torch.equal(dict(_named(tp))[name], leaf), name
    tsd = network_to_state_dict(kind, tp, bidirectional=True)
    assert sorted(tsd) == sorted(jsd)
    for k, v in jsd.items():
        np.testing.assert_array_equal(tsd[k].numpy(), v, err_msg=k)
    # the files: the port's .pt read by the JAX package, the JAX .pt by the port
    tckpt.save_network(kind, tp, str(tmp_path / "t.pt"))
    back = jckpt.load_network(kind, str(tmp_path / "t.pt"), bidirectional=True)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))
    jckpt.save_network_pt(kind, jp, str(tmp_path / "j.pt"), bidirectional=True)
    cfg = dataclasses.replace(TCFG, max_seq_len=17)
    port = tckpt.load_network(kind, str(tmp_path / "j.pt"), "cpu", cfg)
    for name, leaf in _named(from_jax_params(jp)):
        assert torch.equal(dict(_named(port))[name], leaf), name
    # without a config the file's _reverse keys give the direction; a
    # unidirectional config disagrees with them and raises
    bare = tckpt.load_network(kind, str(tmp_path / "j.pt"), "cpu")
    for name, leaf in _named(port):
        assert torch.equal(dict(_named(bare))[name], leaf), name
    with pytest.raises(ValueError, match="bidirectional=True"):
        tckpt.load_network(kind, str(tmp_path / "j.pt"), "cpu",
                           dataclasses.replace(cfg, bidirectional=False))
    uni = to_torch_state_dict(kind, jax.tree.map(
        np.asarray, JMODS[kind].init(jax.random.PRNGKey(0),
                                     dataclasses.replace(JCFG, bidirectional=False))))
    with pytest.raises(ValueError, match="no _reverse"):
        network_from_state_dict(kind, uni, bidirectional=True)


@pytest.mark.parametrize("kind", ["policy", "value", "reward", "a2c"])
def test_ckpt_bytes_equal_flax_and_read_both_ways(kind, tmp_path):
    jp = jax.tree.map(np.asarray, _jax_tree(kind, 7))
    jckpt.save_pytree(jp, str(tmp_path / "j.ckpt"))
    tckpt.save_network(kind, from_jax_params(jp), str(tmp_path / "t.ckpt"))
    assert (tmp_path / "t.ckpt").read_bytes() == (tmp_path / "j.ckpt").read_bytes()
    port = tckpt.load_network(kind, str(tmp_path / "j.ckpt"), "cpu", TCFG)
    bare = tckpt.load_network(kind, str(tmp_path / "j.ckpt"), "cpu")  # keys alone agree
    for name, leaf in _named(from_jax_params(jp)):
        assert torch.equal(dict(_named(port))[name], leaf), name
        assert torch.equal(dict(_named(bare))[name], leaf), name
    # a bidirectional tree is not a unidirectional network
    with pytest.raises(ValueError, match="j.ckpt: "):
        tckpt.load_network(kind, str(tmp_path / "j.ckpt"), "cpu",
                           dataclasses.replace(TCFG, bidirectional=False))


# --------------------------------------------------------------------------
# decodes
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def a2c_pair():
    return _pair("a2c", 8)


def test_greedy_and_beam_match_jax_and_the_full_prefix_oracles(a2c_pair):
    jp, tp = a2c_pair
    feats, _ = _batch(3)
    start = np.ones(N, np.int32)
    f, s = _t(feats), _t(start)
    g = greedy_decode(tp["policy"], TCFG, f, s)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jgreedy(jp["policy"], JCFG, feats, start)))
    assert torch.equal(g, greedy_decode_full_prefix(tp["policy"], TCFG, f, s))
    jd, td = jconfig.DecodeConfig(beam_size=5, max_seq_len=T), tconfig.DecodeConfig(
        beam_size=5, max_seq_len=T)
    toks, scores = beam_search(tp["policy"], tp["value"], TCFG, td, f, s)
    jtoks, jscores = jbeam(jp["policy"], jp["value"], JCFG, jd, feats, start)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    _close(scores, jscores, rtol=1e-5, atol=1e-5)
    ftoks, fscores = beam_search_full_prefix(tp["policy"], tp["value"], TCFG, td, f, s)
    assert torch.equal(toks, ftoks)
    _close(scores, fscores, rtol=1e-5, atol=1e-5)


def test_full_prefix_oracles_report_their_margins(a2c_pair):
    """``margins=True`` leaves the oracles' tokens and scores as they were
    and adds per step the gap to a tie: the greedy top-2 logit gap, and for
    the beam the smaller of the top-B cut's gap and the candidate scores'."""
    _, tp = a2c_pair
    feats, _ = _batch(10)
    f, s = _t(feats), torch.ones(N, dtype=torch.int32)
    toks, gaps = greedy_decode_full_prefix(tp["policy"], TCFG, f, s, margins=True)
    assert torch.equal(toks, greedy_decode_full_prefix(tp["policy"], TCFG, f, s))
    for t in range(T - 1):  # each step's logits read the prefix alone
        logits = policy.forward(tp["policy"], TCFG, f, toks[:, :t + 1].long())[:, -1]
        top2 = torch.topk(logits, 2, dim=-1).values
        assert torch.equal(gaps[:, t], top2[:, 0] - top2[:, 1])
    for b in (1, 3):
        td = tconfig.DecodeConfig(beam_size=b, max_seq_len=T)
        btoks, scores, margins = beam_search_full_prefix(tp["policy"], tp["value"], TCFG, td,
                                                         f, s, margins=True)
        plain = beam_search_full_prefix(tp["policy"], tp["value"], TCFG, td, f, s)
        assert torch.equal(btoks, plain[0]) and torch.equal(scores, plain[1])
        assert margins.shape == (N, T - 1) and bool((margins >= 0).all())


@pytest.mark.parametrize("filters", [dict(top_k=5), dict(top_p=0.8), dict(top_k=6, top_p=0.9)],
                         ids=["top_k", "nucleus", "both"])
def test_sampling_matches_jax_and_the_full_prefix_oracle(a2c_pair, filters):
    jp, tp = a2c_pair
    feats, _ = _batch(4)
    start = np.ones(N, np.int32)
    kw = dict(temperature=0.9, **filters)
    got = sample_decode(tp["policy"], TCFG, _t(feats), _t(start), prng.PRNGKey(11), **kw)
    want = jsample(jp["policy"], JCFG, feats, start, jax.random.PRNGKey(11), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, sample_decode_full_prefix(tp["policy"], TCFG, _t(feats), _t(start),
                                                      prng.PRNGKey(11), **kw))


def test_captioner_matches_jax_captioner(a2c_pair):
    jp, tp = a2c_pair
    idx_to_word = dict(enumerate(WORDS))
    jcap = japi.Captioner(jp, JCFG, idx_to_word)
    tcap = tapi.Captioner(tp, TCFG, idx_to_word, device="cpu")
    feats, _ = _batch(5)
    for beam in (0, 5):
        np.testing.assert_array_equal(tcap.caption_tokens(feats, beam_size=beam),
                                      jcap.caption_tokens(feats, beam_size=beam))
    for r, kw in ((1, dict(top_k=5)), (3, dict(top_p=0.8, temperature=0.7))):
        np.testing.assert_array_equal(
            tcap.sample_tokens(feats, num_samples=r, seed=3, **kw),
            jcap.sample_tokens(feats, num_samples=r, seed=3, **kw))


# --------------------------------------------------------------------------
# steps
# --------------------------------------------------------------------------

def _port_grads(tree, loss_fn):
    names, leaves = zip(*_named(tree))
    for leaf in leaves:
        leaf.requires_grad_()
    out = loss_fn(tree)
    loss = out[0] if isinstance(out, tuple) else out
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    return out, grads


def _check_grads(got, want):
    want = dict(_named(want))
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def _jax_value_loss(vp, pp, rp, feats, caps, prefix_len):
    """The loss of the JAX package's bidirectional value step
    (``steps.py:352-373``)."""
    gen = jgreedy(pp, JCFG, feats, caps[:, 0])
    ve, se = jreward.forward(rp, JCFG, feats, gen)
    rewards = jax.lax.stop_gradient(jreward_ops.cosine_embedding_reward(ve, se)[:, None])
    values = jvalue.forward(vp, JCFG, feats, gen[:, :prefix_len])
    return jnp.mean(jnp.square(values - rewards))


@pytest.mark.parametrize("kind", ["reward", "policy", "value"])
def test_pretraining_losses_and_gradients_match_jax(kind):
    feats, caps = _batch(6)
    f, c = _t(feats), _t(caps, torch.long)
    jp, tp = _pair(kind, 9)
    if kind == "reward":
        jloss, jgrads = jax.value_and_grad(jsteps.reward_loss)(jp, JCFG, feats, caps)
        loss, grads = _port_grads(tp, lambda p: tsteps.reward_loss(p, TCFG, f, c))
    elif kind == "policy":
        lens = np.asarray(jsteps.batch_caption_lens(jnp.asarray(caps)))
        jloss, jgrads = jax.value_and_grad(jsteps.policy_loss)(jp, JCFG, feats, caps, lens)
        loss, grads = _port_grads(tp, lambda p: tsteps.policy_loss(p, TCFG, f, c, _t(lens)))
    else:
        (jpp, tpp), (jr, tr) = _pair("policy", 10), _pair("reward", 11)
        jloss, jgrads = jax.value_and_grad(_jax_value_loss)(jp, jpp, jr, feats, caps, 4)
        loss, grads = _port_grads(tp, lambda p: tsteps.value_episode_loss(
            p, TCFG, tpp, tr, f, c, 4))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _check_grads(grads, jgrads)


@pytest.mark.parametrize("curr,per_step_mean", [(1, False), (3, True)])
def test_full_prefix_rollout_loss_matches_jax(curr, per_step_mean):
    """``a2c_rollout_loss_full`` against the JAX one (jitted, as its step
    runs it): the loss, every stat and every gradient."""
    feats, caps = _batch(7)
    caplen = int(np.max(np.asarray(jsteps.batch_caption_lens(jnp.asarray(caps)))))
    (jp, tp), (jr, tr) = _pair("a2c", 12), _pair("reward", 13)
    loss_fn = jax.jit(jax.value_and_grad(jsteps.a2c_rollout_loss_full, has_aux=True),
                      static_argnums=(1,), static_argnames=("per_step_mean",))
    (jloss, jstats), jgrads = loss_fn(
        jp, JCFG, jr, feats, jnp.asarray(caps), jnp.int32(curr), jnp.int32(caplen),
        jax.random.PRNGKey(5), per_step_mean=per_step_mean)
    (loss, stats), grads = _port_grads(tp, lambda p: tsteps.a2c_rollout_loss_full(
        p, TCFG, tr, _t(feats), _t(caps, torch.long), curr, caplen, prng.PRNGKey(5),
        per_step_mean=per_step_mean))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for name in ("actor_loss", "critic_loss", "mean_reward", "mean_advantage"):
        np.testing.assert_allclose(float(getattr(stats, name).detach()),
                                   float(getattr(jstats, name)), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    _check_grads(grads, jgrads)


def test_full_prefix_rollout_draws_the_jax_actions():
    """The sampled actions themselves: a rollout with the same keys places
    the same tokens, which the port's policy then scores identically."""
    feats, _ = _batch(8)
    (jp, tp) = _pair("a2c", 14)
    keys = prng.split(prng.PRNGKey(9), T - 1)
    jkeys = jax.random.split(jax.random.PRNGKey(9), T - 1)
    np.testing.assert_array_equal(keys, np.asarray(jkeys))
    buf = np.ones((N, 1), np.int32)
    for p in range(1, T):
        _, logits = ta2c.forward(tp, TCFG, _t(feats), _t(buf, torch.long))
        _, jlogits = ja2c.forward(jp, JCFG, feats, buf)
        a = tsteps.sample_categorical(keys[p - 1], logits)
        ja = jax.random.categorical(jkeys[p - 1], jlogits)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        buf = np.concatenate([buf, np.asarray(ja)[:, None].astype(np.int32)], axis=1)


LR = 1e-3


@pytest.mark.parametrize("kind", ["reward", "policy", "value", "a2c"])
def test_three_adam_steps_match_jax(kind):
    jp, tp = _pair(kind, 15)
    tx = joptim.adam(LR, jp, False)
    opt_state = tx.init(jp)
    opt = adam(LR, tp)
    frozen = {"policy": _pair("policy", 16), "reward": _pair("reward", 17)}
    if kind == "reward":
        jstep, tstep = jsteps.make_reward_step(JCFG, tx), tsteps.make_reward_step(TCFG, opt)
    elif kind == "policy":
        jstep, tstep = jsteps.make_policy_step(JCFG, tx), tsteps.make_policy_step(TCFG, opt)
    elif kind == "value":
        jstep = jsteps.make_value_step(JCFG, tx)
        tstep = tsteps.make_value_step(TCFG, opt, frozen["policy"][1], frozen["reward"][1])
    else:
        jstep, tstep = jsteps.make_a2c_step(JCFG, tx), tsteps.make_a2c_step(TCFG, opt)
    key, tkey = jax.random.PRNGKey(3), prng.PRNGKey(3)
    want, got = [], []
    for i, extra in enumerate((2, 6, 4)):
        feats, caps = _batch(20 + i)
        f, c = _t(feats), _t(caps, torch.long)
        if kind == "value":
            jp, opt_state, loss = jstep(jp, opt_state, frozen["policy"][0], frozen["reward"][0],
                                        jnp.asarray(feats), jnp.asarray(caps), extra)
            got.append(float(tstep(tp, f, c, extra)))
        elif kind == "a2c":
            key, sub = jax.random.split(key)
            tkey, tsub = prng.split(tkey)
            jp, opt_state, stats = jstep(jp, opt_state, frozen["reward"][0], jnp.asarray(feats),
                                         jnp.asarray(caps), jnp.int32(1), sub)
            loss = stats.loss
            got.append(float(tstep(tp, frozen["reward"][1], f, c, 1, tsub).loss))
        else:
            jp, opt_state, loss = jstep(jp, opt_state, jnp.asarray(feats), jnp.asarray(caps))
            got.append(float(tstep(tp, f, c)))
        want.append(float(loss))
    # the A2C loss is actor + critic, terms of order 0.1-1 that may nearly
    # cancel: float32 noise of the terms is ~1e-7 absolute
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 if kind == "a2c" else 0)
    want_leaves = dict(_named(jp))
    for name, leaf in _named(tp):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(want_leaves[name]), rtol=0,
                                   atol=2e-5, err_msg=name)


# --------------------------------------------------------------------------
# trainers, evaluation and the fused-path guards
# --------------------------------------------------------------------------

DIMS = {"wordvec_dim": E, "hidden_dim": H}
SEED = 3
TRAIN_KW = dict(epochs=1, batch_size=8, seed=SEED, net_dims=DIMS)


def _fields(seed=0, n_img=12, n_cap=24):
    rng = np.random.default_rng(seed)
    caps = rng.integers(4, V, size=(n_cap, T)).astype(np.int32)
    caps[:, 0] = 1
    lens = rng.integers(3, T + 1, size=n_cap)
    caps[np.arange(n_cap), lens - 1] = 2
    caps[np.arange(T)[None, :] >= lens[:, None]] = 0
    urls = np.array([f"img{i}.jpg" for i in range(n_img)])
    feats = rng.standard_normal((n_img, F)).astype(np.float32)
    idxs = rng.integers(0, n_img, size=n_cap).astype(np.int32)
    return dict(train_captions=caps, train_image_idxs=idxs, val_captions=caps,
                val_image_idxs=idxs, train_features=feats, val_features=feats,
                word_to_idx={w: i for i, w in enumerate(WORDS)},
                idx_to_word=dict(enumerate(WORDS)), train_urls=urls, val_urls=urls,
                train_captions_lens=caption_lengths(caps), val_captions_lens=caption_lengths(caps))


def _log(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _frozen_pts(tmp_path, kinds):
    """The sub-networks the trainers load, one JAX-written ``.pt`` each."""
    out = {}
    for kind in kinds:
        path = str(tmp_path / f"{kind}Network_bidirectional.pt")
        jckpt.save_network_pt(kind, _jax_tree(kind, {"reward": 5, "policy": 6, "value": 7}[kind]),
                              path, bidirectional=True)
        out[f"{kind}_network"] = path
    return out


def _assert_same_checkpoint(kind, jpath, jparams, tpath):
    saved_j = jckpt.load_network(kind, jpath, template=jparams)
    saved_t = jckpt.load_network(kind, tpath, template=jparams, bidirectional=True)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(saved_j),
                            jax.tree.leaves(saved_t)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("kind", ["reward", "policy", "value"])
def test_pretrainer_matches_jax_trainer(kind, tmp_path, monkeypatch):
    fields = _fields()
    jdata, tdata = JCocoData(**fields), CocoData(**fields)
    offset = {"reward": 0, "policy": 1, "value": 2}[kind]
    jinit = JMODS[kind].init(jax.random.PRNGKey(SEED + offset), jloops._cfg_for(jdata, True, DIMS))
    monkeypatch.setattr({"reward": reward, "policy": policy, "value": value}[kind], "init",
                        lambda gen, cfg, emb=None: from_jax_params(jax.tree.map(np.asarray,
                                                                                 jinit)))
    for side in "jt":
        (tmp_path / side).mkdir()
    frozen = _frozen_pts(tmp_path, ("reward", "policy")) if kind == "value" else {}
    jpaths = dict(frozen, **{f"{kind}_network": str(tmp_path / "j" / f"{kind}.ckpt")})
    tpaths = dict(frozen, **{f"{kind}_network": str(tmp_path / "t" / f"{kind}.pt")})
    extra = {} if kind == "value" else {"fused_chain": False}
    jparams = getattr(jloops, f"train_{kind}_network")(
        jdata, jpaths, str(tmp_path / "j"), True, device_data=False, chunk_steps=1, **extra,
        **TRAIN_KW)
    # auto mode: the plain steps on the device given
    getattr(tloops, f"train_{kind}_network")(tdata, tpaths, str(tmp_path / "t"), True,
                                             device="cpu", **TRAIN_KW)
    want, got = _log(tmp_path / "j" / "metrics.jsonl"), _log(tmp_path / "t" / "metrics.jsonl")
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    assert len(got) == 3
    np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want], rtol=1e-4)
    _assert_same_checkpoint(kind, jpaths[f"{kind}_network"], jparams, tpaths[f"{kind}_network"])


def test_a2c_trainer_matches_jax_trainer(tmp_path):
    fields = _fields()
    jdata, tdata = JCocoData(**fields), CocoData(**fields)
    nets = _frozen_pts(tmp_path, ("reward", "policy", "value"))
    for side in "jt":
        (tmp_path / side).mkdir()
    jpaths = dict(nets, a2c_network=str(tmp_path / "j" / "a2c.ckpt"))
    tpaths = dict(nets, a2c_network=str(tmp_path / "t" / "a2c.pt"))
    saves = {side: {"model_path": str(tmp_path / side / f"model.{ext}"),
                    "results_path": str(tmp_path / side / "results.txt")}
             for side, ext in (("j", "ckpt"), ("t", "ckpt"))}
    jparams, _, _ = jloops.train_a2c_network(jdata, saves["j"], jpaths, str(tmp_path / "j"), True,
                                             fused_rollout=False, chunk_steps=1, **TRAIN_KW)
    tloops.train_a2c_network(tdata, saves["t"], tpaths, str(tmp_path / "t"), True,
                             device="cpu", **TRAIN_KW)
    want, got = _log(tmp_path / "j" / "metrics.jsonl"), _log(tmp_path / "t" / "metrics.jsonl")
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    assert len(got) == 3 * 3
    np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want], rtol=1e-4)
    _assert_same_checkpoint("a2c", jpaths["a2c_network"], jparams, tpaths["a2c_network"])
    _assert_same_checkpoint("a2c", saves["j"]["model_path"], jparams,
                            saves["t"]["model_path"])
    assert ((tmp_path / "t" / "results.txt").read_text()
            == (tmp_path / "j" / "results.txt").read_text())


def _eval_paths(d):
    os.makedirs(d, exist_ok=True)
    return {k: os.path.join(d, f"{k}.txt") for k in
            ("real_captions_path", "generated_captions_path", "image_urls_path")}


def _eval_bundle():
    """A COCO-layout bundle with captions of length 17, two per image."""
    rng = np.random.default_rng(4)
    n_img = 40
    n = 2 * n_img
    lens = rng.integers(4, 18, size=n)
    caps = np.where(np.arange(17)[None] < lens[:, None] - 1, rng.integers(4, V, size=(n, 17)), 0)
    caps[np.arange(n), lens - 1] = 2
    caps[:, 0] = 1
    caps = caps.astype(np.int32)
    fields = _fields()
    fields.update(val_captions=caps, val_image_idxs=np.repeat(np.arange(n_img), 2).astype(np.int32),
                  val_features=rng.standard_normal((n_img, F)).astype(np.float32),
                  val_urls=np.array([f"http://example.com/{i}.jpg" for i in range(n_img)]),
                  val_captions_lens=caption_lengths(caps))
    return JCocoData(**fields), CocoData(**fields)


def test_test_a2c_network_dumps_match_jax(a2c_pair, tmp_path):
    """200 draws in Q9 slices of 127 and 71 rows, one group of 254 padded
    from 198: the three dumps byte-identical."""
    jp, tp = a2c_pair
    jdata, tdata = _eval_bundle()
    cfg17 = dict(KW, max_seq_len=17)
    jpaths, tpaths = _eval_paths(str(tmp_path / "j")), _eval_paths(str(tmp_path / "t"))
    jloops.test_a2c_network(jp, jconfig.NetConfig(precision="highest", **cfg17), jdata, jpaths,
                            data_size=200, eval_superbatch=2, use_fused_kernel=False)
    tloops.test_a2c_network(tp, tconfig.NetConfig(**cfg17), tdata, tpaths, data_size=200,
                            eval_superbatch=2, device="cpu")
    for key in jpaths:
        with open(jpaths[key], "rb") as a, open(tpaths[key], "rb") as b:
            assert b.read() == a.read(), key
    # load_a2c_models reads the JAX package's bidirectional .pt files
    files = {}
    for kind, tree in (("policy", jp["policy"]), ("value", jp["value"]), ("a2c", jp)):
        files[f"{kind}_network"] = str(tmp_path / f"{kind}.pt")
        jckpt.save_network_pt(kind, tree, files[f"{kind}_network"], bidirectional=True)
    params, cfg = tloops.load_a2c_models(files["a2c_network"], tdata, files, True,
                                         net_dims=DIMS, device="cpu")
    assert cfg.bidirectional
    for name, leaf in _named(tp):
        assert torch.equal(dict(_named(params))[name], leaf), name


def test_forcing_a_fused_path_raises_for_a_bidirectional_config(a2c_pair, tmp_path):
    jp, tp = a2c_pair
    feats, _ = _batch(9)
    cap = tapi.Captioner(tp, TCFG, dict(enumerate(WORDS)), device="cpu")
    for call in (lambda: cap.caption_tokens(feats, use_fused_kernel=True),
                 lambda: cap.caption_tokens(feats, beam_size=5, use_fused_kernel=True),
                 lambda: cap.sample_tokens(feats, top_k=5, use_fused_kernel=True)):
        with pytest.raises(ValueError, match="unidirectional"):
            call()
    data = CocoData(**_fields())
    paths = _eval_paths(str(tmp_path / "eval"))
    with pytest.raises(ValueError, match="use_fused_kernel=True"):
        tloops.test_a2c_network(tp, TCFG, data, paths, data_size=10, device="cpu",
                                use_fused_kernel=True)
    nets = {f"{k}_network": str(tmp_path / f"{k}.pt") for k in ("reward", "policy", "value",
                                                                 "a2c")}
    for kind in ("reward", "policy", "value"):
        with pytest.raises(ValueError, match="fused_chain"):
            getattr(tloops, f"train_{kind}_network")(data, nets, None, True, device="cpu",
                                                     fused_chain=True, **TRAIN_KW)
    saves = {"model_path": str(tmp_path / "m.ckpt"), "results_path": str(tmp_path / "r.txt")}
    with pytest.raises(ValueError, match="fused_rollout"):
        tloops.train_a2c_network(data, saves, nets, None, True, device="cpu",
                                 fused_rollout=True, **TRAIN_KW)
    opt = adam(LR, tp)
    for make in (lambda: tsteps.make_reward_step(TCFG, opt, fused=True),
                 lambda: tsteps.make_policy_step(TCFG, opt, fused=True),
                 lambda: tsteps.make_value_step(TCFG, opt, tp["policy"], {}, fused=True),
                 lambda: tsteps.make_a2c_step(TCFG, opt, fused=True)):
        with pytest.raises(ValueError, match="unidirectional"):
            make()
    assert not any(os.path.exists(p) for p in list(paths.values()) + list(nets.values())
                   + list(saves.values()))
