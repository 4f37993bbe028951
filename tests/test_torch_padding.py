"""The port's padding to the kernels' widths vs the JAX package, on the CPU.

A model whose widths the CUDA kernels cannot stage in 16-byte chunks (an
odd vocabulary, E, F or H not a multiple of 8) is padded on its way into
them (``ops/padding.py``): zero weight rows and input columns for E and F,
zero units with zero initial state for H, zero head columns with a -1e30
bias for V. Here the padded weights run through the kernels' plain versions
(the functions the kernels compute) at V = 1001 and E = H = F = 500 and are
held against the JAX package on the unpadded model, float32 throughout: the
padding must change nothing.

Tolerances are the unpadded tests' (``test_torch_decode.py``,
``test_torch_sample.py``, ``test_torch_chains.py``): tokens equal against
JAX at ``precision="highest"``, beam scores to 1e-4; the chains' hs to rtol
1e-5 and their gradients to rtol 1e-4, atol 1e-6 (float32 sums in another
order; the padding adds only exact zeros to them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import config as jconfig
from image_captioning_through_rl_tpu.decode import beam_search as jbeam_search
from image_captioning_through_rl_tpu.decode import greedy_decode as jgreedy_decode
from image_captioning_through_rl_tpu.decode import sample as jsample
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu.models import reward as jreward
from image_captioning_through_rl_tpu.models.initializers import embedding_init, gru_init, lstm_init
from image_captioning_through_rl_tpu.ops.pallas_gru import fused_gru_chain as jax_gru_chain
from image_captioning_through_rl_tpu.ops.pallas_lstm import fused_lstm_chain as jax_lstm_chain
from image_captioning_through_rl_tpu.ops.pallas_rollout import fused_rollout as jrollout
from image_captioning_through_rl_tpu_torch import config as tconfig
from image_captioning_through_rl_tpu_torch.models import from_jax_params
from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr
from image_captioning_through_rl_tpu_torch.ops import prng
from image_captioning_through_rl_tpu_torch.ops.fused_beam import (
    beam_search_plain,
    prepare_beam_weights,
)
from image_captioning_through_rl_tpu_torch.ops.fused_decode import (
    greedy_decode_plain,
    prepare_greedy_weights,
)
from image_captioning_through_rl_tpu_torch.ops.fused_gru import gru_chain_plain
from image_captioning_through_rl_tpu_torch.ops.fused_lstm import lstm_chain_plain, padded_chain
from image_captioning_through_rl_tpu_torch.ops.fused_sample import sample_decode_plain
from image_captioning_through_rl_tpu_torch.ops.padding import (
    needs_padding,
    pad8,
    pad_cell,
    pad_dim,
    pad_gates,
)

torch.set_num_threads(1)

V, WIDTH, T, N, BEAM = 1001, 500, 7, 6, 3
KW = dict(vocab_size=V, input_dim=WIDTH, wordvec_dim=WIDTH, hidden_dim=WIDTH, max_seq_len=T)
JCFG = jconfig.NetConfig(precision="highest", **KW)
TCFG = tconfig.NetConfig(**KW)


@pytest.fixture(scope="module")
def params():
    jp = ja2c.init(jax.random.PRNGKey(0), JCFG)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _feats(n=N, seed=0):
    feats = np.random.default_rng(seed).standard_normal((n, WIDTH)).astype(np.float32)
    return feats, np.ones(n, np.int32)


def test_odd_widths_are_padded_and_coco_widths_are_not(params):
    _, tp = params
    gw = prepare_greedy_weights(tp["policy"], torch.float32)
    assert gw.widths == (WIDTH, WIDTH, WIDTH) and gw.feat_dim == WIDTH
    assert gw.wc.shape == (504, 504) and gw.emb.shape == (V, 504)
    assert gw.w.shape == (1008, 4 * 504) and gw.wo.shape == (504, 1002)
    assert float(gw.bo[-1]) == float(torch.tensor(-1e30)) and gw.bo.shape == (1002,)
    assert not needs_padding(512, 512, 512, vocab=1004)
    assert needs_padding(512, 512, 512, vocab=1001) and needs_padding(500, vocab=1004)
    assert [pad8(w) for w in (1, 8, 500, 512)] == [8, 8, 504, 512]


def test_pad_helpers_place_each_gate_and_stay_differentiable():
    w = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(2, 15).requires_grad_()
    p = pad_gates(w, 3, 8)
    assert p.shape == (2, 24)
    for g in range(3):
        assert torch.equal(p[:, 8 * g:8 * g + 5], w[:, 5 * g:5 * g + 5])
        assert not bool(p[:, 8 * g + 5:8 * g + 8].any())
    p.sum().backward()
    assert torch.equal(w.grad, torch.ones_like(w))
    cell = pad_cell({"wi": torch.ones(3, 12), "wh": torch.ones(3, 12), "b": torch.ones(12)},
                    4, 8, 8)
    assert {k: tuple(v.shape) for k, v in cell.items()} == {"wi": (8, 32), "wh": (8, 32),
                                                           "b": (32,)}
    assert torch.equal(pad_dim(torch.ones(2), 0, 4, -1.0), torch.tensor([1.0, 1.0, -1.0, -1.0]))


def test_padded_greedy_matches_jax(params):
    jp, tp = params
    feats, start = _feats(seed=1)
    want = np.asarray(jgreedy_decode(jp["policy"], JCFG, jnp.asarray(feats), jnp.asarray(start)))
    gw = prepare_greedy_weights(tp["policy"], torch.float32)
    got = greedy_decode_plain(gw, torch.from_numpy(feats), torch.from_numpy(start), T)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) < V


def test_padded_beam_matches_jax(params):
    jp, tp = params
    feats, start = _feats(seed=2)
    dcfg = jconfig.DecodeConfig(beam_size=BEAM, max_seq_len=T)
    want_t, want_s = (np.asarray(x) for x in jbeam_search(
        jp["policy"], jp["value"], JCFG, dcfg, jnp.asarray(feats), jnp.asarray(start)))
    bw = prepare_beam_weights(prepare_greedy_weights(tp["policy"], torch.float32), tp["value"])
    assert bw.value.w1.shape == (1008, 504) and bw.value.w2.shape == (504,)
    got_t, got_s = beam_search_plain(bw, torch.from_numpy(feats), torch.from_numpy(start), T,
                                     BEAM)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("k,p", [(0, None), (40, None), (0, 0.9), (40, 0.9)])
def test_padded_sampling_matches_jax(params, k, p):
    """The noise counters stay ``row * V + col`` over the unpadded V: the
    padded head's extra word is cut before the filters and the noise."""
    jp, tp = params
    feats, start = _feats(seed=3 + k)
    want = np.asarray(jsample.sample_decode(
        jp["policy"], JCFG, jnp.asarray(feats), jnp.asarray(start), jax.random.PRNGKey(5),
        max_len=T, temperature=1.1, top_k=k, top_p=None if p is None else jnp.float32(p)))
    gw = prepare_greedy_weights(tp["policy"], torch.float32)
    got = sample_decode_plain(gw, torch.from_numpy(feats), torch.from_numpy(start),
                              prng.PRNGKey(5), T, temperature=1.1, top_k=k, top_p=p)
    np.testing.assert_array_equal(got.numpy(), want)


def _chain_case(kind, n=13, steps=5):
    rng = np.random.default_rng(11)
    init = lstm_init if kind == "lstm" else gru_init
    jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), WIDTH, WIDTH))
    emb = np.asarray(embedding_init(jax.random.PRNGKey(1), V, WIDTH))
    toks = rng.integers(0, V, size=(n, steps)).astype(np.int32)
    states = [(0.5 * rng.standard_normal((n, WIDTH))).astype(np.float32)
              for _ in range(2 if kind == "lstm" else 1)]
    # an upstream gradient of 0.1: the gradients stay near 1 at this width, as
    # the unpadded tests' do at theirs, so atol 1e-6 holds them as it holds those
    dhs = (0.1 * rng.standard_normal((n, steps, WIDTH))).astype(np.float32)
    return jp, emb, toks, states, dhs


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_padded_chain_matches_jax_pallas_chain(kind):
    jp, emb, toks, states, dhs = _chain_case(kind)
    chain = jax_lstm_chain if kind == "lstm" else jax_gru_chain

    def loss(p, e, *s):
        hs = chain(p, e, jnp.asarray(toks), *s, block_n=8, weight_dtype=jnp.float32,
                   interpret=True)
        return jnp.sum(hs * dhs), hs

    (_, want_hs), grads = jax.value_and_grad(loss, argnums=tuple(range(2 + len(states))),
                                             has_aux=True)(jp, emb, *states)
    gp, ge, *gs = grads
    want = [np.asarray(want_hs), *[np.asarray(gp[k]) for k in jp], np.asarray(ge),
            *map(np.asarray, gs)]

    plain = lstm_chain_plain if kind == "lstm" else gru_chain_plain
    gates = 4 if kind == "lstm" else 3
    tparams = {k: v.requires_grad_() for k, v in from_jax_params(jp).items()}
    e = torch.from_numpy(emb.copy()).requires_grad_()
    s = [torch.from_numpy(x).requires_grad_() for x in states]
    seen = []

    def run(p, emb_p, tok, *st):
        seen.append((emb_p.shape[1], st[0].shape[1]))
        return plain(p, emb_p, tok, *st, weight_dtype=torch.float32)

    hs = padded_chain(run, tparams, e, torch.from_numpy(toks), tuple(s), gates)
    assert seen == [(504, 504)]
    got = [hs.detach().numpy(), *[g.numpy() for g in torch.autograd.grad(
        hs, [*tparams.values(), e, *s], torch.from_numpy(dhs))]]
    names = ["hs", *jp, "embedding", "h0", "c0"]
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        tol = dict(rtol=1e-5, atol=1e-6) if name == "hs" else dict(rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


def test_padded_rollout_matches_jax_and_the_unpadded_gradients():
    """The rollout on padded leaves, features and start states, with the
    reward network padded by ``prepare_reward_weights``, at widths of 12
    (plain versions, float32): values, log-probs, actions, tokens and
    rewards equal the JAX package's fused rollout (Pallas, interpret mode) on
    the unpadded networks, and the parameter gradients equal those of the
    unpadded rollout."""
    kw = dict(vocab_size=31, input_dim=12, wordvec_dim=12, hidden_dim=12, max_seq_len=6)
    jcfg, tcfg = jconfig.NetConfig(precision="highest", **kw), tconfig.NetConfig(**kw)
    n, steps = 7, kw["max_seq_len"] - 1
    jp, jr = ja2c.init(jax.random.PRNGKey(0), jcfg), jreward.init(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((n, 12)).astype(np.float32)
    caps = rng.integers(4, 31, size=(n, kw["max_seq_len"])).astype(np.int32)
    caps[:, 0] = 1
    want = [np.asarray(x) for x in jrollout(
        jp, jcfg, jnp.asarray(feats), jnp.asarray(caps), jnp.int32(2), jax.random.PRNGKey(3),
        block_n=8, weight_dtype=jnp.float32, interpret=True, reward_params=jr)]
    tp, tr = (from_jax_params(jax.tree.map(np.asarray, t)) for t in (jp, jr))
    f, c = torch.from_numpy(feats), torch.from_numpy(caps).long()
    noise = prng.gumbel_noise(prng.split(prng.PRNGKey(3), steps), (n, 31), "cpu")
    rw = fr.prepare_reward_weights(tr, f, c[:, 0], torch.float32)
    assert rw.wh.shape == (16, 48)  # the reward network pads itself

    def run(pad):
        params = {net: {k: ({kk: vv.clone().requires_grad_() for kk, vv in v.items()}
                            if isinstance(v, dict) else v.clone().requires_grad_())
                        for k, v in p.items()} for net, p in tp.items()}
        states = fr.start_states(params, tcfg, f, c[:, 0])
        nets_in, f_in = params, f
        if pad:
            nets_in, f_in, states = fr.pad_rollout_inputs(params, f, states)
            assert states[0].shape == (n, 16) and f_in.shape == (n, 16)
        out = fr._RolloutPlain.apply(2, torch.float32, c[:, 1:].t().to(torch.int32).contiguous(),
                                     noise, rw, f_in, *states, *fr.rollout_leaves(nets_in))
        grads = torch.autograd.grad(out[0].sum() + out[1].sum(), fr.rollout_leaves(params))
        return [x.detach() for x in out], grads

    (values, logp, act, tok, rewards), grads = run(True)
    for got, ref in zip((values, logp, act, tok, rewards), want):
        np.testing.assert_allclose(got.t().numpy(), ref, rtol=1e-5, atol=1e-5)
    _, want_grads = run(False)
    for a, b in zip(grads, want_grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
