"""The plain reference against the program's own plain versions at a tiny
size on the CPU (float32): the same keys and noise, the same A2C and XE
losses and gradients, the same beam and beam scores."""

import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu_torch.config import DecodeConfig, NetConfig
from image_captioning_through_rl_tpu_torch.decode.beam import beam_search
from image_captioning_through_rl_tpu_torch.ops import prng as port_prng
from image_captioning_through_rl_tpu_torch.train import steps
from portbench import traffic
from portbench.reference import beam as ref_beam
from portbench.reference import nets, prng
from portbench.reference import train as ref

CFG = {"vocab_size": 40, "input_dim": 12, "wordvec_dim": 10, "hidden_dim": 16, "max_seq_len": 17}
TR = {"lengths": [3, 5, 8, 15], "length_weights": [1, 2, 2, 1], "zipf": 1.0}


def _net_cfg():
    return NetConfig(vocab_size=CFG["vocab_size"], input_dim=CFG["input_dim"],
                     wordvec_dim=CFG["wordvec_dim"], hidden_dim=CFG["hidden_dim"])


def _tree(seed=3):
    leaves = (nets.policy_leaves(CFG, ("policy",)) + nets.value_leaves(CFG, ("value",))
              + nets.reward_leaves(CFG, ("reward",)))
    return nets.build_tree(leaves, traffic.draw_weights(seed, [l[1:] for l in leaves], "cpu"))


def _inputs(n=24, seed=5):
    rng = np.random.default_rng(seed)
    caps = traffic.caption_table(rng, n, TR, CFG["vocab_size"], CFG["max_seq_len"])
    feats = traffic.feature_table(rng, n, CFG["input_dim"])
    return torch.from_numpy(feats), torch.from_numpy(caps).long()


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_keys_and_noise(seed):
    k = prng.key(seed)
    assert np.array_equal(k, port_prng.PRNGKey(seed))
    assert np.array_equal(prng.split(k, 5), port_prng.split(k, 5))
    sub = prng.split(k)[1]
    assert torch.equal(prng.gumbel(sub, (6, 33), "cpu"), port_prng.gumbel(sub, (6, 33), "cpu"))


def _grads(loss, tree):
    flat = nets.flat(tree)
    return dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))


def test_a2c_loss_and_gradients():
    tree = _tree()
    a2c = {"policy": tree["policy"], "value": tree["value"]}
    for v in nets.flat(a2c).values():
        v.requires_grad_()
    feats, caps = _inputs()
    key = prng.split(prng.key(11))[1]
    loss, _, _ = ref.a2c_loss(tree["policy"], tree["value"], tree["reward"], feats, caps, key)
    caplen = torch.max(steps.batch_caption_lens(caps))
    port_loss, _ = steps.a2c_rollout_loss(a2c, _net_cfg(), tree["reward"], feats, caps, 1,
                                          caplen, key)
    assert float(loss) == pytest.approx(float(port_loss), rel=1e-6)
    g_ref, g_port = _grads(loss, a2c), _grads(port_loss, a2c)
    for k in g_ref:
        torch.testing.assert_close(g_ref[k], g_port[k], rtol=1e-5, atol=1e-7)


def test_xe_loss_and_gradients():
    pol = _tree()["policy"]
    for v in nets.flat(pol).values():
        v.requires_grad_()
    feats, caps = _inputs()
    loss = ref.xe_loss(pol, feats, caps)
    port_loss = steps.policy_loss(pol, _net_cfg(), feats, caps, steps.batch_caption_lens(caps))
    assert float(loss) == pytest.approx(float(port_loss), rel=1e-6)
    g_ref, g_port = _grads(loss, pol), _grads(port_loss, pol)
    for k in g_ref:
        torch.testing.assert_close(g_ref[k], g_port[k], rtol=1e-5, atol=1e-7)


def test_beam_and_its_scores():
    tree = _tree()
    feats, _ = _inputs()
    dcfg = DecodeConfig(beam_size=5)
    start = torch.full((feats.shape[0],), 1, dtype=torch.int32)
    toks, scores = beam_search(tree["policy"], tree["value"], _net_cfg(), dcfg, feats, start)
    r_toks, r_scores = ref_beam.beam_search(tree["policy"], tree["value"], feats, 5, 16, 0.6, 0.4)
    assert torch.equal(toks.long(), r_toks)
    torch.testing.assert_close(scores, r_scores, rtol=1e-5, atol=1e-5)
    seq, gaps = ref_beam.sequence_scores(tree["policy"], tree["value"], feats, toks[:, 0], 5,
                                         0.6, 0.4)
    torch.testing.assert_close(seq, scores[:, 0], rtol=1e-5, atol=1e-5)
    assert float(gaps.max()) == 0.0  # every token of the beam is among its parent's top 5
