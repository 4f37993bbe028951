"""The port's pretraining losses and steps vs the JAX package's.

Weights come from the JAX initialisers (``from_jax_params``), features and
captions from a seeded numpy generator; the same tensors feed both sides.

  * Fused losses (the chains through the port's plain chain versions, the
    JAX side's Pallas kernels in interpret mode), loss and every gradient:
    policy XE and reward VSE with float32 weights to rtol 1e-5 (loss) and
    rtol 1e-4, atol 1e-6 (gradients); the fused value loss, which the JAX
    package runs with bf16 weights only (greedy kernel and chain), by
    relative error 2e-3 (loss) and relative Frobenius error 2e-3 per
    gradient — both sides round at the same points, and only where a
    float32 sum of another order straddles a bf16 rounding boundary does a
    value move by one bf16 step.
  * K = 3 Adam steps of each ``make_*_step`` (plain, float32) from the same
    weights on the same minibatches, with and without frozen embeddings,
    vs the JAX ``make_*_step(fused=False)``: the loss trajectory to
    rtol 1e-5 and the final parameters to atol 2e-5. torch's Adam and
    optax's compute the same update in another order; a gradient element
    near zero makes Adam's ``g / (sqrt(v) + eps)`` sensitive to float32
    noise, and such an element moves by at most lr = 1e-3 per step, in
    practice far less.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import config as jconfig
from image_captioning_through_rl_tpu.models import policy as jpolicy
from image_captioning_through_rl_tpu.models import reward as jreward
from image_captioning_through_rl_tpu.models import value as jvalue
from image_captioning_through_rl_tpu.train import optim as joptim
from image_captioning_through_rl_tpu.train import steps as jsteps
from image_captioning_through_rl_tpu_torch import config as tconfig
from image_captioning_through_rl_tpu_torch.models.convert import from_jax_params
from image_captioning_through_rl_tpu_torch.ops.fused_decode import (
    greedy_decode_plain,
    prepare_greedy_weights,
)
from image_captioning_through_rl_tpu_torch.train import steps
from image_captioning_through_rl_tpu_torch.train.optim import adam

torch.set_num_threads(1)

KW = dict(vocab_size=40, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=9)
N = 11
LR = 1e-3


def _cfgs(freeze=False):
    return (jconfig.NetConfig(precision="highest", freeze_embeddings=freeze, **KW),
            tconfig.NetConfig(freeze_embeddings=freeze, **KW))


def _batch(seed):
    rng = np.random.default_rng(seed)
    t = KW["max_seq_len"]
    caps = rng.integers(4, KW["vocab_size"], size=(N, t)).astype(np.int32)
    caps[:, 0] = 1
    lens = rng.integers(3, t + 1, size=N)
    caps[np.arange(N), lens - 1] = 2
    caps[np.arange(t)[None, :] >= lens[:, None]] = 0
    feats = rng.standard_normal((N, KW["input_dim"])).astype(np.float32)
    return feats, caps


INITS = {"policy": (jpolicy.init, 1), "reward": (jreward.init, 2), "value": (jvalue.init, 3)}


def _params(kind):
    init, key = INITS[kind]
    jp = init(jax.random.PRNGKey(key), _cfgs()[0])
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _named(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


def _port_grads(tp, loss_fn):
    tp = {k: ({kk: vv.clone().requires_grad_() for kk, vv in v.items()} if isinstance(v, dict)
              else v.clone().requires_grad_()) for k, v in tp.items()}
    loss = loss_fn(tp)
    names, leaves = zip(*_named(tp))
    return float(loss.detach()), dict(zip(names, torch.autograd.grad(loss, leaves)))


def _check_grads(got, want, bf16=False):
    want = dict(_named(want))
    assert set(got) == set(want)
    for name, g in got.items():
        a, b = g.numpy(), np.asarray(want[name])
        if bf16:
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= 2e-3, f"{name}: relative error {rel:.3g}"
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=name)


def test_policy_loss_fused_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params("policy")
    feats, caps = _batch(0)
    lens = np.array(jsteps.batch_caption_lens(jnp.asarray(caps)))
    np.testing.assert_array_equal(steps.batch_caption_lens(torch.from_numpy(caps)).numpy(), lens)
    jloss, jgrads = jax.value_and_grad(jsteps.policy_loss_fused)(
        jp, jcfg, feats, jnp.asarray(caps), jnp.asarray(lens), block_n=8,
        weight_dtype=jnp.float32, interpret=True)
    loss, grads = _port_grads(tp, lambda p: steps.policy_loss_fused(
        p, tcfg, torch.from_numpy(feats), torch.from_numpy(caps).long(), torch.from_numpy(lens),
        weight_dtype=torch.float32))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    _check_grads(grads, jgrads)


def test_reward_loss_fused_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params("reward")
    feats, caps = _batch(1)
    jloss, jgrads = jax.value_and_grad(jsteps.reward_loss_fused)(
        jp, jcfg, feats, jnp.asarray(caps), block_n=8, weight_dtype=jnp.float32,
        interpret=True)
    loss, grads = _port_grads(tp, lambda p: steps.reward_loss_fused(
        p, tcfg, torch.from_numpy(feats), torch.from_numpy(caps).long(),
        weight_dtype=torch.float32))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    _check_grads(grads, jgrads)


@pytest.mark.parametrize("fused", [False, True])
def test_value_episode_loss_matches_jax(fused):
    jcfg, tcfg = _cfgs()
    (jv, tv), (jpp, tpp), (jr, tr) = _params("value"), _params("policy"), _params("reward")
    # a batch whose greedy rollout has no near-tie (smallest top-2 logit gap
    # 1.6e-3), so both bf16 rollouts agree token for token
    feats, caps = _batch(36)
    gw = prepare_greedy_weights(tpp) if fused else None
    if fused:
        _, gaps = greedy_decode_plain(gw, torch.from_numpy(feats),
                                      torch.from_numpy(caps[:, 0]).int().contiguous(),
                                      tcfg.max_seq_len, margins=True)
        assert float(gaps.min()) > 1e-3
    prefix = 5
    jloss, jgrads = jax.value_and_grad(jsteps.value_episode_loss)(
        jv, jcfg, jpp, jr, feats, jnp.asarray(caps), jnp.int32(prefix), fused=fused,
        interpret=fused)
    loss, grads = _port_grads(tv, lambda p: steps.value_episode_loss(
        p, tcfg, tpp, tr, torch.from_numpy(feats), torch.from_numpy(caps).long(), prefix,
        fused=fused, greedy_weights=gw))
    if fused:
        assert abs(loss - float(jloss)) <= 2e-3 * abs(float(jloss))
    else:
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    _check_grads(grads, jgrads, bf16=fused)


def _jax_steps(kind, jcfg, jp, batches, prefixes, frozen_nets):
    tx = joptim.adam(LR, jp, jcfg.freeze_embeddings)
    opt = tx.init(jp)
    losses = []
    if kind == "value":
        step = jsteps.make_value_step(jcfg, tx)
        for (f, c), pl in zip(batches, prefixes):
            jp, opt, loss = step(jp, opt, *frozen_nets, jnp.asarray(f), jnp.asarray(c),
                                 jnp.int32(pl))
            losses.append(float(loss))
    else:
        step = (jsteps.make_policy_step if kind == "policy" else jsteps.make_reward_step)(jcfg, tx)
        for f, c in batches:
            jp, opt, loss = step(jp, opt, jnp.asarray(f), jnp.asarray(c))
            losses.append(float(loss))
    return losses, jp


@pytest.mark.parametrize("freeze", [False, True], ids=["trained_emb", "frozen_emb"])
@pytest.mark.parametrize("kind", ["policy", "reward", "value"])
def test_three_adam_steps_match_jax(kind, freeze):
    jcfg, tcfg = _cfgs(freeze)
    jp, tp = _params(kind)
    emb0 = tp["embedding"].clone()
    batches = [_batch(10 + i) for i in range(3)]
    prefixes = [3, 9, 6]
    frozen = {}
    if kind == "value":
        frozen = {"j": (_params("policy")[0], _params("reward")[0]),
                  "t": (_params("policy")[1], _params("reward")[1])}
    want_losses, want = _jax_steps(kind, jcfg, jp, batches, prefixes, frozen.get("j"))
    opt = adam(LR, tp, tcfg.freeze_embeddings)
    if kind == "value":
        step = steps.make_value_step(tcfg, opt, *frozen["t"])
        losses = [float(step(tp, torch.from_numpy(f), torch.from_numpy(c).long(), pl))
                  for (f, c), pl in zip(batches, prefixes)]
    else:
        make = steps.make_policy_step if kind == "policy" else steps.make_reward_step
        step = make(tcfg, opt)
        losses = [float(step(tp, torch.from_numpy(f), torch.from_numpy(c).long()))
                  for f, c in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = dict(_named(want))
    for name, leaf in _named(tp):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(want[name]), rtol=0,
                                   atol=2e-5, err_msg=name)
    if freeze:
        assert torch.equal(tp["embedding"], emb0)
    else:
        assert not torch.equal(tp["embedding"], emb0)
