"""The port's A2C rollout, reward stream, losses and steps vs the JAX package's.

Weights come from the JAX initialisers (``from_jax_params``), features and
captions from a seeded numpy generator, keys from ``jax.random.PRNGKey``
(the port's :mod:`...ops.prng` makes the same keys and noise, see
``test_torch_prng.py``). The JAX rollout kernels run in interpret mode with
``block_n=8``, as ``tests/test_pallas_rollout.py`` runs them; the port's
wrappers run their plain versions (the tensors lie on the CPU).

Tolerances, float32 weights: values, log-probs and rewards to rtol 1e-5
(the same float32 operations in another sum order); actions and tokens
exactly (no near-tie at these seeds: the noise is the same to a few ulps
and the logits to ~1e-7); the loss to rtol 1e-5 and every gradient to
rtol 1e-4, atol 1e-6 (the hand-written backward sums over 8 steps and 11
rows in another order). bf16 weights: relative Frobenius error 2e-3 per
output and gradient — both sides round at the same points, and only where
a float32 sum of another order straddles a bf16 rounding boundary does an
operand move, by one bf16 step (2^-8 relative), which a norm over the
whole array dilutes. Three Adam steps: losses to rtol 1e-5, weights to
atol 2e-5, as ``test_torch_steps.py`` argues.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import config as jconfig
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu.models import reward as jreward
from image_captioning_through_rl_tpu.ops import losses as jlosses
from image_captioning_through_rl_tpu.ops.pallas_rollout import fused_reward_stream as jstream
from image_captioning_through_rl_tpu.ops.pallas_rollout import fused_rollout as jrollout
from image_captioning_through_rl_tpu.train import optim as joptim
from image_captioning_through_rl_tpu.train import steps as jsteps
from image_captioning_through_rl_tpu_torch import config as tconfig
from image_captioning_through_rl_tpu_torch.models.convert import from_jax_params
from image_captioning_through_rl_tpu_torch.ops import fused_rollout as tfr
from image_captioning_through_rl_tpu_torch.ops import losses as tlosses
from image_captioning_through_rl_tpu_torch.ops import prng
from image_captioning_through_rl_tpu_torch.train import steps as tsteps
from image_captioning_through_rl_tpu_torch.train.optim import adam

torch.set_num_threads(1)

KW = dict(vocab_size=40, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=9)
N = 11
S = KW["max_seq_len"] - 1
JCFG = jconfig.NetConfig(precision="highest", **KW)
TCFG = tconfig.NetConfig(**KW)
KEY_SEED = 5
BF16_TOL = 2e-3


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


@functools.lru_cache(maxsize=None)
def _nets():
    jp = ja2c.init(jax.random.PRNGKey(0), JCFG)
    jr = jreward.init(jax.random.PRNGKey(1), JCFG)
    return jp, jr


def _port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree))


def _caplen(caps):
    return int(np.max(np.argmax(caps == 2, axis=1)) + 1)


@functools.lru_cache(maxsize=None)
def _jax_rollout(curr, wd_name):
    jp, jr = _nets()
    feats, caps = _batch(0)
    out = jrollout(jp, JCFG, jnp.asarray(feats), jnp.asarray(caps), jnp.int32(curr),
                   jax.random.PRNGKey(KEY_SEED), block_n=8, weight_dtype=jnp.dtype(wd_name),
                   interpret=True, reward_params=jr)
    return tuple(np.asarray(x) for x in out)


def _port_rollout(curr, wd, **kw):
    jp, jr = _nets()
    feats, caps = _batch(0)
    out = tfr.fused_rollout(_port(jp), TCFG, torch.from_numpy(feats), torch.from_numpy(caps).long(),
                            curr, prng.PRNGKey(KEY_SEED), weight_dtype=wd, reward_params=_port(jr),
                            **kw)
    return tuple(x.detach().numpy() for x in out)


def _check_rollout(got, want):
    for name, a, b in zip(("values", "log_probs", "actions", "tokens", "rewards"), got, want):
        assert a.shape == b.shape == (N, S), name
        if name in ("actions", "tokens"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=name)


@pytest.mark.parametrize("curr", [1, 4])
def test_fused_rollout_matches_jax(curr):
    before = (tfr.fused_rollout.fwd_launches, prng.gumbel_noise.launches)
    got = _port_rollout(curr, torch.float32)
    _check_rollout(got, _jax_rollout(curr, "float32"))
    # teacher-forced positions p < curr place the caption's tokens
    _, caps = _batch(0)
    np.testing.assert_array_equal(got[3][:, :curr - 1], caps[:, 1:curr])
    # CPU tensors ran the plain versions: no kernel was counted
    assert (tfr.fused_rollout.fwd_launches, prng.gumbel_noise.launches) == before


def test_rollout_on_jax_made_noise_matches_jax():
    """The JAX package's own Gumbel array, fed to the port's rollout: a
    rollout fault shows here even where a PRNG fault would not."""
    jp, jr = _nets()
    feats, caps = _batch(0)
    keys = jax.random.split(jax.random.PRNGKey(KEY_SEED), S)
    noise = np.array(jax.vmap(lambda k: jax.random.gumbel(k, (N, KW["vocab_size"])))(keys))
    out = tfr.rollout_from_noise(_port(jp), TCFG, torch.from_numpy(feats),
                                 torch.from_numpy(caps).long(), 4, torch.from_numpy(noise),
                                 weight_dtype=torch.float32, reward_params=_port(jr))
    _check_rollout([x.detach().numpy() for x in out], _jax_rollout(4, "float32"))


@pytest.mark.parametrize("wd", ["float32", "bfloat16"])
def test_reward_stream_matches_jax(wd):
    _, jr = _nets()
    feats, caps = _batch(0)
    _, _, actions, tokens, _ = _jax_rollout(1, "float32")
    want = np.asarray(jstream(jr, JCFG, jnp.asarray(feats), jnp.asarray(caps[:, 0]),
                              jnp.asarray(actions), jnp.asarray(tokens), block_n=8,
                              weight_dtype=jnp.dtype(wd), interpret=True))
    got = tfr.fused_reward_stream(_port(jr), TCFG, torch.from_numpy(feats),
                                  torch.from_numpy(caps[:, 0]), torch.from_numpy(actions),
                                  torch.from_numpy(tokens), weight_dtype=getattr(torch, wd))
    assert got.shape == (N, S) and not got.requires_grad
    if wd == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
        # the stream on its own equals the stream fused into the rollout
        np.testing.assert_allclose(got.numpy(), _jax_rollout(1, "float32")[4], rtol=1e-5)
    else:
        assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) <= BF16_TOL


def _named(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


def _port_loss_and_grads(loss_fn):
    tp = _port(_nets()[0])
    names, leaves = zip(*_named(tp))
    for leaf in leaves:
        leaf.requires_grad_()
    loss, stats = loss_fn(tp)
    return float(loss.detach()), stats, dict(zip(names, torch.autograd.grad(loss, leaves)))


def _jax_loss_and_grads(loss_fn):
    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(_nets()[0])
    return float(loss), stats, dict(_named(grads))


def _check_grads(got, want, bf16=False):
    assert set(got) == set(want)
    for name, g in got.items():
        a, b = g.numpy(), np.asarray(want[name])
        if bf16:
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= BF16_TOL, f"{name}: relative error {rel:.3g}"
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=name)


def _loss_args(seed=0):
    feats, caps = _batch(seed)
    return feats, caps, _caplen(caps)


@pytest.mark.parametrize("curr,per_step_mean,fuse_reward",
                         [(1, False, True), (4, True, True), (4, False, False), (1, True, False)])
def test_a2c_loss_fused_matches_jax(curr, per_step_mean, fuse_reward):
    _, jr = _nets()
    feats, caps, caplen = _loss_args()
    jloss, jstats, jgrads = _jax_loss_and_grads(lambda p: jsteps.a2c_rollout_loss_fused(
        p, JCFG, jr, jnp.asarray(feats), jnp.asarray(caps), jnp.int32(curr), jnp.int32(caplen),
        jax.random.PRNGKey(KEY_SEED), per_step_mean=per_step_mean, block_n=8,
        weight_dtype=jnp.float32, interpret=True, fuse_reward=fuse_reward))
    loss, stats, grads = _port_loss_and_grads(lambda p: tsteps.a2c_rollout_loss_fused(
        p, TCFG, _port(jr), torch.from_numpy(feats), torch.from_numpy(caps).long(), curr, caplen,
        prng.PRNGKey(KEY_SEED), per_step_mean=per_step_mean, weight_dtype=torch.float32,
        fuse_reward=fuse_reward))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for name in ("actor_loss", "critic_loss", "mean_reward", "mean_advantage"):
        np.testing.assert_allclose(float(getattr(stats, name).detach()),
                                   float(getattr(jstats, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    _check_grads(grads, jgrads)


@pytest.mark.parametrize("curr,per_step_mean", [(1, False), (4, True)])
def test_a2c_loss_plain_matches_jax(curr, per_step_mean):
    """The eager scan against the JAX package's XLA rollout (the value and
    policy gradients, including the actor term's path into the values,
    Q7)."""
    _, jr = _nets()
    feats, caps, caplen = _loss_args(1)
    jloss, _, jgrads = _jax_loss_and_grads(lambda p: jsteps.a2c_rollout_loss(
        p, JCFG, jr, jnp.asarray(feats), jnp.asarray(caps), jnp.int32(curr), jnp.int32(caplen),
        jax.random.PRNGKey(KEY_SEED), per_step_mean=per_step_mean))
    loss, _, grads = _port_loss_and_grads(lambda p: tsteps.a2c_rollout_loss(
        p, TCFG, _port(jr), torch.from_numpy(feats), torch.from_numpy(caps).long(), curr, caplen,
        prng.PRNGKey(KEY_SEED), per_step_mean=per_step_mean))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _check_grads(grads, jgrads)


@pytest.mark.parametrize("curr", [1, 4])
def test_rollout_backward_equals_autograd_of_the_eager_scan(curr):
    """With float32 weights the rollout's hand-written backward (the plain
    twin of the kernels') equals autograd through the eager scan."""
    _, jr = _nets()
    feats, caps, caplen = _loss_args(2)
    args = (TCFG, _port(jr), torch.from_numpy(feats), torch.from_numpy(caps).long(), curr, caplen,
            prng.PRNGKey(KEY_SEED + 1))
    loss_f, _, grads_f = _port_loss_and_grads(
        lambda p: tsteps.a2c_rollout_loss_fused(p, *args, weight_dtype=torch.float32))
    loss_p, _, grads_p = _port_loss_and_grads(lambda p: tsteps.a2c_rollout_loss(p, *args))
    np.testing.assert_allclose(loss_f, loss_p, rtol=1e-5)
    for name, g in grads_f.items():
        np.testing.assert_allclose(g.numpy(), grads_p[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_bf16_rollout_matches_jax_interpret_bf16():
    _, jr = _nets()
    got, want = _port_rollout(4, torch.bfloat16), _jax_rollout(4, "bfloat16")
    for name, a, b in zip(("values", "log_probs", "actions", "tokens", "rewards"), got, want):
        if name in ("actions", "tokens"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= BF16_TOL, f"{name}: relative error {rel:.3g}"
    feats, caps, caplen = _loss_args()
    jloss, _, jgrads = _jax_loss_and_grads(lambda p: jsteps.a2c_rollout_loss_fused(
        p, JCFG, jr, jnp.asarray(feats), jnp.asarray(caps), jnp.int32(4), jnp.int32(caplen),
        jax.random.PRNGKey(KEY_SEED), per_step_mean=True, block_n=8, weight_dtype=jnp.bfloat16,
        interpret=True))
    loss, _, grads = _port_loss_and_grads(lambda p: tsteps.a2c_rollout_loss_fused(
        p, TCFG, _port(jr), torch.from_numpy(feats), torch.from_numpy(caps).long(), 4, caplen,
        prng.PRNGKey(KEY_SEED), per_step_mean=True, weight_dtype=torch.bfloat16))
    assert abs(loss - jloss) <= BF16_TOL * abs(jloss)
    _check_grads(grads, jgrads, bf16=True)


@pytest.mark.parametrize("per_step_mean", [False, True])
def test_a2c_losses_match_jax(per_step_mean):
    rng = np.random.default_rng(7)
    values, rewards, log_probs = (rng.standard_normal((N, S)).astype(np.float32)
                                  for _ in range(3))
    mask = (rng.random((N, S)) < 0.6).astype(np.float32)
    mask[0] = 0.0  # a row with no valid step
    want = jlosses.a2c_losses(*(jnp.asarray(x) for x in (values, rewards, log_probs)),
                              step_mask=jnp.asarray(mask), per_step_mean=per_step_mean)
    got = tlosses.a2c_losses(*(torch.from_numpy(x) for x in (values, rewards, log_probs)),
                             step_mask=torch.from_numpy(mask), per_step_mean=per_step_mean)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    # Q7: the actor term's gradient reaches the values (no stop-gradient)
    v = torch.from_numpy(values).requires_grad_()
    actor, _ = tlosses.a2c_losses(v, torch.from_numpy(rewards), torch.from_numpy(log_probs),
                                  step_mask=torch.from_numpy(mask), per_step_mean=per_step_mean)
    (dv,) = torch.autograd.grad(actor, v)
    assert float(dv.abs().sum()) > 0


LR = 1e-3


@pytest.mark.parametrize("per_step_mean,currs", [(False, (1, 1, 1)), (True, (3, 5, 2))],
                         ids=["plain", "curriculum"])
def test_three_a2c_adam_steps_match_jax(per_step_mean, currs):
    jp, jr = _nets()
    tx = joptim.adam(LR, jp, JCFG.freeze_embeddings)
    opt_state = tx.init(jp)
    jstep = jsteps.make_a2c_step(JCFG, tx, per_step_mean=per_step_mean)
    tp, tr = _port(jp), _port(jr)
    tstep = tsteps.make_a2c_step(TCFG, adam(LR, tp), per_step_mean=per_step_mean)
    key, tkey = jax.random.PRNGKey(KEY_SEED), prng.PRNGKey(KEY_SEED)
    want_losses, losses = [], []
    for i, curr in enumerate(currs):
        feats, caps = _batch(10 + i)
        key, sub = jax.random.split(key)
        tkey, tsub = prng.split(tkey)
        jp, opt_state, jstats = jstep(jp, opt_state, jr, jnp.asarray(feats), jnp.asarray(caps),
                                      jnp.int32(curr), sub)
        stats = tstep(tp, tr, torch.from_numpy(feats), torch.from_numpy(caps).long(), curr, tsub)
        want_losses.append(float(jstats.loss))
        losses.append(float(stats.loss))
        assert not stats.loss.requires_grad
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = dict(_named(jp))
    for name, leaf in _named(tp):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(want[name]), rtol=0,
                                   atol=2e-5, err_msg=name)


def test_rollout_wrappers_reject_bad_inputs():
    jp, jr = _nets()
    tp, tr = _port(jp), _port(jr)
    feats, caps = _batch(0)
    f, c = torch.from_numpy(feats), torch.from_numpy(caps).long()
    key = prng.PRNGKey(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfr.fused_rollout(tp, TCFG, f, c, 1, key, use_fused_kernel=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfr.fused_reward_stream(tr, TCFG, f, c[:, 0], c[:, 1:], c[:, 1:], use_fused_kernel=True)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tfr.fused_rollout(tp, TCFG, f, c, 1, key, weight_dtype=torch.float16)
    narrow = {**tp, "value": {**tp["value"], "embedding": tp["value"]["embedding"][:, :8]}}
    with pytest.raises(ValueError, match="matching embedding/hidden"):
        tfr.fused_rollout(narrow, TCFG, f, c, 1, key)
    with pytest.raises(ValueError, match="reward net matching"):
        tfr.fused_rollout(tp, TCFG, f, c, 1, key,
                          reward_params={**tr, "embedding": tr["embedding"][:, :8]})
