"""The rollout's two tape options against the JAX package's kernel.

``tape_gates=False`` (no gate tape: the backward recomputes the gates from
the h tape) and ``tape_dtype=bfloat16`` (h, c and the gates stored in bf16)
through the port's plain rollout, against the JAX package's Pallas kernels
in interpret mode (``block_n=8``), at a small width: N = 8, E = H = F = 16,
V = 20, T = 17 (S = 16 steps). Weights come from the JAX initialisers
(``from_jax_params``), features and captions from a seeded numpy generator,
keys from ``jax.random.PRNGKey`` (the port makes the same noise,
``test_torch_prng.py``).

Tolerances, float32 weights, as ``tests/test_pallas_rollout.py`` holds the
JAX kernel's variants against its XLA rollout: the loss to rel 1e-6, every
gradient to rtol 1e-5, atol 1e-6, the actions exactly (the bf16 tape's test
differentiates a signed sum of the values and log-probs instead of the loss,
and holds that sum to rel 1e-5, as each term is held). The bf16 tape keeps
them: both sides round h, c and the gates to bf16 at the same points (the
tape store) and read them back as float32; c_new is formed from the rounded
gates and c on both sides, and with float32 weights v1 from the rounded h_v.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import config as jconfig
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu.models import reward as jreward
from image_captioning_through_rl_tpu.ops.pallas_rollout import fused_rollout as jrollout
from image_captioning_through_rl_tpu.train import steps as jsteps
from image_captioning_through_rl_tpu_torch import config as tconfig
from image_captioning_through_rl_tpu_torch.models.convert import from_jax_params
from image_captioning_through_rl_tpu_torch.ops import fused_rollout as tfr
from image_captioning_through_rl_tpu_torch.ops import prng
from image_captioning_through_rl_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

KW = dict(vocab_size=20, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=17)
N = 8
S = KW["max_seq_len"] - 1
JCFG = jconfig.NetConfig(precision="highest", **KW)
TCFG = tconfig.NetConfig(**KW)
KEY_SEED = 5
LOSS_REL, GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-5, 1e-6


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    caps = rng.integers(4, KW["vocab_size"], size=(N, KW["max_seq_len"])).astype(np.int32)
    caps[:, 0] = 1
    caps[:, -1] = 2
    feats = rng.standard_normal((N, KW["input_dim"])).astype(np.float32)
    return feats, caps


@functools.lru_cache(maxsize=None)
def _nets():
    return ja2c.init(jax.random.PRNGKey(0), JCFG), jreward.init(jax.random.PRNGKey(1), JCFG)


def _port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree))


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
    loss, aux = loss_fn(tp)
    return float(loss.detach()), aux, dict(zip(names, torch.autograd.grad(loss, leaves)))


def _jax_loss_and_grads(loss_fn):
    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(_nets()[0])
    return float(loss), aux, dict(_named(grads))


def _check(loss, grads, jloss, jgrads, what, loss_rel=LOSS_REL):
    assert loss == pytest.approx(jloss, rel=loss_rel), what
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[name]), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{what}: {name}")


def _loss_pair(curr, per_step_mean, **kw):
    _, jr = _nets()
    feats, caps = _batch()
    jloss, jstats, jgrads = _jax_loss_and_grads(lambda p: jsteps.a2c_rollout_loss_fused(
        p, JCFG, jr, jnp.asarray(feats), jnp.asarray(caps), jnp.int32(curr),
        jnp.int32(KW["max_seq_len"]), jax.random.PRNGKey(KEY_SEED), per_step_mean=per_step_mean,
        block_n=8, weight_dtype=jnp.float32, interpret=True, **kw))
    loss, stats, grads = _port_loss_and_grads(lambda p: tsteps.a2c_rollout_loss_fused(
        p, TCFG, _port(jr), torch.from_numpy(feats), torch.from_numpy(caps).long(), curr,
        KW["max_seq_len"], prng.PRNGKey(KEY_SEED), per_step_mean=per_step_mean,
        weight_dtype=torch.float32, **kw))
    return (loss, stats, grads), (jloss, jstats, jgrads)


@pytest.mark.parametrize("fuse_reward,tape_gates",
                         list(itertools.product((False, True), repeat=2)))
def test_a2c_loss_fused_tape_gates_matches_jax(fuse_reward, tape_gates):
    (loss, _, grads), (jloss, _, jgrads) = _loss_pair(1, False, fuse_reward=fuse_reward,
                                                      tape_gates=tape_gates)
    _check(loss, grads, jloss, jgrads, f"fuse_reward={fuse_reward} tape_gates={tape_gates}")


def test_tape_gates_false_curriculum_teacher_branch():
    """The curriculum prefix (curr = T // 2) places the teacher's tokens; the
    recomputed gates read them, as in ``test_rollout_variants_curriculum_
    teacher_branch``."""
    curr = KW["max_seq_len"] // 2
    (loss, stats, grads), (jloss, jstats, jgrads) = _loss_pair(
        curr, True, fuse_reward=True, tape_gates=False)
    _check(loss, grads, jloss, jgrads, "curriculum, tape_gates=False")
    np.testing.assert_allclose(float(stats.mean_reward), float(jstats.mean_reward), rtol=1e-6)


def _cotangents():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((N, S)).astype(np.float32),
            rng.standard_normal((N, S)).astype(np.float32))


@pytest.mark.parametrize("tape_gates", [True, False])
def test_bf16_tape_matches_jax(tape_gates):
    """``fused_rollout(tape_dtype=bfloat16)``: values, log-probs, actions,
    tokens and rewards, and the gradients of a fixed linear function of the
    values and log-probs, against the JAX kernel's bf16 tape."""
    _, jr = _nets()
    feats, caps = _batch(1)
    cv, cl = _cotangents()

    def jloss(p):
        out = jrollout(p, JCFG, jnp.asarray(feats), jnp.asarray(caps), jnp.int32(3),
                       jax.random.PRNGKey(KEY_SEED), block_n=8, weight_dtype=jnp.float32,
                       interpret=True, tape_dtype=jnp.bfloat16, reward_params=jr,
                       tape_gates=tape_gates)
        return jnp.sum(out[0] * cv) + jnp.sum(out[1] * cl), out

    def tloss(p):
        out = tfr.fused_rollout(p, TCFG, torch.from_numpy(feats), torch.from_numpy(caps).long(),
                                3, prng.PRNGKey(KEY_SEED), weight_dtype=torch.float32,
                                reward_params=_port(jr), tape_gates=tape_gates,
                                tape_dtype=torch.bfloat16)
        return (torch.sum(out[0] * torch.from_numpy(cv))
                + torch.sum(out[1] * torch.from_numpy(cl))), out

    want_loss, want, want_grads = _jax_loss_and_grads(jloss)
    loss, got, grads = _port_loss_and_grads(tloss)
    for name, a, b in zip(("values", "log_probs", "actions", "tokens", "rewards"), got, want):
        a, b = a.detach().numpy(), np.asarray(b)
        if name in ("actions", "tokens"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
    # the function is a signed sum of 2 S N outputs, each held to rtol 1e-5
    # above: its value is not the A2C loss the 1e-6 bound is for
    _check(loss, grads, want_loss, want_grads, f"bf16 tape, tape_gates={tape_gates}",
           loss_rel=1e-5)


def _forward_args(wd=torch.float32, curr=3):
    jp, jr = _nets()
    feats, caps = _batch(2)
    f, c = torch.from_numpy(feats), torch.from_numpy(caps).long()
    tp = _port(jp)
    with torch.no_grad():
        states = tfr.start_states(tp, TCFG, f, c[:, 0])
    noise = prng.gumbel_noise(prng.split(prng.PRNGKey(KEY_SEED), S), (N, KW["vocab_size"]),
                              f.device)
    rw = tfr.prepare_reward_weights(_port(jr), f, c[:, 0], wd)
    return (curr, c[:, 1:].t().to(torch.int32).contiguous(), noise, rw, f, *states,
            tfr.prepare_rollout_weights(tp, wd))


@pytest.mark.parametrize("tape_dtype", [torch.float32, torch.bfloat16])
def test_tape_layout(tape_dtype):
    """No gate tape without ``tape_gates``; the tape in its type; the
    forward's outputs do not depend on the tape's options."""
    args = _forward_args()
    base = tfr.rollout_forward_plain(*args)
    for tape_gates in (True, False):
        values, logp, rewards, tape = tfr.rollout_forward_plain(
            *args, tape_gates=tape_gates, tape_dtype=tape_dtype)
        assert (tape.gp is None) == (tape.gv is None) == (not tape_gates)
        for name in ("hp", "cp", "hv", "cv") + (("gp", "gv") if tape_gates else ()):
            assert getattr(tape, name).dtype == tape_dtype, name
        assert tape.v1.dtype == torch.float32
        for a, b in zip((values, logp, rewards, tape.act, tape.tok),
                        (*base[:3], base[3].act, base[3].tok)):
            assert torch.equal(a, b)
        if tape_dtype == torch.bfloat16:
            assert torch.equal(tape.hp, base[3].hp.to(torch.bfloat16))


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_recomputed_gates_equal_the_gate_tape(wd):
    """On the plain path the recomputed gates are the forward's own
    arithmetic on the same float32 tape, so the backward's gradients are the
    gate tape's bit for bit."""
    args = _forward_args(wd)
    gen = torch.Generator().manual_seed(3)
    dval, dlogp = (torch.randn((S, N), generator=gen) for _ in range(2))
    feats, w = args[4], args[-1]
    want = tfr.rollout_backward_plain(tfr.rollout_forward_plain(*args)[3], feats, w, dval, dlogp)
    tape = tfr.rollout_forward_plain(*args, tape_gates=False)[3]
    got = tfr.rollout_backward_plain(tape, feats, w, dval, dlogp)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_recompute_blocks_cover_the_advances():
    """The card's recompute blocks (``csrc/rollout.cu``): the S - 1 advances
    in at most RECOMPUTE_BLOCKS blocks, last first, each of at most
    ``recompute_block_steps`` steps."""
    for steps in (1, 2, 3, 9, 16, 17, 33):
        block = tfr.recompute_block_steps(steps)
        blocks = tfr.recompute_blocks(steps)
        assert len(blocks) <= tfr.RECOMPUTE_BLOCKS
        covered = [t for lo, hi in blocks for t in range(lo, hi)]
        assert sorted(covered) == list(range(steps - 1))
        assert all(0 < hi - lo <= block for lo, hi in blocks)
        assert [hi for _, hi in blocks] == sorted((hi for _, hi in blocks), reverse=True)


def test_tape_options_refused_where_unsupported():
    args = _forward_args()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfr.rollout_forward_plain(*args, tape_dtype=torch.float16)
    jp, _ = _nets()
    feats, caps = _batch()
    with pytest.raises(RuntimeError, match="CUDA"):
        tfr.fused_rollout(_port(jp), TCFG, torch.from_numpy(feats), torch.from_numpy(caps).long(),
                          1, prng.PRNGKey(0), tape_gates=False, use_fused_kernel=True)
    # the card's backward takes the options with bf16 weights only
    tape = tfr.rollout_forward_plain(*args, tape_gates=False)[3]
    zeros = torch.zeros((S, N))
    with pytest.raises(ValueError, match="bfloat16 weights only"):
        tfr.rollout_backward_kernel(tape, args[4], args[-1], zeros, zeros)
