"""Training steps (counterpart of the JAX ``train/steps.py``).

  * reward — VSE ranking loss (reference trainers.py:260-309);
  * policy — caption-length-weighted XE (trainers.py:202-257);
  * value — MSE against the embedding reward of a greedy rollout of the
    frozen policy, on a random-length prefix (trainers.py:125-199);
  * A2C — the actor-critic update on sampled rollouts, plain and
    curriculum (trainers.py:402-616).

Each ``*_loss`` is the plain form: eager autograd over the port's models
(the JAX package's XLA step). Each ``*_loss_fused`` puts the recurrent
chain through :func:`..ops.fused_lstm.fused_lstm_chain` or
:func:`..ops.fused_gru.fused_gru_chain` (the kernels on CUDA tensors, their
plain versions on CPU tensors); what the JAX package left to XLA stays
plain torch: the vocab head, the XE loss, the ``cnn2linear`` ``h0``
product, the embedding-pair projections and the VSE loss.

The A2C rollout's fused form, :func:`a2c_rollout_loss_fused`, runs through
:func:`..ops.fused_rollout.fused_rollout` (the rollout kernels on CUDA
tensors, their plain versions on CPU tensors), with the reward stream fused
in by default.

Bidirectional networks take the plain forms, as in the JAX package, whose
fused steps refuse them: the value step regresses the value of the greedy
rollout's prefix re-encoded (:func:`value_regression_loss`), and A2C runs
:func:`a2c_rollout_loss_full`, which re-runs the three forwards on the
growing prefix. ``compat=True`` selects the reference's batch-as-time
value and reward encoders (quirk Q1, ``forward_compat``) with their
carries reset per minibatch, where the reference calls ``init_hidden()``:
the compat reward and value steps, and :func:`a2c_rollout_loss_compat`,
whose carries thread through all S rollout steps. ``fused=True`` with a
bidirectional config or ``compat=True`` raises ``ValueError``.

A step built by ``make_*_step`` runs one minibatch — loss, backward, one
optimiser step that updates the parameter tensors in place — and returns
the loss (the A2C step: its :class:`RolloutStats`) as detached 0-d tensors
(no device sync).

Data parallelism, rank by rank: a step given a ``shard``
(:class:`..parallel.collectives.RowShard`, this rank's rows ``[lo, hi)``
of a global minibatch of ``n``) computes its rows' loss and gradient and
sums them over the ranks in one flattened ``all_reduce`` before the
optimiser step (:func:`..parallel.collectives.reduce_gradients`), so every
rank takes the step the single-device program takes on the whole minibatch.
The policy, value and A2C losses are means over rows (the A2C step mask is
the same for every row: it depends on the global ``curr_seq_len`` and
``caplen`` only), so with equal shards the mean of the rank means is the
global mean: their reduction divides by the ranks. The reward network's VSE
loss couples every row through its similarity matrix: each rank gathers
both embeddings (the gradient flows back to the owning rank) and takes its
rows of both directions with the global margin and divisor
(:func:`..ops.losses.visual_semantic_embedding_loss_rows`); the parts sum
to the loss. The rollout's noise is drawn at ``row0 = lo``, and its
``caplen`` is the global minibatch's (``caplen=``, from the host, where every
rank holds the global minibatch). Without a shard (one device, or a ragged
minibatch that every rank computes whole) a step runs no gradient
collective. The compat (Q1) steps treat the batch as time and take no shard.

Tensor parallelism over the vocabulary: every step also runs on a
vocab-sharded tree (:func:`..parallel.sharding.shard_params`), the
embedding lookups, the policy head, the XE, A2C's log-softmax and its
Gumbel-max pick vocab-parallel (:mod:`..parallel.tensor_parallel`; the
shard's gradient reduction then runs over the ``data`` group only). The
fused pretrainer steps gather each embedding table over ``model`` before
the chain kernels, which read rows by token inside the launch; the value
step's frozen networks are gathered once, when the step is made. The fused
rollout (kernel 6) picks each step's token over the whole vocabulary
inside one launch, where no cross-rank combine fits: on a vocab-sharded
tree it raises, and the plain rollout runs, as the JAX package turns its
Pallas kernels off on a mesh. Its noise is drawn at the rank's first row
(``row0``) and first column (``col0``) of the global draw.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import END_ID
from ..config import NetConfig
from ..decode.greedy import greedy_decode
from ..models import a2c as a2c_mod
from ..models import policy as policy_mod
from ..models import reward as reward_mod
from ..models import value as value_mod
from ..ops.fused_decode import fused_greedy_decode, prepare_greedy_weights
from ..ops.fused_gru import fused_gru_chain
from ..ops.fused_lstm import fused_lstm_chain
from ..ops.fused_rollout import fused_reward_stream, fused_rollout
from ..ops.linalg import dense
from ..ops.losses import (a2c_losses, visual_semantic_embedding_loss,
                          visual_semantic_embedding_loss_rows, weighted_caption_xe_loss,
                          weighted_caption_xe_of)
from ..ops.prng import split
from ..ops.reward_ops import cosine_embedding_reward
from ..ops.rnn import lstm_cell, lstm_scan
from ..ops.sampling import sample_categorical  # noqa: F401 (tp.sample's draw on a whole tree)
from ..parallel import collectives
from ..parallel import tensor_parallel as tp
from ..parallel.collectives import RowShard, gather_rows, reduce_gradients
from ..parallel.sharding import gather_params


def batch_caption_lens(captions: torch.Tensor) -> torch.Tensor:
    """END position + 1 per row (cf. trainers.py:241)."""
    return torch.argmax((captions == END_ID).to(torch.int32), dim=1) + 1


def _train_step(optimizer: torch.optim.Optimizer, loss_fn, before_step=None,
                shard: RowShard | None = None, mean: bool = True):
    """One minibatch: zero the gradients, loss, backward, with a ``shard``
    the gradients and the loss reduced over the ranks (divided by them for a
    ``mean`` loss), ``before_step(loss)`` (the chunks' best-loss
    bookkeeping, while the weights still enter the minibatch), optimiser
    step."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    loss = loss.detach()
    if shard is not None:
        loss, = reduce_gradients(optimizer, [loss], shard, mean)
    if before_step is not None:
        before_step(loss)
    optimizer.step()
    return loss


# --------------------------------------------------------------------------
# Reward network (VSE loss)
# --------------------------------------------------------------------------

def _vse(ve, se, beta, shard: RowShard | None):
    if shard is None:
        return visual_semantic_embedding_loss(ve, se, beta=beta)
    return visual_semantic_embedding_loss_rows(ve, se, gather_rows(ve, shard),
                                               gather_rows(se, shard), shard.lo, beta)


def reward_loss(params, cfg: NetConfig, features, captions, beta=0.2, compat: bool = False,
                shard: RowShard | None = None):
    """The VSE loss; ``compat=True`` encodes with the batch-as-time GRU from
    a zero carry (the reference resets it after every minibatch,
    trainers.py:307). With ``shard``, this rank's part of the global loss."""
    if compat:
        if shard is not None:
            raise ValueError("the compat reward step treats the batch as time: it takes no shard")
        (ve, se), _ = reward_mod.forward_compat(params, cfg, features, captions,
                                                reward_mod.compat_zero_state(cfg, features.device))
    else:
        ve, se = reward_mod.forward(params, cfg, features, captions)
    return _vse(ve, se, beta, shard)


def reward_loss_fused(params, cfg: NetConfig, features, captions, beta=0.2,
                      weight_dtype=torch.bfloat16, shard: RowShard | None = None):
    """:func:`reward_loss` with the GRU chain through the chain kernels."""
    h0 = torch.zeros((captions.shape[0], cfg.hidden_dim), dtype=torch.float32,
                     device=features.device)
    hs = fused_gru_chain(params["gru"], tp.table(params), captions, h0,
                         weight_dtype=weight_dtype)
    ve, se = reward_mod.embed_pair(params, cfg, features, hs[:, -1])
    return _vse(ve, se, beta, shard)


def make_reward_step(cfg: NetConfig, optimizer: torch.optim.Optimizer, beta=0.2,
                     compat: bool = False, fused: bool = False):
    """``step(params, features, captions, shard=None) -> loss``;
    ``compat=True`` the batch-as-time encoder (Q1); ``fused=True`` runs the
    GRU chain through its kernels (unidirectional, non-compat only). With a
    ``shard`` the rank's parts of the loss and gradient are summed over the
    ranks."""
    if fused and (compat or cfg.bidirectional):
        raise ValueError("fused reward step is unidirectional, non-compat only")
    loss_fn = reward_loss_fused if fused else functools.partial(reward_loss, compat=compat)

    def step(params, features, captions, shard=None):
        return _train_step(optimizer, lambda: loss_fn(params, cfg, features, captions, beta=beta,
                                                      shard=shard), shard=shard, mean=False)

    return step


# --------------------------------------------------------------------------
# Policy network (teacher-forced XE)
# --------------------------------------------------------------------------

def _caption_xe(params, logits, targets, caplens):
    """The caption XE of the policy's logits (a vocab-sharded head's
    columns: vocab-parallel)."""
    vs = tp.vocab_of(params, "head")
    if vs is None:
        return weighted_caption_xe_loss(logits, targets, caplens)
    return weighted_caption_xe_of(tp.log_prob(logits, targets, vs), caplens)


def policy_loss(params, cfg: NetConfig, features, captions, caplens):
    logits = policy_mod.forward(params, cfg, features, captions[:, :-1])
    return _caption_xe(params, logits, captions[:, 1:], caplens)


def policy_loss_fused(params, cfg: NetConfig, features, captions, caplens,
                      weight_dtype=torch.bfloat16):
    """:func:`policy_loss` with the LSTM chain through the chain kernels;
    the vocab head and the XE loss stay single large products over the
    N T rows."""
    h0 = dense(features, params["cnn2linear"])
    hs = fused_lstm_chain(params["lstm"], tp.table(params), captions[:, :-1], h0,
                          torch.zeros_like(h0), weight_dtype=weight_dtype)
    logits = tp.head(params, hs)
    return _caption_xe(params, logits, captions[:, 1:], caplens)


def make_policy_step(cfg: NetConfig, optimizer: torch.optim.Optimizer, fused: bool = False):
    """``step(params, features, captions, shard=None) -> loss``;
    ``fused=True`` runs the LSTM chain through its kernels (unidirectional
    only). A ``shard``'s loss and gradient are averaged over the ranks."""
    if fused and cfg.bidirectional:
        raise ValueError("fused policy step is unidirectional only")
    loss_fn = policy_loss_fused if fused else policy_loss

    def step(params, features, captions, shard=None):
        caplens = batch_caption_lens(captions)
        return _train_step(optimizer,
                           lambda: loss_fn(params, cfg, features, captions, caplens),
                           shard=shard)

    return step


# --------------------------------------------------------------------------
# Value network (MSE vs the embedding reward of greedy rollouts)
# --------------------------------------------------------------------------

def value_rollout_rewards(cfg: NetConfig, pparams, rparams, features, captions,
                          fused: bool = False, greedy_weights=None):
    """The value trainer's targets, with no gradient: the greedy rollout of
    the frozen policy from ``captions[:, 0]`` (``[N, T]`` int64) and its
    embedding reward under the frozen reward network (``[N, 1]``).
    ``fused=True`` decodes with the greedy kernel on ``greedy_weights``
    (:func:`..ops.fused_decode.prepare_greedy_weights`, bf16 by default);
    the reward forward stays eager float32, as in the JAX package
    (``steps.py:300``)."""
    with torch.no_grad():
        start = captions[:, 0]
        if fused:
            gen_caps = fused_greedy_decode(greedy_weights, features.contiguous(),
                                           start.to(torch.int32).contiguous(),
                                           cfg.max_seq_len).long()
        else:
            gen_caps = greedy_decode(pparams, cfg, features, start).long()
        ve, se = reward_mod.forward(rparams, cfg, features, gen_caps)
        return gen_caps, cosine_embedding_reward(ve, se)[:, None]


def value_regression_loss(vparams, cfg: NetConfig, features, gen_caps, rewards,
                          prefix_len: int, fused: bool = False, weight_dtype=torch.bfloat16):
    """MSE of the value of the rollout's prefix of length ``prefix_len``
    (shared by the batch, trainers.py:177) against ``rewards``. The encoder
    runs over the whole rollout and the value reads its state at
    ``prefix_len - 1``; ``fused=True`` runs it through the LSTM chain
    kernels. A bidirectional critic encodes ``gen_caps[:, :prefix_len]``
    itself (its backward direction starts at the prefix's end), as the JAX
    package's ``steps.py:352-373`` does."""
    if cfg.bidirectional:
        values = value_mod.forward(vparams, cfg, features, gen_caps[:, :prefix_len])
        return torch.mean(torch.square(values - rewards))
    n = gen_caps.shape[0]
    zeros = torch.zeros((n, cfg.hidden_dim), dtype=torch.float32, device=features.device)
    if fused:
        hs = fused_lstm_chain(vparams["lstm"], tp.table(vparams), gen_caps, zeros, zeros,
                              weight_dtype=weight_dtype)
        h = hs[:, prefix_len - 1]
    else:
        xs = tp.lookup(vparams, gen_caps).transpose(0, 1)  # [T, N, E]
        hs, _ = lstm_scan(vparams["lstm"], xs, (zeros, zeros))
        h = hs[prefix_len - 1]
    values = value_mod.value_head(vparams, cfg, features, h)  # [N, 1]
    return torch.mean(torch.square(values - rewards))


def value_episode_loss(vparams, cfg: NetConfig, pparams, rparams, features, captions,
                       prefix_len: int, fused: bool = False, greedy_weights=None,
                       weight_dtype=torch.bfloat16):
    """The value trainer's per-minibatch loss (trainers.py:125-199):
    :func:`value_rollout_rewards` then :func:`value_regression_loss`."""
    gen_caps, rewards = value_rollout_rewards(cfg, pparams, rparams, features, captions,
                                              fused=fused, greedy_weights=greedy_weights)
    return value_regression_loss(vparams, cfg, features, gen_caps, rewards, prefix_len,
                                 fused=fused, weight_dtype=weight_dtype)


def value_compat_loss(vparams, cfg: NetConfig, pparams, rparams, features, captions,
                      prefix_len: int):
    """The compat value step's loss (the JAX ``steps.py:238-258``): the
    frozen policy's plain greedy rollout, its reward under the batch-as-time
    reward GRU, and the batch-as-time critic's value of the rollout's prefix
    of length ``prefix_len``, both encoders from a zero carry (reset per
    minibatch, trainers.py:196-197)."""
    with torch.no_grad():
        gen_caps = greedy_decode(pparams, cfg, features, captions[:, 0]).long()
        (ve, se), _ = reward_mod.forward_compat(rparams, cfg, features, gen_caps,
                                                reward_mod.compat_zero_state(cfg, features.device))
        rewards = cosine_embedding_reward(ve, se)[:, None]
    values, _ = value_mod.forward_compat(vparams, cfg, features, gen_caps[:, :prefix_len],
                                         value_mod.compat_zero_state(cfg, features.device))
    return torch.mean(torch.square(values - rewards))


def make_value_step(cfg: NetConfig, optimizer: torch.optim.Optimizer, pparams: dict,
                    rparams: dict, compat: bool = False, fused: bool = False):
    """``step(vparams, features, captions, prefix_len, shard=None) -> loss``
    against the frozen policy ``pparams`` and reward network ``rparams``
    (loaded, not trained: trainers.py:140-150). ``compat=True`` takes
    :func:`value_compat_loss` (Q1). ``fused=True`` prepares the policy's
    bf16 greedy-kernel weights once, here, and runs the rollout and the
    value encoder through their kernels (unidirectional, non-compat only).
    A ``shard``'s loss and gradient are averaged over the ranks (the
    prefix length is the host's, the same on every rank). Vocab-sharded
    frozen networks are gathered here, once (a collective)."""
    if fused and (compat or cfg.bidirectional):
        raise ValueError("fused value step is unidirectional, non-compat only")
    pparams, rparams = gather_params(pparams), gather_params(rparams)
    if compat:
        def compat_step(vparams, features, captions, prefix_len, shard=None):
            if shard is not None:
                raise ValueError("the compat value step treats the batch as time: it takes "
                                 "no shard")
            return _train_step(optimizer, lambda: value_compat_loss(
                vparams, cfg, pparams, rparams, features, captions, prefix_len))

        return compat_step
    greedy_weights = prepare_greedy_weights(pparams) if fused else None

    def step(vparams, features, captions, prefix_len, shard=None):
        return _train_step(optimizer, lambda: value_episode_loss(
            vparams, cfg, pparams, rparams, features, captions, prefix_len, fused=fused,
            greedy_weights=greedy_weights), shard=shard)

    return step


# --------------------------------------------------------------------------
# A2C (joint actor-critic on sampled rollouts)
# --------------------------------------------------------------------------

class RolloutStats(NamedTuple):
    loss: torch.Tensor
    actor_loss: torch.Tensor
    critic_loss: torch.Tensor
    mean_reward: torch.Tensor
    mean_advantage: torch.Tensor


def _a2c_loss(values, rewards, log_probs, curr_seq_len, caplen, per_step_mean):
    """The A2C loss of ``[N, S]`` rollout stacks over the valid placed
    positions ``curr_seq_len <= p <= caplen - 1`` (p = 1 .. S), and its
    stats."""
    p_idx = torch.arange(1, values.shape[1] + 1, device=values.device)[None, :]
    mask = ((p_idx >= curr_seq_len) & (p_idx <= caplen - 1)).to(values.dtype).expand_as(values)
    actor, critic = a2c_losses(values, rewards, log_probs, step_mask=mask,
                               per_step_mean=per_step_mean)
    loss = actor + critic
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    return loss, RolloutStats(loss=loss, actor_loss=actor, critic_loss=critic,
                              mean_reward=torch.sum(rewards * mask) / denom,
                              mean_advantage=torch.sum((values - rewards) * mask) / denom)


def a2c_rollout_loss(a2c_params: dict, cfg: NetConfig, reward_params: dict, features,
                     captions, curr_seq_len: int, caplen, rng, per_step_mean: bool = False,
                     row0: int = 0):
    """Loss of one A2C episode batch as an eager scan (the JAX package's XLA
    rollout, ``steps.py:509-610``) -> ``(loss, RolloutStats)``.

    Plain A2C is ``curr_seq_len = 1``: roll out from the start column;
    the curriculum teacher-forces positions ``p < curr_seq_len``. Per step:
    the critic's value of the current prefix, an action drawn from the
    policy's last-step logits under the step's key (``split(rng, S)``,
    :func:`..ops.sampling.sample_categorical`, JAX's draws), its log-prob,
    the frozen reward of the prefix plus the action (no gradient, Q7), then
    every encoder advances with the placed token. ``caplen``: the batch's
    largest END position + 1. ``row0``: the rows are ``[row0, row0 + N)`` of
    a global minibatch, and draw those rows of its noise."""
    pparams, vparams = a2c_params["policy"], a2c_params["value"]
    vs = tp.vocab_of(pparams, "head")
    n, t_max = captions.shape
    dev = features.device
    start = captions[:, 0]
    pol_state = policy_mod.init_decode_state(pparams, cfg, features)
    pol_state = lstm_cell(pparams["lstm"], tp.lookup(pparams, start), pol_state)
    val_state = value_mod.rnn_step(vparams, cfg, start, value_mod.zero_rnn_state(cfg, n, dev))
    with torch.no_grad():
        rew_state = reward_mod.rnn_step(reward_params, cfg, start,
                                        reward_mod.zero_rnn_state(cfg, n, dev))
        ve = dense(features, reward_params["visual_embed"])
    step_keys = split(rng, t_max - 1)
    values, rewards, log_probs = [], [], []
    for p in range(1, t_max):
        logits = tp.head(pparams, pol_state[0])
        action = tp.sample(step_keys[p - 1], logits.detach(), vs, row0)
        log_probs.append(tp.log_prob(logits, action, vs))
        values.append(value_mod.value_from_state(vparams, cfg, features, val_state)[:, 0])
        token_in = captions[:, p] if p < curr_seq_len else action
        with torch.no_grad():
            rew_after = reward_mod.rnn_step(reward_params, cfg, action, rew_state)
            se = dense(rew_after, reward_params["semantic_embed"])
            rewards.append(cosine_embedding_reward(ve, se))
            rew_state = reward_mod.rnn_step(reward_params, cfg, token_in, rew_state)
        pol_state = lstm_cell(pparams["lstm"], tp.lookup(pparams, token_in), pol_state)
        val_state = value_mod.rnn_step(vparams, cfg, token_in, val_state)
    return _a2c_loss(torch.stack(values, dim=1), torch.stack(rewards, dim=1),
                     torch.stack(log_probs, dim=1), curr_seq_len, caplen, per_step_mean)


def a2c_rollout_loss_full(a2c_params: dict, cfg: NetConfig, reward_params: dict, features,
                          captions, curr_seq_len: int, caplen, rng,
                          per_step_mean: bool = False, row0: int = 0):
    """The full-prefix rollout loss (the JAX package's ``steps.py:613-660``),
    the one a bidirectional A2C step takes: its encoders' backward halves
    have no carried state, so each step re-runs the policy, value and
    reward forwards on the growing prefix, as the reference does
    (trainers.py:441-459). The same step keys, draws, placed tokens, loss
    and mask as :func:`a2c_rollout_loss`."""
    t_max = captions.shape[1]
    vs = tp.vocab_of(a2c_params["policy"], "head")
    step_keys = split(rng, t_max - 1)
    buf = captions[:, :1]
    values, rewards, log_probs = [], [], []
    for p in range(1, t_max):
        value, logits = a2c_mod.forward(a2c_params, cfg, features, buf)
        action = tp.sample(step_keys[p - 1], logits.detach(), vs, row0)
        log_probs.append(tp.log_prob(logits, action, vs))
        values.append(value[:, 0])
        with torch.no_grad():  # the reward of prefix + the sampled action
            ve, se = reward_mod.forward(reward_params, cfg, features,
                                        torch.cat([buf, action[:, None]], dim=1))
            rewards.append(cosine_embedding_reward(ve, se))
        token_in = captions[:, p] if p < curr_seq_len else action
        buf = torch.cat([buf, token_in[:, None]], dim=1)
    return _a2c_loss(torch.stack(values, dim=1), torch.stack(rewards, dim=1),
                     torch.stack(log_probs, dim=1), curr_seq_len, caplen, per_step_mean)


def a2c_rollout_loss_compat(a2c_params: dict, cfg: NetConfig, reward_params: dict, features,
                            captions, curr_seq_len: int, caplen, rng,
                            per_step_mean: bool = False, row0: int = 0):
    """The reference-exact rollout loss with batch-as-time statefulness
    (quirk Q1; the JAX ``steps.py:678-746``): the value LSTM's and the
    reward GRU's carries start at zero and thread through every forward of
    the minibatch's S steps (the reference resets them at minibatch end,
    trainers.py:495-496), each forward re-reading the growing prefix; the
    policy re-runs its forward on the prefix. The same step keys, draws,
    placed tokens, loss and mask as :func:`a2c_rollout_loss_full`; the
    reward under ``no_grad``."""
    pparams, vparams = a2c_params["policy"], a2c_params["value"]
    vs = tp.vocab_of(pparams, "head")
    t_max = captions.shape[1]
    dev = features.device
    step_keys = split(rng, t_max - 1)
    val_carry = value_mod.compat_zero_state(cfg, dev)
    rew_carry = reward_mod.compat_zero_state(cfg, dev)
    buf = captions[:, :1]
    values, rewards, log_probs = [], [], []
    for p in range(1, t_max):
        value, val_carry = value_mod.forward_compat(vparams, cfg, features, buf, val_carry)
        logits = policy_mod.forward(pparams, cfg, features, buf)[:, -1]
        action = tp.sample(step_keys[p - 1], logits.detach(), vs, row0)
        log_probs.append(tp.log_prob(logits, action, vs))
        values.append(value[:, 0])
        with torch.no_grad():  # the reward of prefix + the sampled action
            (ve, se), rew_carry = reward_mod.forward_compat(
                reward_params, cfg, features, torch.cat([buf, action[:, None]], dim=1),
                rew_carry)
            rewards.append(cosine_embedding_reward(ve, se))
        token_in = captions[:, p] if p < curr_seq_len else action
        buf = torch.cat([buf, token_in[:, None]], dim=1)
    return _a2c_loss(torch.stack(values, dim=1), torch.stack(rewards, dim=1),
                     torch.stack(log_probs, dim=1), curr_seq_len, caplen, per_step_mean)


def check_fused_rollout(a2c_params: dict, reward_params: dict) -> None:
    """Raise ``ValueError`` for vocab-sharded networks: the rollout kernels
    pick each step's token over the whole vocabulary inside one launch, and
    no cross-rank combine fits there."""
    trees = (a2c_params["policy"], a2c_params["value"], reward_params)
    if any(getattr(t, "vocab", None) is not None for t in trees):
        raise ValueError("the fused rollout (kernel 6) picks each step's token over the whole "
                         "vocabulary inside one launch, where no cross-rank combine fits: a "
                         "vocab-sharded tree takes the plain rollout (fused=False), as the JAX "
                         "package turns its Pallas kernels off on a mesh")


def a2c_rollout_loss_fused(a2c_params: dict, cfg: NetConfig, reward_params: dict, features,
                           captions, curr_seq_len: int, caplen, rng,
                           per_step_mean: bool = False,
                           weight_dtype: torch.dtype = torch.bfloat16,
                           fuse_reward: bool = True, tape_gates: bool = True, row0: int = 0):
    """:func:`a2c_rollout_loss` with the rollout through
    :func:`..ops.fused_rollout.fused_rollout` (the JAX package's
    ``steps.py:749-818``): the same keys, so the same actions up to the
    kernels' near-ties; the same loss and mask. The frozen reward stream
    runs inside the rollout (``fuse_reward=True``, the default) or as its
    own kernel (:func:`..ops.fused_rollout.fused_reward_stream`).
    ``tape_gates=False`` keeps no gate tape: the backward recomputes the
    gates. ``row0`` as in :func:`a2c_rollout_loss`. A vocab-sharded tree
    raises ``ValueError`` (:func:`check_fused_rollout`)."""
    check_fused_rollout(a2c_params, reward_params)
    if fuse_reward:
        values, log_probs, _, _, rewards = fused_rollout(
            a2c_params, cfg, features, captions, curr_seq_len, rng, weight_dtype=weight_dtype,
            reward_params=reward_params, tape_gates=tape_gates, row0=row0)
    else:
        values, log_probs, actions, tokens = fused_rollout(
            a2c_params, cfg, features, captions, curr_seq_len, rng, weight_dtype=weight_dtype,
            tape_gates=tape_gates, row0=row0)
        rewards = fused_reward_stream(reward_params, cfg, features, captions[:, 0], actions,
                                      tokens, weight_dtype=weight_dtype)
    return _a2c_loss(values, rewards, log_probs, curr_seq_len, caplen, per_step_mean)


def make_a2c_step(cfg: NetConfig, optimizer: torch.optim.Optimizer, per_step_mean: bool = False,
                  compat: bool = False, fused: bool = False, fuse_reward: bool = True):
    """``step(a2c_params, reward_params, features, captions, curr_seq_len,
    rng, caplen=None, shard=None) -> RolloutStats`` (detached): one A2C
    update of ``{"policy", "value"}`` against the frozen reward network,
    plain (``per_step_mean=False``) or curriculum (``True``). ``rng`` is the
    minibatch's host key; ``caplen`` (a host int) the minibatch's largest
    END position + 1, from ``captions`` on the device when None. With a
    ``shard`` the rows are the rank's, their noise drawn at ``row0 =
    shard.lo``, and the gradients and stats are averaged over the ranks
    (``caplen`` must then be the global minibatch's). ``fused=True`` runs the rollout through the
    rollout kernels (:func:`a2c_rollout_loss_fused`), with the reward
    stream fused in or, ``fuse_reward=False``, as its own kernel.
    ``compat=True`` takes :func:`a2c_rollout_loss_compat` (Q1); otherwise a
    bidirectional config takes :func:`a2c_rollout_loss_full`. Both refuse
    ``fused=True``, and so does a vocab-sharded tree (the step raises
    ``ValueError``: :func:`check_fused_rollout`). On a vocab-sharded tree
    the noise is drawn at ``row0 = shard.lo`` and each rank's first column
    (``col0``)."""
    if fused and (compat or cfg.bidirectional):
        raise ValueError("fused rollout is unidirectional, non-compat only")
    fused_kw = {"fuse_reward": fuse_reward} if fused else {}
    if fused:
        rollout = a2c_rollout_loss_fused
    elif compat:
        rollout = a2c_rollout_loss_compat
    else:
        rollout = a2c_rollout_loss_full if cfg.bidirectional else a2c_rollout_loss

    def step(a2c_params, reward_params, features, captions, curr_seq_len, rng, caplen=None,
             shard=None):
        if caplen is None:
            if shard is not None:
                raise ValueError("a sharded A2C step needs the global minibatch's caplen")
            caplen = torch.max(batch_caption_lens(captions))
        if shard is not None and compat:
            raise ValueError("the compat rollout treats the batch as time: it takes no shard")
        optimizer.zero_grad(set_to_none=True)
        loss, stats = rollout(a2c_params, cfg, reward_params, features, captions, curr_seq_len,
                              caplen, rng, per_step_mean=per_step_mean,
                              row0=0 if shard is None else shard.lo, **fused_kw)
        loss.backward()
        stats = [x.detach() for x in stats]
        if shard is not None:
            stats = reduce_gradients(optimizer, stats, shard)
        optimizer.step()
        return RolloutStats(*stats)

    return step


# --------------------------------------------------------------------------
# Chunked steps: K minibatch updates per host dispatch (JAX steps.py:156-237,
# 381-498), the Q12 best-loss bookkeeping on the device
# --------------------------------------------------------------------------

def _tree_leaves(tree: dict) -> list:
    return [leaf for k in sorted(tree)
            for leaf in (_tree_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def _empty_like_tree(tree: dict) -> dict:
    return {k: _empty_like_tree(v) if isinstance(v, dict) else torch.empty_like(v.detach())
            for k, v in tree.items()}


class BestLossChunk:
    """``chunk(best_loss, features [k, N, F], captions [k, N, T], extras=None)
    -> (losses [k], best_prev, best, improved)``: k minibatch updates of a
    best-loss pretrainer's ``params`` (in place) with no host sync, the
    counterpart of the JAX ``_best_loss_scan``.

    The reference re-saves its checkpoint on every improvement
    (trainers.py:182-186, 244-248, 293-297); only the last write is seen,
    and it holds the weights entering the first minibatch that attains the
    minimum loss (quirk Q12, strict ``<``). The chunk carries ``(best,
    best_prev, improved)`` as device tensors: after each minibatch's
    backward, while the weights still enter it, ``best_prev`` takes them
    leaf by leaf through ``torch.where`` where the loss is below ``best``.
    The host saves ``best_prev`` once a chunk, when ``improved`` is set.
    ``extras[j]`` is minibatch j's extra step arguments (the value step's
    prefix length). ``shard`` (a :class:`..parallel.collectives.RowShard`)
    makes the chunk's rows a rank's rows of k global minibatches: each
    update reduces its gradient and loss over the ranks (divided by them
    when ``mean``), inside the captured graph too (NCCL collectives
    capture; gloo's do not, so a gloo rank runs ``graph=False``).

    ``graph=True`` (CUDA only) captures the k updates as one CUDA graph,
    once per input shape, and replays it each chunk: the minibatches are
    copied (or gathered by the caller, :meth:`inputs`) into the graph's
    static buffers. The kernel wrappers count the launches they make (the
    warm-up's, and the capture's, recorded and not run) and none of the
    replays', which call no wrapper; ``BestLossChunk.captures`` and
    ``BestLossChunk.replays`` count captures and replays. The optimiser
    must be capturable (:func:`.optim.adam` makes it so on the
    card). Before its capture one update runs on a side stream to do the
    one-time host work (library load, shared-memory opt-ins, Adam's state),
    and the weights and Adam's state are then put back, so a captured
    chunk computes what k eager updates compute, bit for bit. A capture
    that fails raises."""

    def __init__(self, params: dict, optimizer: torch.optim.Optimizer, loss_fn,
                 graph: bool = False, mean: bool = True):
        if (graph and getattr(params, "vocab", None) is not None and collectives.active()
                and torch.distributed.get_backend() != "nccl"):
            raise ValueError("a vocab-sharded chunk combines its logits over the model group "
                             "inside every update, and gloo's collectives cannot be captured "
                             "in a CUDA graph: run it with graph=False, or over NCCL")
        self._leaves = _tree_leaves(params)
        self._opt = optimizer
        self._loss_fn = loss_fn
        self.best_prev = _empty_like_tree(params)
        self._best_prev_leaves = _tree_leaves(self.best_prev)
        self.device = self._leaves[0].device
        if graph and self.device.type != "cuda":
            raise ValueError("a captured chunk runs on a CUDA device only")
        self.graph = graph
        self._mean = mean
        self._best = torch.empty((), dtype=torch.float32, device=self.device)
        self._improved = torch.empty((), dtype=torch.bool, device=self.device)
        self._buffers, self._graphs = {}, {}

    def _keep_best(self, loss: torch.Tensor) -> None:
        take = loss < self._best
        with torch.no_grad():
            torch.where(take, loss, self._best, out=self._best)
            for bp, p in zip(self._best_prev_leaves, self._leaves):
                torch.where(take, p, bp, out=bp)
            self._improved.logical_or_(take)

    def _update(self, features, captions, extra=(), shard=None) -> torch.Tensor:
        return _train_step(self._opt, lambda: self._loss_fn(features, captions, *extra,
                                                            shard=shard),
                           self._keep_best, shard=shard, mean=self._mean)

    def inputs(self, k: int, n: int, feature_dim: int, steps: int) -> tuple:
        """The captured chunk's static ``(features [k, n, F], captions [k, n,
        T] int64)`` buffers for that shape, to gather a chunk into."""
        key = (k, n, feature_dim, steps)
        if key not in self._buffers:
            self._buffers[key] = (
                torch.empty((k, n, feature_dim), dtype=torch.float32, device=self.device),
                torch.empty((k, n, steps), dtype=torch.int64, device=self.device))
        return self._buffers[key]

    def __call__(self, best_loss: float, features: torch.Tensor, captions: torch.Tensor,
                 extras=None, shard=None):
        k = features.shape[0]
        if not self.graph:
            self._best.fill_(best_loss)
            self._improved.zero_()
            losses = torch.stack([self._update(features[j], captions[j],
                                               () if extras is None else extras[j], shard)
                                  for j in range(k)])
            return losses, self.best_prev, self._best, self._improved
        if extras is not None:
            raise ValueError("a captured chunk takes no per-minibatch extras")
        feats_buf, caps_buf = self.inputs(k, features.shape[1], features.shape[2],
                                          captions.shape[2])
        if features.data_ptr() != feats_buf.data_ptr():
            feats_buf.copy_(features)
        if captions.data_ptr() != caps_buf.data_ptr():
            caps_buf.copy_(captions)
        key = tuple(feats_buf.shape) + (caps_buf.shape[2], shard)
        if key not in self._graphs:
            self._graphs[key] = self._capture(feats_buf, caps_buf, shard)
        graph, losses = self._graphs[key]
        self._best.fill_(best_loss)
        self._improved.zero_()
        graph.replay()
        BestLossChunk.replays += 1
        return losses, self.best_prev, self._best, self._improved

    def _capture(self, feats_buf: torch.Tensor, caps_buf: torch.Tensor, shard=None) -> tuple:
        dev = self.device
        saved = [p.detach().clone() for p in self._leaves]
        saved_state = {id(p): {name: t.clone() for name, t in self._opt.state[p].items()}
                       for p in self._leaves if p in self._opt.state}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._best.fill_(float("inf"))
            self._update(feats_buf[0], caps_buf[0], shard=shard)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():  # put the weights and Adam's state back
            for p, q in zip(self._leaves, saved):
                p.copy_(q)
            for p in self._leaves:
                old = saved_state.get(id(p))
                for name, t in self._opt.state.get(p, {}).items():
                    if old is None:
                        t.zero_()  # a fresh state: step 0, zero moments
                    else:
                        t.copy_(old[name])
        losses = torch.empty((feats_buf.shape[0],), dtype=torch.float32, device=dev)
        self._opt.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        BestLossChunk.captures += 1
        with torch.cuda.graph(graph):
            for j in range(feats_buf.shape[0]):
                losses[j].copy_(self._update(feats_buf[j], caps_buf[j], shard=shard))
        return graph, losses


BestLossChunk.captures = 0
BestLossChunk.replays = 0


def make_reward_chunk_step(cfg: NetConfig, optimizer: torch.optim.Optimizer, params: dict,
                           beta=0.2, fused: bool = False, graph: bool = False) -> BestLossChunk:
    """Chunked :func:`make_reward_step` of ``params`` (non-compat,
    unidirectional): a :class:`BestLossChunk`."""
    if cfg.bidirectional:
        raise ValueError("chunked reward step is unidirectional only")
    loss_fn = reward_loss_fused if fused else reward_loss
    return BestLossChunk(params, optimizer,
                         lambda f, c, shard=None: loss_fn(params, cfg, f, c, beta=beta,
                                                          shard=shard),
                         graph=graph, mean=False)


def make_policy_chunk_step(cfg: NetConfig, optimizer: torch.optim.Optimizer, params: dict,
                           fused: bool = False, graph: bool = False) -> BestLossChunk:
    """Chunked :func:`make_policy_step` of ``params`` (unidirectional): a
    :class:`BestLossChunk`."""
    if cfg.bidirectional:
        raise ValueError("chunked policy step is unidirectional only")
    loss_fn = policy_loss_fused if fused else policy_loss
    return BestLossChunk(params, optimizer,
                         lambda f, c, shard=None: loss_fn(params, cfg, f, c,
                                                          batch_caption_lens(c)),
                         graph=graph)


def make_value_chunk_step(cfg: NetConfig, optimizer: torch.optim.Optimizer, params: dict,
                          pparams: dict, rparams: dict, fused: bool = False) -> BestLossChunk:
    """Chunked :func:`make_value_step` of ``params`` against the frozen
    policy and reward networks (non-compat, unidirectional), run eagerly:
    each minibatch's prefix length (``extras[j] = (prefix_len,)``, drawn by
    the host in minibatch order) is a host int, and its targets come from
    the greedy kernel."""
    if cfg.bidirectional:
        raise ValueError("chunked value step is unidirectional only")
    pparams, rparams = gather_params(pparams), gather_params(rparams)
    greedy_weights = prepare_greedy_weights(pparams) if fused else None
    return BestLossChunk(params, optimizer, lambda f, c, prefix_len, shard=None:
                         value_episode_loss(params, cfg, pparams, rparams, f, c, prefix_len,
                                            fused=fused, greedy_weights=greedy_weights))


def make_a2c_chunk_step(cfg: NetConfig, optimizer: torch.optim.Optimizer,
                        per_step_mean: bool = False, compat: bool = False, fused: bool = False,
                        fuse_reward: bool = True):
    """Chunked A2C update (the JAX ``make_a2c_chunk_step``): ``chunk(
    a2c_params, reward_params, features [k, N, F], captions [k, N, T], currs,
    rngs, caplens=None, shard=None) -> (stats, valid)`` runs k minibatch
    updates of
    :func:`make_a2c_step` eagerly with no host sync, minibatch j under its
    host key ``rngs[j]`` (drawn by the host with the per-step loop's split
    discipline) at ``curr_seq_len = currs[j]`` (host ints: 1 for plain A2C,
    ``caplen - level`` for the curriculum). A minibatch with ``currs[j] <
    1`` is skipped as the reference skips it (trainers.py:550): no update,
    zero stats, ``valid[j]`` False. ``stats`` is a :class:`RolloutStats`
    of ``[k]`` device tensors, ``valid`` a host bool array. ``caplens[j]``
    (host ints) and ``shard`` reach :func:`make_a2c_step`'s step. The
    trainers' per-step walk is the case k = 1."""
    step = make_a2c_step(cfg, optimizer, per_step_mean=per_step_mean, compat=compat,
                         fused=fused, fuse_reward=fuse_reward)

    def chunk(a2c_params, reward_params, features, captions, currs, rngs, caplens=None,
              shard=None):
        k = features.shape[0]
        valid = np.zeros(k, dtype=bool)
        zero = torch.zeros((), dtype=torch.float32, device=features.device)
        stats = []
        for j in range(k):
            if currs[j] < 1:
                stats.append(RolloutStats(zero, zero, zero, zero, zero))
                continue
            stats.append(step(a2c_params, reward_params, features[j], captions[j],
                              int(currs[j]), rngs[j],
                              None if caplens is None else int(caplens[j]), shard))
            valid[j] = True
        return RolloutStats(*(torch.stack(x) for x in zip(*stats))), valid

    return chunk
