"""Training steps (counterpart of the JAX ``train/steps.py``,
unidirectional and non-compat forms only).

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

A step built by ``make_*_step`` runs one minibatch — loss, backward, one
optimiser step that updates the parameter tensors in place — and returns
the loss (the A2C step: its :class:`RolloutStats`) as detached 0-d tensors
(no device sync).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import END_ID
from ..config import NetConfig
from ..decode.greedy import greedy_decode
from ..models import policy as policy_mod
from ..models import reward as reward_mod
from ..models import value as value_mod
from ..ops.fused_decode import fused_greedy_decode, prepare_greedy_weights
from ..ops.fused_gru import fused_gru_chain
from ..ops.fused_lstm import fused_lstm_chain
from ..ops.fused_rollout import fused_reward_stream, fused_rollout
from ..ops.linalg import dense
from ..ops.losses import a2c_losses, visual_semantic_embedding_loss, weighted_caption_xe_loss
from ..ops.prng import split
from ..ops.reward_ops import cosine_embedding_reward
from ..ops.rnn import lstm_cell, lstm_scan
from ..ops.sampling import log_prob_of, sample_categorical


def batch_caption_lens(captions: torch.Tensor) -> torch.Tensor:
    """END position + 1 per row (cf. trainers.py:241)."""
    return torch.argmax((captions == END_ID).to(torch.int32), dim=1) + 1


def _train_step(optimizer: torch.optim.Optimizer, loss_fn):
    """One minibatch: zero the gradients, loss, backward, optimiser step."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    optimizer.step()
    return loss.detach()


# --------------------------------------------------------------------------
# Reward network (VSE loss)
# --------------------------------------------------------------------------

def reward_loss(params, cfg: NetConfig, features, captions, beta=0.2):
    ve, se = reward_mod.forward(params, cfg, features, captions)
    return visual_semantic_embedding_loss(ve, se, beta=beta)


def reward_loss_fused(params, cfg: NetConfig, features, captions, beta=0.2,
                      weight_dtype=torch.bfloat16):
    """:func:`reward_loss` with the GRU chain through the chain kernels."""
    h0 = torch.zeros((captions.shape[0], cfg.hidden_dim), dtype=torch.float32,
                     device=features.device)
    hs = fused_gru_chain(params["gru"], params["embedding"], captions, h0,
                         weight_dtype=weight_dtype)
    ve, se = reward_mod.embed_pair(params, cfg, features, hs[:, -1])
    return visual_semantic_embedding_loss(ve, se, beta=beta)


def make_reward_step(cfg: NetConfig, optimizer: torch.optim.Optimizer, beta=0.2,
                     fused: bool = False):
    """``step(params, features, captions) -> loss``; ``fused=True`` runs the
    GRU chain through its kernels."""
    loss_fn = reward_loss_fused if fused else reward_loss

    def step(params, features, captions):
        return _train_step(optimizer, lambda: loss_fn(params, cfg, features, captions, beta=beta))

    return step


# --------------------------------------------------------------------------
# Policy network (teacher-forced XE)
# --------------------------------------------------------------------------

def policy_loss(params, cfg: NetConfig, features, captions, caplens):
    logits = policy_mod.forward(params, cfg, features, captions[:, :-1])
    return weighted_caption_xe_loss(logits, captions[:, 1:], caplens)


def policy_loss_fused(params, cfg: NetConfig, features, captions, caplens,
                      weight_dtype=torch.bfloat16):
    """:func:`policy_loss` with the LSTM chain through the chain kernels;
    the vocab head and the XE loss stay single large products over the
    N T rows."""
    h0 = dense(features, params["cnn2linear"])
    hs = fused_lstm_chain(params["lstm"], params["embedding"], captions[:, :-1], h0,
                          torch.zeros_like(h0), weight_dtype=weight_dtype)
    logits = dense(hs, params["head"])
    return weighted_caption_xe_loss(logits, captions[:, 1:], caplens)


def make_policy_step(cfg: NetConfig, optimizer: torch.optim.Optimizer, fused: bool = False):
    """``step(params, features, captions) -> loss``; ``fused=True`` runs the
    LSTM chain through its kernels."""
    loss_fn = policy_loss_fused if fused else policy_loss

    def step(params, features, captions):
        caplens = batch_caption_lens(captions)
        return _train_step(optimizer,
                           lambda: loss_fn(params, cfg, features, captions, caplens))

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
    kernels."""
    n = gen_caps.shape[0]
    zeros = torch.zeros((n, cfg.hidden_dim), dtype=torch.float32, device=features.device)
    if fused:
        hs = fused_lstm_chain(vparams["lstm"], vparams["embedding"], gen_caps, zeros, zeros,
                              weight_dtype=weight_dtype)
        h = hs[:, prefix_len - 1]
    else:
        xs = vparams["embedding"][gen_caps].transpose(0, 1)  # [T, N, E]
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


def make_value_step(cfg: NetConfig, optimizer: torch.optim.Optimizer, pparams: dict,
                    rparams: dict, fused: bool = False):
    """``step(vparams, features, captions, prefix_len) -> loss`` against the
    frozen policy ``pparams`` and reward network ``rparams`` (loaded, not
    trained: trainers.py:140-150). ``fused=True`` prepares the policy's
    bf16 greedy-kernel weights once, here, and runs the rollout and the
    value encoder through their kernels."""
    greedy_weights = prepare_greedy_weights(pparams) if fused else None

    def step(vparams, features, captions, prefix_len):
        return _train_step(optimizer, lambda: value_episode_loss(
            vparams, cfg, pparams, rparams, features, captions, prefix_len, fused=fused,
            greedy_weights=greedy_weights))

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
                     captions, curr_seq_len: int, caplen, rng, per_step_mean: bool = False):
    """Loss of one A2C episode batch as an eager scan (the JAX package's XLA
    rollout, ``steps.py:509-610``) -> ``(loss, RolloutStats)``.

    Plain A2C is ``curr_seq_len = 1``: roll out from the start column;
    the curriculum teacher-forces positions ``p < curr_seq_len``. Per step:
    the critic's value of the current prefix, an action drawn from the
    policy's last-step logits under the step's key (``split(rng, S)``,
    :func:`..ops.sampling.sample_categorical`, JAX's draws), its log-prob,
    the frozen reward of the prefix plus the action (no gradient, Q7), then
    every encoder advances with the placed token. ``caplen``: the batch's
    largest END position + 1."""
    pparams, vparams = a2c_params["policy"], a2c_params["value"]
    n, t_max = captions.shape
    dev = features.device
    start = captions[:, 0]
    pol_state = policy_mod.init_decode_state(pparams, cfg, features)
    pol_state = lstm_cell(pparams["lstm"], pparams["embedding"][start], pol_state)
    val_state = value_mod.rnn_step(vparams, cfg, start, value_mod.zero_rnn_state(cfg, n, dev))
    with torch.no_grad():
        rew_state = reward_mod.rnn_step(reward_params, cfg, start,
                                        reward_mod.zero_rnn_state(cfg, n, dev))
        ve = dense(features, reward_params["visual_embed"])
    step_keys = split(rng, t_max - 1)
    values, rewards, log_probs = [], [], []
    for p in range(1, t_max):
        logits = dense(pol_state[0], pparams["head"])
        action = sample_categorical(step_keys[p - 1], logits.detach())
        log_probs.append(log_prob_of(logits, action))
        values.append(value_mod.value_from_state(vparams, cfg, features, val_state)[:, 0])
        token_in = captions[:, p] if p < curr_seq_len else action
        with torch.no_grad():
            rew_after = reward_mod.rnn_step(reward_params, cfg, action, rew_state)
            se = dense(rew_after, reward_params["semantic_embed"])
            rewards.append(cosine_embedding_reward(ve, se))
            rew_state = reward_mod.rnn_step(reward_params, cfg, token_in, rew_state)
        pol_state = lstm_cell(pparams["lstm"], pparams["embedding"][token_in], pol_state)
        val_state = value_mod.rnn_step(vparams, cfg, token_in, val_state)
    return _a2c_loss(torch.stack(values, dim=1), torch.stack(rewards, dim=1),
                     torch.stack(log_probs, dim=1), curr_seq_len, caplen, per_step_mean)


def a2c_rollout_loss_fused(a2c_params: dict, cfg: NetConfig, reward_params: dict, features,
                           captions, curr_seq_len: int, caplen, rng,
                           per_step_mean: bool = False,
                           weight_dtype: torch.dtype = torch.bfloat16,
                           fuse_reward: bool = True):
    """:func:`a2c_rollout_loss` with the rollout through
    :func:`..ops.fused_rollout.fused_rollout` (the JAX package's
    ``steps.py:749-818``): the same keys, so the same actions up to the
    kernels' near-ties; the same loss and mask. The frozen reward stream
    runs inside the rollout (``fuse_reward=True``, the default) or as its
    own kernel (:func:`..ops.fused_rollout.fused_reward_stream`)."""
    if fuse_reward:
        values, log_probs, _, _, rewards = fused_rollout(
            a2c_params, cfg, features, captions, curr_seq_len, rng, weight_dtype=weight_dtype,
            reward_params=reward_params)
    else:
        values, log_probs, actions, tokens = fused_rollout(
            a2c_params, cfg, features, captions, curr_seq_len, rng, weight_dtype=weight_dtype)
        rewards = fused_reward_stream(reward_params, cfg, features, captions[:, 0], actions,
                                      tokens, weight_dtype=weight_dtype)
    return _a2c_loss(values, rewards, log_probs, curr_seq_len, caplen, per_step_mean)


def make_a2c_step(cfg: NetConfig, optimizer: torch.optim.Optimizer, per_step_mean: bool = False,
                  fused: bool = False, fuse_reward: bool = True):
    """``step(a2c_params, reward_params, features, captions, curr_seq_len,
    rng) -> RolloutStats`` (detached): one A2C update of ``{"policy",
    "value"}`` against the frozen reward network, plain
    (``per_step_mean=False``) or curriculum (``True``). ``rng`` is the
    minibatch's host key. ``fused=True`` runs the rollout through the
    rollout kernels (:func:`a2c_rollout_loss_fused`), with the reward
    stream fused in or, ``fuse_reward=False``, as its own kernel."""
    fused_kw = {"fuse_reward": fuse_reward} if fused else {}
    rollout = a2c_rollout_loss_fused if fused else a2c_rollout_loss

    def step(a2c_params, reward_params, features, captions, curr_seq_len, rng):
        caplen = torch.max(batch_caption_lens(captions))
        optimizer.zero_grad(set_to_none=True)
        loss, stats = rollout(a2c_params, cfg, reward_params, features, captions, curr_seq_len,
                              caplen, rng, per_step_mean=per_step_mean, **fused_kw)
        loss.backward()
        optimizer.step()
        return RolloutStats(*(x.detach() for x in stats))

    return step
