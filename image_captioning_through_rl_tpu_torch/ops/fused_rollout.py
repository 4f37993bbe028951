"""The A2C rollout: hand-written CUDA kernels (the reward stream, and the
rollout forward and backward) and their plain PyTorch versions.

Counterpart of the JAX ``ops/pallas_rollout.py``: ``fused_reward_stream``
(TPU kernel ``_reward_stream_kernel``) and ``fused_rollout``
(``_rollout_fwd_kernel``, ``_policy_bwd_kernel`` and ``_value_bwd_kernel``
under the custom VJP of ``_make_core``). The kernels are
``csrc/rollout_fwd.cuh`` (the forward: one persistent cooperative launch for
all steps, planned by :func:`rollout_plan`; entered by ``rollout_fwd.cu``,
and by ``reward_stream.cu`` in its reward-only mode, the stream alone) and
``csrc/rollout.cu`` (the backward: one C call, the heads' products on
``wgmma`` with a fixed-order split-K and both encoders' recurrences in one
cooperative launch, planned by :func:`rollout_bwd_plan`); their notes say
what each step computes, where it rounds, what bounds it on Hopper and what
the design does about that.

Over S = T - 1 steps the rollout takes, at step s (position p = s + 1), the
policy's logits from its carried state, the Gumbel-max action on the step's
noise (``jax.random.categorical`` with the same keys, :mod:`.prng`), its
log-softmax log-prob, the critic's value of ``[features; h_v]``, the placed
token (the teacher while ``p < curr_seq_len``, else the action) and, with the
reward stream fused in, the frozen reward of the prefix plus the action; then
both encoders advance with the placed token (not on the last step, whose
states nothing reads).

What stays plain torch, as in JAX (``pallas_rollout.py:882-888``): the start
states ``h0 = cnn2linear(features)``, the policy's and the value's
start-token cells (their cotangents flow back through autograd into
``cnn2linear`` and the start-token embedding rows), and the reward stream's
per-episode constants (the start-token GRU state ``rew0`` and the normalised
``visual_embed(features)``, ``vn``).

Both versions of the rollout are ``torch.autograd.Function``s over the same
arguments (:class:`_RolloutPlain`, :class:`_RolloutKernel`), with a backward
that mirrors the TPU kernel's: the heads' backward over all S N rows, then
each encoder's recurrence as the teacher-forced LSTM chain's backward
(:func:`.fused_lstm.lstm_chain_backward_plain`, ``lstm_bwd`` in
``csrc/lstm_chain.cuh``). The reward network gets no gradient (Q7).

Routing, as in :mod:`.fused_lstm`: a CUDA tensor runs the kernels (or the
call raises), a CPU tensor the plain versions, and ``use_fused_kernel=False``
selects the plain versions. No path catches a kernel error and falls back.
Networks whose widths the kernels cannot stage are padded (:mod:`.padding`)
on their way into the kernels, differentiably, so the gradients reach the
unpadded parameters.
``fused_rollout.fwd_launches`` / ``.bwd_launches`` and
``fused_reward_stream.launches`` count kernel launches.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..models import policy as policy_mod
from ..models import value as value_mod
from .fused_decode import (assert_tokens, check_tile_widths, round_to, token_gate_table,
                           wmatmul)
from .fused_lstm import (_CHAIN_RING, _SLICE_UNITS, CHAIN_ROWS, CHAIN_THREADS, SMEM_PER_BLOCK,
                         SMEM_PER_SM, SMEM_RESERVED, _chain_smem, chain_plan, embedding_grad,
                         lstm_chain_backward_plain)
from .kernel_build import check_error, load_library
from .linalg import dense
from .padding import needs_padding, pad8, pad_cell, pad_dim, pad_split_rows
from .prng import gumbel_noise, split
from .rnn import gru_cell, lstm_cell

_F32 = torch.float32


def _pad8(x: int) -> int:
    return (x + 7) // 8 * 8


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_weight_dtype(weight_dtype: torch.dtype) -> None:
    if weight_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"weight_dtype must be bfloat16 or float32, got {weight_dtype}")


# --------------------------------------------------------------------------
# The frozen reward stream (forward only: the reward is stop-gradient, Q7)
# --------------------------------------------------------------------------

class RewardWeights(NamedTuple):
    """The frozen reward network in the kernels' layout: ``xg`` the table
    ``emb @ wi + bi`` (f32 ``[V, 3H]``), ``wh`` and ``sem_w`` in the working
    type, biases f32; ``vn`` and ``rew0`` the per-episode constants
    (f32 ``[N, H]``)."""

    xg: torch.Tensor
    wh: torch.Tensor
    bh: torch.Tensor
    sem_w: torch.Tensor
    sem_b: torch.Tensor
    vn: torch.Tensor
    rew0: torch.Tensor


def prepare_reward_weights(reward_params: dict, features: torch.Tensor,
                           start_tokens: torch.Tensor,
                           weight_dtype: torch.dtype = torch.bfloat16) -> RewardWeights:
    """The reward stream's operands, without gradient: the x-gate table (the
    table kernel on CUDA), the weights cast to ``weight_dtype``, and the
    per-episode constants in plain f32 torch, as the JAX package computes
    them outside its kernel: ``rew0`` the GRU state after the start token,
    ``vn`` the normalised ``visual_embed(features)``. A network whose widths
    the kernel cannot stage is padded first (:func:`pad_reward_params`): its
    rewards are the same."""
    _check_weight_dtype(weight_dtype)
    emb_dim, hidden = reward_params["embedding"].shape[1], reward_params["gru"]["wh"].shape[0]
    if needs_padding(emb_dim, hidden, features.shape[1]):
        ep, hp, fp = pad8(emb_dim), pad8(hidden), pad8(features.shape[1])
        reward_params = pad_reward_params(reward_params, ep, hp, fp)
        features = pad_dim(features, 1, fp)
    with torch.no_grad():
        gru = reward_params["gru"]
        emb = reward_params["embedding"].to(weight_dtype).contiguous()
        wi = gru["wi"].to(weight_dtype).contiguous()
        xg = token_gate_table(emb, wi, gru["bi"].to(_F32).contiguous())
        n = features.shape[0]
        h0 = torch.zeros((n, gru["wh"].shape[0]), dtype=_F32, device=features.device)
        rew0 = gru_cell(gru, reward_params["embedding"][start_tokens.long()], h0)
        ve = dense(features, reward_params["visual_embed"])
        vn = ve / torch.clamp_min(torch.linalg.vector_norm(ve, dim=-1, keepdim=True), 1e-12)
        sem = reward_params["semantic_embed"]
        return RewardWeights(
            xg=xg, wh=gru["wh"].to(weight_dtype).contiguous(), bh=gru["bh"].to(_F32).contiguous(),
            sem_w=sem["w"].to(weight_dtype).contiguous(), sem_b=sem["b"].to(_F32).contiguous(),
            vn=vn.to(_F32).contiguous(), rew0=rew0.to(_F32).contiguous())


def pad_reward_params(reward_params: dict, emb_p: int, hidden_p: int, feat_p: int) -> dict:
    """The reward network's embedding, GRU, ``visual_embed`` and
    ``semantic_embed`` padded to ``E = emb_p``, ``H = hidden_p``, ``F =
    feat_p`` (:mod:`.padding`)."""
    vis, sem = reward_params["visual_embed"], reward_params["semantic_embed"]
    return {
        "embedding": pad_dim(reward_params["embedding"], 1, emb_p),
        "gru": pad_cell(reward_params["gru"], 3, emb_p, hidden_p),
        "visual_embed": {"w": pad_dim(pad_dim(vis["w"], 0, feat_p), 1, hidden_p),
                         "b": pad_dim(vis["b"], 0, hidden_p)},
        "semantic_embed": {"w": pad_dim(pad_dim(sem["w"], 0, hidden_p), 1, hidden_p),
                           "b": pad_dim(sem["b"], 0, hidden_p)},
    }


def _gru_update(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The GRU update from input gates ``gi`` (a table row, ``bi`` in it) and
    recurrent gates ``gh`` (``bh`` in it), gate order r, z, n."""
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def _reward_step_plain(rw: RewardWeights, h: torch.Tensor, action: torch.Tensor,
                       token: torch.Tensor | None):
    """One step of the stream in eager torch -> ``(reward [N], h')``: ``gh``
    once, the lookahead on the action, ``semantic_embed``, the cosine
    ``sum(vn * se) / max(|se|, 1e-12)``, and the advance on the placed token
    (``None``: no advance)."""
    wd = rw.wh.dtype
    gh = wmatmul(round_to(h, wd), rw.wh) + rw.bh
    after = _gru_update(rw.xg[action.long()], gh, h)
    se = wmatmul(round_to(after, wd), rw.sem_w) + rw.sem_b
    reward = torch.sum(rw.vn * se, dim=-1) / torch.clamp_min(
        torch.sqrt(torch.sum(se * se, dim=-1)), 1e-12)
    h_next = None if token is None else _gru_update(rw.xg[token.long()], gh, h)
    return reward, h_next


def reward_stream_plain(rw: RewardWeights, act_sm: torch.Tensor, tok_sm: torch.Tensor
                        ) -> torch.Tensor:
    """The reward stream kernel's function in eager torch: step-major
    actions and placed tokens ``[S, N]`` -> rewards ``[S, N]`` f32."""
    steps = act_sm.shape[0]
    h, out = rw.rew0, []
    for s in range(steps):
        reward, h = _reward_step_plain(rw, h, act_sm[s], tok_sm[s] if s + 1 < steps else None)
        out.append(reward)
    return torch.stack(out)


def _check_reward_weights(rw: RewardWeights, n: int, vocab: int) -> None:
    dev = rw.xg.device
    wd = rw.wh.dtype
    hidden = rw.wh.shape[0]
    want = {"xg": (vocab, 3 * hidden), "wh": (hidden, 3 * hidden), "bh": (3 * hidden,),
            "sem_w": (hidden, hidden), "sem_b": (hidden,), "vn": (n, hidden),
            "rew0": (n, hidden)}
    for name, t in rw._asdict().items():
        dtype = wd if name in ("wh", "sem_w") else _F32
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() or t.shape != want[name]:
            raise ValueError(f"reward weight {name!r} must be a contiguous {dtype} tensor of "
                             f"shape {want[name]} on {dev}")
    check_tile_widths(wd, hidden=hidden)


def _launch_reward_stream(rw: RewardWeights, act_sm: torch.Tensor, tok_sm: torch.Tensor,
                          clock: torch.Tensor | None = None) -> torch.Tensor:
    steps, n = act_sm.shape
    vocab = rw.xg.shape[0]
    _check_reward_weights(rw, n, vocab)
    for name, t in (("actions", act_sm), ("tokens", tok_sm)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != rw.xg.device:
            raise ValueError(f"{name} must be a contiguous int32 [S, N] tensor on the weights' "
                             f"device")
    dev = rw.xg.device
    _check_clock(clock, steps, dev)
    assert_tokens(f"actions and tokens must lie in [0, {vocab})", vocab, act_sm, tok_sm)
    hidden = rw.wh.shape[0]
    rewards = torch.empty((steps, n), dtype=_F32, device=dev)
    if rewards.numel() == 0:
        return rewards
    lib = load_library()
    with torch.cuda.device(dev):
        ws = torch.empty(lib.icrl_reward_stream_workspace_floats(n, hidden), dtype=_F32,
                         device=dev)
        err = lib.icrl_reward_stream(
            n, steps, hidden, int(rw.wh.dtype == torch.bfloat16),
            *_reward_plan_args(n, hidden, rw.wh.dtype, dev.index), _ptr(act_sm), _ptr(tok_sm),
            _ptr(rw.xg), _ptr(rw.wh), _ptr(rw.bh), _ptr(rw.sem_w), _ptr(rw.sem_b), _ptr(rw.vn),
            _ptr(rw.rew0), _ptr(rewards), _ptr(ws), _ptr(clock), _stream(dev))
    check_error(lib, "icrl_reward_stream", err)
    fused_reward_stream.launches += 1
    return rewards


def reward_stream(rw: RewardWeights, act_sm: torch.Tensor, tok_sm: torch.Tensor,
                  use_fused_kernel: bool | None = None, *,
                  clock: torch.Tensor | None = None) -> torch.Tensor:
    """The stream on prepared weights: ``[S, N]`` int32 actions and tokens
    -> rewards ``[S, N]``. CUDA tensors run the kernel (one persistent
    launch, the rollout forward's reward-only mode: :func:`rollout_plan`
    with ``reward_only=True``), CPU tensors :func:`reward_stream_plain`.

    ``clock``, for a profile of the kernel: int64 zeros of
    :func:`rollout_clock_slots` on the card, filled as
    :func:`rollout_forward_kernel` fills its own (S + 1 passes: the last
    one takes the last step's reward)."""
    if use_fused_kernel is False or (not rw.xg.is_cuda and not use_fused_kernel):
        if clock is not None:
            raise ValueError("clock profiles the kernel: the plain version takes none")
        return reward_stream_plain(rw, act_sm, tok_sm)
    if not rw.xg.is_cuda:
        raise RuntimeError("use_fused_kernel=True needs CUDA tensors: the reward stream kernel "
                           "runs only on a CUDA device")
    return _launch_reward_stream(rw, act_sm, tok_sm, clock)


def fused_reward_stream(reward_params: dict, cfg, features: torch.Tensor,
                        start_tokens: torch.Tensor, actions: torch.Tensor, tokens: torch.Tensor,
                        weight_dtype: torch.dtype = torch.bfloat16,
                        use_fused_kernel: bool | None = None) -> torch.Tensor:
    """The rollout's frozen embedding-reward stream: per step the GRU
    lookahead on the sampled action, ``semantic_embed``, the cosine against
    the normalised visual embedding, then the GRU advance on the placed
    token. ``actions``, ``tokens``: ``[N, S]`` from :func:`fused_rollout`.
    Returns ``rewards [N, S]`` f32, without gradient (Q7). CUDA tensors run
    the kernel (``csrc/reward_stream.cu``), CPU tensors the plain version."""
    rw = prepare_reward_weights(reward_params, features, start_tokens, weight_dtype)
    rewards = reward_stream(rw, actions.t().to(torch.int32).contiguous(),
                            tokens.t().to(torch.int32).contiguous(), use_fused_kernel)
    return rewards.t()


fused_reward_stream.launches = 0


# --------------------------------------------------------------------------
# The rollout
# --------------------------------------------------------------------------

_POLICY = (("embedding",), ("lstm", "wi"), ("lstm", "wh"), ("lstm", "b"), ("head", "w"),
           ("head", "b"))
_VALUE = (("embedding",), ("lstm", "wi"), ("lstm", "wh"), ("lstm", "b"), ("linear1", "w"),
          ("linear1", "b"), ("linear2", "w"), ("linear2", "b"))


class RolloutWeights(NamedTuple):
    """The policy and value weights in the kernels' layout: embeddings,
    ``[wi; wh]``, the head (``[H, Vp]``, zero columns past V), ``linear1``
    and ``linear2`` (``[H]``) in the working type; biases f32 (``hb`` padded
    with zeros to Vp)."""

    p_emb: torch.Tensor
    p_w: torch.Tensor
    p_b: torch.Tensor
    hw: torch.Tensor
    hb: torch.Tensor
    v_emb: torch.Tensor
    v_w: torch.Tensor
    v_b: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.p_w.dtype


def _prepare_weights(leaves, weight_dtype: torch.dtype) -> RolloutWeights:
    (p_emb, p_wi, p_wh, p_b, hw, hb, v_emb, v_wi, v_wh, v_b, w1, b1, w2,
     b2) = (t.detach() for t in leaves)
    hidden, vocab = hw.shape
    vp = _pad8(vocab)

    def wt(x):
        return x.to(weight_dtype).contiguous()

    hw_p = torch.zeros((hidden, vp), dtype=weight_dtype, device=hw.device)
    hw_p[:, :vocab] = hw
    hb_p = torch.zeros((vp,), dtype=_F32, device=hw.device)
    hb_p[:vocab] = hb
    return RolloutWeights(
        p_emb=wt(p_emb), p_w=wt(torch.cat([p_wi, p_wh])), p_b=p_b.to(_F32).contiguous(),
        hw=hw_p, hb=hb_p, v_emb=wt(v_emb), v_w=wt(torch.cat([v_wi, v_wh])),
        v_b=v_b.to(_F32).contiguous(), w1=wt(w1), b1=b1.to(_F32).contiguous(),
        w2=wt(w2.reshape(-1)), b2=b2.to(_F32).reshape(1).contiguous())


class RolloutTape(NamedTuple):
    """What the backward reads, step-major (row ``s N + r`` is sample r at
    step s): ``hp``, ``cp``, ``hv``, ``cv`` ``[S N, H]`` the states entering
    each step (the first N rows are the start states), ``gp``, ``gv``
    ``[(S - 1) N, 4H]`` the post-activation gates of each advance, ``v1``
    ``[S N, H]`` linear1's output, ``act`` and ``tok`` ``[S, N]`` int32 the
    actions and the placed tokens."""

    hp: torch.Tensor
    cp: torch.Tensor
    gp: torch.Tensor
    hv: torch.Tensor
    cv: torch.Tensor
    gv: torch.Tensor
    v1: torch.Tensor
    act: torch.Tensor
    tok: torch.Tensor


def _cell_plain(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
                c: torch.Tensor):
    """An LSTM advance on the embedding row ``x`` (f32 values of the working
    type) and f32 ``h``, ``c``: gates ``x @ wi + rnd(h) @ wh + b`` ->
    ``(h', c', post-activation gates)``."""
    e = x.shape[-1]
    gates = wmatmul(x, w[:e]) + wmatmul(round_to(h, w.dtype), w[e:]) + b
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new, torch.cat([i, f, g, o], dim=-1)


def rollout_forward_plain(curr: int, teach_sm: torch.Tensor, noise: torch.Tensor,
                          reward: RewardWeights | None, feats: torch.Tensor, ph1, pc1, vh1, vc1,
                          w: RolloutWeights, margins: bool = False):
    """The rollout kernel's forward in eager torch (no autograd) ->
    ``(values [S, N], log_probs [S, N], rewards [S, N] or None, tape)``, and
    with ``margins=True`` also the gap between the two largest noisy logits
    of every step, ``[S, N]`` (how close each sampled action came to a tie,
    which a comparison with the kernel needs)."""
    wd = w.dtype
    steps, n = teach_sm.shape
    f = feats.shape[1]
    vocab = w.p_emb.shape[0]
    hw, hb = w.hw[:, :vocab], w.hb[:vocab]
    fw1 = wmatmul(round_to(feats, wd), w.w1[:f])
    h_p, c_p, h_v, c_v = (x.detach().to(_F32) for x in (ph1, pc1, vh1, vc1))
    h_r = None if reward is None else reward.rew0
    p_emb, v_emb = w.p_emb.to(_F32), w.v_emb.to(_F32)
    out = {k: [] for k in ("hp", "cp", "gp", "hv", "cv", "gv", "v1", "act", "tok", "value",
                           "logp", "reward", "gap")}
    for s in range(steps):
        for k, x in (("hp", h_p), ("cp", c_p), ("hv", h_v), ("cv", c_v)):
            out[k].append(x)
        logits = wmatmul(round_to(h_p, wd), hw) + hb
        noisy = logits + noise[s]
        action = torch.argmax(noisy, dim=-1)  # first maximal index on ties
        if margins:
            top2 = torch.topk(noisy, 2, dim=-1).values
            out["gap"].append(top2[:, 0] - top2[:, 1])
        shifted = logits - torch.max(logits, dim=-1, keepdim=True).values
        lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
        out["logp"].append(torch.gather(shifted, 1, action[:, None])[:, 0] - lse)
        v1 = fw1 + wmatmul(round_to(h_v, wd), w.w1[f:]) + w.b1
        out["v1"].append(v1)
        out["value"].append(wmatmul(round_to(v1, wd), w.w2[:, None])[:, 0] + w.b2)
        token = teach_sm[s].long() if s + 1 < curr else action
        out["act"].append(action)
        out["tok"].append(token)
        if reward is not None:
            rew, h_r = _reward_step_plain(reward, h_r, action, token if s + 1 < steps else None)
            out["reward"].append(rew)
        if s + 1 < steps:
            h_p, c_p, g = _cell_plain(w.p_w, w.p_b, p_emb[token], h_p, c_p)
            out["gp"].append(g)
            h_v, c_v, g = _cell_plain(w.v_w, w.v_b, v_emb[token], h_v, c_v)
            out["gv"].append(g)

    def rows(k, width):
        return (torch.cat(out[k]) if out[k] else
                torch.empty((0, width), dtype=_F32, device=feats.device))

    hidden = w.p_b.shape[0] // 4
    tape = RolloutTape(
        hp=rows("hp", hidden), cp=rows("cp", hidden), gp=rows("gp", 4 * hidden),
        hv=rows("hv", hidden), cv=rows("cv", hidden), gv=rows("gv", 4 * hidden),
        v1=rows("v1", hidden), act=torch.stack(out["act"]).to(torch.int32),
        tok=torch.stack(out["tok"]).to(torch.int32))
    rewards = torch.stack(out["reward"]) if reward is not None else None
    result = (torch.stack(out["value"]), torch.stack(out["logp"]), rewards, tape)
    return result + (torch.stack(out["gap"]),) if margins else result


def _chain_grads_plain(tape_h, tape_c, gates, tok, emb, w_cat, dh_head, n, need_emb):
    """One encoder's backward through the shared chain backward: the S - 1
    advances from the start state, upstream dh_head of the next step's head;
    the start state's cotangent adds the first head's."""
    hidden = tape_h.shape[1]
    steps = tape_h.shape[0] // n
    emb_dim = emb.shape[1]
    h0, c0 = tape_h[:n], tape_c[:n]
    if steps == 1:
        zeros = torch.zeros_like(w_cat, dtype=_F32)
        demb = torch.zeros_like(emb, dtype=_F32) if need_emb else None
        return (zeros[:emb_dim], zeros[emb_dim:], torch.zeros(4 * hidden, dtype=_F32,
                                                              device=emb.device),
                demb, dh_head[:n].clone(), torch.zeros_like(c0))
    tok_c = tok[:-1]
    t = steps - 1
    dwi, dwh, db, demb, dh, dc = lstm_chain_backward_plain(
        dh_head[n:].reshape(t, n, hidden), tok_c, emb.to(_F32)[tok_c.long()], h0, c0,
        tape_h[n:].reshape(t, n, hidden), tape_c[n:].reshape(t, n, hidden),
        gates.reshape(t, n, 4 * hidden), w_cat[:emb_dim], w_cat[emb_dim:], emb.shape[0],
        need_emb)
    return dwi, dwh, db, demb, dh + dh_head[:n], dc


def rollout_backward_plain(tape: RolloutTape, feats: torch.Tensor, w: RolloutWeights,
                           dvalues: torch.Tensor, dlogp: torch.Tensor, need_emb=(True, True)):
    """The rollout kernel's backward in eager torch, from the tape and the
    step-major cotangents ``dvalues``, ``dlogp`` ``[S, N]`` -> the gradients
    of ``(feats, ph1, pc1, vh1, vc1, *policy leaves, *value leaves)`` in the
    order of ``_POLICY`` and ``_VALUE``."""
    wd = w.dtype
    steps, n = tape.act.shape
    f = feats.shape[1]
    vocab = w.p_emb.shape[0]
    hidden = tape.hp.shape[1]
    hw, hb = w.hw[:, :vocab], w.hb[:vocab]
    dlogp, dval = dlogp.reshape(-1).to(_F32), dvalues.reshape(-1).to(_F32)
    # policy head, all S N rows at once
    hp_w = round_to(tape.hp, wd)
    logits = wmatmul(hp_w, hw) + hb
    ex = torch.exp(logits - torch.max(logits, dim=-1, keepdim=True).values)
    softmax = ex / torch.sum(ex, dim=-1, keepdim=True)
    hot = torch.nn.functional.one_hot(tape.act.reshape(-1).long(), vocab).to(_F32)
    dlogits = dlogp[:, None] * (hot - softmax)
    dhw = wmatmul(hp_w.t(), dlogits.to(wd))
    dhb = dlogits.sum(dim=0)
    dh_head = wmatmul(round_to(dlogits, wd), hw.t())
    # value head
    dval_w = round_to(dval[:, None], wd)
    dw2 = wmatmul(round_to(tape.v1, wd).t(), dval_w.to(wd))
    db2 = dval.sum(dim=0, keepdim=True)
    dv1 = wmatmul(dval_w, w.w2[None, :])
    fh = torch.cat([feats.to(_F32).repeat(steps, 1), tape.hv], dim=1)
    dw1 = wmatmul(round_to(fh, wd).t(), dv1.to(wd))
    db1 = dv1.sum(dim=0)
    dfh = wmatmul(round_to(dv1, wd), w.w1.t())
    dfeat = dfh[:, :f].reshape(steps, n, f).sum(dim=0)
    dh_head_v = dfh[:, f:]
    p = _chain_grads_plain(tape.hp, tape.cp, tape.gp, tape.tok, w.p_emb, w.p_w, dh_head, n,
                           need_emb[0])
    v = _chain_grads_plain(tape.hv, tape.cv, tape.gv, tape.tok, w.v_emb, w.v_w, dh_head_v, n,
                           need_emb[1])
    return (dfeat, p[4], p[5], v[4], v[5],
            p[3], p[0], p[1], p[2], dhw, dhb,
            v[3], v[0], v[1], v[2], dw1, db1, dw2.reshape(hidden, 1), db2)


def _check_rollout_inputs(teach_sm, noise, reward, feats, states, w: RolloutWeights) -> None:
    """Device, type, shape and width checks of the rollout kernels' inputs,
    and the token range as a device assertion (no host sync)."""
    dev = feats.device
    steps, n = teach_sm.shape
    vocab, emb_dim = w.p_emb.shape
    hidden = w.p_b.shape[0] // 4
    if feats.dtype != _F32 or feats.dim() != 2 or feats.shape[0] != n:
        raise ValueError("features must be a float32 [N, F] tensor")
    if any(s.device != dev or s.dtype != _F32 or s.shape != (n, hidden) for s in states):
        raise ValueError("the start states must be float32 [N, H] tensors on the features' "
                         "device")
    if any(t.device != dev for t in w):
        raise ValueError("the weights must lie on the features' device")
    if teach_sm.dtype != torch.int32 or teach_sm.device != dev:
        raise ValueError("the teacher tokens must be an int32 [S, N] tensor on the features' "
                         "device")
    if noise.dtype != _F32 or noise.shape != (steps, n, vocab) or noise.device != dev:
        raise ValueError(f"the noise must be a float32 [S, N, V] = {(steps, n, vocab)} tensor "
                         f"on the features' device")
    if reward is not None:
        _check_reward_weights(reward, n, vocab)
    check_tile_widths(w.dtype, feat_dim=feats.shape[1], emb_dim=emb_dim, hidden=hidden)
    assert_tokens(f"tokens must lie in [0, {vocab})", vocab, teach_sm)


# The forward kernel's products in slice order (csrc/rollout_fwd.cuh
# RolloutMat); its plan tries the slice widths of fused_lstm._SLICE_UNITS.
ROLLOUT_PRODUCTS = ("head", "linear1", "policy", "value", "reward", "semantic")


def _rollout_smem(weight_dtype: torch.dtype, units: int, stream: bool, depth: int) -> int:
    """A block's shared memory (chain.cuh ``chain_smem``) for slices of
    ``depth`` rows."""
    kc = _CHAIN_RING[weight_dtype][0]
    return _chain_smem(weight_dtype, False, 4, units, stream, -(-depth // kc) * kc)


def rollout_columns(hidden: int, vp: int, reward: bool, reward_only: bool = False) -> tuple:
    """The columns of each product of a forward step, in slice order: the
    head's Vp, linear1's h half H, both cells' 4H, the reward GRU's 3H and
    ``semantic_embed``'s H (the last two only with the reward stream;
    ``reward_only``, the stream alone: the last two alone)."""
    stream = (3 * hidden, hidden) if reward or reward_only else (0, 0)
    if reward_only:
        return (0, 0, 0, 0, *stream)
    return (vp, hidden, 4 * hidden, 4 * hidden, *stream)


def rollout_plan(n: int, feat_dim: int, hidden: int, vp: int, weight_dtype: torch.dtype,
                 sm_count: int, reward: bool = True, reward_only: bool = False) -> dict:
    """The rollout forward's cooperative launch, as ``csrc/rollout_fwd.cuh:
    rollout_plan`` computes it.

    The columns of the six products (:func:`rollout_columns`) are cut, in
    that order, into slices of ``columns = 4 units`` consecutive columns:
    ``units`` is the widest (bf16 32, 16, 8; float32 16, 8) whose slice of
    ``max(H, F)`` rows fits shared memory beside the chains' staging ring
    while every slice gets a block of its own among the ``co_resident``
    blocks (one per SM): then each block keeps its slice for the whole
    rollout (``stream`` False). Otherwise the weights stream through the
    ring with the A rows every step (``stream`` True, the chains' streaming
    slice width), and block ``x`` walks slices ``x, x + grid_x, ...``. The
    blocks left over make ``row_groups`` (each a replica of the weights):
    block ``(x, g)`` takes the row tiles ``g, g + row_groups, ...`` of
    ``rows_per_tile`` rows. ``slice_table`` lists each slice as
    ``(product, first column, columns)``. No width is refused.

    ``reward_only``: the reward stream alone (``csrc/reward_stream.cu``),
    the same launch with only the reward GRU's and ``semantic_embed``'s
    columns, in slices of ``H`` rows (``feat_dim`` and ``vp`` unread)."""
    depth = hidden if reward_only else max(hidden, feat_dim)
    cols = rollout_columns(hidden, vp, reward, reward_only)

    def slices(nc):
        return sum(-(-c // nc) for c in cols)

    def co_resident(smem):  # one block per SM
        if smem > SMEM_PER_BLOCK:
            return 0
        return sm_count * min(1, SMEM_PER_SM // (smem + SMEM_RESERVED))

    for units in _SLICE_UNITS[weight_dtype]:
        smem = _rollout_smem(weight_dtype, units, False, depth)
        if co_resident(smem) >= slices(4 * units):
            stream = False
            break
    else:
        stream = True
        units = next(u for u in _CHAIN_RING[weight_dtype][2]
                     if _rollout_smem(weight_dtype, u, True, depth) <= SMEM_PER_BLOCK)
        smem = _rollout_smem(weight_dtype, units, True, depth)
    co = co_resident(smem)
    nc = 4 * units
    total = slices(nc)
    grid_x = min(total, co)
    row_groups = max(1, min(-(-max(n, 1) // CHAIN_ROWS), co // max(grid_x, 1)))
    table = [(m, c0, min(nc, c - c0)) for m, c in enumerate(cols) for c0 in range(0, c, nc)]
    return {"rows_per_tile": CHAIN_ROWS, "units": units, "columns": nc, "stream": stream,
            "slices": total, "slice_table": table, "row_groups": row_groups,
            "grid": (grid_x, row_groups), "smem_bytes": smem, "co_resident": co}


@functools.lru_cache(maxsize=None)
def _rollout_plan_args(n: int, feat_dim: int, hidden: int, vp: int, weight_dtype: torch.dtype,
                       index: int, reward: bool) -> tuple:
    """The plan's launch arguments for the card ``index`` (cached)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _launch_args(rollout_plan(n, feat_dim, hidden, vp, weight_dtype, sms, reward))


def _launch_args(p: dict) -> tuple:
    """A plan's six values as the C entries take them."""
    return (p["rows_per_tile"], p["units"], int(p["stream"]), p["grid"][0], p["row_groups"],
            p["smem_bytes"])


@functools.lru_cache(maxsize=None)
def _reward_plan_args(n: int, hidden: int, weight_dtype: torch.dtype, index: int) -> tuple:
    """The reward stream's plan (the reward-only mode), launch arguments for
    the card ``index`` (cached)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _launch_args(rollout_plan(n, hidden, hidden, 0, weight_dtype, sms, reward_only=True))


def combine_row_partials(logits: torch.Tensor, noise: torch.Tensor, v1w: torch.Tensor,
                         b2: torch.Tensor, se: torch.Tensor, vn: torch.Tensor, columns: int):
    """A plain model of the forward kernel's cross-slice combine (for tests):
    ``logits`` and ``noise`` ``[N, V]``, ``v1w = rnd(v1) * rnd(w2)`` and the
    semantic embedding ``se`` and ``vn`` ``[N, H]``, cut into slices of
    ``columns`` columns as the plan cuts them. Each slice keeps per row the
    maximum logit, the sum of ``exp(l - max)``, the largest noisy logit with
    its first index and its logit, and the sums of ``v1w``, ``se * se`` and
    ``vn * se``; the combine takes the slices in order (the first index wins
    an equal maximum across slices too) -> ``(action, log-prob, value,
    cosine)`` per row."""
    n, vocab = logits.shape
    m_all, se_all, best, idx, lb = [], [], None, None, None
    for c0 in range(0, vocab, columns):
        lg, y = logits[:, c0:c0 + columns], logits[:, c0:c0 + columns] + noise[:, c0:c0 + columns]
        m = lg.max(dim=1).values
        m_all.append(m)
        se_all.append(torch.exp(lg - m[:, None]).sum(dim=1))
        bv, bi = y.max(dim=1)  # the first maximal index within the slice
        bl = lg.gather(1, bi[:, None])[:, 0]
        if best is None:
            best, idx, lb = bv, bi + c0, bl
        else:
            take = bv > best  # strict: an earlier slice keeps an equal maximum
            best, idx, lb = (torch.where(take, bv, best), torch.where(take, bi + c0, idx),
                             torch.where(take, bl, lb))
    m_rows = torch.stack(m_all, dim=1)
    mx = m_rows.max(dim=1).values
    sum_exp = (torch.exp(m_rows - mx[:, None]) * torch.stack(se_all, dim=1)).sum(dim=1)
    logp = (lb - mx) - torch.log(sum_exp)
    hidden = v1w.shape[1]

    def sliced(x):
        return torch.stack([x[:, c0:c0 + columns].sum(dim=1)
                            for c0 in range(0, hidden, columns)], dim=1).sum(dim=1)

    value = sliced(v1w) + b2
    cosine = sliced(vn * se) / torch.clamp_min(torch.sqrt(sliced(se * se)), 1e-12)
    return idx, logp, value, cosine


def rollout_clock_slots(steps: int) -> int:
    """The length of the forward kernel's phase profile for ``steps`` steps
    (``clock`` of :func:`rollout_forward_kernel` and :func:`reward_stream`)."""
    return 2 + 4 * (steps + 1)


def _check_clock(clock: torch.Tensor | None, steps: int, dev: torch.device) -> None:
    if clock is not None and (clock.dtype != torch.int64 or clock.device != dev
                              or not clock.is_contiguous()
                              or clock.numel() < rollout_clock_slots(steps)):
        raise ValueError(f"clock must be {rollout_clock_slots(steps)} contiguous int64 zeros "
                         f"on {dev}")


def rollout_forward_kernel(curr: int, teach_sm: torch.Tensor, noise: torch.Tensor,
                           reward: RewardWeights | None, feats: torch.Tensor, ph1, pc1, vh1,
                           vc1, w: RolloutWeights, *, clock: torch.Tensor | None = None):
    """The forward through ``csrc/rollout_fwd.cu``: the two x-gate tables,
    then one cooperative launch for all S steps (:func:`rollout_plan`); the
    same results as :func:`rollout_forward_plain`.

    ``clock``, for a profile: int64 zeros of :func:`rollout_clock_slots` on
    the card, which the launch fills with the nanoseconds at which its last
    block passed each mark: 0 the start, 1 the slices loaded, then for step
    ``t`` (``t = S``: the last reward's pass) ``2 + 4t`` phase A entered,
    ``+ 1`` phase A done, ``+ 2`` phase B entered, ``+ 3`` phase B done."""
    _check_rollout_inputs(teach_sm, noise, reward, feats, (ph1, pc1, vh1, vc1), w)
    dev = feats.device
    steps, n = teach_sm.shape
    _check_clock(clock, steps, dev)
    vocab, emb_dim = w.p_emb.shape
    hidden = w.p_b.shape[0] // 4
    f = feats.shape[1]
    vp = w.hw.shape[1]
    rows = steps * n
    feats = feats.contiguous()
    noise = noise.contiguous()
    teach_sm = teach_sm.contiguous()
    p_xg = token_gate_table(w.p_emb, w.p_w)
    v_xg = token_gate_table(w.v_emb, w.v_w)

    def f32(*shape):
        return torch.empty(shape, dtype=_F32, device=dev)

    hp, cp, hv, cv, v1 = (f32(rows, hidden) for _ in range(5))
    gp, gv = f32(rows - n, 4 * hidden), f32(rows - n, 4 * hidden)
    for buf, x in ((hp, ph1), (cp, pc1), (hv, vh1), (cv, vc1)):
        buf[:n] = x.detach()
    values, logp = f32(steps, n), f32(steps, n)
    rewards = f32(steps, n) if reward is not None else None
    act = torch.empty((steps, n), dtype=torch.int32, device=dev)
    tok = torch.empty_like(act)
    rw = reward if reward is not None else RewardWeights(*([None] * 7))
    lib = load_library()
    with torch.cuda.device(dev):
        ws = f32(lib.icrl_rollout_workspace_floats(n, hidden, vp))
        err = lib.icrl_rollout_fwd(
            n, steps, f, emb_dim, hidden, vocab, vp, int(curr), int(w.dtype == torch.bfloat16),
            *_rollout_plan_args(n, f, hidden, vp, w.dtype, dev.index, reward is not None),
            _ptr(feats), _ptr(teach_sm), _ptr(noise), _ptr(p_xg), _ptr(w.p_w), _ptr(w.p_b),
            _ptr(w.hw), _ptr(w.hb), _ptr(v_xg), _ptr(w.v_w), _ptr(w.v_b), _ptr(w.w1),
            _ptr(w.b1), _ptr(w.w2), _ptr(w.b2), _ptr(rw.xg), _ptr(rw.wh), _ptr(rw.bh),
            _ptr(rw.sem_w), _ptr(rw.sem_b), _ptr(rw.vn), _ptr(rw.rew0), _ptr(values),
            _ptr(logp), _ptr(act), _ptr(tok), _ptr(rewards), _ptr(hp), _ptr(cp), _ptr(gp),
            _ptr(hv), _ptr(cv), _ptr(gv), _ptr(v1), _ptr(ws), _ptr(clock), _stream(dev))
    check_error(lib, "icrl_rollout_fwd", err)
    fused_rollout.fwd_launches += 1
    tape = RolloutTape(hp=hp, cp=cp, gp=gp, hv=hv, cv=cv, gv=gv, v1=v1, act=act, tok=tok)
    return values, logp, rewards, tape


# csrc/wgmma.cuh: the output tile and the depth slice of a block; the least
# depth of a split-K part, in slices (csrc/rollout.cu SPLITK_MIN_SLICES)
WG_TILE, WG_SLICE, SPLITK_MIN_SLICES = 128, 64, 4


def split_k_parts(tiles: int, depth: int, sm_count: int) -> int:
    """Parts of a product of ``depth`` rows among products of ``tiles``
    output tiles in all (``csrc/rollout.cu:splitk_parts``): as many as keep
    every part's blocks on the card at once, at most one part per
    ``SPLITK_MIN_SLICES`` slices of the depth, at least one."""
    slices = -(-depth // WG_SLICE)
    return max(1, min(sm_count // max(tiles, 1), slices // SPLITK_MIN_SLICES))


def split_k_ranges(depth: int, parts: int) -> list:
    """The depth rows ``[k0, k1)`` of each part, as ``wgmma_group_kernel``
    cuts them: whole 64-deep slices, part p taking slices ``[p nk / parts,
    (p + 1) nk / parts)`` of the ``nk = ceil(depth / 64)``."""
    nk = -(-depth // WG_SLICE)
    return [(p * nk // parts * WG_SLICE, min(depth, (p + 1) * nk // parts * WG_SLICE))
            for p in range(parts)]


def split_k_product(a: torch.Tensor, b: torch.Tensor, parts: int, arrival=None) -> torch.Tensor:
    """A plain model of a split-K product and its combine (for tests):
    ``a^T b`` for ``a [K, M]``, ``b [K, N]`` (float32), each part summing its
    depth rows (:func:`split_k_ranges`) into a slice of its own. The parts
    finish in any order (``arrival``, a permutation of ``range(parts)``;
    blocks run in no order on the card); the combine adds the slices in the
    order p = 0, 1, ..., so the result does not depend on ``arrival``."""
    slices = [None] * parts
    for p in range(parts) if arrival is None else arrival:
        k0, k1 = split_k_ranges(a.shape[0], parts)[p]
        slices[p] = a[k0:k1].t() @ b[k0:k1]
    out = slices[0].clone()
    for p in range(1, parts):
        out += slices[p]
    return out


def rollout_bwd_plan(n: int, steps: int, feat_dim: int, hidden: int, vp: int,
                     sm_count: int) -> dict:
    """The bf16 rollout backward's launch plan, as ``csrc/rollout.cu:
    rollout_bwd_plan`` computes it (float32 weights take none).

    ``parts``: the split-K parts of each of ``dhw = rnd(h_p)^T rnd(dlogits)``
    (``tiles`` ``ceil(H / 128) x ceil(Vp / 128)``) and ``dw1 = rnd([feats;
    h_v])^T rnd(dv1)`` (``ceil((F + H) / 128) x ceil(H / 128)``), both of
    depth ``S n`` (:func:`split_k_parts` over the two products' tiles).
    ``chains``: the plan of each encoder's backward recurrence,
    :func:`.fused_lstm.chain_plan` on half the SMs; the two run in one
    cooperative launch of ``grid = (grid_x, row_groups, 2)`` blocks, block
    ``(x, g, c)`` taking chain c's slices and row tiles as a chain's block
    ``(x, g)`` does, and sums its cells' gate gradients into ``db_rows =
    row_groups x (CHAIN_THREADS / units)`` rows of parts per chain. A card of fewer than
    two SMs is refused."""
    if sm_count < 2:
        raise ValueError(f"the rollout backward runs two chains side by side: it needs at least "
                         f"2 SMs, got {sm_count}")
    depth = steps * n
    tiles = {"dhw": -(-hidden // WG_TILE) * -(-vp // WG_TILE),
             "dw1": -(-(feat_dim + hidden) // WG_TILE) * -(-hidden // WG_TILE)}
    total = sum(tiles.values())
    chains = chain_plan(n, hidden, torch.bfloat16, sm_count // 2, backward=True)
    return {"depth": depth, "tiles": tiles,
            "parts": split_k_parts(total, depth, sm_count),
            "chains": chains, "grid": chains["grid"] + (2,),
            "db_rows": chains["row_groups"] * (CHAIN_THREADS // chains["units"])}


@functools.lru_cache(maxsize=None)
def _rollout_bwd_plan_args(n: int, steps: int, feat_dim: int, hidden: int, vp: int,
                           index: int) -> tuple:
    """The bf16 plan's launch arguments for the card ``index`` (cached), and
    its rows of db parts."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    p = rollout_bwd_plan(n, steps, feat_dim, hidden, vp, sms)
    c = p["chains"]
    return (p["parts"], c["rows_per_tile"], c["units"], int(c["stream"]), c["grid"][0],
            c["row_groups"], c["smem_bytes"]), p["db_rows"]


def _carved_size(shapes) -> int:
    """Float32 elements of consecutive regions of the given shapes, each
    starting on a 256-byte boundary (as ``Carver`` carves the kernels'
    workspaces)."""
    return sum(-(-math.prod(shape) // 64) * 64 for shape in shapes)


def _carve(buf: torch.Tensor, shapes) -> list:
    """Views of ``buf`` of the given shapes, laid out as :func:`_carved_size`
    counts them."""
    out, at = [], 0
    for shape in shapes:
        out.append(buf[at:at + math.prod(shape)].view(shape))
        at += _carved_size((shape,))
    return out


def rollout_backward_kernel(tape: RolloutTape, feats: torch.Tensor, w: RolloutWeights,
                            dvalues: torch.Tensor, dlogp: torch.Tensor, need_emb=(True, True)):
    """The backward through ``csrc/rollout.cu``, one C call: the same
    gradients as :func:`rollout_backward_plain`. The gradients are views of
    one buffer, the scratch (with ``dx`` of both chains) another."""
    dev = feats.device
    steps, n = tape.act.shape
    vocab, emb_dim = w.p_emb.shape
    hidden = tape.hp.shape[1]
    f = feats.shape[1]
    vp = w.hw.shape[1]
    bf16 = int(w.dtype == torch.bfloat16)
    feats = feats.to(_F32).contiguous()
    dlogp = dlogp.to(_F32).contiguous()
    dval = dvalues.to(_F32).contiguous()
    r1 = (steps - 1) * n
    shapes = _bwd_grad_shapes(n, f, emb_dim, hidden, vocab, vp)
    grads = _carve(torch.empty(_carved_size(shapes), dtype=_F32, device=dev), shapes)
    plan, db_rows = (_rollout_bwd_plan_args(n, steps, f, hidden, vp, dev.index) if bf16
                     else ((0,) * 7, 0))
    lib = load_library()
    ws_floats = lib.icrl_rollout_bwd_workspace_floats(n, steps, f, emb_dim, hidden, vp, bf16,
                                                      plan[0], db_rows)
    dx_shapes = ((r1, emb_dim), (r1, emb_dim))
    scratch = torch.empty(_carved_size(dx_shapes) + ws_floats, dtype=_F32, device=dev)
    dxp, dxv = _carve(scratch, dx_shapes)
    ws = scratch[_carved_size(dx_shapes):]
    (dfeat, dph1, dpc1, dvh1, dvc1, dpw, dpb, dhw, dhb, dvw, dvb, dw1, db1, dw2, db2) = grads
    err = lib.icrl_rollout_bwd(
        n, steps, f, emb_dim, hidden, vocab, vp, bf16, *plan, _ptr(tape.tok), _ptr(tape.act),
        _ptr(dlogp), _ptr(dval), _ptr(feats), _ptr(tape.hp), _ptr(tape.cp), _ptr(tape.gp),
        _ptr(tape.hv), _ptr(tape.cv), _ptr(tape.gv), _ptr(tape.v1), _ptr(w.p_emb), _ptr(w.p_w),
        _ptr(w.hw), _ptr(w.hb), _ptr(w.v_emb), _ptr(w.v_w), _ptr(w.w1), _ptr(w.w2), _ptr(ws),
        *(_ptr(t) for t in grads), _ptr(dxp), _ptr(dxv), dev.index, _stream(dev))
    check_error(lib, "icrl_rollout_bwd", err)
    fused_rollout.bwd_launches += 1
    tok_c = tape.tok[:-1]
    dp_emb = embedding_grad(dxp, tok_c, vocab) if need_emb[0] else None
    dv_emb = embedding_grad(dxv, tok_c, vocab) if need_emb[1] else None
    return (dfeat, dph1, dpc1, dvh1, dvc1,
            dp_emb, dpw[:emb_dim], dpw[emb_dim:], dpb, dhw, dhb[:vocab],
            dv_emb, dvw[:emb_dim], dvw[emb_dim:], dvb, dw1, db1, dw2.reshape(hidden, 1), db2)


def _bwd_grad_shapes(n: int, f: int, emb_dim: int, hidden: int, vocab: int, vp: int) -> tuple:
    """The shapes of the C entry's gradient outputs, in its order."""
    g4 = 4 * hidden
    return ((n, f), (n, hidden), (n, hidden), (n, hidden), (n, hidden), (emb_dim + hidden, g4),
            (g4,), (hidden, vocab), (vp,), (emb_dim + hidden, g4), (g4,), (f + hidden, hidden),
            (hidden,), (hidden,), (1,))


def _function_forward(ctx, forward, curr, weight_dtype, teach_sm, noise, reward, feats, ph1,
                      pc1, vh1, vc1, *leaves):
    w = _prepare_weights(leaves, weight_dtype)
    values, logp, rewards, tape = forward(curr, teach_sm, noise, reward, feats.detach(), ph1,
                                          pc1, vh1, vc1, w)
    ctx.tape, ctx.weights, ctx.feats = tape, w, feats.detach()
    if rewards is None:
        rewards = values.new_empty((0,))
    ctx.mark_non_differentiable(tape.act, tape.tok, rewards)
    return values, logp, tape.act, tape.tok, rewards


def _function_backward(ctx, backward, dvalues, dlogp):
    if dvalues is None:
        dvalues = torch.zeros_like(ctx.tape.act, dtype=_F32)
    if dlogp is None:
        dlogp = torch.zeros_like(ctx.tape.act, dtype=_F32)
    # inputs: curr, weight_dtype, teach_sm, noise, reward, feats, 4 states, leaves
    first = 10
    need = ctx.needs_input_grad
    grads = backward(ctx.tape, ctx.feats, ctx.weights, dvalues, dlogp,
                     need_emb=(need[first], need[first + len(_POLICY)]))
    return (None,) * 5 + tuple(grads)


class _RolloutPlain(torch.autograd.Function):
    """The rollout in eager torch (any device), as an autograd ``Function``:
    ``apply(curr, weight_dtype, teach_sm, noise, reward, feats, ph1, pc1,
    vh1, vc1, *leaves)`` with the policy's and the value's leaves in the
    order of ``_POLICY`` and ``_VALUE`` -> step-major ``(values,
    log_probs, actions, tokens, rewards)`` (rewards empty without a reward
    stream)."""

    @staticmethod
    def forward(ctx, *args):
        return _function_forward(ctx, rollout_forward_plain, *args)

    @staticmethod
    def backward(ctx, dvalues, dlogp, *_):
        return _function_backward(ctx, rollout_backward_plain, dvalues, dlogp)


class _RolloutKernel(torch.autograd.Function):
    """The rollout through ``csrc/rollout_fwd.cu`` and ``csrc/rollout.cu``,
    over the same arguments as :class:`_RolloutPlain`: one C call forward
    (one kernel launch beside the x-gate tables), one backward. The x-gate
    tables are rebuilt each call (the weights change every optimiser
    step)."""

    @staticmethod
    def forward(ctx, *args):
        return _function_forward(ctx, rollout_forward_kernel, *args)

    @staticmethod
    def backward(ctx, dvalues, dlogp, *_):
        return _function_backward(ctx, rollout_backward_kernel, dvalues, dlogp)


def _leaf(tree: dict, path: tuple) -> torch.Tensor:
    for k in path:
        tree = tree[k]
    return tree


def _check_nets(pparams: dict, vparams: dict, reward_params: dict | None) -> None:
    """The JAX package's checks (``pallas_rollout.py:843-868``)."""
    if "lstm" not in pparams or "lstm" not in vparams:
        raise ValueError("fused rollout requires unidirectional networks")
    if (vparams["embedding"].shape != pparams["embedding"].shape
            or vparams["lstm"]["wh"].shape != pparams["lstm"]["wh"].shape):
        raise ValueError(
            "fused rollout requires policy and value networks with matching embedding/hidden "
            f"dims (policy {tuple(pparams['embedding'].shape)}/"
            f"{tuple(pparams['lstm']['wh'].shape)}, value {tuple(vparams['embedding'].shape)}/"
            f"{tuple(vparams['lstm']['wh'].shape)})")
    if reward_params is not None and (
            reward_params["embedding"].shape != pparams["embedding"].shape
            or reward_params["gru"]["wh"].shape[0] != pparams["lstm"]["wh"].shape[0]):
        raise ValueError(
            "in-kernel reward stream requires a reward net matching the policy's "
            f"embedding/hidden dims (policy {tuple(pparams['embedding'].shape)}, reward "
            f"{tuple(reward_params['embedding'].shape)})")


def rollout_leaves(a2c_params: dict) -> list:
    """The policy's and the value's parameter leaves in the order the
    rollout ``Function``s take them (``_POLICY``, then ``_VALUE``)."""
    return ([_leaf(a2c_params["policy"], p) for p in _POLICY]
            + [_leaf(a2c_params["value"], p) for p in _VALUE])


def prepare_rollout_weights(a2c_params: dict,
                            weight_dtype: torch.dtype = torch.bfloat16) -> RolloutWeights:
    """The policy and value weights in the kernels' layout (no gradient)."""
    _check_weight_dtype(weight_dtype)
    return _prepare_weights(rollout_leaves(a2c_params), weight_dtype)


def start_states(a2c_params: dict, cfg, features: torch.Tensor, start: torch.Tensor):
    """The states entering the first rollout step, in plain torch (with
    gradient), as the JAX package computes them outside its kernel: the
    policy's ``h0 = cnn2linear(features)`` advanced by the start-token cell,
    and the value encoder's start-token cell from zeros -> ``(ph1, pc1,
    vh1, vc1)``."""
    pparams, vparams = a2c_params["policy"], a2c_params["value"]
    n = features.shape[0]
    h0, c0 = policy_mod.init_decode_state(pparams, cfg, features)
    ph1, pc1 = lstm_cell(pparams["lstm"], pparams["embedding"][start], (h0, c0))
    vh1, vc1 = value_mod.rnn_step(vparams, cfg, start,
                                  value_mod.zero_rnn_state(cfg, n, features.device))
    return ph1, pc1, vh1, vc1


def rollout_from_noise(a2c_params: dict, cfg, features: torch.Tensor, captions: torch.Tensor,
                       curr_seq_len: int, noise: torch.Tensor,
                       weight_dtype: torch.dtype = torch.bfloat16, reward_params: dict = None,
                       use_fused_kernel: bool | None = None):
    """:func:`fused_rollout` on given Gumbel noise ``[S, N, V]`` (row s is the
    draw of step s) instead of noise drawn from a key."""
    _check_nets(a2c_params["policy"], a2c_params["value"], reward_params)
    _check_weight_dtype(weight_dtype)
    start = captions[:, 0].long()
    ph1, pc1, vh1, vc1 = start_states(a2c_params, cfg, features, start)
    teach_sm = captions[:, 1:].t().to(torch.int32).contiguous()
    reward = None if reward_params is None else prepare_reward_weights(
        reward_params, features, start, weight_dtype)
    if use_fused_kernel is False or (not features.is_cuda and not use_fused_kernel):
        fn = _RolloutPlain
    elif not features.is_cuda:
        raise RuntimeError("use_fused_kernel=True needs CUDA tensors: the rollout kernels run "
                           "only on a CUDA device")
    else:
        fn = _RolloutKernel
        emb_dim, hidden = a2c_params["policy"]["embedding"].shape[1], ph1.shape[1]
        if needs_padding(emb_dim, hidden, features.shape[1]):
            a2c_params, features, (ph1, pc1, vh1, vc1) = pad_rollout_inputs(
                a2c_params, features, (ph1, pc1, vh1, vc1))
    leaves = rollout_leaves(a2c_params)
    values, logp, act, tok, rewards = fn.apply(int(curr_seq_len), weight_dtype, teach_sm,
                                               noise.to(_F32), reward, features.to(_F32), ph1,
                                               pc1, vh1, vc1, *leaves)
    result = (values.t(), logp.t(), act.t(), tok.t())
    return result + (rewards.t(),) if reward_params is not None else result


def pad_rollout_inputs(a2c_params: dict, features: torch.Tensor, states: tuple):
    """The rollout's policy and value leaves, features and start states
    padded to the kernels' widths (:mod:`.padding`): E, F and H to
    multiples of 8, differentiably (the head's vocabulary is padded by the
    kernels' own weight layout)."""
    p, v = a2c_params["policy"], a2c_params["value"]
    emb_dim, hidden = p["embedding"].shape[1], states[0].shape[1]
    feat_dim = features.shape[1]
    ep, hp, fp = pad8(emb_dim), pad8(hidden), pad8(feat_dim)
    l1, l2 = v["linear1"], v["linear2"]
    padded = {
        "policy": {"embedding": pad_dim(p["embedding"], 1, ep),
                   "lstm": pad_cell(p["lstm"], 4, ep, hp),
                   "head": {"w": pad_dim(p["head"]["w"], 0, hp), "b": p["head"]["b"]}},
        "value": {"embedding": pad_dim(v["embedding"], 1, ep),
                  "lstm": pad_cell(v["lstm"], 4, ep, hp),
                  "linear1": {"w": pad_dim(pad_split_rows(l1["w"], feat_dim, fp, hp), 1, hp),
                              "b": pad_dim(l1["b"], 0, hp)},
                  "linear2": {"w": pad_dim(l2["w"], 0, hp), "b": l2["b"]}},
    }
    return padded, pad_dim(features, 1, fp), tuple(pad_dim(s, 1, hp) for s in states)


def fused_rollout(a2c_params: dict, cfg, features: torch.Tensor, captions: torch.Tensor,
                  curr_seq_len: int, rng, weight_dtype: torch.dtype = torch.bfloat16,
                  reward_params: dict = None, use_fused_kernel: bool | None = None):
    """The A2C rollout of ``a2c_params`` (``{"policy", "value"}``) from
    ``captions[:, 0]``, teacher-forcing positions ``p < curr_seq_len``.

    Returns ``(values [N, S], log_probs [N, S], actions [N, S], tokens [N,
    S])`` with S = T - 1 (actions and tokens int32), differentiable with
    respect to every policy and value parameter and the features; with
    ``reward_params`` the frozen reward stream runs inside the rollout and
    a fifth array, ``rewards [N, S]`` (no gradient), follows. The actions
    are ``jax.random.categorical`` draws: step s's noise is
    ``gumbel(split(rng, S)[s], (N, V))`` from the host key ``rng`` (uint32
    ``[2]``), made on the features' device (:func:`.prng.gumbel_noise`).
    Weights act in ``weight_dtype`` (bf16 by default, as the TPU kernel).

    CUDA tensors run the kernels (``csrc/rollout_fwd.cu``,
    ``csrc/rollout.cu``), CPU tensors the plain versions; ``use_fused_kernel=False`` forces the plain versions,
    ``True`` on CPU tensors raises."""
    steps = captions.shape[1] - 1
    vocab = a2c_params["policy"]["embedding"].shape[0]
    noise = gumbel_noise(split(rng, steps), (captions.shape[0], vocab), features.device)
    return rollout_from_noise(a2c_params, cfg, features, captions, curr_seq_len, noise,
                              weight_dtype, reward_params, use_fused_kernel)


fused_rollout.fwd_launches = 0
fused_rollout.bwd_launches = 0
