"""The reference's training steps: the A2C update on sampled rollouts and
the caption-length-weighted XE update of the policy, each followed by one
Adam step (torch's ``optim.Adam`` arithmetic, betas 0.9 and 0.999, eps
1e-8), as the paper's trainers take them (pratikpv ``trainers.py``), with
that code's quirks: the advantage is ``V - r`` with no stop-gradient (the
actor term reaches the critic), the A2C mean runs over the steps ``1 <= p
<= caplen - 1`` of the batch's longest caption, and the XE sums the first
``caplen`` target positions of each row and divides by the batch size.

:func:`a2c_feed` and :func:`pretrain_feed` replay the trainers' published
walk (one numpy permutation an epoch from ``default_rng(seed + 3)``, resp.
``seed + 1``, sliced in minibatches of 512 with a ragged tail; one threefry
key split off per A2C minibatch from ``PRNGKey(seed + 3)``), so the
reference takes the rows and keys the program took without asking it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import nets, prng
from .nets import F32, Prec

END_ID = 2


class Adam:
    """torch's Adam over the leaves of ``params`` (a dict of path -> leaf)."""

    def __init__(self, params: dict, lr: float):
        self.params = dict(params)
        self.lr, self.b1, self.b2, self.eps = lr, 0.9, 0.999, 1e-8
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / (bc2 ** 0.5) + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def caplen(captions: torch.Tensor) -> torch.Tensor:
    """END position + 1 of each row."""
    return torch.argmax((captions == END_ID).to(torch.int32), dim=1) + 1


def a2c_loss(pol: dict, val: dict, rew: dict, feats, caps, k, prec: Prec = F32):
    """The plain A2C loss of one minibatch (rollout from the start column,
    ``S = T - 1`` sampled steps under the minibatch key ``k``): ``(loss,
    scale, actions)``, ``scale`` the mean of the loss terms' magnitudes,
    which a gap of losses is measured against (the loss itself, a sum of
    terms of both signs, can lie near 0)."""
    n, t_max = caps.shape
    dev = feats.device
    zero = torch.zeros((n, pol["lstm"]["wh"].shape[0]), device=dev)
    start = caps[:, 0]
    h0 = nets.dense(feats, pol["cnn2linear"], prec)
    ps = nets.lstm_cell(pol["lstm"], pol["embedding"][start], (h0, zero), prec)
    vs = nets.lstm_cell(val["lstm"], val["embedding"][start], (zero, zero), prec)
    with torch.no_grad():
        rs = nets.gru_cell(rew["gru"], rew["embedding"][start], zero, prec)
        ve = nets.dense(feats, rew["visual_embed"], prec)
    step_keys = prng.split(k, t_max - 1)
    values, rewards, logps, actions = [], [], [], []
    for p in range(1, t_max):
        logits = nets.dense(ps[0], pol["head"], prec)
        noise = prng.gumbel(step_keys[p - 1], (n, logits.shape[1]), dev)
        action = torch.argmax(noise + logits.detach(), dim=-1)
        actions.append(action)
        logps.append(torch.gather(torch.log_softmax(logits, dim=-1), 1, action[:, None])[:, 0])
        state = torch.cat([feats, vs[0]], dim=-1)
        hidden = nets.dense(state, val["linear1"], prec)
        values.append(nets.dense(hidden, val["linear2"], prec)[:, 0])
        with torch.no_grad():
            rs = nets.gru_cell(rew["gru"], rew["embedding"][action], rs, prec)
            rewards.append(nets.cosine(ve, nets.dense(rs, rew["semantic_embed"], prec)))
        ps = nets.lstm_cell(pol["lstm"], pol["embedding"][action], ps, prec)
        vs = nets.lstm_cell(val["lstm"], val["embedding"][action], vs, prec)
    values, rewards, logps = (torch.stack(x, dim=1) for x in (values, rewards, logps))
    p_idx = torch.arange(1, t_max, device=dev)[None, :]
    mask = (p_idx >= 1) & (p_idx <= torch.max(caplen(caps)) - 1)
    mask = mask.to(values.dtype).expand_as(values)
    adv = values - rewards
    denom = torch.clamp_min(mask.sum(), 1.0)
    actor, critic = -logps * adv * mask, 0.5 * adv * adv * mask
    loss = (torch.sum(actor) + torch.sum(critic)) / denom
    scale = (torch.sum(torch.abs(actor)) + torch.sum(critic)).detach() / denom
    return loss, scale, torch.stack(actions, dim=1)


def xe_loss(pol: dict, feats, caps, prec: Prec = F32):
    """The policy's teacher-forced caption-length-weighted XE."""
    n, t = caps.shape
    h = nets.dense(feats, pol["cnn2linear"], prec)
    state = (h, torch.zeros_like(h))
    logits = []
    for s in range(t - 1):
        state = nets.lstm_cell(pol["lstm"], pol["embedding"][caps[:, s]], state, prec)
        logits.append(nets.dense(state[0], pol["head"], prec))
    logp = torch.log_softmax(torch.stack(logits, dim=1), dim=-1)
    tgt = torch.gather(logp, -1, caps[:, 1:, None].long())[..., 0]
    mask = (torch.arange(t - 1, device=feats.device)[None, :] < caplen(caps)[:, None]).to(tgt.dtype)
    return torch.sum(-tgt * mask) / n


def grads_of(loss, params: dict) -> dict:
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def epoch_masks(rng: np.random.Generator, num: int, batch: int, chunk: int = 16):
    """The row sets of one epoch of the trainers' chunked walk: one
    permutation, minibatches of ``batch`` in chunks of up to ``chunk``, the
    ragged tail a minibatch of its own."""
    perm = rng.permutation(num)
    out, i = [], 0
    while i < num:
        k = max(1, min(chunk, (num - i) // batch))
        mask = perm[i: i + k * batch]
        n = len(mask) // k
        out += [mask[j * n: (j + 1) * n] for j in range(k)]
        i += len(mask)
    return out


def a2c_feed(seed: int, epoch_sizes, batch: int):
    """``[(rows, key), ...]`` of the A2C trainer's first epochs, one epoch
    of ``epoch_sizes[e]`` caption rows each (the rows index that epoch's
    split)."""
    rng, k = np.random.default_rng(seed + 3), prng.key(seed + 3)
    out = []
    for num in epoch_sizes:
        for mask in epoch_masks(rng, num, batch):
            pair = prng.split(k)
            k, sub = pair[0], pair[1]
            out.append((mask, sub))
    return out


def pretrain_feed(seed: int, epoch_sizes, batch: int):
    """The policy pretrainer's minibatch rows of its first epochs."""
    rng = np.random.default_rng(seed + 1)
    out = []
    for num in epoch_sizes:
        perm = rng.permutation(num)
        i = 0
        while i < num:
            k = min(16, (num - i) // batch)
            if k >= 1:
                out += [perm[i + j * batch: i + (j + 1) * batch] for j in range(k)]
                i += k * batch
            else:
                out.append(perm[i:])
                i = num
    return out
