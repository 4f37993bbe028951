"""A2C training through the program's ``train.loops.a2c_training``, the
default walk: the train split on the device, 16 minibatches a dispatch,
the fused rollout with the reward stream inside it, the weights and the
``.trainstate`` written after every epoch.

Set-up builds one training object (the networks, from the seed on the
device, and one Adam over the policy and the critic) and drives it through
the trainer's first three steps on rows of their own: one epoch of one
minibatch, then a resumed epoch of one whole and one ragged minibatch (the
window's two shapes). The reference follows those three steps. The same
object then enters the trainer once more, resumed, on the COCO-size split:
its first ``warmup_epochs`` epochs are set-up, the next ones the window.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench import counts, splits, traffic, trainrun
from portbench.reference import judge, nets
from portbench.reference import train as ref

# the trainer's end-of-epoch line starts "Training A2C Network (<e>/<E>)"
EPOCH_LINE = "Training A2C Network"
LOSS_TAG = "A2C Network-episodic-loss"


def _leaves(cfg):
    return (nets.policy_leaves(cfg, ("policy",)) + nets.value_leaves(cfg, ("value",))
            + nets.reward_leaves(cfg, ("reward",)))


def _weights(cfg, seed, device):
    leaves = _leaves(cfg)
    tensors = traffic.draw_weights(traffic.sub_seed(seed, 2), [l[1:] for l in leaves], device)
    return nets.build_tree(leaves, tensors)


def first_steps(ctx, with_train: bool = True) -> dict:
    """Set-up up to the window: the inputs and the training object, driven
    through the trainer's first three steps; what the check reads of them
    (the logged losses, Adam's first moment after one step, the weights
    after three)."""
    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.train.loops import a2c_training
    from image_captioning_through_rl_tpu_torch.train.optim import adam

    cfg, tr, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    word_to_idx, idx_to_word = traffic.vocab(cfg["vocab_size"])
    train, checks = splits.train_splits(ctx.seed, tr, cfg, with_train)
    tseed = traffic.sub_seed(ctx.seed, 3)
    net_cfg = NetConfig.for_vocab(word_to_idx, None, input_dim=cfg["input_dim"],
                                  wordvec_dim=cfg["wordvec_dim"], hidden_dim=cfg["hidden_dim"])
    tree = _weights(cfg, ctx.seed, dev)
    a2c_params = {"policy": tree["policy"], "value": tree["value"]}
    optimizer = adam(cfg["a2c_lr"], a2c_params, net_cfg.freeze_embeddings)
    leaf_of = nets.flat(a2c_params)
    work = ctx.workdir
    common = dict(optimizer=optimizer, cfg=net_cfg,
                  save_paths=[os.path.join(work, "a2cNetwork.ckpt")], batch_size=tr["batch_size"],
                  seed=tseed, train_state_path=os.path.join(work, "a2cNetwork.ckpt.trainstate"))
    losses, g1 = [], None
    for i, split in enumerate(checks):
        plot = os.path.join(work, f"check{i}")
        with ctx.spans.span("checked_steps"):
            a2c_training(splits.coco_data(split, word_to_idx, idx_to_word), a2c_params,
                         tree["reward"], plot_dir=plot, epochs=i + 1, resume=i > 0, **common)
        losses += splits.logged(plot, LOSS_TAG)
        if i == 0:  # Adam's first moment after one step is (1 - beta1) g; none, 0
            g1 = {k: (optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p)) / 0.1)
                  .detach().cpu() for k, p in leaf_of.items()}
    p3 = {k: p.detach().cpu().clone() for k, p in leaf_of.items()}
    return {"train": train, "checks": checks, "tseed": tseed, "losses": losses, "g1": g1,
            "p3": p3, "a2c_params": a2c_params, "reward_params": tree["reward"],
            "common": common, "vocab": (word_to_idx, idx_to_word)}


def run(ctx) -> dict:
    from image_captioning_through_rl_tpu_torch.train.loops import a2c_training

    cfg, tr = ctx.config, ctx.traffic
    batch = tr["batch_size"]
    st = first_steps(ctx)
    train, checks = st["train"], st["checks"]

    # set-up's warm-up epochs, then the window, in one resumed trainer call
    warm = int(tr["warmup_epochs"])
    epochs = splits.epochs_for(ctx.seconds, tr["epoch_seconds"])
    total = len(checks) + warm + epochs + (1 if ctx.trace else 0)
    full = splits.coco_data(train, *st["vocab"])
    w = trainrun.timed_epochs(ctx, EPOCH_LINE, lambda: a2c_training(
        full, st["a2c_params"], st["reward_params"], plot_dir=None, epochs=total, resume=True,
        **st["common"]), warm, epochs)
    trainrun.read_peak(ctx)
    window = w["end"] - w["start"]
    n_cap = train.captions.shape[0]
    full_mb, tail = divmod(n_cap, batch)
    shape = (cfg["vocab_size"], cfg["wordvec_dim"], cfg["hidden_dim"], cfg["input_dim"])
    s = cfg["max_seq_len"] - 1
    flops = (full_mb * counts.a2c_minibatch_flops(batch, s, *shape)
             + (counts.a2c_minibatch_flops(tail, s, *shape) if tail else 0))
    minibatches = [batch] * full_mb + ([tail] if tail else [])
    losses = st["losses"]
    for k in ("a2c_params", "reward_params", "common"):
        del st[k]
    del full
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    limits = ctx.cell.spec["limits"]
    with ctx.spans.span("reference"):
        nums = readings(ctx, st)
    checks_out = {k: (nums[k], lim) for k, lim in limits.items()}
    return {"end_to_end": {"setup_s": w["start"] - ctx.t_start,
                           "train_samples_per_s": epochs * n_cap / window},
            "attempted": epochs * len(minibatches), "failed": 0,
            "checks": checks_out, "device": trainrun.device_info(ctx),
            "trace_info": {"minibatches": minibatches, "steps": s, "shape": shape,
                           "window_s": window, "window_flops": epochs * flops},
            "notes": {"epochs": epochs, "window_s": window, "losses": losses}}


def reference_steps(cfg, seed, checks, tseed, batch, lr, device, prec=nets.F32, half=False):
    """The reference's three steps from the same weights, rows and keys:
    ``(losses, scales, first gradient, weights after three steps, initial
    weights)`` as dicts of path -> tensor. ``prec`` rounds every product's
    operands (the control); ``half`` leaves out the second half of each
    minibatch and takes the mean over the rest (a planted fault)."""
    nets.tf32_off()
    tree = _weights(cfg, seed, device)
    p0 = {k: v.detach().clone() for k, v in nets.flat({"policy": tree["policy"],
                                                        "value": tree["value"]}).items()}
    params = {k: v.requires_grad_() for k, v in nets.flat({"policy": tree["policy"],
                                                            "value": tree["value"]}).items()}
    opt = ref.Adam(params, lr)
    feed = ref.a2c_feed(tseed, [c.captions.shape[0] for c in checks], batch)
    sizes = np.cumsum([0] + [len(ref.epoch_masks(np.random.default_rng(0),
                                                 c.captions.shape[0], batch)) for c in checks])
    losses, scales, g1 = [], [], None
    for j, (mask, key) in enumerate(feed):
        split = checks[int(np.searchsorted(sizes, j, side="right") - 1)]
        caps, feats = split.rows(mask[: len(mask) // 2] if half else mask)
        loss, scale, _ = ref.a2c_loss(tree["policy"], tree["value"], tree["reward"],
                                      torch.from_numpy(feats).to(device),
                                      torch.from_numpy(caps).long().to(device), key, prec)
        grads = ref.grads_of(loss, params)
        if g1 is None:
            g1 = {k: g.detach().cpu() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
        scales.append(float(scale))
    p3 = {k: v.detach().cpu() for k, v in params.items()}
    return losses, scales, g1, p3, {k: v.cpu() for k, v in p0.items()}


def compare(losses, g1, p3, ref_out) -> dict:
    """The check's numbers: the worst step's loss gap (against the loss
    terms' mean magnitude), the worst leaf's first-gradient norm gap and
    the worst leaf's three-step change norm gap."""
    r_losses, r_scales, r_g1, r_p3, p0 = ref_out
    loss_gap = max(abs(a - b) / s for a, b, s in zip(losses, r_losses, r_scales))
    leaves = judge.counted(r_g1)
    grad_gap, _ = judge.worst_leaf_gap(g1, r_g1, leaves)
    delta_gap, _ = judge.worst_leaf_gap({k: p3[k] - p0[k] for k in leaves},
                                        {k: r_p3[k] - p0[k] for k in leaves}, leaves)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "delta_gap": delta_gap}


def readings(ctx, st, program=None) -> dict:
    """The check's numbers for the program's first three steps in ``st``
    (or for ``program``, a :func:`reference_steps` result standing in for
    the program: the control, or a planted fault) against the reference."""
    cfg, tr = ctx.config, ctx.traffic
    ref_out = reference_steps(cfg, ctx.seed, st["checks"], st["tseed"], tr["batch_size"],
                              cfg["a2c_lr"], torch.device(ctx.device))
    if program is not None:
        return compare(program[0], program[2], program[3], ref_out)
    if len(st["losses"]) != 3:
        return {k: float("nan") for k in ("loss_gap", "grad_gap", "delta_gap")}
    return compare(st["losses"], st["g1"], st["p3"], ref_out)
