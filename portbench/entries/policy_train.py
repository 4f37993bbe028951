"""Teacher-forced XE pretraining of the policy through the program's
``train.loops.train_policy_network``, its default walk on the card: the
train split on the device, 16 minibatches a dispatch replayed as one
captured CUDA graph, the frozen published word vectors as the table, the
best-loss checkpoint written when a chunk improves on the best loss and
the ``.trainstate`` after every epoch.

The trainer makes its own networks and optimiser from its seed; the
training object it drives lives in its ``.trainstate`` from one call to
the next. Set-up drives it through its first three steps on rows of their
own (one epoch of one minibatch, then a resumed epoch of one whole and one
ragged minibatch: the window's shapes), which the reference follows from
the same seed. The trainer then resumes on the COCO-size split, as a run
in progress resumes: its first ``warmup_epochs`` epochs are set-up (the
graphs captured, the best loss brought down to where new bests are as
rare as in a run in progress), the next ones the window.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench import counts, splits, traffic, trainrun
from portbench.reference import judge, nets
from portbench.reference import train as ref

# the trainer's end-of-epoch line starts "Training Policy Network (<e>/<E>)"
EPOCH_LINE = "Training Policy Network"
LOSS_TAG = "Policy Network-loss"
TRAINED = (("cnn2linear", "b"), ("cnn2linear", "w"), ("head", "b"), ("head", "w"),
           ("lstm", "b"), ("lstm", "wh"), ("lstm", "wi"))


def _state(path, template):
    """The program's snapshot: its weights and Adam's first moment by leaf."""
    from image_captioning_through_rl_tpu_torch.train import checkpoint as ckpt
    st = ckpt.load_train_state(path, template)
    opt = st["opt_state"]
    inner = opt["inner_states"]["train"]["inner_state"] if "inner_states" in opt else opt
    mu = inner["0"]["mu"]
    params = nets.flat(st["params"])
    first = {k: torch.from_numpy(np.array(mu[k[0]][k[1]], np.float32)) for k in TRAINED}
    return params, first


def first_steps(ctx, with_train: bool = True) -> dict:
    """Set-up up to the window: the inputs, and the trainer driven through
    its first three steps; what the check reads of them (the logged
    losses, Adam's first moment after one step and the weights after three,
    from the trainer's snapshots)."""
    from image_captioning_through_rl_tpu_torch.train.loops import train_policy_network

    cfg, tr = ctx.config, ctx.traffic
    word_to_idx, idx_to_word = traffic.vocab(cfg["vocab_size"])
    train, checks = splits.train_splits(ctx.seed, tr, cfg, with_train)
    vectors = traffic.word_vectors(np.random.default_rng(traffic.sub_seed(ctx.seed, 4)),
                                   cfg["vocab_size"], cfg["wordvec_dim"])
    tseed = traffic.sub_seed(ctx.seed, 3)
    ckpt_path = os.path.join(ctx.workdir, "policyNetwork.ckpt")
    common = dict(network_paths={"policy_network": ckpt_path}, bidirectional=False,
                  batch_size=tr["batch_size"], lr=cfg["policy_lr"], seed=tseed,
                  device=ctx.device, train_state_path=ckpt_path + ".trainstate",
                  net_dims={"input_dim": cfg["input_dim"], "hidden_dim": cfg["hidden_dim"]})
    losses, g1, p3 = [], None, None
    for i, split in enumerate(checks):
        plot = os.path.join(ctx.workdir, f"check{i}")
        with ctx.spans.span("checked_steps"):
            params = train_policy_network(splits.coco_data(split, word_to_idx, idx_to_word,
                                                           vectors),
                                          plot_dir=plot, epochs=i + 1, resume=i > 0, **common)
        losses += splits.logged(plot, LOSS_TAG)
        template = {k: {kk: vv.detach().cpu() for kk, vv in v.items()}
                    if isinstance(v, dict) else v.detach().cpu() for k, v in params.items()}
        p, first = _state(common["train_state_path"], template)
        if i == 0:
            g1 = {k: v / 0.1 for k, v in first.items()}
        p3 = {k: p[k] for k in TRAINED}
    return {"train": train, "checks": checks, "vectors": vectors, "tseed": tseed,
            "losses": losses, "g1": g1, "p3": p3, "common": common,
            "vocab": (word_to_idx, idx_to_word)}


def run(ctx) -> dict:
    from image_captioning_through_rl_tpu_torch.train.loops import train_policy_network

    cfg, tr = ctx.config, ctx.traffic
    batch = tr["batch_size"]
    st = first_steps(ctx)
    train, checks, vectors = st["train"], st["checks"], st["vectors"]
    warm = int(tr["warmup_epochs"])
    epochs = splits.epochs_for(ctx.seconds, tr["epoch_seconds"])
    total = len(checks) + warm + epochs + (1 if ctx.trace else 0)
    full = splits.coco_data(train, *st["vocab"], vectors)
    written0 = _written()
    w = trainrun.timed_epochs(ctx, EPOCH_LINE, lambda: train_policy_network(
        full, plot_dir=None, epochs=total, resume=True, **st["common"]), warm, epochs)
    trainrun.read_peak(ctx)
    window = w["end"] - w["start"]
    n_cap = train.captions.shape[0]
    full_mb, tail = divmod(n_cap, batch)
    steps = cfg["max_seq_len"] - 1
    e_pad = -(-cfg["wordvec_dim"] // 8) * 8  # the kernels' table width (16-byte rows)
    shape = (cfg["vocab_size"], e_pad, cfg["hidden_dim"], cfg["input_dim"])
    flops = (full_mb * counts.xe_minibatch_flops(batch, steps, *shape)
             + (counts.xe_minibatch_flops(tail, steps, *shape) if tail else 0))
    minibatches = [batch] * full_mb + ([tail] if tail else [])
    del full
    if ctx.device != "cpu":
        torch.cuda.empty_cache()

    limits = ctx.cell.spec["limits"]
    with ctx.spans.span("reference"):
        nums = readings(ctx, st)
    return {"end_to_end": {"setup_s": w["start"] - ctx.t_start,
                           "train_samples_per_s": epochs * n_cap / window},
            "attempted": epochs * len(minibatches), "failed": 0,
            "checks": {k: (nums[k], lim) for k, lim in limits.items()},
            "device": trainrun.device_info(ctx),
            "trace_info": {"minibatches": minibatches, "steps": steps, "shape": shape,
                           "window_s": window, "window_flops": epochs * flops},
            "notes": {"epochs": epochs, "window_s": window, "losses": st["losses"],
                      "window_written_bytes": _written() - written0}}


def readings(ctx, st, program=None) -> dict:
    """The check's numbers for the program's first three steps in ``st``
    (or for ``program``, a :func:`reference_steps` result standing in for
    the program: the control, or a planted fault) against the reference."""
    ref_out = reference_steps(ctx.config, st["vectors"], st["checks"], st["tseed"],
                              ctx.traffic["batch_size"], torch.device(ctx.device))
    if program is not None:
        return compare(program[0], program[1], program[2], ref_out)
    if len(st["losses"]) != 3:
        return {k: float("nan") for k in ("loss_gap", "grad_gap", "delta_gap")}
    return compare(st["losses"], st["g1"], st["p3"], ref_out)


def _written():
    from portbench import harness
    return harness.written_bytes() or 0


def reference_steps(cfg, vectors, checks, tseed, batch, device, prec=nets.F32, half=False):
    """The reference's three XE steps from the trainer's initial weights
    (its seed, torch's default initialisers), rows and Adam: ``(losses,
    first gradient, weights after three steps, initial weights)``. ``prec``
    and ``half`` as in the A2C entry's."""
    nets.tf32_off()
    pol = nets.torch_default_policy(torch.Generator().manual_seed(tseed + 1), cfg, vectors)
    pol = {k: ({kk: vv.to(device) for kk, vv in v.items()} if isinstance(v, dict)
               else v.to(device)) for k, v in pol.items()}
    params = nets.flat(pol)
    p0 = {k: params[k].detach().cpu().clone() for k in TRAINED}
    for k in TRAINED:
        params[k].requires_grad_()
    opt = ref.Adam({k: params[k] for k in TRAINED}, cfg["policy_lr"])
    feed = ref.pretrain_feed(tseed, [c.captions.shape[0] for c in checks], batch)
    per_epoch = [len(ref.pretrain_feed(0, [c.captions.shape[0]], batch)) for c in checks]
    owner = [i for i, n in enumerate(per_epoch) for _ in range(n)]
    losses, g1 = [], None
    for j, mask in enumerate(feed):
        caps, feats = checks[owner[j]].rows(mask[: len(mask) // 2] if half else mask)
        loss = ref.xe_loss(pol, torch.from_numpy(feats).to(device),
                           torch.from_numpy(caps).long().to(device), prec)
        grads = ref.grads_of(loss, {k: params[k] for k in TRAINED})
        if g1 is None:
            g1 = {k: g.detach().cpu() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
    return losses, g1, {k: params[k].detach().cpu() for k in TRAINED}, p0


def compare(losses, g1, p3, ref_out) -> dict:
    """The worst step's relative loss gap, the worst leaf's first-gradient
    norm gap and the worst leaf's three-step change norm gap."""
    r_losses, r_g1, r_p3, p0 = ref_out
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
    leaves = judge.counted(r_g1)
    grad_gap, _ = judge.worst_leaf_gap(g1, r_g1, leaves)
    delta_gap, _ = judge.worst_leaf_gap({k: p3[k] - p0[k] for k in leaves},
                                        {k: r_p3[k] - p0[k] for k in leaves}, leaves)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "delta_gap": delta_gap}
