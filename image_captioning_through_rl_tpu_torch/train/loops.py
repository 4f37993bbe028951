"""Training loops of the three pretrainers (counterpart of the JAX
``train/loops.py``): ``train_reward_network``, ``train_policy_network``
and ``train_value_network``, with the reference's control flow, metric
tags and checkpoint cadence, one minibatch per step on an explicit torch
device.

Reproduced reference behaviours:
  * best-loss checkpointing saves the weights *entering* the best
    minibatch (the reference saves before the optimiser step,
    trainers.py:182-186,244-248,293-297 — quirk Q12);
  * the metric step is ``epoch * batch_size + minibatch_id`` (quirk Q10);
  * the same numpy seeds (``seed``, ``seed + 1``, ``seed + 2``) and the value
    trainer's stdlib ``random.Random(seed + 2)`` prefix lengths, so both
    packages walk the same minibatches and prefixes.

``fused_chain=None`` runs the chain kernels on a CUDA device and the plain
steps on the CPU; ``True`` forces the fused steps (on the CPU their
wrappers run the kernels' plain versions), ``False`` the plain ones.
Not ported yet (ROADMAP §1): chunked steps, device-resident tables, the
mesh, resume snapshots, the compat (Q1) and bidirectional networks, and
native ``.ckpt`` checkpoints — network paths must be reference ``.pt``
files.
"""

from __future__ import annotations

import random as pyrandom
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import MAX_SEQ_LEN
from ..config import NetConfig, TrainConfig
from ..data.coco import CocoData, get_coco_minibatches
from ..models import policy as policy_mod
from ..models import reward as reward_mod
from ..models import value as value_mod
from ..utils.io import global_minibatch_number
from ..utils.logging import make_metrics_writer, print_green
from . import checkpoint as ckpt
from . import steps
from .guard import check_finite
from .optim import adam

# the trainers' defaults come from TrainConfig, as in the JAX package
_T = TrainConfig()


def _cfg_for(data: CocoData, bidirectional: bool,
             net_dims: Optional[Dict[str, int]] = None) -> NetConfig:
    """Model config for a dataset. ``net_dims`` overrides the reference's
    512-wide constants; pretrained word vectors fix ``wordvec_dim`` (an
    override of it is dropped), and ``input_dim`` follows the features
    unless given."""
    net_dims = dict(net_dims or {})
    if data.embeddings is not None:
        net_dims.pop("wordvec_dim", None)
    net_dims.setdefault("input_dim", int(data.train_features.shape[-1]))
    return NetConfig.for_vocab(data.word_to_idx, data.embeddings, bidirectional=bidirectional,
                               **net_dims)


def _device(device) -> torch.device:
    return torch.device(device if device is not None else
                        ("cuda" if torch.cuda.is_available() else "cpu"))


def _use_fused(fused_chain: Optional[bool], device: torch.device) -> bool:
    return device.type == "cuda" if fused_chain is None else bool(fused_chain)


def _clone(tree: dict) -> dict:
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


class _DeferredBookkeeper:
    """One-step-deferred loss bookkeeping: step i's loss is read (a device
    sync) after step i + 1 is queued, so the host's read overlaps the
    device's work; the same losses are compared and the same entering
    weights saved as with an immediate read."""

    def __init__(self, resolve_fn):
        self._resolve = resolve_fn
        self._pending = None

    def push(self, *payload):
        if self._pending is not None:
            self._resolve(*self._pending)
        self._pending = payload

    def flush(self):
        if self._pending is not None:
            self._resolve(*self._pending)
            self._pending = None


def _drive_best_loss_training(desc: str, tag: str, kind: str, ckpt_path: str, writer,
                              epochs: int, batch_size: int, rng: np.random.Generator,
                              train_data: CocoData, params: dict, single_step,
                              device: torch.device) -> dict:
    """The epoch loop shared by the three pretrainers (reference
    trainers.py:160-197, 225-257, 280-309). ``single_step(params, features,
    captions) -> loss`` runs one minibatch and updates ``params`` in place;
    each minibatch's entering weights are cloned first, so the checkpoint
    can hold them (Q12)."""
    state = {"best": float("inf")}

    def resolve(prev, loss_dev, epoch, minibatch_id):
        loss = float(loss_dev)
        check_finite(loss, desc, f"epoch {epoch + 1}, minibatch {minibatch_id}",
                     dump=lambda path: ckpt.save_network_pt(kind, prev, path),
                     dump_path=ckpt_path + ".diverged.pt")
        if loss < state["best"]:
            state["best"] = loss
            ckpt.save_network_pt(kind, prev, ckpt_path)  # Q12: weights entering
        writer.add_scalar(tag, loss, global_minibatch_number(epoch, minibatch_id, batch_size))

    keeper = _DeferredBookkeeper(resolve)
    for epoch in range(epochs):
        t0 = time.perf_counter()
        minibatch_id = -1
        for minibatch_id, (captions, features, _) in enumerate(
                get_coco_minibatches(train_data, batch_size=batch_size, split="train",
                                     rng=rng)):
            prev = _clone(params)
            loss = single_step(params, torch.from_numpy(features).to(device),
                               torch.from_numpy(captions).to(device).long())
            keeper.push(prev, loss, epoch, minibatch_id)
        keeper.flush()
        print(f"{desc} ({epoch + 1}/{epochs}): {minibatch_id + 1} minibatches in "
              f"{time.perf_counter() - t0:.1f} s, best loss {state['best']}", flush=True)
    return params


def _start(kind: str, train_data: CocoData, network_paths: Dict[str, str], bidirectional: bool,
           net_dims, device):
    ckpt_path = network_paths[f"{kind}_network"]
    ckpt.check_pt_path(ckpt_path)
    return ckpt_path, _cfg_for(train_data, bidirectional, net_dims), _device(device)


def train_reward_network(train_data: CocoData, network_paths: Dict[str, str],
                         plot_dir: Optional[str], bidirectional: bool,
                         epochs: int = _T.reward_epochs, batch_size: int = _T.batch_size,
                         lr: float = _T.reward_lr, seed: int = 0, device=None,
                         fused_chain: Optional[bool] = None,
                         net_dims: Optional[Dict[str, int]] = None) -> dict:
    """VSE-loss training of the reward network (trainers.py:260-309);
    writes ``network_paths["reward_network"]`` (a ``.pt``) and returns the
    trained parameters."""
    ckpt_path, cfg, dev = _start("reward", train_data, network_paths, bidirectional, net_dims,
                                 device)
    writer = make_metrics_writer(plot_dir)
    rng = np.random.default_rng(seed)
    params = ckpt.to_device(reward_mod.init(torch.Generator().manual_seed(seed), cfg,
                                            train_data.embeddings), dev)
    opt = adam(lr, params, cfg.freeze_embeddings)
    step = steps.make_reward_step(cfg, opt, fused=_use_fused(fused_chain, dev))
    print_green("[Training] Training Reward Network")
    params = _drive_best_loss_training(
        "Training Reward Network", "Reward Network-loss", "reward", ckpt_path, writer, epochs,
        batch_size, rng, train_data, params, step, dev)
    writer.close()
    return params


def train_policy_network(train_data: CocoData, network_paths: Dict[str, str],
                         plot_dir: Optional[str], bidirectional: bool,
                         epochs: int = _T.policy_epochs, batch_size: int = _T.batch_size,
                         lr: float = _T.policy_lr, seed: int = 0, device=None,
                         fused_chain: Optional[bool] = None,
                         net_dims: Optional[Dict[str, int]] = None) -> dict:
    """Teacher-forced XE pretraining of the policy (trainers.py:202-257);
    writes ``network_paths["policy_network"]``."""
    ckpt_path, cfg, dev = _start("policy", train_data, network_paths, bidirectional, net_dims,
                                 device)
    writer = make_metrics_writer(plot_dir)
    rng = np.random.default_rng(seed + 1)
    params = ckpt.to_device(policy_mod.init(torch.Generator().manual_seed(seed + 1), cfg,
                                            train_data.embeddings), dev)
    opt = adam(lr, params, cfg.freeze_embeddings)
    step = steps.make_policy_step(cfg, opt, fused=_use_fused(fused_chain, dev))
    print_green("[Training] Training Policy Network")
    params = _drive_best_loss_training(
        "Training Policy Network", "Policy Network-loss", "policy", ckpt_path, writer, epochs,
        batch_size, rng, train_data, params, step, dev)
    writer.close()
    return params


def train_value_network(train_data: CocoData, network_paths: Dict[str, str],
                        plot_dir: Optional[str], bidirectional: bool,
                        epochs: int = _T.value_epochs, batch_size: int = _T.batch_size,
                        lr: float = _T.value_lr, seed: int = 0, device=None,
                        fused_chain: Optional[bool] = None,
                        net_dims: Optional[Dict[str, int]] = None) -> dict:
    """MSE training of the critic against the embedding rewards of greedy
    rollouts of the frozen policy (trainers.py:125-199). Loads the reward
    and policy networks from ``network_paths`` and writes
    ``network_paths["value_network"]``."""
    ckpt_path, cfg, dev = _start("value", train_data, network_paths, bidirectional, net_dims,
                                 device)
    writer = make_metrics_writer(plot_dir)
    rng = np.random.default_rng(seed + 2)
    py_rng = pyrandom.Random(seed + 2)
    rparams = ckpt.load_network("reward", network_paths["reward_network"], dev)
    pparams = ckpt.load_network("policy", network_paths["policy_network"], dev)
    params = ckpt.to_device(value_mod.init(torch.Generator().manual_seed(seed + 2), cfg,
                                           train_data.embeddings), dev)
    opt = adam(lr, params, cfg.freeze_embeddings)
    step = steps.make_value_step(cfg, opt, pparams, rparams, fused=_use_fused(fused_chain, dev))

    def single_step(params, features, captions):
        # one random prefix length per minibatch, shared by the batch
        # (trainers.py:177)
        return step(params, features, captions, py_rng.randint(1, MAX_SEQ_LEN))

    print_green("[Training] Training Value Network")
    params = _drive_best_loss_training(
        "Training Value Network", "Value Network-loss", "value", ckpt_path, writer, epochs,
        batch_size, rng, train_data, params, single_step, dev)
    writer.close()
    return params
