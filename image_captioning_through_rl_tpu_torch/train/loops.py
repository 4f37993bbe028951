"""Training loops (counterpart of the JAX ``train/loops.py``): the three
pretrainers ``train_reward_network``, ``train_policy_network`` and
``train_value_network``, and A2C, ``train_a2c_network`` with
``a2c_training`` and ``a2c_curriculum_training``, with the reference's
control flow, metric tags and checkpoint cadence, one minibatch per step on
an explicit torch device (the card unless the caller asks for the CPU).

Reproduced reference behaviours:
  * best-loss checkpointing saves the weights *entering* the best
    minibatch (the reference saves before the optimiser step,
    trainers.py:182-186,244-248,293-297 — quirk Q12);
  * the metric step is ``epoch * batch_size + minibatch_id`` (quirk Q10);
  * the same numpy seeds (``seed`` .. ``seed + 4``), the value trainer's
    stdlib ``random.Random(seed + 2)`` prefix lengths and A2C's threefry
    keys (``PRNGKey(seed + 3)``, ``seed + 4`` for the curriculum, one
    ``split`` per minibatch, drawn before the skip rule), so both packages
    walk the same minibatches, prefixes and sampled actions;
  * A2C saves to every save path after every epoch (trainers.py:498); the
    curriculum appends level 16 (trainers.py:389-390) and skips
    minibatches whose ``curr_seq_len < 1`` (trainers.py:550);
  * the divergence guard and the one-step-late loss read.

``fused_chain=None`` (``fused_rollout=None`` for A2C) runs the kernels on a
CUDA device and the plain steps on the CPU; ``True`` forces the fused
steps (on the CPU their wrappers run the kernels' plain versions),
``False`` the plain ones. Every network and save path is written in the
format its suffix names (:func:`.checkpoint.save_network`: ``.pt`` the
reference state dict, anything else — the CLI's ``.ckpt`` — the native
msgpack tree); a divergence dump goes to ``<path>.diverged`` in the native
format, as in the JAX package. Not ported yet (ROADMAP §1): chunked steps,
device-resident tables, the mesh, ``.trainstate`` snapshots and resume, and
the compat (Q1) and bidirectional networks.

The evaluation half: ``load_a2c_models`` loads a finished model, and
``test_a2c_network`` decodes random val draws with the value-guided beam
(``csrc/beam_search.cu`` on the card) and dumps the real and generated
captions and the image urls, which :mod:`..metrics` scores. It draws
``data_size`` val samples *with replacement* (quirk Q8) and walks them in
127-wide slices per 128 stride (quirk Q9), as the JAX package does.
"""

from __future__ import annotations

import random as pyrandom
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import END_ID, MAX_SEQ_LEN
from ..api import resolve_device
from ..config import DecodeConfig, NetConfig, TrainConfig
from ..data.coco import CocoData, decode_captions, get_coco_batch, get_coco_minibatches
from ..models import policy as policy_mod
from ..models import reward as reward_mod
from ..models import value as value_mod
from ..ops.fused_beam import fused_beam_search, prepare_beam_weights
from ..ops.fused_decode import prepare_greedy_weights
from ..ops.prng import PRNGKey, split
from ..utils.io import append_results, global_minibatch_number
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
    """The trainers' device: the card unless the caller asks for the CPU;
    a CUDA device that is missing raises (no quiet CPU fallback)."""
    return resolve_device("cuda" if device is None else device)


def _use_fused(fused_chain: Optional[bool], device: torch.device) -> bool:
    return device.type == "cuda" if fused_chain is None else bool(fused_chain)


def describe_params(name: str, params: dict) -> str:
    """One line per parameter leaf, ``  path: shape dtype``, in the JAX
    package's order (sorted keys) and format."""
    lines = [f"{name}:"]

    def walk(tree, path):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], path + (k,))
            else:
                leaf = tree[k]
                lines.append(f"  {'/'.join(path + (k,))}: {tuple(leaf.shape)} "
                             f"{str(leaf.dtype).replace('torch.', '')}")

    walk(params, ())
    return "\n".join(lines)


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
                     dump=lambda path: ckpt.save_pytree(prev, path),
                     dump_path=ckpt_path + ".diverged")
        if loss < state["best"]:
            state["best"] = loss
            ckpt.save_network(kind, prev, ckpt_path)  # Q12: weights entering
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
    cfg = _cfg_for(train_data, bidirectional, net_dims)
    return network_paths[f"{kind}_network"], cfg, _device(device)


def train_reward_network(train_data: CocoData, network_paths: Dict[str, str],
                         plot_dir: Optional[str], bidirectional: bool,
                         epochs: int = _T.reward_epochs, batch_size: int = _T.batch_size,
                         lr: float = _T.reward_lr, seed: int = 0, device=None,
                         fused_chain: Optional[bool] = None,
                         net_dims: Optional[Dict[str, int]] = None) -> dict:
    """VSE-loss training of the reward network (trainers.py:260-309);
    writes ``network_paths["reward_network"]`` and returns the trained
    parameters."""
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
    rparams = ckpt.load_network("reward", network_paths["reward_network"], dev, cfg)
    pparams = ckpt.load_network("policy", network_paths["policy_network"], dev, cfg)
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


def _drive_a2c_epoch(*, epoch: int, level: Optional[int], train_data: CocoData,
                     batch_size: int, step, a2c_params: dict, reward_params: dict,
                     rng: np.random.Generator, key: np.ndarray, keeper, device: torch.device
                     ) -> np.ndarray:
    """One epoch of (curriculum) A2C minibatch updates, the JAX package's
    walk without chunks (``loops.py:1128-1150``): plain A2C (``level``
    None) rolls out from position 1; a curriculum level teacher-forces
    ``curr_seq_len = caplen - level`` positions and skips a minibatch where
    that is below 1. The minibatch's key is split off before the skip
    rule. Returns the carried key."""
    for minibatch_id, (captions, features, _) in enumerate(
            get_coco_minibatches(train_data, batch_size=batch_size, split="train", rng=rng)):
        key, sub = split(key)
        if level is None:
            curr = 1
        else:
            # the batch's largest END position + 1 (trainers.py:547), on the host
            curr = int(np.max(np.argmax(captions == END_ID, axis=1)) + 1) - level
            if curr < 1:  # trainers.py:550
                continue
        stats = step(a2c_params, reward_params, torch.from_numpy(features).to(device),
                     torch.from_numpy(captions).to(device).long(), curr, sub)
        keeper.push(stats, epoch, minibatch_id)
    keeper.flush()
    return key


def _a2c_resolver(desc: str, tags: tuple, writer, state: dict, a2c_params: dict, save_paths,
                  batch_size: int):
    """The per-minibatch bookkeeping of A2C: the divergence guard (dumping
    the current weights next to the first save path), the best loss, and
    the three metric tags (loss, mean reward, mean advantage)."""

    def resolve(stats, epoch, minibatch_id):
        loss = float(stats.loss)
        check_finite(loss, desc, f"epoch {epoch + 1}, minibatch {minibatch_id}",
                     dump=lambda path: ckpt.save_pytree(a2c_params, path),
                     dump_path=str(save_paths[0]) + ".diverged" if save_paths else None)
        state["best"] = min(state["best"], loss)
        n = global_minibatch_number(epoch, minibatch_id, batch_size)
        writer.add_scalar(tags[0], loss, n)
        writer.add_scalar(tags[1], float(stats.mean_reward), n)
        writer.add_scalar(tags[2], float(stats.mean_advantage), n)

    return resolve


def _a2c_epochs(desc: str, tags: tuple, level: Optional[int], writer, train_data: CocoData,
                a2c_params: dict, reward_params: dict, step, save_paths, batch_size: int,
                epochs: int, rng: np.random.Generator, key: np.ndarray) -> np.ndarray:
    device = a2c_params["policy"]["embedding"].device
    state = {"best": float("inf")}
    keeper = _DeferredBookkeeper(_a2c_resolver(desc, tags, writer, state, a2c_params,
                                               save_paths, batch_size))
    for epoch in range(epochs):
        t0 = time.perf_counter()
        key = _drive_a2c_epoch(epoch=epoch, level=level, train_data=train_data,
                               batch_size=batch_size, step=step, a2c_params=a2c_params,
                               reward_params=reward_params, rng=rng, key=key, keeper=keeper,
                               device=device)
        ckpt.save_to_paths(a2c_params, save_paths)  # every epoch (trainers.py:498)
        print(f"{desc} ({epoch + 1}/{epochs}): {time.perf_counter() - t0:.1f} s, best loss "
              f"{state['best']}", flush=True)
    return key


def a2c_training(train_data: CocoData, a2c_params: dict, reward_params: dict,
                 optimizer: torch.optim.Optimizer, cfg: NetConfig, plot_dir: Optional[str],
                 save_paths, batch_size: int, epochs: int, seed: int = 0,
                 fused_rollout: Optional[bool] = None, fuse_reward: bool = True) -> dict:
    """The A2C loop (trainers.py:402-500): per minibatch one rollout from
    the start column, the A2C loss and one optimiser step of ``a2c_params``
    (updated in place); the weights go to every path of ``save_paths``
    after every epoch. Numpy seed and threefry key ``seed + 3``."""
    writer = make_metrics_writer(plot_dir)
    device = a2c_params["policy"]["embedding"].device
    step = steps.make_a2c_step(cfg, optimizer, per_step_mean=False,
                               fused=_use_fused(fused_rollout, device), fuse_reward=fuse_reward)
    print_green("[Training] Training Advantage Actor-Critic Network")
    _a2c_epochs("Training A2C Network",
                ("A2C Network-episodic-loss", "A2C Network-episodic-mean-rewards",
                 "A2C Network-episodic-mean-advantage"),
                None, writer, train_data, a2c_params, reward_params, step, save_paths,
                batch_size, epochs, np.random.default_rng(seed + 3), PRNGKey(seed + 3))
    writer.close()
    return a2c_params


def a2c_curriculum_training(train_data: CocoData, a2c_params: dict, reward_params: dict,
                            optimizer: torch.optim.Optimizer, cfg: NetConfig,
                            plot_dir: Optional[str], save_paths, batch_size: int, epochs: int,
                            curriculum: Sequence[int], seed: int = 0,
                            fused_rollout: Optional[bool] = None,
                            fuse_reward: bool = True) -> dict:
    """Curriculum A2C (trainers.py:503-616): per level, ``epochs`` epochs
    that teacher-force the ground-truth prefix of length ``caplen - level``
    and roll out the last ``level`` tokens, with the per-step-mean loss. One
    numpy generator and one key (``seed + 4``) run through all levels."""
    writer = make_metrics_writer(plot_dir)
    device = a2c_params["policy"]["embedding"].device
    step = steps.make_a2c_step(cfg, optimizer, per_step_mean=True,
                               fused=_use_fused(fused_rollout, device), fuse_reward=fuse_reward)
    rng, key = np.random.default_rng(seed + 4), PRNGKey(seed + 4)
    print_green("[Training] Training Advantage Actor-Critic Network")
    print_green(f"[Training] mode set to curriculum training using levels: {list(curriculum)}")
    for level in curriculum:
        print_green(f"[Training] Training curriculum level: {level}")
        tag = f"A2C Curriculum Level-{level}"
        key = _a2c_epochs(f"Training A2C Curriculum Level {level}",
                          (f"{tag}-loss", f"{tag}-mean-rewards", f"{tag}-mean-advantage"),
                          level, writer, train_data, a2c_params, reward_params, step,
                          save_paths, batch_size, epochs, rng, key)
    writer.close()
    return a2c_params


def train_a2c_network(train_data: CocoData, save_paths: Dict[str, str],
                      network_paths: Dict[str, str], plot_dir: Optional[str],
                      bidirectional: bool, epochs: int, batch_size: int,
                      retrain_all: bool = False, curriculum: Optional[Sequence[int]] = None,
                      seed: int = 0, fused_rollout: Optional[bool] = None,
                      a2c_lr: float = _T.a2c_lr, device=None,
                      net_dims: Optional[Dict[str, int]] = None, fuse_reward: bool = True,
                      stage_seconds: Optional[Dict[str, float]] = None):
    """The A2C orchestrator (trainers.py:312-399): load each sub-network
    from ``network_paths`` (training it when its file is missing, or all
    three with ``retrain_all``), freeze the reward network, then run plain
    or curriculum A2C with Adam at ``a2c_lr`` over ``{"value", "policy"}``
    (frozen embeddings stay out of it), saving to
    ``save_paths["model_path"]`` and ``network_paths["a2c_network"]`` every
    epoch, and append the parameter summary to
    ``save_paths["results_path"]``. ``fuse_reward=False`` runs the frozen
    reward stream as its own kernel after each fused rollout instead of
    inside it. ``stage_seconds``, when given, receives the wall seconds of
    each sub-network trained and of the A2C loop. Returns ``(a2c_params,
    reward_params, cfg)``."""
    cfg = _cfg_for(train_data, bidirectional, net_dims)
    dev = _device(device)
    all_save_paths = [save_paths["model_path"], network_paths["a2c_network"]]
    kw = dict(batch_size=batch_size, seed=seed, device=dev, net_dims=net_dims)
    trainers = {"reward": train_reward_network, "policy": train_policy_network,
                "value": train_value_network}
    seconds = {} if stage_seconds is None else stage_seconds
    nets = {}

    def train(kind, train_fn):
        t0 = time.perf_counter()
        nets[kind] = train_fn(train_data, network_paths, plot_dir, bidirectional, **kw)
        seconds[kind] = time.perf_counter() - t0

    if retrain_all:
        print_green("[Training] Training all the networks")
    for kind, train_fn in trainers.items():
        if retrain_all:
            train(kind, train_fn)
            continue
        try:
            nets[kind] = ckpt.load_network(kind, network_paths[f"{kind}_network"], dev, cfg)
            print(f"[Training] loaded {kind} network")
        except FileNotFoundError:
            print(f"[Training] {kind} network not found")
            train(kind, train_fn)
    if retrain_all:
        print_green("[Training] All networks trained")
    reward_params = _clone(nets["reward"])  # frozen: detached, no gradient
    a2c_params = {"value": nets["value"], "policy": nets["policy"]}
    optimizer = adam(a2c_lr, a2c_params, cfg.freeze_embeddings)  # trainers.py:378

    print(f"[Training] train_data len = {len(train_data.train_captions)}")
    print(f"[Training] episodes = {batch_size}")
    print(f"[Training] epochs = {epochs}")
    args = (train_data, a2c_params, reward_params, optimizer, cfg, plot_dir, all_save_paths,
            batch_size, epochs)
    t0 = time.perf_counter()
    if curriculum is None:
        a2c_training(*args, seed=seed, fused_rollout=fused_rollout, fuse_reward=fuse_reward)
    else:
        curriculum = list(curriculum)
        if 16 not in curriculum:
            curriculum.append(16)  # the last level is full training (trainers.py:389-390)
        a2c_curriculum_training(*args, curriculum, seed=seed, fused_rollout=fused_rollout,
                                fuse_reward=fuse_reward)
    seconds["a2c"] = time.perf_counter() - t0
    append_results(save_paths["results_path"],
                   describe_params("AdvantageActorCriticNetwork", a2c_params), header="network")
    return a2c_params, reward_params, cfg


def test_a2c_network(a2c_params: dict, cfg: NetConfig, test_data: CocoData,
                     image_caption_data: Dict[str, str], data_size: int,
                     validation_batch_size: int = 128, dcfg: Optional[DecodeConfig] = None,
                     seed: int = 0, eval_superbatch: int = 8, compat_dump: bool = False,
                     use_fused_kernel: Optional[bool] = None, device=None) -> None:
    """Evaluation pass (trainers.py:619-665): value-guided beam decode of
    ``data_size`` random val draws (``default_rng(seed + 5)``, with
    replacement), appending the real captions, the best beam's captions and
    the image urls to the three paths of ``image_caption_data``.

    The draws are walked in Q9 slices (``validation_batch_size - 1`` rows at
    a stride of ``validation_batch_size``) and decoded ``eval_superbatch``
    slices at a time. A short group is padded with repeats of its last row
    to the full width, so the beam runs at one shape, and trimmed after the
    decode. Each slice's start tokens are its captions' first column. The
    dumps are written slice by slice and flushed after each group;
    ``compat_dump=True`` reproduces quirk Q13 (each slice written with
    ``"\\n".join`` and no trailing newline, so slice boundaries merge).

    On ``device`` (the card unless the caller asks for the CPU; a missing
    CUDA device raises) the weights are prepared once: bf16 on the card,
    where the beam runs the kernel (:func:`..ops.fused_beam.fused_beam_search`),
    float32 on the CPU, where it runs the plain version.
    ``use_fused_kernel=False`` runs the plain version; ``True`` on the CPU
    raises. The faithful (Q2 batch-mean) mode and bidirectional networks
    are not ported: they raise ``NotImplementedError``.
    """
    dcfg = dcfg or DecodeConfig(max_seq_len=cfg.max_seq_len)
    if not dcfg.per_sample_beams:
        raise NotImplementedError(
            "the faithful evaluation (the Q2 batch-mean beam with the Q1-stateful critic) is "
            "not ported yet (ROADMAP §1 item 6)")
    policy_mod.check_unidirectional(cfg)
    dev = _device(device)
    if use_fused_kernel and dev.type != "cuda":
        raise RuntimeError("use_fused_kernel=True needs a CUDA device: the beam kernel runs "
                           "only on the card")
    wd = torch.bfloat16 if dev.type == "cuda" else torch.float32
    weights = prepare_beam_weights(
        prepare_greedy_weights(ckpt.to_device(a2c_params["policy"], dev), wd),
        ckpt.to_device(a2c_params["value"], dev))

    rng = np.random.default_rng(seed + 5)
    captions_all, features_all, urls_all = get_coco_batch(
        test_data, batch_size=data_size, split="val", rng=rng)
    width = validation_batch_size - 1  # Q9: 127-wide slices per 128 stride
    slices = [
        (captions_all[i: i + width], features_all[i: i + width], urls_all[i: i + width])
        for i in range(0, len(captions_all), validation_batch_size)
    ]
    slices = [s for s in slices if s[0].shape[0] > 0]
    gwidth = width * eval_superbatch

    def write_slice(f, lines):
        if compat_dump:
            f.write("\n".join(lines))  # Q13: no trailing newline
        else:
            f.write("\n".join(lines) + "\n")

    t0 = time.perf_counter()
    with open(image_caption_data["real_captions_path"], "a") as real_f, \
         open(image_caption_data["generated_captions_path"], "a") as gen_f, \
         open(image_caption_data["image_urls_path"], "a") as url_f:
        for g in range(0, len(slices), eval_superbatch):
            batch = slices[g: g + eval_superbatch]
            captions_real = np.concatenate([b[0] for b in batch], axis=0)
            features_real = np.concatenate([b[1] for b in batch], axis=0)
            n_real = captions_real.shape[0]
            if n_real < gwidth:  # pad to the full width: one shape for the beam
                pad = gwidth - n_real
                features_real = np.concatenate(
                    [features_real, np.repeat(features_real[-1:], pad, axis=0)], axis=0)
                captions_real = np.concatenate(
                    [captions_real, np.repeat(captions_real[-1:], pad, axis=0)], axis=0)
            toks, _ = fused_beam_search(
                weights, torch.from_numpy(np.ascontiguousarray(features_real, np.float32)).to(dev),
                torch.from_numpy(captions_real[:, 0].astype(np.int32)).to(dev),
                max_len=dcfg.max_seq_len, beam=dcfg.beam_size, value_weight=dcfg.value_weight,
                logprob_weight=dcfg.logprob_weight, use_fused_kernel=use_fused_kernel)
            gen_all = toks[:n_real, 0].cpu().numpy()  # most likely = beam 0
            # write per original slice, the reference's cadence
            off = 0
            for caps_s, _, urls_s in batch:
                n_s = caps_s.shape[0]
                write_slice(real_f, decode_captions(caps_s, test_data.idx_to_word))
                write_slice(gen_f, decode_captions(gen_all[off: off + n_s], test_data.idx_to_word))
                write_slice(url_f, urls_s.tolist())
                off += n_s
            real_f.flush()
            gen_f.flush()
            url_f.flush()
    print(f"Testing model: {len(slices)} slices in {-(-len(slices) // eval_superbatch)} groups "
          f"of {gwidth} rows in {time.perf_counter() - t0:.1f} s", flush=True)


def load_a2c_models(model_path: str, train_data: CocoData, network_paths: Dict[str, str],
                    bidirectional: bool, net_dims: Optional[Dict[str, int]] = None,
                    device=None) -> tuple:
    """Load a finished A2C model for testing (utilities.py:299-323): the
    policy and value networks from their own files, then the a2c file over
    them, which holds both (each ``.pt`` or native, by suffix; every shape
    checked against the config). Returns ``(params, cfg)``, the parameters
    on ``device`` (the card unless the caller asks for the CPU; a missing
    CUDA device raises)."""
    cfg = _cfg_for(train_data, bidirectional, net_dims)
    policy_mod.check_unidirectional(cfg)
    dev = _device(device)
    params = {kind: ckpt.load_network(kind, network_paths[f"{kind}_network"], dev, cfg)
              for kind in ("value", "policy")}
    params.update(ckpt.load_network("a2c", model_path, dev, cfg))
    return params, cfg
