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
``False`` the plain ones. A bidirectional config, and
``compat_batch_as_time=True`` (the reference's batch-as-time value and
reward encoders, quirk Q1: the compat steps of :mod:`.steps`), run the
plain steps on their device (the fused ones are unidirectional and
non-compat, as in the JAX package), and an explicit ``True`` raises
``ValueError``. Every network and save path is
written in the format its suffix names (:func:`.checkpoint.save_network`:
``.pt`` the reference state dict, anything else — the CLI's ``.ckpt`` — the
native msgpack tree); a divergence dump goes to ``<path>.diverged`` in the
native format, as in the JAX package.

The JAX trainers' default walk: the train split lives on the run's device
(``device_data=True``, :class:`..data.device.DeviceCocoTables`) and
``chunk_steps`` (16) minibatch updates run per host dispatch with no host
sync (:mod:`.steps`' chunk steps), their losses read back once a chunk; the
pretrainers' Q12 bookkeeping stays on the device, and on the card the
reward and policy chunks are one CUDA graph replay each. The value and A2C
chunks run eagerly; A2C's per-step walk is its chunk of one minibatch, and
a chunk's stats are read once the next chunk is queued. ``chunk_steps=1``
or ``device_data=False`` (the split in host memory,
:class:`..data.device.HostCocoTables`) walks one minibatch a dispatch, with
the same artifacts. Every trainer writes a ``.trainstate`` snapshot after each epoch (in the JAX package's layout,
:func:`.checkpoint.save_train_state`), and ``resume=True`` continues from it
bit-identically, from either package's snapshot.

``mesh=`` (a :class:`..parallel.mesh.Mesh` whose ``data`` axis holds one
entry a rank, ``torchrun`` launching one process per card) scales every
trainer over the ranks: each rank draws the same global minibatch from the
same host generator, gathers its rows on its own device
(:class:`..data.device.DeviceCocoTables`), runs its steps (the kernels on a
card) on them and reduces its gradients over the ranks, once a step
(:mod:`.steps`); a ragged minibatch, and every compat (Q1) minibatch, is
computed whole on every rank. The JAX package turns its single-chip kernels
off on a mesh; here each rank runs them on its rows. Rank 0 alone writes:
the metrics, every checkpoint and snapshot, the caption dumps. Loads are
rank 0's reads, broadcast (:func:`_sync_load`, :func:`_load_train_state_sync`,
:func:`_exists_sync`), so ranks without a shared file system take the same
branch. Under NCCL the reward and policy chunks stay CUDA graphs with the
all-reduce inside; gloo's collectives do not capture, so a gloo rank runs
them eagerly.

The evaluation half: ``load_a2c_models`` loads a finished model, and
``test_a2c_network`` decodes random val draws with the value-guided beam
(``csrc/beam_search.cu`` on the card; a bidirectional model's carried eager
beam, :func:`..decode.beam.beam_search`; the faithful mode's Q1-stateful
:func:`..decode.beam_compat.beam_search_compat`) and dumps the real and
generated captions and the image urls, which :mod:`..metrics` scores. It draws
``data_size`` val samples *with replacement* (quirk Q8) and walks them in
127-wide slices per 128 stride (quirk Q9), as the JAX package does.
"""

from __future__ import annotations

import os
import random as pyrandom
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import END_ID, MAX_SEQ_LEN
from ..api import resolve_device
from ..config import DecodeConfig, NetConfig, TrainConfig
from ..data.coco import CocoData, decode_captions, epoch_minibatch_indices, get_coco_batch
from ..data.device import DeviceCocoTables, HostCocoTables
from ..decode.beam import beam_search
from ..decode.beam_compat import beam_search_compat
from ..models import policy as policy_mod
from ..models import reward as reward_mod
from ..models import value as value_mod
from ..ops.fused_beam import fused_beam_search, prepare_beam_weights
from ..ops.fused_decode import prepare_greedy_weights
from ..ops.prng import PRNGKey, split
from ..parallel import collectives
from ..parallel.hostbatch import GlobalBatcher
from ..parallel.sharding import gather_params
from ..parallel.mesh import is_main_process
from ..utils.io import append_results, global_minibatch_number
from ..utils.logging import make_metrics_writer, print_green, print_red
from ..utils.profiling import annotate
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


def _device(device, mesh=None) -> torch.device:
    """The trainers' device: this rank's device of ``mesh``, else the card
    unless the caller asks for the CPU; a CUDA device that is missing raises
    (no quiet CPU fallback)."""
    if mesh is not None:
        return resolve_device(mesh.first_device)
    return resolve_device("cuda" if device is None else device)


def _check_mesh(mesh) -> None:
    """A training mesh holds one entry a process: one process per card."""
    entries = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))
    if mesh is not None and not mesh.spans_processes and entries > 1:
        raise ValueError(f"a training mesh holds one device a process; {mesh} lists "
                         f"{entries} in one: launch one process per card with torchrun")


def _multiprocess(mesh) -> bool:
    return mesh is not None and mesh.spans_processes


def _capturable(device: torch.device) -> bool:
    """Whether a step's collectives can sit inside a CUDA graph: on a card,
    without a process group or under NCCL (gloo's do not capture)."""
    if device.type != "cuda":
        return False
    return not collectives.active() or torch.distributed.get_backend() == "nccl"


def _forced_fused_conflict(flag, what: str, why: str) -> None:
    """An explicitly forced fused path that cannot run raises rather than
    quietly running another program (the JAX package's rule)."""
    if flag:
        raise ValueError(f"{what} was explicitly forced but cannot be honored {why} — the "
                         "fused kernels are unidirectional and non-compat; drop the force "
                         "flag or the conflicting mode")


def _use_fused(fused_chain: Optional[bool], device: torch.device, cfg: NetConfig,
               what: str = "fused_chain", compat: bool = False) -> bool:
    """The fused steps run on a CUDA device unless ``fused_chain`` says
    otherwise; never for a bidirectional ``cfg`` or the compat (Q1) steps
    (forcing them raises)."""
    if cfg.bidirectional or compat:
        _forced_fused_conflict(fused_chain, what, "with a bidirectional model"
                               if cfg.bidirectional else "with compat_batch_as_time")
        return False
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


def _sync_load(load_fn, template_fn, multiprocess: bool):
    """A load every rank agrees on. Without ``multiprocess``: ``load_fn()``.
    Else rank 0 alone calls it and broadcasts its verdict on every control
    path (0 loaded, 1 file missing, 2 another failure), then, loaded, its
    tree into each other rank's ``template_fn()``: ranks that disagree about
    a local file would otherwise enter mismatched collectives and hang. A
    failure raises on every rank (rank 0 its own error)."""
    if not multiprocess:
        return load_fn()
    params, code, err = None, 0, None
    if is_main_process():
        try:
            params = load_fn()
        except FileNotFoundError as e:
            code, err = 1, e
        except Exception as e:  # noqa: BLE001 — broadcast the verdict before raising
            code, err = 2, e
    code = collectives.broadcast_int(code)
    if code == 1:
        raise err if err is not None else FileNotFoundError("checkpoint absent on rank 0")
    if code == 2:
        raise err if err is not None else RuntimeError(
            "checkpoint load failed on rank 0 (see its log for the error)")
    return collectives.broadcast_tree(params if params is not None else template_fn())


def _load_train_state_sync(path: str, params: dict, meta_check, multiprocess: bool):
    """A ``.trainstate`` snapshot parsed against ``params``, or None when
    there is none. On several ranks, rank 0 reads the file and broadcasts
    its bytes (verdict first, on every control path, as :func:`_sync_load`),
    so every rank parses the same snapshot."""
    if not multiprocess:
        if not os.path.exists(path):
            return None
        return ckpt.load_train_state(path, params, meta_check)
    data, code, err = None, 0, None
    if is_main_process():
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            code = 1
        except Exception as e:  # noqa: BLE001 — broadcast the verdict before raising
            code, err = 2, e
    code = collectives.broadcast_int(code)
    if code == 2:
        raise err if err is not None else RuntimeError(f"train-state load failed on rank 0: "
                                                       f"{path}")
    if code == 1:
        return None
    return ckpt.train_state_from_bytes(collectives.broadcast_bytes(data), params, meta_check)


def _exists_sync(path: str, multiprocess: bool) -> bool:
    """Rank 0's answer to whether ``path`` exists, on every rank."""
    if not multiprocess:
        return os.path.exists(path)
    return bool(collectives.broadcast_int(os.path.exists(path) if is_main_process() else 0))


def _note_route(resume_fused, fused: bool, what: str) -> None:
    """A resumed snapshot records the route (kernels or plain steps) its run
    took; this run keeps its own, and says so loudly when they differ (the
    continuation is then not bit-identical)."""
    if resume_fused is not None and bool(resume_fused) != fused:
        def name(f):
            return "the kernels" if f else "the plain steps"
        print_red(f"[Training] WARNING: the interrupted run trained its {what} with "
                  f"{name(resume_fused)}, this run takes {name(fused)} on its device — the "
                  f"continuation is NOT bit-identical to the original run")


def _resume_pretrainer(resume: bool, train_state_path: Optional[str], tag: str, params: dict,
                       optimizer: torch.optim.Optimizer, rng: np.random.Generator,
                       set_extra=None, multiprocess: bool = False) -> tuple:
    """Restore a pretrainer's snapshot (either package's) into ``params``
    and ``optimizer`` in place, the numpy generator and ``set_extra`` (the
    value trainer's stdlib prefix stream): ``(start_epoch, resume_best,
    resume_fused)``, ``(0, None, None)`` when ``resume`` is off or there is
    no snapshot. A snapshot of another network raises ``ValueError``.
    ``multiprocess``: rank 0 reads it for every rank."""
    if not resume or not train_state_path:
        return 0, None, None

    def meta_check(meta):
        if meta.get("kind") != "best_loss" or meta.get("tag") != tag:
            raise ValueError(f"train-state at {train_state_path} is for "
                             f"{meta.get('tag') or meta.get('kind')!r}, not {tag!r}")

    state = _load_train_state_sync(train_state_path, params, meta_check, multiprocess)
    if state is None:
        return 0, None, None
    ckpt.restore_train_state(state, params, optimizer)
    meta = state["meta"]
    rng.bit_generator.state = meta["rng_state"]
    if set_extra is not None and meta.get("extra") is not None:
        set_extra(meta["extra"])
    print_green(f"[Training] resumed full {tag.replace('-loss', '')} train state "
                f"(epoch {meta['epoch_done']} done)")
    return meta["epoch_done"], meta["best"], meta.get("fused")


def _drive_best_loss_training(desc: str, tag: str, kind: str, ckpt_path: str, writer,
                              epochs: int, batch_size: int, rng: np.random.Generator,
                              params: dict, single_step, optimizer: torch.optim.Optimizer, *,
                              tables=None, chunk=None, chunk_steps: int = 16,
                              draw_extras=None, train_state_path: Optional[str] = None,
                              start_epoch: int = 0, resume_best: Optional[float] = None,
                              extra_state_fn=None, fused_used: Optional[bool] = None,
                              batcher: Optional[GlobalBatcher] = None) -> dict:
    """The epoch loop shared by the three pretrainers (reference
    trainers.py:160-197, 225-257, 280-309; the JAX package's
    ``_drive_best_loss_training``).

    With ``chunk`` (a :class:`.steps.BestLossChunk`), device ``tables`` and
    ``chunk_steps > 1``, ``chunk_steps`` minibatch updates run per host
    dispatch, gathered on the device from one permutation, with the Q12
    bookkeeping on the device; their losses come back in one copy, and the
    checkpoint is written once a chunk when the chunk improved on the best
    loss. The ragged tail runs one single step. The same losses are logged
    at the same steps, and the checkpoint ends with the same bytes, as the
    per-step walk, where ``single_step(params, features, captions) ->
    loss`` runs one minibatch and each minibatch's entering weights are
    cloned first, so the checkpoint can hold them (Q12). ``draw_extras(k)``
    gives k minibatches' extra chunk arguments (the value trainer's prefix
    lengths, drawn in minibatch order on both walks).

    ``train_state_path`` receives a snapshot after every epoch (weights,
    Adam's state, the numpy generator, ``extra_state_fn()``, the epoch, the
    best loss and the route ``fused_used``); ``start_epoch`` and
    ``resume_best`` re-enter the loop from a restored one.

    ``batcher`` (a mesh's :class:`..parallel.hostbatch.GlobalBatcher`):
    ``tables`` gather this rank's rows, each step and chunk takes the
    minibatch's row shard (None for a ragged one, computed whole), every
    loss is the global one, and rank 0 alone writes."""
    state = {"best": float("inf") if resume_best is None else resume_best}
    main = is_main_process()

    def row_shard(n):
        return None if batcher is None else batcher.row_shard(n)

    def snapshot(epoch):
        if train_state_path and main:
            with annotate("train.snapshot"):
                ckpt.save_train_state(
                    train_state_path, params, optimizer, np.zeros((2,), np.uint32),
                    {"kind": "best_loss", "tag": tag, "epoch_done": epoch + 1,
                     "best": state["best"], "rng_state": rng.bit_generator.state,
                     "fused": fused_used,
                     "extra": None if extra_state_fn is None else extra_state_fn()})

    def log(loss, epoch, minibatch_id, dump_tree):
        check_finite(loss, desc, f"epoch {epoch + 1}, minibatch {minibatch_id}",
                     dump=lambda path: ckpt.save_pytree(dump_tree, path),
                     dump_path=ckpt_path + ".diverged" if main else None)
        improved = loss < state["best"]
        if improved:
            state["best"] = loss
        writer.add_scalar(tag, loss, global_minibatch_number(epoch, minibatch_id, batch_size))
        return improved

    def resolve(prev, loss_dev, epoch, minibatch_id):
        with annotate("train.losses"):
            improved = log(float(loss_dev), epoch, minibatch_id, prev)
        if improved and main:
            with annotate("train.save_best"):
                ckpt.save_network(kind, prev, ckpt_path)  # Q12: weights entering

    keeper = _DeferredBookkeeper(resolve)
    use_chunks = chunk is not None and chunk_steps > 1 and isinstance(tables, DeviceCocoTables)
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        if use_chunks:
            num = tables.num_captions
            with annotate("train.permute"):
                perm = rng.permutation(num)
            i = minibatch_id = 0
            while i < num:
                k = min(chunk_steps, (num - i) // batch_size)
                if k >= 1:
                    with annotate("train.gather"):
                        mask = perm[i: i + k * batch_size]
                        feat_dim, steps_t = tables.features.shape[1], tables.captions.shape[1]
                        shard = row_shard(batch_size)
                        n = batch_size if shard is None else shard.rows  # this rank's rows
                        if chunk.graph:  # gather into the captured graph's input buffers
                            feats_b, caps_b = chunk.inputs(k, n, feat_dim, steps_t)
                            tables.gather(mask, out=(caps_b.view(-1, steps_t),
                                                     feats_b.view(-1, feat_dim)), k=k)
                        else:
                            caps_b, feats_b = tables.gather(mask, k=k)
                            feats_b = feats_b.view(k, n, feat_dim)
                            caps_b = caps_b.view(k, n, steps_t)
                        extras = None if draw_extras is None else draw_extras(k)
                    # the chunk's own spans: train.capture (a new shape) and train.dispatch
                    losses, best_prev, _, improved = chunk(state["best"], feats_b, caps_b,
                                                           extras, shard)
                    with annotate("train.losses"):
                        host = torch.cat([losses, improved.reshape(1).to(losses.dtype)]).tolist()
                    if host[-1] and main:
                        with annotate("train.save_best"):
                            ckpt.save_network(kind, best_prev, ckpt_path)  # Q12, once a chunk
                    with annotate("train.losses"):
                        for loss in host[:-1]:
                            # the post-chunk weights: the entering ones are not kept
                            log(loss, epoch, minibatch_id, params)
                            minibatch_id += 1
                    i += k * batch_size
                else:  # ragged tail: one single step
                    with annotate("train.gather"):
                        caps_b, feats_b = tables.gather(perm[i:])
                    with annotate("train.dispatch"):
                        prev = _clone(params)
                        loss = single_step(params, feats_b, caps_b, row_shard(num - i))
                    resolve(prev, loss, epoch, minibatch_id)
                    minibatch_id += 1
                    i = num
        else:
            with annotate("train.permute"):
                masks = list(epoch_minibatch_indices(tables.num_captions, batch_size, rng))
            minibatch_id = -1
            for minibatch_id, mask in enumerate(masks):
                with annotate("train.gather"):
                    captions, features = tables.gather(mask)
                with annotate("train.dispatch"):
                    prev = _clone(params)
                    loss = single_step(params, features, captions.long(), row_shard(len(mask)))
                keeper.push(prev, loss, epoch, minibatch_id)
            keeper.flush()
            minibatch_id += 1
        snapshot(epoch)
        print(f"{desc} ({epoch + 1}/{epochs}): {minibatch_id} minibatches in "
              f"{time.perf_counter() - t0:.1f} s, best loss {state['best']}", flush=True)
    return params


def _start(kind: str, train_data: CocoData, network_paths: Dict[str, str], bidirectional: bool,
           net_dims, device, train_state_path: Optional[str], mesh=None):
    _check_mesh(mesh)
    cfg = _cfg_for(train_data, bidirectional, net_dims)
    ckpt_path = network_paths[f"{kind}_network"]
    return (ckpt_path, cfg, _device(device, mesh),
            ckpt_path + ".trainstate" if train_state_path is None else train_state_path)


def _rows_io(mesh, compat: bool, train_data: CocoData, device_data: bool, dev: torch.device):
    """``(batcher, tables)`` of a trainer, the JAX package's ``_mesh_io``:
    the train split on the run's device (``device_data``,
    :class:`..data.device.DeviceCocoTables`) or in host memory
    (:class:`..data.device.HostCocoTables`), and on a mesh the
    :class:`..parallel.hostbatch.GlobalBatcher` of this rank's rows, which
    the tables gather. The compat (Q1) steps, which treat the batch as
    time, gather whole minibatches on every rank (no batcher, no
    collective)."""
    tables = DeviceCocoTables if device_data else HostCocoTables
    if mesh is None or compat:
        return None, tables(train_data, "train", dev)
    return GlobalBatcher(mesh), tables(train_data, "train", mesh=mesh)


def _init_params(tree: dict, dev: torch.device, mesh) -> dict:
    """Initial parameters on ``dev``; on several ranks, rank 0's (every rank
    draws the same ones from the same seed; the broadcast makes sure)."""
    tree = ckpt.to_device(tree, dev)
    return GlobalBatcher(mesh).replicate(tree) if _multiprocess(mesh) else tree


def _already_trained(what: str, start_epoch: int, epochs: int, writer) -> bool:
    if start_epoch < epochs:
        return False
    print_green(f"[Training] {what} already trained ({start_epoch}/{epochs} epochs) — nothing "
                f"to resume")
    writer.close()
    return True


def train_reward_network(train_data: CocoData, network_paths: Dict[str, str],
                         plot_dir: Optional[str], bidirectional: bool,
                         epochs: int = _T.reward_epochs, batch_size: int = _T.batch_size,
                         lr: float = _T.reward_lr, seed: int = 0,
                         compat_batch_as_time: bool = False, device_data: bool = True,
                         fused_chain: Optional[bool] = None, chunk_steps: int = 16,
                         resume: bool = False, train_state_path: Optional[str] = None,
                         device=None, net_dims: Optional[Dict[str, int]] = None,
                         mesh=None) -> dict:
    """VSE-loss training of the reward network (trainers.py:260-309);
    writes ``network_paths["reward_network"]`` and returns the trained
    parameters. ``compat_batch_as_time``: the batch-as-time encoder (Q1).

    ``chunk_steps`` minibatches run per host dispatch when the train split
    is on the device (``device_data``) and the step is chunked (not compat,
    unidirectional); on the card with the kernels (the default there) each
    chunk is one CUDA graph replay (:class:`.steps.BestLossChunk`).
    ``chunk_steps=1`` or ``device_data=False`` walks one minibatch a
    dispatch, with the same artifacts. A snapshot goes to
    ``train_state_path`` (default ``<checkpoint>.trainstate``) after every
    epoch; ``resume=True`` continues from it bit-identically (a run already
    complete returns at once; no snapshot starts afresh). ``mesh``: the
    data-parallel run of the module docstring."""
    ckpt_path, cfg, dev, state_path = _start("reward", train_data, network_paths, bidirectional,
                                             net_dims, device, train_state_path, mesh)
    fused = _use_fused(fused_chain, dev, cfg, compat=compat_batch_as_time)
    writer = make_metrics_writer(plot_dir if is_main_process() else None)
    rng = np.random.default_rng(seed)
    params = _init_params(reward_mod.init(torch.Generator().manual_seed(seed), cfg,
                                          train_data.embeddings), dev, mesh)
    opt = adam(lr, params, cfg.freeze_embeddings)
    start_epoch, resume_best, resume_fused = _resume_pretrainer(
        resume, state_path, "Reward Network-loss", params, opt, rng,
        multiprocess=_multiprocess(mesh))
    if _already_trained("Reward Network", start_epoch, epochs, writer):
        return params
    _note_route(resume_fused, fused, "reward network")
    step = steps.make_reward_step(cfg, opt, compat=compat_batch_as_time, fused=fused)
    chunk = None
    if chunk_steps > 1 and not compat_batch_as_time and not cfg.bidirectional:
        chunk = steps.make_reward_chunk_step(cfg, opt, params, fused=fused,
                                             graph=fused and _capturable(dev))
    batcher, tables = _rows_io(mesh, compat_batch_as_time, train_data, device_data, dev)
    print_green("[Training] Training Reward Network")
    params = _drive_best_loss_training(
        "Training Reward Network", "Reward Network-loss", "reward", ckpt_path, writer, epochs,
        batch_size, rng, params, step, opt,
        tables=tables, chunk=chunk, chunk_steps=chunk_steps, train_state_path=state_path,
        start_epoch=start_epoch, resume_best=resume_best, fused_used=fused, batcher=batcher)
    writer.close()
    return params


def train_policy_network(train_data: CocoData, network_paths: Dict[str, str],
                         plot_dir: Optional[str], bidirectional: bool,
                         epochs: int = _T.policy_epochs, batch_size: int = _T.batch_size,
                         lr: float = _T.policy_lr, seed: int = 0, device_data: bool = True,
                         fused_chain: Optional[bool] = None, chunk_steps: int = 16,
                         resume: bool = False, train_state_path: Optional[str] = None,
                         device=None, net_dims: Optional[Dict[str, int]] = None,
                         mesh=None) -> dict:
    """Teacher-forced XE pretraining of the policy (trainers.py:202-257);
    writes ``network_paths["policy_network"]``. Chunks (a CUDA graph each on
    the card with the kernels), snapshots, ``resume`` and ``mesh`` as in
    :func:`train_reward_network`."""
    ckpt_path, cfg, dev, state_path = _start("policy", train_data, network_paths, bidirectional,
                                             net_dims, device, train_state_path, mesh)
    fused = _use_fused(fused_chain, dev, cfg)
    writer = make_metrics_writer(plot_dir if is_main_process() else None)
    rng = np.random.default_rng(seed + 1)
    params = _init_params(policy_mod.init(torch.Generator().manual_seed(seed + 1), cfg,
                                          train_data.embeddings), dev, mesh)
    opt = adam(lr, params, cfg.freeze_embeddings)
    start_epoch, resume_best, resume_fused = _resume_pretrainer(
        resume, state_path, "Policy Network-loss", params, opt, rng,
        multiprocess=_multiprocess(mesh))
    if _already_trained("Policy Network", start_epoch, epochs, writer):
        return params
    _note_route(resume_fused, fused, "policy network")
    step = steps.make_policy_step(cfg, opt, fused=fused)
    chunk = None
    if chunk_steps > 1 and not cfg.bidirectional:
        chunk = steps.make_policy_chunk_step(cfg, opt, params, fused=fused,
                                             graph=fused and _capturable(dev))
    batcher, tables = _rows_io(mesh, False, train_data, device_data, dev)
    print_green("[Training] Training Policy Network")
    params = _drive_best_loss_training(
        "Training Policy Network", "Policy Network-loss", "policy", ckpt_path, writer, epochs,
        batch_size, rng, params, step, opt,
        tables=tables, chunk=chunk, chunk_steps=chunk_steps, train_state_path=state_path,
        start_epoch=start_epoch, resume_best=resume_best, fused_used=fused, batcher=batcher)
    writer.close()
    return params


def train_value_network(train_data: CocoData, network_paths: Dict[str, str],
                        plot_dir: Optional[str], bidirectional: bool,
                        epochs: int = _T.value_epochs, batch_size: int = _T.batch_size,
                        lr: float = _T.value_lr, seed: int = 0,
                        compat_batch_as_time: bool = False, device_data: bool = True,
                        fused_chain: Optional[bool] = None, chunk_steps: int = 16,
                        resume: bool = False, train_state_path: Optional[str] = None,
                        device=None, net_dims: Optional[Dict[str, int]] = None,
                        mesh=None) -> dict:
    """MSE training of the critic against the embedding rewards of greedy
    rollouts of the frozen policy (trainers.py:125-199). Loads the reward
    and policy networks from ``network_paths`` and writes
    ``network_paths["value_network"]``. ``compat_batch_as_time``: the
    batch-as-time critic and reward encoders (Q1). Chunks run eagerly, with
    no host sync (each minibatch's prefix length is a host int); snapshots,
    which carry the stdlib prefix-length stream, ``resume`` and ``mesh`` as
    in :func:`train_reward_network` (the frozen networks are rank 0's reads,
    broadcast)."""
    ckpt_path, cfg, dev, state_path = _start("value", train_data, network_paths, bidirectional,
                                             net_dims, device, train_state_path, mesh)
    fused = _use_fused(fused_chain, dev, cfg, compat=compat_batch_as_time)
    writer = make_metrics_writer(plot_dir if is_main_process() else None)
    rng = np.random.default_rng(seed + 2)
    py_rng = pyrandom.Random(seed + 2)
    params = _init_params(value_mod.init(torch.Generator().manual_seed(seed + 2), cfg,
                                         train_data.embeddings), dev, mesh)
    opt = adam(lr, params, cfg.freeze_embeddings)

    def set_py_rng(s):  # JSON gives the tuple back as a list
        py_rng.setstate((s[0], tuple(s[1]), s[2]))

    start_epoch, resume_best, resume_fused = _resume_pretrainer(
        resume, state_path, "Value Network-loss", params, opt, rng, set_extra=set_py_rng,
        multiprocess=_multiprocess(mesh))
    if _already_trained("Value Network", start_epoch, epochs, writer):
        return params
    _note_route(resume_fused, fused, "value network")
    rparams = _load_or_fail_sync("reward", network_paths["reward_network"], dev, cfg, mesh)
    pparams = _load_or_fail_sync("policy", network_paths["policy_network"], dev, cfg, mesh)
    step = steps.make_value_step(cfg, opt, pparams, rparams, compat=compat_batch_as_time,
                                 fused=fused)

    def single_step(params, features, captions, shard=None):
        # one random prefix length per minibatch, shared by the batch
        # (trainers.py:177), drawn in minibatch order on both walks
        return step(params, features, captions, py_rng.randint(1, MAX_SEQ_LEN), shard)

    chunk = None
    if chunk_steps > 1 and not compat_batch_as_time and not cfg.bidirectional:
        chunk = steps.make_value_chunk_step(cfg, opt, params, pparams, rparams, fused=fused)
    batcher, tables = _rows_io(mesh, compat_batch_as_time, train_data, device_data, dev)
    print_green("[Training] Training Value Network")
    params = _drive_best_loss_training(
        "Training Value Network", "Value Network-loss", "value", ckpt_path, writer, epochs,
        batch_size, rng, params, single_step, opt,
        tables=tables, chunk=chunk, chunk_steps=chunk_steps,
        draw_extras=lambda k: [(py_rng.randint(1, MAX_SEQ_LEN),) for _ in range(k)],
        train_state_path=state_path, start_epoch=start_epoch, resume_best=resume_best,
        extra_state_fn=lambda: list(py_rng.getstate()), fused_used=fused, batcher=batcher)
    writer.close()
    return params


def _load_or_fail_sync(kind: str, path: str, dev: torch.device, cfg: NetConfig, mesh) -> dict:
    """:func:`.checkpoint.load_network`, rank 0's read broadcast on a mesh
    that spans processes (:func:`_sync_load`)."""
    init = {"reward": reward_mod.init, "policy": policy_mod.init, "value": value_mod.init}
    return _sync_load(lambda: ckpt.load_network(kind, path, dev, cfg),
                      lambda: ckpt.to_device(init[kind](torch.Generator().manual_seed(0), cfg),
                                             dev),
                      _multiprocess(mesh))


def _host_caplen(captions: np.ndarray) -> int:
    """A minibatch's largest END position + 1 (trainers.py:547), from the
    host's captions."""
    return int(np.max(np.argmax(captions == END_ID, axis=1)) + 1)


def _host_curr(captions: np.ndarray, level: Optional[int]) -> int:
    """A minibatch's ``curr_seq_len``: 1 for plain A2C; for a curriculum
    level, the batch's largest END position + 1 (trainers.py:547) less the
    level, from the host's captions."""
    if level is None:
        return 1
    return _host_caplen(captions) - level


def _drive_a2c_epoch(*, epoch: int, level: Optional[int], train_data: CocoData,
                     batch_size: int, chunk, chunk_steps: int, tables, a2c_params: dict,
                     reward_params: dict, rng: np.random.Generator, key: np.ndarray, keeper,
                     batcher: Optional[GlobalBatcher] = None) -> np.ndarray:
    """One epoch of (curriculum) A2C minibatch updates, the JAX package's
    walk (``loops.py:1057-1150``): plain A2C (``level`` None) rolls out from
    position 1; a curriculum level teacher-forces ``curr_seq_len = caplen -
    level`` positions and skips a minibatch where that is below 1. The
    minibatches of one permutation run through ``chunk``
    (:func:`.steps.make_a2c_chunk_step`) ``chunk_steps`` whole minibatches
    a dispatch (1 for the per-step walk); the ragged tail is a dispatch of
    its own. Each minibatch's key is split off in order, before the skip
    rule, so every ``chunk_steps`` draws the same stream. A dispatch's stats
    come back in one copy, read by ``keeper`` once the next dispatch is
    queued. With ``batcher`` (a mesh) ``tables`` gather this rank's rows,
    each minibatch's ``caplen`` comes from the host's global captions and
    the chunk takes the row shard (a ragged minibatch runs whole). Returns
    the carried key."""
    host_caps, num = train_data.train_captions, tables.num_captions
    with annotate("train.permute"):
        perm = rng.permutation(num)  # the draw of data.coco.epoch_minibatch_indices
    i = minibatch_id = 0
    while i < num:
        with annotate("train.gather"):
            k = max(1, min(chunk_steps, (num - i) // batch_size))
            mask = perm[i: i + k * batch_size]
            n = len(mask) // k
            subs, currs, caplens = [], [], []
            for j in range(k):
                key, sub = split(key)
                subs.append(sub)
                caplens.append(_host_caplen(host_caps[mask[j * n: (j + 1) * n]]))
                currs.append(1 if level is None else caplens[-1] - level)
            shard = None if batcher is None else batcher.row_shard(n)
            caps_b, feats_b = tables.gather(mask, k=k)
            rows = n if shard is None else shard.rows
        with annotate("train.dispatch"):
            stats, valid = chunk(a2c_params, reward_params, feats_b.view(k, rows, -1),
                                 caps_b.long().view(k, rows, -1), currs, subs,
                                 None if batcher is None else caplens, shard)
        keeper.push(stats, valid, epoch, minibatch_id)
        minibatch_id += k
        i += len(mask)
    keeper.flush()
    return key


def _a2c_resolver(desc: str, tags: tuple, writer, state: dict, a2c_params: dict, save_paths,
                  batch_size: int, main: bool = True):
    """The bookkeeping of one A2C dispatch, ``resolve(stats, valid, epoch,
    first_id)``: its ``[k]`` stats read back in one copy, then for each
    minibatch that ran (``valid``; a skipped curriculum minibatch logs
    nothing) the divergence guard (dumping the current weights next to the
    first save path), the best loss, and the three metric tags (loss, mean
    reward, mean advantage)."""

    def resolve(stats, valid, epoch, first_id):
        with annotate("train.losses"):
            host = torch.stack(list(stats)).cpu().numpy()  # [5, k], one copy
            for j in np.flatnonzero(valid):
                loss = float(host[0, j])
                minibatch_id = first_id + int(j)
                check_finite(loss, desc, f"epoch {epoch + 1}, minibatch {minibatch_id}",
                             dump=lambda path: ckpt.save_pytree(a2c_params, path),
                             dump_path=str(save_paths[0]) + ".diverged"
                             if save_paths and main else None)
                state["best"] = min(state["best"], loss)
                n = global_minibatch_number(epoch, minibatch_id, batch_size)
                rec = steps.RolloutStats(*host[:, j])
                writer.add_scalar(tags[0], loss, n)
                writer.add_scalar(tags[1], float(rec.mean_reward), n)
                writer.add_scalar(tags[2], float(rec.mean_advantage), n)

    return resolve


def _a2c_epochs(desc: str, tags: tuple, level: Optional[int], writer, train_data: CocoData,
                a2c_params: dict, reward_params: dict, chunk, chunk_steps: int, tables,
                save_paths, batch_size: int, first_epoch: int, epochs: int,
                rng: np.random.Generator, key: np.ndarray, best: Optional[float], snapshot,
                batcher: Optional[GlobalBatcher] = None) -> np.ndarray:
    """The epochs ``first_epoch .. epochs - 1`` of one A2C run (or curriculum
    level): after each, the weights go to every save path
    (trainers.py:498; rank 0's) and ``snapshot(epoch, key, best)`` runs."""
    state = {"best": float("inf") if best is None else best}
    main = is_main_process()
    keeper = _DeferredBookkeeper(_a2c_resolver(desc, tags, writer, state, a2c_params,
                                               save_paths, batch_size, main))
    for epoch in range(first_epoch, epochs):
        t0 = time.perf_counter()
        key = _drive_a2c_epoch(epoch=epoch, level=level, train_data=train_data,
                               batch_size=batch_size, chunk=chunk, chunk_steps=chunk_steps,
                               tables=tables, a2c_params=a2c_params,
                               reward_params=reward_params, rng=rng, key=key, keeper=keeper,
                               batcher=batcher)
        with annotate("train.snapshot"):
            if main:
                ckpt.save_to_paths(a2c_params, save_paths)  # every epoch (trainers.py:498)
            snapshot(epoch, key, state["best"])
        print(f"{desc} ({epoch + 1}/{epochs}): {time.perf_counter() - t0:.1f} s, best loss "
              f"{state['best']}", flush=True)
    return key


def _a2c_resume_state(resume: bool, train_state_path: Optional[str], a2c_params: dict,
                      optimizer: torch.optim.Optimizer, kind: str, what: str, mesh=None):
    """A2C's snapshot, restored into ``a2c_params`` and ``optimizer`` in
    place, or None (``resume`` off, or no snapshot). A snapshot of the
    other A2C kind raises ``ValueError``, as the JAX package's does. On a
    mesh rank 0 reads it for every rank."""
    if not resume or not train_state_path:
        return None

    def meta_check(meta):
        if meta.get("kind") != kind:
            raise ValueError(f"train-state kind {meta.get('kind')!r} cannot resume {what}")

    state = _load_train_state_sync(train_state_path, a2c_params, meta_check,
                                   _multiprocess(mesh))
    if state is not None:
        ckpt.restore_train_state(state, a2c_params, optimizer)
    return state


def _a2c_setup(cfg: NetConfig, optimizer, a2c_params: dict, train_data: CocoData,
               per_step_mean: bool, compat: bool, fused_rollout, fuse_reward: bool,
               device_data: bool, chunk_steps: int, mesh=None) -> tuple:
    """A2C's route, chunk step, row batcher (a mesh's, None for compat),
    tables and minibatches a dispatch: ``chunk_steps`` from device tables
    (not compat), else 1."""
    _check_mesh(mesh)
    device = a2c_params["policy"]["embedding"].device
    fused = _use_fused(fused_rollout, device, cfg, "fused_rollout", compat)
    chunk = steps.make_a2c_chunk_step(cfg, optimizer, per_step_mean=per_step_mean,
                                      compat=compat, fused=fused, fuse_reward=fuse_reward)
    batcher, tables = _rows_io(mesh, compat, train_data, device_data, device)
    return (fused, chunk, batcher, tables,
            chunk_steps if device_data and not compat else 1)


def a2c_training(train_data: CocoData, a2c_params: dict, reward_params: dict,
                 optimizer: torch.optim.Optimizer, cfg: NetConfig, plot_dir: Optional[str],
                 save_paths, batch_size: int, epochs: int, seed: int = 0,
                 compat_batch_as_time: bool = False, device_data: bool = True,
                 chunk_steps: int = 16, fused_rollout: Optional[bool] = None,
                 fuse_reward: bool = True, train_state_path: Optional[str] = None,
                 resume: bool = False, mesh=None) -> dict:
    """The A2C loop (trainers.py:402-500): per minibatch one rollout from
    the start column, the A2C loss and one optimiser step of ``a2c_params``
    (updated in place); the weights go to every path of ``save_paths``
    after every epoch. Numpy seed and threefry key ``seed + 3``.
    ``compat_batch_as_time``: the Q1 rollout
    (:func:`.steps.a2c_rollout_loss_compat`), one minibatch a dispatch.

    ``chunk_steps`` minibatches run per host dispatch (eagerly, with no host
    sync) when the train split is on the device (``device_data``); the keys
    are split one per minibatch as the per-step walk splits them, so the
    run is the same at any ``chunk_steps``. A snapshot (weights, Adam's
    state, the key, the numpy generator, the epoch, the best loss, the
    route) goes to ``train_state_path`` after every epoch; ``resume=True``
    continues from it bit-identically (a run already complete returns at
    once; no snapshot starts afresh; a curriculum snapshot raises). ``mesh``:
    the data-parallel run of the module docstring (each rank's rollout draws
    its rows of the minibatch's noise)."""
    writer = make_metrics_writer(plot_dir if is_main_process() else None)
    rng, key = np.random.default_rng(seed + 3), PRNGKey(seed + 3)
    start_epoch, best, resume_fused = 0, None, None
    rs = _a2c_resume_state(resume, train_state_path, a2c_params, optimizer, "a2c",
                           "a plain (non-curriculum) A2C run", mesh)
    if rs is not None:
        meta = rs["meta"]
        key, rng.bit_generator.state = rs["key"], meta["rng_state"]
        start_epoch, best, resume_fused = meta["epoch_done"], meta["best"], meta.get("fused")
        print_green(f"[Training] resumed full A2C train state (epoch {start_epoch} done) from "
                    f"{train_state_path}")
    if _already_trained("A2C Network", start_epoch, epochs, writer):
        return a2c_params
    fused, chunk, batcher, tables, chunk_steps = _a2c_setup(
        cfg, optimizer, a2c_params, train_data, False, compat_batch_as_time, fused_rollout,
        fuse_reward, device_data, chunk_steps, mesh)
    _note_route(resume_fused, fused, "A2C rollout")

    def snapshot(epoch, key, best):
        if train_state_path and is_main_process():
            ckpt.save_train_state(train_state_path, a2c_params, optimizer, key,
                                  {"kind": "a2c", "epoch_done": epoch + 1, "best": best,
                                   "fused": fused, "rng_state": rng.bit_generator.state})

    print_green("[Training] Training Advantage Actor-Critic Network")
    _a2c_epochs("Training A2C Network",
                ("A2C Network-episodic-loss", "A2C Network-episodic-mean-rewards",
                 "A2C Network-episodic-mean-advantage"),
                None, writer, train_data, a2c_params, reward_params, chunk, chunk_steps,
                tables, save_paths, batch_size, start_epoch, epochs, rng, key, best, snapshot,
                batcher)
    writer.close()
    return a2c_params


def a2c_curriculum_training(train_data: CocoData, a2c_params: dict, reward_params: dict,
                            optimizer: torch.optim.Optimizer, cfg: NetConfig,
                            plot_dir: Optional[str], save_paths, batch_size: int, epochs: int,
                            curriculum: Sequence[int], seed: int = 0,
                            compat_batch_as_time: bool = False, device_data: bool = True,
                            chunk_steps: int = 16, fused_rollout: Optional[bool] = None,
                            fuse_reward: bool = True, train_state_path: Optional[str] = None,
                            resume: bool = False, mesh=None) -> dict:
    """Curriculum A2C (trainers.py:503-616): per level, ``epochs`` epochs
    that teacher-force the ground-truth prefix of length ``caplen - level``
    and roll out the last ``level`` tokens, with the per-step-mean loss. One
    numpy generator and one key (``seed + 4``) run through all levels.
    ``compat_batch_as_time``, chunks, snapshots (which carry the levels and
    the level reached), ``resume`` and ``mesh`` as in :func:`a2c_training`;
    a snapshot of a plain run or of other levels raises."""
    writer = make_metrics_writer(plot_dir if is_main_process() else None)
    rng, key = np.random.default_rng(seed + 4), PRNGKey(seed + 4)
    curriculum = list(curriculum)
    start_level, start_epoch, best, resume_fused = 0, 0, None, None
    rs = _a2c_resume_state(resume, train_state_path, a2c_params, optimizer, "a2c_curriculum",
                           "a curriculum A2C run", mesh)
    if rs is not None:
        meta = rs["meta"]
        if meta["curriculum"] != curriculum:
            raise ValueError(f"train-state curriculum {meta['curriculum']} does not match the "
                             f"requested {curriculum}")
        key, rng.bit_generator.state = rs["key"], meta["rng_state"]
        start_level, start_epoch = meta["level_idx"], meta["epoch_done"]
        best, resume_fused = meta["best"], meta.get("fused")
        print_green(f"[Training] resumed full A2C train state (level index {start_level}, "
                    f"epoch {start_epoch} done) from {train_state_path}")
        if start_epoch >= epochs:  # resumed at a level boundary
            start_level, start_epoch, best = start_level + 1, 0, None
    if start_level >= len(curriculum):
        print_green(f"[Training] curriculum already complete ({len(curriculum)} levels) — "
                    f"nothing to resume")
        writer.close()
        return a2c_params
    fused, chunk, batcher, tables, chunk_steps = _a2c_setup(
        cfg, optimizer, a2c_params, train_data, True, compat_batch_as_time, fused_rollout,
        fuse_reward, device_data, chunk_steps, mesh)
    _note_route(resume_fused, fused, "A2C rollout")
    print_green("[Training] Training Advantage Actor-Critic Network")
    print_green(f"[Training] mode set to curriculum training using levels: {curriculum}")
    for level_idx, level in enumerate(curriculum):
        if level_idx < start_level:
            continue  # resumed past this level
        print_green(f"[Training] Training curriculum level: {level}")
        tag = f"A2C Curriculum Level-{level}"

        def snapshot(epoch, key, best, level_idx=level_idx):
            if train_state_path and is_main_process():
                ckpt.save_train_state(
                    train_state_path, a2c_params, optimizer, key,
                    {"kind": "a2c_curriculum", "curriculum": curriculum, "level_idx": level_idx,
                     "epoch_done": epoch + 1, "best": best, "fused": fused,
                     "rng_state": rng.bit_generator.state})

        first = level_idx == start_level
        key = _a2c_epochs(f"Training A2C Curriculum Level {level}",
                          (f"{tag}-loss", f"{tag}-mean-rewards", f"{tag}-mean-advantage"),
                          level, writer, train_data, a2c_params, reward_params, chunk,
                          chunk_steps, tables, save_paths, batch_size,
                          start_epoch if first else 0, epochs, rng, key,
                          best if first else None, snapshot, batcher)
    writer.close()
    return a2c_params


def train_a2c_network(train_data: CocoData, save_paths: Dict[str, str],
                      network_paths: Dict[str, str], plot_dir: Optional[str],
                      bidirectional: bool, epochs: int, batch_size: int,
                      retrain_all: bool = False, curriculum: Optional[Sequence[int]] = None,
                      seed: int = 0, compat_batch_as_time: bool = False, resume: bool = False,
                      fused_rollout: Optional[bool] = None, chunk_steps: int = 16,
                      a2c_lr: float = _T.a2c_lr, device_data: bool = True,
                      train_state_path: Optional[str] = None, device=None,
                      net_dims: Optional[Dict[str, int]] = None, fuse_reward: bool = True,
                      stage_seconds: Optional[Dict[str, float]] = None, mesh=None):
    """The A2C orchestrator (trainers.py:312-399): load each sub-network
    from ``network_paths`` (training it when its file is missing, or all
    three with ``retrain_all``), freeze the reward network, then run plain
    or curriculum A2C with Adam at ``a2c_lr`` over ``{"value", "policy"}``
    (frozen embeddings stay out of it), saving to
    ``save_paths["model_path"]`` and ``network_paths["a2c_network"]`` every
    epoch, and append the parameter summary to
    ``save_paths["results_path"]``. ``fuse_reward=False`` runs the frozen
    reward stream as its own kernel after each fused rollout instead of
    inside it. ``compat_batch_as_time`` trains the reward and value networks
    and runs A2C with the batch-as-time encoders (Q1); the policy has no
    such mode. ``chunk_steps`` and ``device_data`` reach every trainer.
    ``stage_seconds``, when given, receives the wall seconds of each
    sub-network trained and of the A2C loop. Returns ``(a2c_params,
    reward_params, cfg)``.

    ``resume=True`` continues from the snapshots: a sub-network whose
    ``.trainstate`` exists continues its pretraining, and A2C continues
    from ``train_state_path`` (default
    ``network_paths["a2c_network"] + ".trainstate"``); where A2C has no
    snapshot, its weights come from ``network_paths["a2c_network"]`` with a
    fresh optimiser and generators (the reference's resume,
    trainers.py:338-370), or it starts afresh without that file.

    ``mesh`` reaches every trainer (the data-parallel run of the module
    docstring); whether a file exists and what it holds are rank 0's
    answers, broadcast, and rank 0 alone writes."""
    _check_mesh(mesh)
    cfg = _cfg_for(train_data, bidirectional, net_dims)
    dev = _device(device, mesh)
    multiprocess = _multiprocess(mesh)
    # raises before any training
    _use_fused(fused_rollout, dev, cfg, "fused_rollout", compat_batch_as_time)
    all_save_paths = [save_paths["model_path"], network_paths["a2c_network"]]
    kw = dict(batch_size=batch_size, seed=seed, device=dev, net_dims=net_dims,
              chunk_steps=chunk_steps, device_data=device_data, resume=resume, mesh=mesh)
    trainers = {"reward": train_reward_network, "policy": train_policy_network,
                "value": train_value_network}
    seconds = {} if stage_seconds is None else stage_seconds
    nets = {}

    def train(kind, train_fn):
        t0 = time.perf_counter()
        compat = {} if kind == "policy" else {"compat_batch_as_time": compat_batch_as_time}
        nets[kind] = train_fn(train_data, network_paths, plot_dir, bidirectional, **kw, **compat)
        seconds[kind] = time.perf_counter() - t0

    if retrain_all:
        print_green("[Training] Training all the networks")
    for kind, train_fn in trainers.items():
        path = network_paths[f"{kind}_network"]
        if retrain_all or (resume and _exists_sync(path + ".trainstate", multiprocess)):
            train(kind, train_fn)  # with resume, an interrupted pretraining continues
            continue
        try:
            nets[kind] = _load_or_fail_sync(kind, path, dev, cfg, mesh)
            print(f"[Training] loaded {kind} network")
        except FileNotFoundError:
            print(f"[Training] {kind} network not found")
            train(kind, train_fn)
    if retrain_all:
        print_green("[Training] All networks trained")
    reward_params = _clone(nets["reward"])  # frozen: detached, no gradient
    a2c_params = {"value": nets["value"], "policy": nets["policy"]}
    state_path = (network_paths["a2c_network"] + ".trainstate" if train_state_path is None
                  else train_state_path)
    if resume and not _exists_sync(state_path, multiprocess):
        # no snapshot: the reference's weights-only resume (fresh Adam, epoch 0)
        try:
            loaded = _sync_load(
                lambda: ckpt.load_network("a2c", network_paths["a2c_network"], dev, cfg),
                lambda: _clone(a2c_params), multiprocess)
            a2c_params = {k: loaded[k] for k in ("value", "policy")}
            print_green("[Training] resumed A2C weights from checkpoint")
        except FileNotFoundError:
            print("[Training] no A2C checkpoint to resume; starting fresh")
    optimizer = adam(a2c_lr, a2c_params, cfg.freeze_embeddings)  # trainers.py:378

    print(f"[Training] train_data len = {len(train_data.train_captions)}")
    print(f"[Training] episodes = {batch_size}")
    print(f"[Training] epochs = {epochs}")
    args = (train_data, a2c_params, reward_params, optimizer, cfg, plot_dir, all_save_paths,
            batch_size, epochs)
    kw = dict(seed=seed, compat_batch_as_time=compat_batch_as_time, device_data=device_data,
              chunk_steps=chunk_steps, fused_rollout=fused_rollout, fuse_reward=fuse_reward,
              train_state_path=state_path, resume=resume, mesh=mesh)
    t0 = time.perf_counter()
    if curriculum is None:
        a2c_training(*args, **kw)
    else:
        curriculum = list(curriculum)
        if 16 not in curriculum:
            curriculum.append(16)  # the last level is full training (trainers.py:389-390)
        a2c_curriculum_training(*args, curriculum, **kw)
    seconds["a2c"] = time.perf_counter() - t0
    if is_main_process():
        append_results(save_paths["results_path"],
                       describe_params("AdvantageActorCriticNetwork", a2c_params),
                       header="network")
    return a2c_params, reward_params, cfg


def test_a2c_network(a2c_params: dict, cfg: NetConfig, test_data: CocoData,
                     image_caption_data: Dict[str, str], data_size: int,
                     validation_batch_size: int = 128, dcfg: Optional[DecodeConfig] = None,
                     seed: int = 0, eval_superbatch: int = 8, compat_dump: bool = False,
                     use_fused_kernel: Optional[bool] = None, device=None, mesh=None) -> None:
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
    raises. A bidirectional model runs the carried beam
    (:func:`..decode.beam.beam_search`) in float32 on ``device``, as the
    JAX package routes it, and refuses ``use_fused_kernel=True``.

    The faithful mode (``dcfg.per_sample_beams=False``) is the reference's
    own eval: the Q2 batch-mean beam with the Q1-stateful critic
    (:func:`..decode.beam_compat.beam_search_compat`, float32 on
    ``device``, either direction mode), a fresh zero carry per slice
    (trainers.py:661), one slice a decode (the batch-mean ranking couples
    its rows) and the ragged tail at its own size, unpadded. It refuses
    ``use_fused_kernel=True`` (``ValueError``), as the JAX package does.

    ``mesh`` shards each group's per-sample beam over the mesh's ``data``
    axis (:func:`..parallel.serve.sharded_beam_tokens`: each entry's rows
    through its device's beam kernel, or the carried beam of a
    bidirectional model; ``use_fused_kernel`` honoured block by block); the
    faithful mode couples a decode's rows and ignores the mesh. Every rank
    decodes, rank 0 alone writes the dumps. On a 2-D mesh the rows split
    over ``data`` and the parameters are replicated over ``model``; a
    vocab-sharded tree is gathered once, here.
    """
    a2c_params = gather_params(a2c_params)
    dcfg = dcfg or DecodeConfig(max_seq_len=cfg.max_seq_len)
    faithful = not dcfg.per_sample_beams
    if faithful:
        _forced_fused_conflict(use_fused_kernel, "use_fused_kernel=True",
                               "in faithful (batch-mean Q2) mode")
    if cfg.bidirectional:
        _forced_fused_conflict(use_fused_kernel, "use_fused_kernel=True",
                               "with a bidirectional model")
    dev = _device(device, mesh)
    if use_fused_kernel and dev.type != "cuda":
        raise RuntimeError("use_fused_kernel=True needs a CUDA device: the beam kernel runs "
                           "only on the card")
    if mesh is not None and not faithful:
        from ..parallel.serve import sharded_beam_tokens
        from ..parallel.sharding import replicate

        pp, vp = (replicate(mesh, a2c_params[k]) for k in ("policy", "value"))

        def decode(features, start):
            return sharded_beam_tokens(mesh, pp, vp, cfg, dcfg, features, start,
                                       use_fused_kernel=use_fused_kernel)
    elif faithful or cfg.bidirectional:
        pparams, vparams = (ckpt.to_device(a2c_params[k], dev) for k in ("policy", "value"))
        beam_fn = beam_search_compat if faithful else beam_search

        def decode(features, start):
            with torch.no_grad():  # the compat beam's carry starts at zero per call
                return beam_fn(pparams, vparams, cfg, dcfg, features, start)[:2]
    else:
        wd = torch.bfloat16 if dev.type == "cuda" else torch.float32
        weights = prepare_beam_weights(
            prepare_greedy_weights(ckpt.to_device(a2c_params["policy"], dev), wd),
            ckpt.to_device(a2c_params["value"], dev))

        def decode(features, start):
            return fused_beam_search(
                weights, features, start, max_len=dcfg.max_seq_len, beam=dcfg.beam_size,
                value_weight=dcfg.value_weight, logprob_weight=dcfg.logprob_weight,
                use_fused_kernel=use_fused_kernel)

    rng = np.random.default_rng(seed + 5)
    captions_all, features_all, urls_all = get_coco_batch(
        test_data, batch_size=data_size, split="val", rng=rng)
    width = validation_batch_size - 1  # Q9: 127-wide slices per 128 stride
    slices = [
        (captions_all[i: i + width], features_all[i: i + width], urls_all[i: i + width])
        for i in range(0, len(captions_all), validation_batch_size)
    ]
    slices = [s for s in slices if s[0].shape[0] > 0]
    group = 1 if faithful else eval_superbatch  # Q2 couples a decode's rows
    gwidth = width * group

    def write_slice(f, lines):
        if compat_dump:
            f.write("\n".join(lines))  # Q13: no trailing newline
        else:
            f.write("\n".join(lines) + "\n")

    def open_main(path):  # every rank decodes, rank 0 alone writes
        return open(path if is_main_process() else os.devnull, "a")

    t0 = time.perf_counter()
    with open_main(image_caption_data["real_captions_path"]) as real_f, \
         open_main(image_caption_data["generated_captions_path"]) as gen_f, \
         open_main(image_caption_data["image_urls_path"]) as url_f:
        for g in range(0, len(slices), group):
            batch = slices[g: g + group]
            captions_real = np.concatenate([b[0] for b in batch], axis=0)
            features_real = np.concatenate([b[1] for b in batch], axis=0)
            n_real = captions_real.shape[0]
            if n_real < gwidth and not faithful:  # pad: one shape for the beam
                pad = gwidth - n_real
                features_real = np.concatenate(
                    [features_real, np.repeat(features_real[-1:], pad, axis=0)], axis=0)
                captions_real = np.concatenate(
                    [captions_real, np.repeat(captions_real[-1:], pad, axis=0)], axis=0)
            toks, _ = decode(
                torch.from_numpy(np.ascontiguousarray(features_real, np.float32)).to(dev),
                torch.from_numpy(captions_real[:, 0].astype(np.int32)).to(dev))
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
    print(f"Testing model: {len(slices)} slices in {-(-len(slices) // group)} groups "
          f"of {gwidth} rows in {time.perf_counter() - t0:.1f} s", flush=True)


def load_a2c_models(model_path: str, train_data: CocoData, network_paths: Dict[str, str],
                    bidirectional: bool, net_dims: Optional[Dict[str, int]] = None,
                    device=None, mesh=None) -> tuple:
    """Load a finished A2C model for testing (utilities.py:299-323): the
    policy and value networks from their own files, then the a2c file over
    them, which holds both (each ``.pt`` or native, by suffix; every shape
    checked against the config). Returns ``(params, cfg)``, the parameters
    on ``device`` (the card unless the caller asks for the CPU; a missing
    CUDA device raises), or on this rank's device of ``mesh``. On a mesh
    that spans processes rank 0 reads the files and broadcasts what it
    read (:func:`_sync_load`): a rank without the files still loads, and
    a file missing on rank 0 raises on every rank."""
    cfg = _cfg_for(train_data, bidirectional, net_dims)
    dev = _device(device, mesh)

    def load():
        params = {kind: ckpt.load_network(kind, network_paths[f"{kind}_network"], dev, cfg)
                  for kind in ("value", "policy")}
        params.update(ckpt.load_network("a2c", model_path, dev, cfg))
        return params

    def template():
        gen = torch.Generator().manual_seed(0)
        return {"value": ckpt.to_device(value_mod.init(gen, cfg), dev),
                "policy": ckpt.to_device(policy_mod.init(gen, cfg), dev)}

    return _sync_load(load, template, _multiprocess(mesh)), cfg
