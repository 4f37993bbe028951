"""Checkpoint persistence (counterpart of the JAX ``train/checkpoint.py``).

A network's file format follows its path's suffix, as in the JAX package:

  * ``.pt``: the reference's own format, one ``torch.save``d state dict in
    the reference layout (:mod:`..models.convert`);
  * anything else (the CLI names them ``*.ckpt``): the native format, flax's
    msgpack of the parameter tree (:mod:`..utils.msgpack`). For the same
    tree the bytes equal the JAX package's ``save_pytree``, and its
    ``load_network(kind, path, template=...)`` reads them.

Every write is published atomically. A vocab-sharded tree
(:class:`..parallel.sharding.Sharded`) is first gathered over its model
group (a collective: every rank of the group writes with it), and rank 0
writes the whole tree: the same bytes as a write of the unsharded tree.
:func:`load_network` checks the tree's
keys against the network kind's and, given a config, every shape: the JAX
package's ``from_bytes`` copies without a shape check; the port raises,
naming the file and the first leaf that differs. A network's direction
is its tree's: a ``.pt`` with ``_reverse`` keys or a tree whose cells are
``*_fwd`` / ``*_bwd`` pairs is bidirectional, and a given ``cfg`` must
agree with it.

Full training-state snapshots (``*.trainstate``, exact resume) are written
in the JAX package's layout: flax's msgpack of ``{"params", "opt_state",
"key", "meta"}`` with ``meta`` a JSON string (numpy's 128-bit PCG64 state
needs JSON's big ints) and ``opt_state`` optax's tree for ``adam(lr)``
(``multi_transform``'s, with masked embedding leaves, for
``freeze_embeddings=True``), translated to and from ``torch.optim.Adam``'s
``step``, ``exp_avg`` and ``exp_avg_sq``. For the same state the bytes equal
the JAX package's ``save_train_state``, and each package resumes the
other's snapshots. Orbax is not ported.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ..api import resolve_device
from ..config import NetConfig
from ..models import a2c as a2c_mod
from ..models import policy as policy_mod
from ..models import reward as reward_mod
from ..models import value as value_mod
from ..models.convert import load_state_dict, network_from_state_dict, network_to_state_dict
from ..parallel.mesh import is_main_process
from ..parallel.sharding import gather_params
from ..utils import msgpack
from ..utils.io import atomic_write

_INITS = {"policy": policy_mod.init, "value": value_mod.init, "reward": reward_mod.init,
          "a2c": a2c_mod.init}
# the smallest config: the kinds' keys without their widths
_KEYS_CFG = NetConfig(vocab_size=5, input_dim=1, wordvec_dim=1, hidden_dim=1)


def _numpy(tree: dict) -> dict:
    return {k: _numpy(v) if isinstance(v, dict)
            else v.detach().to("cpu", torch.float32).contiguous().numpy()
            for k, v in tree.items()}


def _whole(params: dict) -> Optional[dict]:
    """The tree to write: a vocab-sharded one gathered over its model group,
    None on the ranks that then leave the write to rank 0."""
    if getattr(params, "vocab", None) is None:
        return params
    params = gather_params(params)
    return params if is_main_process() else None


def save_pytree(params: dict, path: str) -> None:
    """``params`` (a tree of tensors) as a native msgpack checkpoint,
    float32, published atomically."""
    params = _whole(params)
    if params is None:
        return
    data = msgpack.packb(_numpy(params))
    with atomic_write(path) as f:
        f.write(data)


def load_pytree(path: str) -> dict:
    """A native msgpack checkpoint -> its tree of CPU tensors (the stored
    dtypes)."""
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read())
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a parameter tree (a {type(tree).__name__})")

    def to_torch(node, where):
        if isinstance(node, dict):
            return {k: to_torch(v, f"{where}/{k}" if where else k) for k, v in node.items()}
        if not isinstance(node, np.ndarray):
            raise ValueError(f"{path}: leaf {where!r} is a {type(node).__name__}, not an array")
        return torch.from_numpy(node)

    return to_torch(tree, "")


def _leaves(tree: dict, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], path + (k,))
        else:
            yield "/".join(path + (k,)), tree[k]


def _check_network(kind: str, params: dict, path: str, cfg: Optional[NetConfig] = None) -> None:
    """Raise ``ValueError`` unless ``params`` has the leaves of a ``kind``
    network (float32) of ``cfg``'s directions (the tree's own without one),
    and, given ``cfg``, their shapes; the message names ``path`` and the
    first leaf that differs."""
    if kind not in _INITS:
        raise ValueError(f"unknown network kind {kind!r} (expected one of {sorted(_INITS)})")
    keys_cfg = cfg or dataclasses.replace(_KEYS_CFG, bidirectional=is_bidirectional(kind, params))
    want = dict(_leaves(_INITS[kind](torch.Generator().manual_seed(0), keys_cfg)))
    got = dict(_leaves(params))
    for name in sorted(want.keys() | got.keys()):
        if name not in got:
            raise ValueError(f"{path}: not a {kind} network: leaf {name!r} is missing")
        if name not in want:
            raise ValueError(f"{path}: not a {kind} network: leaf {name!r} is not one of its")
        if got[name].dtype != torch.float32:
            raise ValueError(f"{path}: leaf {name!r} is {got[name].dtype}, not float32")
        if cfg is not None and tuple(got[name].shape) != tuple(want[name].shape):
            raise ValueError(f"{path}: leaf {name!r} has shape {tuple(got[name].shape)}, but "
                             f"this {kind} network needs {tuple(want[name].shape)} (check "
                             f"--input_dim/--wordvec_dim/--hidden_dim, --bidirectional and the "
                             f"vocabulary)")


def load_network(kind: str, path: str, device="cuda", cfg: Optional[NetConfig] = None) -> dict:
    """A checkpoint of ``kind`` (policy, value, reward or a2c) -> the port's
    parameter tree, float32 on ``device`` (the card unless the caller asks
    for ``"cpu"``; a missing CUDA device raises). ``.pt`` goes through the
    reference converters, any other path through msgpack; the tree is
    checked by :func:`_check_network`. The network is bidirectional when
    ``cfg`` is, or, without ``cfg``, when the file is."""
    device = resolve_device(device)
    if str(path).endswith(".pt"):
        sd = load_state_dict(path)
        bidirectional = (cfg.bidirectional if cfg is not None
                         else any(k.endswith("_reverse") for k in sd))
        params = network_from_state_dict(kind, sd, bidirectional)
    else:
        params = load_pytree(path)
    _check_network(kind, params, path, cfg)
    return to_device(params, device)


def is_bidirectional(kind: str, params: dict) -> bool:
    """Whether a ``kind`` tree's recurrent cells are ``*_fwd`` / ``*_bwd``
    pairs."""
    tree = params.get("policy", {}) if kind == "a2c" else params
    return any(k.endswith("_fwd") for k in tree)


def save_network_pt(kind: str, params: dict, path: str) -> None:
    """``params`` of ``kind`` as a reference-layout ``.pt`` state dict (the
    ``_reverse`` keys too for a bidirectional tree), published atomically."""
    params = _whole(params)
    if params is None:
        return
    sd = network_to_state_dict(kind, params, is_bidirectional(kind, params))
    with atomic_write(path) as f:
        torch.save(sd, f)


def save_network(kind: str, params: dict, path: str) -> None:
    """``params`` of ``kind`` in the format ``path``'s suffix names: ``.pt``
    the reference state dict, anything else the native msgpack tree."""
    if str(path).endswith(".pt"):
        save_network_pt(kind, params, path)
    else:
        save_pytree(params, path)


def save_to_paths(params: dict, save_paths) -> None:
    """The a2c ``{"policy", "value"}`` parameters to one path or a list of
    them, each in the format its suffix names (reference save_a2c_model,
    utilities.py:286-296: A2C saves go to both the log directory and the
    pretrained-models directory, trainers.py:384,498)."""
    for path in [save_paths] if isinstance(save_paths, str) else save_paths:
        save_network("a2c", params, path)


def to_device(tree: dict, device) -> dict:
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# ---- full training-state snapshots (exact resume) ----

_TRAIN_STATE_VERSION = 1


def _paths(tree: dict, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def optimizer_state_tree(params: dict, optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer`` (a ``torch.optim.Adam`` over leaves of ``params``, as
    :func:`.optim.adam` builds it) as the state dict of optax's state for
    the same tree: ``{"0": {"count", "mu", "nu"}, "1": {}}`` for
    ``optax.adam``; where leaves are left out of the optimiser (frozen
    embeddings), ``multi_transform``'s tree with those leaves masked
    (``{}``). Adam's moments before its first step are zeros."""
    trained = {id(p) for group in optimizer.param_groups for p in group["params"]}
    counts = set()

    def moments(tree, name):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = moments(v, name)
            elif id(v) not in trained:
                out[k] = {}  # optax's MaskedNode
            else:
                st = optimizer.state.get(v, {})
                counts.add(int(st["step"]) if "step" in st else 0)
                out[k] = (st[name].detach().to("cpu", torch.float32).contiguous().numpy()
                          if name in st else np.zeros(tuple(v.shape), np.float32))
        return out

    adam_state = {"mu": moments(params, "exp_avg"), "nu": moments(params, "exp_avg_sq")}
    if len(counts) > 1:
        raise ValueError(f"the optimiser's leaves have taken different step counts {counts}: "
                         "optax's Adam state has one count")
    adam_state["count"] = np.asarray(counts.pop() if counts else 0, np.int32)
    inner = {"0": adam_state, "1": {}}
    if all(id(p) in trained for _, p in _paths(params)):
        return inner
    return {"inner_states": {"frozen": {"inner_state": {}}, "train": {"inner_state": inner}}}


def load_optimizer_state(opt_tree: dict, params: dict, optimizer: torch.optim.Optimizer) -> None:
    """Load optax's Adam state ``opt_tree`` (:func:`optimizer_state_tree`'s
    layout, either form) into ``optimizer`` over the leaves of ``params``:
    each trained leaf's ``exp_avg``/``exp_avg_sq`` from ``mu``/``nu`` and
    ``step`` from ``count`` (none before the first step)."""
    inner = (opt_tree["inner_states"]["train"]["inner_state"] if "inner_states" in opt_tree
             else opt_tree)
    adam_state = inner["0"]
    count = int(adam_state["count"])
    where = {id(p): path for path, p in _paths(params)}

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    state = {}
    order = [p for group in optimizer.param_groups for p in group["params"]]
    for i, p in enumerate(order):
        if count == 0:
            continue
        path = where[id(p)]
        mu, nu = at(adam_state["mu"], path), at(adam_state["nu"], path)
        if not isinstance(mu, np.ndarray) or tuple(mu.shape) != tuple(p.shape):
            raise ValueError(f"train-state Adam moment {'/'.join(path)!r} does not match the "
                             f"parameter's shape {tuple(p.shape)}")
        state[i] = {"step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": torch.from_numpy(np.array(mu, np.float32)),
                    "exp_avg_sq": torch.from_numpy(np.array(nu, np.float32))}
    optimizer.load_state_dict({"state": state,
                               "param_groups": optimizer.state_dict()["param_groups"]})


def save_train_state(path: str, params: dict, optimizer: torch.optim.Optimizer, key,
                     meta: dict) -> None:
    """Atomically snapshot the full training state in the JAX package's
    layout: the weights, Adam's state (:func:`optimizer_state_tree`), the
    host key (uint32 ``[2]``; the pretrainers hold none and pass zeros) and
    ``meta`` (JSON-serialisable; ``version`` and ``key_impl`` appended, as
    the JAX package appends them)."""
    if getattr(params, "vocab", None) is not None:
        raise ValueError("a training-state snapshot holds whole trees: a vocab-sharded tree's "
                         "blocks and their Adam moments are not gathered into one")
    meta = dict(meta, version=_TRAIN_STATE_VERSION, key_impl=None)
    payload = msgpack.OrderedMap([
        ("params", _numpy(params)),
        ("opt_state", optimizer_state_tree(params, optimizer)),
        ("key", np.asarray(key, np.uint32)),
        ("meta", json.dumps(meta)),
    ])
    data = msgpack.packb(payload)
    with atomic_write(path) as f:
        f.write(data)


def _check_state_shapes(template: dict, restored: dict) -> None:
    """The JAX package's architecture diagnosis when a snapshot's weights
    disagree with the run's config; a missing or extra leaf raises too."""
    want, got = dict(_paths(template)), dict(_paths(restored))
    for path in sorted(want.keys() | got.keys()):
        name = "/".join(path)
        if path not in got or path not in want:
            what = "missing" if path not in got else "not a leaf of this network"
            raise ValueError(f"train-state param {name!r} is {what} — the snapshot is of "
                             f"another network")
        ts, rs = tuple(want[path].shape), tuple(np.shape(got[path]))
        if ts != rs:
            raise ValueError(
                f"train-state param {name!r} has shape {rs}, but this run's architecture "
                f"expects {ts} — the snapshot was taken with different network dims (check "
                f"--input_dim/--wordvec_dim/--hidden_dim/--bidirectional and the vocabulary)")


def train_state_from_bytes(data: bytes, params_template: dict, meta_check=None) -> dict:
    """Parse a :func:`save_train_state` payload (either package's):
    ``{"params": tree of CPU tensors, "opt_state": optax's tree (numpy),
    "key": uint32 [2], "meta": dict}``. ``meta_check(meta)`` runs before
    the weights are checked against ``params_template``'s shapes, so a
    snapshot of another network raises the caller's diagnosis."""
    raw = msgpack.unpackb(data)
    meta = json.loads(raw["meta"])
    if meta.get("version") != _TRAIN_STATE_VERSION:
        raise ValueError(f"train-state version {meta.get('version')!r} is not the supported "
                         f"{_TRAIN_STATE_VERSION}")
    if meta_check is not None:
        meta_check(meta)
    _check_state_shapes(params_template, raw["params"])

    def to_torch(node):
        return ({k: to_torch(v) for k, v in node.items()} if isinstance(node, dict)
                else torch.from_numpy(np.array(node, np.float32)))

    return {"params": to_torch(raw["params"]), "opt_state": raw["opt_state"],
            "key": np.asarray(raw["key"], np.uint32), "meta": meta}


def load_train_state(path: str, params_template: dict, meta_check=None) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    return train_state_from_bytes(data, params_template, meta_check)


def restore_train_state(state: dict, params: dict, optimizer: torch.optim.Optimizer) -> None:
    """Copy a parsed snapshot's weights into ``params`` in place (on their
    device) and its Adam state into ``optimizer``."""
    with torch.no_grad():
        for (path, p), (_, q) in zip(_paths(params), _paths(state["params"])):
            p.copy_(q)
    load_optimizer_state(state["opt_state"], params, optimizer)
