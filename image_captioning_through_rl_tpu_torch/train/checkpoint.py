"""Checkpoint persistence (counterpart of the JAX ``train/checkpoint.py``).

A network's file format follows its path's suffix, as in the JAX package:

  * ``.pt``: the reference's own format, one ``torch.save``d state dict in
    the reference layout (:mod:`..models.convert`);
  * anything else (the CLI names them ``*.ckpt``): the native format, flax's
    msgpack of the parameter tree (:mod:`..utils.msgpack`). For the same
    tree the bytes equal the JAX package's ``save_pytree``, and its
    ``load_network(kind, path, template=...)`` reads them.

Every write is published atomically. :func:`load_network` checks the tree's
keys against the network kind's and, given a config, every shape: the JAX
package's ``from_bytes`` copies without a shape check; the port raises,
naming the file and the first leaf that differs. A network's direction
is its tree's: a ``.pt`` with ``_reverse`` keys or a tree whose cells are
``*_fwd`` / ``*_bwd`` pairs is bidirectional, and a given ``cfg`` must
agree with it. ``.trainstate`` snapshots and Orbax are not ported (ROADMAP
§1 item 7).
"""

from __future__ import annotations

import dataclasses
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


def save_pytree(params: dict, path: str) -> None:
    """``params`` (a tree of tensors) as a native msgpack checkpoint,
    float32, published atomically."""
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
