"""Checkpoint persistence (counterpart of the JAX ``train/checkpoint.py``).

The port writes and reads the reference's own format: one ``torch.save``d
state dict per network, in the reference layout
(:mod:`..models.convert`), written atomically. The JAX package's
``load_network`` reads these ``.pt`` files directly. Native msgpack
``.ckpt`` files, ``.trainstate`` snapshots and Orbax are not ported yet:
a path without the ``.pt`` suffix raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ..api import resolve_device
from ..models.convert import load_state_dict, network_from_state_dict, network_to_state_dict
from ..utils.io import atomic_write


def check_pt_path(path: str) -> None:
    if not str(path).endswith(".pt"):
        raise NotImplementedError(
            f"{path}: the port reads and writes reference .pt checkpoints only; native "
            f".ckpt files are not ported yet (ROADMAP §1)")


def save_network_pt(kind: str, params: dict, path: str) -> None:
    """``params`` of ``kind`` (policy, value, reward or a2c) as a
    reference-layout ``.pt`` state dict, published atomically."""
    check_pt_path(path)
    sd = network_to_state_dict(kind, params)
    with atomic_write(path) as f:
        torch.save(sd, f)


def save_to_paths(params: dict, save_paths) -> None:
    """The a2c ``{"policy", "value"}`` parameters to one ``.pt`` path or a
    list of them (reference save_a2c_model, utilities.py:286-296: A2C saves
    go to both the log directory and the pretrained-models directory,
    trainers.py:384,498), each published atomically."""
    for path in [save_paths] if isinstance(save_paths, str) else save_paths:
        save_network_pt("a2c", params, path)


def load_network(kind: str, path: str, device="cuda") -> dict:
    """A reference-layout ``.pt`` checkpoint of ``kind`` -> the port's
    parameter tree (float32, on ``device``: the card unless the caller asks
    for ``"cpu"``; a missing CUDA device raises)."""
    check_pt_path(path)
    device = resolve_device(device)
    params = network_from_state_dict(kind, load_state_dict(path))
    return to_device(params, device)


def to_device(tree: dict, device) -> dict:
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
