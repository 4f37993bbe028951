"""Device meshes and the process group (counterpart of the JAX
``parallel/mesh.py``).

A :class:`Mesh` is an array of ``torch.device`` entries with a shape and
axis names, the port's ``jax.sharding.Mesh``. In a distributed world (one
process per card, launched by ``torchrun``) the mesh spans the ranks, one
device each, and :attr:`Mesh.ranks` names the rank that owns each entry.
In one process it lists local devices, repeats allowed: the CPU is one
torch device, so ``make_mesh(devices=["cpu"] * 8)`` stands in for the JAX
package's eight virtual CPU devices, and ``[cuda:0, cuda:0]`` splits a
batch over one card.

A 2-D ``("data", "model")`` mesh of shape ``(D, M)`` lays the entries out
in rank order, row-major, as the JAX mesh reshapes its process-major
devices: rank ``r`` sits at ``(r // M, r % M)``. Each data row of ``M``
ranks is one ``model`` group, each model column of ``D`` ranks one
``data`` group (:meth:`Mesh.group`): rows of a batch split over ``data``,
the vocabulary over ``model`` (:mod:`.tensor_parallel`).

The process group: NCCL for CUDA tensors, gloo for CPU tensors. Each rank
of a world owns the card ``cuda:LOCAL_RANK`` (``--device cuda``). Ranks
share one card only on purpose, a check's set-up rather than a way to
train: with ``ICRL_SHARE_CARD=1`` every rank that names the card's index
(``cuda:0``) runs on it and the group is gloo carrying CUDA tensors (NCCL
refuses two ranks on one device). Without that variable, a world of more
than one rank that names a card's index raises.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
_ENV_SHARE_CARD = "ICRL_SHARE_CARD"


def local_device_count() -> int:
    """The cards this process sees (1 for the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def world() -> Tuple[int, int]:
    """``(rank, world_size)`` of the process group, ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    """True on the rank that writes files (rank 0), and without a process
    group."""
    return world()[0] == 0


def _share_card() -> bool:
    return os.environ.get(_ENV_SHARE_CARD, "0") == "1"


def rank_device(device="cuda") -> torch.device:
    """This process's device: ``cuda`` is ``cuda:LOCAL_RANK`` (0 without
    torchrun); ``cpu`` is the CPU. An explicit index is kept in a world of
    one, and in a larger one only with ``ICRL_SHARE_CARD=1`` (every rank
    would run on that card): else ``ValueError``. A missing CUDA device
    raises (no rank carries on on the CPU)."""
    from ..api import resolve_device  # api imports the decodes: resolve at call time

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    elif dev.type == "cuda" and int(os.environ.get("WORLD_SIZE", "1")) > 1 and not _share_card():
        raise ValueError(f"--device {device} in a world of {os.environ['WORLD_SIZE']} ranks "
                         f"would run every rank on that card: pass --device cuda (each rank "
                         f"its cuda:LOCAL_RANK), or set {_ENV_SHARE_CARD}=1 to share the card "
                         f"on purpose (gloo)")
    return resolve_device(dev)


def backend_for(device="cuda") -> str:
    """gloo for the CPU and for a named card that the ranks share on purpose
    (``ICRL_SHARE_CARD=1``), NCCL for every other card."""
    dev = torch.device(device)
    if dev.type != "cuda" or (dev.index is not None and _share_card()):
        return "gloo"
    return "nccl"


def maybe_init_distributed(device="cuda") -> bool:
    """Join the job that torchrun's variables announce (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), on the
    backend :func:`backend_for` ``device`` names. No variable: a no-op
    returning False. Some but not all: ``RuntimeError`` naming the missing
    ones (peers would otherwise wait forever). All: ``init_process_group``
    (once), and the return is ``world_size > 1``."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    present = [k for k in _ENV if os.environ.get(k)]
    if not present:
        return False
    if len(present) < len(_ENV):
        missing = sorted(set(_ENV) - set(present))
        raise RuntimeError(f"the distributed launch environment is incomplete: {present} set but "
                           f"{missing} missing — export all five (torchrun does) or none")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    size = int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        backend_for(device),
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        world_size=size, rank=int(os.environ["RANK"]))
    return size > 1


class Mesh:
    """Devices in an array with named axes. ``shape`` maps each axis name
    to its size (``mesh.shape["data"]``), as the JAX mesh's does.
    ``ranks``: the owning rank of each entry in a distributed world, None
    for a single-process mesh."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None, groups=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = ranks
        self.shape = dict(zip(self.axis_names, devices.shape))
        self._groups = groups or {}

    @property
    def coords(self) -> Optional[dict]:
        """This rank's position on each axis (``{"data": d, "model": m}``)
        in a distributed world; None on one process's mesh."""
        if self.ranks is None:
            return None
        where = np.argwhere(self.ranks == world()[0])
        if len(where) != 1:
            raise ValueError("a distributed mesh holds one entry a rank")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def group(self, axis: str):
        """The process group of this rank's ``axis``: the ranks that share
        its position on every other axis. The whole world's group for an
        axis that spans it; None without a process group (one process's
        mesh, or a world of one), where every collective is the identity."""
        if self.ranks is None or world()[1] == 1:
            return None
        if axis not in self.shape:
            raise ValueError(f"{self} has no '{axis}' axis")
        return self._groups.get(axis, dist.group.WORLD)

    def entries(self, axis: str) -> list:
        """One process's entries along ``axis`` (index 0 on every other
        axis): the devices a batch splits over when ``axis`` is ``data``.
        An absent axis is one entry, the first."""
        if axis not in self.shape:
            return [self.devices.flat[0]]
        i = self.axis_names.index(axis)
        index = tuple(slice(None) if a == i else 0 for a in range(self.devices.ndim))
        return list(self.devices[index])

    @property
    def spans_processes(self) -> bool:
        """True when entries belong to other ranks."""
        return self.ranks is not None and world()[1] > 1

    @property
    def local_devices(self) -> list:
        """This process's entries, in mesh order (repeats kept)."""
        flat = list(self.devices.flat)
        if self.ranks is None:
            return flat
        rank = world()[0]
        return [d for d, r in zip(flat, self.ranks.flat) if r == rank]

    @property
    def first_device(self) -> torch.device:
        return self.local_devices[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(shape: Optional[Tuple[int, ...]] = None, axis_names: Sequence[str] = ("data",),
              devices=None, device="cuda") -> Mesh:
    """A mesh over ``devices`` (any torch devices, repeats allowed; one
    process), or, with ``devices=None``, over the job: one entry a rank
    (each rank's :func:`rank_device` of ``device``) in a distributed world,
    else this process's cards (the CPU without one when ``device`` is
    ``cpu``). ``shape`` defaults to 1-D over every entry; it must cover
    them and match ``axis_names`` in rank. In a world the entries follow
    the ranks row-major (rank ``r`` of a ``(D, M)`` mesh at ``(r // M, r %
    M)``), and every rank creates every axis group here, in one order, as
    ``torch.distributed.new_group`` requires: the groups of an axis that
    does not span the world."""
    ranks = None
    if devices is None:
        rank, size = world()
        if dist.is_available() and dist.is_initialized():
            mine = str(rank_device(device))
            names = [None] * size
            dist.all_gather_object(names, mine)
            devices = [torch.device(n) for n in names]
            ranks = np.arange(size)
        elif torch.device(device).type == "cuda":
            rank_device(device)  # raises without a card
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device(device)]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices),)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {shape} does not cover {len(devices)} devices")
    if len(shape) != len(axis_names):
        raise ValueError("shape and axis_names must have the same rank")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    ranks = None if ranks is None else ranks.reshape(shape)
    return Mesh(arr.reshape(shape), axis_names, ranks,
                None if ranks is None else _axis_groups(ranks, tuple(axis_names)))


def _axis_groups(ranks: np.ndarray, axis_names: tuple) -> dict:
    """This rank's process group of each axis that does not span the world
    (a world-wide axis takes the default group). Every rank makes every
    group, axis by axis, in the order of the other axes' positions."""
    rank, size = world()
    groups = {}
    for i, axis in enumerate(axis_names):
        if ranks.shape[i] == size:
            continue
        lines = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    return groups
