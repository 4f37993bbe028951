"""Weight interchange: JAX parameter trees and reference ``.pt`` state dicts.

Counterpart of the JAX ``models/convert.py``. Layout facts:

  * torch ``nn.Linear`` stores ``weight [out, in]``; the port stores
    ``[in, out]``, so linear weights transpose.
  * torch ``nn.LSTM`` stores ``weight_ih_l0 [4H, in]`` / ``weight_hh_l0
    [4H, H]`` with gate order i,f,g,o, the port's order, so LSTM weights
    transpose too.
  * torch keeps two LSTM bias vectors; the port fuses them on load as
    ``b = b_ih + b_hh`` and exports ``(b_ih=b, b_hh=0)``, so a load of an
    export restores ``b`` bit for bit. The GRU keeps both (the candidate
    gate applies ``r`` between them), gate order r, z, n as torch's.

The reference a2c checkpoint carries both networks under
``value_network.*`` and ``policy_network.*``; the reward network's keys are
``rewrnn.caption_embedding.weight``, ``rewrnn.gru.*_l0``, ``visual_embed``
and ``semantic_embed``. These ``.pt`` files are one of the port's two
checkpoint formats; the other, native ``.ckpt``, is
:mod:`..train.checkpoint`'s msgpack tree.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def from_jax_params(tree) -> dict:
    """A JAX parameter tree whose leaves are numpy arrays (for example
    ``jax.tree.map(np.asarray, params)``) -> the same tree of float32
    torch tensors."""
    if isinstance(tree, Mapping):
        return {k: from_jax_params(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _t(x) -> torch.Tensor:
    """A state-dict value (tensor or ndarray) as a float32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(sd: Mapping, prefix: str) -> dict:
    return {"w": _t(sd[f"{prefix}.weight"]).T.contiguous(), "b": _t(sd[f"{prefix}.bias"])}


def _lstm(sd: Mapping, prefix: str) -> dict:
    return {
        "wi": _t(sd[f"{prefix}.weight_ih_l0"]).T.contiguous(),
        "wh": _t(sd[f"{prefix}.weight_hh_l0"]).T.contiguous(),
        "b": _t(sd[f"{prefix}.bias_ih_l0"]) + _t(sd[f"{prefix}.bias_hh_l0"]),
    }


def _gru(sd: Mapping, prefix: str) -> dict:
    return {
        "wi": _t(sd[f"{prefix}.weight_ih_l0"]).T.contiguous(),
        "wh": _t(sd[f"{prefix}.weight_hh_l0"]).T.contiguous(),
        "bi": _t(sd[f"{prefix}.bias_ih_l0"]),
        "bh": _t(sd[f"{prefix}.bias_hh_l0"]),
    }


def _check_unidirectional(sd: Mapping) -> None:
    if any(k.endswith("_reverse") for k in sd):
        raise NotImplementedError(
            "bidirectional checkpoints are not ported yet (ROADMAP §1 item 5)")


def _strip_prefix(sd: Mapping, prefix: str) -> dict:
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if not out:
        raise KeyError(f"no keys with prefix {prefix!r} in state dict")
    return out


def policy_from_state_dict(sd: Mapping) -> dict:
    _check_unidirectional(sd)
    return {
        "embedding": _t(sd["caption_embedding.weight"]),
        "cnn2linear": _linear(sd, "cnn2linear"),
        "head": _linear(sd, "linear2vocab"),
        "lstm": _lstm(sd, "lstm"),
    }


def value_from_state_dict(sd: Mapping) -> dict:
    _check_unidirectional(sd)
    return {
        "embedding": _t(sd["valrnn.caption_embedding.weight"]),
        "linear1": _linear(sd, "linear1"),
        "linear2": _linear(sd, "linear2"),
        "lstm": _lstm(sd, "valrnn.lstm"),
    }


def reward_from_state_dict(sd: Mapping) -> dict:
    _check_unidirectional(sd)
    return {
        "embedding": _t(sd["rewrnn.caption_embedding.weight"]),
        "visual_embed": _linear(sd, "visual_embed"),
        "semantic_embed": _linear(sd, "semantic_embed"),
        "gru": _gru(sd, "rewrnn.gru"),
    }


def a2c_from_state_dict(sd: Mapping) -> dict:
    return {
        "value": value_from_state_dict(_strip_prefix(sd, "value_network.")),
        "policy": policy_from_state_dict(_strip_prefix(sd, "policy_network.")),
    }


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", torch.float32)


def _linear_to(p: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _host(p["w"]).T.contiguous()
    out[f"{prefix}.bias"] = _host(p["b"]).clone()


def _lstm_to(p: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight_ih_l0"] = _host(p["wi"]).T.contiguous()
    out[f"{prefix}.weight_hh_l0"] = _host(p["wh"]).T.contiguous()
    out[f"{prefix}.bias_ih_l0"] = _host(p["b"]).clone()
    out[f"{prefix}.bias_hh_l0"] = torch.zeros_like(_host(p["b"]))


def _gru_to(p: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight_ih_l0"] = _host(p["wi"]).T.contiguous()
    out[f"{prefix}.weight_hh_l0"] = _host(p["wh"]).T.contiguous()
    out[f"{prefix}.bias_ih_l0"] = _host(p["bi"]).clone()
    out[f"{prefix}.bias_hh_l0"] = _host(p["bh"]).clone()


def policy_to_state_dict(params: Mapping) -> dict:
    sd = {"caption_embedding.weight": _host(params["embedding"]).clone()}
    _linear_to(params["cnn2linear"], "cnn2linear", sd)
    _linear_to(params["head"], "linear2vocab", sd)
    _lstm_to(params["lstm"], "lstm", sd)
    return sd


def value_to_state_dict(params: Mapping) -> dict:
    sd = {"valrnn.caption_embedding.weight": _host(params["embedding"]).clone()}
    _linear_to(params["linear1"], "linear1", sd)
    _linear_to(params["linear2"], "linear2", sd)
    _lstm_to(params["lstm"], "valrnn.lstm", sd)
    return sd


def reward_to_state_dict(params: Mapping) -> dict:
    sd = {"rewrnn.caption_embedding.weight": _host(params["embedding"]).clone()}
    _linear_to(params["visual_embed"], "visual_embed", sd)
    _linear_to(params["semantic_embed"], "semantic_embed", sd)
    _gru_to(params["gru"], "rewrnn.gru", sd)
    return sd


def a2c_to_state_dict(params: Mapping) -> dict:
    sd = {f"value_network.{k}": v for k, v in value_to_state_dict(params["value"]).items()}
    sd.update({f"policy_network.{k}": v
               for k, v in policy_to_state_dict(params["policy"]).items()})
    return sd


def load_state_dict(path: str) -> dict:
    """Read a reference ``.pt`` state dict (tensors only) onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


_FROM = {"policy": policy_from_state_dict, "value": value_from_state_dict,
         "reward": reward_from_state_dict, "a2c": a2c_from_state_dict}
_TO = {"policy": policy_to_state_dict, "value": value_to_state_dict,
       "reward": reward_to_state_dict, "a2c": a2c_to_state_dict}


def _converter(table: dict, kind: str):
    if kind not in table:
        raise ValueError(f"unknown network kind {kind!r} (expected one of {sorted(table)})")
    return table[kind]


def network_from_state_dict(kind: str, sd: Mapping) -> dict:
    """A reference state dict of ``kind`` (policy, value, reward or a2c)
    -> the port's parameter tree (float32, CPU)."""
    return _converter(_FROM, kind)(sd)


def network_to_state_dict(kind: str, params: Mapping) -> dict:
    """The port's parameter tree of ``kind`` -> a reference state dict of
    float32 CPU tensors (``torch.save`` writes it as the reference does)."""
    return _converter(_TO, kind)(params)
