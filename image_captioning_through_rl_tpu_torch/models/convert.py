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
and ``semantic_embed``. A bidirectional network's backward direction is
torch's ``*_l0_reverse`` keys (the port's ``lstm_bwd`` / ``gru_bwd``), the
forward its ``*_l0`` keys (``lstm_fwd`` / ``gru_fwd``), and the critic adds
``rnn_linear``; every converter takes ``bidirectional``, and a state dict
whose ``_reverse`` keys disagree with it raises. These ``.pt`` files are one
of the port's two checkpoint formats; the other, native ``.ckpt``, is
:mod:`..train.checkpoint`'s msgpack tree.
"""

from __future__ import annotations

import math
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


def _lstm(sd: Mapping, prefix: str, reverse: bool = False) -> dict:
    sfx = "_reverse" if reverse else ""
    return {
        "wi": _t(sd[f"{prefix}.weight_ih_l0{sfx}"]).T.contiguous(),
        "wh": _t(sd[f"{prefix}.weight_hh_l0{sfx}"]).T.contiguous(),
        "b": _t(sd[f"{prefix}.bias_ih_l0{sfx}"]) + _t(sd[f"{prefix}.bias_hh_l0{sfx}"]),
    }


def _gru(sd: Mapping, prefix: str, reverse: bool = False) -> dict:
    sfx = "_reverse" if reverse else ""
    return {
        "wi": _t(sd[f"{prefix}.weight_ih_l0{sfx}"]).T.contiguous(),
        "wh": _t(sd[f"{prefix}.weight_hh_l0{sfx}"]).T.contiguous(),
        "bi": _t(sd[f"{prefix}.bias_ih_l0{sfx}"]),
        "bh": _t(sd[f"{prefix}.bias_hh_l0{sfx}"]),
    }


def _check_directions(sd: Mapping, bidirectional: bool) -> None:
    """A state dict's ``_reverse`` keys must agree with ``bidirectional``
    (the JAX converters would drop them, or fail on a missing key)."""
    reverse = any(k.endswith("_reverse") for k in sd)
    if reverse and not bidirectional:
        raise ValueError("a bidirectional checkpoint: load it with bidirectional=True "
                         "(--bidirectional)")
    if bidirectional and not reverse:
        raise ValueError("bidirectional=True, but the checkpoint has no _reverse weights")


def _strip_prefix(sd: Mapping, prefix: str) -> dict:
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if not out:
        raise KeyError(f"no keys with prefix {prefix!r} in state dict")
    return out


def _rnn_pair(read, sd: Mapping, prefix: str, name: str, bidirectional: bool) -> dict:
    """``{name: ...}`` or ``{name_fwd: ..., name_bwd: ...}`` from torch's
    ``*_l0`` / ``*_l0_reverse`` keys."""
    if bidirectional:
        return {f"{name}_fwd": read(sd, prefix), f"{name}_bwd": read(sd, prefix, reverse=True)}
    return {name: read(sd, prefix)}


def policy_from_state_dict(sd: Mapping, bidirectional: bool = False) -> dict:
    _check_directions(sd, bidirectional)
    return {
        "embedding": _t(sd["caption_embedding.weight"]),
        "cnn2linear": _linear(sd, "cnn2linear"),
        "head": _linear(sd, "linear2vocab"),
        **_rnn_pair(_lstm, sd, "lstm", "lstm", bidirectional),
    }


def value_from_state_dict(sd: Mapping, bidirectional: bool = False) -> dict:
    _check_directions(sd, bidirectional)
    params = {
        "embedding": _t(sd["valrnn.caption_embedding.weight"]),
        "linear1": _linear(sd, "linear1"),
        "linear2": _linear(sd, "linear2"),
        **_rnn_pair(_lstm, sd, "valrnn.lstm", "lstm", bidirectional),
    }
    if bidirectional:
        params["rnn_linear"] = _linear(sd, "rnn_linear")
    return params


def reward_from_state_dict(sd: Mapping, bidirectional: bool = False) -> dict:
    _check_directions(sd, bidirectional)
    return {
        "embedding": _t(sd["rewrnn.caption_embedding.weight"]),
        "visual_embed": _linear(sd, "visual_embed"),
        "semantic_embed": _linear(sd, "semantic_embed"),
        **_rnn_pair(_gru, sd, "rewrnn.gru", "gru", bidirectional),
    }


def a2c_from_state_dict(sd: Mapping, bidirectional: bool = False) -> dict:
    return {
        "value": value_from_state_dict(_strip_prefix(sd, "value_network."), bidirectional),
        "policy": policy_from_state_dict(_strip_prefix(sd, "policy_network."), bidirectional),
    }


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", torch.float32)


def _linear_to(p: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _host(p["w"]).T.contiguous()
    out[f"{prefix}.bias"] = _host(p["b"]).clone()


def _lstm_to(p: Mapping, prefix: str, out: dict, reverse: bool = False) -> None:
    sfx = "_reverse" if reverse else ""
    out[f"{prefix}.weight_ih_l0{sfx}"] = _host(p["wi"]).T.contiguous()
    out[f"{prefix}.weight_hh_l0{sfx}"] = _host(p["wh"]).T.contiguous()
    out[f"{prefix}.bias_ih_l0{sfx}"] = _host(p["b"]).clone()
    out[f"{prefix}.bias_hh_l0{sfx}"] = torch.zeros_like(_host(p["b"]))


def _gru_to(p: Mapping, prefix: str, out: dict, reverse: bool = False) -> None:
    sfx = "_reverse" if reverse else ""
    out[f"{prefix}.weight_ih_l0{sfx}"] = _host(p["wi"]).T.contiguous()
    out[f"{prefix}.weight_hh_l0{sfx}"] = _host(p["wh"]).T.contiguous()
    out[f"{prefix}.bias_ih_l0{sfx}"] = _host(p["bi"]).clone()
    out[f"{prefix}.bias_hh_l0{sfx}"] = _host(p["bh"]).clone()


def _rnn_pair_to(write, params: Mapping, name: str, prefix: str, out: dict,
                 bidirectional: bool) -> None:
    if bidirectional:
        write(params[f"{name}_fwd"], prefix, out)
        write(params[f"{name}_bwd"], prefix, out, reverse=True)
    else:
        write(params[name], prefix, out)


def policy_to_state_dict(params: Mapping, bidirectional: bool = False) -> dict:
    sd = {"caption_embedding.weight": _host(params["embedding"]).clone()}
    _linear_to(params["cnn2linear"], "cnn2linear", sd)
    _linear_to(params["head"], "linear2vocab", sd)
    _rnn_pair_to(_lstm_to, params, "lstm", "lstm", sd, bidirectional)
    return sd


def value_to_state_dict(params: Mapping, bidirectional: bool = False) -> dict:
    sd = {"valrnn.caption_embedding.weight": _host(params["embedding"]).clone()}
    _linear_to(params["linear1"], "linear1", sd)
    _linear_to(params["linear2"], "linear2", sd)
    _rnn_pair_to(_lstm_to, params, "lstm", "valrnn.lstm", sd, bidirectional)
    if bidirectional:
        _linear_to(params["rnn_linear"], "rnn_linear", sd)
    return sd


def reward_to_state_dict(params: Mapping, bidirectional: bool = False) -> dict:
    sd = {"rewrnn.caption_embedding.weight": _host(params["embedding"]).clone()}
    _linear_to(params["visual_embed"], "visual_embed", sd)
    _linear_to(params["semantic_embed"], "semantic_embed", sd)
    _rnn_pair_to(_gru_to, params, "gru", "rewrnn.gru", sd, bidirectional)
    return sd


def a2c_to_state_dict(params: Mapping, bidirectional: bool = False) -> dict:
    sd = {f"value_network.{k}": v
          for k, v in value_to_state_dict(params["value"], bidirectional).items()}
    sd.update({f"policy_network.{k}": v
               for k, v in policy_to_state_dict(params["policy"], bidirectional).items()})
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


def network_from_state_dict(kind: str, sd: Mapping, bidirectional: bool = False) -> dict:
    """A reference state dict of ``kind`` (policy, value, reward or a2c)
    -> the port's parameter tree (float32, CPU)."""
    return _converter(_FROM, kind)(sd, bidirectional)


def network_to_state_dict(kind: str, params: Mapping, bidirectional: bool = False) -> dict:
    """The port's parameter tree of ``kind`` -> a reference state dict of
    float32 CPU tensors (``torch.save`` writes it as the reference does)."""
    return _converter(_TO, kind)(params, bidirectional)


# ---- VGG16 (the visual front end, models/vgg.py) ----

_VGG_FCS = (("fc6", 0), ("fc7", 3))


def _vgg_check(sd: Mapping, source: str) -> None:
    from .vgg import CONV_IDXS

    want = {f"features.{i}.{p}" for i in CONV_IDXS for p in ("weight", "bias")}
    want |= {f"classifier.{i}.{p}" for _, i in _VGG_FCS for p in ("weight", "bias")}
    missing = sorted(want - set(sd))
    if missing:
        raise ValueError(f"{source}: not a VGG16 state dict (missing {missing[:4]}"
                         f"{' ...' if len(missing) > 4 else ''})")


def vgg_from_state_dict(sd: Mapping, device=None):
    """A torchvision-layout VGG16 state dict (``features.{i}.*`` OIHW for
    the 13 convolutions, ``classifier.{0,3}.*`` for fc6 and fc7) -> a
    :class:`.vgg.VGG16` in float32 on ``device``; fc8 (``classifier.6``)
    and any other key are dropped, as the JAX ``vgg_from_torch`` drops
    them."""
    from .vgg import VGG16

    _vgg_check(sd, "vgg_from_state_dict")
    model = VGG16(device=device)
    keep = set(model.state_dict())
    model.load_state_dict({k: _t(v) for k, v in sd.items() if k in keep}, strict=True)
    return model


def vgg_from_jax(tree: Mapping, device=None):
    """The JAX VGG16 tree (``conv{k}: {w HWIO, b}``, ``fc6``/``fc7: {w [in,
    out], b}``; :func:`from_jax_params` of its numpy leaves, or a ``.ckpt``'s
    tree) -> a :class:`.vgg.VGG16`: convolutions HWIO -> OIHW, linear
    weights transposed. fc6 reads the NCHW flatten in both packages, so its
    rows keep their order."""
    from .vgg import CONV_IDXS

    sd = {}
    for k, i in enumerate(CONV_IDXS):
        sd[f"features.{i}.weight"] = _t(tree[f"conv{k}"]["w"]).permute(3, 2, 0, 1).contiguous()
        sd[f"features.{i}.bias"] = _t(tree[f"conv{k}"]["b"])
    for name, i in _VGG_FCS:
        sd[f"classifier.{i}.weight"] = _t(tree[name]["w"]).T.contiguous()
        sd[f"classifier.{i}.bias"] = _t(tree[name]["b"])
    return vgg_from_state_dict(sd, device)


def vgg_to_jax(model) -> dict:
    """A :class:`.vgg.VGG16` -> the JAX VGG16 tree (float32 CPU tensors):
    the inverse of :func:`vgg_from_jax`, as a ``.ckpt`` stores it."""
    from .vgg import CONV_IDXS

    sd = model.state_dict()
    tree = {f"conv{k}": {"w": _host(sd[f"features.{i}.weight"]).permute(2, 3, 1, 0).contiguous(),
                         "b": _host(sd[f"features.{i}.bias"])}
            for k, i in enumerate(CONV_IDXS)}
    for name, i in _VGG_FCS:
        tree[name] = {"w": _host(sd[f"classifier.{i}.weight"]).T.contiguous(),
                      "b": _host(sd[f"classifier.{i}.bias"])}
    return tree


def save_vgg_ckpt(model, path: str) -> None:
    """A VGG16 as a native ``.ckpt``: the bytes the JAX package's
    ``save_pytree`` writes for the same weights."""
    from ..train.checkpoint import save_pytree

    save_pytree(vgg_to_jax(model), path)


def load_vgg_ckpt(path: str, device=None):
    """A native VGG16 ``.ckpt`` (the JAX package's ``save_pytree`` or
    :func:`save_vgg_ckpt`) -> a :class:`.vgg.VGG16` on ``device``."""
    from ..train.checkpoint import load_pytree

    tree = load_pytree(path)
    if not all(f"conv{k}" in tree for k in range(13)) or "fc6" not in tree or "fc7" not in tree:
        raise ValueError(f"{path}: not a VGG16 checkpoint (keys {sorted(tree)[:6]} ...)")
    return vgg_from_jax(tree, device)


# ---- CLIP's ViT image tower (models/vit.py) ----

_HF_VISION = "vision_model."
# (transformers' name under encoder.layers.{i}., the port's under
# transformer.resblocks.{i}.), for the keys that carry over as they are
_HF_BLOCK = (("layer_norm1", "ln_1"), ("self_attn.out_proj", "attn.out_proj"),
             ("layer_norm2", "ln_2"), ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj"))
_HF_TOP = (("embeddings.patch_embedding.weight", "conv1.weight"),
           ("embeddings.class_embedding", "class_embedding"),
           ("embeddings.position_embedding.weight", "positional_embedding"),
           ("pre_layrnorm.weight", "ln_pre.weight"), ("pre_layrnorm.bias", "ln_pre.bias"),
           ("post_layernorm.weight", "ln_post.weight"), ("post_layernorm.bias", "ln_post.bias"))


def clip_vision_from_state_dict(sd: Mapping, heads: int | None = None, device=None):
    """A ``transformers`` ``CLIPVisionModelWithProjection`` (or ``CLIPModel``)
    state dict -> a :class:`.vit.VisionTransformer` in float32 on
    ``device``. The layout: ``vision_model.embeddings.{patch_embedding.weight
    [W, 3, P, P], class_embedding [W], position_embedding.weight [T, W]}``,
    ``vision_model.pre_layrnorm.*`` (sic), per layer
    ``vision_model.encoder.layers.{i}.{layer_norm1, self_attn.{q,k,v,out}_proj,
    layer_norm2, mlp.fc1, mlp.fc2}.*``, ``vision_model.post_layernorm.*`` and
    ``visual_projection.weight [out, W]``. q, k and v are fused into one
    in-projection (rows q, k, v), the projection is transposed, any other
    key (the text tower, ``position_ids``) is dropped. The sizes come from
    the shapes; ``heads`` (not in a state dict) defaults to ``W / 64``, as
    in every CLIP tower."""
    from .vit import VisionTransformer

    def get(key):
        if key not in sd:
            raise ValueError(f"clip_vision_from_state_dict: not a CLIP vision state dict "
                             f"(missing {key!r})")
        return _t(sd[key])

    patch = get(_HF_VISION + "embeddings.patch_embedding.weight")
    pos = get(_HF_VISION + "embeddings.position_embedding.weight")
    proj = get("visual_projection.weight")
    layers = 0
    while f"{_HF_VISION}encoder.layers.{layers}.layer_norm1.weight" in sd:
        layers += 1
    width, p = patch.shape[0], patch.shape[-1]
    grid = math.isqrt(pos.shape[0] - 1)
    hidden = get(f"{_HF_VISION}encoder.layers.0.mlp.fc1.weight").shape[0]
    model = VisionTransformer(image_size=grid * p, patch=p, width=width, layers=layers,
                              heads=heads, mlp=hidden, output_dim=proj.shape[0], device=device)
    out = {mine: get(_HF_VISION + theirs) for theirs, mine in _HF_TOP}
    out["proj"] = proj.T.contiguous()
    for i in range(layers):
        src, dst = f"{_HF_VISION}encoder.layers.{i}.", f"transformer.resblocks.{i}."
        for part in ("weight", "bias"):
            out[f"{dst}attn.in_proj_{part}"] = torch.cat(
                [get(f"{src}self_attn.{c}_proj.{part}") for c in "qkv"])
            for theirs, mine in _HF_BLOCK:
                out[f"{dst}{mine}.{part}"] = get(f"{src}{theirs}.{part}")
    model.load_state_dict(out, strict=True)
    return model


def clip_vision_to_state_dict(model) -> dict:
    """A :class:`.vit.VisionTransformer` -> the ``transformers`` layout that
    :func:`clip_vision_from_state_dict` reads (float32 CPU tensors; no
    ``position_ids``)."""
    sd = {k: _host(v) for k, v in model.state_dict().items()}
    out = {_HF_VISION + theirs: sd[mine] for theirs, mine in _HF_TOP}
    out["visual_projection.weight"] = sd["proj"].T.contiguous()
    w = model.width
    for i in range(len(model.transformer.resblocks)):
        src, dst = f"transformer.resblocks.{i}.", f"{_HF_VISION}encoder.layers.{i}."
        for part in ("weight", "bias"):
            fused = sd[f"{src}attn.in_proj_{part}"]
            for k, c in enumerate("qkv"):
                out[f"{dst}self_attn.{c}_proj.{part}"] = fused[k * w:(k + 1) * w].clone()
            for theirs, mine in _HF_BLOCK:
                out[f"{dst}{theirs}.{part}"] = sd[f"{src}{mine}.{part}"]
    return out
