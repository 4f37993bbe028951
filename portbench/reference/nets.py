"""The plain reference: the three networks of the paper's system in float32
PyTorch (TF32 off), written from the reference models (pratikpv
``models.py``: ``nn.Embedding``, ``nn.LSTM``, ``nn.GRU``, the value MLP)
in the parameter layout of the program (input-major ``w [in, out]``, LSTM
``wi [E, 4H]``, ``wh [H, 4H]`` and one fused bias ``b [4H]`` in gate order
i, f, g, o; GRU ``wi``, ``wh`` ``[., 3H]`` with ``bi``, ``bh`` in gate
order r, z, n).

It imports neither JAX nor the program. Every product goes through
:class:`Prec`, whose ``rnd`` rounds both operands: the identity for the
reference, a scaled float8 (e4m3) rounding for the control that stands in
for a program computing one precision below its configuration's bf16.
"""

from __future__ import annotations

import math

import torch


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Prec:
    """Operand rounding of every product: ``None`` (float32) or
    ``"fp8"`` (float8 e4m3 with one power-of-two scale a tensor, the
    nearest precision below the configuration's bf16)."""

    def __init__(self, kind: str | None = None):
        if kind not in (None, "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def rnd(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind is None:
            return x
        amax = x.detach().abs().max().clamp_min(1e-30)
        scale = torch.exp2(torch.floor(torch.log2(448.0 / amax)))
        q = (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
        return x + (q - x).detach()  # rounded forward, straight-through backward

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.rnd(a), self.rnd(b))


F32 = Prec()


def dense(x, layer, prec: Prec = F32):
    return prec.mm(x, layer["w"]) + layer["b"]


def lstm_cell(p, x, state, prec: Prec = F32):
    h, c = state
    gates = prec.mm(torch.cat([x, h], dim=-1), torch.cat([p["wi"], p["wh"]], dim=0)) + p["b"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def gru_cell(p, x, h, prec: Prec = F32):
    gi = prec.mm(x, p["wi"]) + p["bi"]
    gh = prec.mm(h, p["wh"]) + p["bh"]
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def cosine(a, b, eps: float = 1e-12):
    def unit(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)
    return torch.sum(unit(a) * unit(b), dim=-1)


# --------------------------------------------------------------------------
# the leaves of each network: (path, shape, kind, scale) for the benchmark's
# own weights (torch's default initialisers' distributions)
# --------------------------------------------------------------------------

def _lstm(prefix, e, h):
    k = 1.0 / math.sqrt(h)
    return [(prefix + ("wi",), (e, 4 * h), "uniform", k),
            (prefix + ("wh",), (h, 4 * h), "uniform", k),
            (prefix + ("b",), (4 * h,), "uniform", 2 * k)]


def _linear(prefix, fan_in, fan_out):
    k = 1.0 / math.sqrt(fan_in)
    return [(prefix + ("w",), (fan_in, fan_out), "uniform", k),
            (prefix + ("b",), (fan_out,), "uniform", k)]


def policy_leaves(cfg: dict, prefix=()):
    v, e, h, f = cfg["vocab_size"], cfg["wordvec_dim"], cfg["hidden_dim"], cfg["input_dim"]
    return ([(prefix + ("embedding",), (v, e), "normal", 1.0)]
            + _linear(prefix + ("cnn2linear",), f, h) + _linear(prefix + ("head",), h, v)
            + _lstm(prefix + ("lstm",), e, h))


def value_leaves(cfg: dict, prefix=()):
    v, e, h, f = cfg["vocab_size"], cfg["wordvec_dim"], cfg["hidden_dim"], cfg["input_dim"]
    return ([(prefix + ("embedding",), (v, e), "normal", 1.0)] + _lstm(prefix + ("lstm",), e, h)
            + _linear(prefix + ("linear1",), f + h, h) + _linear(prefix + ("linear2",), h, 1))


def reward_leaves(cfg: dict, prefix=()):
    v, e, h, f = cfg["vocab_size"], cfg["wordvec_dim"], cfg["hidden_dim"], cfg["input_dim"]
    k = 1.0 / math.sqrt(h)
    return ([(prefix + ("embedding",), (v, e), "normal", 1.0),
             (prefix + ("gru", "wi"), (e, 3 * h), "uniform", k),
             (prefix + ("gru", "wh"), (h, 3 * h), "uniform", k),
             (prefix + ("gru", "bi"), (3 * h,), "uniform", k),
             (prefix + ("gru", "bh"), (3 * h,), "uniform", k)]
            + _linear(prefix + ("visual_embed",), f, h)
            + _linear(prefix + ("semantic_embed",), h, h))


def build_tree(leaves, tensors) -> dict:
    """The nested dict of ``tensors``, one per entry of ``leaves``."""
    tree: dict = {}
    for (path, *_), t in zip(leaves, tensors):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def flat(tree: dict, path=()):
    """``{path: leaf}`` of a nested dict, paths in sorted order."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(flat(tree[k], path + (k,)))
        else:
            out[path + (k,)] = tree[k]
    return out


def torch_default_policy(gen: torch.Generator, cfg: dict, embeddings) -> dict:
    """The policy a trainer initialises from ``gen`` (a CPU generator):
    torch's default initialisers drawn in the order of the reference
    model's construction (the table is the pretrained vectors, no draw;
    ``cnn2linear``, ``head``, then the LSTM with its two biases summed)."""
    f, h, v = cfg["input_dim"], cfg["hidden_dim"], cfg["vocab_size"]
    e = embeddings.shape[1]

    def u(shape, k):
        return torch.empty(shape, dtype=torch.float32).uniform_(-k, k, generator=gen)

    def linear(fan_in, fan_out):
        k = 1.0 / math.sqrt(fan_in)
        return {"w": u((fan_in, fan_out), k), "b": u((fan_out,), k)}

    params = {"embedding": torch.as_tensor(embeddings, dtype=torch.float32).clone(),
              "cnn2linear": linear(f, h), "head": linear(h, v)}
    k = 1.0 / math.sqrt(h)
    params["lstm"] = {"wi": u((e, 4 * h), k), "wh": u((h, 4 * h), k)}
    params["lstm"]["b"] = u((4 * h,), k) + u((4 * h,), k)
    return params
