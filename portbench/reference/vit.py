"""The plain reference of CLIP's image tower at ViT-L/14@336px (Radford et
al., "Learning Transferable Visual Models From Natural Language
Supervision", arXiv:2103.00020; ``openai/clip-vit-large-patch14-336``'s
``vision_config``: image 336, patch 14, hidden 1024, MLP 4096, 24 layers,
16 heads, ``quick_gelu``, LayerNorm eps 1e-5, projection 768), and the PCA
projection after it, in float32 PyTorch (TF32 off), computed in blocks of
:data:`BLOCK` images.

- The weights: a dict in ``transformers``' ``CLIPVisionModelWithProjection``
  layout (``vision_model.embeddings.*``, ``vision_model.pre_layrnorm``,
  ``vision_model.encoder.layers.{i}.{layer_norm1, self_attn.{q,k,v,out}_proj,
  layer_norm2, mlp.fc1, mlp.fc2}``, ``vision_model.post_layernorm``,
  ``visual_projection``), drawn by :func:`draw_weights`.
- The preprocessing, written here: uint8 RGB ``[N, 336, 336, 3]`` over 255,
  less CLIP's mean, over its std, then NCHW.
- The tower: the patch embedding as a stride-14 convolution without bias;
  the class token first, the positions added, ``ln_pre``; each layer ``x +=
  out_proj(attention(layer_norm1(x)))`` with q, k and v projected apart and
  the attention written out per head as ``softmax(q k^T / sqrt(64)) v``,
  then ``x += fc2(quick_gelu(fc1(layer_norm2(x))))``; the embedding
  ``post_layernorm(x[:, 0]) @ visual_projection^T``. LayerNorm and
  ``quick_gelu(x) = x / (1 + exp(-1.702 x))`` are written out here.
- The projection: ``(x - mean) @ components``, the fitted projection's
  ``mean`` and ``components`` handed in as data; the fit and its gaps are
  ``reference/vgg.py``'s (:func:`.vgg.fit_pca`, :func:`.vgg.pca_gaps`).

It imports neither JAX nor the program. ``prec`` (:class:`.nets.Prec`)
rounds both operands of every product: the identity for the reference,
float8 e4m3 for the control that stands in for a tower one precision below
the configuration's bf16.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from . import nets
from .nets import F32, Prec

IMAGE_SIZE, PATCH, WIDTH, LAYERS, HEADS, MLP, OUTPUT_DIM = 336, 14, 1024, 24, 16, 4096, 768
EPS = 1e-5
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
BLOCK = 16
# The visual projection's draw over CLIP's initial N(0, 1 / width). A seeded
# tower's class token varies mostly with the image's mean colour, and at
# CLIP's scale its PCA rows (median norm ~12) reach the captioning nets at a
# quarter of the VGG16 cell's (~40): 16-89 distinct beam captions for 1,024
# images (14 seeds on an H100), so that a single bf16 near-tie moved up to
# 47% of the checked rows at once. At 4 (a power of two: every product of the
# tower's float8 control scales exactly) the rows reach the nets at ~48 and
# 361-674 captions serve 1,024 images, as the VGG16 cell's do. Every gap of
# the tower's half of the check is relative, so the gain moves only the
# captions.
PROJECTION_GAIN = 4.0
V = "vision_model."


def draw_weights(seed: int, device, image_size: int = IMAGE_SIZE, patch: int = PATCH,
                 width: int = WIDTH, layers: int = LAYERS, mlp: int = MLP,
                 output_dim: int = OUTPUT_DIM) -> dict:
    """The tower's weights from one ``torch.Generator`` on ``device``, so
    that each of its sums keeps a scale of order 1, as a trained tower's
    activations stay in range:

    - the patch embedding N(0, 1 / 588) (its fan-in): unit-variance patch
      tokens from the normalised pixels; the class token and the positions
      N(0, 1), the same scale, so that neither the content nor the position
      of a patch vanishes under ``ln_pre``;
    - q and k N(0, 4 / width), v and ``fc1`` N(0, 1 / width): from a
      LayerNorm'd row, q and k entries of spread 2 and v and ``fc1``
      entries of unit spread, so that the attention logits ``q k / 8``
      spread by 4: a softmax over the 577 tokens that picks among them, as
      a trained tower's does, not a near-uniform mean (at logits of unit
      spread the class token's embedding barely depends on the image);
    - ``out_proj`` and ``fc2`` N(0, 1 / (fan_in * layers)): each of the 48
      residual additions adds about 1 / layers of the stream's variance, so
      the stream stays O(1) through the 24 blocks;
    - ``visual_projection`` N(0, (:data:`PROJECTION_GAIN`)^2 / width): the
      embedding at the scale of the feature rows that the captioning nets'
      seeded weights meet in the other cells (see :data:`PROJECTION_GAIN`);
    - every bias N(0, 0.01); every LayerNorm's gain 1 + N(0, 0.1^2) and bias
      N(0, 0.1^2) (a trained LayerNorm's are not 1 and 0).
    """
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def normal(*shape, std=1.0, mean=0.0):
        w = torch.empty(shape, dtype=torch.float32, device=device).normal_(generator=gen)
        return w.mul_(std).add_(mean)

    def ln(prefix):
        sd[prefix + ".weight"] = normal(width, std=0.1, mean=1.0)
        sd[prefix + ".bias"] = normal(width, std=0.1)

    def linear(prefix, n_in, n_out, std):
        sd[prefix + ".weight"] = normal(n_out, n_in, std=std)
        sd[prefix + ".bias"] = normal(n_out, std=0.01)

    tokens = (image_size // patch) ** 2 + 1
    fan = 3 * patch * patch
    sd = {V + "embeddings.patch_embedding.weight": normal(width, 3, patch, patch, std=fan ** -0.5),
          V + "embeddings.class_embedding": normal(width),
          V + "embeddings.position_embedding.weight": normal(tokens, width)}
    ln(V + "pre_layrnorm")
    for i in range(layers):
        p = f"{V}encoder.layers.{i}."
        ln(p + "layer_norm1")
        for c, std in (("q", 2.0), ("k", 2.0), ("v", 1.0)):
            linear(f"{p}self_attn.{c}_proj", width, width, std * width ** -0.5)
        linear(p + "self_attn.out_proj", width, width, (width * layers) ** -0.5)
        ln(p + "layer_norm2")
        linear(p + "mlp.fc1", width, mlp, width ** -0.5)
        linear(p + "mlp.fc2", mlp, width, (mlp * layers) ** -0.5)
    ln(V + "post_layernorm")
    sd["visual_projection.weight"] = normal(output_dim, width,
                                            std=PROJECTION_GAIN * width ** -0.5)
    return sd


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8 ``[N, H, W, 3]`` -> normalised float32 ``[N, 3, H, W]``."""
    x = images.to(torch.float32) / 255.0
    mean = torch.tensor(MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + EPS) * w + b


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + torch.exp(-1.702 * x))


def _linear(sd: dict, prefix: str, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    return prec.mm(x, sd[prefix + ".weight"].T) + sd[prefix + ".bias"]


def _ln(sd: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, sd[prefix + ".weight"], sd[prefix + ".bias"])


def embed(sd: dict, x: torch.Tensor, heads: int = HEADS, prec: Prec = F32) -> torch.Tensor:
    """Preprocessed ``[N, 3, S, S]`` -> image embeddings ``[N, out]``."""
    w = sd[V + "embeddings.patch_embedding.weight"]
    patch = w.shape[-1]
    t = F.conv2d(prec.rnd(x), prec.rnd(w), stride=patch).flatten(2).transpose(1, 2)
    n, width = t.shape[0], t.shape[2]
    cls = sd[V + "embeddings.class_embedding"].expand(n, 1, width)
    t = torch.cat([cls, t], dim=1) + sd[V + "embeddings.position_embedding.weight"]
    t = _ln(sd, V + "pre_layrnorm", t)
    d = width // heads
    i = 0
    while f"{V}encoder.layers.{i}.layer_norm1.weight" in sd:
        p = f"{V}encoder.layers.{i}."
        h = _ln(sd, p + "layer_norm1", t)
        q, k, v = (_linear(sd, f"{p}self_attn.{c}_proj", h, prec)
                   .view(n, -1, heads, d).transpose(1, 2) for c in "qkv")
        att = torch.softmax(prec.mm(q, k.transpose(2, 3)) / d ** 0.5, dim=-1)
        o = prec.mm(att, v).transpose(1, 2).reshape(n, -1, width)
        t = t + _linear(sd, p + "self_attn.out_proj", o, prec)
        h = _ln(sd, p + "layer_norm2", t)
        t = t + _linear(sd, p + "mlp.fc2", quick_gelu(_linear(sd, p + "mlp.fc1", h, prec)), prec)
        i += 1
    cls = _ln(sd, V + "post_layernorm", t[:, 0])
    return prec.mm(cls, sd["visual_projection.weight"].T)


def embedding_table(sd: dict, images: np.ndarray, device, prec: Prec = F32,
                    heads: int = HEADS, block: int = BLOCK) -> torch.Tensor:
    """Embeddings ``[N, out]`` (float32, on ``device``) of uint8 images
    ``[N, S, S, 3]``, :data:`BLOCK` images at a time."""
    nets.tf32_off()
    out = []
    with torch.no_grad():
        for i in range(0, images.shape[0], block):
            x = preprocess(torch.from_numpy(np.ascontiguousarray(images[i:i + block])).to(device))
            out.append(embed(sd, x, heads, prec))
    return torch.cat(out)


def features(sd: dict, images: np.ndarray, mean: torch.Tensor, components: torch.Tensor,
             device, prec: Prec = F32, heads: int = HEADS) -> torch.Tensor:
    """The projected features ``[N, k]`` (float32, on ``device``) of uint8
    images ``[N, S, S, 3]``."""
    mean, components = mean.to(device, torch.float32), components.to(device, torch.float32)
    with torch.no_grad():
        return (embedding_table(sd, images, device, prec, heads) - mean) @ components
