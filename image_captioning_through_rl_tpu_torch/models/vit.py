"""CLIP's ViT image tower, the second visual front end: raw images -> image
embeddings (no counterpart in the JAX package).

The tower of Radford et al. (2021), "Learning Transferable Visual Models
From Natural Language Supervision", arXiv:2103.00020, at ViT-L/14@336px by
default (``openai/clip-vit-large-patch14-336``'s ``vision_config``):

- patches of 14 x 14 pixels (3 * 14 * 14 = 588 values each) embedded to
  1024 without a bias; a class token in front, 577 learned positions
  added, then ``ln_pre``;
- 24 pre-LN residual blocks, each ``x += out_proj(attn(ln_1(x)))`` with
  one fused in-projection to q, k and v and 16 heads of 64 at scale 1/8,
  then ``x += c_proj(quick_gelu(c_fc(ln_2(x))))`` with a 4096-wide hidden
  layer and ``quick_gelu(x) = x * sigmoid(1.702 x)``; LayerNorm eps 1e-5;
- the embedding ``ln_post(x[:, 0]) @ proj`` (1024 -> 768, no bias):
  CLIP's ``encode_image``.

:class:`VisionTransformer` is an ``nn.Module`` whose state-dict keys are
OpenAI CLIP's ``visual.*`` keys without the prefix (``conv1.weight``,
``class_embedding``, ``positional_embedding``, ``ln_pre``,
``transformer.resblocks.{i}.{ln_1, attn.in_proj_weight, attn.in_proj_bias,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}``, ``ln_post``, ``proj [1024,
768]``); :func:`.convert.clip_vision_from_state_dict` reads the
``transformers`` layout. The patch embedding runs as one product over the
unfolded patches (``conv1``'s weight viewed as ``[1024, 588]``): the
patches do not overlap, so the stride-14 convolution is exactly that
product, and cuBLAS runs it at ``[N * 576, 588] x [588, 1024]`` on the
tensor cores, where a convolution over 3 input channels would take cuDNN's
padded-channel kernels (VGG16's conv1_1 did). Every product with a weight
runs through ``torch.nn.functional.linear`` or ``@`` (cuBLAS on a card).

Attention is ``scaled_dot_product_attention`` on a backend named per call
(:func:`attention_backend`): FlashAttention for a bf16 or fp16 CUDA
tensor, forced, so that an input it cannot take raises rather than running
another kernel; the math backend elsewhere (the CPU, and float32 on a
card, with TF32 off as for every float32 product of the port). Inside
``extract.stack`` each block names two host spans
(:func:`..utils.profiling.annotate`): ``vit.attention`` (the head split,
the attention call and the head merge) and ``vit.mlp`` (``c_fc``, the
activation and ``c_proj``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..utils.profiling import annotate
from .vgg import _no_tf32

BACKBONE = "clip-vit-l14-336"
IMAGE_SIZE, PATCH, WIDTH, LAYERS, MLP_DIM, OUTPUT_DIM = 336, 14, 1024, 24, 4096, 768
HEAD_DIM = 64  # every CLIP tower's head width: heads = width / 64
EPS = 1e-5

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation, ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


def attention_backend(x: torch.Tensor) -> SDPBackend:
    """The one backend an attention call may take: FlashAttention for a
    bf16 or fp16 CUDA tensor, the math backend for any other (the CPU;
    float32 on a card, computed in float32 with TF32 off)."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        return SDPBackend.FLASH_ATTENTION
    return SDPBackend.MATH


def attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Softmax attention of every token over every token, per head, at scale
    ``1 / sqrt(head width)``: the fused projection ``qkv [N, T, 3 W]``
    (q, k, v in that order, each ``heads`` blocks of ``W / heads``) ->
    ``[N, T, W]``, heads merged in order. q, k and v are strided views of
    ``qkv``."""
    n, t, w3 = qkv.shape
    d = w3 // (3 * heads)
    q, k, v = qkv.view(n, t, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    with sdpa_kernel(attention_backend(qkv)):
        o = F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
    return o.transpose(1, 2).reshape(n, t, heads * d)


class _Attention(nn.Module):
    def __init__(self, width: int, device):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width, device=device))
        self.out_proj = nn.Linear(width, width, device=device)


class _MLP(nn.Module):
    def __init__(self, width: int, hidden: int, device):
        super().__init__()
        self.c_fc = nn.Linear(width, hidden, device=device)
        self.c_proj = nn.Linear(hidden, width, device=device)


class ResidualBlock(nn.Module):
    """One pre-LN block: ``x + out_proj(attn(ln_1(x)))``, then ``x +
    c_proj(quick_gelu(c_fc(ln_2(x))))``."""

    def __init__(self, width: int, heads: int, hidden: int, eps: float, device):
        super().__init__()
        self.heads = heads
        self.ln_1 = nn.LayerNorm(width, eps=eps, device=device)
        self.attn = _Attention(width, device)
        self.ln_2 = nn.LayerNorm(width, eps=eps, device=device)
        self.mlp = _MLP(width, hidden, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = F.linear(self.ln_1(x), self.attn.in_proj_weight, self.attn.in_proj_bias)
        with annotate("vit.attention"):
            o = attention(qkv, self.heads)
        x = x + self.attn.out_proj(o)
        h = self.ln_2(x)
        with annotate("vit.mlp"):
            m = self.mlp.c_proj(quick_gelu(self.mlp.c_fc(h)))
        return x + m


class VisionTransformer(nn.Module):
    """CLIP's image tower, on ``device``, without gradients; its weights are
    uninitialised until :meth:`init` or a state dict fills them. The
    defaults are ViT-L/14@336px; every CLIP ViT is the same module at other
    sizes (``heads`` defaults to ``width / 64``, every CLIP tower's head
    width)."""

    backbone = BACKBONE

    def __init__(self, image_size: int = IMAGE_SIZE, patch: int = PATCH, width: int = WIDTH,
                 layers: int = LAYERS, heads: int | None = None, mlp: int = MLP_DIM,
                 output_dim: int = OUTPUT_DIM, eps: float = EPS, device=None):
        super().__init__()
        heads = width // HEAD_DIM if heads is None else heads
        if image_size % patch or heads < 1 or width % heads:
            raise ValueError(f"image_size {image_size} must be a multiple of the patch {patch}, "
                             f"and width {width} of the heads {heads}")
        self.image_size, self.patch, self.width = image_size, patch, width
        self.feature_dim = output_dim
        tokens = (image_size // patch) ** 2 + 1
        # built on the meta device, then given uninitialised storage
        meta = "meta"
        self.conv1 = nn.Conv2d(3, width, patch, patch, bias=False, device=meta)
        self.class_embedding = nn.Parameter(torch.empty(width, device=meta))
        self.positional_embedding = nn.Parameter(torch.empty(tokens, width, device=meta))
        self.ln_pre = nn.LayerNorm(width, eps=eps, device=meta)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            ResidualBlock(width, heads, mlp, eps, meta) for _ in range(layers))
        self.ln_post = nn.LayerNorm(width, eps=eps, device=meta)
        self.proj = nn.Parameter(torch.empty(width, output_dim, device=meta))
        self.to_empty(device=device if device is not None else "cpu")
        self.requires_grad_(False)  # a feature extractor: nothing here trains

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "VisionTransformer":
        """Weights from ``gen`` at the scales of ``transformers``' CLIP
        initialisation (factor 1): the patch embedding and the positions
        N(0, 0.02), the class token N(0, 1 / width), q, k, v and ``c_proj``
        N(0, 1 / (width * 2 * layers)), ``out_proj`` N(0, 1 / width),
        ``c_fc`` N(0, 1 / (2 width)), ``proj`` N(0, 1 / width); biases 0,
        LayerNorms 1 and 0."""
        w, layers = self.width, len(self.transformer.resblocks)
        deep = (w * 2 * layers) ** -0.5

        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=gen) * std)

        normal(self.conv1.weight, 0.02)
        normal(self.positional_embedding, 0.02)
        normal(self.class_embedding, w ** -0.5)
        normal(self.proj, w ** -0.5)
        for block in self.transformer.resblocks:
            normal(block.attn.in_proj_weight, deep)
            normal(block.attn.out_proj.weight, w ** -0.5)
            normal(block.mlp.c_fc.weight, (2 * w) ** -0.5)
            normal(block.mlp.c_proj.weight, deep)
            for b in (block.attn.in_proj_bias, block.attn.out_proj.bias, block.mlp.c_fc.bias,
                      block.mlp.c_proj.bias):
                b.zero_()
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed images ``[N, 3, S, S]`` -> the first residual stream
        ``[N, T, W]``: patch embeddings after the class token, the
        positions added, then ``ln_pre``."""
        n, p, g = x.shape[0], self.patch, self.image_size // self.patch
        # [N, S, S, 3] -> [N * g * g, 3 * p * p] in conv1's (channel, row,
        # column) order: one copy, whatever x's memory format
        patches = (x.permute(0, 2, 3, 1).reshape(n, g, p, g, p, 3)
                   .permute(0, 1, 3, 5, 2, 4).reshape(n * g * g, 3 * p * p))
        t = F.linear(patches, self.conv1.weight.view(self.width, -1)).view(n, g * g, self.width)
        t = torch.cat([self.class_embedding.expand(n, 1, self.width), t], dim=1)
        return self.ln_pre(t + self.positional_embedding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed images ``[N, 3, S, S]`` -> embeddings ``[N,
        output_dim]`` in the module's type."""
        with torch.no_grad():
            _no_tf32(x)
            t = self.embed(x)
            for block in self.transformer.resblocks:
                t = block(t)
            return self.ln_post(t[:, 0]) @ self.proj

    def extract(self, images, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """The extraction loop's call (:func:`.vgg.iter_features`):
        :func:`features`."""
        return features(self, images, compute_dtype=compute_dtype)


def init(gen: torch.Generator, device=None, **sizes) -> VisionTransformer:
    """A :class:`VisionTransformer` (ViT-L/14@336px unless ``sizes`` say
    otherwise) with weights drawn from ``gen`` (:meth:`VisionTransformer.init`)."""
    return VisionTransformer(**sizes).init(gen).to(device if device is not None else "cpu")


def preprocess(images, size: int = IMAGE_SIZE, device=None) -> torch.Tensor:
    """RGB ``[N, H, W, 3]`` (uint8, divided by 255, or float) -> normalised
    ``[N, 3, size, size]`` float32 on ``device`` (the images' own for a
    tensor, else the CPU): a bicubic resize that antialiases when it
    shrinks, clamped to the pixels' range, skipped where the images are
    ``size`` already, then CLIP's mean and std. A view of the pixels'
    channels-last order (the patch embedding copies it once)."""
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images))
    if device is not None:
        images = images.to(device)
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x / 255.0
    x = x.permute(0, 3, 1, 2)
    if x.shape[2:] != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bicubic", align_corners=False,
                          antialias=True).clamp_(0.0, 1.0)
    mean, std = _clip_stats(x.device)
    return (x - mean) / std


@functools.lru_cache(maxsize=None)
def _clip_stats(device: torch.device) -> tuple:
    """CLIP's mean and std as ``[3, 1, 1]`` float32 tensors on ``device``,
    made once (a blocking copy on every batch would drain the card's
    queue)."""
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)[:, None, None]
                 for v in (CLIP_MEAN, CLIP_STD))


def features(model: VisionTransformer, images, compute_dtype: torch.dtype | None = None
             ) -> torch.Tensor:
    """Image embeddings ``[N, output_dim]`` float32 from raw images ``[N, H,
    W, 3]``, on the model's device. ``compute_dtype`` (``torch.bfloat16``)
    runs the tower with activations in that type; the model must be cast to
    match (``model.to(dtype)``, as :class:`..api.FeatureExtractor` casts
    it)."""
    dev = next(model.parameters()).device
    x = preprocess(images, size=model.image_size, device=dev)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    return model(x).to(torch.float32)

