"""The plain reference of the visual front end: VGG16 configuration D
(Simonyan & Zisserman, "Very Deep Convolutional Networks for Large-Scale
Image Recognition", arXiv:1409.1556, Table 1, column D) up to fc7, and the
PCA projection, in float32 ``torch.nn.functional`` (TF32 off), computed in
blocks of :data:`BLOCK` images.

- The weights: a dict in torchvision's ``vgg16`` state-dict layout
  (``features.{i}.weight`` OIHW at the ``nn.Sequential`` indices of the 13
  convolutions, ``classifier.0`` for fc6 and ``classifier.3`` for fc7; no
  fc8), drawn by :func:`draw_weights`.
- The preprocessing, written here: uint8 RGB ``[N, 224, 224, 3]`` over 255,
  less ImageNet's mean, over its std, then NCHW.
- The stack: 3x3 convolutions, padding 1, each followed by a ReLU, in blocks
  of 64-64 / 128-128 / 256x3 / 512x3 / 512x3 channels, each block closed by
  a 2x2 max-pool; fc6 reads the NCHW flatten of the last pool (512 x 7 x 7)
  and fc6 and fc7 are each followed by a ReLU (the dropout between them is
  the identity at inference).
- The projection: ``(x - mean) @ components``, with the fitted projection's
  ``mean`` and ``components`` handed in as data.
- The fit, of its own: the mean and the top-``k`` right singular vectors of
  an fc7 table in float64 (:func:`fit_pca`), and :func:`pca_gaps`, which
  holds another fit of the same images against it without regard to the
  components' signs.

It imports neither JAX nor the program. ``prec`` (:class:`.nets.Prec`)
rounds every layer's weights and its input activations: the identity for
the reference, float8 e4m3 for the control that stands in for a stack one
precision below the configuration's bf16.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from . import nets
from .nets import F32, Prec

CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M")
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
IMAGE_SIZE, FC_DIM, POOLED = 224, 4096, 512 * 7 * 7
FCS = ((0, POOLED, FC_DIM), (3, FC_DIM, FC_DIM))  # (classifier index, in, out): fc6, fc7
BLOCK = 64


def conv_layers() -> list:
    """``(index, in_channels, out_channels)`` of the 13 convolutions, at
    their indices in torchvision's ``features`` (each convolution and its
    ReLU take two, a pool one)."""
    out, i, c_in = [], 0, 3
    for c in CFG:
        if c == "M":
            i += 1
        else:
            out.append((i, c_in, c))
            c_in, i = c, i + 2
    return out


def draw_weights(seed: int, device) -> dict:
    """Every weight N(0, 2 / fan_in) (a convolution's fan-in is 9 input
    channels), every bias 0, from one ``torch.Generator`` on ``device``: a
    ReLU stack so drawn keeps its activations' mean square from layer to
    layer, as a trained VGG16's stays in range."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sd = {}

    def normal(shape, fan_in):
        w = torch.empty(shape, dtype=torch.float32, device=device).normal_(generator=gen)
        return w.mul_(math.sqrt(2.0 / fan_in))

    for i, c_in, c_out in conv_layers():
        sd[f"features.{i}.weight"] = normal((c_out, c_in, 3, 3), 9 * c_in)
        sd[f"features.{i}.bias"] = torch.zeros(c_out, device=device)
    for i, n_in, n_out in FCS:
        sd[f"classifier.{i}.weight"] = normal((n_out, n_in), n_in)
        sd[f"classifier.{i}.bias"] = torch.zeros(n_out, device=device)
    return sd


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8 ``[N, H, W, 3]`` -> normalised float32 ``[N, 3, H, W]``."""
    x = images.to(torch.float32) / 255.0
    mean = torch.tensor(MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def fc7(sd: dict, x: torch.Tensor, prec: Prec = F32) -> torch.Tensor:
    """Preprocessed ``[N, 3, 224, 224]`` -> fc7 ``[N, 4096]`` (after its ReLU)."""
    i = 0
    for c in CFG:
        if c == "M":
            x = F.max_pool2d(x, 2, 2)
            i += 1
        else:
            x = F.relu(F.conv2d(prec.rnd(x), prec.rnd(sd[f"features.{i}.weight"]),
                                sd[f"features.{i}.bias"], padding=1))
            i += 2
    x = torch.flatten(x, 1)
    for i, _, _ in FCS:
        x = F.relu(F.linear(prec.rnd(x), prec.rnd(sd[f"classifier.{i}.weight"]),
                            sd[f"classifier.{i}.bias"]))
    return x


def fc7_table(sd: dict, images: np.ndarray, device, prec: Prec = F32,
              block: int = BLOCK) -> torch.Tensor:
    """fc7 ``[N, 4096]`` (float32, on ``device``) of uint8 images
    ``[N, 224, 224, 3]``, :data:`BLOCK` images at a time."""
    nets.tf32_off()
    out = []
    with torch.no_grad():
        for i in range(0, images.shape[0], block):
            x = preprocess(torch.from_numpy(np.ascontiguousarray(images[i:i + block])).to(device))
            out.append(fc7(sd, x, prec))
    return torch.cat(out)


def features(sd: dict, images: np.ndarray, mean: torch.Tensor, components: torch.Tensor,
             device, prec: Prec = F32) -> torch.Tensor:
    """The projected features ``[N, k]`` (float32, on ``device``) of uint8
    images ``[N, 224, 224, 3]``."""
    mean, components = mean.to(device, torch.float32), components.to(device, torch.float32)
    with torch.no_grad():
        return (fc7_table(sd, images, device, prec) - mean) @ components


def fit_pca(table: torch.Tensor, k: int) -> tuple:
    """``(mean [D], components [D, k])`` in float64 of a table ``[N, D]``:
    its column mean and the first ``k`` right singular vectors of the
    centred table, in the order of their singular values."""
    x = table.to(torch.float64)
    mean = x.mean(dim=0)
    _, _, vt = torch.linalg.svd(x - mean, full_matrices=False)
    return mean, vt[:k].T


def pca_gaps(table: torch.Tensor, mean: torch.Tensor, components: torch.Tensor,
             fit_mean: torch.Tensor, fit_components: torch.Tensor) -> dict:
    """Another fit ``(fit_mean, fit_components)`` of the images of ``table``
    against this module's fit ``(mean, components)`` of it, by two numbers
    that no component's sign moves:

    - ``pca_mean_gap``: ``|fit_mean - mean| / |mean|``;
    - ``pca_variance_gap``: over every ``m`` up to ``k``, the largest
      ``|1 - v(m) / w(m)|``, where ``v(m)`` is the variance of the centred
      table along the fit's first ``m`` components and ``w(m)`` that along
      this module's, the most any ``m`` orthonormal directions take. A fit
      in the wrong order, off the subspace, or not orthonormal reads high;
      two fits that differ by rounding, or swap components of nearly equal
      variance, read near 0."""
    x = table.to(torch.float64) - mean
    want = torch.cumsum(((x @ components) ** 2).sum(dim=0), 0)
    got = torch.cumsum(((x @ fit_components.to(x)) ** 2).sum(dim=0), 0)
    fit_mean = fit_mean.to(mean)
    return {"pca_mean_gap": float(torch.linalg.vector_norm(fit_mean - mean)
                                  / torch.linalg.vector_norm(mean)),
            "pca_variance_gap": float((1.0 - got / want).abs().max())}
