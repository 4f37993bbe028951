"""Operations and bytes of CLIP's image tower (ViT-L/14@336px by default),
then the PCA projection, for a batch of ``n`` images, layer by layer: the
yardstick of ``vit_l14_roofline``, ``attention_roofline.vit``,
``mlp_roofline.vit`` and of the CLIP cell's ``mfu.images``.

Counted as :mod:`portbench.counts` counts, from the shapes of
``portbench/reference/vit.py``, in bf16 (the configuration's tower), each
layer's least traffic: the preprocessing reads the uint8 pixels and writes
the bf16 patches; the patch embedding, each projection and each MLP product
read their input, weights and bias once and write their output once; the
class token, the positions and ``ln_pre`` are one pass over the stream, as
is each LayerNorm; the attention core reads q, k and v and writes its
output once, its products ``4 n heads T^2 d``; ``c_fc``'s activation is
taken in its pass (the least traffic; the program now spends three more
passes on it) and each residual add reads the stream once in its
product's pass; ``ln_post`` and ``proj`` act on the class rows only; the
projection to the PCA reads the bf16 embedding and the float32 ``mean``
and ``components`` and writes its float32 output, its products at the
float32 peak (the program's product runs with TF32 off). A layer's bound is
the larger of its bytes at the peak bandwidth and its products at the peak
rate; a stretch's is the sum over its layers, which run one after another.
"""

from __future__ import annotations

from portbench.counts import BW, FW, PEAK_F32, Work
from portbench.reference import vit as ref

U8 = 1
# ViT-L/14@336px, as the configuration's keys name its sizes
L14_336 = {"image_size": ref.IMAGE_SIZE, "patch_size": ref.PATCH, "hidden_size": ref.WIDTH,
           "num_hidden_layers": ref.LAYERS, "num_attention_heads": ref.HEADS,
           "intermediate_size": ref.MLP, "projection_dim": ref.OUTPUT_DIM}


def tower(cfg: dict) -> dict:
    """The tower's sizes out of a configuration (the keys of :data:`L14_336`)."""
    return {k: int(cfg[k]) for k in L14_336}


def attention(n: int, tw: dict = L14_336) -> Work:
    """One block's attention core over ``n`` images."""
    t, w = (tw["image_size"] // tw["patch_size"]) ** 2 + 1, tw["hidden_size"]
    d = w // tw["num_attention_heads"]
    return Work(4 * n * t * w * BW, 4.0 * n * tw["num_attention_heads"] * t * t * d)


def mlp(n: int, tw: dict = L14_336) -> list:
    """One block's ``c_fc`` (its activation in its pass) and ``c_proj``."""
    t, w, m = (tw["image_size"] // tw["patch_size"]) ** 2 + 1, tw["hidden_size"], \
        tw["intermediate_size"]
    return [("c_fc", Work(n * t * (w + m) * BW + (w * m + m) * BW, 2.0 * n * t * w * m)),
            ("c_proj", Work(n * t * (m + w) * BW + (m * w + w) * BW, 2.0 * n * t * m * w))]


def layers(n: int, pca_dim: int, tw: dict = L14_336) -> list:
    """``(name, Work)`` of each layer of the front end at ``n`` images."""
    s, p, w, o = tw["image_size"], tw["patch_size"], tw["hidden_size"], tw["projection_dim"]
    patches = (s // p) ** 2
    t, k = patches + 1, 3 * p * p
    stream = n * t * w * BW
    out = [("preprocess", Work(n * 3 * s * s * (U8 + BW), 0.0, scalar=2 * n * 3 * s * s)),
           ("patch_embed", Work(n * patches * (k + w) * BW + k * w * BW,
                                2.0 * n * patches * k * w)),
           ("embed", Work(n * patches * w * BW + (t + 3) * w * BW + stream, 0.0))]
    ln = Work(2 * stream + 2 * w * BW, 0.0)
    for i in range(tw["num_hidden_layers"]):
        out += [(f"ln_1.{i}", ln),
                (f"qkv.{i}", Work(stream + (3 * w * w + 3 * w) * BW + 3 * stream,
                                  2.0 * n * t * w * 3 * w)),
                (f"attention.{i}", attention(n, tw)),
                (f"out_proj.{i}", Work(3 * stream + (w * w + w) * BW, 2.0 * n * t * w * w)),
                (f"ln_2.{i}", ln)]
        out += [(f"{name}.{i}", work) for name, work in mlp(n, tw)]
        out.append((f"residual.{i}", Work(stream, 0.0)))
    out += [("ln_post", Work(2 * n * w * BW + 2 * w * BW, 0.0)),
            ("proj", Work(n * (w + o) * BW + w * o * BW, 2.0 * n * w * o)),
            ("projection", Work(n * o * BW + (o + o * pca_dim) * FW + n * pca_dim * FW,
                                2.0 * n * o * pca_dim, PEAK_F32))]
    return out


def bound_s(n: int, pca_dim: int, tw: dict = L14_336) -> float:
    """The least time the card could take over a batch of ``n`` images."""
    return sum(w.bound_s() for _, w in layers(n, pca_dim, tw))


def flops(n: int, pca_dim: int, tw: dict = L14_336) -> float:
    """The products of a batch of ``n`` images: the tower's and the
    projection's."""
    return sum(w.flops for _, w in layers(n, pca_dim, tw))
