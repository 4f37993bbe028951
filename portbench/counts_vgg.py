"""Operations and bytes of the visual front end (VGG16 configuration D up to
fc7, then the PCA projection) for a batch of ``n`` images, layer by layer:
the yardstick of ``vgg16_roofline`` and of the image cell's ``mfu.images``.

Counted as :mod:`portbench.counts` counts, from the shapes of
``portbench/reference/vgg.py``, in bf16 (the configuration's stack): the
preprocessing reads the uint8 pixels and writes the normalised input; each
convolution and linear layer reads its input, weights and bias once and
writes its output once, its ReLU in the same pass; each 2x2 pool reads its
input and writes its output; the projection reads fc7 and the float32
``mean`` and ``components`` and writes its float32 output, its products at
the float32 peak (the program's product runs with TF32 off). A layer's
bound is the larger of its bytes at the peak bandwidth and its products at
the peak rate; the stack's is the sum over its layers, which run one after
another.
"""

from __future__ import annotations

from portbench.counts import BW, FW, PEAK_F32, Work
from portbench.reference import vgg as ref

U8 = 1


def layers(n: int, pca_dim: int, size: int = ref.IMAGE_SIZE) -> list:
    """``(name, Work)`` of each layer of the front end at ``n`` images."""
    px = size * size
    out = [("preprocess", Work(n * 3 * px * U8 + n * 3 * px * BW, 0.0,
                               scalar=2 * n * 3 * px))]
    i, c_in, hw = 0, 3, size
    for c in ref.CFG:
        if c == "M":
            out.append((f"pool{i}", Work(n * c_in * hw * hw * BW + n * c_in * (hw // 2) ** 2 * BW,
                                         0.0, scalar=n * c_in * hw * hw)))
            hw //= 2
            i += 1
        else:
            out.append((f"conv{i}", Work(n * c_in * hw * hw * BW + (9 * c_in * c + c) * BW
                                         + n * c * hw * hw * BW,
                                         2.0 * n * hw * hw * 9 * c_in * c)))
            c_in = c
            i += 2
    for i, n_in, n_out in ref.FCS:
        out.append((f"fc{6 if i == 0 else 7}", Work((n_in * n_out + n_out) * BW
                                                    + n * (n_in + n_out) * BW,
                                                    2.0 * n * n_in * n_out)))
    out.append(("projection", Work(n * ref.FC_DIM * BW + (ref.FC_DIM + ref.FC_DIM * pca_dim) * FW
                                   + n * pca_dim * FW, 2.0 * n * ref.FC_DIM * pca_dim,
                                   PEAK_F32)))
    return out


def bound_s(n: int, pca_dim: int) -> float:
    """The least time the card could take over a batch of ``n`` images."""
    return sum(w.bound_s() for _, w in layers(n, pca_dim))


def flops(n: int, pca_dim: int) -> float:
    """The products of a batch of ``n`` images: the stack's and the
    projection's."""
    return sum(w.flops for _, w in layers(n, pca_dim))
