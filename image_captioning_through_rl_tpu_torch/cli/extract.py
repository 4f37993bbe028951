"""Feature-extraction CLI: raw images -> VGG16 fc7 ``.h5`` feature tables
(counterpart of the JAX ``cli/extract.py``, with its flags), or CLIP
ViT-L/14@336px image embeddings (``--backbone clip-vit-l14-336``).

Writes what the data loader reads (``{split}2014_vgg16_fc7[_pca].h5`` with a
``features`` dataset), each published atomically:

    python -m image_captioning_through_rl_tpu_torch.cli.extract \\
        --images_dir /path/to/val2014 --split val --out_dir datasets/coco_captioning \\
        --weights vgg16.pt --pca_components 512

``--weights`` takes a torchvision-layout VGG16 ``.pt`` state dict or a native
``.ckpt`` (with ``--backbone clip-vit-l14-336``: a ``transformers`` CLIP
state dict, and the tables and the projection are named
``{split}2014_clip_vit_l14_336[_pca].h5`` and ``clip_vit_l14_336_pca.npz``,
which the bundle's loader does not read); without it the weights are
random (pipeline testing only).
Images are read with PIL in file-name order; ``--file_list`` pins the order
(to match a ``*_urls.txt``). The stack runs on the card (``--device cuda``,
the default) or, asked, the CPU. Without ``--pca_components`` (or with
``--pca_from``) the tables are written block by block as the batches come
(:class:`..data.hdf5.H5Writer`), never held whole; a fresh PCA fit needs the
whole fc7 table, as in the JAX package. ``--spmd`` splits each batch over
all of the process's cards (:func:`..models.vgg.iter_features` with a mesh),
as the JAX CLI shards it over its chips.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np


def list_images(images_dir: str, file_list: str | None) -> List[str]:
    """The image paths: ``file_list``'s names in its order, else every
    ``.jpg``, ``.jpeg``, ``.png`` or ``.bmp`` of ``images_dir`` sorted."""
    if file_list:
        with open(file_list) as f:
            names = [line.strip() for line in f if line.strip()]
        return [os.path.join(images_dir, n) for n in names]
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    return sorted(os.path.join(images_dir, n) for n in os.listdir(images_dir)
                  if n.lower().endswith(exts))


def load_image_batch(paths: List[str], resize: int = 256, crop: int = 224,
                     resample: str = "bilinear") -> np.ndarray:
    """Decode on the host: the shorter side to ``resize`` (aspect kept, the
    longer side rounded to the nearest pixel), then a centre ``crop x
    crop`` (its offset rounded down) -> uint8 ``[N, crop, crop, 3]``.
    ``resample`` is PIL's filter: ``"bilinear"`` is VGG's evaluation
    geometry as torchvision's pretrained pipeline decodes it (Pillow's
    default filter differs); CLIP's transform is ``"bicubic"`` at ``resize
    = crop = 336``. The normalisation runs on the device
    (:func:`..models.vgg.preprocess`, :func:`..models.vit.preprocess`, whose
    resizes are skipped at the backbone's size)."""
    from PIL import Image  # the CLI's and the image server's dependency only

    filt = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}[resample]
    out = np.zeros((len(paths), crop, crop, 3), np.uint8)
    for i, p in enumerate(paths):
        with Image.open(p) as im:
            im = im.convert("RGB")
            w, h = im.size
            scale = resize / min(w, h)
            nw, nh = max(crop, round(w * scale)), max(crop, round(h * scale))
            im = im.resize((nw, nh), resample=filt)
            left, top = (nw - crop) // 2, (nh - crop) // 2
            out[i] = np.asarray(im.crop((left, top, left + crop, top + crop)), np.uint8)
    return out


def build_parser() -> argparse.ArgumentParser:
    from ..api import BACKBONES

    ap = argparse.ArgumentParser(description="Extract VGG16 fc7 (or CLIP image) features")
    ap.add_argument("--images_dir", required=True)
    ap.add_argument("--split", default="val", choices=["train", "val"])
    ap.add_argument("--out_dir", default=os.path.join("datasets", "coco_captioning"))
    ap.add_argument("--weights", default="", help="VGG16 weights (.pt torchvision layout or "
                    ".ckpt), or the --backbone's")
    ap.add_argument("--backbone", default="vgg16", choices=BACKBONES,
                    help="the visual front end: VGG16 fc7, or CLIP ViT-L/14@336px's image "
                         "embedding (weights in the transformers layout)")
    ap.add_argument("--file_list", default="", help="newline list of filenames fixing image order")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--pca_components", type=int, default=0,
                    help="also write the _pca variant with this many components")
    ap.add_argument("--pca_from", default="", help="reuse a fitted projection (.npz)")
    ap.add_argument("--bf16", action="store_true",
                    help="run the stack in bfloat16 (fc7 values drift at bf16 rounding "
                         "level; fit and apply PCA on the same type's features)")
    ap.add_argument("--spmd", action="store_true",
                    help="shard each batch over all of this process's cards")
    ap.add_argument("--pca_refit", action="store_true",
                    help="overwrite an existing vgg16_fc7_pca.npz with a fresh fit; any other "
                         "split's _pca features must then be re-extracted with --pca_from "
                         "against the new basis")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> None:
    from ..api import load_feature_extractor, resolve_device
    from ..data.hdf5 import H5Writer, write_h5
    from ..data.pca import PCAProjection, fit_pca
    from ..models import vgg
    from ..utils.logging import print_green

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    mesh = None
    if args.spmd:
        from ..parallel import make_mesh

        mesh = make_mesh(device=args.device)
        print_green(f"[Extract] SPMD: each batch split over {mesh}")
    extractor = load_feature_extractor(weights=args.weights, bf16=args.bf16, device=device,
                                       mesh=mesh, backbone=args.backbone)
    if args.weights:
        print_green(f"[Extract] loaded {args.backbone} weights from {args.weights}")
    paths = list_images(args.images_dir, args.file_list or None)
    print_green(f"[Extract] {len(paths)} images from {args.images_dir}")

    kwargs = dict(batch_size=args.batch_size, loader=extractor.load_images,
                  progress=vgg.print_progress("Extracting"),
                  compute_dtype=extractor.compute_dtype, mesh=mesh)
    os.makedirs(args.out_dir, exist_ok=True)
    tag = "vgg16_fc7" if args.backbone == "vgg16" else args.backbone.replace("-", "_")
    raw_path = os.path.join(args.out_dir, f"{args.split}2014_{tag}.h5")
    pca_path = os.path.join(args.out_dir, f"{args.split}2014_{tag}_pca.h5")
    npz_path = os.path.join(args.out_dir, f"{tag}_pca.npz")

    fitting = bool(args.pca_components) and not args.pca_from
    if fitting and os.path.exists(npz_path) and not args.pca_refit:
        # refused before the extraction: a refit would put this split in
        # another (rotated) basis than the split that wrote the npz
        raise SystemExit(
            f"[Extract] {npz_path} already exists; pass --pca_from {npz_path} so this split "
            "reuses the same projection (refitting would produce an incompatible basis), or "
            "--pca_refit to deliberately refit and overwrite it (or delete the npz by hand)")

    if fitting:
        feats = vgg.extract_features(extractor.model, paths, **kwargs)
        write_h5(raw_path, {"features": feats})
        print_green(f"[Extract] wrote {raw_path}")
        proj = fit_pca(torch_on(feats, device), k=args.pca_components)
        proj.save(npz_path)
        write_h5(pca_path, {"features": proj.apply(torch_on(feats, device)).cpu().numpy()})
        print_green(f"[Extract] wrote {pca_path}")
        return
    proj = PCAProjection.load(args.pca_from, device) if args.pca_from else None
    shapes = {"raw": (raw_path, extractor.dim)}
    if proj is not None:
        shapes["pca"] = (pca_path, proj.dim)
    import contextlib

    with contextlib.ExitStack() as stack:
        writers = {k: stack.enter_context(H5Writer(path, {"features": ((len(paths), dim), "f4")}))
                   for k, (path, dim) in shapes.items()}
        row = 0
        for block in vgg.iter_features(extractor.model, paths, **kwargs):
            writers["raw"].write("features", row, block)
            if proj is not None:
                writers["pca"].write("features", row,
                                       proj.apply(torch_on(block, device)).cpu().numpy())
            row += len(block)
    for path, _ in shapes.values():
        print_green(f"[Extract] wrote {path}")


def torch_on(x: np.ndarray, device):
    """A host array as a float32 tensor on ``device``."""
    import torch

    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


if __name__ == "__main__":
    main()
