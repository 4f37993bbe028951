"""Caption image files end to end from the command line (counterpart of the
JAX ``cli/caption.py``, with its flags): raw JPEG/PNG -> VGG16 fc7, or with
``--backbone clip-vit-l14-336`` CLIP ViT-L/14@336px's image embedding (->
PCA) -> the trained policy (greedy, value-guided beam, the faithful beam or
sampled) -> caption text:

    python -m image_captioning_through_rl_tpu_torch.cli.caption \\
        photo1.jpg photo2.jpg \\
        --model logs/<ts>/a2cNetwork.ckpt \\
        --vocab datasets/coco_captioning/coco2014_vocab.json \\
        --vgg_weights vgg16.pt --pca datasets/coco_captioning/vgg16_fc7_pca.npz \\
        --beam_size 5

``--model`` takes a native ``.ckpt`` or a reference ``.pt``; the
``policyNetwork`` / ``valueNetwork`` files next to it load first when they
exist (the reference's order), unless ``--policy_model`` / ``--value_model``
name others, and the a2c checkpoint loads over them. One
``<file>\\t<caption>`` line an image (``--num_samples`` lines with
sampling) goes to stdout or ``--out``. The stack and the decodes run on the
card (``--device cuda``, the default) or, asked, the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    from ..api import BACKBONES

    ap = argparse.ArgumentParser(description="Caption image files (pixels -> features -> text)")
    ap.add_argument("images", nargs="*", help="image files to caption")
    ap.add_argument("--images_dir", default="", help="caption every image in this directory")
    ap.add_argument("--model", required=True, help="a2cNetwork checkpoint (.ckpt or reference .pt)")
    ap.add_argument("--vocab", required=True,
                    help="coco2014_vocab.json (or a directory holding it)")
    ap.add_argument("--policy_model", default="",
                    help="policy checkpoint (default: sibling of --model)")
    ap.add_argument("--value_model", default="",
                    help="value checkpoint (default: sibling of --model)")
    ap.add_argument("--backbone", default="vgg16", choices=BACKBONES,
                    help="the visual front end: VGG16 fc7, or CLIP ViT-L/14@336px's image "
                         "embedding")
    ap.add_argument("--vgg_weights", default="",
                    help="the backbone's weights: VGG16's .pt (torchvision layout) or .ckpt, "
                         "CLIP's transformers state dict; empty = random (pipeline testing "
                         "only)")
    ap.add_argument("--pca", default="",
                    help="fitted PCA projection .npz (cli/extract); required for models "
                         "trained on _pca features")
    ap.add_argument("--vgg_bf16", action="store_true",
                    help="run the backbone in bfloat16 (features drift at bf16 rounding "
                         "level)")
    ap.add_argument("--beam_size", type=int, default=0,
                    help="0 = greedy; >0 = value-guided beam search")
    ap.add_argument("--faithful_beam", action="store_true",
                    help="reference-exact shared-beam decoding (quirk Q2/Q1)")
    ap.add_argument("--sample", action="store_true",
                    help="stochastic decode (softmax sampling) instead of greedy/beam; seeded, "
                         "so runs reproduce")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="sampling temperature (0 = exact greedy)")
    ap.add_argument("--top_k", type=int, default=0,
                    help="sample only among the k most probable tokens per step (0 = all)")
    ap.add_argument("--top_p", type=float, default=1.0,
                    help="nucleus sampling: smallest token set holding this mass (1.0 = off)")
    ap.add_argument("--num_samples", type=int, default=1,
                    help="captions drawn per image (this many lines per image)")
    ap.add_argument("--sample_seed", type=int, default=0)
    ap.add_argument("--bidirectional", action="store_true")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--out", default="",
                    help="write captions here (one '<file>\\t<caption>' line each; default "
                         "stdout)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    paths = list(args.images)
    if args.images_dir:
        from .extract import list_images

        paths += list_images(args.images_dir, None)
    if not paths:
        ap.error("no images given (positional files or --images_dir)")
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        ap.error(f"image files not found: {missing[:5]}")
    if args.sample and args.beam_size:
        ap.error("--sample and --beam_size are mutually exclusive")

    from ..api import Captioner, load_feature_extractor, resolve_device
    from ..config import NetConfig
    from ..data.coco import load_vocab
    from ..train import checkpoint as ckpt
    from ..utils.io import get_filename, resolve_checkpoint
    from ..utils.logging import print_green

    device = resolve_device(args.device)
    vocab_path = (os.path.join(args.vocab, "coco2014_vocab.json")
                  if os.path.isdir(args.vocab) else args.vocab)
    word_to_idx, idx_to_word = load_vocab(vocab_path)
    extractor = load_feature_extractor(args.vgg_weights, args.pca, bf16=args.vgg_bf16,
                                       device=device, backbone=args.backbone)
    cfg = NetConfig.for_vocab(word_to_idx, bidirectional=args.bidirectional,
                              input_dim=extractor.dim)

    params = {}
    for kind, override in (("policy", args.policy_model), ("value", args.value_model)):
        path = override or resolve_checkpoint(
            os.path.dirname(args.model),
            get_filename(f"{kind}Network.ckpt", args.bidirectional, None))
        if os.path.exists(path):
            params[kind] = ckpt.load_network(kind, path, device, cfg)
        elif override:
            raise FileNotFoundError(f"{kind} checkpoint not found: {path}")
    params.update(ckpt.load_network("a2c", args.model, device, cfg))
    print_green(f"[Caption] model {args.model} | vocab {len(word_to_idx)} | features "
                f"{extractor.dim}-d | {len(paths)} images")

    cap = Captioner(params, cfg, idx_to_word, device=device)
    if args.sample:
        captions = cap.sample_images(paths, extractor, batch_size=args.batch_size,
                                     temperature=args.temperature, top_k=args.top_k,
                                     top_p=args.top_p, num_samples=args.num_samples,
                                     seed=args.sample_seed)
        if args.num_samples > 1:  # n-best: one line a draw, in order
            lines = [f"{p}\t{c}" for p, row in zip(paths, captions) for c in row]
        else:
            lines = [f"{p}\t{c}" for p, c in zip(paths, captions)]
    else:
        captions = cap.caption_images(paths, extractor, batch_size=args.batch_size,
                                      beam_size=args.beam_size, faithful_beam=args.faithful_beam)
        lines = [f"{p}\t{c}" for p, c in zip(paths, captions)]
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print_green(f"[Caption] wrote {args.out}")
    else:
        sys.stdout.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
