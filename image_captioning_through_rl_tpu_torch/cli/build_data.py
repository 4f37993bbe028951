"""Dataset-builder CLI (counterpart of the JAX ``cli/build_data.py``): raw
COCO annotation JSON -> the captioning bundle (caption half).

    python -m image_captioning_through_rl_tpu_torch.cli.build_data \
        --train_annotations annotations/captions_train2014.json \
        --val_annotations annotations/captions_val2014.json \
        --out_dir datasets/coco_captioning --min_count 5

Writes ``coco2014_captions.h5``, ``coco2014_vocab.json``,
``{split}2014_urls.txt`` and ``{split}2014_images.txt``. The image
lists feed ``cli.extract`` (``--file_list``) so the VGG16 feature-table
rows land in the same image order the caption table indexes (reference utilities.py:45-113
documents the consumed layout).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from ..data.build import build_bundle
    from ..utils.logging import print_green

    ap = argparse.ArgumentParser(
        description="Build the COCO captioning bundle from annotation JSON")
    ap.add_argument("--train_annotations", required=True,
                    help="captions_train2014.json")
    ap.add_argument("--val_annotations", required=True,
                    help="captions_val2014.json")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--min_count", type=int, default=5,
                    help="words below this train-split count become <UNK>")
    ap.add_argument("--max_words", type=int, default=0,
                    help="cap the non-special vocabulary at the most "
                         "frequent N words (0 = no cap)")
    ap.add_argument("--max_len", type=int, default=17,
                    help="caption row width incl <START>/<END>")
    ap.add_argument("--truncate", action="store_true",
                    help="truncate over-length captions to max_len-2 body "
                         "words instead of dropping them")
    args = ap.parse_args(argv)

    stats = build_bundle(
        args.train_annotations, args.val_annotations, args.out_dir,
        min_count=args.min_count, max_words=args.max_words or None,
        max_len=args.max_len, truncate=args.truncate,
    )
    print_green(
        f"[BuildData] vocab {stats['vocab_size']} words; "
        f"train {stats['train_captions']} captions / "
        f"{stats['train_images']} images "
        f"({stats['train_dropped']} dropped over-length); "
        f"val {stats['val_captions']} / {stats['val_images']} "
        f"({stats['val_dropped']} dropped) -> {args.out_dir}"
    )
    print_green(
        "[BuildData] next: extract features per split, e.g.\n"
        f"  python -m image_captioning_through_rl_tpu_torch.cli.extract "
        f"--images_dir <train2014/> --split train --out_dir {args.out_dir} "
        f"--file_list {args.out_dir}/train2014_images.txt "
        "--weights vgg16.pt --pca_components 512"
    )


if __name__ == "__main__":
    main()
