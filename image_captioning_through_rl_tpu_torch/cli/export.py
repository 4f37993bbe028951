"""Export a network checkpoint as a reference-layout torch ``.pt`` file
(counterpart of the JAX ``cli/export.py``):

    python -m image_captioning_through_rl_tpu_torch.cli.export \
        logs/<ts>/a2cNetwork.ckpt a2cNetwork.pt --kind a2c --vocab datasets/coco_captioning

The input is a native ``.ckpt`` (``--vocab`` is then required, and with the
widths sizes the shape check) or a ``.pt`` (re-exported through the same
mapping; its shapes are checked when ``--vocab`` is given). The output
loads into the reference's torch networks with ``strict=True``.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Export a checkpoint as a reference-layout torch .pt")
    ap.add_argument("src", help="input checkpoint (.ckpt native or .pt)")
    ap.add_argument("dst", help="output .pt path")
    ap.add_argument("--kind", required=True, choices=("policy", "value", "reward", "a2c"))
    ap.add_argument("--vocab", default="",
                    help="coco2014_vocab.json (or bundle dir); required for native .ckpt "
                         "inputs, where it sizes the shape check")
    ap.add_argument("--bidirectional", action="store_true",
                    help="bidirectional networks (not ported yet: raises, ROADMAP §1 item 5)")
    ap.add_argument("--input_dim", type=int, default=512)
    ap.add_argument("--wordvec_dim", type=int, default=512)
    ap.add_argument("--hidden_dim", type=int, default=512)
    args = ap.parse_args(argv)

    if not os.path.exists(args.src):
        ap.error(f"input checkpoint not found: {args.src}")
    if args.bidirectional:
        raise NotImplementedError("--bidirectional: bidirectional networks are not ported yet "
                                  "(ROADMAP §1 item 5)")
    if not args.src.endswith(".pt") and not args.vocab:
        ap.error("--vocab is required for native .ckpt inputs (sizes the shape check)")

    from ..config import NetConfig
    from ..data.coco import load_vocab
    from ..train import checkpoint as ckpt
    from ..utils.logging import print_green

    cfg = None
    if args.vocab:
        vocab_path = (os.path.join(args.vocab, "coco2014_vocab.json")
                      if os.path.isdir(args.vocab) else args.vocab)
        word_to_idx, _ = load_vocab(vocab_path)
        cfg = NetConfig.for_vocab(word_to_idx, input_dim=args.input_dim,
                                  wordvec_dim=args.wordvec_dim, hidden_dim=args.hidden_dim)
    params = ckpt.load_network(args.kind, args.src, device="cpu", cfg=cfg)
    ckpt.save_network_pt(args.kind, params, args.dst)
    print_green(f"[Export] {args.src} -> {args.dst} ({args.kind})")


if __name__ == "__main__":
    main()
