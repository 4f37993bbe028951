"""Reference-checkpoint parity in one command (counterpart of the JAX
``cli/verify_reference.py``; ``icrl-torch-verify-reference``).

Point it at a directory of the reference's trained ``.pt`` files (the
``models_pretrained`` layout ``load_a2c_models`` reads, reference
utilities.py:299-323) and a COCO bundle, and it runs four stages:

  1. **convert** — every ``.pt`` through the converters
     (:mod:`..models.convert`) and back to a state dict, every tensor
     bitwise equal (the conversion is lossless, so any later difference is
     arithmetic, not plumbing).
  2. **greedy parity** — val features decoded by the port's carried greedy
     decode and by an eager-torch oracle that runs the ORIGINAL state dict
     under the reference's semantics (trainers.py:57-70: re-encode the
     whole prefix each step), token for token.
  3. **faithful-beam dump** — the reference's eval (``test_a2c_network``
     in the faithful Q2 + Q1 mode with the Q13 ``compat_dump``,
     trainers.py:619-665), its generated-captions file byte-diffed against
     the reference's own dump (``--dump_dir``).
  4. **score diff** — that dump scored by :mod:`..metrics` against the
     reference's published ``results*.txt`` dict.

``--self_test`` proves the command itself: it writes reference-layout
``.pt`` files of random networks and a synthetic bundle into a temporary
directory, makes a "reference" dump from the same weights, then requires
every stage to pass against them. Everything runs on ``--device`` (the
card unless the caller asks for ``cpu``). The exit code is 0 when every
stage that can run passes; a stage whose inputs are absent reports SKIP.
"""

from __future__ import annotations

import argparse
import ast
import glob
import os
import sys
import tempfile

import numpy as np
import torch

from .. import START_ID
from ..api import resolve_device
from ..config import DecodeConfig, NetConfig
from ..data import load_data, make_synthetic_coco
from ..decode import greedy_decode
from ..metrics import load_textfiles, score
from ..models import policy, reward, value
from ..models.convert import load_state_dict, network_from_state_dict, network_to_state_dict
from ..train import checkpoint as ckpt
from ..train.loops import load_a2c_models, test_a2c_network


def _stage(name: str, ok, detail: str = "") -> bool:
    tag = {True: "PASS", False: "FAIL", None: "SKIP"}[ok]
    print(f"[{tag}] {name}" + (f" — {detail}" if detail else ""), flush=True)
    return ok is not False


# ---------------------------------------------------------------------------
# stage 1: lossless conversion round trip
# ---------------------------------------------------------------------------

_KINDS = {  # file stem -> converter kind (the reference's file layout)
    "policyNetwork": "policy",
    "valueNetwork": "value",
    "rewardNetwork": "reward",
    "a2cNetwork": "a2c",
}


def _find_pt(models_dir: str, bidirectional: bool) -> dict:
    """kind -> path of its ``.pt``, the ``_bidirectional`` name first when
    ``bidirectional``."""
    sfx = "_bidirectional" if bidirectional else ""
    found = {}
    for stem, kind in _KINDS.items():
        for cand in (f"{stem}{sfx}.pt", f"{stem}.pt"):
            p = os.path.join(models_dir, cand)
            if os.path.exists(p):
                found[kind] = p
                break
    return found


def verify_convert(models_dir: str, bidirectional: bool, device="cuda") -> bool:
    found = _find_pt(models_dir, bidirectional)
    if not found:
        return _stage("convert", False, f"no reference .pt files in {models_dir}")
    ok_all = True
    for kind, path in sorted(found.items()):
        sd = load_state_dict(path)
        params = ckpt.to_device(network_from_state_dict(kind, sd, bidirectional), device)
        back = network_to_state_dict(kind, params, bidirectional)
        missing = set(sd) ^ set(back)
        bad = sorted(k for k in set(sd) & set(back)
                     if not torch.equal(sd[k].to(torch.float32), back[k]))
        ok = not missing and not bad
        ok_all &= _stage(
            f"convert {kind} ({os.path.basename(path)})", ok,
            f"{len(sd)} tensors round-trip bitwise" if ok
            else f"key diff {sorted(missing)[:4]}, value diff {bad[:4]}")
    return ok_all


# ---------------------------------------------------------------------------
# stage 2: greedy token parity against an eager-torch oracle of the .pt
# ---------------------------------------------------------------------------

def _torch_greedy(sd, features: np.ndarray, start: np.ndarray, max_len: int,
                  device="cpu") -> np.ndarray:
    """Greedy decode under the reference's eager semantics (models.py:33-84
    forward; trainers.py:57-70 loop: re-encode the whole prefix each step,
    append the argmax of the last position), on the state dict as it is."""
    t = {k: torch.as_tensor(np.array(v)).to(device) for k, v in sd.items()}
    emb, c2l_w = t["caption_embedding.weight"], t["cnn2linear.weight"]
    c2l_b = t["cnn2linear.bias"]
    wi, wh = t["lstm.weight_ih_l0"], t["lstm.weight_hh_l0"]
    bi, bh = t["lstm.bias_ih_l0"], t["lstm.bias_hh_l0"]
    head_w, head_b = t["linear2vocab.weight"], t["linear2vocab.bias"]

    feats = torch.as_tensor(features).to(device)
    caps = torch.as_tensor(start.astype(np.int64)).to(device)[:, None]
    lstm = torch.nn.LSTM(emb.shape[1], wh.shape[1], batch_first=True, device=device)
    if feats.is_cuda:  # float32 products and cuDNN, as the port computes them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wi)
        lstm.weight_hh_l0.copy_(wh)
        lstm.bias_ih_l0.copy_(bi)
        lstm.bias_hh_l0.copy_(bh)
        h0 = (feats @ c2l_w.T + c2l_b)[None]
        for _ in range(max_len - 1):
            out, _ = lstm(emb[caps], (h0, torch.zeros_like(h0)))
            logits = out[:, -1] @ head_w.T + head_b
            caps = torch.cat([caps, logits.argmax(-1, keepdim=True)], dim=1)
    return caps.cpu().numpy()


def _cfg_from_params(policy_params: dict, data) -> NetConfig:
    emb = policy_params["embedding"]
    return NetConfig.for_vocab(
        data.word_to_idx, None, input_dim=policy_params["cnn2linear"]["w"].shape[0],
        wordvec_dim=emb.shape[1], hidden_dim=policy_params["lstm"]["wh"].shape[0])


def verify_greedy(models_dir: str, data, bidirectional: bool, n: int, device="cuda") -> bool:
    found = _find_pt(models_dir, bidirectional)
    if "policy" not in found:
        return _stage("greedy parity", False, "policyNetwork.pt not found")
    if bidirectional:
        # the oracle here is unidirectional; the bidirectional forwards are
        # held to the JAX package's in tests/test_torch_bidirectional.py
        return _stage("greedy parity", None,
                      "bidirectional oracle not wired (tests cover it)") or True
    path = found["policy"]
    params = ckpt.load_network("policy", path, device)
    cfg = _cfg_from_params(params, data)
    feats = np.asarray(data.val_features[:n], np.float32)
    start = np.full((feats.shape[0],), START_ID, np.int32)
    with torch.no_grad():
        ours = greedy_decode(params, cfg, torch.from_numpy(feats).to(device),
                             torch.from_numpy(start).to(device)).cpu().numpy()
    oracle = _torch_greedy(load_state_dict(path), feats, start, cfg.max_seq_len, device)
    agree = float((ours == oracle).mean())
    rows = int((ours == oracle).all(axis=1).sum())
    return _stage("greedy parity", agree == 1.0,
                  f"{rows}/{len(feats)} captions token-exact (token agreement {agree:.6f})")


# ---------------------------------------------------------------------------
# stages 3 and 4: the faithful-beam dump's byte diff and the score diff
# ---------------------------------------------------------------------------

def run_eval_dump(models_dir: str, data, bidirectional: bool, out_dir: str, test_size: int,
                  seed: int = 0, device="cuda") -> dict | None:
    found = _find_pt(models_dir, bidirectional)
    missing = sorted(k for k in ("policy", "a2c") if k not in found)
    if missing:
        _stage("eval dump", False,
               f"missing {', '.join(m + 'Network.pt' for m in missing)} in {models_dir}")
        return None
    paths = {f"{k}_network": v for k, v in found.items()}
    # the widths come from the checkpoint, not the reference's hard-coded
    # 512s (models.py:17-18): the self test runs small networks
    sd = load_state_dict(found["policy"])
    net_dims = {"input_dim": sd["cnn2linear.weight"].shape[1],
                "wordvec_dim": sd["caption_embedding.weight"].shape[1],
                # lstm.weight_hh_l0 is [4H, H] in either direction mode
                "hidden_dim": sd["lstm.weight_hh_l0"].shape[1]}
    a2c_params, cfg = load_a2c_models(found["a2c"], data, paths, bidirectional,
                                      net_dims=net_dims, device=device)
    image_caption_data = {
        "real_captions_path": os.path.join(out_dir, "real_captions.txt"),
        "generated_captions_path": os.path.join(out_dir, "generated_captions.txt"),
        "image_urls_path": os.path.join(out_dir, "image_url.txt"),
    }
    test_a2c_network(a2c_params, cfg, data, image_caption_data, data_size=test_size,
                     dcfg=DecodeConfig(max_seq_len=cfg.max_seq_len, per_sample_beams=False),
                     seed=seed, compat_dump=True, device=device)
    return image_caption_data


def verify_dump_diff(generated: str, dump_dir: str) -> bool:
    cands = sorted(glob.glob(os.path.join(dump_dir, "generated_captions*.txt")))
    if not cands:
        return _stage("beam-dump byte-diff", None,
                      f"no generated_captions*.txt under {dump_dir}") or True
    ref_file = cands[0]
    with open(generated, "rb") as f:
        got = f.read()
    with open(ref_file, "rb") as f:
        want = f.read()
    if got == want:
        return _stage("beam-dump byte-diff", True,
                      f"byte-identical to {os.path.basename(ref_file)}")
    gl, wl = got.decode().splitlines(), want.decode().splitlines()
    first = next((i for i, (a, b) in enumerate(zip(gl, wl)) if a != b), min(len(gl), len(wl)))
    return _stage("beam-dump byte-diff", False,
                  f"{len(gl)} vs {len(wl)} lines; first diff at line {first + 1}")


def verify_score_diff(image_caption_data: dict, dump_dir: str, tol: float = 1e-9) -> bool:
    results = None
    for name in ("results_non-curr.txt", "results_curriculum.txt", "results.txt"):
        p = os.path.join(dump_dir, name)
        if os.path.exists(p):
            results = p
            break
    if results is None:
        return _stage("score diff", None, f"no results*.txt under {dump_dir}") or True
    with open(results) as f:
        published = next((ast.literal_eval(line.strip())
                          for line in f if line.strip().startswith("{")), None)
    if published is None:
        return _stage("score diff", False, f"no '{{...}}' results dict line in {results}")
    refs, hypo = load_textfiles(image_caption_data["real_captions_path"],
                                image_caption_data["generated_captions_path"])
    ours = score(refs, hypo)
    diffs = {k: abs(ours[k] - v) for k, v in published.items() if k in ours}
    worst = max(diffs.values()) if diffs else float("inf")
    return _stage("score diff", worst <= tol,
                  "; ".join(f"{k}: d={d:.2e}" for k, d in sorted(diffs.items())))


# ---------------------------------------------------------------------------
# self test: reference-style inputs made here, every stage must pass
# ---------------------------------------------------------------------------

def self_test(device="cuda") -> bool:
    """Every stage against ``.pt`` files, a bundle and a "reference" dump
    written into a new temporary directory, which it names."""
    print("— self test: writing reference-style .pt files and a bundle —")
    work = tempfile.mkdtemp(prefix="verify_reference_selftest_")
    fixture = make_synthetic_coco(os.path.join(work, "coco"), num_train_images=16,
                                  num_val_images=64, vocab_size=37, feature_dim=16, seed=11)
    data = load_data(fixture)
    cfg = NetConfig.for_vocab(data.word_to_idx, None, input_dim=16, wordvec_dim=12,
                              hidden_dim=16)
    models_dir = os.path.join(work, "models_pretrained")
    os.makedirs(models_dir)
    pp = policy.init(torch.Generator().manual_seed(0), cfg)
    vp = value.init(torch.Generator().manual_seed(1), cfg)
    rp = reward.init(torch.Generator().manual_seed(2), cfg)
    for kind, params in (("policy", pp), ("value", vp), ("reward", rp),
                         ("a2c", {"policy": pp, "value": vp})):
        ckpt.save_network(kind, params, os.path.join(models_dir, f"{kind}Network.pt"))

    # the "reference dump": the same eval once, its outputs stamped as the
    # files the real stages diff against (the byte and score diffs end to end)
    dump_dir = os.path.join(work, "reference_dump")
    os.makedirs(dump_dir)
    golden = run_eval_dump(models_dir, data, False, dump_dir, test_size=40, seed=3,
                           device=device)
    ref_gen = os.path.join(dump_dir, "generated_captions_non-curr.txt")
    os.rename(golden["generated_captions_path"], ref_gen)
    refs, hypo = load_textfiles(golden["real_captions_path"], ref_gen)
    with open(os.path.join(dump_dir, "results_non-curr.txt"), "w") as f:
        f.write("\n---------- results ----------\n")
        f.write(repr({k: v for k, v in score(refs, hypo).items() if k != "METEOR"}) + "\n")

    out_dir = os.path.join(work, "out")
    os.makedirs(out_dir)
    ok = verify_convert(models_dir, False, device)
    ok &= verify_greedy(models_dir, data, False, n=48, device=device)
    icd = run_eval_dump(models_dir, data, False, out_dir, test_size=40, seed=3, device=device)
    ok &= verify_dump_diff(icd["generated_captions_path"], dump_dir)
    ok &= verify_score_diff(icd, dump_dir)
    _stage("SELF TEST", bool(ok), work)
    return bool(ok)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Prove token, byte and score parity against the reference's real .pt "
                    "checkpoints (PyTorch/CUDA).")
    ap.add_argument("--models_dir", help="directory with the reference .pt files "
                    "(models_pretrained layout)")
    ap.add_argument("--data_dir", help="COCO bundle directory (load_data)")
    ap.add_argument("--dump_dir", default="", help="directory with the reference's shipped "
                    "generated_captions*/results*.txt to diff against (e.g. "
                    "models_pretrained/no_wemb)")
    ap.add_argument("--out_dir", default="", help="where to write our eval dump (default: a "
                    "temporary directory)")
    ap.add_argument("--test_size", type=int, default=40504,
                    help="eval draws (the reference image_captioner.py default)")
    ap.add_argument("--greedy_n", type=int, default=256,
                    help="val features for the greedy token-parity stage")
    ap.add_argument("--bidirectional", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--self_test", action="store_true",
                    help="write synthetic reference inputs and require every stage to pass")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device: the card unless the run asks for cpu; a missing CUDA "
                         "device raises")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.self_test:
        return 0 if self_test(dev) else 1
    if not args.models_dir or not args.data_dir:
        ap.error("--models_dir and --data_dir are required (or use --self_test)")

    data = load_data(args.data_dir)
    ok = verify_convert(args.models_dir, args.bidirectional, dev)
    ok &= verify_greedy(args.models_dir, data, args.bidirectional, n=args.greedy_n, device=dev)
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="verify_reference_")
    os.makedirs(out_dir, exist_ok=True)
    icd = run_eval_dump(args.models_dir, data, args.bidirectional, out_dir,
                        test_size=args.test_size, seed=args.seed, device=dev)
    if icd is None:
        ok = False
        _stage("beam-dump byte-diff", None, "eval dump unavailable")
        _stage("score diff", None, "eval dump unavailable")
    elif args.dump_dir:
        ok &= verify_dump_diff(icd["generated_captions_path"], args.dump_dir)
        ok &= verify_score_diff(icd, args.dump_dir)
    else:
        _stage("beam-dump byte-diff", None, "--dump_dir not given")
        _stage("score diff", None, "--dump_dir not given")
    if icd is not None:
        print(f"\neval dump written to {out_dir}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
