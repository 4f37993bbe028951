"""CLI driver (counterpart of the JAX ``cli/main.py``), the reference
pipeline of image_captioner.py:

  setup paths -> load the bundle -> train or load the A2C network -> test
  (beam decode + caption dumps) -> score (BLEU/METEOR/ROUGE-L/CIDEr) ->
  [optional post-processing].

Every flag of the JAX CLI keeps its name, default, type and choices, and
``--config`` its precedence and errors. One flag is the port's own:
``--device`` (default ``cuda``, as ``server.main`` has it); without a card
the run raises unless it asks for ``--device cpu``. ``--faithful_beam``
evaluates with the reference's own beam (Q2 batch-mean ranking with the
Q1-stateful critic) and ``--compat_batch_as_time`` trains the reward and
value networks and A2C with the reference's batch-as-time encoders (Q1).
``--chunk_steps`` minibatch updates run per device dispatch (16 by default,
as in the JAX CLI; 1 walks one minibatch a dispatch, with the same
artifacts), and ``--resume`` continues an interrupted run from its
``.trainstate`` snapshots, as the JAX CLI does. ``--train_word2vec
word2vec|fasttext`` trains word vectors on the caption corpus (SGNS, on
``--device``; ``--save_word2vec`` writes them) and ``--pretrained_word2vec``
loads a named model or a vector file; either way the vectors, aligned to the
vocabulary, become every network's frozen embedding table and fix its
width.

``--spmd`` trains and evaluates data-parallel (:mod:`..parallel`): one
process per card, launched by ``torchrun --nproc_per_node=K -m
image_captioning_through_rl_tpu_torch --spmd ...``; each rank joins the
process group that torchrun's variables announce (NCCL on the cards, gloo
on the CPU or where ``--device cuda:<i>`` makes the ranks share one card)
and the mesh holds one entry a rank. A single process with ``--spmd`` is a
world of one. Rank 0 decides (whether ``--test_model`` names a model, the
log directory's name, the word vectors) and broadcasts, rank 0 alone writes
(``run_config.json``, the checkpoints, the dumps, ``results.txt``), and the
other ranks return before scoring.

A run writes into ``logs/<stamp>/`` what the JAX CLI writes there: the
caption, generated-caption and url dumps, ``results.txt``,
``run_config.json`` (``eval_config.json`` for a ``--test_model`` run, which
reuses the model's log directory), ``metrics.jsonl`` with TensorBoard's
``runs/`` beside it, and the a2c checkpoint; the sub-network checkpoints
and every ``.trainstate`` snapshot go to ``--pretrained_path``. Checkpoints are native ``.ckpt`` files (flax's
msgpack, :mod:`..train.checkpoint`); reference ``.pt`` files of the same
stem are read where no ``.ckpt`` is there.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from datetime import datetime

import torch

from ..api import resolve_device
from ..config import DecodeConfig
from ..data.coco import load_data
from ..parallel import collectives
from ..parallel.mesh import is_main_process, make_mesh, maybe_init_distributed, rank_device, world
from ..train.loops import load_a2c_models, test_a2c_network, train_a2c_network
from ..utils.io import atomic_write, get_filename, resolve_checkpoint
from ..utils.logging import print_green

BASE_DIR = os.path.join("datasets", "coco_captioning")
REAL_CAPTIONS_FILE = "real_captions.txt"
GENERATED_CAPTIONS_FILE = "generated_captions.txt"
IMAGE_URL_FILENAME = "image_url.txt"

# native checkpoints use .ckpt; reference .pt files of the same stem load too
A2C_NETWORK_WEIGHTS_FILE = "a2cNetwork.ckpt"
REWARD_NETWORK_WEIGHTS_FILE = "rewardNetwork.ckpt"
POLICY_NETWORK_WEIGHTS_FILE = "policyNetwork.ckpt"
VALUE_NETWORK_WEIGHTS_FILE = "valueNetwork.ckpt"

RESULTS_FILE = "results.txt"
BEST_SCORE_FILENAME = "best_scores.txt"
BEST_SCORE_IMAGES_PATH = "best_scores_images"
CURRICULUM_LEVELS = [3, 6, 9, 12, 15]  # image_captioner.py:35

def spmd_mesh(args):
    """``--spmd``: join the process group torchrun's variables announce
    (a partial set raises) and return the mesh, one entry a rank (this
    process's device alone in a world of one); None without ``--spmd``."""
    if not args.spmd:
        return None
    if maybe_init_distributed(args.device) or collectives.active():
        rank, size = world()
        print_green(f"[Info] SPMD: rank {rank} of {size} "
                    f"({torch.distributed.get_backend()})")
        return make_mesh(device=args.device)
    return make_mesh(devices=[rank_device(args.device)])


def setup(args):
    """Check the device, derive the log directory and the three path dicts
    (reference image_captioner.py:38-90). In a process group the log
    directory is rank 0's, and only rank 0 makes it."""
    dev = rank_device(args.device) if args.spmd else resolve_device(args.device)
    name = f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""
    print_green(f"[Info] Working on: {dev}{name}")

    if os.path.isdir(os.path.split(args.test_model)[0]):
        log_dir = os.path.split(args.test_model)[0]
    else:
        log_dir = os.path.join("logs", datetime.now().strftime("%d-%b-%Y_%H_%M_%S"))
    if collectives.active():  # rank 0's answer: its files decide
        log_dir = collectives.broadcast_bytes(log_dir.encode()).decode()
    if is_main_process():
        os.makedirs(log_dir, exist_ok=True)

    reward_file = get_filename(REWARD_NETWORK_WEIGHTS_FILE, args.bidirectional, None)
    policy_file = get_filename(POLICY_NETWORK_WEIGHTS_FILE, args.bidirectional, None)
    value_file = get_filename(VALUE_NETWORK_WEIGHTS_FILE, args.bidirectional, None)
    a2c_file = get_filename(A2C_NETWORK_WEIGHTS_FILE, args.bidirectional, args.curriculum)
    results_file = get_filename(RESULTS_FILE, args.bidirectional, args.curriculum)
    generated_file = get_filename(GENERATED_CAPTIONS_FILE, args.bidirectional, args.curriculum)

    save_paths = {
        "model_path": os.path.join(log_dir, a2c_file),
        "results_path": os.path.join(log_dir, results_file),
    }
    image_caption_data = {
        "real_captions_path": os.path.join(log_dir, REAL_CAPTIONS_FILE),
        "generated_captions_path": os.path.join(log_dir, generated_file),
        "image_urls_path": os.path.join(log_dir, IMAGE_URL_FILENAME),
        "best_score_file_path": os.path.join(log_dir, BEST_SCORE_FILENAME),
        "best_score_images_path": os.path.join(log_dir, BEST_SCORE_IMAGES_PATH),
    }
    network_paths = {
        "a2c_network": resolve_checkpoint(args.pretrained_path, a2c_file),
        "reward_network": resolve_checkpoint(args.pretrained_path, reward_file),
        "policy_network": resolve_checkpoint(args.pretrained_path, policy_file),
        "value_network": resolve_checkpoint(args.pretrained_path, value_file),
    }
    return log_dir, save_paths, image_caption_data, network_paths


def _record_run_config(args, log_dir: str) -> None:
    """Write the resolved flags to ``<log_dir>/run_config.json`` (replayable
    through ``--config``); a ``--test_model`` run reuses the model's log
    directory and writes ``eval_config.json`` instead, so the training run's
    record survives its evaluations. Rank 0's alone."""
    if not is_main_process():
        return
    reused_dir = os.path.isdir(os.path.split(args.test_model)[0])
    name = "eval_config.json" if reused_dir else "run_config.json"
    resolved = {k: v for k, v in sorted(vars(args).items()) if k != "config"}
    with atomic_write(os.path.join(log_dir, name)) as f:
        f.write(json.dumps(resolved, indent=2).encode() + b"\n")


def main(args) -> dict:
    """Run the pipeline for parsed ``args``. Returns the log directory, the
    A2C parameters, the network config and the wall seconds of each stage
    (``load``, ``word2vec`` with word vectors, ``reward``/``policy``/``value``
    when trained, ``a2c``, ``test``, ``score``, ``postprocess``); a rank
    other than 0 returns after the test, before the scores."""
    mesh = spmd_mesh(args)
    device = args.device if mesh is None else mesh.first_device
    multiprocess = mesh is not None and mesh.spans_processes
    log_dir, save_paths, image_caption_data, network_paths = setup(args)
    print_green(f"[Info] Saving Logs in dir: {log_dir}")
    _record_run_config(args, log_dir)
    seconds = {}

    @contextlib.contextmanager
    def stage(name):
        t0 = time.perf_counter()
        yield
        seconds[name] = time.perf_counter() - t0

    max_train = None if args.training_size == 0 else args.training_size
    print_green(f"[Info] Loading COCO dataset {max_train or ''}")
    with stage("load"):
        data = load_data(base_dir=args.data_dir, max_train=max_train, print_keys=True)
    print_green("[Info] COCO dataset loaded")

    if args.train_word2vec != "none":
        from ..embeddings import get_preprocessed_corpus, train_word_embeddings

        print_green(f"[Info] Training Word Embeddings {args.train_word2vec}")
        with stage("word2vec"):
            if is_main_process():
                data.embeddings = train_word_embeddings(
                    args.train_word2vec, data, get_preprocessed_corpus(data),
                    save_path=args.save_word2vec, device=device)
            if multiprocess:
                data.embeddings = _broadcast_array(data.embeddings)
        print_green("[Info] Done Training Word Embeddings")
    elif args.pretrained_word2vec != "none":
        from ..embeddings import get_embeddings, get_vectors_by_vocab

        print_green(f"[Info] Loading Pretrained Word Embeddings {args.pretrained_word2vec}")
        with stage("word2vec"):
            if is_main_process():
                data.embeddings = get_vectors_by_vocab(get_embeddings(args.pretrained_word2vec),
                                                       data.word_to_idx)
            if multiprocess:
                data.embeddings = _broadcast_array(data.embeddings)

    use_test_model = bool(os.path.isfile(args.test_model)
                          and "a2cNetwork" in os.path.split(args.test_model)[1])
    if multiprocess:
        # rank 0's decision: ranks that disagree about a local file would
        # enter mismatched collectives (the load's broadcast vs training)
        use_test_model = bool(collectives.broadcast_int(use_test_model))
    net_dims = {k: v for k, v in (("input_dim", args.input_dim),
                                  ("wordvec_dim", args.wordvec_dim),
                                  ("hidden_dim", args.hidden_dim))
                if v is not None} or None

    if use_test_model:
        print_green("[Info] Loading A2C Network")
        with stage("load_model"):
            a2c_params, cfg = load_a2c_models(args.test_model, data, network_paths,
                                              args.bidirectional, net_dims=net_dims,
                                              device=device, mesh=mesh)
        print_green("[Info] A2C Network loaded")
    else:
        curriculum = CURRICULUM_LEVELS if args.curriculum else None
        prof = contextlib.nullcontext()
        if args.profile_dir and is_main_process():
            from ..utils.profiling import trace

            prof = trace(args.profile_dir)
            print_green(f"[Info] Profiling to: {args.profile_dir}")
        print_green("[Info] Training A2C Network")
        with prof:
            a2c_params, _, cfg = train_a2c_network(
                train_data=data,
                save_paths=save_paths,
                network_paths=network_paths,
                plot_dir=log_dir,
                epochs=args.epochs,
                batch_size=args.batch_size,
                bidirectional=args.bidirectional,
                retrain_all=args.retrain,
                curriculum=curriculum,
                seed=args.seed,
                compat_batch_as_time=args.compat_batch_as_time,
                resume=args.resume,
                # the flag forces the fused steps; the default runs the
                # kernels on the card and the plain steps on the CPU
                fused_rollout=True if args.fused_rollout else None,
                chunk_steps=args.chunk_steps,
                device=device,
                net_dims=net_dims,
                stage_seconds=seconds,
                mesh=mesh,
            )
        print_green("[Info] A2C Network trained")

    print_green("[Info] Testing A2C Network")
    dcfg = DecodeConfig(max_seq_len=cfg.max_seq_len, per_sample_beams=not args.faithful_beam)
    with stage("test"):
        test_a2c_network(a2c_params, cfg, test_data=data, image_caption_data=image_caption_data,
                         data_size=args.test_size, dcfg=dcfg, seed=args.seed,
                         compat_dump=args.compat_dump, device=device, mesh=mesh)
    print_green("[Info] A2C Network Tested")
    result = {"log_dir": log_dir, "params": a2c_params, "cfg": cfg, "seconds": seconds}
    if not is_main_process():
        return result  # the dumps are rank 0's: it scores them

    print_green("[Info] A2C Network score - start")
    from ..metrics import calculate_a2c_network_score

    with stage("score"):
        calculate_a2c_network_score(image_caption_data, save_paths)
    print_green("[Info] A2C Network score - end")

    if args.postprocess:
        from ..metrics.postprocess import post_process_data

        print_green("[Info] Post-processing - start")
        with stage("postprocess"):
            post_process_data(image_caption_data)
        print_green("[Info] Post-processing - end")

    print_green(f"[Info] Logs saved in dir: {log_dir}")
    print_green("[Info] Stage seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    return result


def _broadcast_array(arr):
    """Rank 0's numpy array (or None) on every rank."""
    import io

    import numpy as np

    buf = io.BytesIO()
    if is_main_process():
        np.save(buf, np.asarray(arr) if arr is not None else np.zeros((0,)), allow_pickle=False)
    data = collectives.broadcast_bytes(buf.getvalue())
    out = np.load(io.BytesIO(data), allow_pickle=False)
    return None if out.shape == (0,) else out


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Generate Image Captions through Deep Reinforcement Learning "
                    "(PyTorch/CUDA)")
    p.add_argument("--training_size", type=int, default=0,
                   help="Cap on how many training captions to load; 0 keeps everything")
    p.add_argument("--test_size", type=int, default=40504,
                   help="How many validation samples to draw for the eval pass")
    p.add_argument("--epochs", type=int, default=100,
                   help="A2C training epochs")
    p.add_argument("--batch_size", type=int, default=512,
                   help="Episodes per A2C update (also the pretraining minibatch size)")
    p.add_argument("--retrain", action=argparse.BooleanOptionalAction, default=False,
                   help="Train the reward, policy and value sub-networks from "
                        "scratch instead of loading their checkpoints")
    p.add_argument("--postprocess", action=argparse.BooleanOptionalAction, default=False,
                   help="After scoring, rank caption pairs, save the top five and "
                        "fetch their source images")
    p.add_argument("--curriculum", action=argparse.BooleanOptionalAction, default=False,
                   help="Run the staged-rollout (curriculum) variant of A2C training")
    p.add_argument("--bidirectional", action=argparse.BooleanOptionalAction, default=False,
                   help="Build every recurrent encoder bidirectionally")
    p.add_argument("--test_model", type=str, default="",
                   help="Path to a finished A2C checkpoint to evaluate instead of "
                        "training (.ckpt or reference .pt)")
    p.add_argument("--pretrained_path", type=str, default="models_pretrained",
                   help="Directory holding the sub-network checkpoints")
    p.add_argument("--pretrained_word2vec", type=str, default="none",
                   help="Pretrained word-vector source: none, conceptnet, word2vec, "
                        "fasttext, glove (a file of that name in $ICRL_EMBEDDINGS_DIR, "
                        "else a gensim download), or a word2vec/GloVe file path; the "
                        "vectors become the frozen embedding tables")
    p.add_argument("--train_word2vec", type=str, default="none",
                   choices=["none", "word2vec", "fasttext"],
                   help="Fit word embeddings on the caption corpus before training "
                        "(SGNS on --device); they become the frozen embedding tables")
    p.add_argument("--save_word2vec", type=str, default="",
                   help="Also write the trained word vectors to this path in the "
                        "word2vec interchange format (.bin for binary, .gz ok)")
    p.add_argument("--data_dir", type=str, default=BASE_DIR, help="Dataset directory")
    p.add_argument("--seed", type=int, default=0, help="Global RNG seed")
    p.add_argument("--faithful_beam", action=argparse.BooleanOptionalAction, default=False,
                   help="Reference-exact decoding: batch-mean shared beam (Q2) with "
                        "stateful value encoding (Q1), one 127-row slice a decode, in "
                        "float32 on the device (no beam kernel)")
    p.add_argument("--compat_dump", action=argparse.BooleanOptionalAction, default=False,
                   help="Write caption dumps with the reference's merged slice "
                        "boundaries (no trailing newline per slice, quirk Q13)")
    p.add_argument("--compat_batch_as_time", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="Reference-exact batch-as-time value/reward encoders (quirk Q1) "
                        "for the reward and value pretrainers and A2C (their plain steps, "
                        "no fused kernel)")
    p.add_argument("--resume", action=argparse.BooleanOptionalAction, default=False,
                   help="Continue an interrupted run from its full-state snapshots "
                        "(<checkpoint>.trainstate: weights, Adam moments, RNG streams, "
                        "epoch), bit-identically; without one, A2C resumes its weights "
                        "only")
    p.add_argument("--chunk_steps", type=int, default=16,
                   help="Minibatch updates per device dispatch, with the train split "
                        "on the device and the best-loss bookkeeping kept there (the "
                        "reward and policy pretrainers replay one CUDA graph a chunk on "
                        "the card); 1 walks one minibatch a dispatch. The artifacts are "
                        "the same either way")
    p.add_argument("--fused_rollout", action=argparse.BooleanOptionalAction, default=False,
                   help="Force the fused A2C steps (on the CPU their wrappers run the "
                        "kernels' plain versions). Default: the kernels on the card, the "
                        "plain steps on the CPU")
    p.add_argument("--input_dim", type=int, default=None,
                   help="Image feature dimension (default: inferred from "
                        "the dataset's feature width; the reference "
                        "hard-codes 512 in models.py)")
    p.add_argument("--wordvec_dim", type=int, default=None,
                   help="Word embedding dimension (default 512; "
                        "pretrained vectors override it)")
    p.add_argument("--hidden_dim", type=int, default=None,
                   help="RNN hidden dimension (default 512)")
    p.add_argument("--spmd", action=argparse.BooleanOptionalAction, default=False,
                   help="Train and evaluate data-parallel over every rank of the job, one "
                        "card a process (launch with torchrun --nproc_per_node=K); a single "
                        "process is a world of one")
    p.add_argument("--profile_dir", type=str, default="",
                   help="Capture a torch.profiler trace of the training phase (host, and "
                        "the card when there is one) into this directory as a Chrome "
                        "trace (Perfetto, chrome://tracing)")
    p.add_argument("--config", type=str, default="",
                   help="JSON file of flag values used as DEFAULTS (explicit "
                        "command-line flags still win). Every run writes its "
                        "resolved flags to <log_dir>/run_config.json, which "
                        "replays through this option")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: the card unless the run asks for cpu; a missing "
                        "CUDA device raises")
    return p


def parse_args_with_config(parser: argparse.ArgumentParser, argv=None):
    """Parse ``argv`` honoring ``--config``: the JSON file's values are
    installed as parser defaults before the real parse, so precedence is
    command line > config file > built-in defaults. Unknown keys and
    mistyped values fail fast with the offending key named."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", type=str, default="")
    ns, _ = pre.parse_known_args(argv)
    if ns.config:
        with open(ns.config) as f:
            try:
                cfg = json.load(f)
            except json.JSONDecodeError as e:
                parser.error(f"--config {ns.config}: not valid JSON ({e})")
        if not isinstance(cfg, dict):
            parser.error(f"--config {ns.config}: expected a JSON object of "
                         f"flag values, got {type(cfg).__name__}")
        by_dest = {a.dest: a for a in parser._actions}
        for key, val in cfg.items():
            act = by_dest.get(key)
            if act is None or key in ("help", "config"):
                parser.error(f"--config {ns.config}: unknown key {key!r} "
                             f"(run --help for the flag list)")
            if isinstance(act, (argparse.BooleanOptionalAction,
                                argparse._StoreTrueAction,
                                argparse._StoreFalseAction)):
                if not isinstance(val, bool):
                    parser.error(f"--config {ns.config}: key {key!r} must be "
                                 f"a JSON boolean, got {val!r}")
            elif act.type is not None and val is not None:
                try:
                    cfg[key] = act.type(val)
                except (TypeError, ValueError):
                    parser.error(f"--config {ns.config}: key {key!r}: "
                                 f"{val!r} is not a valid "
                                 f"{getattr(act.type, '__name__', act.type)}")
            if act.choices is not None and cfg[key] not in act.choices:
                parser.error(f"--config {ns.config}: key {key!r}: "
                             f"{cfg[key]!r} not in {sorted(act.choices)}")
        parser.set_defaults(**cfg)
    return parser.parse_args(argv)


def run(argv=None) -> None:
    main(parse_args_with_config(build_arg_parser(), argv))
