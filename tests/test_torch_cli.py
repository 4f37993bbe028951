"""The port's CLIs against the JAX package's, on the CPU at small widths.

One synthetic bundle (the JAX package's ``make_synthetic_coco``: 24
training and 12 validation captions, V = 40, F = 32) and
``--hidden_dim``/``--wordvec_dim`` 32. The port runs with ``--device cpu``;
each side runs in its own working directory (the log directories are named
to the second). Held:
  * both parsers' defaults and flags (except the port's ``--device``), and
    ``--config``'s precedence and errors;
  * every flag of a part not ported yet raises before the bundle is read,
    naming its ROADMAP item, and the ported ones (``--resume`` among them)
    reach the bundle; without
    a card the default device raises;
  * ``--test_model`` on JAX-written ``.ckpt`` files (JAX at
    ``precision="highest"``, as ``tests/test_torch_eval.py``): the three
    dumps byte-identical, ``results.txt`` scores within 1e-12,
    ``eval_config.json`` keys equal except ``device``;
  * a training run from JAX-written sub-network ``.ckpt`` files (A2C only,
    ``--epochs 1 --batch_size 8 --chunk_steps 1``): the A2C
    ``metrics.jsonl`` tags and steps equal and values within rtol 1e-4, the
    a2c ``.ckpt`` within atol 2e-5 of the JAX CLI's, the artifacts equal,
    TensorBoard's ``runs/`` and the ``.trainstate`` snapshots included;
  * a ``--retrain`` run of the port alone, whose ``.ckpt`` files the JAX
    package loads; ``--profile_dir`` leaves a Chrome trace;
  * ``--faithful_beam --compat_dump --test_model``: the dumps byte for byte
    and the scores against the JAX CLI's; ``--compat_batch_as_time`` runs,
    with ``--retrain`` and from JAX-written sub-networks, their losses
    within rtol 1e-4 of the JAX CLI's;
  * ``cli/score`` prints the JAX dict, ``cli/export`` writes the JAX
    export's tensors, and ``build_bundle`` (and ``cli/build_data``) writes
    the JAX builder's h5 contents, text files and stats.
"""

import ast
import dataclasses
import importlib
import json
import os
import shutil

import h5py
import jax
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu.cli import export as jexport
from image_captioning_through_rl_tpu.cli import score as jscore
from image_captioning_through_rl_tpu.config import NetConfig as JNetConfig
from image_captioning_through_rl_tpu.data.build import build_bundle as jbuild_bundle
from image_captioning_through_rl_tpu.data.synthetic import make_synthetic_coco
from image_captioning_through_rl_tpu.models import policy as jpolicy
from image_captioning_through_rl_tpu.models import reward as jreward
from image_captioning_through_rl_tpu.models import value as jvalue
from image_captioning_through_rl_tpu.train import checkpoint as jckpt
from image_captioning_through_rl_tpu_torch.cli import build_data as tbuild_data
from image_captioning_through_rl_tpu_torch.cli import export as texport
from image_captioning_through_rl_tpu_torch.cli import score as tscore
from image_captioning_through_rl_tpu_torch.data.build import build_bundle as tbuild_bundle
from image_captioning_through_rl_tpu_torch.models import from_jax_params
from image_captioning_through_rl_tpu_torch.train import checkpoint as tckpt

# the cli packages export main(); the modules come by name
jmain = importlib.import_module("image_captioning_through_rl_tpu.cli.main")
tmain = importlib.import_module("image_captioning_through_rl_tpu_torch.cli.main")
torch.set_num_threads(1)

V, F, WIDTH = 40, 32, 32
DIMS = ["--hidden_dim", str(WIDTH), "--wordvec_dim", str(WIDTH)]
JCFG = JNetConfig(vocab_size=V, input_dim=F, wordvec_dim=WIDTH, hidden_dim=WIDTH)
JINITS = {"reward": (jreward, 5), "policy": (jpolicy, 6), "value": (jvalue, 7)}
ARTIFACTS = {"a2cNetwork.ckpt", "generated_captions.txt", "image_url.txt", "metrics.jsonl",
             "real_captions.txt", "results.txt", "run_config.json", "runs"}


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return make_synthetic_coco(str(tmp_path_factory.mktemp("coco")), num_train_images=12,
                               num_val_images=6, captions_per_image=2, vocab_size=V,
                               feature_dim=F, seed=11)


@pytest.fixture(scope="module")
def jax_models(tmp_path_factory):
    """JAX-written sub-network ``.ckpt`` files and an a2c ``.ckpt`` in a
    log directory of its own (``run/``), from the JAX initialisers."""
    d = tmp_path_factory.mktemp("models")
    trees = {k: mod.init(jax.random.PRNGKey(key), JCFG) for k, (mod, key) in JINITS.items()}
    for kind, tree in trees.items():
        jckpt.save_pytree(tree, str(d / f"{kind}Network.ckpt"))
    (d / "run").mkdir()
    jckpt.save_pytree({"value": jvalue.init(jax.random.PRNGKey(8), JCFG),
                       "policy": jpolicy.init(jax.random.PRNGKey(9), JCFG)},
                      str(d / "run" / "a2cNetwork.ckpt"))
    return d


def _jax_run(argv):
    with jax.default_matmul_precision("highest"):
        jmain.main(jmain.parse_args_with_config(jmain.build_arg_parser(), argv))


def _port_run(argv):
    return tmain.main(tmain.parse_args_with_config(tmain.build_arg_parser(), argv))


def _log_dir(side):
    (stamp,) = os.listdir(side / "logs")
    return side / "logs" / stamp


def _scores(path):
    blocks = path.read_text().split("---------- results ----------")
    return [ast.literal_eval(b.strip()) for b in blocks if b.strip().startswith("{")]


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_parsers_defaults_and_flags_equal():
    j, t = jmain.build_arg_parser(), tmain.build_arg_parser()
    jd, td = vars(j.parse_args([])), vars(t.parse_args([]))
    assert td.pop("device") == "cuda"
    assert td == jd

    def flags(parser):
        return {a.dest: (a.option_strings, a.type, a.choices, a.default, type(a))
                for a in parser._actions}

    tf = flags(t)
    assert tf.pop("device")[0] == ["--device"]
    assert tf == flags(j)


CONFIGS = {
    "command line wins": ({"epochs": 3, "batch_size": 16, "retrain": True, "seed": "7",
                           "train_word2vec": "none"}, ["--epochs", "5", "--no-retrain"]),
    "unknown key": ({"nope": 1}, []),
    "config key": ({"config": "x.json"}, []),
    "boolean not a bool": ({"retrain": "yes"}, []),
    "bad type": ({"epochs": "many"}, []),
    "bad choice": ({"train_word2vec": "glove"}, []),
    "not an object": ([1, 2], []),
    "not JSON": ("{oops", []),
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_config_precedence_and_errors(case, tmp_path, capsys):
    cfg, extra = CONFIGS[case]
    path = tmp_path / "cfg.json"
    path.write_text(cfg if isinstance(cfg, str) else json.dumps(cfg))
    out = {}
    for side, mod in (("jax", jmain), ("port", tmain)):
        try:
            ns = vars(mod.parse_args_with_config(mod.build_arg_parser(),
                                                 ["--config", str(path), *extra]))
            ns.pop("device", None)
            out[side] = ns
        except SystemExit as e:
            out[side] = (e.code, capsys.readouterr().err.strip().splitlines()[-1])
    assert out["port"] == out["jax"]
    if case == "command line wins":
        assert (out["port"]["epochs"], out["port"]["batch_size"], out["port"]["retrain"],
                out["port"]["seed"]) == (5, 16, False, 7)
    else:
        assert out["port"][0] == 2 and "--config" in out["port"][1]


@pytest.mark.parametrize("flags, item", [
    (["--bidirectional"], 5), (["--faithful_beam"], 6), (["--compat_batch_as_time"], 6),
    (["--resume"], 7), (["--spmd"], 8), (["--train_word2vec", "word2vec"], 10),
    (["--pretrained_word2vec", "glove"], 10)])
def test_unported_flags_raise_before_the_bundle_is_read(flags, item, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--data_dir", str(tmp_path / "missing"), *flags, "--device", "cpu"]
    if item in (5, 6, 7):  # ported: these flags no longer raise, the run reads the bundle
        with pytest.raises(FileNotFoundError, match="missing"):
            _port_run(argv)
        return
    with pytest.raises(NotImplementedError, match=rf"^{flags[0]}: .*ROADMAP §1 item {item}\)"):
        _port_run(argv)
    assert not (tmp_path / "logs").exists()


def test_default_device_is_the_card(coco, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        _port_run(["--data_dir", coco, "--retrain", "--epochs", "1"])
    assert not (tmp_path / "logs").exists()


def test_test_model_matches_jax_cli(coco, jax_models, tmp_path, monkeypatch):
    runs = {}
    for side, run in (("j", _jax_run), ("t", _port_run)):
        d = tmp_path / side
        shutil.copytree(jax_models, d)
        monkeypatch.chdir(d)
        argv = ["--data_dir", coco, "--test_model", str(d / "run" / "a2cNetwork.ckpt"),
                "--test_size", "300", "--pretrained_path", str(d), *DIMS]
        run(argv + (["--device", "cpu"] if side == "t" else []))
        runs[side] = d / "run"
        assert not (d / "logs").exists()  # the model's log directory is reused
    for name in ("real_captions.txt", "generated_captions.txt", "image_url.txt"):
        got, want = (runs["t"] / name).read_bytes(), (runs["j"] / name).read_bytes()
        assert got == want, name
        assert len(want.splitlines()) == 298  # 300 draws: slices of 127, 127 and 44 rows
    (want,), (got,) = _scores(runs["j"] / "results.txt"), _scores(runs["t"] / "results.txt")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-300), k
    jcfg = json.loads((runs["j"] / "eval_config.json").read_text())
    tcfg = json.loads((runs["t"] / "eval_config.json").read_text())
    assert tcfg.pop("device") == "cpu" and sorted(tcfg) == sorted(jcfg)


def test_training_run_matches_jax_cli(coco, jax_models, tmp_path, monkeypatch):
    sides = {}
    for side, run in (("j", _jax_run), ("t", _port_run)):
        d = tmp_path / side
        shutil.copytree(jax_models, d, ignore=shutil.ignore_patterns("run"))
        monkeypatch.chdir(d)
        argv = ["--data_dir", coco, "--pretrained_path", ".", "--epochs", "1",
                "--batch_size", "8", "--chunk_steps", "1", "--test_size", "20", *DIMS]
        run(argv + (["--device", "cpu"] if side == "t" else []))
        sides[side] = d
    jlog, tlog = _log_dir(sides["j"]), _log_dir(sides["t"])
    want = [json.loads(x) for x in (jlog / "metrics.jsonl").read_text().splitlines()]
    got = [json.loads(x) for x in (tlog / "metrics.jsonl").read_text().splitlines()]
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    assert len(got) == 3 * 3 and got[0]["tag"].startswith("A2C Network-episodic")
    np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want], rtol=1e-4)

    template = {"value": jvalue.init(jax.random.PRNGKey(0), JCFG),
                "policy": jpolicy.init(jax.random.PRNGKey(0), JCFG)}
    saved_j = _flat(jckpt.load_network("a2c", str(jlog / "a2cNetwork.ckpt"), template=template))
    for path in (tlog / "a2cNetwork.ckpt", sides["t"] / "a2cNetwork.ckpt"):
        saved_t = _flat(jckpt.load_network("a2c", str(path), template=template))
        assert sorted(saved_t) == sorted(saved_j)
        for k in saved_j:
            np.testing.assert_allclose(saved_t[k], saved_j[k], rtol=0, atol=2e-5, err_msg=k)

    assert set(os.listdir(tlog)) == set(os.listdir(jlog)) == ARTIFACTS
    assert set(os.listdir(sides["t"])) == set(os.listdir(sides["j"]))
    for name in ("real_captions.txt", "image_url.txt"):
        assert (tlog / name).read_bytes() == (jlog / name).read_bytes(), name
    assert len(_scores(tlog / "results.txt")) == 1
    run_cfg = json.loads((tlog / "run_config.json").read_text())
    assert run_cfg.pop("device") == "cpu"
    assert run_cfg == json.loads((jlog / "run_config.json").read_text())


def test_retrain_run_writes_ckpts_the_jax_package_loads(coco, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pre = tmp_path / "pre"
    out = _port_run(["--data_dir", coco, "--retrain", "--epochs", "1", "--batch_size", "8",
                     "--test_size", "20", "--pretrained_path", str(pre), "--seed", "2", *DIMS,
                     "--device", "cpu"])
    log = _log_dir(tmp_path)
    assert set(os.listdir(log)) == ARTIFACTS
    assert set(os.listdir(pre)) == {f"{k}Network.ckpt{s}" for k in ("reward", "policy", "value",
                                                                      "a2c")
                                    for s in ("", ".trainstate")}
    assert set(out["seconds"]) == {"load", "reward", "policy", "value", "a2c", "test", "score"}
    tags = {json.loads(x)["tag"] for x in (log / "metrics.jsonl").read_text().splitlines()}
    assert {"Reward Network-loss", "Policy Network-loss", "Value Network-loss",
            "A2C Network-episodic-loss"} <= tags
    for kind, path in [(k, pre / f"{k}Network.ckpt") for k in JINITS] + [
            ("a2c", pre / "a2cNetwork.ckpt"), ("a2c", log / "a2cNetwork.ckpt")]:
        template = (JINITS[kind][0].init(jax.random.PRNGKey(0), JCFG) if kind != "a2c" else
                    {"value": jvalue.init(jax.random.PRNGKey(0), JCFG),
                     "policy": jpolicy.init(jax.random.PRNGKey(0), JCFG)})
        jtree = _flat(jckpt.load_network(kind, str(path), template=template))
        ttree = _flat(jax.tree.map(lambda t: t.numpy(), tckpt.load_network(
            kind, str(path), device="cpu", cfg=out["cfg"])))
        assert sorted(jtree) == sorted(ttree)
        for k in jtree:
            np.testing.assert_array_equal(jtree[k], ttree[k], err_msg=f"{path} {k}")
    final = _flat(jax.tree.map(lambda t: t.detach().numpy(), out["params"]))
    for k, v in _flat(jckpt.load_network("a2c", str(log / "a2cNetwork.ckpt"),
                                         template=template)).items():
        np.testing.assert_array_equal(v, final[k], err_msg=k)


def test_bidirectional_retrain_and_test_model_match_jax_cli(coco, tmp_path, monkeypatch):
    """``--bidirectional --retrain`` writes every artifact under its
    ``_bidirectional`` name, with finite losses; ``--bidirectional
    --test_model`` on its a2c ``.ckpt`` writes the JAX CLI's dumps, byte for
    byte, and its scores."""
    monkeypatch.chdir(tmp_path)
    pre = tmp_path / "pre"
    out = _port_run(["--data_dir", coco, "--bidirectional", "--retrain", "--epochs", "1",
                     "--batch_size", "8", "--test_size", "20", "--pretrained_path", str(pre),
                     *DIMS, "--device", "cpu"])
    assert out["cfg"].bidirectional
    log = _log_dir(tmp_path)
    bidi = {"a2cNetwork_bidirectional.ckpt", "generated_captions_bidirectional.txt",
            "results_bidirectional.txt"}
    assert set(os.listdir(log)) == ARTIFACTS - {"a2cNetwork.ckpt", "generated_captions.txt",
                                                 "results.txt"} | bidi
    assert set(os.listdir(pre)) == {f"{k}Network_bidirectional.ckpt{s}"
                                    for k in ("reward", "policy", "value", "a2c")
                                    for s in ("", ".trainstate")}
    values = [json.loads(x)["value"] for x in (log / "metrics.jsonl").read_text().splitlines()]
    assert values and np.isfinite(values).all()

    runs = {}
    for side, run in (("j", _jax_run), ("t", _port_run)):
        d = tmp_path / side
        shutil.copytree(pre, d / "pre")
        (d / "run").mkdir()
        shutil.copy(log / "a2cNetwork_bidirectional.ckpt", d / "run")
        monkeypatch.chdir(d)
        run(["--data_dir", coco, "--bidirectional", "--test_model",
             str(d / "run" / "a2cNetwork_bidirectional.ckpt"), "--test_size", "300",
             "--pretrained_path", str(d / "pre"), *DIMS]
            + (["--device", "cpu"] if side == "t" else []))
        runs[side] = d / "run"
    for name in ("real_captions.txt", "generated_captions_bidirectional.txt", "image_url.txt"):
        assert (runs["t"] / name).read_bytes() == (runs["j"] / name).read_bytes(), name
    (want,) = _scores(runs["j"] / "results_bidirectional.txt")
    (got,) = _scores(runs["t"] / "results_bidirectional.txt")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-300), k


def test_faithful_test_model_matches_jax_cli(coco, jax_models, tmp_path, monkeypatch):
    """``--faithful_beam --compat_dump --test_model``: the reference's eval
    (the Q2 batch-mean beam with the Q1-stateful critic, one slice a
    decode, the tail at its own size, the Q13 merged dumps), its three
    dumps byte for byte and its scores against the JAX CLI's."""
    runs = {}
    for side, run in (("j", _jax_run), ("t", _port_run)):
        d = tmp_path / side
        shutil.copytree(jax_models, d)
        monkeypatch.chdir(d)
        run(["--data_dir", coco, "--test_model", str(d / "run" / "a2cNetwork.ckpt"),
             "--test_size", "150", "--faithful_beam", "--compat_dump", "--pretrained_path",
             str(d), *DIMS] + (["--device", "cpu"] if side == "t" else []))
        runs[side] = d / "run"
    for name in ("real_captions.txt", "generated_captions.txt", "image_url.txt"):
        got, want = (runs["t"] / name).read_bytes(), (runs["j"] / name).read_bytes()
        assert got == want, name
        assert len(want.splitlines()) == 149 - 1  # slices of 127 and 22 rows, merged (Q13)
    (want,), (got,) = _scores(runs["j"] / "results.txt"), _scores(runs["t"] / "results.txt")
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-300), k


def _jax_inits(monkeypatch):
    """The port's networks start from the JAX initialisers' weights (the
    same seeds), so two trainings can be held to each other."""
    for name, jmod in (("reward", jreward), ("policy", jpolicy), ("value", jvalue)):
        def init(gen, cfg, emb=None, jmod=jmod):
            tree = jmod.init(jax.random.PRNGKey(gen.initial_seed()),
                             JNetConfig(**dataclasses.asdict(cfg)), emb)
            return from_jax_params(jax.tree.map(np.asarray, tree))

        monkeypatch.setattr(importlib.import_module(
            f"image_captioning_through_rl_tpu_torch.models.{name}"), "init", init)


def _compat_runs(coco, tmp_path, monkeypatch, extra, models=None):
    """A ``--compat_batch_as_time`` training run of each CLI on 8 training
    captions (one minibatch an epoch) -> both sides' metrics.jsonl records
    and log directories."""
    _jax_inits(monkeypatch)
    out = {}
    for side, run in (("j", _jax_run), ("t", _port_run)):
        d = tmp_path / side
        if models is None:
            d.mkdir()
        else:
            shutil.copytree(models, d, ignore=shutil.ignore_patterns("run", "value*"))
        monkeypatch.chdir(d)
        np.random.seed(4)  # the --training_size draw (numpy's global generator)
        run(["--data_dir", coco, "--compat_batch_as_time", "--training_size", "8", "--epochs",
             "1", "--batch_size", "8", "--chunk_steps", "1", "--test_size", "20",
             "--pretrained_path", ".", "--seed", "2", *extra, *DIMS]
            + (["--device", "cpu"] if side == "t" else []))
        log = _log_dir(d)
        out[side] = ([json.loads(x) for x in (log / "metrics.jsonl").read_text().splitlines()],
                     log)
    (want, jlog), (got, tlog) = out["j"], out["t"]
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    assert set(os.listdir(tlog)) == set(os.listdir(jlog)) == ARTIFACTS
    assert json.loads((tlog / "run_config.json").read_text())["compat_batch_as_time"]
    return want, got


def test_compat_retrain_run_matches_jax_cli(coco, tmp_path, monkeypatch):
    """``--compat_batch_as_time --retrain``: the same stages, minibatches
    and artifacts as the JAX CLI; the compat reward pretrainer's and the
    policy's 150 losses within rtol 1e-4 of the JAX CLI's, from the same
    initial weights and data. The value and A2C stages train against
    networks those 150 Adam steps left apart by float noise (Adam's
    normalised steps carry it into the weights), so their losses are
    checked finite here and held to the JAX CLI's from shared frozen
    networks by :func:`test_compat_training_run_matches_jax_cli`."""
    want, got = _compat_runs(coco, tmp_path, monkeypatch, ["--retrain"])
    assert len(got) == 50 + 100 + 50 + 3
    first = [i for i, r in enumerate(got) if r["tag"] in ("Reward Network-loss",
                                                          "Policy Network-loss")]
    assert len(first) == 150
    np.testing.assert_allclose([got[i]["value"] for i in first],
                               [want[i]["value"] for i in first], rtol=1e-4)
    assert np.isfinite([r["value"] for r in got]).all()


def test_compat_training_run_matches_jax_cli(coco, jax_models, tmp_path, monkeypatch):
    """``--compat_batch_as_time`` from JAX-written reward and policy
    ``.ckpt`` files and no value network: the compat value pretrainer's 50
    losses and the compat A2C step's losses within rtol 1e-4 of the JAX
    CLI's."""
    want, got = _compat_runs(coco, tmp_path, monkeypatch, [], models=jax_models)
    assert [r["tag"] for r in got].count("Value Network-loss") == 50 and len(got) == 50 + 3
    np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want], rtol=1e-4)


def test_profile_dir_leaves_a_trace(coco, jax_models, tmp_path, monkeypatch):
    d = tmp_path / "t"
    shutil.copytree(jax_models, d, ignore=shutil.ignore_patterns("run"))
    monkeypatch.chdir(d)
    _port_run(["--data_dir", coco, "--pretrained_path", str(d), "--epochs", "1",
               "--batch_size", "8", "--test_size", "10", "--profile_dir", str(d / "prof"),
               *DIMS, "--device", "cpu"])
    (trace,) = os.listdir(d / "prof")
    assert trace.endswith(".json")
    assert json.loads((d / "prof" / trace).read_text())["traceEvents"]


def test_score_cli_prints_the_jax_dict(tmp_path, capsys):
    real = tmp_path / "real.txt"
    gen = tmp_path / "gen.txt"
    real.write_text("<START> a man rides a horse <END>\n<START> two dogs play <END>\n"
                    "<START> a red bus on the street <END>\n")
    gen.write_text("<START> a man rides a brown horse <END>\n<START> a dog plays <END>\n"
                   "<START> a bus on a street <END>\n")
    outs = {}
    for side, mod in (("j", jscore), ("t", tscore)):
        for extra in ([], ["--json", "--results", str(tmp_path / f"{side}_results.txt")]):
            scores = mod.main([str(real), str(gen), *extra])
            outs[side, bool(extra)] = (capsys.readouterr().out, scores)
    for plain in (False, True):
        assert outs["t", plain] == outs["j", plain]
    assert ((tmp_path / "t_results.txt").read_text()
            == (tmp_path / "j_results.txt").read_text())


@pytest.mark.parametrize("kind", ["policy", "value", "reward", "a2c"])
def test_export_cli_matches_jax_export(kind, coco, jax_models, tmp_path):
    src = (jax_models / "run" / "a2cNetwork.ckpt" if kind == "a2c"
           else jax_models / f"{kind}Network.ckpt")
    widths = ["--input_dim", str(F), "--wordvec_dim", str(WIDTH), "--hidden_dim", str(WIDTH)]
    sds = {}
    for side, mod in (("j", jexport), ("t", texport)):
        mod.main([str(src), str(tmp_path / f"{side}.pt"), "--kind", kind, "--vocab", coco,
                  *widths])
        sds[side] = torch.load(tmp_path / f"{side}.pt", weights_only=True)
    # a .pt input re-exports through the same mapping
    texport.main([str(tmp_path / "j.pt"), str(tmp_path / "again.pt"), "--kind", kind])
    again = torch.load(tmp_path / "again.pt", weights_only=True)
    assert sorted(sds["t"]) == sorted(sds["j"]) == sorted(again)
    for k, v in sds["j"].items():
        assert sds["t"][k].dtype == v.dtype and torch.equal(sds["t"][k], v), k
        assert torch.equal(again[k], v), k
    with pytest.raises(ValueError, match="needs"):
        texport.main([str(src), str(tmp_path / "x.pt"), "--kind", kind, "--vocab", coco,
                      "--input_dim", str(F), "--hidden_dim", str(WIDTH + 1)])
    with pytest.raises(SystemExit):
        texport.main([str(src), str(tmp_path / "x.pt"), "--kind", kind])


@pytest.mark.parametrize("kind", ["policy", "value", "reward", "a2c"])
def test_export_cli_bidirectional_matches_jax_export(kind, coco, tmp_path):
    cfg = JNetConfig(vocab_size=V, input_dim=F, wordvec_dim=WIDTH, hidden_dim=WIDTH,
                     bidirectional=True)
    mods = {"policy": jpolicy, "value": jvalue, "reward": jreward}
    tree = ({k: mods[k].init(jax.random.PRNGKey(i), cfg) for i, k in enumerate(("value",
                                                                               "policy"))}
            if kind == "a2c" else mods[kind].init(jax.random.PRNGKey(3), cfg))
    src = tmp_path / f"{kind}Network_bidirectional.ckpt"
    jckpt.save_pytree(tree, str(src))
    widths = ["--input_dim", str(F), "--wordvec_dim", str(WIDTH), "--hidden_dim", str(WIDTH)]
    sds = {}
    for side, mod in (("j", jexport), ("t", texport)):
        mod.main([str(src), str(tmp_path / f"{side}.pt"), "--kind", kind, "--vocab", coco,
                  "--bidirectional", *widths])
        sds[side] = torch.load(tmp_path / f"{side}.pt", weights_only=True)
    texport.main([str(tmp_path / "j.pt"), str(tmp_path / "again.pt"), "--kind", kind,
                  "--bidirectional"])
    again = torch.load(tmp_path / "again.pt", weights_only=True)
    assert sorted(sds["t"]) == sorted(sds["j"]) == sorted(again)
    assert any(k.endswith("_reverse") for k in again)
    for k, v in sds["j"].items():
        assert torch.equal(sds["t"][k], v) and torch.equal(again[k], v), k
    with pytest.raises(ValueError, match="--bidirectional does not match"):
        texport.main([str(tmp_path / "j.pt"), str(tmp_path / "x.pt"), "--kind", kind])


def _annotations(path, split, rng):
    words = ["a", "man", "dog", "red", "bus", "the", "street", "on", "rides", "horse-drawn"]
    images = [{"id": int(i), "file_name": f"COCO_{split}_{i:06d}.jpg",
               "coco_url": f"http://images.example/{split}/{i}.jpg"}
              for i in rng.permutation(np.arange(100, 109))]
    anns = []
    for k in range(30):
        n = int(rng.integers(1, 20))
        anns.append({"id": k, "image_id": images[k % len(images)]["id"],
                     "caption": " ".join(rng.choice(words, size=n)) + rng.choice([".", "!", ""])})
    anns.append({"id": 99, "image_id": images[0]["id"], "caption": " ... "})
    path.write_text(json.dumps({"images": images, "annotations": anns}))
    return str(path)


def test_build_bundle_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    train = _annotations(tmp_path / "train.json", "train2014", rng)
    val = _annotations(tmp_path / "val.json", "val2014", rng)
    kw = dict(min_count=2, max_words=6, max_len=12, truncate=False)
    stats = {"j": jbuild_bundle(train, val, str(tmp_path / "j"), **kw),
             "t": tbuild_bundle(train, val, str(tmp_path / "t"), **kw)}
    tbuild_data.main(["--train_annotations", train, "--val_annotations", val, "--out_dir",
                      str(tmp_path / "cli"), "--min_count", "2", "--max_words", "6",
                      "--max_len", "12"])
    assert stats["t"] == stats["j"] and stats["j"]["train_dropped"] > 0
    assert stats["j"]["train_empty"] == 1
    names = sorted(os.listdir(tmp_path / "j"))
    for out in ("t", "cli"):
        assert sorted(os.listdir(tmp_path / out)) == names
        for name in names:
            a, b = tmp_path / "j" / name, tmp_path / out / name
            if name.endswith(".h5"):
                with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                    assert sorted(fa) == sorted(fb)
                    for k in fa:
                        assert fa[k].dtype == fb[k].dtype, k
                        np.testing.assert_array_equal(fb[k][()], fa[k][()], err_msg=k)
            else:
                assert a.read_bytes() == b.read_bytes(), name
