"""``--spmd`` through the port's CLI in a world of two processes (gloo on the
CPU) against the same run in one process.

The two ranks run ``python -m image_captioning_through_rl_tpu_torch --spmd``
from directories of their own (no shared working directory: relative paths
name different files on each rank), with torchrun's variables, under one
deadline that kills both when either fails or the deadline passes
(``torch_multiprocess.run_world``). A ``--retrain`` run writes, on rank 0
alone, the artifacts of the single-process run: the caption and url dumps
byte for byte, the metrics' tags and steps with values at rtol 1e-4, every
``.ckpt`` leaf within rtol 1e-4, atol 1e-5 of the single process's (the
gradient sums run in another order, over a few hundred Adam steps); rank 1's
directory stays empty. A ``--test_model`` run then names rank 0's model by
a relative path that only rank 0 can open: rank 0's answer decides, its
reads reach rank 1 by broadcast, and the dumps equal a single-process
``--test_model`` run's. An A2C run from sub-networks that rank 0 reads and
broadcasts reduces the same gradients as one process.
"""

import importlib
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu.data.synthetic import make_synthetic_coco
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.train import checkpoint as tckpt

from torch_multiprocess import run_world

tmain = importlib.import_module("image_captioning_through_rl_tpu_torch.cli.main")
torch.set_num_threads(1)

V, F, WIDTH = 40, 32, 32
DIMS = ["--hidden_dim", str(WIDTH), "--wordvec_dim", str(WIDTH)]
DUMPS = ("generated_captions.txt", "real_captions.txt", "image_url.txt")


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return make_synthetic_coco(str(tmp_path_factory.mktemp("coco")), num_train_images=12,
                               num_val_images=6, captions_per_image=2, vocab_size=V,
                               feature_dim=F, seed=11)


def _argv(coco, *extra):
    return ["--data_dir", coco, "--epochs", "1", "--batch_size", "8", "--test_size", "20",
            "--pretrained_path", "pre", "--seed", "2", *DIMS, "--device", "cpu", *extra]


def _log_dir(cwd):
    (stamp,) = os.listdir(cwd / "logs")
    return cwd / "logs" / stamp


def _one_process(cwd, argv, monkeypatch):
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    return tmain.main(tmain.parse_args_with_config(tmain.build_arg_parser(), argv))


def _world(log_dir, cwds, argv):
    """The CLI with ``--spmd`` as two ranks, rank r in ``cwds[r]``."""
    for d in cwds:
        d.mkdir(parents=True, exist_ok=True)
    run_world(2, "", {}, log_dir, timeout=300, cwds=cwds,
              argv=[sys.executable, "-m", "image_captioning_through_rl_tpu_torch", "--spmd",
                    *argv])


def _leaves(path, kind):
    cfg = NetConfig(vocab_size=V, input_dim=F, wordvec_dim=WIDTH, hidden_dim=WIDTH)
    tree = tckpt.load_network(kind, str(path), device="cpu", cfg=cfg)
    return [x.numpy() for x in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, torch.Tensor))]


def test_spmd_retrain_and_test_model_in_two_processes(coco, tmp_path, monkeypatch):
    argv = _argv(coco, "--retrain")
    single = tmp_path / "single"
    _one_process(single, argv, monkeypatch)
    ranks = [tmp_path / "world" / f"rank{r}" for r in range(2)]
    _world(tmp_path, ranks, argv)
    assert list(ranks[1].iterdir()) == []  # rank 1 wrote nothing
    want, got = _log_dir(single), _log_dir(ranks[0])
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    for name in DUMPS:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
    logs = [[json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()]
            for d in (want, got)]
    assert [(r["tag"], r["step"]) for r in logs[1]] == [(r["tag"], r["step"]) for r in logs[0]]
    np.testing.assert_allclose([r["value"] for r in logs[1]], [r["value"] for r in logs[0]],
                               rtol=1e-4)
    assert sorted(os.listdir(ranks[0] / "pre")) == sorted(os.listdir(single / "pre"))
    for kind in ("reward", "policy", "value", "a2c"):
        for a, b in zip(_leaves(ranks[0] / "pre" / f"{kind}Network.ckpt", kind),
                        _leaves(single / "pre" / f"{kind}Network.ckpt", kind)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=kind)

    # --test_model: a relative path only rank 0 can open (rank 1 has no files)
    model = os.path.relpath(got / "a2cNetwork.ckpt", ranks[0])
    cwds = [ranks[0], tmp_path / "world_t1"]
    _world(tmp_path, cwds, _argv(coco, "--test_model", model))
    assert list(cwds[1].iterdir()) == []
    evals = sorted(os.listdir(got))
    assert "eval_config.json" in evals
    ref = tmp_path / "single_t"
    ref.mkdir()
    shutil.copytree(single / "pre", ref / "pre")
    shutil.copytree(single / "logs", ref / "logs")
    ref_model = os.path.relpath(_log_dir(ref) / "a2cNetwork.ckpt", ref)
    for name in DUMPS:  # before the single process's eval appends to its copy
        assert (got / name).read_bytes() == 2 * (want / name).read_bytes(), name
    monkeypatch.chdir(ref)
    tmain.main(tmain.parse_args_with_config(tmain.build_arg_parser(),
                                            _argv(coco, "--test_model", ref_model)))
    for name in DUMPS:
        assert (got / name).read_bytes() == (_log_dir(ref) / name).read_bytes(), name


def _first_moments(path):
    """Adam's first moment of each trained leaf in ``path``'s ``.trainstate``."""
    cfg = NetConfig(vocab_size=V, input_dim=F, wordvec_dim=WIDTH, hidden_dim=WIDTH)
    template = tckpt.load_network("a2c", str(path), device="cpu", cfg=cfg)
    mu = tckpt.load_train_state(str(path) + ".trainstate", template)["opt_state"]["0"]["mu"]
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(mu)[0]}


def test_spmd_a2c_from_loaded_networks_reduces_one_process_gradient(coco, tmp_path,
                                                                     monkeypatch):
    """A2C alone (no ``--retrain``) from the three sub-networks' files: rank
    0 reads them and broadcasts them into rank 1's freshly built trees. The
    gradients each step reduces, read back as Adam's first moments from
    the ``.trainstate``, equal the single process's to 1e-5 of each leaf's
    norm, and the ``.ckpt`` leaves agree at rtol 1e-4, atol 1e-5. (The
    ranks' trees were once built in different key orders, and the
    gradient bucket, laid out in the optimiser's order, summed one rank's
    leaves into another's.)"""
    single = tmp_path / "single"
    _one_process(single, _argv(coco, "--retrain"), monkeypatch)
    a2c_single = tmp_path / "a2c_single"
    ranks = [tmp_path / "world" / f"rank{r}" for r in range(2)]
    for d in (a2c_single, ranks[0]):
        (d / "pre").mkdir(parents=True)
        for kind in ("reward", "policy", "value"):
            shutil.copy(single / "pre" / f"{kind}Network.ckpt", d / "pre")
    monkeypatch.chdir(a2c_single)
    tmain.main(tmain.parse_args_with_config(tmain.build_arg_parser(), _argv(coco)))
    _world(tmp_path, ranks, _argv(coco))
    assert list(ranks[1].iterdir()) == []
    want, got = (_first_moments(d / "pre" / "a2cNetwork.ckpt") for d in (a2c_single, ranks[0]))
    assert sorted(got) == sorted(want) and want
    for k, a in want.items():
        assert np.linalg.norm(got[k] - a) <= 1e-5 * np.linalg.norm(a), k
    for a, b in zip(_leaves(ranks[0] / "pre" / "a2cNetwork.ckpt", "a2c"),
                    _leaves(a2c_single / "pre" / "a2cNetwork.ckpt", "a2c")):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_spmd_with_a_partial_launch_environment_raises(coco, tmp_path, monkeypatch):
    """Some of torchrun's variables but not all: ``--spmd`` raises, naming
    the missing ones, before a directory is made or the bundle is read (a
    rank that carried on alone would leave its peers waiting)."""
    monkeypatch.chdir(tmp_path)
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(RuntimeError, match=r"incomplete.*'LOCAL_RANK', 'MASTER_ADDR', "
                                           r"'MASTER_PORT'"):
        tmain.main(tmain.parse_args_with_config(tmain.build_arg_parser(),
                                                ["--spmd", *_argv(coco, "--retrain")]))
    assert not (tmp_path / "logs").exists() and not torch.distributed.is_initialized()
