"""``cli/verify_reference`` of the port, on the CPU: the non-slow cases of
the JAX package's ``tests/test_verify_reference.py`` (the ``_bidirectional``
file first, missing checkpoints failing in their stage, a results file
without a dict line, the eager-torch greedy oracle against the port's
decode and the JAX one) and a ``--self_test`` with every stage passing and
the card by default."""

import jax
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import config as jconfig
from image_captioning_through_rl_tpu.models import policy as jpolicy
from image_captioning_through_rl_tpu.models.convert import to_torch_state_dict
from image_captioning_through_rl_tpu_torch import config as tconfig
from image_captioning_through_rl_tpu_torch.cli import verify_reference as vr
from image_captioning_through_rl_tpu_torch.decode import greedy_decode
from image_captioning_through_rl_tpu_torch.models import from_jax_params, policy

torch.set_num_threads(1)


def test_verify_reference_finds_the_bidirectional_files_first(tmp_path):
    for name in ("policyNetwork.pt", "policyNetwork_bidirectional.pt", "a2cNetwork.pt"):
        (tmp_path / name).write_bytes(b"x")
    uni = vr._find_pt(str(tmp_path), bidirectional=False)
    bi = vr._find_pt(str(tmp_path), bidirectional=True)
    assert uni["policy"].endswith("policyNetwork.pt")
    assert bi["policy"].endswith("policyNetwork_bidirectional.pt")
    assert bi["a2c"].endswith("a2cNetwork.pt")  # the plain name when there is no other


def test_verify_reference_torch_greedy_oracle_matches_the_port():
    """The eager-torch oracle on the reference state dict (the JAX
    package's export) against the port's carried greedy decode and the
    JAX one."""
    from image_captioning_through_rl_tpu.decode import greedy_decode as jgreedy

    kw = dict(vocab_size=33, input_dim=12, wordvec_dim=10, hidden_dim=14, max_seq_len=8)
    jcfg, tcfg = jconfig.NetConfig(precision="highest", **kw), tconfig.NetConfig(**kw)
    jpp = jpolicy.init(jax.random.PRNGKey(0), jcfg)
    feats = np.random.default_rng(2).standard_normal((9, 12)).astype(np.float32)
    start = np.ones(9, np.int32)
    oracle = vr._torch_greedy(to_torch_state_dict("policy", jax.tree.map(np.asarray, jpp)),
                              feats, start, kw["max_seq_len"])
    with torch.no_grad():
        ours = greedy_decode(from_jax_params(jax.tree.map(np.asarray, jpp)), tcfg,
                             torch.from_numpy(feats), torch.from_numpy(start)).numpy()
    np.testing.assert_array_equal(ours, oracle)
    np.testing.assert_array_equal(ours, np.asarray(jgreedy(jpp, jcfg, feats, start)))


def test_verify_reference_missing_checkpoints_fail_in_their_stage(tmp_path, capsys):
    """A models directory without a2cNetwork.pt: staged FAIL and SKIP lines
    and exit code 1, never a KeyError; an empty one fails the convert
    stage."""
    from image_captioning_through_rl_tpu_torch.data import load_data, make_synthetic_coco
    from image_captioning_through_rl_tpu_torch.train.checkpoint import save_network

    fixture = make_synthetic_coco(str(tmp_path / "coco"), num_train_images=4, num_val_images=8,
                                  vocab_size=23, feature_dim=8, seed=5)
    data = load_data(fixture)
    cfg = tconfig.NetConfig.for_vocab(data.word_to_idx, None, input_dim=8, wordvec_dim=6,
                                      hidden_dim=8)
    models = tmp_path / "models"
    models.mkdir()
    save_network("policy", policy.init(torch.Generator().manual_seed(0), cfg),
                 str(models / "policyNetwork.pt"))
    argv = ["--data_dir", fixture, "--device", "cpu"]
    rc = vr.main(["--models_dir", str(models), "--out_dir", str(tmp_path / "out"), *argv])
    out = capsys.readouterr().out
    assert rc == 1
    assert "[PASS] convert policy" in out and "[PASS] greedy parity" in out
    assert "[FAIL] eval dump" in out and "a2cNetwork.pt" in out
    assert "[SKIP] beam-dump byte-diff" in out and "[SKIP] score diff" in out
    empty = tmp_path / "empty"
    empty.mkdir()
    assert vr.main(["--models_dir", str(empty), "--out_dir", str(tmp_path / "out2"),
                    *argv]) == 1
    assert "[FAIL] convert" in capsys.readouterr().out


def test_verify_reference_score_diff_without_a_dict_line(tmp_path, capsys):
    (tmp_path / "results_non-curr.txt").write_text("scores: none here\n")
    (tmp_path / "real.txt").write_text("a cat\n")
    (tmp_path / "gen.txt").write_text("a cat\n")
    icd = {"real_captions_path": str(tmp_path / "real.txt"),
           "generated_captions_path": str(tmp_path / "gen.txt")}
    assert vr.verify_score_diff(icd, str(tmp_path)) is False
    assert "[FAIL] score diff" in capsys.readouterr().out


def test_verify_reference_self_test_passes_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(vr.tempfile, "mkdtemp", lambda prefix="": str(tmp_path / "work"))
    assert vr.main(["--self_test", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("[PASS]") == 8  # four converts, greedy, byte diff, score diff, the test
    assert "[FAIL]" not in out and "[PASS] SELF TEST" in out
    with pytest.raises(RuntimeError, match="cuda"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        vr.main(["--self_test"])
