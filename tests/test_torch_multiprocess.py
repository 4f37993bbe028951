"""The port's data-parallel training in worlds of 2 and 4 processes (gloo on
the CPU) vs the JAX package's single-process runs.

Each world is a set of processes of ``torch_multiprocess.py`` (one thread
each, a port the OS chose, one deadline for the world: a stuck collective
kills the peers and fails its test). The workers import only the port; the
references come from the JAX package in this process.

  * The three pretrainers one epoch each, then A2C plain and curriculum
    ``[4]``, with ``chunk_steps`` 1 and 2, on 27 captions in minibatches of
    8: the last minibatch (3 rows) is ragged and runs whole on every rank.
    Every rank's parameters equal JAX's single-process trainers' at rtol
    1e-4, atol 1e-6 (the equality the JAX package asserts between its mesh
    and plain runs, ``tests/test_multihost.py``), rank 0's metric logs match
    JAX's, and rank 1, whose network paths name an empty directory, wrote
    nothing there: it trained on rank 0's networks through broadcasts.
  * The VSE loss and gradient of the reward step, summed over the ranks,
    against the JAX ``reward_loss`` on the whole minibatch (rtol 1e-5, for
    each gradient leaf also 1e-5 of its largest entry, where entries near 0
    carry the leaf's rounding);
    the rollout's sampled actions at each rank's rows, gathered, equal to
    the JAX rollout's (interpret mode) bit for bit; the explicit per-rank
    A2C step against the JAX ``shard_map`` step on a mesh of as many
    devices, sampling and on a sampling-free window; greedy, beam and
    sampled decoding sharded over the processes, equal to JAX's
    single-device decodes on every rank.
  * ``_sync_load``: rank 0's file decides. A checkpoint that only rank 1
    holds raises ``FileNotFoundError`` on every rank, a corrupt one on rank
    0 raises on every rank, one that only rank 0 holds loads everywhere;
    none of them hangs.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import config as jconfig
from image_captioning_through_rl_tpu.data.coco import CocoData as JCocoData
from image_captioning_through_rl_tpu.decode import beam_search as jbeam_search
from image_captioning_through_rl_tpu.decode import greedy_decode as jgreedy_decode
from image_captioning_through_rl_tpu.decode import sample as jsample
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu.models import policy as jpolicy
from image_captioning_through_rl_tpu.models import reward as jreward
from image_captioning_through_rl_tpu.models import value as jvalue
from image_captioning_through_rl_tpu.ops.pallas_rollout import fused_rollout as jrollout
from image_captioning_through_rl_tpu.parallel import make_mesh as jmake_mesh
from image_captioning_through_rl_tpu.parallel import replicate as jreplicate
from image_captioning_through_rl_tpu.parallel import shard_batch as jshard_batch
from image_captioning_through_rl_tpu.parallel.shard_map_step import (
    make_shard_map_a2c_step as jshard_map_step)
from image_captioning_through_rl_tpu.train import loops as jloops
from image_captioning_through_rl_tpu.train import optim as joptim
from image_captioning_through_rl_tpu.train import steps as jsteps
from image_captioning_through_rl_tpu_torch.data.coco import caption_lengths
from image_captioning_through_rl_tpu_torch.models import from_jax_params
from image_captioning_through_rl_tpu_torch.train import checkpoint as tckpt

from torch_multiprocess import run_world

V, F, T = 40, 16, 9
DIMS = {"wordvec_dim": 16, "hidden_dim": 16}
SEED = 3
BATCH = 8
PARAMS_TOL = dict(rtol=1e-4, atol=1e-6)


def _fields(seed=0, n_img=12, n_cap=27):
    rng = np.random.default_rng(seed)
    words = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(4, V)]
    caps = rng.integers(4, V, size=(n_cap, T)).astype(np.int32)
    caps[:, 0] = 1
    lens = rng.integers(3, T + 1, size=n_cap)
    caps[np.arange(n_cap), lens - 1] = 2
    caps[np.arange(T)[None, :] >= lens[:, None]] = 0
    urls = np.array([f"img{i}.jpg" for i in range(n_img)])
    feats = rng.standard_normal((n_img, F)).astype(np.float32)
    idxs = rng.integers(0, n_img, size=n_cap).astype(np.int32)
    return dict(train_captions=caps, train_image_idxs=idxs, val_captions=caps[:4],
                val_image_idxs=idxs[:4], train_features=feats, val_features=feats,
                word_to_idx={w: i for i, w in enumerate(words)},
                idx_to_word=dict(enumerate(words)), train_urls=urls, val_urls=urls,
                train_captions_lens=caption_lengths(caps),
                val_captions_lens=caption_lengths(caps[:4]))


def _log(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _close(got, want, **tol):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's single-process run: the three pretrainers one
    epoch each from their initialisers (plain XLA steps, per minibatch),
    then A2C plain and curriculum; and the inputs the workers start from."""
    d = tmp_path_factory.mktemp("jax_reference")
    fields = _fields()
    jdata = JCocoData(**fields)
    jcfg = jloops._cfg_for(jdata, False, DIMS)
    inits = {}
    for kind, mod, offset in (("reward", jreward, 0), ("policy", jpolicy, 1),
                              ("value", jvalue, 2)):
        path = d / f"init_{kind}.ckpt"
        tckpt.save_network(kind, from_jax_params(jax.tree.map(
            np.asarray, mod.init(jax.random.PRNGKey(SEED + offset), jcfg))), str(path))
        inits[kind] = str(path)
    with open(d / "fields.pkl", "wb") as f:
        pickle.dump(fields, f)
    paths = {f"{k}_network": str(d / f"{k}Network.ckpt") for k in ("reward", "policy", "value")}
    kw = dict(epochs=1, batch_size=BATCH, seed=SEED, net_dims=DIMS)
    out = {}
    for kind in ("reward", "policy", "value"):
        extra = {} if kind == "value" else {"fused_chain": False}
        out[kind] = getattr(jloops, f"train_{kind}_network")(
            jdata, paths, str(d / "pre"), False, device_data=False, chunk_steps=1, **extra, **kw)
    for name, curriculum in (("plain", None), ("curriculum", [4])):
        saves = {"model_path": str(d / f"model_{name}.ckpt"),
                 "results_path": str(d / f"results_{name}.txt")}
        net = dict(paths, a2c_network=str(d / f"a2c_{name}.ckpt"))
        out[name], _, _ = jloops.train_a2c_network(
            jdata, saves, net, str(d / name), False, curriculum=curriculum,
            fused_rollout=False, chunk_steps=1, **kw)
    return {"dir": d, "params": out, "inits": inits, "fields": str(d / "fields.pkl")}


@pytest.mark.parametrize("size,chunk_steps", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_trainers_in_a_world_match_the_jax_single_process_run(reference, size, chunk_steps,
                                                              tmp_path):
    res = tmp_path / "res"
    res.mkdir()
    run_world(size, "trainers", {"fields": reference["fields"], "inits": reference["inits"],
                                 "out": str(tmp_path / "out"), "res": str(res),
                                 "batch_size": BATCH, "seed": SEED, "dims": DIMS,
                                 "chunk_steps": chunk_steps}, tmp_path, timeout=240)
    ranks = []
    for rank in range(size):
        with open(res / f"rank{rank}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    for name in ("reward", "policy", "value", "plain", "curriculum"):
        for rank, got in enumerate(ranks):
            _close(got[name], reference["params"][name], err_msg=f"{name} rank {rank}",
                   **PARAMS_TOL)
    jdir, tdir = reference["dir"], tmp_path / "out" / "rank0"
    for sub in ("pre", "plain", "curriculum"):
        want, got = _log(jdir / sub / "metrics.jsonl"), _log(tdir / sub / "metrics.jsonl")
        assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
        np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want],
                                   rtol=1e-4)
    for name in ("plain", "curriculum"):
        assert ((tdir / f"results_{name}.txt").read_text()
                == (jdir / f"results_{name}.txt").read_text())
    assert {"rewardNetwork.ckpt", "a2c_plain.ckpt", "model_curriculum.ckpt"} <= {
        p.name for p in tdir.iterdir()}
    for rank in range(1, size):
        assert list((tmp_path / "out" / f"rank{rank}").iterdir()) == []


KW = dict(vocab_size=V, input_dim=F, wordvec_dim=16, hidden_dim=16, max_seq_len=T)
JCFG = jconfig.NetConfig(precision="highest", **KW)


@pytest.fixture(scope="module")
def step_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("steps")
    rng = np.random.default_rng(7)
    fields = _fields(seed=1, n_cap=8)
    caps = fields["train_captions"][:8]
    feats = rng.standard_normal((8, F)).astype(np.float32)
    jp = ja2c.init(jax.random.PRNGKey(1), JCFG)
    jr = jreward.init(jax.random.PRNGKey(2), JCFG)
    inp = {"cfg": KW, "feats": feats, "caps": caps, "key": [0, 17],
           "a2c": jax.tree.map(np.asarray, jp), "reward": jax.tree.map(np.asarray, jr),
           "caplen": int(np.max(np.argmax(caps == 2, axis=1)) + 1),
           "dfeats": rng.standard_normal((7, F)).astype(np.float32)}
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    return d / "inputs.pkl", inp, jp, jr


@pytest.mark.parametrize("size", [2, 4])
def test_sharded_steps_and_decodes_match_jax(step_inputs, size, tmp_path):
    path, inp, jp, jr = step_inputs
    res = tmp_path / "res"
    res.mkdir()
    run_world(size, "steps", {"inputs": str(path), "res": str(res)}, tmp_path)
    feats, caps = jnp.asarray(inp["feats"]), jnp.asarray(inp["caps"])
    loss, grads = jax.value_and_grad(jsteps.reward_loss)(jr, JCFG, feats, caps)
    key = jax.random.PRNGKey(17)
    _, _, actions, _ = jrollout(jp, JCFG, feats, caps, jnp.int32(1), key, block_n=8,
                                weight_dtype=jnp.float32, interpret=True)
    mesh = jmake_mesh((size,), ("data",), devices=jax.devices()[:size])
    tx = joptim.adam(1e-3)
    start = jnp.ones(7, jnp.int32)
    dfeats = jnp.asarray(inp["dfeats"])
    greedy = np.asarray(jgreedy_decode(jp["policy"], JCFG, dfeats, start))
    btoks, bscores = jbeam_search(jp["policy"], jp["value"], JCFG,
                                  jconfig.DecodeConfig(beam_size=3, max_seq_len=T), dfeats, start)
    sampled = np.asarray(jsample.sample_decode_n(jp["policy"], JCFG, dfeats, start,
                                                 jax.random.PRNGKey(5), 4, temperature=1.1,
                                                 top_k=40, top_p=jnp.float32(0.9)))
    for rank in range(size):
        with open(res / f"rank{rank}.pkl", "rb") as f:
            got = pickle.load(f)
        np.testing.assert_allclose(got["vse_loss"], float(loss), rtol=1e-5)
        for a, b in zip(got["vse_grads"], _leaves(grads)):
            # rtol 1e-5 of the leaf's scale: entries near 0 carry its rounding
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
        np.testing.assert_array_equal(got["actions"], np.asarray(actions))
        for name, curr in (("sampled", 1), ("window", inp["caplen"])):
            step = jshard_map_step(JCFG, tx, mesh)
            new, _, stats = step(jreplicate(mesh, jp), jreplicate(mesh, tx.init(jp)),
                                 jreplicate(mesh, jr), *jshard_batch(mesh, feats, caps),
                                 jnp.int32(curr), key)
            params, loss_got = got[f"shard_map_{name}"]
            _close(params, new, err_msg=name, **PARAMS_TOL)
            np.testing.assert_allclose(loss_got, float(stats.loss), rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(got["greedy"], greedy)
        np.testing.assert_array_equal(got["beam"][0], np.asarray(btoks))
        np.testing.assert_allclose(got["beam"][1], np.asarray(bscores), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got["sample"], sampled)


def test_sync_load_takes_rank_0s_answer(tmp_path):
    """Rank 0 missing the checkpoint (only rank 1 has one) raises on every
    rank, a corrupt file on rank 0 raises on every rank, a file only rank 0
    has loads on every rank (the port's counterpart of the JAX package's
    ``tests/test_multihost.py`` load cases); none hangs."""
    cfg = dict(KW)
    tree = from_jax_params(jax.tree.map(np.asarray,
                                        jpolicy.init(jax.random.PRNGKey(3), JCFG)))
    for rank in (0, 1):
        (tmp_path / f"r{rank}").mkdir()
    tckpt.save_network("policy", tree, str(tmp_path / "r1" / "only1.ckpt"))
    tckpt.save_network("policy", tree, str(tmp_path / "r0" / "only0.ckpt"))
    (tmp_path / "r0" / "bad.ckpt").write_bytes(b"not a checkpoint")
    tckpt.save_network("policy", tree, str(tmp_path / "r1" / "bad.ckpt"))
    cases = {name: str(tmp_path / "r{rank}" / f"{name}.ckpt")
             for name in ("only1", "only0", "bad")}
    res = tmp_path / "res"
    res.mkdir()
    run_world(2, "sync_load", {"cfg": cfg, "cases": cases, "res": str(res)}, tmp_path,
              timeout=120)
    want_sums = [float(x.sum()) for x in jax.tree.leaves(
        {k: tree[k] for k in sorted(tree)}, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    outs = []
    for rank in (0, 1):
        with open(res / f"rank{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    for rank, got in enumerate(outs):
        assert got["only1"] == ("raised", "FileNotFoundError"), rank
        assert got["only1_exists"] is False and got["only0_exists"] is True
        assert got["only0"][0] == "loaded"
        np.testing.assert_allclose(sorted(got["only0"][1]), sorted(want_sums), rtol=1e-6)
        assert got["bad"][0] == "raised"
    assert outs[1]["bad"] == ("raised", "RuntimeError")  # rank 0's own error is its own
