"""The port's tensor parallelism over the vocabulary (a ``("data", "model")``
mesh) vs the JAX package's single-device program.

Worlds of 2 ranks, a ``(1, 2)`` mesh (vocab blocks of 20), and of 4 ranks,
a ``(2, 2)`` mesh (4 rows and 20 columns a rank), of
``torch_multiprocess.py`` over gloo on the CPU. On ``shard_params(*_spec)``
trees each world takes three Adam steps of the reward, policy and value
steps (plain, and fused through the chains' plain twins with float32
weights, and the plain ones as one chunk of three updates, equal to the
steps bit for bit; a captured chunk is refused over gloo; the fused losses'
reduced gradients, gathered, against JAX's, which Adam's scale-blind update
would not show) and of A2C plain
and curriculum ``[3]``; the parameters, gathered,
match the JAX steps on the whole minibatches at rtol 1e-4, atol 1e-6, the
losses at rtol 1e-4 (the vocab-parallel log-softmax sums its exponentials
block by block), and the actions of each A2C run's first step, gathered,
equal JAX's bit for bit. The fused rollout refuses a sharded tree. With
replicated parameters the VSE loss and gradient are reduced over the data
group (over the world they would be M times the gradient); ``gather_params``
returns the tree bit for bit; a sharded checkpoint write has the bytes of
the unsharded one; a sharded policy decodes JAX's greedy tokens; and, in
the world of 4, one policy trainer epoch with replicated parameters matches
the JAX single-process trainer. In this process: the mesh and its groups'
layout, ``shard_params`` placement, ``V % M``, the batcher's rows on a 2-D
mesh, a mesh without a ``data`` axis, and the noise kernel's column window
in its plain version against ``jax.random``'s columns (the bits bit for bit,
the Gumbel noise within 4 ulps as ``tests/test_torch_prng.py`` holds it, and
equal to the whole plain draw's columns bit for bit).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import config as jconfig
from image_captioning_through_rl_tpu.data.coco import CocoData as JCocoData
from image_captioning_through_rl_tpu.decode import greedy_decode as jgreedy_decode
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu.models import reward as jreward
from image_captioning_through_rl_tpu.ops.pallas_rollout import fused_rollout as jrollout
from image_captioning_through_rl_tpu.train import loops as jloops
from image_captioning_through_rl_tpu.train import optim as joptim
from image_captioning_through_rl_tpu.train import steps as jsteps
from image_captioning_through_rl_tpu_torch import parallel
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.data.coco import CocoData, caption_lengths
from image_captioning_through_rl_tpu_torch.data.device import DeviceCocoTables, HostCocoTables
from image_captioning_through_rl_tpu_torch.models import from_jax_params
from image_captioning_through_rl_tpu_torch.models import policy as tpolicy
from image_captioning_through_rl_tpu_torch.ops import prng
from image_captioning_through_rl_tpu_torch.parallel import hostbatch
from image_captioning_through_rl_tpu_torch.parallel import mesh as tmesh
from image_captioning_through_rl_tpu_torch.parallel import sharding
from image_captioning_through_rl_tpu_torch.train import checkpoint as tckpt

from torch_multiprocess import run_world

V, F, T, N = 40, 16, 9, 8
KW = dict(vocab_size=V, input_dim=F, wordvec_dim=16, hidden_dim=16, max_seq_len=T)
JCFG = jconfig.NetConfig(precision="highest", **KW)
LR = 1e-3
CURRICULUM = 3
PARAMS_TOL = dict(rtol=1e-4, atol=1e-6)
DIMS = {"wordvec_dim": 16, "hidden_dim": 16}
SEED = 3


def _captions(rng, n):
    caps = rng.integers(4, V, size=(n, T)).astype(np.int32)
    caps[:, 0] = 1
    lens = rng.integers(3, T + 1, size=n)
    caps[np.arange(n), lens - 1] = 2
    caps[np.arange(T)[None, :] >= lens[:, None]] = 0
    return caps


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _close(got, want, what, **tol):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, err_msg=f"{what} leaf {i}", **tol)


def _fields(seed=0, n_img=12, n_cap=27):
    rng = np.random.default_rng(seed)
    words = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(4, V)]
    caps = _captions(rng, n_cap)
    urls = np.array([f"img{i}.jpg" for i in range(n_img)])
    feats = rng.standard_normal((n_img, F)).astype(np.float32)
    idxs = rng.integers(0, n_img, size=n_cap).astype(np.int32)
    return dict(train_captions=caps, train_image_idxs=idxs, val_captions=caps[:4],
                val_image_idxs=idxs[:4], train_features=feats, val_features=feats,
                word_to_idx={w: i for i, w in enumerate(words)},
                idx_to_word=dict(enumerate(words)), train_urls=urls, val_urls=urls,
                train_captions_lens=caption_lengths(caps),
                val_captions_lens=caption_lengths(caps[:4]))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The inputs the worlds start from, and the JAX single-device runs."""
    d = tmp_path_factory.mktemp("tp_reference")
    rng = np.random.default_rng(11)
    jp = ja2c.init(jax.random.PRNGKey(1), JCFG)
    jr = jreward.init(jax.random.PRNGKey(2), JCFG)
    batches = [(rng.standard_normal((N, F)).astype(np.float32), _captions(rng, N))
               for _ in range(3)]
    keys = [np.asarray(jax.random.PRNGKey(20 + i), np.uint32) for i in range(3)]
    inp = {"cfg": KW, "lr": LR, "batches": batches, "prefixes": [3, 9, 6],
           "keys": [k.tolist() for k in keys], "curriculum": CURRICULUM,
           "a2c": jax.tree.map(np.asarray, jp), "reward": jax.tree.map(np.asarray, jr),
           "policy": jax.tree.map(np.asarray, jp["policy"]),
           "value": jax.tree.map(np.asarray, jp["value"]),
           "dfeats": rng.standard_normal((6, F)).astype(np.float32)}
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)

    want = {}
    for kind, params in (("reward", jr), ("policy", jp["policy"]), ("value", jp["value"])):
        tx = joptim.adam(LR, params)
        opt, losses = tx.init(params), []
        if kind == "value":
            step = jsteps.make_value_step(JCFG, tx)
            for (f, c), pl in zip(batches, inp["prefixes"]):
                params, opt, loss = step(params, opt, jp["policy"], jr, jnp.asarray(f),
                                         jnp.asarray(c), jnp.int32(pl))
                losses.append(float(loss))
        else:
            make = jsteps.make_reward_step if kind == "reward" else jsteps.make_policy_step
            step = make(JCFG, tx)
            for f, c in batches:
                params, opt, loss = step(params, opt, jnp.asarray(f), jnp.asarray(c))
                losses.append(float(loss))
        want[kind] = (losses, params)
    for name, per_step_mean, curr in (("plain", False, 1), ("curriculum", True, CURRICULUM)):
        params, tx = jp, joptim.adam(LR, jp)
        opt, losses = tx.init(params), []
        step = jsteps.make_a2c_step(JCFG, tx, per_step_mean=per_step_mean)
        for (f, c), key in zip(batches, keys):
            params, opt, stats = step(params, opt, jr, jnp.asarray(f), jnp.asarray(c),
                                      jnp.int32(curr), jnp.asarray(key))
            losses.append(float(stats.loss))
        _, _, actions, _ = jrollout(jp, JCFG, jnp.asarray(batches[0][0]),
                                    jnp.asarray(batches[0][1]), jnp.int32(curr),
                                    jnp.asarray(keys[0]), block_n=8, weight_dtype=jnp.float32,
                                    interpret=True)
        want[f"a2c_{name}"] = (losses, params, np.asarray(actions))
    f, c = batches[0]
    vse_loss, vse_grads = jax.value_and_grad(jsteps.reward_loss)(jr, JCFG, jnp.asarray(f),
                                                               jnp.asarray(c))
    want["vse"] = (float(vse_loss), vse_grads)
    want["reward_grads"] = want["vse"]
    want["policy_grads"] = jax.value_and_grad(jsteps.policy_loss)(
        jp["policy"], JCFG, jnp.asarray(f), jnp.asarray(c), jsteps.batch_caption_lens(c))
    want["greedy"] = np.asarray(jgreedy_decode(jp["policy"], JCFG, jnp.asarray(inp["dfeats"]),
                                               jnp.ones(6, jnp.int32)))
    tree = from_jax_params(jax.tree.map(np.asarray, jp))
    for suffix in ("ckpt", "pt"):
        tckpt.save_network("a2c", tree, str(d / f"whole.{suffix}"))

    # the trainer epoch: the JAX single-process policy trainer from one init
    fields = _fields()
    with open(d / "fields.pkl", "wb") as fh:
        pickle.dump(fields, fh)
    jdata = JCocoData(**fields)
    jcfg = jloops._cfg_for(jdata, False, DIMS)
    init = d / "init_policy.ckpt"
    tckpt.save_network("policy", from_jax_params(jax.tree.map(
        np.asarray, ja2c.policy_mod.init(jax.random.PRNGKey(SEED + 1), jcfg))), str(init))
    paths = {f"{k}_network": str(d / f"{k}Network.ckpt") for k in ("reward", "policy", "value")}
    want["trainer"] = jloops.train_policy_network(
        jdata, paths, str(d / "pre"), False, epochs=1, batch_size=N, seed=SEED, net_dims=DIMS,
        device_data=False, chunk_steps=1, fused_chain=False)
    return {"dir": d, "inputs": str(d / "inputs.pkl"), "want": want,
            "trainer": {"fields": str(d / "fields.pkl"), "init": str(init), "batch_size": N,
                        "seed": SEED, "dims": DIMS}}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_vocab_sharded_steps_in_a_world_match_jax(reference, shape, tmp_path):
    size = shape[0] * shape[1]
    res = tmp_path / "res"
    res.mkdir()
    args = {"inputs": reference["inputs"], "res": str(res), "shape": list(shape)}
    if size == 4:
        args["trainer"] = dict(reference["trainer"], out=str(tmp_path / "out"))
    run_world(size, "tensor_parallel", args, tmp_path, timeout=240)
    want = reference["want"]
    for rank in range(size):
        with open(res / f"rank{rank}.pkl", "rb") as f:
            got = pickle.load(f)
        d, m = rank // shape[1], rank % shape[1]
        cols = V // shape[1]
        rows = N // shape[0]
        assert got["coords"] == {"data": d, "model": m}
        assert got["rows"] == (d * rows, (d + 1) * rows)
        assert got["vocab"] == (m * cols, (m + 1) * cols, V, shape[1])
        for kind in ("reward", "policy", "value"):
            for route in ("plain", "fused"):
                losses, params = got[f"{kind}_{route}"]
                np.testing.assert_allclose(losses, want[kind][0], rtol=1e-4,
                                           err_msg=f"{kind} {route} rank {rank}")
                _close(params, want[kind][1], f"{kind} {route} rank {rank}", **PARAMS_TOL)
            chunked = got[f"{kind}_chunk"]  # the chunk's updates are the steps', op for op
            for x, y in zip(_leaves(chunked), _leaves(got[f"{kind}_plain"][1])):
                assert np.array_equal(x, y), f"{kind} chunk rank {rank}"
        assert "cannot be captured" in got["graph_chunk"]
        for name in ("plain", "curriculum"):
            losses, params, actions = got[f"a2c_{name}"]
            np.testing.assert_allclose(losses, want[f"a2c_{name}"][0], rtol=1e-4,
                                       err_msg=f"a2c {name} rank {rank}")
            _close(params, want[f"a2c_{name}"][1], f"a2c {name} rank {rank}", **PARAMS_TOL)
            np.testing.assert_array_equal(actions, want[f"a2c_{name}"][2])
        assert "no cross-rank combine" in got["fused_rollout"]
        for kind in ("reward", "policy"):  # the fused losses' gradients, gathered
            loss, grads = got[f"{kind}_grads"]
            np.testing.assert_allclose(loss, float(want[f"{kind}_grads"][0]), rtol=1e-5)
            _close(grads, want[f"{kind}_grads"][1], f"{kind} gradient rank {rank}",
                   **PARAMS_TOL)
        loss, grads = got["vse"]
        np.testing.assert_allclose(loss, want["vse"][0], rtol=1e-5)
        for a, b in zip(grads, _leaves(want["vse"][1])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
        with open(reference["inputs"], "rb") as f:
            inp = pickle.load(f)
        for a, b in zip(_leaves(got["round_trip"]), _leaves(inp["a2c"])):
            assert np.array_equal(a, b)
        np.testing.assert_array_equal(got["greedy"], want["greedy"])
        if size == 4:
            _close(got["trainer"], want["trainer"], f"policy trainer rank {rank}", **PARAMS_TOL)
    for suffix in ("ckpt", "pt"):
        assert ((res / f"sharded.{suffix}").read_bytes()
                == (reference["dir"] / f"whole.{suffix}").read_bytes())
    if size == 4:
        assert (tmp_path / "out" / "rank0" / "policyNetwork.ckpt").exists()
        for rank in range(1, size):
            assert list((tmp_path / "out" / f"rank{rank}").iterdir()) == []


# ---- in this process: placement, layout, the batcher, the noise window ----

def _a2c_tree():
    return from_jax_params(jax.tree.map(np.asarray, ja2c.init(jax.random.PRNGKey(1), JCFG)))


@pytest.mark.parametrize("model", [2, 4])
def test_shard_params_places_vocab_blocks_on_one_process(model, tmp_path):
    tree = _a2c_tree()
    mesh = parallel.make_mesh((8 // model, model), ("data", "model"), devices=["cpu"] * 8)
    blocks = parallel.shard_params(mesh, tree, parallel.a2c_param_spec(tree))
    assert isinstance(blocks, parallel.LocalBlocks) and sorted(blocks) == list(range(model))
    cols = V // model
    for m, b in blocks.items():
        sl = slice(m * cols, (m + 1) * cols)
        assert b.vocab[:4] == (m * cols, (m + 1) * cols, V, model)
        assert torch.equal(b["policy"]["embedding"], tree["policy"]["embedding"][sl])
        assert torch.equal(b["value"]["embedding"], tree["value"]["embedding"][sl])
        assert torch.equal(b["policy"]["head"]["w"], tree["policy"]["head"]["w"][:, sl])
        assert torch.equal(b["policy"]["head"]["b"], tree["policy"]["head"]["b"][sl])
        assert torch.equal(b["policy"]["lstm"]["wh"], tree["policy"]["lstm"]["wh"])
        assert isinstance(b["policy"], parallel.Sharded) and not isinstance(
            b["policy"]["lstm"], parallel.Sharded)
    whole = parallel.gather_params(blocks)
    for a, b in zip(jax.tree.leaves(whole), jax.tree.leaves(tree)):
        assert torch.equal(a, b)
    # a block of one process has no group to combine its logits over
    cfg = NetConfig(**KW)
    with pytest.raises(ValueError, match="gather the tree"):
        tpolicy.forward(blocks[0]["policy"], cfg, torch.zeros((2, F)),
                        torch.ones((2, 3), dtype=torch.long))
    # a snapshot holds whole trees only
    with pytest.raises(ValueError, match="snapshot holds whole trees"):
        tckpt.save_train_state(str(tmp_path / "blocks.trainstate"), blocks[0], None,
                               np.zeros(2, np.uint32), {})
    # a decode gathers it: the tokens of the whole tree
    pblocks = parallel.shard_params(mesh, tree["policy"], parallel.policy_param_spec(
        tree["policy"]))
    feats, start = np.random.default_rng(0).standard_normal((4, F)).astype(np.float32), \
        np.ones(4, np.int32)
    assert torch.equal(
        parallel.sharded_greedy_tokens(mesh, pblocks, cfg, feats, start),
        parallel.sharded_greedy_tokens(parallel.make_mesh(devices=["cpu"]), tree["policy"],
                                       cfg, feats, start))


def test_shard_params_refuses_a_vocabulary_the_model_axis_does_not_divide():
    tree = _a2c_tree()
    mesh = parallel.make_mesh((1, 3), ("data", "model"), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="should be divisible by 3, but it is equal to 40"):
        parallel.shard_params(mesh, tree, parallel.a2c_param_spec(tree))
    one = parallel.make_mesh((3, 1), ("data", "model"), devices=["cpu"] * 3)
    assert isinstance(parallel.shard_params(one, tree, parallel.a2c_param_spec(tree)),
                      sharding.Replicated)


class _RankMesh(tmesh.Mesh):
    """A mesh of ranks, one CPU entry each, without a process group."""

    def __init__(self, shape, names):
        devs = np.empty(int(np.prod(shape)), dtype=object)
        devs[:] = [torch.device("cpu")] * devs.size
        super().__init__(devs.reshape(shape), names, np.arange(devs.size).reshape(shape))


def test_global_batcher_rows_go_by_the_data_coordinate(monkeypatch):
    """On a (2, 2) mesh the model ranks of a data block hold the same rows
    (the JAX ``local_rows`` de-duplication); the shard's size is the data
    axis'."""
    caps = np.arange(8 * 3).reshape(8, 3)
    chunk = np.arange(2 * 8 * 3).reshape(2, 8, 3)
    mesh = _RankMesh((2, 2), ("data", "model"))
    for rank in range(4):
        monkeypatch.setattr(hostbatch, "world", lambda rank=rank: (rank, 4))
        monkeypatch.setattr(tmesh, "world", lambda rank=rank: (rank, 1))
        b = parallel.GlobalBatcher(mesh)
        lo, hi = (rank // 2) * 4, (rank // 2 + 1) * 4
        assert b.local_rows(8) == (lo, hi)
        shard = b.row_shard(8)
        assert (shard.lo, shard.hi, shard.n, shard.size) == (lo, hi, 8, 2)
        np.testing.assert_array_equal(b.shard(caps), caps[lo:hi])
        np.testing.assert_array_equal(b.shard_stacked(chunk), chunk[:, lo:hi])
        assert b.local_rows(7) == (0, 7) and b.row_shard(7) is None


def test_a_mesh_without_a_data_axis_replicates_rows_and_parameters(monkeypatch):
    """``replicate`` and the batcher on a model-only mesh (JAX
    ``tests/test_parallel.py:292-300``), and both device tables with
    ``mesh=`` there: every rank the whole batch (JAX
    ``tests/test_device_data.py:65-72``)."""
    mesh = parallel.make_mesh((8,), ("model",), devices=["cpu"] * 8)
    tree = {"w": torch.ones((4, 4))}
    rep = parallel.replicate(mesh, tree)
    assert torch.equal(next(iter(rep.values()))["w"], tree["w"])
    assert parallel.GlobalBatcher(mesh).replicate({"w": torch.ones(2)})["w"].tolist() == [1, 1]
    ranked = _RankMesh((4,), ("model",))
    monkeypatch.setattr(hostbatch, "world", lambda: (3, 4))
    b = parallel.GlobalBatcher(ranked)
    assert b.local_rows(8) == (0, 8) and b.row_shard(8) is None
    fields = _fields()
    data = CocoData(**fields)
    for tables in (DeviceCocoTables(data, "train", device="cpu", mesh=mesh),
                   HostCocoTables(data, "train", device="cpu", mesh=mesh)):
        caps_b, feats_b = tables.gather(np.arange(6))
        assert caps_b.shape == (6, T) and feats_b.shape == (6, F)
        np.testing.assert_array_equal(caps_b.numpy(), fields["train_captions"][:6])
        n = sum(c.shape[0] for c, _ in tables.minibatches(16, rng=np.random.default_rng(0)))
        assert n == tables.num_captions


@pytest.mark.parametrize("rows,cols", [((0, 5), (0, 40)), ((0, 5), (20, 40)), ((2, 4), (7, 26)),
                                       ((5, 6), (39, 40))])
def test_noise_window_is_the_columns_of_jax_gumbel(rows, cols):
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.random.gumbel(key, (6, V)))[rows[0]:rows[1], cols[0]:cols[1]]
    k = np.asarray(key, np.uint32)
    shape = (rows[1] - rows[0], cols[1] - cols[0])
    got = prng.gumbel(k, shape, device="cpu", row0=rows[0], col0=cols[0], width=V)
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))  # torch's log against XLA's
    assert np.all(np.abs(got.numpy() - want) <= 4 * ulp)
    whole = prng.gumbel(k, (6, V), device="cpu")[rows[0]:rows[1], cols[0]:cols[1]]
    assert torch.equal(got, whole)
    bits = np.asarray(jax.random.bits(key, (6, V)))[rows[0]:rows[1], cols[0]:cols[1]]
    np.testing.assert_array_equal(prng.random_bits(k, shape, "cpu", rows[0], cols[0], V).numpy(),
                                  bits.astype(np.int64))
    with pytest.raises(ValueError, match="do not fit"):
        prng.gumbel(k, shape, device="cpu", col0=cols[0] + 1, width=cols[1])
