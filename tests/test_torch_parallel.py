"""The port's parallel layer in one process vs the JAX package.

The noise with a first global row: ``random_bits``, ``gumbel_noise_plain``,
``categorical`` and ``sample_categorical`` at ``row0`` are rows ``[row0,
row0 + n)`` of the draw of the global shape (the bits and the tokens bit for
bit against ``jax.random``; the Gumbel floats bit for bit against the port's
own global draw and within ``test_torch_prng.py``'s 4-ulp rule against
``jax.random.gumbel``, whose logs XLA rounds its own way), and ``fold_in``
is ``jax.random.fold_in``. Sharded decoding over meshes of 2, 4 and 8 CPU
entries (the CPU is one torch device, listed repeatedly, as the JAX tests
list 8 virtual devices): greedy, the per-sample beam and sampling
(unfiltered, and top-k 40 with nucleus 0.9 at R = 4) at ragged N, tokens
equal to the JAX package's single-device decodes at ``precision="highest"``
and to the port's unsharded ones, beam scores within 1e-5; the JAX
package's padded-row property (``tests/test_parallel.py``) and the Q2
refusal. The mesh, the batcher's row blocks, the specs and the launch
environment's checks. The multi-process worlds are
``test_torch_multiprocess.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import config as jconfig
from image_captioning_through_rl_tpu import parallel as jparallel
from image_captioning_through_rl_tpu.decode import beam_search as jbeam_search
from image_captioning_through_rl_tpu.decode import greedy_decode as jgreedy_decode
from image_captioning_through_rl_tpu.decode import sample as jsample
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu_torch import parallel
from image_captioning_through_rl_tpu_torch.config import DecodeConfig, NetConfig
from image_captioning_through_rl_tpu_torch.models import from_jax_params
from image_captioning_through_rl_tpu_torch.ops import prng
from image_captioning_through_rl_tpu_torch.ops.fused_beam import (fused_beam_search,
                                                                  prepare_beam_weights)
from image_captioning_through_rl_tpu_torch.ops.fused_decode import (fused_greedy_decode,
                                                                    prepare_greedy_weights)
from image_captioning_through_rl_tpu_torch.ops.fused_sample import fused_sample_decode
from image_captioning_through_rl_tpu_torch.ops.sampling import sample_categorical
from image_captioning_through_rl_tpu_torch.parallel import collectives, hostbatch, mesh as tmesh
from image_captioning_through_rl_tpu_torch.parallel import sharding
from image_captioning_through_rl_tpu_torch.train import steps

torch.set_num_threads(1)

KW = dict(vocab_size=60, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=7)
JCFG = jconfig.NetConfig(precision="highest", **KW)
TCFG = NetConfig(**KW)
T, V = KW["max_seq_len"], KW["vocab_size"]
BEAM = 3


@pytest.fixture(scope="module")
def params():
    jp = ja2c.init(jax.random.PRNGKey(0), JCFG)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _feats(n, seed=0):
    feats = np.random.default_rng(seed).standard_normal((n, KW["input_dim"])).astype(np.float32)
    return feats, np.ones(n, np.int32)


def _cpu_mesh(size):
    return parallel.make_mesh(devices=["cpu"] * size)


# ---- the noise at a first global row ----

@pytest.mark.parametrize("row0,n", [(0, 5), (3, 5), (7, 1), (12, 4)])
def test_random_bits_row0_are_rows_of_the_global_draw(row0, n):
    key = prng.split(prng.PRNGKey(11), 2)[1]
    want = np.asarray(jax.random.bits(jnp.asarray(key), (row0 + n, V), jnp.uint32))
    got = prng.random_bits(key, (n, V), row0=row0)
    np.testing.assert_array_equal(got.numpy(), want[row0:].astype(np.int64))


@pytest.mark.parametrize("row0,n", [(0, 6), (5, 6), (9, 3)])
def test_gumbel_noise_plain_row0_are_rows_of_the_global_draw(row0, n):
    keys = prng.split(prng.PRNGKey(4), 3)
    whole = prng.gumbel_noise_plain(keys, (row0 + n, V))
    got = prng.gumbel_noise_plain(keys, (n, V), row0=row0)
    torch.testing.assert_close(got, whole[:, row0:], rtol=0, atol=0)
    for k, key in enumerate(keys):
        want = np.asarray(jax.random.gumbel(jnp.asarray(key), (row0 + n, V)))[row0:]
        ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
        assert np.all(np.abs(got[k].numpy() - want) <= 4 * ulp)


@pytest.mark.parametrize("row0,n", [(0, 8), (8, 8), (3, 13)])
def test_categorical_row0_draws_the_global_tokens(row0, n):
    key = prng.PRNGKey(21)
    logits = np.random.default_rng(row0).standard_normal((row0 + n, V)).astype(np.float32)
    want = np.asarray(jax.random.categorical(jnp.asarray(key), jnp.asarray(logits)))
    local = torch.from_numpy(logits[row0:])
    np.testing.assert_array_equal(prng.categorical(key, local, row0=row0).numpy(), want[row0:])
    np.testing.assert_array_equal(sample_categorical(key, local, row0=row0).numpy(),
                                  want[row0:])


@pytest.mark.parametrize("data", [0, 1, 3, 7, 12345, 2**31 - 1])
def test_fold_in_matches_jax(data):
    for seed in (0, 9):
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        got = prng.fold_in(prng.PRNGKey(seed), data)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


def test_the_counter_check_takes_the_global_draw(params):
    prng.random_bits(prng.PRNGKey(0), (1, 4), row0=2**30 - 2)  # 2**32 - 4 elements fit
    with pytest.raises(ValueError, match="64-bit counters"):
        prng.random_bits(prng.PRNGKey(0), (1, 4), row0=2**30 - 1)
    with pytest.raises(ValueError, match="row0"):
        prng.random_bits(prng.PRNGKey(0), (1, 4), row0=-1)
    gw = prepare_greedy_weights(params[1]["policy"], torch.float32)
    with pytest.raises(ValueError, match="counter space"):
        fused_sample_decode(gw, torch.zeros((2, 4)), torch.ones(2, dtype=torch.int32),
                            prng.PRNGKey(0), row0=2**32)


# ---- sharded decoding against JAX, one process ----

@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("n", [1, 5, 13])
def test_sharded_greedy_and_beam_match_jax(params, size, n):
    jp, tp = params
    feats, start = _feats(n, seed=n)
    jf, js = jnp.asarray(feats), jnp.asarray(start)
    mesh = _cpu_mesh(size)
    want = np.asarray(jgreedy_decode(jp["policy"], JCFG, jf, js))
    got = parallel.sharded_greedy_tokens(mesh, tp["policy"], TCFG, feats, start)
    gw = prepare_greedy_weights(tp["policy"], torch.float32)
    one = fused_greedy_decode(gw, torch.from_numpy(feats), torch.from_numpy(start), T)
    assert got.dtype == torch.int32 and got.shape == (n, T)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), one.numpy())

    dcfg = DecodeConfig(beam_size=BEAM, max_seq_len=T)
    jtoks, jscores = jbeam_search(jp["policy"], jp["value"], JCFG,
                                  jconfig.DecodeConfig(beam_size=BEAM, max_seq_len=T), jf, js)
    toks, scores = parallel.sharded_beam_tokens(mesh, tp["policy"], tp["value"], TCFG, dcfg,
                                                feats, start)
    one_t, one_s = fused_beam_search(prepare_beam_weights(gw, tp["value"]),
                                     torch.from_numpy(feats), torch.from_numpy(start),
                                     max_len=T, beam=BEAM)
    assert toks.shape == (n, BEAM, T) and scores.shape == (n, BEAM)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(toks.numpy(), one_t.numpy())
    # the CPU's products round by batch shape: a block's sums may end an ulp away
    np.testing.assert_allclose(scores.numpy(), one_s.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("k,p,r", [(0, None, 1), (40, 0.9, 4)])
def test_sharded_sample_matches_jax(params, size, k, p, r):
    jp, tp = params
    n = 7
    feats, start = _feats(n, seed=30 + size)
    jkey = jax.random.PRNGKey(5)
    kw = dict(temperature=1.1, top_k=k)
    want = np.asarray(jsample.sample_decode_n(jp["policy"], JCFG, jnp.asarray(feats),
                                              jnp.asarray(start), jkey, r,
                                              top_p=None if p is None else jnp.float32(p), **kw))
    got = parallel.sharded_sample_tokens(_cpu_mesh(size), tp["policy"], TCFG, feats, start,
                                         prng.PRNGKey(5), r, top_p=p, **kw)
    gw = prepare_greedy_weights(tp["policy"], torch.float32)
    one = fused_sample_decode(gw, torch.from_numpy(feats).repeat_interleave(r, 0),
                              torch.from_numpy(start).repeat_interleave(r, 0), prng.PRNGKey(5),
                              max_len=T, top_p=p, **kw)
    want = want[:, 0] if r == 1 else want
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.reshape(n * r, T).numpy(), one.numpy())


@pytest.mark.parametrize("size", [2, 4, 8])
def test_padded_rows_never_leak_any_remainder(params, size):
    """The JAX package's property (``tests/test_parallel.py``): the rows the
    data axis pads with (repeats of the last row) never reach the output,
    for every remainder: 1, size - 1 and size + 1 rows, greedy, beam and
    two samples a row, each equal to the unsharded decode of the same
    rows."""
    _, tp = params
    mesh = _cpu_mesh(size)
    gw = prepare_greedy_weights(tp["policy"], torch.float32)
    bw = prepare_beam_weights(gw, tp["value"])
    dcfg = DecodeConfig(beam_size=BEAM, max_seq_len=T)
    for n in sorted({1, size - 1, size + 1} - {0}):
        feats, start = _feats(n, seed=100 + n)
        f, s = torch.from_numpy(feats), torch.from_numpy(start)
        np.testing.assert_array_equal(
            parallel.sharded_greedy_tokens(mesh, tp["policy"], TCFG, feats, start).numpy(),
            fused_greedy_decode(gw, f, s, T).numpy(), err_msg=f"greedy n={n}")
        got_t, got_s = parallel.sharded_beam_tokens(mesh, tp["policy"], tp["value"], TCFG, dcfg,
                                                    feats, start)
        ref_t, ref_s = fused_beam_search(bw, f, s, max_len=T, beam=BEAM)
        np.testing.assert_array_equal(got_t.numpy(), ref_t.numpy(), err_msg=f"beam n={n}")
        np.testing.assert_allclose(got_s.numpy(), ref_s.numpy(), rtol=1e-6)
        got_n = parallel.sharded_sample_tokens(mesh, tp["policy"], TCFG, feats, start,
                                               prng.PRNGKey(9), 2, temperature=0.9, top_k=5)
        ref_n = fused_sample_decode(gw, f.repeat_interleave(2, 0), s.repeat_interleave(2, 0),
                                    prng.PRNGKey(9), max_len=T, temperature=0.9, top_k=5)
        np.testing.assert_array_equal(got_n.reshape(2 * n, T).numpy(), ref_n.numpy(),
                                      err_msg=f"sample n={n}")


def test_sharded_beam_refuses_the_faithful_mode(params):
    _, tp = params
    feats, start = _feats(4)
    dcfg = DecodeConfig(max_seq_len=T, per_sample_beams=False)
    with pytest.raises(ValueError, match="per-sample beams"):
        parallel.sharded_beam_tokens(_cpu_mesh(2), tp["policy"], tp["value"], TCFG, dcfg, feats,
                                     start)


def test_replicate_commits_once_and_passes_through(params):
    _, tp = params
    mesh = _cpu_mesh(4)
    rep = parallel.replicate(mesh, tp["policy"])
    assert list(rep) == [torch.device("cpu")]  # one copy a distinct device
    assert parallel.replicate(mesh, rep) is rep
    other = parallel.replicate(_cpu_mesh(2), rep)
    assert other is not rep and other.mesh is not mesh
    toks = parallel.sharded_greedy_tokens(mesh, rep, TCFG, *_feats(6))
    assert len(rep.cache) == 1  # the kernel layout, made once
    parallel.sharded_greedy_tokens(mesh, rep, TCFG, *_feats(6))
    assert len(rep.cache) == 1 and toks.shape == (6, T)


# ---- the mesh, the batcher, the specs, the launch environment ----

def test_make_mesh_checks_like_jax():
    mesh = parallel.make_mesh(devices=["cpu"] * 6)
    assert mesh.shape == {"data": 6} and not mesh.spans_processes
    assert mesh.local_devices == [torch.device("cpu")] * 6
    with pytest.raises(ValueError, match="does not cover"):
        parallel.make_mesh((4,), devices=["cpu"] * 6)
    with pytest.raises(ValueError, match="same rank"):
        parallel.make_mesh((6,), ("data", "model"), devices=["cpu"] * 6)
    two_d = parallel.make_mesh((3, 2), ("data", "model"), devices=["cuda:0", "cpu"] * 3)
    assert two_d.shape == {"data": 3, "model": 2} and not two_d.spans_processes
    assert two_d.entries("data") == [torch.device("cuda:0")] * 3
    assert two_d.entries("model") == [torch.device("cuda:0"), torch.device("cpu")]
    assert two_d.coords is None and two_d.group("model") is None
    assert parallel.make_mesh((6, 1), ("data", "model"), devices=["cpu"] * 6).shape == \
        {"data": 6, "model": 1}
    assert parallel.make_mesh(device="cpu").local_devices == [torch.device("cpu")]
    assert parallel.is_main_process() and parallel.local_device_count() >= 1


def test_param_specs_are_the_jax_specs(params):
    jp, tp = params
    for name in ("policy_param_spec", "value_param_spec", "reward_param_spec"):
        tree = jp["value"] if name == "value_param_spec" else jp["policy"]
        want = jax.tree.map(tuple, getattr(jparallel, name)(tree),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got = getattr(parallel, name)(from_jax_params(jax.tree.map(np.asarray, tree)))
        assert got == want
    spec = parallel.a2c_param_spec(tp)
    with pytest.raises(ValueError, match="'model' axis"):
        parallel.shard_params(_cpu_mesh(2), tp, spec)
    blocks = parallel.shard_params(parallel.make_mesh((2, 2), ("data", "model"),
                                                      devices=["cpu"] * 4), tp, spec)
    assert isinstance(blocks, sharding.LocalBlocks) and sorted(blocks) == [0, 1]
    v = tp["policy"]["embedding"].shape[0]
    for m, block in blocks.items():
        lo, hi = m * v // 2, (m + 1) * v // 2
        assert block.vocab[:4] == (lo, hi, v, 2)
        torch.testing.assert_close(block["policy"]["embedding"], tp["policy"]["embedding"][lo:hi])
        torch.testing.assert_close(block["policy"]["head"]["w"], tp["policy"]["head"]["w"][:, lo:hi])
        torch.testing.assert_close(block["value"]["lstm"]["wi"], tp["value"]["lstm"]["wi"])
    whole = parallel.gather_params(blocks)
    for a, b in zip(steps._tree_leaves(whole), steps._tree_leaves(tp)):
        assert torch.equal(a, b)
    rep = parallel.shard_params(_cpu_mesh(2), tp, sharding._rep(tp))
    assert isinstance(rep, sharding.Replicated)


def test_shard_batch_splits_one_process_mesh():
    x = torch.arange(24).reshape(12, 2)
    blocks = parallel.shard_batch(_cpu_mesh(3), x)
    assert [b.tolist() for b in blocks] == [x[:4].tolist(), x[4:8].tolist(), x[8:].tolist()]
    a, b = parallel.shard_batch(_cpu_mesh(2), x, np.arange(12))
    assert len(a) == len(b) == 2 and b[1].tolist() == list(range(6, 12))
    with pytest.raises(ValueError, match="do not divide"):
        parallel.shard_batch(_cpu_mesh(5), x)


class _RankMesh(tmesh.Mesh):
    """A mesh of ``size`` ranks, one CPU entry each, without a process group."""

    def __init__(self, size):
        devs = np.empty(size, dtype=object)
        devs[:] = [torch.device("cpu")] * size
        super().__init__(devs, ("data",), np.arange(size))


@pytest.mark.parametrize("size", [2, 4])
def test_global_batcher_takes_contiguous_equal_blocks(size, monkeypatch):
    caps = np.arange(8 * 3).reshape(8, 3)
    chunk = np.arange(2 * 8 * 3).reshape(2, 8, 3)
    rows = []
    for rank in range(size):
        monkeypatch.setattr(hostbatch, "world", lambda rank=rank: (rank, size))
        b = parallel.GlobalBatcher(_RankMesh(size))
        lo, hi = b.local_rows(8)
        assert (lo, hi) == (rank * 8 // size, (rank + 1) * 8 // size)
        assert b.row_shard(8) == collectives.RowShard(lo, hi, 8, size)
        np.testing.assert_array_equal(b.shard(caps), caps[lo:hi])
        np.testing.assert_array_equal(b.shard_stacked(chunk), chunk[:, lo:hi])
        # a ragged batch is every rank's whole batch, and takes no shard
        assert b.local_rows(7) == (0, 7) and b.row_shard(7) is None
        rows.extend(range(lo, hi))
    assert rows == list(range(8))


def test_launch_environment_all_or_nothing(monkeypatch):
    names = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
    for name in names:
        monkeypatch.delenv(name, raising=False)
    assert parallel.maybe_init_distributed(device="cpu") is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match=r"incomplete.*'LOCAL_RANK', 'MASTER_PORT', 'RANK'"):
        parallel.maybe_init_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_backends_and_rank_devices(monkeypatch):
    monkeypatch.delenv("ICRL_SHARE_CARD", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert tmesh.backend_for("cuda") == "nccl"
    assert tmesh.backend_for("cuda:0") == "nccl"
    assert tmesh.backend_for("cpu") == "gloo"
    assert tmesh.rank_device("cpu") == torch.device("cpu")
    # a named card in a world of two: every rank on it, refused unless asked for
    with pytest.raises(ValueError, match="ICRL_SHARE_CARD=1"):
        tmesh.rank_device("cuda:0")
    monkeypatch.setenv("ICRL_SHARE_CARD", "1")
    assert tmesh.backend_for("cuda:0") == "gloo"  # ranks that share a card, on purpose
    assert tmesh.backend_for("cuda") == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):  # no rank carries on on the CPU
        tmesh.rank_device("cuda")


def test_adam_orders_its_leaves_by_path():
    """The gradient bucket follows the optimiser's leaf order: a tree loaded
    on rank 0 and a template filled by its broadcast, built in other key
    orders, give the same order."""
    from image_captioning_through_rl_tpu_torch.train.optim import adam

    def tree(order):
        shapes = {"b": {"w": (3, 2), "a": (5,)}, "a": {"z": (4,), "c": (1, 7)}}
        return {k: {j: torch.zeros(shapes[k][j]) for j in order(shapes[k])} for k in order(shapes)}

    orders = [[tuple(p.shape) for p in adam(1e-3, tree(f)).param_groups[0]["params"]]
              for f in (sorted, lambda d: sorted(d, reverse=True), list)]
    assert orders[0] == orders[1] == orders[2] == [(1, 7), (4,), (5,), (3, 2)]


def test_without_a_process_group_the_collectives_are_the_identity():
    x = torch.arange(6.0).reshape(3, 2)
    assert collectives.all_reduce_(x.clone()).equal(x)
    assert collectives.broadcast_int(7) == 7
    assert collectives.broadcast_bytes(b"abc") == b"abc"
    shard = collectives.RowShard(0, 3, 3, 1)
    x.requires_grad_(True)
    y = collectives.gather_rows(x, shard)
    y.sum().backward()
    assert y.detach().equal(x.detach()) and x.grad.equal(torch.ones_like(x))
