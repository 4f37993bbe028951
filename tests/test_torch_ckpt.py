"""Native ``.ckpt`` checkpoints of the port against flax and the JAX package.

For each network kind at small width (the JAX initialiser's weights carried
across as numpy): the port's ``save_pytree`` writes the bytes of the JAX
package's ``save_pytree`` (flax's ``to_bytes``), the JAX ``load_network``
reads the port's file exactly, and the port reads the JAX file exactly. A
file of the wrong shape or the wrong kind raises, naming the file and the
leaf. The msgpack subset is held against the ``msgpack`` package value by
value, smallest encodings included.
"""

import jax
import msgpack as msgpack_ref
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu.config import NetConfig as JNetConfig
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu.models import policy as jpolicy
from image_captioning_through_rl_tpu.models import reward as jreward
from image_captioning_through_rl_tpu.models import value as jvalue
from image_captioning_through_rl_tpu.train import checkpoint as jckpt
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.data.coco import CocoData, caption_lengths
from image_captioning_through_rl_tpu_torch.models.convert import from_jax_params
from image_captioning_through_rl_tpu_torch.train import checkpoint as tckpt
from image_captioning_through_rl_tpu_torch.train import loops as tloops
from image_captioning_through_rl_tpu_torch.train import steps as tsteps
from image_captioning_through_rl_tpu_torch.train.guard import TrainingDiverged
from image_captioning_through_rl_tpu_torch.utils import msgpack

V, F, E, H = 23, 12, 10, 8
JMODS = {"policy": jpolicy, "value": jvalue, "reward": jreward, "a2c": ja2c}
KINDS = sorted(JMODS)


def _cfgs(h=H):
    kw = dict(vocab_size=V, input_dim=F, wordvec_dim=E, hidden_dim=h)
    return JNetConfig(**kw), NetConfig(**kw)


def _jax_tree(kind, h=H, key=0):
    return jax.tree.map(np.asarray, JMODS[kind].init(jax.random.PRNGKey(key), _cfgs(h)[0]))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_equal_trees(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_save_pytree_bytes_equal_flax(kind, tmp_path):
    jtree = _jax_tree(kind)
    jckpt.save_pytree(jtree, str(tmp_path / "j.ckpt"))
    tckpt.save_pytree(from_jax_params(jtree), str(tmp_path / "t.ckpt"))
    assert (tmp_path / "t.ckpt").read_bytes() == (tmp_path / "j.ckpt").read_bytes()


@pytest.mark.parametrize("kind", KINDS)
def test_jax_load_network_reads_the_port_file(kind, tmp_path):
    jtree = _jax_tree(kind, key=1)
    path = str(tmp_path / f"{kind}Network.ckpt")
    tckpt.save_network(kind, from_jax_params(jtree), path)
    back = jckpt.load_network(kind, path, template=_jax_tree(kind, key=2))
    _assert_equal_trees(jax.tree.map(np.asarray, back), jtree)


@pytest.mark.parametrize("kind", KINDS)
def test_port_reads_the_jax_file(kind, tmp_path):
    jtree = _jax_tree(kind, key=3)
    path = str(tmp_path / f"{kind}Network.ckpt")
    jckpt.save_pytree(jtree, path)
    got = tckpt.load_network(kind, path, device="cpu", cfg=_cfgs()[1])
    _assert_equal_trees(jax.tree.map(lambda t: t.numpy(), got), jtree)
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(got))


@pytest.mark.parametrize("kind", KINDS)
def test_wrong_shape_file_raises(kind, tmp_path):
    path = str(tmp_path / f"{kind}Network.ckpt")
    jckpt.save_pytree(_jax_tree(kind, h=H + 2), path)
    assert tckpt.load_network(kind, path, device="cpu")  # keys alone agree
    with pytest.raises(ValueError, match=rf"{path}: leaf '.*' has shape .* needs"):
        tckpt.load_network(kind, path, device="cpu", cfg=_cfgs()[1])


@pytest.mark.parametrize("kind", KINDS)
def test_wrong_kind_file_raises(kind, tmp_path):
    other = KINDS[(KINDS.index(kind) + 1) % len(KINDS)]
    path = str(tmp_path / f"{other}Network.ckpt")
    jckpt.save_pytree(_jax_tree(other), path)
    with pytest.raises(ValueError, match=rf"{path}: not a {kind} network: leaf"):
        tckpt.load_network(kind, path, device="cpu")


def test_non_float32_and_non_tree_files_raise(tmp_path):
    tree = from_jax_params(_jax_tree("policy"))
    tree["head"]["b"] = tree["head"]["b"].double()
    path = str(tmp_path / "p.ckpt")
    tckpt.save_pytree(tree, path)  # save_pytree writes float32 whatever it is given
    assert tckpt.load_network("policy", path, device="cpu")["head"]["b"].dtype == torch.float32
    raw = {k: v for k, v in _jax_tree("policy").items()}
    raw["head"] = dict(raw["head"], b=raw["head"]["b"].astype(np.float64))
    jckpt.save_pytree(raw, path)
    with pytest.raises(ValueError, match=r"leaf 'head/b' is torch.float64"):
        tckpt.load_network("policy", path, device="cpu")
    with open(path, "wb") as f:
        f.write(msgpack_ref.packb([1, 2]))
    with pytest.raises(ValueError, match="not a parameter tree"):
        tckpt.load_network("policy", path, device="cpu")


def test_pt_route_and_save_by_suffix(tmp_path):
    """``.pt`` paths keep the reference state dict, checked alike; the a2c
    saves write each path in its suffix's format."""
    jtree = _jax_tree("a2c", key=4)
    params = from_jax_params(jtree)
    paths = [str(tmp_path / "a2cNetwork.pt"), str(tmp_path / "a2cNetwork.ckpt")]
    tckpt.save_to_paths(params, paths)
    assert torch.load(paths[0], weights_only=True)["policy_network.linear2vocab.bias"].shape == (V,)
    with open(paths[1], "rb") as f:
        assert f.read(1) == b"\x82"  # a two-key msgpack map: policy, value
    for path in paths:
        got = tckpt.load_network("a2c", path, device="cpu", cfg=_cfgs()[1])
        for (name, a), b in zip(tckpt._leaves(got), [t for _, t in tckpt._leaves(params)]):
            assert torch.equal(a, b), (path, name)
    with pytest.raises(ValueError, match="needs"):
        tckpt.load_network("a2c", paths[0], device="cpu", cfg=_cfgs(h=H + 1)[1])


def test_trainer_divergence_dump_is_native(tmp_path, monkeypatch):
    """A non-finite loss dumps the entering weights to ``<path>.diverged`` in
    the native format, which the JAX package reads, as its trainers do."""
    rng = np.random.default_rng(0)
    words = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(4, V)]
    caps = rng.integers(4, V, size=(16, 7)).astype(np.int32)
    caps[:, 0], caps[:, 5:] = 1, 0
    caps[:, 4] = 2
    feats = rng.standard_normal((8, F)).astype(np.float32)
    idxs = rng.integers(0, 8, size=16).astype(np.int32)
    data = CocoData(train_captions=caps, train_image_idxs=idxs, val_captions=caps,
                    val_image_idxs=idxs, train_features=feats, val_features=feats,
                    word_to_idx={w: i for i, w in enumerate(words)},
                    idx_to_word=dict(enumerate(words)), train_urls=np.array(["u"] * 8),
                    val_urls=np.array(["u"] * 8), train_captions_lens=caption_lengths(caps),
                    val_captions_lens=caption_lengths(caps))
    monkeypatch.setattr(tsteps, "make_policy_step",
                        lambda *a, **k: lambda p, f, c, *r: torch.tensor(float("nan")))
    path = str(tmp_path / "policyNetwork.ckpt")
    with pytest.raises(TrainingDiverged, match=r"policyNetwork\.ckpt\.diverged"):
        tloops.train_policy_network(data, {"policy_network": path}, None, False, epochs=1,
                                    batch_size=8, device="cpu",
                                    net_dims={"wordvec_dim": E, "hidden_dim": H})
    template = jpolicy.init(jax.random.PRNGKey(0), _cfgs()[0])
    dumped = jckpt.load_network("policy", path + ".diverged", template=template)
    assert jax.tree.map(np.shape, dumped) == jax.tree.map(np.shape, template)


MSGPACK_VALUES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, None,
    "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65536, "été",
    b"", b"x" * 255, b"y" * 256, b"z" * 65536,
    [], list(range(15)), list(range(16)), list(range(65536)), (1, (2, 3)),
    {}, {f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
    {f"k{i:05d}": None for i in range(65536)}, {"b": {"a": [1, "x", None]}, "a": b"q"},
]


@pytest.mark.parametrize("value", MSGPACK_VALUES, ids=lambda v: f"{type(v).__name__}")
def test_msgpack_subset_matches_the_package(value):
    def keys_sorted(v):  # the port sorts map keys at every level, as jax.tree.map does
        return {k: keys_sorted(v[k]) for k in sorted(v)} if isinstance(v, dict) else v

    want = msgpack_ref.packb(keys_sorted(value))
    assert msgpack.packb(value) == want
    back = msgpack.unpackb(want)
    assert back == msgpack_ref.unpackb(want, strict_map_key=False)


@pytest.mark.parametrize("nbytes", [1, 2, 4, 8, 16, 17, 255, 256, 65535, 65536])
def test_msgpack_ext_headers_match_flax(nbytes):
    """Every ext header width (fixext 1-16, ext 8/16/32) through flax's
    ndarray encoding."""
    from flax import serialization

    for shape in [(nbytes,), ()] if nbytes == 1 else [(nbytes,)]:
        tree = {"a": np.arange(np.prod(shape), dtype=np.uint8).reshape(shape)}
        assert msgpack.packb(tree) == serialization.to_bytes(tree)
        back = msgpack.unpackb(msgpack.packb(tree))["a"]
        assert back.shape == shape and back.flags.writeable


@pytest.mark.parametrize("value, match", [
    (-1, "negative"), (1.5, "float"), (True, "boolean"), ({1: 2}, "not a str"),
    (np.zeros(2, dtype=object), "object"), (2 ** 64, "64 bits"),
])
def test_msgpack_subset_rejects_the_rest(value, match):
    with pytest.raises(ValueError, match=match):
        msgpack.packb(value)


def test_msgpack_rejects_arrays_past_flax_chunk_limit_and_foreign_types(monkeypatch):
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    with pytest.raises(ValueError, match="chunk"):
        msgpack.packb({"w": np.zeros(17, np.float32)})
    assert msgpack.packb({"w": np.zeros(16, np.float32)})
    for data, match in ((msgpack_ref.packb(1.5), "0xcb"), (msgpack_ref.packb(True), "0xc3"),
                        (msgpack_ref.packb(msgpack_ref.ExtType(2, b"ab")), "ext type 2"),
                        (msgpack_ref.packb([1]) + b"\x00", "after"),
                        (msgpack_ref.packb("abc")[:-1], "truncated")):
        with pytest.raises(ValueError, match=match):
            msgpack.unpackb(data)
