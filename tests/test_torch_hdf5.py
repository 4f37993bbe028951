"""The port's HDF5 reader and writer against h5py, and its ``load_data`` and
``make_synthetic_coco`` against the JAX package's.

The reader must give h5py's arrays (values, dtypes and shapes, exact) for
every layout h5py writes by default, and raise a ``ValueError`` naming the
file, the dataset and the reason for every other. The writer's files must
read back equal through h5py (libhdf5 itself, including its B-tree name
lookup ``name in f``) and through the reader. ``load_data`` must equal the
JAX package's field for field and dtype for dtype on bundles written by
either package.
"""

import dataclasses
import filecmp
import os

import h5py
import numpy as np
import pytest

from image_captioning_through_rl_tpu.data.coco import load_data as jload_data
from image_captioning_through_rl_tpu.data.synthetic import make_synthetic_coco as jmake
from image_captioning_through_rl_tpu_torch.data import coco as tcoco
from image_captioning_through_rl_tpu_torch.data import hdf5
from image_captioning_through_rl_tpu_torch.data.synthetic import make_synthetic_coco as tmake

DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64", "float32",
          "float64"]


def _h5py_read(path):
    with h5py.File(path, "r") as f:
        return {k: np.asarray(v) for k, v in f.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _arrays(dtype, rng):
    dt = np.dtype(dtype)
    if dt.kind == "f":
        draw = lambda shape: rng.standard_normal(shape).astype(dt)  # noqa: E731
    else:
        info = np.iinfo(dt)
        draw = lambda shape: rng.integers(info.min, info.max, size=shape, dtype=dt,  # noqa: E731
                                          endpoint=True)
    return {"one_d": draw((7,)), "two_d": draw((5, 3)), "three_d": draw((2, 3, 4)),
            "no_rows": draw((0, 6)), "scalar": draw(())}


@pytest.mark.parametrize("dtype", DTYPES)
def test_reader_matches_h5py(dtype, tmp_path):
    arrays = _arrays(dtype, np.random.default_rng(DTYPES.index(dtype)))
    path = tmp_path / "x.h5"
    with h5py.File(path, "w") as f:
        for k, v in arrays.items():
            f[k] = v
    _assert_same(hdf5.read_h5(str(path)), _h5py_read(path))
    _assert_same(hdf5.read_h5(str(path)), arrays)
    assert list(hdf5.read_h5(str(path), ["two_d"])) == ["two_d"]


def test_reader_many_datasets_and_special_storage(tmp_path):
    """More than 256 datasets (an inner B-tree level), a dataset created
    without data (undefined address: zeros), and one whose header grew
    into a continuation block (attributes, skipped)."""
    path = tmp_path / "many.h5"
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        for i in range(300):
            f[f"d{i:03d}"] = rng.integers(0, 99, size=(i % 7, 2)).astype(np.int32)
        f.create_dataset("unwritten", shape=(3, 4), dtype=np.float32)
        ds = f.create_dataset("grown", data=np.arange(6.0))
        for i in range(40):
            ds.attrs[f"attribute_{i}"] = np.arange(i + 1)
    got = hdf5.read_h5(str(path))
    _assert_same(got, _h5py_read(path))
    assert len(got) == 302 and not got["unwritten"].any()


def _compact(f):
    space = h5py.h5s.create_simple((3,))
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    ds = h5py.h5d.create(f.id, b"bad", h5py.h5t.NATIVE_INT32, space, dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(3, dtype=np.int32))


RAISING = {
    "chunked": (lambda f, tmp: f.create_dataset("bad", data=np.arange(10), chunks=(5,)),
                "chunked storage"),
    "compact": (lambda f, tmp: _compact(f), "compact storage"),
    "gzip": (lambda f, tmp: f.create_dataset("bad", data=np.arange(10), compression="gzip"),
             "filter pipeline"),
    "external": (lambda f, tmp: f.create_dataset("bad", shape=(4,), dtype=np.int32,
                                                 external=[(str(tmp / "ext.bin"), 0, 16)]),
                 "external storage"),
    "big-endian": (lambda f, tmp: f.create_dataset("bad", data=np.arange(3, dtype=">i4")),
                   "big-endian"),
    "big-endian float": (lambda f, tmp: f.create_dataset("bad", data=np.ones(3, ">f8")),
                         "big-endian"),
    "string": (lambda f, tmp: f.create_dataset("bad", data=np.array([b"ab", b"cd"])),
               "string datatype"),
    "vlen string": (lambda f, tmp: f.create_dataset("bad", data="a vlen string"),
                    "variable-length datatype"),
    "vlen ints": (lambda f, tmp: f.create_dataset("bad", (2,), dtype=h5py.vlen_dtype("i4")),
                  "variable-length datatype"),
    "compound": (lambda f, tmp: f.create_dataset(
        "bad", data=np.zeros(3, dtype=[("a", "<i4"), ("b", "<f4")])), "compound datatype"),
    "float16": (lambda f, tmp: f.create_dataset("bad", data=np.ones(3, np.float16)),
                "not IEEE float32 or float64"),
    "nested group": (lambda f, tmp: f.create_group("bad").create_dataset("x", data=[1]),
                     "nested group"),
}


@pytest.mark.parametrize("case", sorted(RAISING))
def test_reader_raises_naming_file_dataset_and_reason(case, tmp_path):
    make, reason = RAISING[case]
    path = tmp_path / "bad.h5"
    with h5py.File(path, "w") as f:
        f["fine"] = np.arange(4)
        make(f, tmp_path)
    with pytest.raises(ValueError) as err:
        hdf5.read_h5(str(path))
    msg = str(err.value)
    assert str(path) in msg and "dataset 'bad'" in msg and reason in msg, msg
    assert hdf5.read_h5(str(path), ["fine"])["fine"].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("libver", ["v108", "latest"])
def test_reader_raises_on_other_superblocks(libver, tmp_path):
    """libver v108 keeps superblock 0 but writes the root group as links
    once it holds a newer feature; "latest" writes superblock 3."""
    path = tmp_path / "new.h5"
    with h5py.File(path, "w", libver=libver) as f:
        f["x"] = np.arange(3)
    with h5py.File(path, "r") as f:
        version = f.id.get_create_plist().get_version()[0]
    if version == 0:
        assert hdf5.read_h5(str(path))["x"].tolist() == [0, 1, 2]
        return
    with pytest.raises(ValueError, match=rf"{path}: superblock version {version}"):
        hdf5.read_h5(str(path))


def test_reader_raises_on_truncated_and_foreign_files(tmp_path):
    path = tmp_path / "x.h5"
    hdf5.write_h5(str(path), {"a": np.arange(100)})
    data = path.read_bytes()
    path.write_bytes(data[:-8])
    with pytest.raises(ValueError, match="truncated"):
        hdf5.read_h5(str(path))
    path.write_bytes(b"not hdf5" * 20)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.read_h5(str(path))
    path.write_bytes(data)
    with pytest.raises(KeyError, match="no dataset 'b'"):
        hdf5.read_h5(str(path), ["b"])


@pytest.mark.parametrize("count", [0, 1, 8, 9, 256, 257, 300])
def test_writer_files_read_back_in_h5py(count, tmp_path):
    """Counts around a SNOD's 8 entries and a B-tree node's 32 SNODs; every
    name found by libhdf5's lookup as well as by iteration."""
    rng = np.random.default_rng(count)
    arrays = {}
    for i in range(count):
        dt = np.dtype(DTYPES[i % len(DTYPES)])
        arrays[f"n{rng.integers(10 ** 6)}_{i}"] = (
            rng.standard_normal((i % 3, 2, i % 5)) * 100).astype(dt)
    path = str(tmp_path / "w.h5")
    hdf5.write_h5(path, arrays)
    with h5py.File(path, "r") as f:
        assert f.id.get_filesize() == os.path.getsize(path)
        for k, v in arrays.items():
            assert k in f
            assert f[k].dtype == v.dtype and f[k].shape == v.shape
    _assert_same(_h5py_read(path), arrays)
    _assert_same(hdf5.read_h5(path), arrays)


@pytest.mark.parametrize("dtype", DTYPES)
def test_writer_dtypes_and_shapes(dtype, tmp_path):
    arrays = _arrays(dtype, np.random.default_rng(7))
    arrays["fortran"] = np.asfortranarray(arrays["two_d"])
    arrays["swapped"] = arrays["three_d"].astype(np.dtype(dtype).newbyteorder(">"))
    path = str(tmp_path / "w.h5")
    hdf5.write_h5(path, arrays)
    want = {k: v.astype(np.dtype(dtype)) for k, v in arrays.items()}
    _assert_same(_h5py_read(path), want)
    _assert_same(hdf5.read_h5(path), want)


@pytest.mark.parametrize("arrays, match", [
    ({"a/b": np.arange(3)}, "dataset name"),
    ({"": np.arange(3)}, "dataset name"),
    ({"s": np.array(["ab"])}, "dtype"),
    ({"b": np.array([True])}, "dtype"),
    ({"h": np.ones(2, np.float16)}, "dtype"),
])
def test_writer_rejects_what_it_cannot_write(arrays, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        hdf5.write_h5(str(tmp_path / "w.h5"), arrays)
    assert not os.listdir(tmp_path)


def _fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(y, x, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    kw = dict(num_train_images=13, num_val_images=7, captions_per_image=3, vocab_size=45,
              feature_dim=24, seed=5)
    jdir = jmake(str(tmp_path_factory.mktemp("jax_bundle")), **kw)
    tdir = tmake(str(tmp_path_factory.mktemp("port_bundle")), **kw)
    rng = np.random.default_rng(9)
    for d in (jdir, tdir):  # full (non-PCA) feature tables, one per writer
        for split, n in (("train", 13), ("val", 7)):
            feats = rng.standard_normal((n, 40)).astype(np.float32)
            if d == jdir:
                with h5py.File(os.path.join(d, f"{split}2014_vgg16_fc7.h5"), "w") as f:
                    f["features"] = feats
            else:
                hdf5.write_h5(os.path.join(d, f"{split}2014_vgg16_fc7.h5"), {"features": feats})
    return {"jax": jdir, "port": tdir}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("variant", ["whole", "max_train seeded", "max_train global",
                                     "full features"])
def test_load_data_matches_jax(writer, variant, bundles, capsys):
    kw = {"whole": {}, "max_train seeded": {"max_train": 50, "seed": 3},
          "max_train global": {"max_train": 50}, "full features": {"pca_features": False}}[variant]
    np.random.seed(11)
    want = jload_data(bundles[writer], print_keys=True, **kw)
    printed = capsys.readouterr().out
    np.random.seed(11)
    got = tcoco.load_data(bundles[writer], print_keys=True, **kw)
    assert capsys.readouterr().out == printed
    _fields_equal(want, got)
    assert got.train_image_idxs.dtype == np.int32 and got.train_captions_lens.dtype == np.int64


def test_make_synthetic_coco_matches_jax(bundles):
    for name in ("coco2014_vocab.json", "train2014_urls.txt", "val2014_urls.txt"):
        assert filecmp.cmp(os.path.join(bundles["jax"], name),
                           os.path.join(bundles["port"], name), shallow=False), name
    for name in ("coco2014_captions.h5", "train2014_vgg16_fc7_pca.h5", "val2014_vgg16_fc7_pca.h5"):
        _assert_same(_h5py_read(os.path.join(bundles["port"], name)),
                     _h5py_read(os.path.join(bundles["jax"], name)))
