"""The PyTorch port imports neither jax, the JAX package nor tqdm."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "image_captioning_through_rl_tpu_torch"


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import image_captioning_through_rl_tpu_torch\n"
        "import image_captioning_through_rl_tpu_torch.api\n"
        "import image_captioning_through_rl_tpu_torch.server\n"
        "import image_captioning_through_rl_tpu_torch.decode\n"
        "import image_captioning_through_rl_tpu_torch.decode.sample\n"
        "import image_captioning_through_rl_tpu_torch.decode.beam_compat\n"
        "import image_captioning_through_rl_tpu_torch.client\n"
        "import image_captioning_through_rl_tpu_torch.train.loops\n"
        "import image_captioning_through_rl_tpu_torch.train.steps\n"
        "import image_captioning_through_rl_tpu_torch.ops.prng\n"
        "import image_captioning_through_rl_tpu_torch.ops.sampling\n"
        "import image_captioning_through_rl_tpu_torch.ops.fused_rollout\n"
        "import image_captioning_through_rl_tpu_torch.ops.fused_sample\n"
        "import image_captioning_through_rl_tpu_torch.train.checkpoint\n"
        "import image_captioning_through_rl_tpu_torch.train.optim\n"
        "import image_captioning_through_rl_tpu_torch.data.device\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'image_captioning_through_rl_tpu'\n"
        "             or m.startswith('image_captioning_through_rl_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_metrics_writer_imports_without_jax_or_tensorflow(tmp_path):
    """The trainers' metric writer tees into TensorBoard through its
    TensorFlow-free stub: writing a scalar imports neither jax, TensorFlow
    nor the JAX package."""
    code = (
        "import sys\n"
        "from image_captioning_through_rl_tpu_torch.utils.logging import make_metrics_writer\n"
        f"w = make_metrics_writer({str(tmp_path)!r})\n"
        "w.add_scalar('tag', 1.0, 0)\n"
        "w.close()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in (\n"
        "    'jax', 'tensorflow', 'image_captioning_through_rl_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "metrics.jsonl").exists() and (tmp_path / "runs").is_dir()


def test_cli_slice_imports_without_h5py_msgpack_or_flax():
    """The bundle reader and writer, the native checkpoints and the CLIs
    import without jax, flax, h5py, msgpack or the JAX package (the GPU
    machine has none of them), and ``python -m`` the package reaches the
    CLI's parser."""
    code = (
        "import sys\n"
        "import image_captioning_through_rl_tpu_torch.data.hdf5\n"
        "import image_captioning_through_rl_tpu_torch.data.coco\n"
        "import image_captioning_through_rl_tpu_torch.data.synthetic\n"
        "import image_captioning_through_rl_tpu_torch.data.build\n"
        "import image_captioning_through_rl_tpu_torch.utils.msgpack\n"
        "import image_captioning_through_rl_tpu_torch.utils.profiling\n"
        "import image_captioning_through_rl_tpu_torch.cli.main\n"
        "import image_captioning_through_rl_tpu_torch.cli.score\n"
        "import image_captioning_through_rl_tpu_torch.cli.export\n"
        "import image_captioning_through_rl_tpu_torch.cli.build_data\n"
        "import image_captioning_through_rl_tpu_torch.cli.verify_reference\n"
        "import image_captioning_through_rl_tpu_torch.__main__\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in (\n"
        "    'jax', 'flax', 'h5py', 'msgpack', 'image_captioning_through_rl_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    proc = subprocess.run([sys.executable, "-m", "image_captioning_through_rl_tpu_torch",
                           "--help"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--device" in proc.stdout, proc.stderr


def test_evaluation_half_imports_without_jax_or_tqdm():
    """The evaluation modules import, and score a pair through the native
    library, with ``tqdm`` unimportable (the GPU machine has none). This
    host's torch imports tqdm itself, so it is imported first and its tqdm
    modules dropped before the blocker goes in."""
    code = (
        "import importlib.abc, sys\n"
        "import torch\n"
        "for m in [m for m in sys.modules if m == 'tqdm' or m.startswith('tqdm.')]:\n"
        "    del sys.modules[m]\n"
        "class NoTqdm(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name == 'tqdm' or name.startswith('tqdm.'):\n"
        "            raise ModuleNotFoundError(name)\n"
        "sys.meta_path.insert(0, NoTqdm())\n"
        "import image_captioning_through_rl_tpu_torch.metrics as m\n"
        "import image_captioning_through_rl_tpu_torch.metrics.postprocess\n"
        "import image_captioning_through_rl_tpu_torch.native as native\n"
        "from image_captioning_through_rl_tpu_torch.api import evaluate_captions\n"
        "from image_captioning_through_rl_tpu_torch.train.loops import (\n"
        "    load_a2c_models, test_a2c_network)\n"
        "native.native_available()\n"
        "assert set(evaluate_captions(['a b c'], ['a b'])) == {\n"
        "    'Bleu_1', 'Bleu_2', 'Bleu_3', 'Bleu_4', 'METEOR', 'ROUGE_L', 'CIDEr'}\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'tqdm', 'requests', 'PIL')\n"
        "             or m.startswith(('jax.', 'tqdm.', 'image_captioning_through_rl_tpu.'))\n"
        "             or m == 'image_captioning_through_rl_tpu')\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_name_no_tqdm():
    """No module of the port imports tqdm, at the top or inside a function."""
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        assert "import tqdm" not in text and "from tqdm" not in text, path
