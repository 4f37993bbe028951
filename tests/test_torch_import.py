"""The PyTorch port imports neither jax nor the JAX package."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import image_captioning_through_rl_tpu_torch\n"
        "import image_captioning_through_rl_tpu_torch.api\n"
        "import image_captioning_through_rl_tpu_torch.server\n"
        "import image_captioning_through_rl_tpu_torch.decode\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'image_captioning_through_rl_tpu'\n"
        "             or m.startswith('image_captioning_through_rl_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
