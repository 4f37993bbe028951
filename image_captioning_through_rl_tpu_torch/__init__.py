"""image_captioning_through_rl_tpu_torch — the PyTorch/CUDA port of
:mod:`image_captioning_through_rl_tpu`.

The JAX package is the reference; this package mirrors its module names
so each counterpart is easy to find (``models/policy.py`` here is
``models/policy.py`` there). It imports ``torch`` and never ``jax`` or the
JAX package.

Parameters keep the JAX package's layout and names: input-major LSTM
weights ``wi [E, 4H]``, ``wh [H, 4H]`` with one fused bias ``b [4H]``, and
``{"w": [in, out], "b": [out]}`` linears. Weights therefore cross between
the packages as plain numpy (:func:`.models.convert.from_jax_params`) and
through the reference ``.pt`` layout (:mod:`.models.convert`).

Decoding (greedy, value-guided beam, sampled), the training chains and the
A2C rollout run through hand-written CUDA kernels for Hopper (``csrc/``) on
a CUDA device, and through their plain PyTorch versions on the CPU; see
:mod:`.ops`.
"""

__version__ = "0.1.0"

MAX_SEQ_LEN = 17  # max caption length in the COCO bundle

# Special vocabulary ids of the CS231n-style COCO captioning bundle.
NULL_ID = 0
START_ID = 1
END_ID = 2
UNK_ID = 3
