"""The program's spans on the card: a captured chunk's capture is a
``train.capture`` span of its own, before the dispatch that replays it,
and a beam caption call on the kernels emits its four ``caption.*`` spans.

Marked ``cuda``: without a CUDA device every test here skips. The file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_spans.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from image_captioning_through_rl_tpu_torch import START_ID
from image_captioning_through_rl_tpu_torch.config import NetConfig

CFG = NetConfig(vocab_size=60, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=7)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured chunk and the kernels run only on the GPU")
    return torch.device("cuda")


def _host_spans(prof, prefix):
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(prefix) and e.device_type() == torch.autograd.DeviceType.CPU:
            start = e.start_ns() / 1e3
            out.append((e.name(), start, start + e.duration_ns() / 1e3))
    return sorted(out, key=lambda s: s[1])


@pytest.mark.cuda
def test_capture_is_its_own_span_before_the_dispatch(dev):
    """Two chunks of one shape, called as the trainers call them: the chunk
    opens one ``train.capture`` (``BestLossChunk.captures`` counts it),
    before the first ``train.dispatch`` and inside none; the second chunk
    captures nothing."""
    from image_captioning_through_rl_tpu_torch.models import policy
    from image_captioning_through_rl_tpu_torch.train import checkpoint as ckpt
    from image_captioning_through_rl_tpu_torch.train import steps
    from image_captioning_through_rl_tpu_torch.train.optim import adam

    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((2, 3, 8, CFG.input_dim)).astype(np.float32))
    caps = rng.integers(4, CFG.vocab_size, size=(2, 3, 8, CFG.max_seq_len))
    caps[..., 0], caps[..., -1] = START_ID, 2
    feats, caps = feats.to(dev), torch.from_numpy(caps).to(dev)
    params = ckpt.to_device(policy.init(torch.Generator().manual_seed(3), CFG), dev)
    chunk = steps.make_policy_chunk_step(CFG, adam(1e-3, params), params, fused=True, graph=True)
    steps.BestLossChunk.captures = steps.BestLossChunk.replays = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for c in range(2):
            chunk(float("inf"), feats[c], caps[c])[0].tolist()
    assert (steps.BestLossChunk.captures, steps.BestLossChunk.replays) == (1, 2)
    spans = _host_spans(prof, "train.")
    assert [s[0] for s in spans] == ["train.capture", "train.dispatch", "train.dispatch"]
    assert all(b[1] >= a[2] for a, b in zip(spans, spans[1:]))


@pytest.mark.cuda
def test_caption_call_spans_on_the_card(dev):
    """A beam-5 caption call on the card under the profiler: the four
    ``caption.*`` spans, in order and siblings, around one ``beam_kernel``
    launch."""
    from image_captioning_through_rl_tpu_torch.api import Captioner
    from image_captioning_through_rl_tpu_torch.models import a2c

    words = {i: f"w{i}" for i in range(CFG.vocab_size)}
    cap = Captioner(a2c.init(torch.Generator().manual_seed(0), CFG), CFG, words, device=dev)
    feats = np.random.default_rng(1).standard_normal((33, CFG.input_dim)).astype(np.float32)
    cap.caption(feats, beam_size=5)  # builds and loads the kernels outside the trace
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cap.caption(feats, beam_size=5)
    spans = _host_spans(prof, "caption.")
    assert [s[0] for s in spans] == ["caption.features_in", "caption.search",
                                     "caption.tokens_out", "caption.strings"]
    assert all(b[1] >= a[2] for a, b in zip(spans, spans[1:]))
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "beam_kernel" in e.name()]
    assert len(kernels) == 1
