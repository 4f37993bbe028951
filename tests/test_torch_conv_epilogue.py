"""VGG16's convolution epilogue (``ops/fused_conv_epilogue``: bias, ReLU and
the 2x2 pool in one pass over a channels-last convolution output) and the
channels-last stack that runs it (``models/vgg.VGG16.channels_last_stack``),
on the CPU, where the wrapper takes its plain version; the kernel against
it, bit for bit, is ``test_torch_cuda.py``'s.

Tolerances, where a biased ``nn.Conv2d`` adds its bias inside the
product's sums and the epilogue adds it to the rounded product, one rounding
apart: ``torch.testing.assert_close``'s defaults for float32 (rtol 1.3e-6,
atol 1e-5); for bf16 its rtol 1.6e-2 and an atol of one bf16 step at the
operands' scale (2^-7: the biases and products here are below 2), which a
sum that cancels to near zero shows whole. The whole bf16 stack against
``self.features``: 1e-2 by relative Frobenius error (such roundings over 13
layers; 2.4e-3 measured).
"""

import functools

import numpy as np
import pytest
import torch
from torch import nn

from image_captioning_through_rl_tpu_torch.models import convert
from image_captioning_through_rl_tpu_torch.models import vgg as tvgg
from image_captioning_through_rl_tpu_torch.ops.fused_conv_epilogue import fused_conv_epilogue

torch.set_num_threads(2)

CL = torch.channels_last
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2**-7}


def _conv(c_in, c_out, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    conv = nn.Conv2d(c_in, c_out, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * (2 / (9 * c_in)) ** 0.5)
        conv.bias.copy_(torch.randn(c_out, generator=gen) * 0.5)
    return conv.requires_grad_(False).to(dtype).to(memory_format=CL)


def _input(n, c, h, w, dtype, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, c, h, w), generator=gen).to(dtype).contiguous(memory_format=CL)


@pytest.mark.parametrize("shape", [(2, 3, 16, 6, 10), (1, 16, 8, 4, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", [False, True])
def test_plain_route_matches_conv_relu_pool_modules(shape, dtype, pool):
    """The convolution without its bias, then the epilogue, against
    ``nn.Conv2d`` -> ``nn.ReLU`` (-> ``nn.MaxPool2d``): the same values, a
    channels-last output, no kernel launched."""
    n, c_in, c_out, h, w = shape
    conv, x = _conv(c_in, c_out, dtype), _input(n, c_in, h, w, dtype)
    layers = [conv, nn.ReLU()] + ([nn.MaxPool2d(2, 2)] if pool else [])
    want = nn.Sequential(*layers)(x)
    launches = fused_conv_epilogue.launches
    got = fused_conv_epilogue(torch.nn.functional.conv2d(x, conv.weight, None, padding=1),
                              conv.bias, pool)
    assert fused_conv_epilogue.launches == launches
    assert got.shape == ((n, c_out, h // 2, w // 2) if pool else (n, c_out, h, w))
    assert got.dtype == dtype and got.is_contiguous(memory_format=CL)
    assert float(got.float().abs().max()) > 0 and float(got.float().min()) >= 0
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2, atol=ATOL[dtype])


def test_plain_route_keeps_nan_and_negative_zero():
    """PyTorch's ReLU (``clamp_min``) and pool, which the kernel copies: a
    NaN passes both, ``-0 + 0`` is ``+0``, a negative sum becomes ``+0``."""
    x = torch.zeros((1, 8, 2, 2)).contiguous(memory_format=CL)
    x[0, 0, 0, 0] = float("nan")
    x[0, 1] = -0.0
    x[0, 2] = -1.0
    b = torch.zeros(8)
    y = fused_conv_epilogue(x, b, pool=False)
    assert torch.isnan(y[0, 0, 0, 0]) and not torch.isnan(y[0, 0, 1, 1])
    assert not torch.signbit(y[0, 1:3]).any() and not y[0, 1:3].any()
    assert torch.isnan(fused_conv_epilogue(x, b, pool=True)[0, 0, 0, 0])


def test_plain_route_returns_a_new_tensor():
    x = _input(1, 8, 4, 4, torch.float32)
    before = x.clone()
    y = fused_conv_epilogue(x, torch.full((8,), -0.25), pool=False)
    assert y.data_ptr() != x.data_ptr()
    assert torch.equal(x, before)


def test_forced_kernel_on_cpu_raises():
    x = _input(1, 8, 4, 4, torch.float32)
    with pytest.raises(RuntimeError, match="conv epilogue kernel runs only on a CUDA device"):
        fused_conv_epilogue(x, torch.zeros(8), pool=True, use_fused_kernel=True)


@pytest.mark.parametrize("case, match", [
    ("nchw", "channels-last"),
    ("float16", "bfloat16 or float32"),
    ("int", "bfloat16 or float32"),
    ("three_dims", "channels-last"),
    ("channels_12", "C = 12 is not a multiple of 8"),
    ("odd_h", "even H and W"),
    ("odd_w", "even H and W"),
    ("bias_shape", "bias must be"),
    ("bias_dtype", "bias must be"),
    ("bias_strided", "bias must be a contiguous"),
    ("offset", "16-byte boundary"),
])
@pytest.mark.parametrize("use_fused_kernel", [None, False])
def test_refusals_on_either_route(case, match, use_fused_kernel):
    """What the kernel does not take raises on the plain route too, so the
    two take the same inputs."""
    x, b, pool = _input(2, 16, 4, 6, torch.float32), torch.zeros(16), True
    if case == "nchw":
        x = x.contiguous()
    elif case == "float16":
        x, b = x.half(), b.half()
    elif case == "int":
        x = x.to(torch.int32)
    elif case == "three_dims":
        x = x[0]
    elif case == "channels_12":
        x, b = _input(2, 12, 4, 6, torch.float32), torch.zeros(12)
    elif case == "odd_h":
        x = _input(2, 16, 5, 6, torch.float32)
    elif case == "odd_w":
        x = _input(2, 16, 4, 7, torch.float32)
    elif case == "bias_shape":
        b = torch.zeros(8)
    elif case == "bias_dtype":
        b = b.bfloat16()
    elif case == "bias_strided":
        b = torch.zeros(32)[::2]
    elif case == "offset":  # a view 4 bytes into its storage, channels-last all the same
        x = torch.zeros(x.numel() + 1)[1:].as_strided(x.shape, x.stride()).copy_(x)
        assert x.is_contiguous(memory_format=CL)
    with pytest.raises(ValueError, match=match):
        fused_conv_epilogue(x, b, pool, use_fused_kernel=use_fused_kernel)


def test_odd_sizes_pass_without_a_pool():
    x = _input(1, 8, 5, 7, torch.float32)
    y = fused_conv_epilogue(x, torch.ones(8), pool=False)
    torch.testing.assert_close(y, torch.relu(x + 1.0), rtol=0, atol=0)


# ---- the channels-last stack ----


def _model(dtype=torch.float32):
    model = tvgg.init(torch.Generator().manual_seed(5))
    return tvgg.cast_params(model, dtype) if dtype != torch.float32 else model


@functools.lru_cache(maxsize=None)
def _shared_model(dtype=torch.float32):
    """A model the tests only read."""
    return _model(dtype)


def _pixels(n, size, seed=2):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channels_last_stack_matches_features(dtype):
    """The card's route, its epilogue in the plain version here, against
    ``self.features`` (the CPU route): the five pools where the blocks close,
    ``[N, 512, 2, 2]`` at 64 pixels, channels-last."""
    model = _shared_model(dtype)
    x = tvgg.preprocess(_pixels(2, 64), size=64).to(dtype)
    want = model.features(x)
    got = model.channels_last_stack(x)
    assert got.shape == want.shape == (2, 512, 2, 2)
    assert got.is_contiguous(memory_format=CL)
    assert float(want.float().abs().max()) > 0
    if dtype == torch.float32:
        torch.testing.assert_close(got, want.contiguous(memory_format=CL))
    else:
        assert float((got.float() - want.float()).norm() / want.float().norm()) < 1e-2


def test_card_layout_leaves_a_cpu_model_and_its_pixels_in_nchw():
    """Off a card nothing changes: the weights stay contiguous, ``preprocess``
    returns contiguous NCHW, and ``forward`` runs ``self.features``."""
    model = tvgg.card_layout(_shared_model())
    assert all(model.features[i].weight.is_contiguous() for i in tvgg.CONV_IDXS)
    assert all(_shared_model(torch.bfloat16).features[i].weight.is_contiguous()
               for i in tvgg.CONV_IDXS)
    assert tvgg.preprocess(_pixels(2, 32), size=32).is_contiguous()
    x = tvgg.preprocess(_pixels(1, 224))
    launches = fused_conv_epilogue.launches
    torch.testing.assert_close(model(x), model.classifier(torch.flatten(model.features(x), 1)),
                               rtol=0, atol=0)
    assert fused_conv_epilogue.launches == launches


def test_pool_indices_follow_the_configuration():
    model = tvgg.VGG16(device="meta")
    assert tvgg.POOL_IDXS == tuple(k for k, layer in enumerate(model.features)
                                   if isinstance(layer, nn.MaxPool2d))
    assert tvgg.CONV_IDXS == tuple(k for k, layer in enumerate(model.features)
                                   if isinstance(layer, nn.Conv2d))


def test_channels_last_weights_keep_state_dict_and_jax_tree(tmp_path):
    """The layout a card keeps (the 13 convolution weights channels-last)
    changes no key, shape or value of the state dict, of its ``.pt`` file or
    of the JAX tree, and the tree carries back to the same weights."""
    model = _model()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    tree = convert.vgg_to_jax(model)
    model.to(memory_format=CL)
    assert all(model.features[i].weight.is_contiguous(memory_format=CL)
               and not model.features[i].weight.is_contiguous() for i in tvgg.CONV_IDXS)
    after = model.state_dict()
    assert list(after) == list(sd)
    for k, v in sd.items():
        assert after[k].shape == v.shape and torch.equal(after[k], v), k
    path = tmp_path / "vgg16.pt"
    torch.save(after, path)
    loaded = convert.load_state_dict(str(path))
    assert all(torch.equal(loaded[k], v) for k, v in sd.items())
    tree_after = convert.vgg_to_jax(model)
    assert tree_after.keys() == tree.keys()
    for name, leaves in tree.items():
        for leaf, v in leaves.items():
            assert torch.equal(tree_after[name][leaf], v), (name, leaf)
    back = convert.vgg_from_jax(tree_after).state_dict()
    assert all(torch.equal(back[k], v) for k, v in sd.items())


def test_replaced_forward_runs_self_features_on_channels_last_weights():
    """A ``forward`` that runs ``self.features`` (as the benchmark's planted
    faults replace it) still runs, and gives the same pool5, on the weights a
    card keeps channels-last, from NCHW and channels-last pixels."""
    model = _model()
    x = tvgg.preprocess(_pixels(1, 32), size=32)
    want = model.features(x)
    model.to(memory_format=CL)
    for pixels in (x, x.contiguous(memory_format=CL)):
        torch.testing.assert_close(model.features(pixels), want)
