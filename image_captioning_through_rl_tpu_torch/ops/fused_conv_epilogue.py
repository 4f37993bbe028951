"""What follows a VGG16 convolution on the card: its bias, its ReLU and,
where it closes a block, the 2x2 max-pool, as one hand-written CUDA kernel
over the convolution's channels-last output, and the plain PyTorch version.

Counterpart of no TPU kernel: the JAX package leaves its VGG16 to XLA
(``models/vgg.py``, ``lax.conv_general_dilated``), which fuses these passes
into the convolutions. The port's convolutions stay on cuDNN, without their
bias, in channels-last memory, and this pass takes their output
(:meth:`..models.vgg.VGG16.forward` on a card). The kernel is
``csrc/conv_epilogue.cu``; its note says what bounds it and what its design
does about that.

Routing is :func:`.kernel_build.runs_kernel`'s: a CUDA tensor runs the
kernel, a CPU tensor the plain version, ``use_fused_kernel=False`` the plain
version anywhere, ``use_fused_kernel=True`` on the CPU raises. Both routes
take the same inputs and refuse the same ones, and both return a new tensor.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from .kernel_build import check_error, load_library, runs_kernel

# channels a 16-byte group of the kernel holds in bf16 (4 in float32): the
# channel count must be a multiple of it
CHANNEL_GROUP = 8


def _check(x: torch.Tensor, bias: torch.Tensor, pool: bool) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv epilogue: x must be bfloat16 or float32, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv epilogue: x must be a channels-last [N, C, H, W] tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    n, c, h, w = x.shape
    if c % CHANNEL_GROUP:
        raise ValueError(f"conv epilogue: C = {c} is not a multiple of {CHANNEL_GROUP}")
    if pool and (h % 2 or w % 2):
        raise ValueError(f"conv epilogue: a 2x2 pool needs an even H and W, got {h} x {w}")
    if (bias.shape != (c,) or bias.dtype != x.dtype or bias.device != x.device
            or not bias.is_contiguous()):
        raise ValueError(f"conv epilogue: bias must be a contiguous [{c}] {x.dtype} on "
                         f"{x.device}, got {tuple(bias.shape)} {bias.dtype} on {bias.device} "
                         f"strides {bias.stride()}")
    if x.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("conv epilogue: x and bias must start on a 16-byte boundary (the "
                         "kernel's loads), as fresh tensors do; got a view that starts off it")


def conv_epilogue_plain(x: torch.Tensor, bias: torch.Tensor, pool: bool) -> torch.Tensor:
    """The plain version: ``x + bias`` (rounded once to x's type), the ReLU,
    then, with ``pool``, the 2x2 max-pool: the passes PyTorch runs after a
    biased ``nn.Conv2d``, its ``nn.ReLU`` and ``nn.MaxPool2d``."""
    y = torch.relu(x + bias[:, None, None])
    return F.max_pool2d(y, 2, 2) if pool else y


def fused_conv_epilogue(x: torch.Tensor, bias: torch.Tensor, pool: bool,
                        use_fused_kernel=None) -> torch.Tensor:
    """``relu(x + bias)`` of a convolution's output ``x`` (a channels-last
    ``[N, C, H, W]`` in bf16 or float32, ``C`` a multiple of 8) and its
    ``[C]`` bias of the same type, max-pooled over 2x2 windows when ``pool``
    (``H`` and ``W`` even): a new channels-last ``[N, C, H', W']``. ``x``
    and ``bias`` start on a 16-byte boundary, as fresh tensors do. The
    kernel's pooled output is ``relu(max(x) + bias)``, which equals the plain
    version's bit for bit (rounding and the ReLU are monotonic). Anything
    else raises ``ValueError`` on either route. ``fused_conv_epilogue.launches``
    counts the kernel's launches."""
    _check(x, bias, pool)
    if not runs_kernel(use_fused_kernel, x, "conv epilogue"):
        return conv_epilogue_plain(x, bias, pool)
    n, c, h, w = x.shape
    out = torch.empty((n, c, h // 2, w // 2) if pool else (n, c, h, w), dtype=x.dtype,
                      device=x.device, memory_format=torch.channels_last)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.icrl_conv_epilogue(n, c, h, w, int(x.dtype == torch.bfloat16), int(pool),
                                     x.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                     torch.cuda.current_stream(x.device).cuda_stream)
    check_error(lib, "icrl_conv_epilogue", err)
    fused_conv_epilogue.launches += 1
    return out


fused_conv_epilogue.launches = 0
