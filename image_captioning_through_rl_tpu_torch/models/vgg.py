"""VGG16, the visual front end: raw images -> fc7 features (counterpart of
the JAX ``models/vgg.py``).

Configuration D of Simonyan & Zisserman (2014): 3x3 convolutions in blocks
of 64-64 / 128-128 / 256x3 / 512x3 / 512x3 channels, each block closed by a
2x2 max-pool, then fc6 (4096) and fc7 (4096); no fc8 (only features are
extracted). :class:`VGG16` is an ``nn.Module`` in NCHW whose state-dict keys
are torchvision's (``features.{i}.*`` for the 13 convolutions at their
``nn.Sequential`` indices, ``classifier.{0,3}.*`` for fc6 and fc7), so a
torchvision-layout ``.pt`` loads as it is (:func:`.convert.vgg_from_state_dict`).
The JAX package works in NHWC; its fc6 reads the NCHW flatten, which is this
module's own, so its weights carry over unpermuted (:func:`.convert.vgg_from_jax`).
The extraction loop here (:func:`iter_features`, :func:`extract_features`)
serves every backbone: VGG16, and CLIP's image tower (:mod:`.vit`), which
brings its own preprocessing and stack.

The JAX package runs the stack in XLA. The port runs its convolutions
through ``torch.nn.functional.conv2d`` (cuDNN on the card) and fc6 and fc7
through ``linear``. On the CPU the stack is ``self.features`` as it stands.
On a card it is channels-last: the convolution weights are put in
``torch.channels_last`` once, at the stack's first batch there
(:func:`card_layout`), :func:`preprocess` hands over channels-last pixels,
each convolution runs without its bias, so that cuDNN's NHWC kernels read
and write NHWC with no transposes, and one hand-written pass adds the bias,
applies the ReLU and, where the convolution closes a block, the 2x2 pool
(:func:`..ops.fused_conv_epilogue.fused_conv_epilogue`, 13 launches a
batch). Shapes, state-dict keys and fc6's NCHW flatten are the same on
both. A float32 stack on the card turns TF32 off first (cuDNN's
convolutions use TF32 by default, which keeps about three decimal digits),
so float32 is float32 on every device.
"""

from __future__ import annotations

import copy
import functools
import sys
from typing import Iterable, List

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.fused_conv_epilogue import fused_conv_epilogue
from ..utils.profiling import annotate
from .initializers import linear_init

# channels per convolution; "M" a 2x2 max-pool (configuration D)
CFG: List = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
# the nn.Sequential indices of the 13 convolutions (torchvision's)
CONV_IDXS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
# ... and of the five pools, each two after the convolution that closes a block
POOL_IDXS = (4, 9, 16, 23, 30)
FC7_DIM, IMAGE_SIZE = 4096, 224

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# batches the extraction keeps on the device before reading them back, so
# the host's decode and copy of the next batch overlap the card's stack
PIPELINE_DEPTH = 4


class VGG16(nn.Module):
    """The stack up to fc7 (post-ReLU), on ``device``, without gradients;
    NCHW shapes, channels-last memory on a card (:meth:`channels_last_stack`).
    Its weights are uninitialised until :meth:`init` or a state dict fills
    them."""

    backbone, feature_dim, image_size = "vgg16", FC7_DIM, IMAGE_SIZE

    def __init__(self, device=None):
        super().__init__()
        layers, in_ch = [], 3
        # built on the meta device, then given uninitialised storage: torch's
        # default initialisation of 138M weights would only be overwritten
        for c in CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(in_ch, c, 3, padding=1, device="meta"),
                           nn.ReLU(inplace=True)]
                in_ch = c
        self.features = nn.Sequential(*layers)
        # torchvision's indices: fc6 at 0, fc7 at 3 (its dropout at 2 is the
        # identity at inference)
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, FC7_DIM, device="meta"), nn.ReLU(inplace=True), nn.Identity(),
            nn.Linear(FC7_DIM, FC7_DIM, device="meta"), nn.ReLU(inplace=True))
        self.to_empty(device=device if device is not None else "cpu")
        self.requires_grad_(False)  # a feature extractor: nothing here trains

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "VGG16":
        """Kaiming-uniform weights from ``gen``, as the JAX ``vgg.init``
        draws them (U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for every weight and
        bias; a convolution's fan-in is 9 in-channels); the draws are torch's,
        not JAX's."""
        for i in CONV_IDXS:
            conv = self.features[i]
            c_out, c_in = conv.weight.shape[:2]
            lin = linear_init(gen, 9 * c_in, c_out)
            # [9 in, out] as JAX's HWIO, then OIHW
            conv.weight.copy_(lin["w"].reshape(3, 3, c_in, c_out).permute(3, 2, 0, 1))
            conv.bias.copy_(lin["b"])
        for i in (0, 3):
            fc = self.classifier[i]
            lin = linear_init(gen, fc.in_features, fc.out_features)
            fc.weight.copy_(lin["w"].t())
            fc.bias.copy_(lin["b"])
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed images ``[N, 3, 224, 224]`` -> fc7 ``[N, 4096]`` in
        the module's type: on a card through :meth:`channels_last_stack`, on
        the CPU through ``self.features``."""
        with torch.no_grad():
            _no_tf32(x)
            x = self.channels_last_stack(x) if x.is_cuda else self.features(x)
            return self.classifier(torch.flatten(x, 1))

    def channels_last_stack(self, x: torch.Tensor) -> torch.Tensor:
        """The 13 convolutions and 5 pools of ``self.features`` in
        channels-last memory: each convolution without its bias, then its
        bias, ReLU and (closing a block) 2x2 pool in one
        :func:`..ops.fused_conv_epilogue.fused_conv_epilogue` (the kernel on
        a card, its plain version on the CPU), on the weights
        :func:`card_layout` lays out. ``[N, 3, 224, 224]`` -> channels-last
        ``[N, 512, 7, 7]``."""
        card_layout(self)
        x = x.contiguous(memory_format=torch.channels_last)
        for i in CONV_IDXS:
            conv = self.features[i]
            x = F.conv2d(x, conv.weight, None, padding=1)
            x = fused_conv_epilogue(x, conv.bias, i + 2 in POOL_IDXS)
        return x


def init(gen: torch.Generator, device=None) -> VGG16:
    """A :class:`VGG16` with weights drawn from ``gen`` (:meth:`VGG16.init`)."""
    return VGG16(device=device).init(gen)


def _no_tf32(x: torch.Tensor) -> None:
    """On a CUDA tensor, float32 convolutions and products in float32: cuDNN
    and cuBLAS otherwise take TF32 for them."""
    if x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def card_layout(model: VGG16) -> VGG16:
    """``model`` with its 13 convolution weights in ``torch.channels_last``
    where it lies on a CUDA device (what cuDNN's NHWC kernels read); on any
    other device, or laid out already, as it is. :meth:`VGG16.channels_last_stack`
    calls it, so the weights are laid out once, at a model's first batch on
    a card, however the model got there; a cast (``Module.to(dtype)``) or
    a copy (``copy.deepcopy``) keeps the layout. Values, shapes and
    state-dict keys do not change."""
    w = model.features[CONV_IDXS[-1]].weight
    if w.is_cuda and not w.is_contiguous(memory_format=torch.channels_last):
        model.to(memory_format=torch.channels_last)
    return model


def cast_params(model: VGG16, dtype: torch.dtype) -> VGG16:
    """The model's weights in ``dtype`` (for example ``torch.bfloat16``),
    cast once, not per batch."""
    return model.to(dtype)


def preprocess(images, size: int = IMAGE_SIZE, device=None) -> torch.Tensor:
    """RGB ``[N, H, W, 3]`` (uint8, divided by 255, or float) -> normalised
    ``[N, 3, size, size]`` float32 on ``device`` (the images' own for a
    tensor, else the CPU): a bilinear resize that antialiases when it
    shrinks (``jax.image.resize(..., "bilinear")``'s), skipped where the
    images are ``size`` already, then ImageNet's mean and std. Contiguous
    in channels-last memory on a CUDA device (the NHWC pixels' own order:
    no copy where no resize runs), in NCHW elsewhere."""
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images))
    if device is not None:
        images = images.to(device)
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x / 255.0
    x = x.permute(0, 3, 1, 2)
    if x.shape[2:] != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                          antialias=True)
    mean, std = _imagenet_stats(x.device, x.dtype)
    layout = torch.channels_last if x.is_cuda else torch.contiguous_format
    return ((x - mean) / std).contiguous(memory_format=layout)


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device, dtype: torch.dtype) -> tuple:
    """ImageNet's mean and std as ``[3, 1, 1]`` tensors on ``device``, made
    once: a blocking host-to-device copy of them on every batch would wait
    for the card's queue to drain."""
    return tuple(torch.tensor(v, dtype=dtype, device=device)[:, None, None]
                 for v in (IMAGENET_MEAN, IMAGENET_STD))


def features_fc7(model: VGG16, images, preprocessed: bool = False,
                 compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """fc7 features ``[N, 4096]`` float32 from raw images ``[N, H, W, 3]``
    or preprocessed ``[N, 3, 224, 224]``, on the model's device.
    ``compute_dtype`` (``torch.bfloat16``) runs the stack with activations
    in that type; the model must be cast to match (:func:`cast_params`)."""
    dev = next(model.parameters()).device
    x = images.to(dev) if preprocessed else preprocess(images, device=dev)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    return model(x).to(torch.float32)


def _staged(batch: np.ndarray, batch_size: int, pinned: bool) -> torch.Tensor:
    """``batch`` as a ``[batch_size, ...]`` host tensor, padded by repeating
    its last item (the bytes ``np.concatenate`` makes): a view of the array
    where it is whole and ``pinned`` is false, else a new buffer, written in
    place and page-locked where ``pinned`` (PyTorch's caching host
    allocator, which hands a buffer out again only once the copies that
    read it have finished). numpy writes the rows on one thread: torch's
    copy splits them over its thread pool and waits for the slowest thread,
    which on the 8-core host of an H100 stalled a 64-image batch by up to
    14 ms, an idle card at a call's first batch."""
    src = torch.from_numpy(batch)
    if batch.shape[0] == batch_size and not pinned:
        return src
    out = torch.empty((batch_size, *src.shape[1:]), dtype=src.dtype, pin_memory=pinned)
    rows = out.numpy()
    rows[:len(batch)] = batch
    rows[len(batch):] = batch[-1]
    return out


@functools.lru_cache(maxsize=None)
def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream that carries pixels from the host to ``device``."""
    return torch.cuda.Stream(device=device)


def _to_card(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Pinned ``host`` copied to ``device`` on the device's copy stream,
    so that the copy neither waits for the queued stacks nor holds up the
    host; the device's current stream waits for the copy before it runs
    anything launched after this, and keeps the result's memory until it
    has read it."""
    compute = torch.cuda.current_stream(device)
    side = _copy_stream(device)
    with torch.cuda.stream(side):
        x = host.to(device, non_blocking=True)
    compute.wait_stream(side)
    x.record_stream(compute)
    return x


def _mesh_replicas(model: VGG16, projection, mesh) -> list:
    """``(device, model, projection)`` for each ``data`` entry of ``mesh``: the
    given model and projection on their own device, a copy on each other
    device (once, however often the device repeats). A mesh that spans
    processes raises ``ValueError``: each process extracts its own file
    list instead (its pixels are on its host)."""
    if mesh.spans_processes:
        raise ValueError("extract_features(mesh=...) shards over the devices of one process; "
                         "in a multi-process job give each process its own file list instead "
                         "of sharding a global batch")
    home = next(model.parameters()).device
    copies = {}
    entries = mesh.entries("data")  # a 2-D mesh replicates over its model axis
    for d in entries:
        if d not in copies:
            same = d == home
            copies[d] = (model if same else copy.deepcopy(model).to(d),
                         None if projection is None else projection.to(d))
    return [(d, *copies[d]) for d in entries]


def _stack(model, x, compute_dtype: torch.dtype | None) -> torch.Tensor:
    """A backbone's features of a batch of pixels: its own ``extract`` where
    it has one (:meth:`.vit.VisionTransformer.extract`), else VGG16's
    :func:`features_fc7`."""
    extract = getattr(model, "extract", None)
    if extract is None:
        return features_fc7(model, x, compute_dtype=compute_dtype)
    return extract(x, compute_dtype=compute_dtype)


def iter_features(model: VGG16, images, batch_size: int = 64, projection=None, loader=None,
                  progress=None, compute_dtype: torch.dtype | None = None, mesh=None):
    """Feature blocks (numpy float32, one a batch, in input order), without
    holding the whole table: ``model`` is the backbone (VGG16 through
    :func:`features_fc7`, or a module with an ``extract(pixels,
    compute_dtype)`` method of its own: :mod:`.vit`'s CLIP tower), whose
    own preprocessing normalises the pixels; ``images`` is ``[N, H, W, 3]`` or, with
    ``loader``, any sequence whose slices ``loader`` turns into such an
    array (file paths: :func:`..cli.extract.load_image_batch`). The last
    batch is padded to ``batch_size`` by repeating its last item (one batch
    shape, as the JAX package compiles one program), the padding cut off
    the block. ``projection`` (:class:`..data.pca.PCAProjection`) maps fc7
    on the device; ``progress`` optionally wraps the batch starts (any
    iterable wrapper, for example a progress bar). Up to
    :data:`PIPELINE_DEPTH` batches stay on the device before they are read
    back, so the host decodes the next batch while the card computes. On a
    CUDA model each padded batch is written into page-locked host memory
    and copied on a side stream that the stack's stream waits for
    (``iter_features.pinned_batches`` counts those batches), and each block
    is copied back into page-locked memory as soon as its stack is queued,
    with an event of its own: reading a block back waits for its batch,
    not for the batches queued after it. On the CPU the array itself is
    the input (``iter_features.pageable_batches``).

    ``mesh`` (one process's :class:`..parallel.mesh.Mesh`) splits each
    padded batch into equal row blocks over its ``data`` entries, each on
    its device's copy of the model (the batch rounded up to a multiple of
    the entries), and joins the blocks on the model's device.

    Each batch's host phases are three sibling spans
    (:func:`..utils.profiling.annotate`): ``extract.pixels_in`` (the slice,
    decoded by ``loader`` where one is given, padded, and its copy to the
    device launched), ``extract.stack`` (the stack's and the projection's
    launches; the CLIP tower's ``vit.*`` spans nest inside it) and
    ``extract.features_out`` (the block read back, which
    waits on the device; on a card also, right after the stack, the
    launch of that copy)."""
    replicas = None
    if mesh is not None:
        replicas = _mesh_replicas(model, projection, mesh)
        batch_size = -(-batch_size // len(replicas)) * len(replicas)
    n = images.shape[0] if hasattr(images, "shape") else len(images)
    if n == 0:
        return iter(())
    dev = next(model.parameters()).device
    pinned = dev.type == "cuda"

    def to_device(x: torch.Tensor, d: torch.device) -> torch.Tensor:
        return _to_card(x, d) if pinned and d.type == "cuda" else x.to(d)

    def pixels_in(batch: np.ndarray):
        x = _staged(batch, batch_size, pinned)
        if pinned:
            iter_features.pinned_batches += 1
        else:
            iter_features.pageable_batches += 1
        if replicas is None:
            return to_device(x, dev)
        return [to_device(block, d)
                for block, (d, _, _) in zip(x.split(batch_size // len(replicas)), replicas)]

    def stack(x) -> torch.Tensor:
        if replicas is None:
            feats = _stack(model, x, compute_dtype)
            return feats if projection is None else projection.apply(feats)
        parts = []
        for block, (_, m, proj) in zip(x, replicas):
            f = _stack(m, block, compute_dtype)
            parts.append((f if proj is None else proj.apply(f)).to(dev))
        return torch.cat(parts)

    def read_back(f: torch.Tensor, real: int):
        if not pinned:
            return f[:real], None
        with annotate("extract.features_out"):
            host = torch.empty((real, *f.shape[1:]), dtype=f.dtype, pin_memory=True)
            host.copy_(f[:real], non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        return host, done

    def features_out(f: torch.Tensor, done) -> np.ndarray:
        with annotate("extract.features_out"):
            if done is not None:
                done.synchronize()
            return f.cpu().numpy()

    def blocks():
        pending = []
        starts: Iterable[int] = range(0, n, batch_size)
        if progress is not None:
            starts = progress(starts)
        for i in starts:
            with annotate("extract.pixels_in"):
                chunk = images[i:i + batch_size]
                batch = np.asarray(chunk if loader is None else loader(chunk))
                real = batch.shape[0]
                x = pixels_in(batch)
            with annotate("extract.stack"):
                f = stack(x)
            pending.append(read_back(f, real))
            if len(pending) > PIPELINE_DEPTH:
                yield features_out(*pending.pop(0))
        for f, done in pending:
            yield features_out(f, done)

    return blocks()


iter_features.pinned_batches = 0
iter_features.pageable_batches = 0


def extract_features(model: VGG16, images, batch_size: int = 64, projection=None, loader=None,
                     progress=None, compute_dtype: torch.dtype | None = None,
                     mesh=None) -> np.ndarray:
    """:func:`iter_features` as one ``[N, dim]`` float32 array (``dim`` the
    projection's components, else the backbone's ``feature_dim``, VGG16's
    4096; an empty input gives ``[0, dim]``)."""
    blocks = list(iter_features(model, images, batch_size=batch_size, projection=projection,
                                loader=loader, progress=progress, compute_dtype=compute_dtype,
                                mesh=mesh))
    if not blocks:
        dim = projection.dim if projection is not None else getattr(model, "feature_dim",
                                                                    FC7_DIM)
        return np.zeros((0, dim), np.float32)
    with annotate("extract.features_out"):
        return np.concatenate(blocks, axis=0)


def print_progress(desc: str):
    """A ``progress`` wrapper for :func:`iter_features` that prints one line
    per batch to stderr (the card's machine has no progress-bar package)."""

    def wrap(starts):
        starts = list(starts)
        for k, i in enumerate(starts):
            yield i
            print(f"{desc}: batch {k + 1}/{len(starts)}", file=sys.stderr, flush=True)

    return wrap
