"""The image cell (``images-beam5-vgg16``) on the CPU at tiny captioning
nets and a few 224x224 images (VGG16 keeps its published widths): a sound
run is correct with nothing of JAX loaded, its reference imports nothing
of the program, each fault planted in the front end turns ``correct``
false, the float8 control reads far above the program, the reference's
PCA numbers see a bad fit, the three readers read synthetic and CPU
traces and find nothing in a program without the front end's spans, and
``counts_vgg`` counts the program module's own products."""

import json
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import ROOT, SEED, load_cell
from portbench import counts, counts_vgg, harness

CELL = "images-beam5-vgg16"
TINY_CONFIG = {"vocab_size": 30, "input_dim": 8, "wordvec_dim": 16, "hidden_dim": 16}
TINY_TRAFFIC = {"ring_images": 4, "group_images": 2, "extract_batch": 2, "pca_fit_images": 8,
                "check_calls": 2, "check_calls_from": 2, "trace_calls": 1, "warmup_calls": 1}
FORBIDDEN = ("jax", "jaxlib", "flax", "image_captioning_through_rl_tpu")
READERS = ("vgg16_roofline", "extract_idle_ms_per_call.images", "mfu.images")


def run_tiny(seed: int = SEED) -> dict:
    import run as bench
    return bench.run_cell(load_cell(CELL), seed, 1, False, device="cpu",
                          config_override=TINY_CONFIG, traffic_override=TINY_TRAFFIC)


def _python(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_the_image_cell_runs_tiny_without_jax():
    out = _python(f"""
        import json, sys
        sys.path[:0] = ["portbench/tests", "portbench", "."]
        import test_portbench_vgg as t
        res = t.run_tiny()
        import calibrate_images  # noqa: F401  the cell's calibration too
        print(json.dumps([res["correct"], sorted(res["metrics"]), res["checks"],
                          sorted({{m.split(".")[0] for m in sys.modules}})]))
    """)
    correct, names, checks, top = json.loads(out.strip().splitlines()[-1])
    assert correct, checks
    assert names == ["caption_call_p95_ms", "captions_per_s", "setup_s"]
    assert list(checks) == ["pca_mean_gap", "pca_variance_gap", "feature_gap",
                            "strings_mismatched", "topb_gap", "score_excess_mean",
                            "rows_scored_worse"]
    for name in ("pca_mean_gap", "pca_variance_gap", "feature_gap"):
        assert 0 < checks[name]["value"] <= checks[name]["limit"], name
    assert not set(top) & set(FORBIDDEN), set(top) & set(FORBIDDEN)
    assert "image_captioning_through_rl_tpu_torch" in top


def test_the_vgg_reference_imports_nothing_of_the_program():
    out = _python("""
        import json, sys
        sys.path[:0] = ["."]
        import portbench.reference.vgg, portbench.counts_vgg  # noqa: F401
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert not top & (set(FORBIDDEN) | {"image_captioning_through_rl_tpu_torch"})


@pytest.mark.parametrize("fault, number", [
    ("relu_dropped", "feature_gap"), ("nhwc_flatten", "feature_gap"),
    ("std_skipped", "feature_gap"), ("mean_not_subtracted", "feature_gap"),
    ("uncentred_fit", "pca_variance_gap"), ("components_reversed", "pca_variance_gap")])
def test_a_fault_in_the_front_end_fails_the_check(fault, number):
    """Each fault planted in the program for the whole run (its PCA fit
    included) parts the features from the reference's, or the fit from the
    reference's own, past the limit; the captions, searched on the
    program's own features, stay sound."""
    import calibrate_images
    with calibrate_images.vision_fault(fault):
        res = run_tiny()
    assert not res["correct"], res["checks"]
    c = res["checks"]
    assert c[number]["value"] > c[number]["limit"], c
    assert c["topb_gap"]["value"] <= c["topb_gap"]["limit"], c


def _table(n=32, d=48, seed=0):
    gen = torch.Generator().manual_seed(seed)
    scale = 0.8 ** torch.arange(d, dtype=torch.float32)
    return torch.randn(n, d, generator=gen) * scale + 3.0


def _bad_fits(table, k):
    """Fits of ``table`` each wrong in one way, by name."""
    from portbench.reference import vgg as ref_vgg
    mean, comps = ref_vgg.fit_pca(table, k)
    _, _, vt = torch.linalg.svd(table.double(), full_matrices=False)
    q, _ = torch.linalg.qr(torch.randn(table.shape[1], k, dtype=torch.float64,
                                       generator=torch.Generator().manual_seed(1)))
    return {"sound": (mean, comps), "mean_zero": (torch.zeros_like(mean), comps),
            "reversed": (mean, comps.flip(1)), "uncentred": (mean, vt[:k].T),
            "scaled": (mean, 1.1 * comps), "random_basis": (mean, q),
            "signs_flipped": (mean, -comps)}


@pytest.mark.parametrize("fit", ["sound", "signs_flipped", "mean_zero", "reversed", "uncentred",
                                 "scaled", "random_basis"])
def test_the_pca_numbers_see_a_bad_fit_and_not_the_signs(fit):
    from portbench.reference import vgg as ref_vgg
    table, k = _table(), 8
    gaps = ref_vgg.pca_gaps(table, *ref_vgg.fit_pca(table, k), *_bad_fits(table, k)[fit])
    limits = load_cell(CELL).spec["limits"]
    over = {name for name, gap in gaps.items() if gap > limits[name]}
    assert over == {"mean_zero": {"pca_mean_gap"}}.get(
        fit, set() if fit in ("sound", "signs_flipped") else {"pca_variance_gap"}), gaps


def test_the_float8_control_reads_far_above_the_program():
    import calibrate_images
    import run as bench
    cell = load_cell(CELL)
    entry = harness.entry_module(cell.entry)
    with tempfile.TemporaryDirectory() as work:
        ctx = bench.Context(cell, SEED, 0, False, "cpu", work, TINY_CONFIG, TINY_TRAFFIC)
        ctx.t_start = time.perf_counter()
        prog, pixels, _, projection = entry.sampled_calls(ctx)
        dev = torch.device("cpu")
        program = entry.feature_gap(SEED, prog, pixels, projection, dev)
        control = entry.feature_gap(SEED, prog, pixels, projection, dev,
                                    calibrate_images.calibrate.FP8)
    # the control's own stack against the program's features: float8's
    # rounding, several times bf16's
    assert control > 3 * program > 0, (program, control)


def _ctx(trace, calls=2):
    tracer = type("T", (), {"trace": trace})()
    ctx = type("C", (), {"tracer": tracer, "device": "cuda", "spans": harness.Spans()})()
    for j in range(calls):
        ctx.spans.add("traced_call", float(j), j + 0.5)
    return ctx


OUT = {"trace_info": {"extract_batch": 64, "pca_dim": 512, "window_s": 2.0,
                      "window_flops": 3e14, "group": 1016,
                      "shape": (1004, 512, 512, 512, 17, 5)}}


def _trace():
    """Two batches' spans, a launch of another thread inside the second
    stack (operation 9), a copy and a beam kernel launched outside them, and
    the device idle over (0, 2), (12, 20), (30, 31), (45, 60), (70, 100) of
    a stretch (0, 100)."""
    host = [("extract.pixels_in", 0.0, 1.0), ("extract.stack", 1.0, 4.0),
            ("extract.pixels_in", 4.0, 5.0), ("extract.stack", 5.0, 7.0),
            ("extract.features_out", 7.0, 40.0), ("caption.search", 41.0, 42.0)]
    launches = [(0.5, 1, 7), (2.0, 2, 7), (3.0, 3, 7), (4.5, 4, 7), (6.0, 5, 7), (6.2, 6, 7),
                (6.4, 9, 8), (6.5, 7, 7), (41.5, 8, 7)]
    device = [("Memcpy HtoD", 2.0, 4.0, 1), ("conv", 4.0, 10.0, 2), ("relu", 10.0, 12.0, 3),
              ("Memcpy HtoD", 20.0, 21.0, 4), ("conv", 21.0, 25.0, 5), ("cudnn", 25.0, 28.0, 6),
              ("gemm", 28.0, 30.0, 7), ("beam_kernel", 31.0, 45.0, 8),
              ("other thread", 60.0, 70.0, 9)]
    return harness.Trace(device, host, launches, [], 0.0, 100.0, 1e-4)


def test_readers_on_a_synthetic_trace():
    ctx = _ctx(_trace())
    read = {name: harness.metric_reader(name).read(ctx, OUT) for name in READERS}
    roof = harness.metric_reader("vgg16_roofline")
    # the first stack's operations 2-3 (8 us), the second's 5-7 (9 us); not
    # the other thread's 9, nor the copies and the beam launched outside
    assert roof.stack_seconds(_trace()) == pytest.approx(17e-6)
    assert read["vgg16_roofline"] == pytest.approx(
        100.0 * 2 * counts_vgg.bound_s(64, 512) / 17e-6)
    # idle inside the extract spans: (0, 2) and (12, 20) and (30, 31)
    assert read["extract_idle_ms_per_call.images"] == pytest.approx(11e-3 / 2)
    assert read["mfu.images"] == pytest.approx(100.0 * 3e14 / 2.0 / counts.PEAK_BF16)


def test_readers_find_nothing_without_the_front_ends_spans():
    """A program without the ``extract.*`` spans (the parent of this cell)
    and a run without a trace: the span readers report nothing and raise
    nothing; ``mfu.images`` reads the window alone."""
    bare = _trace()
    bare.host = [h for h in bare.host if not h[0].startswith("extract.")]
    untraced = type("C", (), {"tracer": None, "device": "cuda", "spans": harness.Spans()})()
    for name in READERS[:2]:
        reader = harness.metric_reader(name)
        assert reader.read(_ctx(bare), OUT) is None, name
        assert reader.read(untraced, OUT) is None, name
    assert harness.metric_reader("mfu.images").read(untraced, OUT) > 0


def test_the_front_ends_spans_reach_the_reduced_trace():
    """A profiled extraction on the CPU, reduced as the harness reduces a
    traced stretch: the main thread's host ranges hold the three spans,
    which the idle reader reads (a CPU run launches nothing, so the
    roofline reader finds no launch)."""
    from image_captioning_through_rl_tpu_torch.models import vgg
    model = vgg.VGG16(device="cpu").init(torch.Generator().manual_seed(0))
    images = np.random.default_rng(0).integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vgg.extract_features(model, images, batch_size=2)
    trace = harness.reduce_profile(prof, 1e-3)
    names = [n for n, _, _ in trace.host if n.startswith("extract.")]
    assert sorted(set(names)) == ["extract.features_out", "extract.pixels_in", "extract.stack"]
    assert names.count("extract.stack") == 2
    ctx = _ctx(trace, calls=1)
    assert harness.metric_reader("extract_idle_ms_per_call.images").read(ctx, OUT) > 0
    assert harness.metric_reader("vgg16_roofline").read(ctx, OUT) is None


def _module_products(n: int) -> dict:
    """2 x multiply-adds of each convolution and linear layer of the
    program's VGG16, from the output shapes a meta-device forward gives."""
    from image_captioning_through_rl_tpu_torch.models import vgg
    model = vgg.VGG16(device="meta")
    got = {}

    def hook(mod, inputs, output):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
        else:
            k = mod.in_features
        got[len(got)] = 2.0 * output.numel() * k
    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            mod.register_forward_hook(hook)
    model(torch.empty(n, 3, 224, 224, device="meta"))
    return got


@pytest.mark.parametrize("n", [1, 64])
def test_counts_vgg_products_are_the_modules(n):
    """The counted products of the 13 convolutions and fc6, fc7 equal the
    program module's own at its shapes: 30.93 GFLOP an image (30.69 in the
    convolutions), and the projection's 2 x 4096 x k more."""
    mine = [w.flops for name, w in counts_vgg.layers(n, 512) if name.startswith(("conv", "fc"))]
    assert mine == list(_module_products(n).values())
    assert sum(mine) / n == pytest.approx(30.93233664e9)
    assert sum(mine[:13]) / n == pytest.approx(30.693261312e9)
    assert counts_vgg.flops(n, 512) == pytest.approx(sum(mine) + 2.0 * n * 4096 * 512)


def test_counts_vgg_bound_at_the_cells_batch():
    """At batch 64 the stack's bound is the sum of its layers': 2.487 ms,
    above the 2.006 ms its products alone take at the bf16 peak."""
    assert counts_vgg.bound_s(64, 512) == pytest.approx(2.4872752541e-3, rel=1e-9)
    assert counts_vgg.bound_s(64, 512) > counts_vgg.flops(64, 512) / counts.PEAK_BF16
