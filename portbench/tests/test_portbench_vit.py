"""The CLIP image cell (``images-beam5-clipl14-336``) on the CPU at a tiny
tower (width 64, 4 heads, 2 layers, 56 px) and tiny captioning nets: a
sound run is correct with nothing of JAX loaded, its reference imports
nothing of the program, each fault planted in the tower that the limits
separate turns ``correct`` false, the float8 control reads far above the
program, the three readers read synthetic and CPU traces and find nothing
in a program without the ``vit.*`` spans."""

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
from portbench import counts_vit, harness

CELL = "images-beam5-clipl14-336"
TINY_CONFIG = {"vocab_size": 30, "input_dim": 8, "wordvec_dim": 16, "hidden_dim": 16,
               "image_size": 56, "hidden_size": 64, "num_attention_heads": 4,
               "num_hidden_layers": 2, "intermediate_size": 256, "projection_dim": 32}
TINY_TRAFFIC = {"ring_images": 4, "group_images": 2, "extract_batch": 2, "pca_fit_images": 16,
                "check_calls": 2, "check_calls_from": 2, "trace_calls": 1, "warmup_calls": 1}
FORBIDDEN = ("jax", "jaxlib", "flax", "image_captioning_through_rl_tpu")
READERS = ("vit_l14_roofline", "attention_roofline.vit", "mlp_roofline.vit")


def run_tiny(seed: int = SEED) -> dict:
    import run as bench
    return bench.run_cell(load_cell(CELL), seed, 1, False, device="cpu",
                          config_override=TINY_CONFIG, traffic_override=TINY_TRAFFIC)


def _python(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_the_clip_cell_runs_tiny_without_jax():
    out = _python(f"""
        import json, sys
        sys.path[:0] = ["portbench/tests", "portbench", "."]
        import test_portbench_vit as t
        res = t.run_tiny()
        import calibrate_vit  # noqa: F401  the cell's calibration too
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


def test_the_vit_reference_imports_nothing_of_the_program():
    out = _python("""
        import json, sys
        sys.path[:0] = ["."]
        import portbench.reference.vit, portbench.counts_vit  # noqa: F401
        import portbench.span_launches  # noqa: F401
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert not top & (set(FORBIDDEN) | {"image_captioning_through_rl_tpu_torch"})


@pytest.mark.parametrize("fault, number", [
    ("attention_scale_1_32", "feature_gap"), ("ln_pre_skipped", "feature_gap"),
    ("positions_shifted", "feature_gap"), ("imagenet_stats", "pca_mean_gap"),
    ("mean_not_subtracted", "feature_gap")])
def test_a_fault_in_the_tower_fails_the_check(fault, number):
    """Each fault planted in the program for the whole run (its PCA fit
    included) parts the features from the reference's, or the fit from the
    reference's own, past the limit; the captions, searched on the
    program's own features, stay sound. (The exact erf GELU in QuickGELU's
    place moves the features about as much as bf16's rounding does: no
    limit separates it, at this size or on the card.)"""
    import calibrate_vit
    with calibrate_vit.vit_fault(fault):
        res = run_tiny()
    assert not res["correct"], res["checks"]
    c = res["checks"]
    assert c[number]["value"] > c[number]["limit"], c
    assert c["topb_gap"]["value"] <= c["topb_gap"]["limit"], c


def test_the_float8_control_reads_far_above_the_program():
    import calibrate
    import run as bench
    cell = load_cell(CELL)
    entry = harness.entry_module(cell.entry)
    with tempfile.TemporaryDirectory() as work:
        ctx = bench.Context(cell, SEED, 0, False, "cpu", work, TINY_CONFIG, TINY_TRAFFIC)
        ctx.t_start = time.perf_counter()
        prog, pixels, _, projection = entry.sampled_calls(ctx)
        dev = torch.device("cpu")
        cfg = ctx.config
        program = entry.feature_gap(cfg, SEED, prog, pixels, projection, dev)
        control = entry.feature_gap(cfg, SEED, prog, pixels, projection, dev, calibrate.FP8)
    # the control's own tower against the program's features: float8's
    # rounding, several times bf16's
    assert control > 3 * program > 0, (program, control)


def _ctx(trace, calls=2):
    tracer = type("T", (), {"trace": trace})()
    ctx = type("C", (), {"tracer": tracer, "device": "cuda", "spans": harness.Spans()})()
    for j in range(calls):
        ctx.spans.add("traced_call", float(j), j + 0.5)
    return ctx


OUT = {"trace_info": {"extract_batch": 64, "pca_dim": 512, "window_s": 2.0,
                      "window_flops": 3e14, "group": 256, "tower": counts_vit.L14_336,
                      "shape": (1004, 512, 512, 512, 17, 5)}}


def _trace():
    """One stack holding two blocks' spans: an attention (operation 3) and
    an MLP (4-5) launched inside their spans, a launch of another thread
    inside the second attention (9), the first stack operations (2, 6)
    outside the inner spans, a beam kernel launched outside every span."""
    host = [("extract.pixels_in", 0.0, 1.0), ("extract.stack", 1.0, 10.0),
            ("vit.attention", 2.0, 3.0), ("vit.mlp", 3.5, 5.0),
            ("vit.attention", 6.0, 7.0), ("vit.mlp", 7.5, 8.5),
            ("extract.features_out", 10.0, 40.0), ("caption.search", 41.0, 42.0)]
    launches = [(1.5, 2, 7), (2.5, 3, 7), (4.0, 4, 7), (4.5, 5, 7), (5.5, 6, 7), (6.5, 10, 7),
                (6.6, 9, 8), (8.0, 11, 7), (41.5, 8, 7)]
    device = [("gemm", 10.0, 20.0, 2), ("flash_fwd_kernel", 20.0, 30.0, 3),
              ("gemm", 30.0, 40.0, 4), ("elementwise", 40.0, 42.0, 5),
              ("gemm", 42.0, 50.0, 6), ("flash_fwd_kernel", 50.0, 58.0, 10),
              ("gemm", 58.0, 70.0, 11), ("beam_kernel", 71.0, 85.0, 8),
              ("other thread", 90.0, 95.0, 9)]
    return harness.Trace(device, host, launches, [], 0.0, 100.0, 1e-4)


def test_readers_on_a_synthetic_trace():
    ctx = _ctx(_trace())
    read = {name: harness.metric_reader(name).read(ctx, OUT) for name in READERS}
    # the stack: operations 2-6, 10, 11 (10 + 10 + 10 + 2 + 8 + 8 + 12 us); not
    # the other thread's 9 nor the beam
    assert read["vit_l14_roofline"] == pytest.approx(
        100.0 * counts_vit.bound_s(64, 512) / 60e-6)
    # two attention spans: 10 + 8 us
    assert read["attention_roofline.vit"] == pytest.approx(
        100.0 * 2 * counts_vit.attention(64).bound_s() / 18e-6)
    # two MLP spans: 10 + 2 and 12 us
    mlp = sum(w.bound_s() for _, w in counts_vit.mlp(64))
    assert read["mlp_roofline.vit"] == pytest.approx(100.0 * 2 * mlp / 24e-6)


def test_readers_find_nothing_without_the_towers_spans():
    """A program without the ``vit.*`` and ``extract.*`` spans (the parent of
    this cell), a run without a trace, and a VGG16 run (no ``tower``): the
    readers report nothing and raise nothing."""
    bare = _trace()
    bare.host = [h for h in bare.host if not h[0].startswith(("vit.", "extract."))]
    untraced = type("C", (), {"tracer": None, "device": "cuda", "spans": harness.Spans()})()
    vgg = {"trace_info": {k: v for k, v in OUT["trace_info"].items() if k != "tower"}}
    for name in READERS:
        reader = harness.metric_reader(name)
        assert reader.read(_ctx(bare), OUT) is None, name
        assert reader.read(untraced, OUT) is None, name
        assert reader.read(_ctx(_trace()), vgg) is None, name


def test_the_towers_spans_reach_the_reduced_trace():
    """A profiled extraction through a tiny tower on the CPU, reduced as the
    harness reduces a traced stretch: the main thread's host ranges hold
    the ``vit.*`` spans inside ``extract.stack``; a CPU run launches
    nothing, so the readers find no launch."""
    from image_captioning_through_rl_tpu_torch.models import vgg, vit
    model = vit.init(torch.Generator().manual_seed(0), image_size=28, patch=14, width=32,
                     layers=2, heads=2, mlp=64, output_dim=16)
    images = np.random.default_rng(0).integers(0, 256, (3, 28, 28, 3), dtype=np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vgg.extract_features(model, images, batch_size=2)
    trace = harness.reduce_profile(prof, 1e-3)
    names = [n for n, _, _ in trace.host if n.startswith(("vit.", "extract.stack"))]
    assert names.count("extract.stack") == 2
    assert names.count("vit.attention") == names.count("vit.mlp") == 4
    ctx = _ctx(trace, calls=1)
    for name in READERS:
        assert harness.metric_reader(name).read(ctx, OUT) is None, name
