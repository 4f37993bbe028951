"""What the benchmark loads, and how it finds its cells: nothing of JAX or
of the JAX package in the process that runs a cell, nothing of the program
in the reference, and a configuration, a cell and a per-layer metric added
as new files only."""

import json
import shutil
import subprocess
import sys
import textwrap

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "image_captioning_through_rl_tpu")


def _python(code: str, cwd=ROOT) -> str:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_a_run_loads_no_jax_and_no_jax_package():
    out = _python("""
        import json, sys
        sys.path[:0] = ["portbench/tests", "portbench", "."]
        from conftest import run_tiny
        for cell in ("a2c-e512", "beam5-e512", "policy-xe-w2v300"):
            assert run_tiny(cell)["correct"], cell
        import calibrate, harness  # noqa: F401  every module of the harness
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)
    assert "image_captioning_through_rl_tpu_torch" in top  # the program was run


def test_the_reference_imports_nothing_of_the_program():
    out = _python("""
        import json, sys
        sys.path[:0] = ["."]
        import portbench.reference.beam, portbench.reference.judge  # noqa: F401
        import portbench.reference.nets, portbench.reference.prng  # noqa: F401
        import portbench.reference.train, portbench.counts, portbench.traffic  # noqa: F401
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert not top & (set(FORBIDDEN) | {"image_captioning_through_rl_tpu_torch"})


def test_a_cell_a_configuration_and_a_metric_added_as_files(tmp_path):
    """A copy of the checkout's benchmark gains a configuration, a traffic
    mix (a cell) and a per-layer metric by new files and new entries in
    BENCHMARK.json; the harness, unedited, runs the cell and reads the
    metric."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/coco-e512.json").read_text())
    cfg["hidden_dim"] = 1024
    (tmp_path / "portbench/configs/coco-e512-h1024.json").write_text(json.dumps(cfg))
    cell = json.loads((ROOT / "portbench/workloads/beam5-e512.json").read_text())
    cell.update(config="coco-e512-h1024")
    cell["traffic"]["beam_size"] = 3
    (tmp_path / "portbench/workloads/beam3-h1024.json").write_text(json.dumps(cell))
    (tmp_path / "portbench/metrics/calls_per_s.caption.py").write_text(textwrap.dedent("""
        def read(ctx, out):
            calls = ctx.spans.of("traced_call")
            return len(calls) / max(sum(e - s for s, e in calls), 1e-9)
    """))
    bench["configs"].append({"name": "coco-e512-h1024", "source": "https://example.org",
                             "file": "portbench/configs/coco-e512-h1024.json",
                             "reduced": [], "why": "a test's configuration"})
    bench["workloads"].append({"name": "beam3-h1024", "config": "coco-e512-h1024",
                               "traffic": "beam3-h1024", "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({"name": "calls_per_s.caption", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "Captioner (api.py)",
                               "moves": "captions_per_s", "workloads": ["beam3-h1024"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("captions_per_s", "caption_call_p95_ms"):
            m["workloads"].append("beam3-h1024")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pkg = "image_captioning_through_rl_tpu_torch"
    (tmp_path / pkg).symlink_to(ROOT / pkg, target_is_directory=True)
    out = _python(f"""
        import json, sys
        sys.path[:0] = ["portbench/tests", "portbench", "."]
        import conftest, run
        from portbench import harness
        cell = harness.load_cell(harness.Path("."), "beam3-h1024")
        assert cell.config["hidden_dim"] == 1024 and cell.spec["traffic"]["beam_size"] == 3
        assert [m["name"] for m in cell.per_layer][-1] == "calls_per_s.caption"
        res = run.run_cell(cell, 5, 1, False, device="cpu",
                           config_override=dict(conftest.TINY, hidden_dim=24),
                           traffic_override=conftest.TINY_TRAFFIC["beam5-e512"])
        ctx = type("C", (), {{"tracer": None, "spans": harness.Spans()}})()
        ctx.spans.add("traced_call", 0.0, 0.5)
        ctx.spans.add("traced_call", 0.5, 1.0)
        rate = harness.metric_reader("calls_per_s.caption").read(ctx, {{}})
        print(json.dumps([res["correct"], sorted(res["metrics"]), rate]))
    """, cwd=tmp_path)
    correct, names, rate = json.loads(out.strip().splitlines()[-1])
    assert correct and names == ["caption_call_p95_ms", "captions_per_s", "setup_s"]
    assert rate == 2.0
