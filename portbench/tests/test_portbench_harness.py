"""The harness's own arithmetic: the trainers' epoch clock, the trace's
busy time, idle gaps and launch ranges, and the per-layer readers that
find nothing to read."""

import io
import sys
import tempfile

import pytest

from conftest import SEED, tiny_ctx
from portbench import harness, splits


def test_epoch_clock_times_only_the_trainers_epoch_lines(monkeypatch):
    monkeypatch.setattr(sys, "stderr", io.StringIO())
    seen = []
    clock = harness.EpochClock("Training A2C Network", lambda n, t: seen.append(n))
    with clock.installed():
        print("[Training] Training Advantage Actor-Critic Network")
        print("Training A2C Network (1/3): 6.0 s, best loss 0.1")
        sys.stdout.write("Training A2C Network (2/3): 6.1 s")
        sys.stdout.write(", best loss 0.0\nTraining A2C Network (3/3): 6.0 s\n")
    assert seen == [1, 2, 3] and len(clock.times) == 3
    assert "Training A2C Network (2/3)" in sys.stderr.getvalue()


@pytest.mark.parametrize("cell", ["a2c-e512", "policy-xe-w2v300"])
def test_the_trainers_epoch_lines_are_the_clocks(cell, capsys):
    """The training window's bounds are read from the trainer's printed
    end-of-epoch lines: pinned here, so that a change of their wording fails
    here first. The checked steps run one epoch, then a resumed second."""
    with tempfile.TemporaryDirectory() as work:
        ctx, entry = tiny_ctx(cell, SEED, work)
        entry.first_steps(ctx, with_train=False)
    printed = capsys.readouterr().out
    clock = harness.EpochClock(entry.EPOCH_LINE)
    clock.write(printed)
    lines = [ln for ln in printed.splitlines() if ln.startswith(entry.EPOCH_LINE + " (")]
    assert len(clock.times) == 2 and len(lines) == 2, printed[-2000:]
    assert lines[0].startswith(entry.EPOCH_LINE + " (1/1):"), lines
    assert lines[1].startswith(entry.EPOCH_LINE + " (2/2):"), lines


def test_spans():
    spans = harness.Spans()
    spans.add("call", 1.0, 1.5)
    with spans.span("reference"):
        pass
    spans.add("call", 2.0, 2.25)
    assert spans.of("call") == [(1.0, 1.5), (2.0, 2.25)]
    assert spans.seconds()["call"] == pytest.approx(0.75) and "reference" in spans.seconds()


def test_trace_busy_gaps_and_ranges():
    dev = [("k1", 0.0, 10.0, 1), ("k2", 5.0, 20.0, 2), ("k3", 40.0, 50.0, 3), ("k4", 60.0, 61.0, 4)]
    host = [("op", 0.0, 30.0), ("other", 35.0, 39.0)]
    launches = [(1.0, 1, 7), (2.0, 2, 7), (36.0, 3, 7), (55.0, 4, 8)]
    ranges = [("_F", 0.5, 3.0, 7), ("_F", 35.0, 39.0, 7), ("_F", 50.0, 70.0, 7)]
    tr = harness.Trace(dev, host, launches, ranges, 0.0, 100.0, 1e-4)
    assert tr.busy_s() == pytest.approx(31e-6)
    assert tr.gaps() == [(20.0, 40.0), (50.0, 60.0), (61.0, 100.0)]
    assert tr.in_ranges("_F") == pytest.approx([25e-6, 10e-6, 0.0])  # thread 8's launch is not
    assert tr.in_ranges("_G") is None
    bd = harness.breakdown(tr, top=2)
    assert bd["device_ops"][0][0] == "k2"
    assert bd["idle_gaps"][0] == ["host Python after other", pytest.approx(39e-6)]
    assert bd["idle_gaps"][1] == ["op", pytest.approx(20e-6)]


def test_readers_find_nothing_without_a_trace():
    ctx = type("C", (), {"tracer": None, "device": "cpu", "spans": harness.Spans()})()
    out = {"trace_info": {"minibatches": [512], "steps": 16, "window_s": 1.0,
                          "window_flops": 1.0, "shape": (1004, 512, 512, 512)}}
    for name in ("device_ms_per_minibatch", "device_ops_per_minibatch", "rollout_fwd_roofline",
                 "rollout_bwd_roofline", "lstm_chain_fwd_roofline", "lstm_chain_bwd_roofline",
                 "beam_roofline", "idle_share.train", "idle_share.caption", "mfu.train",
                 "mfu.caption", "host_ms_per_call.caption"):
        assert harness.metric_reader(name).read(ctx, out) is None, name


@pytest.mark.parametrize("seconds, epoch, want", [(30, 6.0, 5), (1, 6.0, 1), (30, 1.5, 20)])
def test_epochs_for(seconds, epoch, want):
    assert splits.epochs_for(seconds, epoch) == want
