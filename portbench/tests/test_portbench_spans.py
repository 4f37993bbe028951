"""The program's spans read against the device's idle time
(``portbench/spans.py``) and the five readers that use them: the idle
stretches inside named host ranges on a synthetic trace, nothing read from
a program without spans, and the Captioner's spans found in a reduced CPU
trace."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import TINY
from portbench import harness, spans

READERS = {"strings_ms_per_call.caption": "caption", "unattributed_idle_share.caption": "caption",
           "saves_ms_per_epoch.train": "train", "chunk_host_ms_per_minibatch.train": "train",
           "unattributed_idle_share.train": "train"}


def _trace(host):
    # device busy over [0, 10], [30, 40] and [70, 80] of a stretch [0, 100]:
    # gaps (10, 30), (40, 70), (80, 100), 70 us idle
    dev = [("k", 0.0, 10.0, 1), ("k", 30.0, 40.0, 2), ("k", 70.0, 80.0, 3)]
    return harness.Trace(dev, host, [], [], 0.0, 100.0, 1e-4)


def test_idle_inside_partial_overlaps_counted_once():
    tr = _trace([("a", 5.0, 20.0), ("a", 15.0, 35.0), ("b", 45.0, 50.0), ("a", 60.0, 90.0),
                 ("aten::mm", 0.0, 100.0)])
    assert tr.gaps() == [(10.0, 30.0), (40.0, 70.0), (80.0, 100.0)]
    assert spans.union(tr, ["a"]) == [(5.0, 35.0), (60.0, 90.0)]
    # a: 10-30 (the two overlapping ranges once), 60-70, 80-90; b: 45-50
    assert spans.idle_inside(tr, ["a"]) == pytest.approx(40e-6)
    assert spans.idle_inside(tr, ["b"]) == pytest.approx(5e-6)
    assert spans.idle_inside(tr, ["a", "b"]) == pytest.approx(45e-6)
    assert spans.idle_inside(tr, ["c"]) == 0.0
    assert spans.idle_s(tr) == pytest.approx(70e-6)
    share = spans.unattributed_share(tr, ["a", "b"])
    assert share == pytest.approx(100.0 * 25 / 70)
    # the spans and what they leave unattributed make the whole idle time
    assert spans.idle_inside(tr, ["a", "b"]) + share / 100 * spans.idle_s(tr) == pytest.approx(
        spans.idle_s(tr))
    assert spans.unattributed_share(tr, ["c"]) is None  # no such span: nothing read


WARM, WINDOW = 2, 3  # the set-up's and the window's epochs of the synthetic run


def _ctx(trace, calls=2, traced_epochs=1):
    tracer = type("T", (), {"trace": trace})()
    ctx = type("C", (), {"tracer": tracer, "device": "cpu", "spans": harness.Spans(),
                         "traffic": {"warmup_epochs": WARM}})()
    for j in range(calls):
        ctx.spans.add("traced_call", float(j), j + 0.5)
    for j in range(WARM + WINDOW + traced_epochs):  # one span a trainer's epoch line
        ctx.spans.add("epoch", float(j), j + 1.0)
    return ctx


OUT = {"trace_info": {"minibatches": [512, 512, 100]}, "notes": {"epochs": WINDOW}}


@pytest.mark.parametrize("traced_epochs", [1, 2])
def test_readers_on_a_traced_program_with_spans(traced_epochs):
    """The five readers on a synthetic trace; the training readers divide
    by the epochs the run traced, counted from its epoch spans."""
    host = [("caption.strings", 12.0, 28.0), ("caption.search", 40.0, 42.0),
            ("train.dispatch", 45.0, 50.0), ("train.losses", 50.0, 52.0),
            ("train.snapshot", 80.0, 99.0), ("train.capture", 60.0, 70.0)]
    ctx = _ctx(_trace(host), traced_epochs=traced_epochs)
    assert spans.traced_epochs(ctx, OUT) == traced_epochs
    read = {name: harness.metric_reader(name).read(ctx, OUT) for name in READERS}
    assert read["strings_ms_per_call.caption"] == pytest.approx(16e-3 / 2)
    assert read["unattributed_idle_share.caption"] == pytest.approx(100.0 * (70 - 18) / 70)
    assert read["saves_ms_per_epoch.train"] == pytest.approx(19e-3 / traced_epochs)
    assert read["chunk_host_ms_per_minibatch.train"] == pytest.approx(
        7e-3 / (3 * traced_epochs))
    assert read["unattributed_idle_share.train"] == pytest.approx(100.0 * (70 - 36) / 70)


def test_traced_epochs_counts_the_epochs_the_profiler_ran():
    """A training run's traced epochs, as ``trainrun.timed_epochs`` starts
    and stops the profiler at the trainer's epoch lines: the epochs between
    its start and its stop."""
    from portbench import trainrun

    events = []
    tracer = type("T", (), {"start": lambda self: events.append("start"),
                            "stop": lambda self: events.append("stop")})()
    ctx = type("C", (), {"tracer": tracer, "spans": harness.Spans(),
                         "traffic": {"warmup_epochs": WARM}})()
    total = WARM + WINDOW + 1

    def trainer():
        for e in range(total):
            events.append(e)
            print(f"Training (1/1) ({e + 1}/{total}): 0.1 s", flush=True)

    trainrun.timed_epochs(ctx, "Training (1/1)", trainer, WARM, WINDOW)
    ran = events[events.index("start") + 1: events.index("stop")]
    assert spans.traced_epochs(ctx, {"notes": {"epochs": WINDOW}}) == len(ran) == 1


def test_readers_find_nothing_without_the_programs_spans():
    """A program that names no phases (the parent of the spans) and a run
    without a trace: every reader reports nothing and raises nothing."""
    bare = _ctx(_trace([("aten::mm", 0.0, 100.0)]))
    untraced = type("C", (), {"tracer": None, "device": "cpu", "spans": harness.Spans()})()
    for name in READERS:
        reader = harness.metric_reader(name)
        assert reader.read(bare, OUT) is None, name
        assert reader.read(untraced, OUT) is None, name


def test_the_captioners_spans_reach_the_reduced_trace():
    """A profiled caption call on the CPU, reduced as the harness reduces a
    traced stretch: the main thread's host ranges hold the four
    ``caption.*`` spans, which the caption readers read."""
    from image_captioning_through_rl_tpu_torch.api import Captioner
    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.data.coco import decode_captions
    from image_captioning_through_rl_tpu_torch.models import policy, value

    cfg = NetConfig(vocab_size=TINY["vocab_size"], input_dim=TINY["input_dim"],
                    wordvec_dim=TINY["wordvec_dim"], hidden_dim=TINY["hidden_dim"],
                    max_seq_len=7)
    gen = torch.Generator().manual_seed(0)
    idx_to_word = {i: f"w{i}" for i in range(cfg.vocab_size)}
    cap = Captioner({"policy": policy.init(gen, cfg), "value": value.init(gen, cfg)}, cfg,
                    idx_to_word, device="cpu")
    feats = np.random.default_rng(0).standard_normal((4, cfg.input_dim)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        decode_captions(cap.caption_tokens(feats, beam_size=3), idx_to_word)
    trace = harness.reduce_profile(prof, 1e-3)
    names = [n for n, _, _ in trace.host if n.startswith("caption.")]
    assert sorted(names) == sorted(["caption.features_in", "caption.search",
                                    "caption.tokens_out", "caption.strings"])
    ctx = _ctx(trace, calls=1)
    assert harness.metric_reader("strings_ms_per_call.caption").read(ctx, OUT) > 0
    share = harness.metric_reader("unattributed_idle_share.caption").read(ctx, OUT)
    assert 0 <= share < 100
