"""A run driven past the harness's look for a card, on the CPU at tiny
sizes, with the timed path broken underneath: each fault the cell can
have must turn ``correct`` false, and a sound run must keep it true. The
control (the reference in float8, put in the program's place) must read
far above the program. The card's own check of the control, at the
cells' sizes, is ``test_control_fails_at_the_cells_size`` (marked
``cuda``)."""

import tempfile

import pytest
import torch

from conftest import SEED, load_cell, run_tiny, tiny_ctx
from image_captioning_through_rl_tpu_torch import api
from image_captioning_through_rl_tpu_torch.train import steps

TRAINING = ("a2c-e512", "policy-xe-w2v300")


@pytest.mark.parametrize("cell", TRAINING + ("beam5-e512",))
def test_sound_run_is_correct(cell):
    res = run_tiny(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "_notes" and "checks" in res


@pytest.mark.parametrize("cell", TRAINING)
def test_state_left_unchanged(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    res = run_tiny(cell)
    assert not res["correct"]
    assert res["checks"]["delta_gap"]["value"] == pytest.approx(1.0)



@pytest.mark.parametrize("cell", TRAINING)
def test_half_the_batch_left_out(cell, monkeypatch):
    if cell.startswith("a2c"):
        orig = steps.a2c_rollout_loss

        def half(a2c, cfg, reward, feats, caps, curr, caplen, rng, **kw):
            n = feats.shape[0] // 2
            return orig(a2c, cfg, reward, feats[:n], caps[:n], curr, caplen, rng, **kw)
        monkeypatch.setattr(steps, "a2c_rollout_loss", half)
    else:
        orig = steps.policy_loss

        def half(params, cfg, feats, caps, caplens):
            n = feats.shape[0] // 2
            return orig(params, cfg, feats[:n], caps[:n], caplens[:n])
        monkeypatch.setattr(steps, "policy_loss", half)
    res = run_tiny(cell)
    assert not res["correct"], res["checks"]


def test_token_altered_where_produced(monkeypatch):
    orig = api.fused_beam_search

    def altered(*args, **kw):
        toks, scores = orig(*args, **kw)
        toks = toks.clone()
        toks[0, 0, 1:] = (toks[0, 0, 1:] + 15) % 30
        return toks, scores
    monkeypatch.setattr(api, "fused_beam_search", altered)
    res = run_tiny("beam5-e512")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault, number", [("no_critic", "score_excess_mean"),
                                           ("second_beam", "rows_scored_worse")])
def test_beam_search_fault(fault, number):
    """The critic dropped from the beam's score, or a beam other than the
    best returned: the captions stay the policy's top-``B`` tokens, so only
    the score numbers can see it."""
    import calibrate
    with calibrate.beam_fault(fault):
        res = run_tiny("beam5-e512")
    assert not res["correct"], res["checks"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"], res["checks"]
    assert res["checks"]["topb_gap"]["value"] <= res["checks"]["topb_gap"]["limit"]


@pytest.mark.parametrize("cell", TRAINING)
def test_control_reads_far_above_the_program(cell):
    from portbench.reference import nets
    with tempfile.TemporaryDirectory() as work:
        ctx, entry = tiny_ctx(cell, SEED, work)
        st = entry.first_steps(ctx, with_train=False)
        program = entry.readings(ctx, st)
        import calibrate
        control = entry.readings(ctx, st, calibrate._reference(entry, ctx, st,
                                                               prec=nets.Prec("fp8")))
    assert max(control.values()) > 10 * max(program.values()) + 1e-4, (program, control)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAINING + ("beam5-e512",))
def test_control_fails_at_the_cells_size(cell):
    """On the card, at the cell's own sizes, one seed: the control fails one
    of the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cell's sizes on the card")
    import calibrate
    from portbench import harness
    c = load_cell(cell)
    got = []
    run = calibrate.captioning if c.entry == "caption" else calibrate.training
    run(c, harness.entry_module(c.entry), [], [SEED], "cuda", got.append)
    control = [r for r in got if r["kind"] == "control"]
    assert control
    for r in control:
        assert any(r[k] > lim for k, lim in c.spec["limits"].items()), r
