"""The frozen operation and byte counts against the bounds the smoke run
printed for its own shapes (V 1004, F = E = H 512, T 17, beam 5; N 127 for
the beam, 512 rows for the chains and the rollout, 1024 for greedy)."""

import pytest

from portbench import counts

V, F, E, H, T, B = 1004, 512, 512, 512, 17, 5
S, N = T - 1, 512

# ms and what bounds it, as chip_smoke.bounds() gives them at these shapes.
# rollout_fwd: 0.0790 ms counts the noise of [16, 512, 1004] once; the smoke
# run's bounds() since it gained the noise window reads 0.0741, because that
# entry reuses the name of the noise's element count and halves it.
CASES = [
    (lambda: counts.decode(1024, V, E, H, F, T), 0.05444537386450961, "operations"),
    (lambda: counts.beam(127, V, E, H, F, T, B), 0.08497236073609707, "operations"),
    (lambda: counts.token_gates(V, E, H), 0.00338806447761194, "bytes"),
    (lambda: counts.chain_fwd("lstm", N, 16, V, E, H), 0.03224835820895522, "bytes"),
    (lambda: counts.chain_bwd("lstm", N, 16, V, E, H), 0.0694837985197169, "operations"),
    (lambda: counts.chain_fwd("gru", N, 17, V, E, H), 0.028491653731343283, "bytes"),
    (lambda: counts.chain_bwd("gru", N, 17, V, E, H), 0.0553699019453994, "operations"),
    (lambda: counts.threefry_gumbel(S, N, V), 0.015467474149253731, "operations"),
    (lambda: counts.reward_stream(N, S, V, H), 0.0173879134479272, "operations"),
    (lambda: counts.rollout_fwd(N, S, V, E, H, F), 0.07900784238805969, "bytes"),
    (lambda: counts.rollout_bwd(N, S, V, E, H, F), 0.17320058175935288, "operations"),
    (lambda: counts.rollout_fwd(N, S, V, E, H, F, gates=False), 0.06735483936097068,
     "operations"),
    (lambda: counts.rollout_bwd(N, S, V, E, H, F, gates=False), 0.23834164287158746,
     "operations"),
    (lambda: counts.rollout_fwd(N, S, V, E, H, F, tb=2), 0.06735483936097068, "operations"),
]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_bound_matches_the_smoke_runs(i):
    work, ms, by = CASES[i]
    got_ms, got_by = work().bound_ms()
    assert got_by == by
    assert got_ms == pytest.approx(ms, rel=1e-12)


def test_step_flops():
    """A2C minibatch ~238 GFLOP at S = 16; policy XE ~99 GFLOP at E 304."""
    assert counts.a2c_minibatch_flops(N, S, V, E, H, F) == pytest.approx(237.909311488e9)
    assert counts.xe_minibatch_flops(N, S, V, 304, H, F) == pytest.approx(99.262660608e9)
