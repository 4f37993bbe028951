"""Operations and bytes of each kernel call and of each step, as functions
of the shapes they run at (bf16 weights, float32 activations): the
yardstick for the roofline shares and the whole step's share of the peak.

Counted from the shapes and the algorithms: each input read once and each
output written once; the products each call must do (the x-gate tables
counted once, the cells' input products as table rows); the scalar work
of the threefry hash and the Gumbel map at the float32 rate outside the
tensor cores. Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s
bf16, 67 TFLOP/s float32, 3.35 TB/s. They assume the card's full 700 W;
every share is printed beside the card's power limit.
"""

from __future__ import annotations

PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
BW, FW = 2, 4  # bytes of a bf16 weight, of a float32 value


class Work:
    """``nbytes`` to move and ``flops`` of products at ``peak``, plus
    ``scalar`` operations at the float32 rate."""

    def __init__(self, nbytes: float, flops: float, peak: float = PEAK_BF16, scalar: float = 0.0):
        self.nbytes, self.flops, self.peak, self.scalar = nbytes, flops, peak, scalar

    def bound_s(self) -> float:
        """The least time the card could take."""
        return max(self.nbytes / PEAK_BYTES, self.flops / self.peak + self.scalar / PEAK_F32)

    def bound_ms(self) -> tuple[float, str]:
        t_bytes = self.nbytes / PEAK_BYTES
        t_ops = self.flops / self.peak + self.scalar / PEAK_F32
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _lstm_w(v, e, h):
    return (v * e + (e + h) * 4 * h) * BW + 4 * h * FW


def decode(n, v, e, h, f, t, scalar=0.0) -> Work:
    """The greedy decode of ``n`` rows over ``t`` columns."""
    g4 = 4 * h
    return Work(n * f * FW + f * h * BW + _lstm_w(v, e, h) + h * v * BW + v * FW + n * t * 4,
                2 * n * f * h + 2 * v * e * g4 + (t - 1) * (2 * n * h * g4 + 2 * n * h * v),
                scalar=scalar)


def beam(n, v, e, h, f, t, b) -> Work:
    """Beam-``b`` search of ``n`` rows: policy cells and heads of ``n b``
    beams, the critic's ``h @ wh`` once a parent and its MLP for every one
    of the ``b^2`` candidates."""
    g4, steps, nb = 4 * h, t - 1, n * b
    lstm_w, head_w = _lstm_w(v, e, h), h * v * BW + v * FW
    return Work(n * f * FW + f * h * BW + 2 * lstm_w + head_w + ((f + h) * h + h) * BW
                + nb * (t + 1) * 4,
                2 * n * f * h * 2 + 2 * 2 * v * e * g4
                + steps * (2 * nb * h * g4 * 2 + 2 * nb * h * v + 2 * nb * b * h * h))


def token_gates(v, e, h) -> Work:
    g4 = 4 * h
    return Work((v * e + e * g4) * BW + v * g4 * FW, 2 * v * e * g4)


def _chain(kind, h):
    return (4 * h, 2 * h + 4 * h) if kind == "lstm" else (3 * h, 2 * h + 3 * h)


def chain_fwd(kind, n, steps, v, e, h) -> Work:
    """An LSTM (``kind="lstm"``) or GRU chain's forward over ``steps``
    columns of ``n`` rows, its tape written."""
    g, tape = _chain(kind, h)
    wts = (v * e + (e + h) * g) * BW + 2 * g * FW
    return Work(wts + n * steps * 4 + 2 * n * h * FW + steps * n * tape * FW,
                2 * v * e * g + steps * 2 * n * h * g)


def chain_bwd(kind, n, steps, v, e, h) -> Work:
    """The chain's backward from its tape."""
    g, tape = _chain(kind, h)
    wts = (v * e + (e + h) * g) * BW + 2 * g * FW
    return Work(wts + n * steps * 4 + steps * n * (tape + h) * FW + (v * e + (e + h) * g + g) * FW
                + 2 * n * h * FW,
                steps * 2 * n * (g * h + (e + h) * g + g * e))


def threefry_gumbel(s, n, v) -> Work:
    """The hash and the Gumbel map of ``s n v`` noise entries: 118 integer
    operations (20 rounds, five key injections) and 8 more."""
    el = s * n * v
    return Work(el * FW, el * 126, PEAK_F32)


def _reward_w(v, h):
    g3 = 3 * h
    return (h * g3 + h * h) * BW + (v * g3 + g3 + h) * FW


def _reward_step(n, h):
    return 2 * n * h * 3 * h + 2 * n * h * h + 4 * n * h


def reward_stream(n, s, v, h) -> Work:
    return Work(_reward_w(v, h) + 2 * n * h * FW + 3 * s * n * 4, s * _reward_step(n, h))


def _rollout_tape(n, s, h, gates, tb):
    return 4 * s * n * h * tb + s * n * h * FW + (2 * (s - 1) * n * 4 * h * tb if gates else 0)


def _policy_value_w(v, e, h, f):
    return 2 * _lstm_w(v, e, h) + h * v * BW + v * FW + ((f + h) * h + h) * BW


def rollout_fwd(n, s, v, e, h, f, gates=True, tb=FW) -> Work:
    """The A2C rollout's forward of ``n`` rows over ``s`` sampled steps
    with the reward stream fused in: its noise, features, tokens, weights,
    five ``[s, n]`` outputs and tape; the policy and critic cells, the
    head and the reward GRU a step."""
    g4 = 4 * h
    return Work(s * n * v * FW + n * f * FW + s * n * 4 + _policy_value_w(v, e, h, f)
                + _reward_w(v, h) + 5 * s * n * 4 + _rollout_tape(n, s, h, gates, tb),
                2 * 2 * v * e * g4 + 2 * n * f * h
                + s * (2 * n * h * v + 2 * n * h * h + 2 * n * h + _reward_step(n, h))
                + (s - 1) * 2 * 2 * n * h * g4)


def rollout_bwd(n, s, v, e, h, f, gates=True, tb=FW) -> Work:
    """The rollout's backward from its tape: the head's three products a
    step, the critic MLP's, both recurrences' and their weight gradients."""
    g4 = 4 * h
    grads = (2 * (v * e + (e + h) * g4 + g4) + h * v + v + (f + h) * h + 2 * h + 1) * FW
    return Work(_rollout_tape(n, s, h, gates, tb) + 4 * s * n * 4 + n * f * FW
                + _policy_value_w(v, e, h, f) + grads + (n * f + 4 * n * h) * FW,
                3 * 2 * s * n * h * v + 2 * 2 * s * n * (f + h) * h
                + 2 * (s - 1) * 2 * n * (g4 * h + (e + h) * g4 + g4 * e)
                + (0 if gates else 2 * (s - 1) * 2 * n * (e + h) * g4))


def a2c_minibatch_flops(n, s, v, e, h, f) -> float:
    """The products of one A2C minibatch: the rollout's forward and
    backward."""
    return rollout_fwd(n, s, v, e, h, f).flops + rollout_bwd(n, s, v, e, h, f).flops


def xe_minibatch_flops(n, steps, v, e, h, f) -> float:
    """The products of one policy XE minibatch: the chain's forward and
    backward, the head's three products a step and ``cnn2linear``'s."""
    return (chain_fwd("lstm", n, steps, v, e, h).flops + chain_bwd("lstm", n, steps, v, e, h).flops
            + 3 * 2 * n * steps * h * v + 3 * 2 * n * f * h)
