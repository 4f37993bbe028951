"""PyTorch port vs the JAX package: config, networks and weight interchange.

Weights come from the JAX initialisers and cross as numpy
(``from_jax_params``); inputs come from a seeded numpy generator. The JAX
side runs at ``precision="highest"`` (float32), so the two agree to
float32 rounding: atol = rtol = 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import config as jconfig
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu.models import policy as jpolicy
from image_captioning_through_rl_tpu.models import value as jvalue
from image_captioning_through_rl_tpu.models.convert import a2c_from_torch, a2c_to_torch
from image_captioning_through_rl_tpu_torch import config as tconfig
from image_captioning_through_rl_tpu_torch.models import (
    a2c,
    a2c_from_state_dict,
    a2c_to_state_dict,
    from_jax_params,
    load_state_dict,
    policy,
    value,
)

torch.set_num_threads(1)

KW = dict(vocab_size=60, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=7)
JCFG = jconfig.NetConfig(precision="highest", **KW)
TCFG = tconfig.NetConfig(**KW)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def params():
    jp = ja2c.init(jax.random.PRNGKey(0), JCFG)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _inputs(n=6, t=5, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, KW["input_dim"])).astype(np.float32)
    caps = rng.integers(0, KW["vocab_size"], size=(n, t)).astype(np.int32)
    return feats, caps


@pytest.mark.parametrize("cls", ["NetConfig", "TrainConfig", "DecodeConfig"])
def test_config_fields_match_reference(cls):
    def fields(mod):
        return [(f.name, f.default) for f in dataclasses.fields(getattr(mod, cls))]

    assert fields(tconfig) == fields(jconfig)


def test_policy_forward_and_step_match_jax(params):
    jp, tp = params
    feats, caps = _inputs()
    want = jpolicy.forward(jp["policy"], JCFG, jnp.asarray(feats), jnp.asarray(caps))
    got = policy.forward(tp["policy"], TCFG, torch.from_numpy(feats), torch.from_numpy(caps).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    jstate = jpolicy.init_decode_state(jp["policy"], JCFG, jnp.asarray(feats))
    tstate = policy.init_decode_state(tp["policy"], TCFG, torch.from_numpy(feats))
    for t in range(caps.shape[1]):
        jlog, jstate = jpolicy.step(jp["policy"], JCFG, jnp.asarray(caps[:, t]), jstate)
        tlog, tstate = policy.step(tp["policy"], TCFG, torch.from_numpy(caps[:, t]).long(), tstate)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        for a, b in zip(tstate, jstate):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_value_forward_and_state_match_jax(params):
    jp, tp = params
    feats, caps = _inputs()
    want = jvalue.forward(jp["value"], JCFG, jnp.asarray(feats), jnp.asarray(caps))
    got = value.forward(tp["value"], TCFG, torch.from_numpy(feats), torch.from_numpy(caps).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    jstate = jvalue.zero_rnn_state(JCFG, caps.shape[0])
    tstate = value.zero_rnn_state(TCFG, caps.shape[0])
    for t in range(caps.shape[1]):
        jstate = jvalue.rnn_step(jp["value"], JCFG, jnp.asarray(caps[:, t]), jstate)
        tstate = value.rnn_step(tp["value"], TCFG, torch.from_numpy(caps[:, t]).long(), tstate)
        jv = jvalue.value_from_state(jp["value"], JCFG, jnp.asarray(feats), jstate)
        tv = value.value_from_state(tp["value"], TCFG, torch.from_numpy(feats), tstate)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    # the carried state ends where the full encode does
    np.testing.assert_allclose(tv.numpy(), got.numpy(), **TOL)


def test_a2c_forward_matches_jax(params):
    jp, tp = params
    feats, caps = _inputs(seed=1)
    jv, jl = ja2c.forward(jp, JCFG, jnp.asarray(feats), jnp.asarray(caps))
    tv, tl = a2c.forward(tp, TCFG, torch.from_numpy(feats), torch.from_numpy(caps).long())
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_pt_round_trip_is_bit_exact(params, tmp_path):
    """JAX a2c_to_torch -> .pt -> port load -> port export -> JAX
    a2c_from_torch gives back the JAX arrays bit for bit."""
    jp, _ = params
    path = tmp_path / "a2cNetwork.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in a2c_to_torch(jp).items()}, path)
    loaded = a2c_from_state_dict(load_state_dict(str(path)))
    back = a2c_from_torch({k: v.numpy() for k, v in a2c_to_state_dict(loaded).items()})
    flat_j, tree_j = jax.tree.flatten(jp)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    # and the port's own tree survives the state-dict layout unchanged
    again = a2c_from_state_dict(a2c_to_state_dict(loaded))
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(loaded)):
        assert torch.equal(a, b)


def test_torch_init_shapes_match_jax():
    tp = a2c.init(torch.Generator().manual_seed(0), TCFG)
    jp = ja2c.init(jax.random.PRNGKey(0), JCFG)
    assert jax.tree.map(np.shape, jp) == jax.tree.map(lambda t: tuple(t.shape), tp)


def test_bidirectional_raises():
    cfg = tconfig.NetConfig(bidirectional=True, **KW)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        policy.init(torch.Generator().manual_seed(0), cfg)
    sd = {"lstm.weight_ih_l0_reverse": torch.zeros(1)}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        from image_captioning_through_rl_tpu_torch.models import policy_from_state_dict

        policy_from_state_dict(sd)
