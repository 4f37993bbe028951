"""The compat (quirk Q1) training paths: the port against the JAX package,
on the CPU, at the widths of ``tests/test_torch_compat.py`` (whose helpers
this file shares). Held:

  * the compat reward, value and A2C steps, in both direction modes: the
    loss to rtol 1e-5, every gradient to rtol 1e-4, atol 1e-6, then three
    Adam steps' losses to rtol 1e-5 and the weights to atol 2e-5 (the A2C
    case at T = 5, six-step rollouts in the JAX compile otherwise);
  * ``fused=True`` with ``compat=True`` raising ``ValueError`` in every
    step builder;
  * one epoch of the reward, value and A2C trainers with
    ``compat_batch_as_time`` against the JAX trainers' per-minibatch
    losses (rtol 1e-4), and a forced fused chain or rollout raising
    ``ValueError`` under compat before anything is written.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_compat import BIDI, JMODS, E, H, _batch, _cfgs, _fields, _named, _pair, _t

from image_captioning_through_rl_tpu.data.coco import CocoData as JCocoData
from image_captioning_through_rl_tpu.models import reward as jreward
from image_captioning_through_rl_tpu.models import value as jvalue
from image_captioning_through_rl_tpu.train import checkpoint as jckpt
from image_captioning_through_rl_tpu.train import loops as jloops
from image_captioning_through_rl_tpu.train import optim as joptim
from image_captioning_through_rl_tpu.train import steps as jsteps
from image_captioning_through_rl_tpu_torch.data.coco import CocoData
from image_captioning_through_rl_tpu_torch.models import from_jax_params, reward, value
from image_captioning_through_rl_tpu_torch.ops import prng
from image_captioning_through_rl_tpu_torch.train import loops as tloops
from image_captioning_through_rl_tpu_torch.train import steps as tsteps
from image_captioning_through_rl_tpu_torch.train.optim import adam

torch.set_num_threads(1)


def _port_grads(tree, loss_fn):
    names, leaves = zip(*_named(tree))
    for leaf in leaves:
        leaf.requires_grad_()
    out = loss_fn(tree)
    loss = out[0] if isinstance(out, tuple) else out
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    for leaf in leaves:
        leaf.requires_grad_(False)
    return out, grads


def _check_grads(got, want):
    want = dict(_named(want))
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def _jax_value_compat_loss(jcfg):
    """The loss inside the JAX package's compat value step
    (``steps.py:238-258``)."""
    from image_captioning_through_rl_tpu.decode.greedy import greedy_decode as jgreedy
    from image_captioning_through_rl_tpu.ops.reward_ops import cosine_embedding_reward

    def loss(vp, pp, rp, feats, caps, prefix_len):
        gen = jgreedy(pp, jcfg, feats, caps[:, 0])
        (ve, se), _ = jreward.forward_compat(rp, jcfg, feats, gen,
                                             jreward.compat_zero_state(jcfg))
        rewards = jax.lax.stop_gradient(cosine_embedding_reward(ve, se)[:, None])
        values, _ = jvalue.forward_compat(vp, jcfg, feats, gen[:, :prefix_len],
                                          jvalue.compat_zero_state(jcfg))
        return jnp.mean(jnp.square(values - rewards))

    return loss


LR = 1e-3


@pytest.mark.parametrize("kind", ["reward", "value", "a2c"])
@BIDI
def test_compat_steps_match_jax(kind, bidirectional):
    """One loss and its gradients, then three Adam steps of the step
    builder, each against the JAX package's."""
    t = 5 if kind == "a2c" else 7
    jcfg, tcfg = _cfgs(bidirectional, t)
    jp, tp = _pair(kind, bidirectional, 15)
    (jpp, tpp), (jr, tr) = _pair("policy", bidirectional, 16), _pair("reward", bidirectional, 17)
    feats, caps = _batch(18, t=t)
    f, c = _t(feats), _t(caps, torch.long)
    if kind == "reward":
        jloss, jgrads = jax.value_and_grad(jsteps.reward_loss)(jp, jcfg, feats, caps,
                                                                compat=True)
        loss, grads = _port_grads(tp, lambda p: tsteps.reward_loss(p, tcfg, f, c, compat=True))
    elif kind == "value":
        jloss, jgrads = jax.value_and_grad(_jax_value_compat_loss(jcfg))(jp, jpp, jr, feats,
                                                                         caps, 4)
        loss, grads = _port_grads(tp, lambda p: tsteps.value_compat_loss(p, tcfg, tpp, tr, f, c,
                                                                         4))
    else:
        caplen = int(np.max(np.asarray(jsteps.batch_caption_lens(jnp.asarray(caps)))))
        loss_fn = jax.jit(jax.value_and_grad(jsteps.a2c_rollout_loss_compat, has_aux=True),
                          static_argnums=(1,))
        (jloss, _), jgrads = loss_fn(jp, jcfg, jr, feats, jnp.asarray(caps), jnp.int32(2),
                                     jnp.int32(caplen), jax.random.PRNGKey(5))
        (loss, _), grads = _port_grads(tp, lambda p: tsteps.a2c_rollout_loss_compat(
            p, tcfg, tr, f, c, 2, caplen, prng.PRNGKey(5)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _check_grads(grads, jgrads)

    tx = joptim.adam(LR, jp, False)
    opt_state = tx.init(jp)
    opt = adam(LR, tp)
    if kind == "reward":
        jstep = jsteps.make_reward_step(jcfg, tx, compat=True)
        tstep = tsteps.make_reward_step(tcfg, opt, compat=True)
    elif kind == "value":
        jstep = jsteps.make_value_step(jcfg, tx, compat=True)
        tstep = tsteps.make_value_step(tcfg, opt, tpp, tr, compat=True)
    else:
        jstep = jsteps.make_a2c_step(jcfg, tx, compat=True)
        tstep = tsteps.make_a2c_step(tcfg, opt, compat=True)
    key, tkey = jax.random.PRNGKey(3), prng.PRNGKey(3)
    want, got = [], []
    for i, extra in enumerate((2, 6, 4)):
        feats, caps = _batch(20 + i, t=t)
        f, c = _t(feats), _t(caps, torch.long)
        if kind == "value":
            jp, opt_state, jl = jstep(jp, opt_state, jpp, jr, jnp.asarray(feats),
                                      jnp.asarray(caps), extra)
            got.append(float(tstep(tp, f, c, extra)))
        elif kind == "a2c":
            key, sub = jax.random.split(key)
            tkey, tsub = prng.split(tkey)
            jp, opt_state, stats = jstep(jp, opt_state, jr, jnp.asarray(feats),
                                         jnp.asarray(caps), jnp.int32(1), sub)
            jl = stats.loss
            got.append(float(tstep(tp, tr, f, c, 1, tsub).loss))
        else:
            jp, opt_state, jl = jstep(jp, opt_state, jnp.asarray(feats), jnp.asarray(caps))
            got.append(float(tstep(tp, f, c)))
        want.append(float(jl))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 if kind == "a2c" else 0)
    want_leaves = dict(_named(jp))
    for name, leaf in _named(tp):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(want_leaves[name]), rtol=0,
                                   atol=2e-5, err_msg=name)


def test_compat_forbids_the_fused_steps():
    _, tcfg = _cfgs(False)
    _, tp = _pair("a2c", False, 1)
    opt = adam(LR, tp)
    for make in (lambda: tsteps.make_reward_step(tcfg, opt, compat=True, fused=True),
                 lambda: tsteps.make_value_step(tcfg, opt, tp["policy"], {}, compat=True,
                                                fused=True),
                 lambda: tsteps.make_a2c_step(tcfg, opt, compat=True, fused=True)):
        with pytest.raises(ValueError, match="non-compat"):
            make()


# --------------------------------------------------------------------------
# the trainers
# --------------------------------------------------------------------------

SEED = 3
DIMS = {"wordvec_dim": E, "hidden_dim": H}
TRAIN_KW = dict(epochs=1, batch_size=8, seed=SEED, net_dims=DIMS)


def _log(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _frozen_pts(tmp_path, kinds, bidirectional):
    out = {}
    jcfg, _ = _cfgs(bidirectional)
    for kind in kinds:
        path = str(tmp_path / f"{kind}.pt")
        jckpt.save_network_pt(kind, JMODS[kind].init(jax.random.PRNGKey(
            {"reward": 5, "policy": 6, "value": 7}[kind]), jcfg), path,
            bidirectional=bidirectional)
        out[f"{kind}_network"] = path
    return out


@pytest.mark.parametrize("kind", ["reward", "value", "a2c"])
def test_compat_trainers_match_jax_trainers(kind, tmp_path, monkeypatch):
    """One epoch of each compat trainer (three minibatches) against the JAX
    trainer with ``compat_batch_as_time=True``: the per-minibatch losses."""
    fields = _fields()
    jdata, tdata = JCocoData(**fields), CocoData(**fields)
    for side in "jt":
        (tmp_path / side).mkdir()
    if kind == "a2c":
        nets = _frozen_pts(tmp_path, ("reward", "policy", "value"), False)
        saves = {side: {"model_path": str(tmp_path / side / "model.ckpt"),
                        "results_path": str(tmp_path / side / "results.txt")} for side in "jt"}
        jloops.train_a2c_network(jdata, saves["j"], dict(nets, a2c_network=str(
            tmp_path / "j" / "a2c.ckpt")), str(tmp_path / "j"), False, compat_batch_as_time=True,
            chunk_steps=1, **TRAIN_KW)
        tloops.train_a2c_network(tdata, saves["t"], dict(nets, a2c_network=str(
            tmp_path / "t" / "a2c.ckpt")), str(tmp_path / "t"), False,
            compat_batch_as_time=True, device="cpu", **TRAIN_KW)
        n_logged = 3 * 3
    else:
        jinit = JMODS[kind].init(jax.random.PRNGKey(SEED + {"reward": 0, "value": 2}[kind]),
                                 jloops._cfg_for(jdata, False, DIMS))
        monkeypatch.setattr({"reward": reward, "value": value}[kind], "init",
                            lambda gen, cfg, emb=None: from_jax_params(
                                jax.tree.map(np.asarray, jinit)))
        frozen = _frozen_pts(tmp_path, ("reward", "policy"), False) if kind == "value" else {}
        paths = {side: dict(frozen, **{f"{kind}_network": str(tmp_path / side / f"{kind}.ckpt")})
                 for side in "jt"}
        getattr(jloops, f"train_{kind}_network")(
            jdata, paths["j"], str(tmp_path / "j"), False, compat_batch_as_time=True,
            device_data=False, chunk_steps=1, **TRAIN_KW)
        getattr(tloops, f"train_{kind}_network")(
            tdata, paths["t"], str(tmp_path / "t"), False, compat_batch_as_time=True,
            device="cpu", **TRAIN_KW)
        n_logged = 3
    want, got = _log(tmp_path / "j" / "metrics.jsonl"), _log(tmp_path / "t" / "metrics.jsonl")
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    assert len(got) == n_logged
    np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want], rtol=1e-4)


def test_compat_trainers_refuse_forced_fused_paths(tmp_path):
    data = CocoData(**_fields())
    nets = {f"{k}_network": str(tmp_path / f"{k}.pt") for k in ("reward", "policy", "value",
                                                                 "a2c")}
    for kind in ("reward", "value"):
        with pytest.raises(ValueError, match="compat_batch_as_time"):
            getattr(tloops, f"train_{kind}_network")(data, nets, None, False, device="cpu",
                                                     compat_batch_as_time=True,
                                                     fused_chain=True, **TRAIN_KW)
    saves = {"model_path": str(tmp_path / "m.ckpt"), "results_path": str(tmp_path / "r.txt")}
    with pytest.raises(ValueError, match="fused_rollout"):
        tloops.train_a2c_network(data, saves, nets, None, False, device="cpu",
                                 compat_batch_as_time=True, fused_rollout=True, **TRAIN_KW)
    assert not os.listdir(tmp_path)


