"""Worlds of processes for the port's data-parallel tests.

:func:`run_world` starts ``size`` processes of this file, each with
torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT`` from a port the OS
chose, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), one thread each, and
waits for them under one deadline: when one fails or the deadline passes,
every peer is killed, so a stuck collective fails its test instead of the
suite. As a script, ``python torch_multiprocess.py <worker> <json args>``
joins the gloo world on the CPU and runs the named worker, which imports
only the port (never JAX): the references come from the test process.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(size: int, worker: str, args: dict, log_dir, timeout: float = 180.0,
              cwds=None, argv=None) -> list:
    """Run ``worker`` (or, with ``argv``, that command line) on ``size``
    ranks; returns each rank's output. Fails (with the outputs) when a rank
    exits non-zero or the deadline passes; every process is gone when it
    returns."""
    port = free_port()
    procs, logs = [], []
    for rank in range(size):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(size), RANK=str(rank), LOCAL_RANK=str(rank),
                   OMP_NUM_THREADS="1", PYTHONPATH=ROOT + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        log = open(os.path.join(str(log_dir), f"rank{rank}.log"), "w+")
        cmd = argv or [sys.executable, os.path.abspath(__file__), worker, json.dumps(args)]
        procs.append(subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
                                      cwd=None if cwds is None else str(cwds[rank])))
        logs.append(log)
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"the world of {size} passed its {timeout} s deadline"
                break
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed is None and bad:
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if failed:
        tail = "\n".join(f"--- rank {r} ---\n{o[-3000:]}" for r, o in enumerate(outs))
        raise AssertionError(f"{failed}\n{tail}")
    return outs


# ---------------------------------------------------------------------------
# Workers: run inside the world, import only the port
# ---------------------------------------------------------------------------

def _world():
    import torch

    from image_captioning_through_rl_tpu_torch.parallel import make_mesh, maybe_init_distributed
    from image_captioning_through_rl_tpu_torch.parallel.mesh import world

    torch.set_num_threads(1)
    assert maybe_init_distributed(device="cpu") == (int(os.environ["WORLD_SIZE"]) > 1)
    return make_mesh(device="cpu"), *world()


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def worker_trainers(a):
    """The three pretrainers one epoch each, then A2C plain and curriculum,
    on this rank's rows; each rank's outputs under its own directory (rank
    1's must stay empty: it reads rank 0's networks through broadcasts)."""
    from image_captioning_through_rl_tpu_torch.data.coco import CocoData
    from image_captioning_through_rl_tpu_torch.models import policy, reward, value
    from image_captioning_through_rl_tpu_torch.train import checkpoint as ckpt
    from image_captioning_through_rl_tpu_torch.train import loops

    mesh, rank, _ = _world()
    with open(a["fields"], "rb") as f:
        data = CocoData(**pickle.load(f))
    for kind, mod in (("reward", reward), ("policy", policy), ("value", value)):
        mod.init = (lambda gen, cfg, emb=None, kind=kind:
                    ckpt.load_network(kind, a["inits"][kind], "cpu", cfg))
    out = os.path.join(a["out"], f"rank{rank}")
    os.makedirs(out, exist_ok=True)
    paths = {f"{k}_network": os.path.join(out, f"{k}Network.ckpt")
             for k in ("reward", "policy", "value")}
    kw = dict(epochs=1, batch_size=a["batch_size"], seed=a["seed"], net_dims=a["dims"],
              chunk_steps=a["chunk_steps"], mesh=mesh)
    result = {}
    for kind in ("reward", "policy", "value"):
        trained = getattr(loops, f"train_{kind}_network")(data, paths, os.path.join(out, "pre"),
                                                          False, **kw)
        result[kind] = _numpy(trained)
    for name, curriculum in (("plain", None), ("curriculum", [4])):
        saves = {"model_path": os.path.join(out, f"model_{name}.ckpt"),
                 "results_path": os.path.join(out, f"results_{name}.txt")}
        net = dict(paths, a2c_network=os.path.join(out, f"a2c_{name}.ckpt"))
        params, _, _ = loops.train_a2c_network(data, saves, net, os.path.join(out, name), False,
                                               curriculum=curriculum, **kw)
        result[name] = _numpy(params)
    _dump(os.path.join(a["res"], f"rank{rank}.pkl"), result)


def worker_steps(a):
    """This rank's part of the VSE loss and its reduced gradient, the
    rollout's actions at this rank's rows, the explicit per-rank A2C step,
    and decoding sharded over the processes."""
    import numpy as np
    import torch

    from image_captioning_through_rl_tpu_torch.config import DecodeConfig, NetConfig
    from image_captioning_through_rl_tpu_torch.ops import prng
    from image_captioning_through_rl_tpu_torch.ops.fused_rollout import fused_rollout
    from image_captioning_through_rl_tpu_torch.parallel import (GlobalBatcher,
                                                                make_shard_map_a2c_step,
                                                                sharded_beam_tokens,
                                                                sharded_greedy_tokens,
                                                                sharded_sample_tokens)
    from image_captioning_through_rl_tpu_torch.parallel.collectives import (gather_blocks,
                                                                            reduce_gradients)
    from image_captioning_through_rl_tpu_torch.train import optim, steps

    mesh, rank, size = _world()
    with open(a["inputs"], "rb") as f:
        inp = pickle.load(f)
    cfg = NetConfig(**inp["cfg"])
    tree = lambda t: {k: tree(v) if isinstance(v, dict) else torch.tensor(v)  # noqa: E731
                      for k, v in t.items()}
    feats, caps = torch.from_numpy(inp["feats"]), torch.from_numpy(inp["caps"]).long()
    n = feats.shape[0]
    batcher = GlobalBatcher(mesh)
    shard = batcher.row_shard(n)
    lo, hi = shard.lo, shard.hi
    out = {}

    # the reward step's VSE loss and gradient
    rparams = tree(inp["reward"])
    leaves = [p.requires_grad_(True) for p in steps._tree_leaves(rparams)]
    opt = torch.optim.SGD(leaves, lr=0.0)
    loss = steps.reward_loss(rparams, cfg, feats[lo:hi], caps[lo:hi], shard=shard)
    loss.backward()
    loss, = reduce_gradients(opt, [loss.detach()], shard, mean=False)
    out["vse_loss"] = float(loss)
    out["vse_grads"] = [p.grad.numpy().copy() for p in leaves]

    # the rollout's actions: this rank's rows of the global draw
    a2c = tree(inp["a2c"])
    key = np.asarray(inp["key"], np.uint32)
    with torch.no_grad():
        _, _, acts, _ = fused_rollout(a2c, cfg, feats[lo:hi], caps[lo:hi], 1, key,
                                      weight_dtype=torch.float32, row0=lo)
    out["actions"] = gather_blocks(acts, lo, n).numpy()

    # the explicit per-rank step: a sampling step and a sampling-free window
    for name, curr in (("sampled", 1), ("window", inp["caplen"])):
        params = tree(inp["a2c"])
        step = make_shard_map_a2c_step(cfg, optim.adam(1e-3, params), mesh)
        stats = step(params, tree(inp["reward"]), feats, caps, curr, key)
        out[f"shard_map_{name}"] = (_numpy(params), float(stats.loss))

    # decoding sharded over the processes, every rank given the whole batch
    dfeats, dstart = inp["dfeats"], np.ones(len(inp["dfeats"]), np.int32)
    pp, vp = tree(inp["a2c"]["policy"]), tree(inp["a2c"]["value"])
    out["greedy"] = sharded_greedy_tokens(mesh, pp, cfg, dfeats, dstart).numpy()
    toks, scores = sharded_beam_tokens(mesh, pp, vp, cfg, DecodeConfig(
        beam_size=3, max_seq_len=cfg.max_seq_len), dfeats, dstart)
    out["beam"] = (toks.numpy(), scores.numpy())
    out["sample"] = sharded_sample_tokens(mesh, pp, cfg, dfeats, dstart, prng.PRNGKey(5), 4,
                                          temperature=1.1, top_k=40, top_p=0.9).numpy()
    _dump(os.path.join(a["res"], f"rank{rank}.pkl"), out)


def worker_sync_load(a):
    """Rank 0's files decide every load: each case's outcome on this rank."""
    import torch

    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.train import loops, steps

    mesh, rank, _ = _world()
    cfg = NetConfig(**a["cfg"])
    dev = torch.device("cpu")
    out = {}
    for case, path in a["cases"].items():
        path = path.format(rank=rank)
        try:
            params = loops._load_or_fail_sync("policy", path, dev, cfg, mesh)
            out[case] = ("loaded", [float(p.sum()) for p in steps._tree_leaves(params)])
        except Exception as e:  # noqa: BLE001 — the outcome is the result
            out[case] = ("raised", type(e).__name__)
        out[case + "_exists"] = loops._exists_sync(path, mesh.spans_processes)
    _dump(os.path.join(a["res"], f"rank{rank}.pkl"), out)


def worker_tensor_parallel(a):
    """Tensor parallelism over the vocabulary on a ``(D, M)`` mesh: three
    Adam steps of each step (the pretrainers plain and fused through their
    plain twins, and as one chunk of three; A2C plain and curriculum) on
    ``shard_params`` trees (a captured chunk refused over gloo), the
    A2C actions of each first step gathered, the fused rollout's refusal,
    the VSE loss and gradient of replicated parameters reduced over the data
    group, ``gather_params``, sharded checkpoint writes, a greedy decode of a
    sharded policy, and with ``a["trainer"]`` one policy trainer epoch on
    the mesh with replicated parameters."""
    import numpy as np
    import torch

    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import prepare_greedy_weights
    from image_captioning_through_rl_tpu_torch.parallel import (
        GlobalBatcher, a2c_param_spec, gather_params, make_mesh, maybe_init_distributed,
        policy_param_spec, reward_param_spec, shard_params, sharded_greedy_tokens,
        value_param_spec)
    from image_captioning_through_rl_tpu_torch.parallel import tensor_parallel as tp
    from image_captioning_through_rl_tpu_torch.parallel.collectives import (gather_blocks,
                                                                            reduce_gradients)
    from image_captioning_through_rl_tpu_torch.parallel.mesh import world
    from image_captioning_through_rl_tpu_torch.train import checkpoint as ckpt
    from image_captioning_through_rl_tpu_torch.train import optim, steps

    torch.set_num_threads(1)
    maybe_init_distributed(device="cpu")
    mesh = make_mesh(tuple(a["shape"]), ("data", "model"), device="cpu")
    rank = world()[0]
    with open(a["inputs"], "rb") as f:
        inp = pickle.load(f)
    cfg = NetConfig(**inp["cfg"])
    tree = lambda t: {k: tree(v) if isinstance(v, dict) else torch.tensor(v)  # noqa: E731
                      for k, v in t.items()}
    specs = {"a2c": a2c_param_spec, "policy": policy_param_spec, "value": value_param_spec,
             "reward": reward_param_spec}

    def placed(kind):
        t = tree(inp[kind])
        return shard_params(mesh, t, specs[kind](t))

    batches = [(torch.from_numpy(f), torch.from_numpy(c).long()) for f, c in inp["batches"]]
    n = batches[0][0].shape[0]
    shard = GlobalBatcher(mesh).row_shard(n)
    lo, hi = shard.lo, shard.hi
    out = {"coords": mesh.coords, "rows": (lo, hi), "vocab": tuple(placed("policy").vocab[:4])}

    f32 = torch.float32  # the fused steps through their plain twins, float32 weights
    greedy = prepare_greedy_weights(gather_params(placed("policy")), f32)
    fused_loss = {
        "reward": lambda p, f, c, _: steps.reward_loss_fused(p, cfg, f, c, weight_dtype=f32,
                                                             shard=shard),
        "policy": lambda p, f, c, _: steps.policy_loss_fused(
            p, cfg, f, c, steps.batch_caption_lens(c), weight_dtype=f32),
        "value": lambda p, f, c, pl: steps.value_episode_loss(
            p, cfg, None, gather_params(placed("reward")), f, c, pl, fused=True,
            greedy_weights=greedy, weight_dtype=f32)}
    for kind in ("reward", "policy", "value"):
        for fused in (False, True):
            params = placed(kind)
            opt = optim.adam(inp["lr"], params)
            if fused:
                losses = [float(steps._train_step(
                    opt, lambda: fused_loss[kind](params, f[lo:hi], c[lo:hi], pl), shard=shard,
                    mean=kind != "reward"))
                    for (f, c), pl in zip(batches, inp["prefixes"])]
            elif kind == "value":
                step = steps.make_value_step(cfg, opt, placed("policy"), placed("reward"))
                losses = [float(step(params, f[lo:hi], c[lo:hi], pl, shard))
                          for (f, c), pl in zip(batches, inp["prefixes"])]
            else:
                make = steps.make_reward_step if kind == "reward" else steps.make_policy_step
                step = make(cfg, opt)
                losses = [float(step(params, f[lo:hi], c[lo:hi], shard)) for f, c in batches]
            out[f"{kind}_{'fused' if fused else 'plain'}"] = (losses,
                                                              _numpy(gather_params(params)))

    # the fused losses' reduced gradients, gathered: the table's gather over
    # model keeps each block's rows (a sum there would double them, which the
    # Adam steps above cannot see: Adam's update is blind to a gradient's scale)
    from image_captioning_through_rl_tpu_torch.parallel import sharding

    f, c = batches[0]
    for kind in ("reward", "policy"):
        params = placed(kind)
        leaves = [p.requires_grad_(True) for p in steps._tree_leaves(params)]
        opt = torch.optim.SGD(leaves, lr=0.0)
        if kind == "reward":
            loss = steps.reward_loss_fused(params, cfg, f[lo:hi], c[lo:hi],
                                           weight_dtype=torch.float32, shard=shard)
        else:
            loss = steps.policy_loss_fused(params, cfg, f[lo:hi], c[lo:hi],
                                           steps.batch_caption_lens(c[lo:hi]),
                                           weight_dtype=torch.float32)
        loss.backward()
        loss, = reduce_gradients(opt, [loss.detach()], shard, mean=kind == "policy")
        grads = {id(p): p.grad for p in leaves}
        out[f"{kind}_grads"] = (float(loss), _numpy(sharding._gather_sharded(
            _map(params, lambda p: grads[id(p)]), params.specs, params.vocab)))

    # the chunked forms: k = 3 updates a call, the same parameters as the steps
    feats_k = torch.stack([f[lo:hi] for f, _ in batches])
    caps_k = torch.stack([c[lo:hi] for _, c in batches])
    for kind in ("reward", "policy", "value"):
        params = placed(kind)
        opt = optim.adam(inp["lr"], params)
        if kind == "value":
            chunk = steps.make_value_chunk_step(cfg, opt, params, placed("policy"),
                                                placed("reward"))
            chunk(float("inf"), feats_k, caps_k, [(pl,) for pl in inp["prefixes"]], shard)
        else:
            make = (steps.make_reward_chunk_step if kind == "reward"
                    else steps.make_policy_chunk_step)
            make(cfg, opt, params)(float("inf"), feats_k, caps_k, shard=shard)
        out[f"{kind}_chunk"] = _numpy(gather_params(params))
    try:
        steps.make_policy_chunk_step(cfg, optim.adam(inp["lr"], placed("policy")),
                                     placed("policy"), graph=True)
        out["graph_chunk"] = "built"
    except ValueError as e:
        out["graph_chunk"] = str(e)

    picks, sample = [], tp.sample

    def recorded(*args, **kw):
        action = sample(*args, **kw)
        picks.append(action)
        return action

    tp.sample = recorded
    for name, per_step_mean, curr in (("plain", False, 1),
                                      ("curriculum", True, inp["curriculum"])):
        params, rparams = placed("a2c"), placed("reward")
        step = steps.make_a2c_step(cfg, optim.adam(inp["lr"], params),
                                   per_step_mean=per_step_mean)
        losses, actions = [], None
        for (f, c), key in zip(batches, inp["keys"]):
            picks.clear()
            caplen = int(torch.max(steps.batch_caption_lens(c)))
            stats = step(params, rparams, f[lo:hi], c[lo:hi], curr, np.asarray(key, np.uint32),
                         caplen=caplen, shard=shard)
            losses.append(float(stats.loss))
            if actions is None:
                actions = gather_blocks(torch.stack(picks, dim=1), lo, n, shard.group).numpy()
        out[f"a2c_{name}"] = (losses, _numpy(gather_params(params)), actions)
    tp.sample = sample
    try:
        fused = steps.make_a2c_step(cfg, optim.adam(inp["lr"], placed("a2c")), fused=True)
        fused(placed("a2c"), placed("reward"), *batches[0], 1, np.asarray(inp["keys"][0],
                                                                          np.uint32))
        out["fused_rollout"] = "ran"
    except ValueError as e:
        out["fused_rollout"] = str(e)

    # the VSE loss and gradient of replicated parameters: reduced over the data group
    rparams = tree(inp["reward"])
    leaves = [p.requires_grad_(True) for p in steps._tree_leaves(rparams)]
    opt = torch.optim.SGD(leaves, lr=0.0)
    f, c = batches[0]
    loss = steps.reward_loss(rparams, cfg, f[lo:hi], c[lo:hi], shard=shard)
    loss.backward()
    loss, = reduce_gradients(opt, [loss.detach()], shard, mean=False)
    out["vse"] = (float(loss), [p.grad.numpy().copy() for p in leaves])

    out["round_trip"] = _numpy(gather_params(placed("a2c")))
    for suffix in ("ckpt", "pt"):
        ckpt.save_network("a2c", placed("a2c"), os.path.join(a["res"], f"sharded.{suffix}"))
    dstart = np.ones(len(inp["dfeats"]), np.int32)
    out["greedy"] = sharded_greedy_tokens(mesh, placed("policy"), cfg, inp["dfeats"],
                                          dstart).numpy()

    if a.get("trainer"):
        from image_captioning_through_rl_tpu_torch.data.coco import CocoData
        from image_captioning_through_rl_tpu_torch.models import policy
        from image_captioning_through_rl_tpu_torch.train import loops

        t = a["trainer"]
        with open(t["fields"], "rb") as f:
            data = CocoData(**pickle.load(f))
        policy.init = lambda gen, cfg, emb=None: ckpt.load_network("policy", t["init"], "cpu",
                                                                  cfg)
        d = os.path.join(t["out"], f"rank{rank}")
        os.makedirs(d, exist_ok=True)
        paths = {f"{k}_network": os.path.join(d, f"{k}Network.ckpt")
                 for k in ("reward", "policy", "value")}
        trained = loops.train_policy_network(
            data, paths, os.path.join(d, "pre"), False, epochs=1, batch_size=t["batch_size"],
            seed=t["seed"], net_dims=t["dims"], chunk_steps=1, mesh=mesh)
        out["trainer"] = _numpy(trained)
    _dump(os.path.join(a["res"], f"rank{rank}.pkl"), out)


if __name__ == "__main__":
    globals()[f"worker_{sys.argv[1]}"](json.loads(sys.argv[2]))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
