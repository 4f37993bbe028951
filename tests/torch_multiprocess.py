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


if __name__ == "__main__":
    globals()[f"worker_{sys.argv[1]}"](json.loads(sys.argv[2]))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
