"""Processes as mesh ranks: the launcher of the W-HFL training step with
one process per mobile user, and of the sharded W-HFL sweep with one
process per shard.

`launch(worker, world, backend, *args)` spawns `world` processes with
`torch.multiprocessing`, joins them into one process group through a
`FileStore` in a fresh temporary directory (no port is needed), runs
``worker(rank, world, *args)`` in each and returns the ranks' results
in rank order.  A rank that raises fails the launch: the others are
stopped and the parent raises.  The backend is the caller's: "nccl"
across cards, one rank a card (and at world size 1); "gloo" for ranks
on the CPU, or for ranks sharing one card (NCCL refuses two ranks on
one GPU; gloo stages CUDA tensors through host memory).  A rank's card
is ``cuda:{rank % device_count}``.

`train_worker` is the worker of a training run (`examples/
lm_federated_torch.py --ranks`, `chip_smoke.py`'s ranks phase, the
tests): it builds the mesh (pod, data, model) on the world, refines it
(`launch.mesh.refine_mesh`), builds the structural or fused step on it,
cuts its own user's rows from each global batch and runs the steps.
It reports its metrics, seconds a step, seconds inside collectives
(`sharding.record_collectives`), the collectives' groups, the flash
kernels' launches (and those with a query offset, "q_seq"'s rows past
the first block) and its peak device memory; with a `reference`
(in memory, or a `save_reference` file), whether its final state and
metrics equal it bit for bit.

`sweep_worker` is the worker of a sweep on ranks
(`repro_torch.exec.ShardedSweepRunner(ranks=...)`, which launches it):
it builds the ``("cluster", "user")`` mesh on the world and runs the
scenarios on it (`exec.RankSweepRunner`), and reports the rank's
results, launches, collectives and peak memory.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from collections import Counter
from datetime import timedelta

import torch

from repro_torch.device import CPU_THREADS
from repro_torch.sharding.api import forget_groups

# Seconds a collective may wait for the other ranks before the process
# group gives up.
TIMEOUT_S = 900


def launch(worker, world: int, backend: str, *args):
    """Run ``worker(rank, world, *args)`` in `world` processes joined as
    one process group of `backend`; returns their results in rank
    order.  A world of one runs in the calling process (the process
    group made and destroyed around the worker), its result returned
    as it is."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro-ranks-")
    try:
        if world == 1:
            return [_run(0, 1, backend, tmp, worker, args)]
        mp.spawn(_entry, args=(world, backend, tmp, worker, args),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(rank, world, backend, tmp, worker, args):
    import torch.distributed as dist

    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        return worker(rank, world, *args)
    finally:
        dist.destroy_process_group()
        forget_groups()


def _entry(rank, world, backend, tmp, worker, args):
    out = _run(rank, world, backend, tmp, worker, args)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield "/".join(map(str, prefix)), tree


def reference(state, metrics) -> dict:
    """A run's final state and its metrics (a list of per-step {"loss",
    "edge_power"}) by name, for `train_worker`'s bitwise check."""
    ref = {f"state/{k}": t.detach() for k, t in _flat(state)}
    for i, m in enumerate(metrics):
        for k, v in m.items():
            ref[f"metrics/{i}/{k}"] = v.detach()
    return ref


def save_reference(path: str, state, metrics) -> None:
    """`reference` written to `path` (host memory, for other
    processes)."""
    torch.save({k: t.cpu() for k, t in reference(state, metrics).items()},
               path)


def _spec_names(specs, prefix=()):
    """(name, spec) of a spec tree's leaves, named as `_flat` names a
    tree's (a spec is a tuple: a leaf here)."""
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from _spec_names(specs[k], prefix + (k,))
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from _spec_names(v, prefix + (i,))
    else:
        yield "/".join(map(str, prefix)), specs


def compare_to_reference(ref, state, metrics, cut=None) -> dict:
    """{"leaves", "unequal": [names whose bits differ], "max_abs_diff",
    "gaps": {unequal float name: [max |got - ref|, max |ref|]}} of a
    run's final state and metrics against a `reference` dict or a
    `save_reference` file; ``cut(name, tensor)`` gives a reference
    leaf's block that this rank holds (a sharded state)."""
    if isinstance(ref, str):
        ref = torch.load(ref, mmap=True, weights_only=True)
    got = reference(state, metrics)
    unequal, worst, gaps = [], 0.0, {}
    for name in sorted(set(ref) | set(got)):
        if name not in ref or name not in got:
            unequal.append(name)
            continue
        b = ref[name] if cut is None else cut(name, ref[name])
        a, b = got[name].detach(), b.to(got[name].device)
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(
                _bits(a), _bits(b)):
            unequal.append(name)
            if a.shape == b.shape and a.is_floating_point():
                gap = float((a.float() - b.float()).abs().max())
                worst = max(worst, gap)
                gaps[name] = [gap, float(b.float().abs().max())]
    return {"leaves": len(ref), "unequal": unequal, "max_abs_diff": worst,
            "gaps": gaps}


def train_worker(rank: int, world: int, spec: dict) -> dict:
    """One rank of a W-HFL training run.  `spec`:

    - "cfg" (ArchConfig), "shape" (InputShape: the global batch),
      "tcfg" (TrainConfig), "fused" (bool), "mesh" ((pod, cluster,
      user, model) sizes, their product the world);
    - "batches": global batches (dicts of CPU tensors), one a step, or
      one for every step; "keys": the steps' `prng.PRNGKey` seeds;
    - "device": None (the rank's card) or "cpu"; "params0" (optional:
      start from these parameters, else `init_fn` at seed 0);
    - "reference": a `reference` dict (a world of one, in this
      process) or a `save_reference` file to hold the final state and
      the metrics to, bit for bit (each of the rank's shards against the
      same block of the reference's leaf; `vs_reference`'s gaps give
      the distance where they differ); "return_state": send the final
      state back, its shards gathered (small runs); "log_every": rank 0
      prints a step's metrics.

    The rank's state is its shards (`train.state_specs`): "params0" is
    cut to them.

    A list of specs runs each in turn in the same processes.
    """
    if isinstance(spec, list):
        return [train_worker(rank, world, s) for s in spec]
    from repro_torch import prng
    from repro_torch.kernels import LAUNCH_COUNTERS, flash_mha
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import (axes_bound, gather_tree,
                                      record_collectives, shard_tree)
    from repro_torch.sharding.api import local_shard
    from repro_torch.tree import tree_map

    if spec.get("device") == "cpu":
        torch.set_num_threads(CPU_THREADS)
    mesh = make_mesh(spec["mesh"], device_type="cpu"
                     if spec.get("device") == "cpu" else "cuda")
    build = (train.build_fused_train_step if spec.get("fused")
             else train.build_train_step)
    step, init_fn, _, rmesh = build(spec["cfg"], spec["shape"], mesh,
                                    spec["tcfg"], device=spec.get("device"))
    state, _ = init_fn(prng.PRNGKey(0))
    dev = state["step"].device
    specs = train.state_specs(spec["cfg"], spec["shape"], rmesh,
                              spec["tcfg"], fused=spec.get("fused", False))
    if spec.get("params0") is not None:
        with axes_bound(rmesh):
            state["params"] = tree_map(
                lambda t: t.to(dev).clone(),
                shard_tree(spec["params0"], specs["params"]))
    batches = spec["batches"]
    data = ("pod", "cluster", "user")
    # the mesh the step was built on: refined, or the production one
    # (the fused step)
    rows = train.batch_shardings(spec["cfg"], spec["shape"], rmesh)

    def local(batch):
        return {k: local_shard(v, rows[k], rmesh, data + ("data",)).to(dev)
                for k, v in batch.items()}

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    for fn, attr in LAUNCH_COUNTERS.values():
        setattr(fn, attr, 0)
    flash_mha.offset_launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    metrics, step_s, coll_s, groups = [], [], [], Counter()
    for i, seed in enumerate(spec["keys"]):
        batch = local(batches[min(i, len(batches) - 1)])
        sync()
        t0 = time.perf_counter()
        with record_collectives() as log:
            state, m = step(state, batch, prng.PRNGKey(seed))
            sync()
        step_s.append(time.perf_counter() - t0)
        coll_s.append(sum(r["seconds"] for r in log))
        groups.update((r["op"], "/".join(r["axes"]), r["group_size"])
                      for r in log)
        metrics.append({k: v.detach() for k, v in m.items()})
        if spec.get("log_every") and rank == 0 and (
                i % spec["log_every"] == 0 or i == len(spec["keys"]) - 1):
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"edge_power={float(m['edge_power']):.2e} "
                  f"({sum(step_s) / len(step_s):.2f}s/step)", flush=True)
    import torch.distributed as dist

    # a group of one rank makes no collective: one barrier on the world
    # runs the backend whatever the mesh
    dist.barrier()
    out = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "pid": os.getpid(),
           "coordinate": {a: rmesh.get_local_rank(a)
                          for a in data + ("model",)
                          if a in rmesh.mesh_dim_names and (
                              a != "model" or rmesh.size(
                                  rmesh.mesh_dim_names.index(a)) > 1)},
           "device": str(dev),
           "metrics": [{k: float(v) for k, v in m.items()}
                       for m in metrics],
           "step_seconds": step_s, "collective_seconds": coll_s,
           "collectives": [{"op": op, "axes": axes, "group_size": n,
                            "count": c}
                           for (op, axes, n), c in sorted(groups.items())],
           "launches": {name: getattr(fn, attr) for name, (fn, attr)
                        in LAUNCH_COUNTERS.items()},
           "offset_launches": flash_mha.offset_launches,
           "peak_allocated_bytes": (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else None)}
    if spec.get("reference"):
        names = {f"state/{k}": s for k, s in _spec_names(specs)}

        def cut(name, t):
            if name not in names:
                return t
            with axes_bound(rmesh):
                return shard_tree(t, names[name])
        out["vs_reference"] = compare_to_reference(spec["reference"],
                                                   state, metrics, cut)
    if spec.get("return_state"):
        with axes_bound(rmesh):
            state = gather_tree(state, specs)
        out["state"] = tree_map(lambda t: t.detach().cpu(), state)
        out["raw_metrics"] = [{k: v.cpu() for k, v in m.items()}
                              for m in metrics]
    if dev.type == "cuda":
        # the next spec's ranks share the card: hand back this one's
        # cached blocks
        del state, metrics
        torch.cuda.empty_cache()
    return out


def sweep_worker(rank: int, world: int, spec: dict) -> dict:
    """One rank of a sweep on ranks.  `spec`: "scenarios" (`Scenario`s),
    "seeds", "mesh" ((mc, mu), their product the world), "combine",
    "driver", "warmup", "device" ("cpu", or "cuda" for the rank's
    card), "keep_state", "guard".  The scenarios run one by one, their
    seeds one by one (``batch="map"``).  Returns the rank's
    `SweepResult`s (final states on the CPU) and, over the whole run,
    its kernel launches, the collectives it made (grouped by op, axes
    and group size) and their seconds, its coordinate, and its peak
    device memory.  A list of specs runs each in turn in the same
    processes."""
    if isinstance(spec, list):
        return [sweep_worker(rank, world, s) for s in spec]
    import torch.distributed as dist

    from repro_torch.exec import RankSweepRunner, make_rank_mesh
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.sharding import record_collectives
    from repro_torch.tree import tree_map

    mesh = make_rank_mesh(spec["mesh"], "cpu" if spec["device"] == "cpu"
                          else "cuda")
    runner = RankSweepRunner(
        spec["scenarios"], mesh, dist.get_backend(), seeds=spec["seeds"],
        keep_state=spec.get("keep_state", False),
        combine=spec.get("combine", "gathered"),
        driver=spec.get("driver", "stepwise"),
        warmup=spec.get("warmup", False), device=spec["device"],
        guard=spec.get("guard", "off"))
    dev = runner.device
    for fn, attr in LAUNCH_COUNTERS.values():
        setattr(fn, attr, 0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with record_collectives() as log:
        results = runner.run()
    seconds = time.perf_counter() - t0
    for r in results:
        if r.final_state is not None:
            r.final_state = tree_map(lambda t: t.detach().cpu(),
                                     r.final_state)
    groups = Counter((r["op"], "/".join(r["axes"]), r["group_size"])
                     for r in log)
    return {"rank": rank, "world": world, "backend": dist.get_backend(),
            "pid": os.getpid(), "device": str(dev),
            "coordinate": {a: mesh.get_local_rank(a)
                           for a in mesh.mesh_dim_names},
            "results": results, "seconds": seconds,
            "collective_seconds": sum(r["seconds"] for r in log),
            "collectives": [{"op": op, "axes": axes, "group_size": n,
                             "count": c}
                            for (op, axes, n), c in sorted(groups.items())],
            "launches": {name: getattr(fn, attr) for name, (fn, attr)
                         in LAUNCH_COUNTERS.items()},
            "peak_allocated_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None)}
