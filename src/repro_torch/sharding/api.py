"""Logical-axis sharding rules and the per-rank runner (the port of
`repro.sharding.api`).

Models name the dimensions of their parameters and activations by
*logical* axes (e.g. ("batch", "seq", "embed")); a `Rules` table maps
each logical name onto mesh axes.  A spec is a tuple with one entry per
tensor dimension, as JAX's `PartitionSpec`: None (replicated), a mesh
axis name, or a tuple of them (the dimension split over their product,
major to minor).  `placements` turns a spec into the DTensor placements
(`Shard(d)` / `Replicate()` per mesh dimension) of a
`torch.distributed.device_mesh.DeviceMesh`.

A mesh here is a `DeviceMesh` (ranks) or a mapping of axis names to
sizes in mesh order (a shape alone, e.g. ``{"data": 16, "model": 16}``,
for the tables of a mesh no process holds); `mesh_axes` reads either.

`shard_map` is the per-rank runner of the W-HFL training step and of
the sharded sweep: every process runs `f` on its own slice of the
inputs (cut by the in-specs over the manual axes) with the mesh's axis
names bound, so that `axis_index(name)` is the rank's coordinate on
that axis and the collectives run over the ranks that share every other
manual coordinate: `psum(x, names)` an all-reduce (`core.dist`'s hops),
`all_gather` the counterpart of `jax.lax`'s tiled one (the sweep
engine's, `exec.round`).  Collectives over a group of one rank
return their input and issue nothing.  A 0-dim tensor is summed as the
one-card code sums a list of scalars: gathered, then added left to
right in the group's rank order; a larger tensor is all-reduced by the
backend (for two members a + b in either order, so bit for bit the
one-card sum).  `record_collectives()` lists every collective with its
group size and seconds.  Inside `segmented(recorder)` a collective does
not run: it hands the recorder the call to make and an empty tensor of
its output's shape (the chunked driver's CUDA graphs stop there and
issue the collective between replays, `core.whfl._ChunkFn`).

Placements are executed as one process per mesh coordinate, every axis
manual: a rank holds plain tensors that are its shards, each leaf's
spec over the mesh saying which (`param_sharding_tree`; `shard_tree`
cuts a tree, `gather_tree` puts it back together, `shard_index` gives
a shard's flat indices in the whole leaf, for `prng.normal_at`).  Under
a "model" axis past 1 the models run tensor-parallel (`model_shards`
says how many ways the active rules split a logical axis), and the
collectives that autograd passes through are functions of their own:
`copy_to` (the identity; its backward sums over the group), `reduce_from`
(a sum; its backward the identity), `gather_shards` (an all-gather;
its backward `psum_scatter`) and `gather_from` (an all-gather of the
blocks of a replicated activation; its backward keeps the rank's own
block).  Each keeps the axis context, the rules and the collective log
it ran under for its backward, which autograd may run on a thread of
its own (`carry_context` does the same for a function that
`torch.utils.checkpoint` runs again there).  `logical` checks a
tensor's placement: its rank, and the local size of every dimension the
rules put on "model", the sequence-parallel attention's query rows
("q_seq", where the heads do not divide; `seq_block` gives a rank's
rows) among them.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch

class PartitionSpec(tuple):
    """A spec: one entry per tensor dimension.  A tuple (it equals the
    plain tuple of its entries), marked so that a spec and a tuple of
    specs stay apart.  A one-name tuple entry is that name, as JAX's
    `PartitionSpec` canonicalizes it (``P(("data",)) == P("data")``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


def is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, of a `DeviceMesh` or a mapping."""
    if is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


@dataclass(frozen=True)
class Rules:
    """Mapping from logical axis name -> mesh axis (or tuple of them).

    `bare` marks the rules of the manual (pod, cluster, user) context,
    where the data axes are mapped by the runner and only "model"
    remains.  `dims`: the global sizes of the logical axes the
    architecture fixes (heads, kv_heads, ffn, vocab, experts), for
    `logical`'s placement check."""

    mesh: object
    table: Mapping[str, Optional[object]] = field(default_factory=dict)
    bare: bool = False
    dims: Mapping[str, int] = field(default_factory=dict)

    def physical(self, name: Optional[str]):
        if name is None:
            return None
        return self.table.get(name, None)


_state = threading.local()


def current_rules() -> Optional[Rules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def set_rules(rules: Optional[Rules]):
    prev = current_rules()
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def spec_for(logical_axes: Sequence[Optional[str]],
             rules: Optional[Rules] = None) -> tuple:
    rules = rules or current_rules()
    if rules is None:
        return P()
    return P(*[rules.physical(a) for a in logical_axes])


def logical(x: torch.Tensor, *logical_axes: Optional[str],
            sizes: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """Check `x`'s placement against its logical axes and return it: a
    no-op when no rules are active; its rank must match; under a
    "model" axis past 1, every dimension the rules put on "model" must
    hold its shard, global size / model (`ValueError` naming the
    logical axis otherwise).  The global sizes are the architecture's
    (`Rules.dims`) and `sizes`' for the axes it does not fix: "q_seq"
    (sequence-parallel attention's query rows) takes its length there,
    which must divide by "model"."""
    rules = current_rules()
    if rules is None:
        return x
    if x.ndim != len(logical_axes):
        raise ValueError(
            f"logical(): rank mismatch, array rank {x.ndim} vs axes "
            f"{logical_axes}")
    n = mesh_axes(rules.mesh).get("model", 1)
    if n == 1:
        return x
    for d, name in enumerate(logical_axes):
        if "model" not in _names(rules.physical(name)):
            continue
        want = (sizes or {}).get(name, rules.dims.get(name))
        if name == "q_seq" and want is None:
            raise ValueError("logical(): 'q_seq' on 'model' needs the "
                             "sequence's length (sizes={'q_seq': L})")
        if want is not None and want % n:
            raise ValueError(
                f"logical(): axis {name!r} of {want} does not divide over "
                f"'model' ({n})")
        if want is not None and x.shape[d] * n != want:
            raise ValueError(
                f"logical(): axis {name!r} (dimension {d}) holds "
                f"{x.shape[d]}; its shard over 'model' ({n}) is "
                f"{want // n} of {want}")
    return x


def seq_block(L: int) -> Tuple[int, int]:
    """(first row, rows) of this rank's block of L query rows under
    sequence-parallel attention ("q_seq" on "model"): the contiguous
    L / model rows at its "model" coordinate, as the reference's
    sharding of the row axis cuts them; (0, L) where the rules do not
    put "q_seq" on "model".  `ValueError` where L does not divide."""
    n = model_shards("q_seq")
    if n == 1:
        return 0, L
    if L % n:
        raise ValueError(f"sequence-parallel attention: the sequence of {L} "
                         f"positions does not divide over 'model' ({n})")
    b = L // n
    return axis_index("model") * b, b


def model_shards(name: str) -> int:
    """How many ways the active rules split logical axis `name` over
    "model" on this rank: the "model" axis's size where the rules put
    `name` on it and an axis context is bound, else 1."""
    rules, ctx = current_rules(), current_axes()
    if rules is None or ctx is None or "model" not in _names(
            rules.physical(name)):
        return 1
    return mesh_axes(ctx.mesh).get("model", 1)


# ---------------------------------------------------------------------------
# Default rule tables
# ---------------------------------------------------------------------------

def make_rules(mesh, *, fsdp: bool = True, cfg=None,
               inside_shardmap: bool = False) -> Rules:
    """Standard 2D/3D parallelism rules, optionally architecture-aware.

    data-ish logical axes map onto the data axes (pod/data or
    pod/cluster/user for the W-HFL-refined mesh); model-ish onto "model".
    With `fsdp`, the `embed` dim of weights is sharded over the data axes
    too (ZeRO-3 style).  With `cfg` (an ArchConfig), head/KV-head/expert
    /ffn/vocab sharding is enabled only where the dimension divides by
    the model-axis size.  `inside_shardmap=True`: the rules of the manual
    (pod, cluster, user) context, where batch-like names stay None and
    only "model" is emitted.  Reads only the mesh's axis names and
    sizes."""
    sizes = mesh_axes(mesh)
    axes = tuple(sizes)
    data_axes = (None if inside_shardmap else
                 tuple(a for a in ("pod", "cluster", "user", "data")
                       if a in axes) or None)
    model_ax = "model" if "model" in axes else None
    n_model = sizes.get("model", 1)
    fsdp_ax = None if (inside_shardmap or not fsdp) else data_axes

    def fits(dim: Optional[int]) -> Optional[str]:
        if dim is None:       # unknown -> assume shardable
            return model_ax
        return model_ax if (dim and dim % n_model == 0) else None

    heads_ax = kv_ax = experts_ax = model_ax
    vocab_ax = ffn_ax = model_ax
    dims = {}
    if cfg is not None:
        heads_ax = fits(getattr(cfg, "n_heads", None) or None)
        kv_ax = fits(getattr(cfg, "n_kv_heads", None) or None)
        experts_ax = fits(getattr(cfg, "n_experts", None) or None)
        ffn_ax = fits(getattr(cfg, "d_ff", None) or None)
        vocab_ax = fits(getattr(cfg, "vocab", None) or None)
        dims = {a: getattr(cfg, f, 0) for a, f in (
            ("heads", "n_heads"), ("kv_heads", "n_kv_heads"),
            ("ffn", "d_ff"), ("vocab", "vocab"), ("experts", "n_experts"))
            if getattr(cfg, f, 0)}
        if getattr(cfg, "family", "") in ("ssm", "hybrid"):
            # mamba head-packed dims shard iff the SSM head count divides;
            # hybrids share the logical name with attention heads, so both
            # must divide
            d_inner = cfg.ssm_expand * cfg.d_model
            ssm_heads = d_inner // max(cfg.ssm_head_dim, 1)
            if cfg.family == "ssm":
                heads_ax = fits(ssm_heads)
            elif not (fits(ssm_heads) and heads_ax):
                heads_ax = None

    table = {
        # activations
        "batch": data_axes,
        "users": data_axes,          # stacked per-user leading dim
        "seq": None,
        # sequence-parallel attention: the q rows over 'model' when the
        # head count cannot shard
        "q_seq": model_ax if heads_ax is None else None,
        "embed": None,
        "heads": heads_ax,
        "kv_heads": kv_ax,
        "head_dim": None,
        "ffn": ffn_ax,
        "expert_ffn": None,
        "moe_tokens": model_ax,
        "experts": experts_ax,
        "vocab": vocab_ax,
        "state": None,
        "clusters": "pod" if "pod" in axes else None,
        # params
        "p_embed": fsdp_ax,          # fsdp'd embed dim of weight matrices
        "p_heads": heads_ax,
        "p_kv_heads": kv_ax,
        "p_ffn": ffn_ax,
        "p_expert_ffn": None,
        "p_experts": experts_ax,
        "p_vocab": vocab_ax,
        "layers": None,
    }
    return Rules(mesh=mesh, table=table, bare=inside_shardmap, dims=dims)


def map_axes_tree(fn, tree):
    """`fn` on every leaf of a logical-axes tree (dicts and lists of
    tuples; a tuple is a leaf)."""
    if isinstance(tree, dict):
        return {k: map_axes_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_axes_tree(fn, v) for v in tree]
    return fn(tree)


def param_sharding_tree(param_axes_tree, rules: Rules):
    """Map a tree of logical-axes tuples to specs over `rules.mesh`."""
    return map_axes_tree(lambda axes: spec_for(axes, rules),
                         param_axes_tree)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence, mesh) -> list:
    """The DTensor placements of `spec` on a `DeviceMesh`: ``Shard(d)``
    on each mesh dimension that a spec entry d names, ``Replicate()`` on
    the others."""
    from torch.distributed.tensor import Replicate, Shard

    where = {a: d for d, entry in enumerate(spec) for a in _names(entry)}
    return [Shard(where[a]) if a in where else Replicate()
            for a in mesh.mesh_dim_names]


# ---------------------------------------------------------------------------
# The per-rank runner and its collectives
# ---------------------------------------------------------------------------

@dataclass
class _AxisContext:
    mesh: object                       # DeviceMesh
    manual: Tuple[str, ...]


_groups: Dict[tuple, object] = {}
_log = threading.local()


def forget_groups() -> None:
    """Drop the process groups the collectives made (call it with the
    process group that holds them destroyed)."""
    _groups.clear()


def current_axes() -> Optional[_AxisContext]:
    """The axis context `shard_map` binds while it runs `f`, or None."""
    return getattr(_state, "axes", None)


def _ctx() -> _AxisContext:
    ctx = current_axes()
    if ctx is None:
        raise RuntimeError("axis names are bound only inside shard_map")
    return ctx


def _as_names(names) -> Tuple[str, ...]:
    return (names,) if isinstance(names, str) else tuple(names)


def axis_index(name: str) -> int:
    """This rank's coordinate on mesh axis `name`."""
    return _ctx().mesh.get_local_rank(name)


def axis_size(name: str) -> int:
    return mesh_axes(_ctx().mesh)[name]


def _group(names: Tuple[str, ...]):
    """(process group, member ranks) of the ranks that share this rank's
    coordinates on every mesh axis but `names`, in the mesh order of
    `names` (major to minor).  Every rank builds every group of the
    partition, in one order, so the collective `new_group` calls agree."""
    mesh = _ctx().mesh
    order = list(mesh.mesh_dim_names)
    dims = [order.index(n) for n in names]
    rest = [d for d in range(len(order)) if d not in dims]
    ranks = mesh.mesh.permute(*rest, *dims).reshape(
        -1, math.prod(mesh.shape[d] for d in dims))
    key = (tuple(mesh.mesh.flatten().tolist()), tuple(mesh.shape),
           tuple(order), names)
    if key not in _groups:
        import torch.distributed as dist

        mine, _ = dist.new_subgroups_by_enumeration(
            [row.tolist() for row in ranks])
        me = dist.get_rank()
        row = next(r.tolist() for r in ranks if me in r.tolist())
        _groups[key] = (mine, row)
    return _groups[key]


@contextlib.contextmanager
def record_collectives() -> Iterator[List[dict]]:
    """Record every collective the runner makes while the block runs:
    {"op", "axes", "group_size", "numel", "seconds"}, the seconds from
    a device synchronize before it to its end."""
    prev = getattr(_log, "records", None)
    _log.records = []
    try:
        yield _log.records
    finally:
        _log.records = prev


def _timed(op: str, names, size: int, x: torch.Tensor, run):
    records = getattr(_log, "records", None)
    if records is None:
        return run()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    out = run()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    records.append({"op": op, "axes": list(names), "group_size": size,
                    "numel": x.numel(), "seconds": time.perf_counter() - t0})
    return out


def _gather(x: torch.Tensor, group, size: int) -> List[torch.Tensor]:
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


@contextlib.contextmanager
def segmented(recorder) -> Iterator[None]:
    """Hand every collective the block makes to `recorder` instead of
    running it: ``recorder.cut(issue, shape, dtype, device)`` gets the
    call that runs the collective (``issue()`` returns its output) and
    returns the tensor that stands for the output from then on."""
    prev = getattr(_state, "segments", None)
    _state.segments = recorder
    try:
        yield
    finally:
        _state.segments = prev


def _collective(op: str, names, size: int, x: torch.Tensor, run,
                shape) -> torch.Tensor:
    """``run(x)`` as collective `op` over `size` ranks, timed where
    `record_collectives` records; handed to the `segmented` recorder
    where one is active (`shape`: the output's)."""
    recorder = getattr(_state, "segments", None)
    issue = lambda: _timed(op, names, size, x, lambda: run(x))
    if recorder is None:
        return issue()
    return recorder.cut(issue, tuple(shape), x.dtype, x.device)


def _group_size(names: Tuple[str, ...]) -> int:
    sizes = mesh_axes(_ctx().mesh)
    return math.prod(sizes[n] for n in names)


def psum(x: torch.Tensor, names) -> torch.Tensor:
    """Sum of `x` over the ranks of the manual axes `names`: a 0-dim
    tensor gathered and added left to right in the group's rank order
    (as the one-card code's ``sum`` of a list), anything else
    all-reduced by the backend."""
    names = _as_names(names)
    group, members = _group(names)
    if len(members) == 1:
        return x
    if x.ndim == 0:
        def run(x):
            out = 0
            for part in _gather(x, group, len(members)):
                out = out + part
            return out
        return _collective("psum_scalar", names, len(members), x, run, ())

    def run(x):
        import torch.distributed as dist

        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y
    return _collective("all_reduce", names, len(members), x, run, x.shape)


def pmean(x: torch.Tensor, names) -> torch.Tensor:
    """Mean of a 0-dim `x` over the ranks of `names`: the gathered values
    stacked and averaged (``torch.stack(...).mean()``, as the one-card
    step averages its users')."""
    names = _as_names(names)
    group, members = _group(names)
    if len(members) == 1:
        return torch.stack([x]).mean()
    return _collective("pmean", names, len(members), x, lambda x: torch.stack(
        _gather(x, group, len(members))).mean(), ())


def all_gather(x: torch.Tensor, names, axis: int = 0) -> torch.Tensor:
    """`jax.lax.all_gather(..., tiled=True)`: every member's `x` of the
    group over `names`, in the group's mesh order, concatenated along
    `axis`."""
    names = _as_names(names)
    n = _group_size(names)
    if n == 1:
        return x
    group, _ = _group(names)
    x = x.contiguous()
    axis %= x.ndim
    shape = list(x.shape)
    shape[axis] *= n
    return _collective("all_gather", names, n, x, lambda x: torch.cat(
        _gather(x, group, n), dim=axis), shape)


def psum_scatter(x: torch.Tensor, names, axis: int = 0) -> torch.Tensor:
    """`jax.lax.psum_scatter(..., tiled=True)`: the sum of `x` over the
    group of `names`, of which this rank keeps its block along `axis`
    (the blocks in the group's mesh order).  The sum is `psum`'s, so
    the block has the bits of the same block of ``psum(x, names)``."""
    names = _as_names(names)
    n = _group_size(names)
    if n == 1:
        return x
    group, _ = _group(names)
    axis %= x.ndim
    if x.shape[axis] % n:
        raise ValueError(f"dimension {axis} of size {x.shape[axis]} does "
                         f"not divide over {names} ({n})")
    b = x.shape[axis] // n
    i, _ = _coordinate(names)
    shape = list(x.shape)
    shape[axis] = b

    def run(x):
        import torch.distributed as dist

        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y.narrow(axis, i * b, b).clone()
    return _collective("psum_scatter", names, n, x, run, shape)


def pmax(x: torch.Tensor, names) -> torch.Tensor:
    """Elementwise maximum of `x` over the ranks of `names` (exact in any
    order)."""
    names = _as_names(names)
    group, members = _group(names)
    if len(members) == 1:
        return x

    def run(x):
        import torch.distributed as dist

        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
        return y
    return _collective("pmax", names, len(members), x, run, x.shape)


# ---------------------------------------------------------------------------
# Collectives under autograd
# ---------------------------------------------------------------------------

def _saved() -> tuple:
    return current_axes(), current_rules(), getattr(_log, "records", None)


@contextlib.contextmanager
def _restored(saved: tuple):
    prev = _saved()
    _state.axes, _state.rules, _log.records = saved
    try:
        yield
    finally:
        _state.axes, _state.rules, _log.records = prev


def carry_context(fn):
    """`fn` bound to the axis context, rules and collective log active
    now, wherever it runs later (`torch.utils.checkpoint` recomputes a
    forward inside the backward, which autograd runs on a thread of its
    own for CUDA tensors)."""
    saved = _saved()

    def run(*args):
        with _restored(saved):
            return fn(*args)
    return run


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names):
        ctx.names, ctx.saved = names, _saved()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with _restored(ctx.saved):
            return psum(g, ctx.names), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names):
        return psum(x, names)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names, axis):
        ctx.names, ctx.axis, ctx.saved = names, axis, _saved()
        return all_gather(x, names, axis)

    @staticmethod
    def backward(ctx, g):
        with _restored(ctx.saved):
            return psum_scatter(g, ctx.names, ctx.axis), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names, axis):
        ctx.axis, ctx.block = axis, x.shape[axis]
        ctx.start = _coordinate(names)[0] * ctx.block
        return all_gather(x, names, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.axis, ctx.start, ctx.block), None, None


def copy_to(x: torch.Tensor, names) -> torch.Tensor:
    """A replicated input entering a split computation over `names` (a
    column-parallel product): the identity, whose backward sums the
    gradient over the group."""
    names = _as_names(names)
    return x if _group_size(names) == 1 else _CopyTo.apply(x, names)


def reduce_from(x: torch.Tensor, names) -> torch.Tensor:
    """The partial results of a split computation over `names` (a
    row-parallel product, a vocab-parallel lookup) summed: `psum`, whose
    backward is the identity (every member's loss is the same)."""
    names = _as_names(names)
    return x if _group_size(names) == 1 else _ReduceFrom.apply(x, names)


def gather_shards(x: torch.Tensor, names, axis: int) -> torch.Tensor:
    """A parameter's shards over `names` put together along `axis`
    (FSDP): `all_gather`, whose backward is `psum_scatter` (each member
    keeps its block of the gradient summed over the group)."""
    names = _as_names(names)
    if _group_size(names) == 1:
        return x
    return _GatherShards.apply(x, names, axis % x.ndim)


def gather_from(x: torch.Tensor, names, axis: int) -> torch.Tensor:
    """The blocks of an activation that a split computation over `names`
    made along `axis` (sequence-parallel attention's rows) put together
    into the replicated whole: `all_gather`, whose backward keeps this
    rank's block of the gradient.  That gradient is the same on every
    member (what follows runs replicated), so it is cut, not summed, as
    `gather_shards`' `psum_scatter` would sum it n times."""
    names = _as_names(names)
    if _group_size(names) == 1:
        return x
    return _GatherFrom.apply(x, names, axis % x.ndim)


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def axes_bound(mesh, manual: Optional[Sequence[str]] = None):
    """Bind `mesh`'s axis names (all of them, or `manual`) as `shard_map`
    does while it runs its function, for code that cuts, gathers or
    draws shards outside it."""
    prev = current_axes()
    _state.axes = _AxisContext(mesh, tuple(manual) if manual is not None
                               else tuple(mesh.mesh_dim_names))
    try:
        yield
    finally:
        _state.axes = prev


def _split(entry, names) -> Tuple[str, ...]:
    """The axes of spec entry `entry` among `names` (None: every axis of
    the bound mesh) whose size is past 1, in the entry's order."""
    sizes = mesh_axes(_ctx().mesh)
    return tuple(a for a in _names(entry) if a in sizes and sizes[a] > 1
                 and (names is None or a in names))


def _cut(x: torch.Tensor, spec: Sequence, names=None) -> torch.Tensor:
    for d, entry in enumerate(spec):
        axes = _split(entry, names)
        if not axes:
            continue
        i, n = _coordinate(axes)
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of size {x.shape[d]} "
                             f"does not divide over {axes} ({n})")
        b = x.shape[d] // n
        x = x.narrow(d, i * b, b)
    return x


def _spec_tree_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree (dicts and lists) and its spec tree
    (the same structure, a `PartitionSpec` at each leaf)."""
    if isinstance(tree, dict):
        return {k: _spec_tree_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_spec_tree_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def shard_tree(tree, specs, names=None):
    """This rank's shard (views) of every leaf of `tree` under its spec
    in `specs` (a tree of the same structure), cut over the spec's axes
    among `names` (default: all of the bound mesh's)."""
    return _spec_tree_map(lambda x, spec: _cut(x, spec, names), tree, specs)


def gather_tree(tree, specs, names=None, *, differentiable=False):
    """Every leaf's shards over its spec's axes among `names` (default:
    all) gathered back together along each split dimension: by
    `all_gather`, or with ``differentiable`` by `gather_shards` (FSDP's
    gather under autograd)."""
    op = gather_shards if differentiable else all_gather

    def gather(x, spec):
        for d, entry in enumerate(spec):
            axes = _split(entry, names)
            if axes:
                x = op(x, axes, d)
        return x
    return _spec_tree_map(gather, tree, specs)


def spec_leaves(specs) -> list:
    """The specs of a spec tree (dicts and lists, a tuple at each leaf)
    in `repro_torch.tree`'s leaf order."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


def split_axes(spec: Sequence, names=None) -> Tuple[str, ...]:
    """The bound mesh's axes (among `names`, default all) that `spec`
    splits a leaf over, in mesh order."""
    order = list(_ctx().mesh.mesh_dim_names)
    return tuple(sorted({a for e in spec for a in _split(e, names)},
                        key=order.index))


def shard_shape(shape: Sequence[int], spec: Sequence) -> Tuple[int, ...]:
    """The shape of this rank's shard of a leaf of global `shape`."""
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= _group_size(_split(entry, None))
    return tuple(out)


def global_shape(shape: Sequence[int], spec: Sequence) -> Tuple[int, ...]:
    """The global shape of a leaf whose shard on this rank has `shape`."""
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] *= _group_size(_split(entry, None))
    return tuple(out)


def sharded(spec: Optional[Sequence]) -> bool:
    """Whether `spec` splits a leaf on the bound mesh."""
    return spec is not None and bool(split_axes(spec))


def shard_index(shape: Sequence[int], spec: Sequence,
                device=None) -> torch.Tensor:
    """The flat indices in a leaf of global `shape` (row-major) of this
    rank's shard under `spec`, an int64 tensor of the shard's shape."""
    local = shard_shape(shape, spec)
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(shape))):
        axes = _split(spec[d], None) if d < len(spec) else ()
        off = _coordinate(axes)[0] * local[d] if axes else 0
        pos = torch.arange(off, off + local[d], dtype=torch.int64,
                           device=device) * stride
        idx = idx + pos.reshape((-1,) + (1,) * (len(shape) - 1 - d))
        stride *= shape[d]
    return idx


def _coordinate(names: Tuple[str, ...]) -> Tuple[int, int]:
    """(this rank's linear coordinate over `names`, their product)."""
    mesh = _ctx().mesh
    sizes = mesh_axes(mesh)
    idx, n = 0, 1
    for name in names:
        idx = idx * sizes[name] + mesh.get_local_rank(name)
        n *= sizes[name]
    return idx, n


def local_shard(tree, spec: Sequence, mesh, manual: Sequence[str]):
    """This rank's slice of every tensor leaf of `tree` under `spec`:
    each dimension whose entry names manual axes cut into their product
    of equal blocks, the rank's block by its coordinate over them."""
    manual = tuple(manual)

    def cut(x):
        if not isinstance(x, torch.Tensor):
            return x
        with axes_bound(mesh, manual):
            return _cut(x, spec, manual)
    return _map_tensors(cut, tree)


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree)


def shard_map(f, mesh, in_specs, out_specs, axis_names=None):
    """The per-rank runner: ``shard_map(f, mesh, in_specs, out_specs)
    (*args)`` runs `f` on this rank's slice of each argument (its
    in-spec applies to every tensor leaf of it) with the mesh's axis
    names bound for `axis_index` and the collectives; `axis_names` are
    the manual axes (default: all of the mesh's).  The outputs are this
    rank's, replicated by construction: an out-spec may name no manual
    axis."""
    manual = tuple(axis_names) if axis_names is not None else tuple(
        mesh.mesh_dim_names)
    outs = [out_specs] if isinstance(out_specs, P) else list(out_specs)
    if any(a in manual for spec in outs for e in spec for a in _names(e)):
        raise NotImplementedError(
            f"out_specs {out_specs}: outputs split over the manual axes")

    def run(*args):
        specs = ([in_specs] * len(args) if isinstance(in_specs, P)
                 else list(in_specs))
        local = [local_shard(a, s, mesh, manual)
                 for a, s in zip(args, specs)]
        prev = current_axes()
        _state.axes = _AxisContext(mesh, manual)
        try:
            return f(*local)
        finally:
            _state.axes = prev
    return run
