"""W-HFL federated round (paper §II-III protocol, Mode A: paper scale).

Per global round t:
  - every MU (c,m) runs `tau` local optimizer steps from its cluster
    model theta_IS[c]  (eq. 2),
  - each cluster OTA-aggregates the MU deltas at its IS (eqs. 8-13),
    repeated for `I` cluster iterations,
  - ISs OTA-transmit their accumulated deltas to the PS, which closes
    the round (eqs. 15-18).

`make_round_fn` builds the per-round function ``round_fn(state, key,
P_t, P_is_t) -> state``.  Local training runs batched over the C*M users
in vmapped passes of M (`torch.func.vmap` of `torch.func.grad`; every
engine uses that width, so a user's gradient has the same bits whoever
shares its pass), with every user's minibatch indices drawn at once by
the batched `jax.random` emulation, so a seed reproduces the JAX
package's round: keys split in the same order, the same users draw the
same indices, and the OTA hops get the same keys.  Baselines: ``mode="conventional"`` (single-hop OTA FL) and
``OTAConfig(mode="ideal")`` (error-free).

Partial participation and the robust cluster folds live in the round
body (`make_round_body`), once for every engine: each round takes its
attendance mask from `WHFLConfig.participation` at the round index
(`repro_torch.fed.ParticipationSchedule.present`, on the device),
precodes every user's flat delta with its transmit multiplier before any
hop and before the power fold, and folds the cluster hop by the
attendance-rescaled OTA mean or by a robust fold over orthogonalized
per-user receptions (`WHFLConfig.cluster_agg`).  A full schedule with the
mean fold inserts no op.

`make_window_fn` is the drivers' unit: the rounds of one eval window
and the eval, over a sweep's seeds run one by one (``batch="map"``) or
as one program under `torch.func.vmap` (``batch="vmap"``).  The
stepwise driver runs it eagerly; `make_chunk_fn` replays it as one CUDA
graph per window length on the card.
"""
from __future__ import annotations

import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core import aggregation as agg
from repro_torch.core.channel import (ROBUST_CAPABLE_BACKENDS, OTAConfig,
                                      _const, cluster_ota, conventional_ota,
                                      global_ota, orthogonal_cluster_ota,
                                      resolve_backend)
from repro_torch.core.topology import Topology, power_schedule
from repro_torch.device import resolve_device
from repro_torch.fed.clients import ParticipationSchedule
from repro_torch.ft.faults import GradPoison
from repro_torch.ft.guard import guard_estimate, validate_guard
from repro_torch.obs.telemetry import (cluster_telemetry, is_telemetry,
                                       is_telemetry_zero, telemetry_init)
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.tree import tree_leaves, tree_map

MODES = ("whfl", "conventional")
CLUSTER_AGGREGATORS = ("mean", "median", "trimmed_mean")


@dataclass(frozen=True)
class WHFLConfig:
    tau: int = 1                 # local (user) iterations per cluster round
    I: int = 1                   # cluster iterations per global round
    batch: int = 500
    mode: str = "whfl"           # "whfl" | "conventional"
    ota: OTAConfig = field(default_factory=OTAConfig)
    power_base: float = 1.0
    power_slope: float = 1e-2
    power_is_factor: float = 20.0
    power_low: bool = False      # P_t,low = 0.5 P_t (paper's I=1 runs)
    # per-round MU attendance and behaviour (repro_torch.fed); the
    # default full schedule inserts no op
    participation: ParticipationSchedule = field(
        default_factory=ParticipationSchedule)
    # cluster-hop fold: "mean" (the paper's OTA superposition) |
    # "median" | "trimmed_mean" (robust folds over orthogonalized
    # per-user receptions; reference/equivalent/ideal only)
    cluster_agg: str = "mean"
    agg_trim: float = 0.25       # trim fraction for "trimmed_mean"
    # in-program round diagnostics (repro_torch.obs.telemetry): the
    # state gains a "telemetry" block, recomputed every round; False
    # adds no op (a Python-level gate)
    telemetry: bool = False
    # non-finite guard over the hops' estimates (repro_torch.ft.guard):
    # "off" | "halt" | "skip_round" | "zero_fill"; "off" adds no op
    guard: str = "off"
    # fault injection (repro_torch.ft.faults.GradPoison): user (c, m)'s
    # transmitted flat made NaN or Inf at round t; None adds no op
    poison: Optional[GradPoison] = None


def validate_participation(cfg: WHFLConfig) -> None:
    """Fail fast on configs no round can run: an unknown cluster
    aggregator, a robust fold in conventional mode (there is no cluster
    hop to make robust), or a robust fold on a superposition backend
    (`repro_torch.core.channel.ROBUST_CAPABLE_BACKENDS`)."""
    if cfg.cluster_agg not in CLUSTER_AGGREGATORS:
        raise ValueError(
            f"unknown cluster_agg {cfg.cluster_agg!r}; known: "
            f"{', '.join(CLUSTER_AGGREGATORS)}")
    if cfg.cluster_agg == "mean":
        return
    if cfg.mode != "whfl":
        raise ValueError(
            "robust cluster aggregation (cluster_agg="
            f"{cfg.cluster_agg!r}) needs the W-HFL cluster hop; "
            f"mode={cfg.mode!r} has none")
    if cfg.ota.mode != "ideal":
        backend = resolve_backend(cfg.ota)
        if backend not in ROBUST_CAPABLE_BACKENDS:
            raise ValueError(
                f"cluster_agg={cfg.cluster_agg!r} needs per-user "
                f"reception; backend {backend!r} is an in-channel OTA "
                f"superposition (see repro_torch.core.channel."
                f"ROBUST_CAPABLE_BACKENDS)")


def init_round_state(params, opt: Optimizer, C: int, M: int,
                     telemetry_C: Optional[int] = None,
                     guard: bool = False):
    """Fresh per-run round state: the global model, per-user optimizer
    state ``[C, M, ...]`` (carried across rounds), the round index and
    the transmit-power accumulators.

    ``telemetry_C`` (the real cluster count, never a mesh-padded one)
    adds the zero ``"telemetry"`` block a ``WHFLConfig.telemetry``
    round updates; ``guard=True`` (for ``WHFLConfig.guard != "off"``)
    adds the int32 ``"guard_trips"`` count.  The defaults leave the
    state as it was without either."""
    dev = next(tree_leaves(params))[1].device
    opt_state = tree_map(lambda x: x.expand(C, M, *x.shape).clone(),
                         opt.init(params))
    zero = torch.zeros((), device=dev)
    state = {
        "theta": params,
        "opt": opt_state,
        "t": torch.zeros((), dtype=torch.int32, device=dev),
        "power_edge": zero.clone(),   # sum of per-symbol tx power, edge
        "power_is": zero.clone(),     # same, IS->PS hop
        "n_edge_tx": zero.clone(),    # transmissions counted
        "n_is_tx": zero.clone(),
    }
    if telemetry_C is not None:
        state["telemetry"] = telemetry_init(telemetry_C, dev)
    if guard:
        state["guard_trips"] = torch.zeros((), dtype=torch.int32,
                                           device=dev)
    return state


def make_local_train(loss_fn: Callable, opt: Optimizer, cfg: WHFLConfig,
                     pass_width: int) -> Callable:
    """Build the batched local-training step ``local_train(theta,
    opt_state, X, Y, keys, step) -> (delta, opt_state)``: every user
    takes `cfg.tau` optimizer steps from its own `theta` on its own
    shard and returns the model difference (eq. 2).

    theta and opt_state carry a leading user axis [U, ...]; X [U, n,
    ...], Y [U, n]; keys [U, 2].  Per step each user splits its key into
    (kb, kd) and draws `cfg.batch` indices from kb, as the reference's
    per-user program does; where the loss has a ``draw_rng``, it draws
    from every user's kd at once what the model would draw (the CNN's
    dropout masks), and each user's share is its `rng`.

    The gradients run in vmapped passes of `pass_width` users.  A pass's
    users never mix, but on the card the algorithm of a batched GEMM and
    of the bias gradient's sum over the batch follows the number of
    users in the pass, and with it the bits of every user's gradient.  So every
    engine gives the same width (the round builders pass the scenario's
    M): the caller's users are cut into passes of exactly `pass_width`,
    the last one filled with zero users whose gradients are dropped, and
    a user's gradient then has the same bits on every engine and mesh,
    whoever shares its pass.

    Where the loss sets ``per_user_grads`` each user's gradient is
    `torch.func.grad` of fresh copies of its own unbatched inputs, so it
    sees the same shapes (and bits) however many users the caller holds
    (under vmap a convolution with per-user weights becomes a grouped
    one, whose algorithm follows the group count); the optimizer step,
    elementwise, still runs over all users at once.
    """
    one_grad = torch.func.grad(loss_fn)
    grad_fn = torch.func.vmap(one_grad)
    draw = getattr(loss_fn, "draw_rng", None)
    per_user = getattr(loss_fn, "per_user_grads", False)

    def in_passes(args):
        """`grad_fn` over the user axis in passes of exactly
        `pass_width` users."""
        U, W = args[1].shape[0], pass_width
        parts = []
        for u0 in range(0, U, W):
            n = min(W, U - u0)
            part = tree_map(lambda a: a[u0:u0 + n].contiguous(), args)
            if n < W:
                part = tree_map(lambda a: torch.cat(
                    [a, a.new_zeros((W - n, *a.shape[1:]))]), part)
            g = grad_fn(*part)
            parts.append(g if n == W else tree_map(lambda x: x[:n], g))
        if len(parts) == 1:
            return parts[0]
        return tree_map(lambda *xs: torch.cat(xs), *parts)

    def grads_of(th, xb, yb, rng):
        args = [th, xb, yb, rng]
        if not per_user:
            return in_passes(args)
        parts = [one_grad(*tree_map(lambda a: a[u].clone(), args))
                 for u in range(xb.shape[0])]
        return tree_map(lambda *xs: torch.stack(xs), *parts)

    def local_train(theta, opt_state, X, Y, keys, step):
        users = torch.arange(X.shape[0], device=X.device)[:, None]
        th, st = theta, opt_state
        step_keys = prng.split(keys, cfg.tau)                 # [U, tau, 2]
        for i in range(cfg.tau):
            kb, kd = prng.split(step_keys[:, i]).unbind(-2)
            idx = prng.randint(kb, (cfg.batch,), 0, X.shape[1])
            rng = kd if draw is None else draw(kd, cfg.batch)
            grads = grads_of(th, X[users, idx], Y[users, idx], rng)
            upd, st = opt.update(grads, st, th, step)
            th = apply_updates(th, upd)
        return tree_map(lambda a, b: a - b, th, theta), st

    return local_train


def make_round_body(topo: Topology, cfg: WHFLConfig, spec: agg.FlatSpec,
                    users_train: Callable, cluster_estimate: Callable,
                    n_rx: int) -> Callable:
    """The W-HFL round every engine runs, ``round_fn(state, key, P_t,
    P_is_t) -> state``: the conventional baseline, or `cfg.I` cluster
    iterations and the IS -> PS hop.  An engine supplies how its users
    train and how its cluster hop runs:

    - ``users_train(theta_IS, opt_state, key, step) -> (flat,
      opt_state)``: every real user's local training from its cluster's
      model in the [n_rx]-stacked `theta_IS`; flat [C, M, 2N] deltas;
    - ``cluster_estimate(key, flat, P_t) -> [n_rx, 2N]``: the cluster
      hop, each rx station's estimate of its cluster's mean delta.

    `n_rx` is C, or more where an engine pads clusters in; only the
    first C cluster models transmit to the PS, and the padded rows of
    an estimate stay zero.

    Participation (`cfg.participation`) and the cluster fold
    (`cfg.cluster_agg`) are applied here, on the real [C, M] block, so
    every engine runs them alike.  Each round's mask ``claimed`` and
    multiplier ``mult = claimed * tx_base`` come from the round index on
    its device.  Each hop precodes the users' flat deltas by ``mult``
    and takes their energies for the power fold from the precoded flat
    (a multiplier that is not a power of two changes the energy's
    rounding).  The mean fold rescales the hop's estimate by
    `agg.attendance_rescale` (padded rx rows by 1); a robust fold runs
    `orthogonal_cluster_ota` and the masked median or trimmed mean (its
    padded rows 0).  A full schedule with the mean fold adds no op.

    Telemetry (`cfg.telemetry`, `repro_torch.obs.telemetry`) reads the
    real [C, M] precoded flat, the real rows of the last cluster
    iteration's estimate after the guard, and the IS deltas; the guard
    (`cfg.guard`) runs on each hop's estimate before it is applied and
    counts its trips in ``state["guard_trips"]``; a planned poison
    (`cfg.poison`) is added to the flat the fold hears (not to the one
    the power fold and telemetry read), selected on the device from the
    round index.  Each is a Python-level gate: off, it adds no op.
    """
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}; known: "
                         f"{', '.join(MODES)}")
    validate_participation(cfg)
    validate_guard(cfg.guard)
    C, M, N = topo.C, topo.M, spec.two_n // 2
    tele_on = cfg.telemetry
    guard_on = cfg.guard != "off"
    poison = cfg.poison
    if poison is not None:
        if poison.c >= C or poison.m >= M:
            raise ValueError(
                f"poison targets user ({poison.c}, {poison.m}) outside "
                f"the ({C}, {M}) grid")
        poison_at = np.zeros((C, M), np.float32)
        poison_at[poison.c, poison.m] = 1.0
    schedule = cfg.participation
    partial = not schedule.is_full
    robust = cfg.cluster_agg != "mean"
    ideal = cfg.ota.mode == "ideal"
    # static [C, M] grids, uploaded once per device (`_const`): the
    # transmit multipliers' base and the weights the rescale sums over
    # (the ideal mean weighs users alike, the OTA folds by their gains)
    tx_base = schedule.tx_base(C, M)
    ones = np.ones((C, M), np.float32)
    rx_w = ones if ideal else np.asarray(topo.beta_own, np.float32)
    rx_w_conv = (ones if ideal
                 else np.asarray(topo.beta_mu_ps, np.float32)).reshape(-1)

    def pad_rx(x, fill):
        """[C, ...] -> [n_rx, ...], the padded rows `fill`."""
        if n_rx == C:
            return x
        return F.pad(x, (0, 0) * (x.dim() - 1) + (0, n_rx - C), value=fill)

    def cluster_fold(key, flat, claimed, P_t):
        """The cluster hop's receive fold: the OTA superposition mean
        (rescaled to the claimed users under partial participation) or
        a robust masked fold over per-user receptions."""
        if robust:
            mask = (claimed if partial
                    else torch.ones((C, M), device=flat.device))
            per_user = orthogonal_cluster_ota(key, flat, topo, P_t, cfg.ota)
            if cfg.cluster_agg == "median":
                est = agg.masked_median(per_user, mask)
            else:
                est = agg.masked_trimmed_mean(per_user, mask, cfg.agg_trim)
            return pad_rx(est, 0.0)
        est = cluster_estimate(key, flat, P_t)               # [n_rx, 2N]
        if partial:
            resc = agg.attendance_rescale(_const(rx_w, flat.device),
                                          claimed)
            est = est * pad_rx(resc, 1.0)[:, None]
        return est

    def maybe_poison(flat, step):
        """The planned poison added to the poisoned user's row at its
        round, chosen on the device from the round index (a CUDA graph
        replays it)."""
        if poison is None:
            return flat
        hit = (step == poison.t) & (_const(poison_at, step.device) > 0)
        return flat + torch.where(hit, float(poison.value), 0.0)[..., None]

    def real_rows(est):
        return est if n_rx == C else est[:C]

    def round_fn(state, key, P_t, P_is_t):
        P_t = torch.as_tensor(P_t, dtype=torch.float32)
        P_is_t = torch.as_tensor(P_is_t, dtype=torch.float32)
        theta = state["theta"]
        step = state["t"]
        theta_IS = tree_map(lambda x: x.expand(n_rx, *x.shape), theta)
        if partial:
            claimed = schedule.present(step, C, M)
            mult = claimed * _const(tx_base, step.device)
        else:
            claimed = None

        def train(th, opt_state, k):
            """The users' flat deltas, precoded, and their energies."""
            flat, opt_state = users_train(th, opt_state, k, step)
            if partial:
                flat = agg.cotaf_precode(flat, mult)
            return flat, opt_state, agg.user_energy(flat)

        trips = state["guard_trips"] if guard_on else None
        if cfg.mode == "conventional":
            k1, k2 = prng.split(key)
            flat, opt_state, pw = train(theta_IS, state["opt"], k1)
            est = conventional_ota(k2, maybe_poison(flat, step), topo,
                                   P_t, cfg.ota)
            if partial:
                est = est * agg.attendance_rescale(
                    _const(rx_w_conv, flat.device), claimed.reshape(-1))
            out = {**state, "opt": opt_state, "t": step + 1,
                   "power_edge": state["power_edge"]
                   + agg.symbol_power_from_energy(pw, P_t, N),
                   "n_edge_tx": state["n_edge_tx"] + 1.0}
            if guard_on:
                est, trip = guard_estimate(est, cfg.guard)
                out["guard_trips"] = trips + trip
            out["theta"] = apply_updates(theta, agg.unflatten(spec, est))
            if tele_on:
                out["telemetry"] = {
                    **cluster_telemetry(flat, est, claimed, topo, P_t,
                                        mode="conventional"),
                    **is_telemetry_zero(step.device)}
            return out

        # --- W-HFL ---
        keys = prng.split(key, cfg.I + 1)
        opt_state = state["opt"]
        p_edge = torch.zeros((), device=step.device)
        for i in range(cfg.I):
            k1, k2 = prng.split(keys[i])
            flat, opt_state, pw = train(theta_IS, opt_state, k1)
            est = cluster_fold(k2, maybe_poison(flat, step), claimed,
                               P_t)                          # [n_rx, 2N]
            if guard_on:
                est, trip = guard_estimate(est, cfg.guard)
                trips = trips + trip
            theta_IS = apply_updates(theta_IS, agg.unflatten(spec, est))
            p_edge = p_edge + agg.symbol_power_from_energy(pw, P_t, N)
            if tele_on and i == cfg.I - 1:   # the last iteration's block
                tele = cluster_telemetry(flat, real_rows(est), claimed,
                                         topo, P_t)

        is_deltas = agg.flatten(
            spec, tree_map(lambda a, b: a[:C] - b, theta_IS, theta))
        est = global_ota(keys[-1], is_deltas, topo, P_is_t, cfg.ota)
        out = {**state, "opt": opt_state, "t": step + 1,
               "power_edge": state["power_edge"] + p_edge,
               "n_edge_tx": state["n_edge_tx"] + float(cfg.I),
               "power_is": state["power_is"]
               + agg.symbol_power(is_deltas, P_is_t),
               "n_is_tx": state["n_is_tx"] + 1.0}
        if guard_on:
            est, trip = guard_estimate(est, cfg.guard)
            out["guard_trips"] = trips + trip
        out["theta"] = apply_updates(theta, agg.unflatten(spec, est))
        if tele_on:
            out["telemetry"] = {**tele,
                                **is_telemetry(is_deltas, topo, P_is_t)}
        return out

    return round_fn


def make_round_fn(loss_fn: Callable, opt: Optimizer, topo: Topology,
                  cfg: WHFLConfig, spec: agg.FlatSpec, X: torch.Tensor,
                  Y: torch.Tensor) -> Callable:
    """Build the single engine's per-round function ``round_fn(state,
    key, P_t, P_is_t) -> state`` (`make_round_body`): the C*M users
    train in C vmapped passes of M (`make_local_train`), and the cluster
    hop is `cluster_ota`.

    X [C, M, n, ...] and Y [C, M, n] are the users' shards on the run's
    device.  P_t and P_is_t enter as float32 scalars, as they enter the
    reference's jitted round.
    """
    C, M = topo.C, topo.M
    U = C * M
    Xu = X.reshape(U, *X.shape[2:])
    Yu = Y.reshape(U, *Y.shape[2:])
    local_train = make_local_train(loss_fn, opt, cfg, pass_width=M)

    def users_train(theta_IS, opt_state, key, step):
        keys = prng.split(key, U)
        th_u = tree_map(lambda x: x[:, None].expand(C, M, *x.shape[1:])
                        .reshape(U, *x.shape[1:]), theta_IS)
        st_u = tree_map(lambda x: x.reshape(U, *x.shape[2:]), opt_state)
        deltas, st_u = local_train(th_u, st_u, Xu, Yu, keys, step)
        flat = agg.flatten(spec, deltas).reshape(C, M, -1)
        return flat, tree_map(lambda x: x.reshape(C, M, *x.shape[1:]), st_u)

    def cluster_estimate(key, flat, P_t):
        return cluster_ota(key, flat, topo, P_t, cfg.ota)

    return make_round_body(topo, cfg, spec, users_train, cluster_estimate,
                           n_rx=C)


def eval_windows(T: int, eval_every: int) -> list:
    """Partition ``T`` rounds into the stepwise driver's eval windows:
    an eval follows round ``t`` whenever ``t % eval_every == 0 or
    t == T - 1``; the list holds the rounds between consecutive eval
    points (summing to T)."""
    e = max(1, int(eval_every))
    out, prev = [], -1
    for t in range(T):
        if t % e == 0 or t == T - 1:
            out.append(t - prev)
            prev = t
    return out


BATCH_MODES = ("vmap", "map")


def stack_seeds(trees):
    """Per-seed trees -> the seed-stacked carry: one tree of [S, ...]
    leaves."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def make_window_fn(round_fn: Callable,
                   eval_fn: Optional[Callable] = None,
                   batch: str = "map") -> Callable:
    """Lift the per-seed round into an eval window: ``window(states,
    keys, P_win, P_is_win) -> (states, keys, metrics)`` runs
    ``len(P_win)`` rounds of every seed, then ``eval_fn(state)`` on each
    seed's state (metrics: their [S, ...] stack, or None).

    The carry is seed-stacked in both modes: states is one tree of
    [S, ...] leaves (`stack_seeds`) and keys [S, 2].  Per round and seed
    the carried key splits into (next_key, sub) and `round_fn` takes sub
    with that round's powers.  P_win and P_is_win are float32 [w]
    tensors of the window's powers on the run's device.  The seeds run

    - ``batch="map"``: one after the other, each on its own copy of its
      slice of the carry (restacked at the window's end), so a seed's
      bits do not depend on the others;
    - ``batch="vmap"``: as one program, `round_fn` and `eval_fn` under
      `torch.func.vmap` over the seed axis.  Each op runs once for all
      seeds (the OTA kernels as one launch, `repro_torch.kernels.ops`),
      so a batched GEMM may round a seed's gradient otherwise than its
      map run does; its random draws are the same.

    Both drivers run this one loop: the stepwise driver calls it eagerly
    and the chunked driver replays it as a graph (`make_chunk_fn`).
    """
    if batch not in BATCH_MODES:
        raise ValueError(f"batch must be one of {BATCH_MODES}, got "
                         f"{batch!r}")
    if batch == "vmap":
        def seed_round(state, key, P_t, P_is_t):
            key, sub = prng.split(key)
            return round_fn(state, sub, P_t, P_is_t), key

        step = torch.func.vmap(seed_round, in_dims=(0, 0, None, None))
        evals = None if eval_fn is None else torch.func.vmap(eval_fn)

        def window(states, keys, P_win, P_is_win):
            for i in range(P_win.shape[0]):
                states, keys = step(states, keys, P_win[i], P_is_win[i])
            return states, keys, None if evals is None else evals(states)

        return window

    def window(states, keys, P_win, P_is_win):
        # fresh allocations, as a seed run alone holds its state: a view
        # into the stack may sit at an offset that changes a kernel's
        # vectorization, and with it a reduction's order
        S = keys.shape[0]
        per = [tree_map(lambda x: x[s].clone(), states) for s in range(S)]
        ks = [keys[s].clone() for s in range(S)]
        for i in range(P_win.shape[0]):
            for s in range(S):
                ks[s], sub = prng.split(ks[s])
                per[s] = round_fn(per[s], sub, P_win[i], P_is_win[i])
        metrics = (None if eval_fn is None
                   else torch.stack([eval_fn(st) for st in per]))
        return stack_seeds(per), torch.stack(ks), metrics

    return window


class _Segments:
    """The recorder `_ChunkFn` captures a window with: the window as the
    CUDA graphs of its collective-free segments, in order, one private
    memory pool for all, each graph but the last followed by the
    collective that ended it (`repro_torch.sharding.api.segmented`).  A
    collective is not issued while the window is captured: it gets a
    static output buffer, allocated on the `stream` the graphs replay
    on, which the graphs after it read; at a replay it runs between its
    two graphs and writes that buffer."""

    def __init__(self, pool, stream):
        self.pool = pool
        self.stream = stream
        self.segments = []           # [(graph, issue collective or None)]
        self.graph = None

    def begin(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool)

    def end(self) -> None:
        with warnings.catch_warnings():
            # two collectives back to back leave a segment without a
            # kernel, whose graph CUDA runs as a no-op
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            self.graph.capture_end()
        self.pool = self.graph.pool()
        self.segments.append((self.graph, None))

    def cut(self, issue, shape, dtype, device) -> torch.Tensor:
        self.end()
        with torch.cuda.stream(self.stream):
            out = torch.empty(shape, dtype=dtype, device=device)
        self.segments[-1] = (self.graph, lambda: out.copy_(issue()))
        self.begin()
        return out


# The launches of each kernel of ours that the chunked driver's graph
# replays made: every graph's kernel nodes, counted at its capture (the
# wrappers' launch counts while it was recorded: a wrapper called on the
# capturing stream records one kernel node where it would launch one),
# times its replays.  A replay runs no Python, so the wrappers' own
# counts cannot see it, and a device trace can lose a replay's records
# (`repro_torch.kernels.trace_probe`).
REPLAYED_LAUNCHES: Counter = Counter()


def _launch_counts() -> dict:
    from repro_torch.kernels import LAUNCH_COUNTERS

    return {name: getattr(fn, attr)
            for name, (fn, attr) in LAUNCH_COUNTERS.items()}


class _ChunkFn:
    """The chunked driver's unit (`make_chunk_fn`): an eval window
    (`make_window_fn`) on the device of the power values.

    On the CPU each call runs the window eagerly.  On CUDA each distinct
    window length is captured once as CUDA graphs (at most three
    lengths: 1, eval_every and the tail) and every later call replays
    them:

    - the seed-stacked carry (states and keys) lives in static buffers
      that the graphs read and, at the window's end, overwrite in place,
      so a call returns them as the carried state (pass them back
      unchanged);
    - the window's powers are copied into the graphs' float32 [w]
      buffers before each replay, so every round of every replay reads
      its own;
    - before the first capture of a length the window runs once eagerly
      on a side stream (its outputs dropped): that uploads every constant
      the wrappers and channels cache, builds the cuBLAS/cuDNN handles
      and plans and takes every host-side decision, so no host-to-device
      copy or host read is left for the capture.

    A window that makes no collective (one process, or ranks whose
    groups all hold one rank) is one graph.  On ranks a collective of
    the runner (`repro_torch.sharding`) cannot enter a capture (gloo's
    never can), so the window is captured as the graphs of the segments
    between its collectives (`_Segments`), and a replay runs each graph
    and then the collective that follows it, on the captured buffers.

    A replay runs no Python, so the kernel wrappers' launch counts see
    the eager run and the capture, not the replays: each replay adds its
    graphs' kernel nodes, counted at their capture, to
    `REPLAYED_LAUNCHES`.

    The graphs share one memory pool: they replay one after another on
    one stream, and each replay's metrics are copied out before the next.
    """

    def __init__(self, window: Callable):
        self.window = window
        self.graphs: Dict[int, tuple] = {}
        self.carry = None
        self.pool = None
        self.captures = 0          # windows captured (the run journal's)

    def __call__(self, states, keys, P_win, P_is_win):
        if P_win.device.type != "cuda":
            return self.window(states, keys, P_win, P_is_win)
        self._load([states, keys])
        w = int(P_win.shape[0])
        if w not in self.graphs:
            self._capture(w, P_win, P_is_win)
        segments, P, P_is, metrics, nodes = self.graphs[w]
        P.copy_(P_win)
        P_is.copy_(P_is_win)
        for graph, collective in segments:
            graph.replay()
            if collective is not None:
                collective()
        REPLAYED_LAUNCHES.update(nodes)
        states, keys = self.carry
        return states, keys, None if metrics is None else metrics.clone()

    def _load(self, carry) -> None:
        """Copy (states, keys) into the static buffers, unless they are
        the buffers."""
        if self.carry is None:
            self.carry = tree_map(torch.clone, carry)
            return
        for (_, dst), (_, src) in zip(tree_leaves(self.carry),
                                      tree_leaves(carry)):
            if dst is not src:
                dst.copy_(src)

    def _capture(self, w: int, P_win, P_is_win) -> None:
        from repro_torch.sharding.api import segmented

        states, keys = self.carry
        dev = P_win.device
        P = P_win.detach().clone()
        P_is = P_is_win.detach().clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.window(states, keys, P, P_is)
        torch.cuda.current_stream(dev).wait_stream(side)
        # as `torch.cuda.graph` does: the graphs' private pool cannot use
        # blocks the allocator keeps cached for other streams
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        rec = _Segments(self.pool, torch.cuda.current_stream(dev))
        before = _launch_counts()
        with torch.cuda.stream(side), segmented(rec):
            rec.begin()
            new_states, new_keys, metrics = self.window(states, keys, P,
                                                        P_is)
            for (_, dst), (_, src) in zip(tree_leaves(self.carry),
                                          tree_leaves([new_states,
                                                       new_keys])):
                if dst is not src:
                    dst.copy_(src)
            rec.end()
        torch.cuda.current_stream(dev).wait_stream(side)
        nodes = {name: n - before[name]
                 for name, n in _launch_counts().items() if n != before[name]}
        self.pool = rec.pool
        self.graphs[w] = (rec.segments, P, P_is, metrics, nodes)
        self.captures += 1


def make_chunk_fn(round_fn: Callable,
                  eval_fn: Optional[Callable] = None,
                  batch: str = "map") -> Callable:
    """The chunked driver's window executor: `make_window_fn`'s window,
    ``chunk_fn(states, keys, P_win, P_is_win) -> (states, keys,
    metrics)``, as one CUDA graph per window length on the card (on
    ranks, the graphs between the window's collectives; `_ChunkFn`;
    under ``batch="vmap"`` one graph for all seeds) and eagerly on the
    CPU.  It runs the stepwise driver's loop, so the two
    drivers agree bit for bit.
    """
    return _ChunkFn(make_window_fn(round_fn, eval_fn, batch))


class WHFLTrainer:
    """loss_fn(params, xb, yb, rng) -> scalar; data X/Y: [C, M, n, ...].

    A thin stateful wrapper over `make_round_fn`, the counterpart of the
    JAX package's `repro.core.whfl.WHFLTrainer`: it holds the round and
    the power schedule.  `round_fn` (built by `init_state`) is the round
    itself, for callers that drive it themselves (`repro_torch.sim`).
    Runs on the CUDA card unless `device` names another.
    """

    def __init__(self, loss_fn: Callable, local_opt: Optimizer,
                 topo: Topology, cfg: WHFLConfig, X, Y,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.opt = local_opt
        self.topo = topo
        self.cfg = cfg
        self.X = torch.as_tensor(X, device=self.device)
        self.Y = torch.as_tensor(Y, device=self.device)
        self.C, self.M = topo.C, topo.M
        self._spec = None
        self.round_fn: Optional[Callable] = None

    def init_state(self, params):
        spec = agg.make_flat_spec(params)
        if spec != self._spec:   # (re)build on first use or a new model
            self._spec = spec
            self.round_fn = make_round_fn(self.loss_fn, self.opt, self.topo,
                                          self.cfg, spec, self.X, self.Y)
        return init_round_state(
            params, self.opt, self.C, self.M,
            telemetry_C=self.C if self.cfg.telemetry else None,
            guard=self.cfg.guard != "off")

    def round(self, state, key):
        t = int(state["t"])
        P_t, P_is_t = (torch.tensor(p, dtype=torch.float32,
                                    device=self.device)
                       for p in power_schedule(
                           t, self.cfg.power_base, self.cfg.power_slope,
                           self.cfg.power_is_factor, self.cfg.power_low))
        return self.round_fn(state, key, P_t, P_is_t)

    def avg_edge_power(self, state) -> float:
        return float(state["power_edge"]) / max(float(state["n_edge_tx"]),
                                                1.0)

    def avg_is_power(self, state) -> float:
        return float(state["power_is"]) / max(float(state["n_is_tx"]), 1.0)


@torch.no_grad()
def accuracy(apply_fn, params, X: torch.Tensor, Y: torch.Tensor,
             batch: int = 2000) -> float:
    """Top-1 accuracy of `apply_fn(params, .)` over (X, Y), in batches of
    ``min(batch, n)``.  The last, short batch is padded with zero rows to
    the full batch and the padded rows are masked out, as the reference
    does: a batch-norm model then sees full batches only."""
    n = len(X)
    if n == 0:
        return 0.0
    batch = min(batch, n)
    correct = 0
    for i in range(0, n, batch):
        xb, yb = X[i:i + batch], Y[i:i + batch]
        m = xb.shape[0]
        if m < batch:
            xb = torch.cat([xb, xb.new_zeros((batch - m, *xb.shape[1:]))])
        logits = apply_fn(params, xb)[:m]
        correct += int((logits.argmax(-1) == yb).sum())
    return correct / n
