"""Federated client state and the per-round attendance schedule.

`ClientPool` wraps the partitioned datasets with per-client accounting.
`ParticipationSchedule` says which mobile users transmit in a global
round, and how: honestly, as free riders, or as byzantine users.  The
schedule is static configuration; its per-round ``[C, M]`` mask is a
pure function of the round index, drawn from the threefry2x32 counter
PRNG keyed on the schedule's seed with the counter (round, user).  So
the mask is the same on every engine, mesh and driver, and the same as
the JAX package's bit for bit.

The round index may be the round state's device int32 tensor: `present`
then computes the mask on that device with no host read, so a round
that takes it stays free of host syncs and can be captured in a CUDA
graph (each replay reads its own round index).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.prng import MASK32, _threefry2x32

_U24 = 2.0 ** -24


def counter_uniform(seed: int, t, n: int, device=None) -> torch.Tensor:
    """``n`` uniform [0, 1) float32 draws from the counter PRNG, keyed
    on ``seed`` with counter words ``(t, 0..n-1)``: 24 random bits each.

    ``t`` is an int (the draws land on `device`) or an integer tensor
    (on its device; `device` is ignored), e.g. the round state's int32
    round index."""
    k0 = int(seed) & MASK32
    k1 = ((int(seed) >> 32) & MASK32) ^ 0x3C6EF372
    if isinstance(t, torch.Tensor):
        device = t.device
        x0 = (t.to(torch.int64) & MASK32).reshape(1).expand(n)
    else:
        x0 = torch.full((n,), int(t) & MASK32, dtype=torch.int64,
                        device=device)
    x1 = torch.arange(n, dtype=torch.int64, device=device)
    b0, _ = _threefry2x32(k0, k1, x0, x1)
    return (b0 >> 8).to(torch.float32) * _U24


PARTICIPATION_KINDS = ("full", "bernoulli", "stragglers")


@dataclass(frozen=True)
class ParticipationSchedule:
    """Per-round MU attendance and behaviour flags (static config).

    kind:
      - ``"full"``: every MU transmits every round (the paper's
        assumption; with no flags set the round inserts no
        participation op at all).
      - ``"bernoulli"``: each MU transmits with probability `rate` each
        round; the draws come from `counter_uniform` keyed on `seed`
        with counter ``(round t, user c*M+m)``.
      - ``"stragglers"``: the leading ``ceil(straggler_frac * M)`` users
        of every cluster transmit only on rounds with
        ``t % straggler_every == 0``.

    Behaviour flags, placed at the tail of every cluster:
      - the last `n_byzantine` users are byzantine: when present they
        transmit ``-byzantine_scale * delta`` (sign flipping);
      - the `n_free_riders` users just before them transmit nothing but
        still claim attendance, so the receiver counts them.

    A sampled-out user never claimed the round, so the attendance
    rescale (`repro_torch.core.aggregation.attendance_rescale`) drops it
    from the normalization; byzantine users and free riders do claim,
    and only a robust fold (`WHFLConfig.cluster_agg`) defends against
    them.
    """

    kind: str = "full"
    rate: float = 1.0             # bernoulli attendance probability
    seed: int = 17                # counter-PRNG key (static)
    straggler_every: int = 4      # stragglers attend every k-th round
    straggler_frac: float = 0.25  # leading fraction of users straggling
    n_byzantine: int = 0          # per-cluster byzantine tail users
    byzantine_scale: float = 1.0  # byzantine transmit -scale * delta
    n_free_riders: int = 0        # per-cluster free riders (claim, tx 0)

    def __post_init__(self):
        if self.kind not in PARTICIPATION_KINDS:
            raise ValueError(
                f"unknown participation kind {self.kind!r}; known: "
                f"{', '.join(PARTICIPATION_KINDS)}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.straggler_every < 1:
            raise ValueError("straggler_every must be >= 1")
        if min(self.n_byzantine, self.n_free_riders) < 0:
            raise ValueError("flag counts must be >= 0")

    @property
    def is_full(self) -> bool:
        """True iff the schedule is the exact no-op: the round is then
        the one built before participation existed, op for op."""
        return (self.kind == "full" and self.n_byzantine == 0
                and self.n_free_riders == 0)

    # -- static flags --------------------------------------------------------

    def flags(self, C: int, M: int) -> Tuple[np.ndarray, np.ndarray]:
        """(byzantine, free_rider) float32 ``[C, M]`` indicator grids:
        byzantine users last in every cluster, free riders just before;
        the counts clamp to M."""
        byz = np.zeros((C, M), np.float32)
        free = np.zeros((C, M), np.float32)
        nb = min(self.n_byzantine, M)
        nf = min(self.n_free_riders, M - nb)
        if nb:
            byz[:, M - nb:] = 1.0
        if nf:
            free[:, M - nb - nf: M - nb] = 1.0
        return byz, free

    def tx_base(self, C: int, M: int) -> np.ndarray:
        """Static per-user transmit multiplier ``[C, M]``: honest users
        1, free riders 0, byzantine ``-byzantine_scale``.  A round's
        multiplier is ``present(t) * tx_base``."""
        byz, free = self.flags(C, M)
        return ((1.0 - byz - free)
                + byz * np.float32(-self.byzantine_scale)).astype(np.float32)

    def _straggler_rows(self, C: int, M: int) -> np.ndarray:
        """float32 ``[C, M]``: 0 for the stragglers, 1 for the rest."""
        keep = np.ones((C, M), np.float32)
        keep[:, :int(np.ceil(self.straggler_frac * M))] = 0.0
        return keep

    # -- the per-round mask --------------------------------------------------

    def present(self, t, C: int, M: int) -> torch.Tensor:
        """Attendance mask ``[C, M]`` float32 in {0, 1} for round ``t``.

        ``t`` is an int (the mask lands on the CPU) or an integer tensor,
        whose device the mask is computed on without reading `t` on the
        host."""
        device = (t.device if isinstance(t, torch.Tensor)
                  else torch.device("cpu"))
        if self.kind == "full":
            return torch.ones((C, M), device=device)
        if self.kind == "stragglers":
            # deferred: repro_torch.core imports this module
            from repro_torch.core.channel import _const
            keep = _const(self._straggler_rows(C, M), device)
            t = torch.as_tensor(t, dtype=torch.int32, device=device)
            on = (t % self.straggler_every) == 0
            return torch.where(on, torch.ones_like(keep), keep)
        u = counter_uniform(self.seed, t, C * M).reshape(C, M)
        return (u < float(np.float32(self.rate))).to(torch.float32)

    def history(self, T: int, C: int, M: int, device=None) -> np.ndarray:
        """Realized attendance ``[T, C, M]`` for rounds 0..T-1, each
        round's mask computed on `device` from a device round index,
        as a round computes it (e.g. for `ClientPool.mark_round`)."""
        ts = torch.arange(T, dtype=torch.int32, device=device)
        return np.stack([self.present(ts[t], C, M).cpu().numpy()
                         for t in range(T)])

    def attendance_fraction(self, t, C: int, M: int) -> torch.Tensor:
        """Scalar realized attendance fraction for round ``t``:
        ``mean(present(t))``, taken as the JAX package's mean is (the sum
        times the float32 reciprocal of the count)."""
        return (torch.sum(self.present(t, C, M))
                * float(np.float32(1.0 / (C * M))))


@dataclass
class ClientState:
    cluster: int
    index: int            # within-cluster index m
    n_samples: int
    rounds_participated: int = 0


@dataclass
class ClientPool:
    """C x M clients with stacked data arrays [C, M, n, ...] (numpy)."""
    X: np.ndarray
    Y: np.ndarray
    clients: List[ClientState] = field(default_factory=list)
    rounds_seen: int = 0              # rounds accounted via mark_round

    def __post_init__(self):
        if not self.clients:
            n = self.Y.shape[2]
            self.clients = [ClientState(c, m, n)
                            for c in range(self.C) for m in range(self.M)]

    @property
    def C(self) -> int:
        return self.X.shape[0]

    @property
    def M(self) -> int:
        return self.X.shape[1]

    def client(self, c: int, m: int) -> ClientState:
        return self.clients[c * self.M + m]

    def mark_round(self, mask: Optional[np.ndarray] = None):
        """Account one global round of attendance: every client with no
        `mask`, else those whose entry of the ``[C, M]`` mask (e.g. a row
        of `ParticipationSchedule.history`) is nonzero."""
        if mask is None:
            self.rounds_seen += 1
            for cl in self.clients:
                cl.rounds_participated += 1
            return
        m = np.asarray(mask)
        if m.shape != (self.C, self.M):
            raise ValueError(
                f"mask shape {m.shape} != (C, M) = {(self.C, self.M)}")
        self.rounds_seen += 1
        for cl in self.clients:
            cl.rounds_participated += int(m[cl.cluster, cl.index] != 0)

    def attendance_fractions(self) -> np.ndarray:
        """[C, M] float32 per-client realized attendance over the rounds
        accounted so far (1.0 everywhere before any round)."""
        out = np.ones((self.C, self.M), np.float32)
        if self.rounds_seen:
            for cl in self.clients:
                out[cl.cluster, cl.index] = (cl.rounds_participated
                                             / self.rounds_seen)
        return out

    def label_histogram(self, n_classes: int = 10) -> np.ndarray:
        """[C, M, n_classes] label counts (checks the i.i.d., non-i.i.d.
        and cluster-non-i.i.d. partitions)."""
        C, M, _ = self.Y.shape
        out = np.zeros((C, M, n_classes), np.int64)
        for c in range(C):
            for m in range(M):
                out[c, m] = np.bincount(self.Y[c, m].astype(np.int64),
                                        minlength=n_classes)[:n_classes]
        return out


def make_pool(partitioner: Callable, seed: int, X: np.ndarray, Y: np.ndarray,
              C: int, M: int, **kw) -> ClientPool:
    Xs, Ys = partitioner(seed, X, Y, C, M, **kw)
    return ClientPool(X=Xs, Y=Ys)
