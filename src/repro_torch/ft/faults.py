"""Deterministic fault injection for the port's sweep.

The port's copy of `repro.ft.faults`.  A `FaultPlan` says what breaks,
and when:

- ``crash_round=k`` -- exit the process at once (`os._exit`, no
  cleanup: the nearest in-process stand-in for a kill or a preemption)
  once round ``k`` has run on the device.  The stepwise driver stops at
  round ``k`` exactly; the chunked driver at the end of the first eval
  window that reaches ``k`` (it does not see rounds inside a window).
- ``crash_window=w`` -- the same, after the ``w``-th eval window
  (1-based).
- ``save_errors=n`` -- the first ``n`` checkpoint saves raise a
  transient `OSError`; `repro_torch.ft.ckpt.CheckpointManager` retries
  after `backoff_delay`, whose jitter comes from the counter PRNG.
- ``poison=MODE@T:C:M`` -- user (C, M)'s transmitted flat delta is made
  NaN (``nan``) or +Inf (``inf``) at round ``T``, for the non-finite
  guard (`repro_torch.ft.guard`) to catch.  The round selects it on the
  device from its round index, so a CUDA graph replays it.

Every fault fires at the same round, window and attempt on both engines,
both drivers and every mesh.  Crashes exit with `CRASH_EXIT_CODE`.

``--inject`` on ``repro_torch.sim.sweep`` takes comma-separated
``key=value`` pairs, e.g. ``crash_round=5,save_errors=2`` or
``poison=nan@4:0:1``.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np

POISON_MODES = ("nan", "inf")

# injected crashes exit with this code, told apart from real failures
CRASH_EXIT_CODE = 173


@dataclass(frozen=True)
class GradPoison:
    """Poison user (c, m)'s transmitted flat delta at round t."""
    t: int
    c: int
    m: int
    mode: str = "nan"

    def __post_init__(self):
        if self.mode not in POISON_MODES:
            raise ValueError(f"unknown poison mode {self.mode!r}; "
                             f"known: {', '.join(POISON_MODES)}")
        if min(self.t, self.c, self.m) < 0:
            raise ValueError(f"poison indices must be >= 0, got "
                             f"t={self.t} c={self.c} m={self.m}")

    @property
    def value(self) -> np.float32:
        return np.float32(np.nan if self.mode == "nan" else np.inf)


@dataclass(frozen=True)
class FaultPlan:
    crash_round: Optional[int] = None
    crash_window: Optional[int] = None
    save_errors: int = 0
    poison: Optional[GradPoison] = None

    def __post_init__(self):
        if self.save_errors < 0:
            raise ValueError("save_errors must be >= 0")
        for k in ("crash_round", "crash_window"):
            v = getattr(self, k)
            if v is not None and v < 1:
                raise ValueError(f"{k} must be >= 1 (1-based), got {v}")

    @property
    def is_empty(self) -> bool:
        return (self.crash_round is None and self.crash_window is None
                and self.save_errors == 0 and self.poison is None)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse an ``--inject`` spec, e.g.
        ``"crash_round=5,save_errors=2,poison=nan@4:0:1"``."""
        kw: dict = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad --inject entry {part!r} "
                                 f"(expected key=value)")
            k, v = part.split("=", 1)
            k = k.strip()
            if k in ("crash_round", "crash_window", "save_errors"):
                kw[k] = int(v)
            elif k == "poison":
                if "@" not in v:
                    raise ValueError(
                        f"bad poison spec {v!r} (expected MODE@T:C:M)")
                mode, at = v.split("@", 1)
                idx = at.split(":")
                if len(idx) != 3:
                    raise ValueError(
                        f"bad poison spec {v!r} (expected MODE@T:C:M)")
                kw["poison"] = GradPoison(t=int(idx[0]), c=int(idx[1]),
                                          m=int(idx[2]),
                                          mode=mode.strip())
            else:
                raise ValueError(
                    f"unknown --inject key {k!r}; known: crash_round, "
                    f"crash_window, save_errors, poison")
        return cls(**kw)


def hard_crash(reason: str) -> None:
    """Stand in for a preemption: exit at once, skipping every Python
    cleanup (atexit, finally, buffered writes); what survives is what
    was already fsynced."""
    print(f"[repro_torch.ft] injected crash: {reason}", file=sys.stderr)
    sys.stderr.flush()
    os._exit(CRASH_EXIT_CODE)


def backoff_delay(attempt: int, base: float, seed: int = 0) -> float:
    """Exponential backoff with deterministic jitter for save retries:
    ``base * 2**attempt * (1 + u)``, ``u`` in [0, 1) from the counter
    PRNG keyed on ``(seed, attempt)``, so retry timing reproduces too."""
    from repro_torch.fed.clients import counter_uniform
    u = float(counter_uniform(seed, attempt, 1, device="cpu")[0])
    return base * (2.0 ** attempt) * (1.0 + u)
