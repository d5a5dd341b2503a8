"""In-program non-finite guard over the OTA hops' estimates.

A deep fade, a byzantine transmit scale or an injected fault
(`repro_torch.ft.faults.GradPoison`) can drive the matched-filter fold
to NaN or Inf, and one such estimate spoils every model it is applied
to.  `guard_estimate` inspects each hop's estimate before it is applied
and applies a policy:

- ``"off"`` -- no guard.  A Python-level gate in the round body: the
  round runs not one op more.
- ``"zero_fill"`` -- the estimate's non-finite entries are zeroed; the
  finite ones pass unchanged.
- ``"skip_round"`` -- any non-finite entry zeroes the whole estimate:
  the receiving model takes no update from that hop.
- ``"halt"`` -- in the round, ``"skip_round"``; the sweep also stops the
  scenario at the next eval boundary it reads the trips at.

Selection is by `torch.where`, so on a finite estimate every policy
returns the input's bits, and a guarded run without faults equals the
unguarded one bit for bit.  Each call also returns its trip (int32, 0
or 1), summed into ``state["guard_trips"]``.
"""
from __future__ import annotations

import torch

GUARD_POLICIES = ("off", "halt", "skip_round", "zero_fill")


def validate_guard(policy: str) -> None:
    if policy not in GUARD_POLICIES:
        raise ValueError(f"unknown guard policy {policy!r}; known: "
                         f"{', '.join(GUARD_POLICIES)}")


def guard_estimate(est: torch.Tensor, policy: str):
    """``(guarded est, trip)`` for an estimate of any shape; trip is an
    int32 scalar, 1 iff an entry was non-finite.  Not for ``"off"``:
    the caller leaves the guard out altogether."""
    validate_guard(policy)
    if policy == "off":
        raise ValueError("guard_estimate with policy='off': the caller "
                         "must leave the guard out when it builds the "
                         "round")
    finite = torch.isfinite(est)
    trip = torch.logical_not(torch.all(finite))
    zero = torch.zeros_like(est)
    if policy == "zero_fill":
        out = torch.where(finite, est, zero)
    else:   # halt / skip_round: drop the whole estimate
        out = torch.where(trip, zero, est)
    return out, trip.to(torch.int32)
