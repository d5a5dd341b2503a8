"""Structured JSONL run journal for the port's sweep.

The port's copy of `repro.obs.trace`: one line per event, schema
``repro.obs.trace/v1``, the same `EVENTS`.  Every record carries
``event`` and ``t`` (seconds since the writer opened, from
`time.perf_counter`), plus event-specific fields:

- ``run_start`` -- schema tag, torch version, the backend
  (``cuda``/``cpu``), device count, UTC timestamp.  Always first.
- ``scenario_start`` -- scenario name, seeds, rounds, driver, engine.
- ``compile`` -- the chunked driver captured a CUDA graph since the
  last event (the port traces no program; a capture is its compile):
  ``n_traces`` is the run's captures so far, ``new`` how many are new.
- ``window`` -- one eval window issued: its last ``round``, ``rounds``
  in it, wall ``seconds``.  Both drivers issue windows without waiting
  for the card (one sync at the end of a scenario, or where a
  checkpoint, the guard or a fault needs the host's view), so every
  window carries ``enqueue_only: true``.
- ``telemetry`` -- per-eval scalar summary of the telemetry block
  (`repro_torch.obs.telemetry.summarize`).
- ``checkpoint`` -- one save of the sweep's carry (`repro_torch.ft.
  ckpt`), or a resume (``resumed: true``).
- ``guard`` -- the non-finite guard (`repro_torch.ft.guard`) tripped.
- ``fault`` -- an injected or recovered fault (`repro_torch.ft.faults`).
- ``scenario_end`` -- totals for the scenario.
- ``run_end`` -- always last (written by `TraceWriter.close`).

    python -m repro_torch.sim.sweep --device cpu --scenarios fig2_iid \\
        --quick --telemetry --trace run.jsonl
    python -m repro_torch.obs.trace run.jsonl

The second command validates a journal (exit 1 on any violation);
``--allow-truncated-tail`` tolerates exactly what a killed run leaves (a
torn last line, no ``run_end``, an unclosed scenario).  Each line is
flushed and fsynced before `emit` returns, so a hard kill loses none.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

SCHEMA_VERSION = "repro.obs.trace/v1"

EVENTS = ("run_start", "scenario_start", "compile", "window",
          "telemetry", "checkpoint", "guard", "fault", "scenario_end",
          "run_end")


class TraceWriter:
    """Append-only JSONL event writer, flushed and fsynced per event."""

    def __init__(self, path: str, device: Optional[str] = None):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "w")
        self._t0 = time.perf_counter()
        self._closed = False
        import torch  # deferred: the validator CLI must not pay this

        backend = "cuda" if (device is None or str(device).startswith(
            "cuda")) and torch.cuda.is_available() else "cpu"
        self.emit("run_start", schema=SCHEMA_VERSION,
                  torch_version=torch.__version__, backend=backend,
                  device_count=(torch.cuda.device_count()
                                if backend == "cuda" else 1),
                  timestamp=datetime.datetime.now(
                      datetime.timezone.utc).isoformat(timespec="seconds"))

    def emit(self, event: str, **fields) -> None:
        if event not in EVENTS:
            raise ValueError(f"unknown trace event {event!r}; known: "
                             f"{', '.join(EVENTS)}")
        if self._closed:
            raise ValueError(f"trace {self.path!r} is closed")
        rec = {"event": event,
               "t": round(time.perf_counter() - self._t0, 6), **fields}
        self._f.write(json.dumps(rec) + "\n")
        # durable before control returns: a later hard kill must not
        # lose the line
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._closed:
            return
        self.emit("run_end")
        self._closed = True
        self._f.close()

    def __enter__(self) -> "TraceWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def validate_trace(path: str, allow_truncated_tail: bool = False
                   ) -> Tuple[Dict[str, int], List[str]]:
    """Check a journal against the v1 schema: ``(event counts,
    errors)``, valid when the error list is empty.

    ``allow_truncated_tail`` tolerates what a killed run leaves: an
    invalid last line, a missing ``run_end`` and scenarios started but
    never ended.  Anything else (a torn interior line, an unknown event,
    a bad schema header) is still an error.
    """
    errors: List[str] = []
    events: List[Dict] = []
    lines: List[Tuple[int, str]] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if line:
                lines.append((i, line))
    for n, (i, line) in enumerate(lines):
        is_tail = n == len(lines) - 1
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            if not (allow_truncated_tail and is_tail):
                errors.append(f"line {i}: not valid JSON ({e.msg})")
            continue
        if not isinstance(rec, dict):
            errors.append(f"line {i}: not a JSON object")
            continue
        ev = rec.get("event")
        if ev not in EVENTS:
            errors.append(f"line {i}: unknown event {ev!r}")
        if not isinstance(rec.get("t"), (int, float)):
            errors.append(f"line {i}: missing/non-numeric 't'")
        events.append(rec)
    if not events:
        errors.append("empty trace (no events)")
        return {}, errors
    first = events[0]
    if first.get("event") != "run_start":
        errors.append(f"first event is {first.get('event')!r}, "
                      f"expected 'run_start'")
    elif first.get("schema") != SCHEMA_VERSION:
        errors.append(f"schema {first.get('schema')!r} != "
                      f"{SCHEMA_VERSION!r}")
    if events[-1].get("event") != "run_end" and not allow_truncated_tail:
        errors.append(f"last event is {events[-1].get('event')!r}, "
                      f"expected 'run_end' (truncated run?)")
    starts = [e.get("scenario") for e in events
              if e.get("event") == "scenario_start"]
    ends = [e.get("scenario") for e in events
            if e.get("event") == "scenario_end"]
    if (sorted(map(str, starts)) != sorted(map(str, ends))
            and not allow_truncated_tail):
        errors.append(f"unbalanced scenario_start/scenario_end: "
                      f"{starts} vs {ends}")
    for i, e in enumerate(events, 1):
        if e.get("event") == "window":
            for k in ("round", "rounds", "seconds"):
                if not isinstance(e.get(k), (int, float)):
                    errors.append(
                        f"event {i}: window missing numeric {k!r}")
    counts: Dict[str, int] = {}
    for e in events:
        ev = e.get("event")
        counts[ev] = counts.get(ev, 0) + 1
    return counts, errors


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Validate a repro.obs.trace JSONL run journal")
    ap.add_argument("trace", help="journal file written via --trace")
    ap.add_argument("--allow-truncated-tail", action="store_true",
                    help="post-crash audit: tolerate a torn last line, a "
                         "missing run_end and unclosed scenarios")
    args = ap.parse_args(argv)
    counts, errors = validate_trace(
        args.trace, allow_truncated_tail=args.allow_truncated_tail)
    if args.allow_truncated_tail:
        _, strict = validate_trace(args.trace)
        for e in strict:
            if e not in errors:
                print(" ~ tolerated:", e)
    for ev in EVENTS:
        if counts.get(ev):
            print(f"  {ev:16s} {counts[ev]}")
    if errors:
        print(f"INVALID ({len(errors)} schema violations):")
        for e in errors:
            print(" -", e)
        return 1
    print(f"valid {SCHEMA_VERSION} journal "
          f"({sum(counts.values())} events)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
