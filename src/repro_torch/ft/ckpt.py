"""Sweep checkpoints behind a versioned resume manifest.

The port's copy of `repro.ft.ckpt`.  `CheckpointManager` wraps the
atomic npz store (`repro_torch.checkpoint.store`) with what a resumable
sweep needs:

- the **payload** is the whole sweep carry: the per-seed round states
  stacked over seeds (model, optimizer moments, power accumulators, the
  round index ``t`` that keys the counter PRNG and the power schedule,
  and the telemetry and guard blocks where the run has them) and the
  carried PRNG keys, saved at eval-window boundaries as
  ``round_<cursor>.npz``;
- the **manifest** (schema ``repro.ft.ckpt/v1``, the npz's JSON
  metadata) records the scenario's fingerprint, the seeds, the round
  cursor, the git commit, the torch version, the engine, mesh and
  driver, and the host's eval accumulators (rounds, metric and
  telemetry trajectories): floats round-trip exactly through JSON, so a
  resumed record is the uninterrupted one bit for bit;
- a save retries transient IO errors after `backoff_delay`, and
  `FaultPlan.save_errors` injects such errors.

`check_manifest` refuses a checkpoint of another scenario config, seed
list or round count; the engine, mesh and driver may all differ (the
port's invariances -- sharded equals single, chunked equals stepwise --
make a checkpoint cut on one resumable on another).
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import time
import warnings
from typing import Callable, Dict, Optional, Tuple

from repro_torch.checkpoint import store
from repro_torch.ft.faults import FaultPlan, backoff_delay

SCHEMA_VERSION = "repro.ft.ckpt/v1"

# checkpoint file names: round_<cursor>.npz (cursor = rounds completed)
PREFIX = "round_"

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def scenario_fingerprint(scenario_json: Dict) -> str:
    """Content hash of a scenario's JSON document: two configs resume
    each other iff their fingerprints match.  `Scenario.to_json` is the
    JAX package's document, so a scenario's fingerprint is the JAX
    package's too."""
    blob = json.dumps(scenario_json, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def git_sha() -> Optional[str]:
    """The checkout's commit, or None where the checkout has no
    ``.git`` (an unpacked `git archive`) or git cannot say."""
    if not os.path.exists(os.path.join(_ROOT, ".git")):
        return None
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=_ROOT,
                             capture_output=True, text=True, timeout=10)
        return out.stdout.strip() if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def check_manifest(man: Dict, fingerprint: str, seeds, rounds_total: int,
                   torch_version: Optional[str] = None) -> None:
    """Refuse a checkpoint that cannot give a bitwise resume: another
    schema, scenario fingerprint, seed list or total round count.  A
    torch version change only warns: it may still be bit for bit, and
    `repro_torch.obs.diff` is what judges."""
    if man.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"checkpoint manifest schema "
                         f"{man.get('schema')!r} != {SCHEMA_VERSION!r}")
    if man.get("fingerprint") != fingerprint:
        raise ValueError(
            f"checkpoint is for a different scenario config "
            f"(fingerprint {man.get('fingerprint')} != {fingerprint})")
    if list(man.get("seeds", [])) != list(seeds):
        raise ValueError(f"checkpoint seed batch {man.get('seeds')} != "
                         f"requested {list(seeds)}")
    if man.get("rounds_total") != rounds_total:
        raise ValueError(
            f"checkpoint was cut for {man.get('rounds_total')} total "
            f"rounds, this run wants {rounds_total}")
    if torch_version and man.get("torch_version") != torch_version:
        warnings.warn(
            f"resuming a checkpoint written under torch "
            f"{man.get('torch_version')} with torch {torch_version}; "
            f"bitwise parity is judged by repro_torch.obs.diff, not "
            f"promised here")


class CheckpointManager:
    """Save and load the sweep carry of ONE scenario under `dirpath`.

    emit: an optional ``emit(event, **fields)`` journal callback for
    ``checkpoint`` saves and ``fault`` retries; `faults` injects its
    `save_errors`; `sleep` can be replaced in tests.
    """

    def __init__(self, dirpath: str, keep: int = 3, retries: int = 3,
                 retry_base: float = 0.05, retry_seed: int = 0,
                 faults: Optional[FaultPlan] = None,
                 emit: Optional[Callable] = None,
                 sleep: Callable = time.sleep):
        self.dirpath = dirpath
        self.keep = keep
        self.retries = retries
        self.retry_base = retry_base
        self.retry_seed = retry_seed
        self.emit = emit
        self.sleep = sleep
        self._inject_left = faults.save_errors if faults else 0
        self.saves = 0
        self.io_retries = 0
        self.save_seconds = 0.0
        self.load_seconds = 0.0

    def _emit(self, event: str, **fields) -> None:
        if self.emit is not None:
            self.emit(event, **fields)

    def save(self, cursor: int, payload, manifest: Dict) -> str:
        """Atomic save of (payload tree, manifest) as
        ``round_<cursor>.npz``, retrying transient IO errors."""
        t0 = time.perf_counter()
        attempt = 0
        while True:
            try:
                if self._inject_left > 0:
                    self._inject_left -= 1
                    raise OSError("injected transient IO error "
                                  "(FaultPlan.save_errors)")
                path = store.save_step(
                    self.dirpath, cursor, payload, keep=self.keep,
                    prefix=PREFIX,
                    meta={"schema": SCHEMA_VERSION, **manifest})
                break
            except OSError as e:
                attempt += 1
                if attempt > self.retries:
                    raise
                delay = backoff_delay(attempt - 1, self.retry_base,
                                      self.retry_seed)
                self.io_retries += 1
                self._emit("fault", kind="ckpt_io_error", round=cursor,
                           attempt=attempt, error=str(e),
                           backoff_seconds=round(delay, 6))
                self.sleep(delay)
        dt = time.perf_counter() - t0
        self.saves += 1
        self.save_seconds += dt
        self._emit("checkpoint", round=cursor, path=path,
                   seconds=round(dt, 6), attempts=attempt + 1)
        return path

    def load_latest(self, template, check: Optional[Callable] = None
                    ) -> Optional[Tuple[dict, Dict]]:
        """``(payload, manifest)`` of the newest checkpoint, held to
        `template`'s structure, dtypes and shapes; None when the
        directory holds none (a fresh start).  `check(manifest)` runs
        before the payload is read, so a wrong seed list or scenario
        fails with its own message."""
        path = store.latest(self.dirpath, prefix=PREFIX)
        if path is None:
            return None
        t0 = time.perf_counter()
        manifest = store.read_meta(path).get("extra", {})
        if manifest.get("schema") != SCHEMA_VERSION:
            raise ValueError(
                f"{path!r} is not a {SCHEMA_VERSION} checkpoint "
                f"(schema {manifest.get('schema')!r})")
        if check is not None:
            check(manifest)
        payload = store.load(path, template)
        self.load_seconds += time.perf_counter() - t0
        return payload, manifest
