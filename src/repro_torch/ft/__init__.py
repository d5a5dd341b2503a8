"""`repro_torch.ft` -- fault tolerance for the port's sweep.

- `repro_torch.ft.ckpt` -- checkpoint and resume: the whole sweep carry
  saved atomically at eval-window boundaries behind a versioned
  manifest (``--checkpoint DIR --ckpt-every W --resume``); a killed and
  resumed run equals the uninterrupted one bit for bit, on both engines
  and drivers and across meshes.
- `repro_torch.ft.faults` -- deterministic fault injection (a crash at a
  round or window, transient IO errors on save, a NaN or Inf in one
  user's transmitted delta; ``--inject``).
- `repro_torch.ft.guard` -- the non-finite guard over the OTA hops'
  estimates (``--guard halt|skip_round|zero_fill``); ``off`` adds no op.
"""
from repro_torch.ft.ckpt import SCHEMA_VERSION as CKPT_SCHEMA_VERSION
from repro_torch.ft.ckpt import (CheckpointManager, check_manifest, git_sha,
                                 scenario_fingerprint)
from repro_torch.ft.faults import (CRASH_EXIT_CODE, FaultPlan, GradPoison,
                                   backoff_delay, hard_crash)
from repro_torch.ft.guard import GUARD_POLICIES, guard_estimate, validate_guard

__all__ = ["CKPT_SCHEMA_VERSION", "CRASH_EXIT_CODE", "CheckpointManager",
           "FaultPlan", "GUARD_POLICIES", "GradPoison", "backoff_delay",
           "check_manifest", "git_sha", "guard_estimate", "hard_crash",
           "scenario_fingerprint", "validate_guard"]
