"""`repro_torch.obs` -- observability for the port's sweep.

- `repro_torch.obs.telemetry` -- the in-program round diagnostics
  (per-cluster receive SNR and noise floor, the OTA hop's update-norm
  ratio, attendance, per-tier symbol energy), computed inside the round
  body every engine runs (`repro_torch.core.whfl.make_round_body`) from
  values the round already holds.  ``WHFLConfig.telemetry=False`` (the
  default) is a Python-level gate: the round then runs not one op more.
- `repro_torch.obs.trace` -- the sweep's JSONL run journal (schema
  ``repro.obs.trace/v1``); ``python -m repro_torch.obs.trace FILE``
  validates one.
- `repro_torch.obs.diff` -- two JSON documents compared path by path,
  by ULP distance or within ``--rtol``/``--atol``: the latter is how a
  port document is judged against a JAX one.

Submodules are imported explicitly (``from repro_torch.obs import
diff``); the package re-exports nothing, so the numpy-only `diff` CLI
never imports torch.
"""
