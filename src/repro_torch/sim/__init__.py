"""Scenario sweeps: the registry of paper scenarios and `SweepRunner`.

    python -m repro_torch.sim.sweep --scenarios fig2_iid --seeds 2
"""
from repro_torch.sim.scenario import (FIG2_FAMILIES, SCENARIOS, Scenario,
                                      get_scenario, list_scenarios,
                                      register_scenario)

_SWEEP_EXPORTS = ("SweepRunner", "SweepResult", "sweep_to_json",
                  "csv_lines", "bench_doc", "SCHEMA_VERSION")

__all__ = [
    "Scenario", "SCENARIOS", "FIG2_FAMILIES", "get_scenario",
    "list_scenarios", "register_scenario", *_SWEEP_EXPORTS,
]


def __getattr__(name):
    # sweep is imported lazily so `python -m repro_torch.sim.sweep` does
    # not re-execute the module it was launched from (runpy double-import)
    if name in _SWEEP_EXPORTS:
        from repro_torch.sim import sweep
        return getattr(sweep, name)
    raise AttributeError(f"module 'repro_torch.sim' has no attribute "
                         f"{name!r}")
