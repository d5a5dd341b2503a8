"""The participation scenarios end to end: the port's sweep against the
JAX package's.

Against JAX: each of the seven `PARTICIPATION_FAMILIES` scenarios in its
`.quick()` variant (C 2, M 2) and with M = 5 (so the median sees odd
claimed counts), cut to 4 rounds, 2 seeds, through both packages (the
JAX one with ``batch="map"``); `fig2_drop50` and `fig2_byzantine1` on the
faithful channel through `fused` and `slab_kernel` (the kernels' plain
versions here) and in conventional mode.  Bounds, as in
tests/test_torch_slice.py: loss, edge and IS power within rtol 1e-5,
accuracy within 1/n_test, the final model within 1e-4 of max |theta|.
The masks are the reference's bit for bit (tests/test_torch_clients.py);
the rest differs by summation order only (measured below 2e-6 of max
|theta|).

The port's engines and drivers against each other are held in
tests/test_torch_participation.py.
"""
import numpy as np
import pytest
import torch

from repro.sim.scenario import SCENARIOS as J_SCENARIOS
from repro.sim.sweep import SweepRunner as JSweepRunner
from repro_torch.sim import sweep
from repro_torch.sim.scenario import PARTICIPATION_FAMILIES, get_scenario

torch.set_num_threads(1)

RTOL = 1e-5
THETA_RTOL = 1e-4
ROUNDS = 4

CUTS = {
    "quick": {},
    "M5": dict(M=5),
    "fused": dict(ota_mode="faithful", ota_backend="fused"),
    "slab_kernel": dict(ota_mode="faithful", ota_backend="slab_kernel"),
    "conventional": dict(mode="conventional"),
}
CASES = ([(name, "quick") for name in PARTICIPATION_FAMILIES]
         + [(name, "M5") for name in PARTICIPATION_FAMILIES]
         + [(name, cut) for name in ("fig2_drop50", "fig2_byzantine1")
            for cut in ("fused", "slab_kernel", "conventional")])


def _cut(sc, cut):
    return sc.quick().replace(total_IT=ROUNDS, **CUTS[cut])


@pytest.mark.parametrize("name,cut", CASES)
def test_scenario_matches_reference(name, cut):
    ref = JSweepRunner([_cut(J_SCENARIOS[name], cut)], seeds=2,
                       batch="map", keep_state=True).run()[0]
    got = sweep.SweepRunner([_cut(get_scenario(name), cut)], seeds=2,
                            keep_state=True, batch="map",
                            device="cpu").run()[0]
    assert got.scenario.to_json() == ref.scenario.to_json()
    assert got.rounds == ref.rounds and got.seeds == ref.seeds
    np.testing.assert_allclose(got.acc, ref.acc, rtol=0,
                               atol=1.0 / ref.scenario.n_test)
    for key in ("loss", "edge_power", "is_power"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   rtol=RTOL, err_msg=key)
    for leaf in ("w", "b"):
        want = np.asarray(ref.final_state["theta"][leaf])
        have = got.final_state["theta"][leaf].numpy()
        assert have.shape == want.shape
        assert np.abs(have - want).max() <= THETA_RTOL * np.abs(want).max()
    np.testing.assert_allclose(got.final_state["power_edge"].numpy(),
                               np.asarray(ref.final_state["power_edge"]),
                               rtol=RTOL)
