"""The port's W-HFL sweep, end to end, against the JAX package.

`fig2_iid` (equivalent backend) and `scale_u256` (fused backend) run in
their `.quick()` variants for 2 seeds through both packages, the JAX
one with ``batch="map"`` (seeds run one by one, as the port runs them).
Tolerances, and why:

- round 1: loss, edge power and IS power within rtol 1e-5, accuracy
  within 1/n_test.  Both runs start from the same weights (normals
  within 4 ULP) and draw the same minibatches and channels; only float
  summation order differs, which measures below 4e-7.
- every later eval: the same bounds.  Over 8 rounds the gaps stay below
  4e-7 relative, because nothing in these rounds amplifies a ULP.
- final model: within rtol 1e-4 of the largest parameter magnitude.  An
  elementwise rtol would fail on weights that cancel to near zero
  (their relative gap reaches 4e-3 while the absolute one is ~1e-7).
"""
import ast
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core.aggregation import flatten as j_flatten
from repro.core.aggregation import make_flat_spec as j_make_flat_spec
from repro.core.whfl import accuracy as j_accuracy
from repro.core.whfl import eval_windows as j_eval_windows
from repro.core.whfl import init_round_state as j_init_round_state
from repro.core.whfl import make_round_fn as j_make_round_fn
from repro.data import PARTITIONERS as J_PARTITIONERS
from repro.data import synthetic_cifar as j_synthetic_cifar
from repro.data import synthetic_mnist as j_synthetic_mnist
from repro.nn.core import split_params
from repro.optim import adam as j_adam
from repro.optim import sgd as j_sgd
from repro.sim.scenario import SCENARIOS as J_SCENARIOS
from repro.sim.sweep import SweepRunner as JSweepRunner
from repro_torch import convert, prng
from repro_torch.core import aggregation as agg
from repro_torch.core.whfl import (accuracy, eval_windows, init_round_state,
                                   make_round_fn)
from repro_torch.data import PARTITIONERS, synthetic_cifar, synthetic_mnist
from repro_torch.optim import adam
from repro_torch.sim import sweep
from repro_torch.sim.scenario import SCENARIOS, get_scenario

# one intra-op thread: test workers run side by side, and torch's
# default of one thread per core oversubscribes the CPU many times
torch.set_num_threads(1)

RTOL = 1e-5
THETA_RTOL = 1e-4
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture(scope="module", params=["fig2_iid", "scale_u256"])
def both_runs(request):
    name = request.param
    ref = JSweepRunner([name], seeds=2, quick=True, batch="map",
                       keep_state=True).run()[0]
    got = sweep.SweepRunner([name], seeds=2, quick=True, keep_state=True,
                            device="cpu").run()[0]
    return ref, got


def test_trajectories_match_reference(both_runs):
    ref, got = both_runs
    n_test = ref.scenario.n_test
    assert got.rounds == ref.rounds and got.seeds == ref.seeds
    np.testing.assert_allclose(got.acc, ref.acc, rtol=0, atol=1.0 / n_test)
    for key in ("loss", "edge_power", "is_power"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   rtol=RTOL, err_msg=key)


def test_final_model_and_state_match_reference(both_runs):
    ref, got = both_runs
    for leaf in ("w", "b"):
        want = np.asarray(ref.final_state["theta"][leaf])
        have = got.final_state["theta"][leaf].numpy()
        assert have.shape == want.shape
        assert np.abs(have - want).max() <= THETA_RTOL * np.abs(want).max()
    assert got.final_state["t"].tolist() == np.asarray(
        ref.final_state["t"]).tolist()
    np.testing.assert_allclose(got.final_state["power_edge"].numpy(),
                               np.asarray(ref.final_state["power_edge"]),
                               rtol=RTOL)


def test_round_one_matches_reference():
    """One fig2_iid quick round from identical weights (the reference's,
    moved over with `convert`): the parameters, the Adam state and the
    power accumulators after the round."""
    sc = get_scenario("fig2_iid").quick()
    jsc = J_SCENARIOS["fig2_iid"].quick()
    X, Y, _, _ = jsc.make_data()
    topo = jsc.make_topology()
    init_fn, _, loss_fn = jsc.task_fns()
    params = split_params(init_fn(jax.random.PRNGKey(0)))[0]
    spec = j_make_flat_spec(params)
    opt = j_adam(jsc.lr)
    state = j_init_round_state(params, opt, topo.C, topo.M)
    key = jax.random.split(jax.random.PRNGKey(1))[1]
    ref = jax.jit(j_make_round_fn(loss_fn, opt, topo, jsc.whfl_config(),
                                  spec, X, Y))(state, key, 0.5, 10.0)

    t_params = convert.params_from_jax(jax.device_get(params))
    t_state = init_round_state(t_params, adam(sc.lr), topo.C, topo.M)
    round_fn = make_round_fn(sc.task_fns()[2], adam(sc.lr),
                             sc.make_topology(), sc.whfl_config(),
                             agg.make_flat_spec(t_params),
                             torch.as_tensor(X), torch.as_tensor(Y))
    got = round_fn(t_state, prng.split(prng.PRNGKey(1))[1], 0.5, 10.0)

    want = np.asarray(j_flatten(spec, ref["theta"]))
    have = agg.flatten(agg.make_flat_spec(t_params), got["theta"]).numpy()
    assert np.abs(have - want).max() <= RTOL * np.abs(want).max()
    for m in ("m", "v"):
        for leaf in ("w", "b"):
            w_ = np.asarray(ref["opt"][m][leaf])
            h_ = got["opt"][m][leaf].numpy()
            assert h_.shape == w_.shape == (topo.C, topo.M) + w_.shape[2:]
            assert np.abs(h_ - w_).max() <= RTOL * np.abs(w_).max()
    for k in ("power_edge", "power_is", "n_edge_tx", "n_is_tx"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL)
    assert int(got["t"]) == int(ref["t"]) == 1


def test_data_partition_and_topology_byte_equal():
    for ref, got in ((j_synthetic_mnist(3, n_train=300, n_test=50),
                      synthetic_mnist(3, n_train=300, n_test=50)),
                     (j_synthetic_cifar(1, n_train=40, n_test=10),
                      synthetic_cifar(1, n_train=40, n_test=10))):
        for (xr, yr), (xg, yg) in zip(ref, got):
            assert xr.tobytes() == xg.tobytes()
            assert yr.tobytes() == yg.tobytes()
    xtr, ytr = synthetic_mnist(0, n_train=300, n_test=10)[0]
    for name, part in PARTITIONERS.items():
        for a, b in zip(J_PARTITIONERS[name](4, xtr, ytr, 2, 3),
                        part(4, xtr, ytr, 2, 3)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for name in ("fig2_iid", "scale_u256"):
        jt = J_SCENARIOS[name].make_topology()
        tt = SCENARIOS[name].make_topology()
        for f in ("d_mu_is", "d_is_ps", "d_mu_ps", "beta_bar_c", "beta_is"):
            assert getattr(jt, f).tobytes() == getattr(tt, f).tobytes()


def test_registry_matches_reference():
    assert set(SCENARIOS) == set(J_SCENARIOS)
    for name, sc in SCENARIOS.items():
        assert sc.to_json() == J_SCENARIOS[name].to_json()
        assert sc.quick().to_json() == J_SCENARIOS[name].quick().to_json()
    assert sweep.RECORD_KEYS == ("scenario", "seeds", "rounds", "metrics",
                                 "final", "n_traces", "seconds", "exec",
                                 "telemetry")


@pytest.mark.parametrize("name", ["fig3_cifar", "fig2_drop10",
                                  "fig2_byzantine1_median"])
def test_unported_scenarios_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sweep.SweepRunner([name], quick=True, device="cpu").run()


def test_params_and_state_round_trip():
    params = split_params(
        J_SCENARIOS["fig2_iid"].task_fns()[0](jax.random.PRNGKey(2)))[0]
    params = jax.device_get(params)
    back = convert.to_numpy(convert.params_from_jax(params))
    for k in params:
        assert back[k].dtype == params[k].dtype
        assert back[k].tobytes() == params[k].tobytes()
    # the port's init draws the reference's weights (normals within 4 ULP)
    mine = convert.to_numpy(
        SCENARIOS["fig2_iid"].task_fns()[0](prng.PRNGKey(2)))
    np.testing.assert_allclose(mine["w"], params["w"], rtol=4 * 2 ** -23,
                               atol=0)
    state = jax.device_get(j_init_round_state(params, j_adam(0.1), 2, 3))
    t_state = convert.state_from_jax(state)
    assert t_state["t"].dtype == torch.int32
    assert t_state["opt"]["m"]["w"].shape == (2, 3, 784, 10)
    sgd_state = jax.device_get(
        j_init_round_state(params, j_sgd(0.1), 2, 3))
    assert convert.state_from_jax(sgd_state)["opt"] == {}


def test_cli_writes_reference_schema(tmp_path):
    out = tmp_path / "sweep.json"
    bench = tmp_path / "bench.json"
    doc = sweep.main(["--scenarios", "scale_u256", "--quick", "--seeds", "1",
                      "--device", "cpu", "--out", str(out),
                      "--bench-out", str(bench)])
    assert doc["schema"] == "repro.sim.sweep/v1"
    rec = doc["scenarios"][0]
    assert tuple(rec) == sweep.RECORD_KEYS
    assert rec["exec"]["batch"] == "map" and rec["exec"]["device"] == "cpu"
    assert out.exists() and bench.exists()
    assert sweep.main(["--list"]) == {}


def test_runner_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.SweepRunner(["fig2_iid"])
    with pytest.raises(SystemExit):
        sweep.main(["--scenarios", "fig2_iid", "--quick"])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    root = os.path.join(SRC, "repro_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root)
             for f in fs if f.endswith(".py")]
    repo = os.path.dirname(SRC)
    files.append(os.path.join(repo, "chip_smoke.py"))
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.convert, repro_torch.kernels.build
        import repro_torch.sim.sweep as s
        s.SweepRunner(["scale_u256"], quick=True, device="cpu")
        print("ok", sorted(m for m, v in sys.modules.items() if v is not None
                           and m.split(".")[0] in ("jax", "repro")))
    """)
    out = subprocess.run([sys.executable, "-c", script],
                         env={**os.environ, "PYTHONPATH": SRC},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok []")


@pytest.mark.parametrize("T,every", [(1, 1), (8, 2), (7, 3), (5, 10)])
def test_eval_windows_match_reference(T, every):
    assert eval_windows(T, every) == j_eval_windows(T, every)


def test_accuracy_matches_reference():
    sc = J_SCENARIOS["fig2_iid"]
    init_fn, apply_fn, _ = sc.task_fns()
    params = jax.device_get(split_params(init_fn(jax.random.PRNGKey(4)))[0])
    _, (xte, yte) = j_synthetic_mnist(0, n_train=10, n_test=450)
    want = j_accuracy(apply_fn, params, xte, yte, batch=200)
    got = accuracy(SCENARIOS["fig2_iid"].task_fns()[1],
                   convert.params_from_jax(params), torch.as_tensor(xte),
                   torch.as_tensor(yte), batch=200)
    assert got == want
