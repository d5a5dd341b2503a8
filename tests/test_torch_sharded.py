"""The port's sharded engine and partial combine, against the JAX package
and against the port's own single engine.

Port against JAX (inputs made from a seed with numpy, the JAX kernels in
interpret mode):

- `fused_mac_partials_plain` against `fused_mac_partials`: within 1e-5
  of max |p|; `fused_partials_reduce_plain` against
  `fused_partials_reduce` on the same partials: within 1e-5 of max |y|
  (the noise is drawn on each side, within 4 ULP; the sums differ in
  order only); `fused_noise` within 4 ULP, the Box-Muller bound of
  tests/test_torch_prng.py;
- the sharded slice against the JAX `ShardedSweepRunner` on a 1x1 mesh
  (``scale_u256`` cut to C=2, M=8, K=4, 2 rounds, 2 seeds, u_sharded):
  the bounds of tests/test_torch_slice.py (loss and power rtol 1e-5,
  accuracy 1/n_test, final model 1e-4 of max |theta|).

Port against port, bit for bit: the sharded engine on meshes 1x1, 2x2,
2x3 (padded users) and 3x2 (a padded cluster), with both combines,
against the single engine (final model, optimizer state and every
metric); and `fused_mac_partials` + `fused_partials_reduce` against
`fused_mac` at several tilings.  The plain versions add users, u-blocks
and antenna rows one at a time in the kernels' order, so no torch
reduction's order (which follows a tile's width) enters.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.topology import pad_plan as j_pad_plan
from repro.core.topology import pad_topology as j_pad_topology
from repro.exec import ShardedSweepRunner as JShardedSweepRunner
from repro.exec import parse_mesh as j_parse_mesh
from repro.exec import validate_mesh_for as j_validate_mesh_for
from repro.kernels.fused_mac import fused_mac_partials as j_partials
from repro.kernels.fused_mac import fused_noise as j_fused_noise
from repro.kernels.fused_mac import fused_partials_reduce as j_reduce
from repro.sim.scenario import SCENARIOS as J_SCENARIOS
from repro_torch.core.topology import pad_plan, pad_topology
from repro_torch.exec import (ShardedSweepRunner, make_device_mesh,
                              make_runner, parse_mesh, validate_mesh_for)
from repro_torch.kernels import (fused_mac, fused_mac_partials,
                                 fused_mac_partials_plain, fused_mac_plain,
                                 fused_noise, fused_partials_reduce,
                                 fused_partials_reduce_plain)
from repro_torch.sim import sweep
from repro_torch.sim.scenario import get_scenario

# one intra-op thread: test workers run side by side, and torch's
# default of one thread per core oversubscribes the CPU many times
torch.set_num_threads(1)

RTOL = 1e-5
THETA_RTOL = 1e-4
SEED = np.array([0xC0FFEE, 42], np.uint32)
SMALL = dict(C=2, M=8, K=4, K_ps=4, total_IT=2, n_train=4 * 16 * 4)


def _small(**kw):
    """scale_u256 cut to C=2, M=8, K=4, 2 rounds (Adam, so that the
    optimizer state is not empty)."""
    return get_scenario("scale_u256").replace(**SMALL, opt="adam", **kw)


# ---------------------------------------------------------------------------
# pad plans and meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,M,mesh", [(4, 5, (2, 4)), (4, 64, (2, 4)),
                                      (2, 8, (3, 5)), (3, 7, (1, 1)),
                                      (16, 1024, (3, 3))])
def test_pad_plan_matches_reference(C, M, mesh):
    want, got = j_pad_plan(C, M, mesh), pad_plan(C, M, mesh)
    assert (got.C, got.M, got.Cp, got.Mp, got.is_identity) == (
        want.C, want.M, want.Cp, want.Mp, want.is_identity)
    assert got.user_perm().tobytes() == want.user_perm().tobytes()
    rng = np.random.default_rng(C * M)
    grid = rng.standard_normal((C, M, 3)).astype(np.float32)
    rows = rng.standard_normal((C, 5)).astype(np.float32)
    keys = rng.integers(0, 2 ** 31, (C, M, 2), dtype=np.int64)
    for x in (grid, rows, keys):
        for fill in (0, 1.0):
            pad = want.pad_rx if x is rows else want.pad_users
            ref = np.asarray(pad(x, fill=fill))
            pad = got.pad_rx if x is rows else got.pad_users
            have = pad(torch.as_tensor(x), fill=fill).numpy()
            assert have.shape == ref.shape
            if x is keys:     # int64 words here, int32 in JAX without x64
                assert np.array_equal(have, ref)
            else:
                assert have.tobytes() == ref.tobytes()
    padded = np.array(want.pad_users(grid))
    assert np.ascontiguousarray(got.unpad_users(torch.as_tensor(
        padded)).numpy()).tobytes() == np.asarray(
        want.unpad_users(padded)).tobytes()
    topo = J_SCENARIOS["fig2_iid"].make_topology()
    assert pad_topology(topo, mesh) == pad_plan(topo.C, topo.M, mesh)
    assert (j_pad_topology(topo, mesh).Cp, j_pad_topology(topo, mesh).Mp) \
        == (pad_topology(topo, mesh).Cp, pad_topology(topo, mesh).Mp)


def test_pad_plan_rejects_empty_workloads():
    with pytest.raises(ValueError, match="positive"):
        pad_plan(0, 4, (1, 1))


class _ShapeMesh:
    """A JAX-side stand-in mesh: `validate_mesh_for` reads only
    ``.devices.shape``."""

    def __init__(self, mc, mu):
        self.devices = np.empty((mc, mu), dtype=object)


@pytest.mark.parametrize("spec", ["2x4", "1X1", " 3 * 5 ", (4, 2)])
def test_parse_mesh_matches_reference(spec):
    assert parse_mesh(spec) == j_parse_mesh(spec)


@pytest.mark.parametrize("bad", ["2x", "x4", "0x2", "2x4x2", "abc", (0, 1),
                                 (1, 2, 3)])
def test_parse_mesh_errors_match_reference(bad):
    with pytest.raises(ValueError) as want:
        j_parse_mesh(bad)
    with pytest.raises(ValueError) as got:
        parse_mesh(bad)
    assert str(got.value) == str(want.value)


def test_validate_mesh_for_matches_reference():
    mesh = make_device_mesh("2x4", "cpu")
    assert mesh.axis_names == ("cluster", "user")
    assert list(mesh.shards())[:3] == [(0, 0), (0, 1), (0, 2)]
    assert validate_mesh_for(mesh, 4, 64) == j_validate_mesh_for(
        _ShapeMesh(2, 4), 4, 64) == (2, 16)
    with pytest.raises(ValueError, match="pad to M=8"):
        validate_mesh_for(mesh, 4, 5)
    with pytest.raises(ValueError, match="pad to M=8"):
        j_validate_mesh_for(_ShapeMesh(2, 4), 4, 5)


# ---------------------------------------------------------------------------
# the partial combine against the JAX kernels, and against fused_mac
# ---------------------------------------------------------------------------

def _inputs(B, U, N, seed):
    rng = np.random.default_rng(seed)
    t_re = rng.standard_normal((U, N)).astype(np.float32)
    t_im = rng.standard_normal((U, N)).astype(np.float32)
    amp = rng.uniform(0.5, 2.0, (B, U)).astype(np.float32)
    w = rng.integers(0, 2, (B, U)).astype(np.float32)
    w[:, 0] = 1.0
    return t_re, t_im, amp, w


PARTIAL_SHAPES = [        # B, U, K, N, block_u, (rx, u, n bases)
    (1, 8, 1, 64, 8, (0, 0, 0)),
    (2, 16, 4, 130, 4, (0, 16, 0)),
    (3, 12, 7, 96, 6, (2, 3, 5)),
    (2, 32, 12, 200, 8, (0, 64, 200)),    # K padded to 16 on the JAX side
]


@pytest.mark.parametrize("B,U,K,N,bu,bases", PARTIAL_SHAPES)
def test_partials_and_reduce_plain_match_jax(B, U, K, N, bu, bases):
    rb, ub, nb = bases
    arrs = _inputs(B, U, N, B * 100 + U + K + N)
    kw = dict(K=K, sigma_h2=1.0, rx_base=rb, u_base=ub, n_base=nb)
    ref = jax.jit(functools.partial(j_partials, block_u=bu, interpret=True,
                                    **kw))(jnp.asarray(SEED), *arrs)
    tens = [torch.as_tensor(a) for a in arrs]
    got = fused_mac_partials(torch.as_tensor(SEED.astype(np.int64)), *tens,
                             block_u=bu, **kw)
    for r, g in zip(ref, got):
        r = np.asarray(r)[:, :, :K]
        assert g.shape == (B, U // bu, K, N) and g.dtype == torch.float32
        assert np.abs(g.numpy() - r).max() <= RTOL * np.abs(r).max()

    # the fold of the JAX partials, on both sides
    Kp = ref[0].shape[2]
    z = j_fused_noise(jnp.asarray(SEED), B, Kp, N, 2.0, rx_base=rb,
                      n_base=nb)
    want = [np.asarray(y) for y in j_reduce(*ref, *z, K=K)]
    parts = [torch.as_tensor(np.array(p)[:, :, :K].copy()) for p in ref]
    y = fused_partials_reduce(SEED, *parts, K=K, sigma_z2=2.0, rx_base=rb,
                              n_base=nb)
    scale = np.abs(want[0] + 1j * want[1]).max()
    for w_, y_ in zip(want, y):
        assert y_.shape == (B, N)
        assert np.abs(y_.numpy() - w_).max() <= RTOL * scale


@pytest.mark.parametrize("B,K,N,bases", [(1, 1, 64, (0, 0)),
                                         (3, 7, 130, (2, 5)),
                                         (2, 16, 300, (5, 982))])
def test_fused_noise_matches_jax(B, K, N, bases):
    want = j_fused_noise(jnp.asarray(SEED), B, K, N, 3.0, rx_base=bases[0],
                         n_base=bases[1])
    got = fused_noise(SEED, B, K, N, 3.0, rx_base=bases[0],
                      n_base=bases[1])
    for w_, g in zip(want, got):
        w_ = np.asarray(w_)
        assert g.shape == w_.shape == (B, K, N)
        np.testing.assert_allclose(g.numpy(), w_, rtol=4 * 2 ** -23,
                                   atol=4 * 2 ** -23 * np.abs(w_).max())


@pytest.mark.parametrize("B,U,K,N,bu,tiles", [
    (2, 16, 4, 130, 4, 1),
    (3, 24, 7, 96, 4, 3),       # three tiles of the user axis
    (2, 32, 12, 200, 8, 2),
])
def test_partials_then_reduce_equals_fused_mac_bitwise(B, U, K, N, bu,
                                                       tiles):
    """Every tile's blocks, folded in global block order, give
    `fused_mac` over the whole user range, bit for bit."""
    t_re, t_im, amp, w = (torch.as_tensor(a)
                          for a in _inputs(B, U, N, U + K))
    kw = dict(K=K, sigma_h2=1.0, rx_base=1, n_base=7)
    U_t = U // tiles
    parts = [fused_mac_partials(
        SEED, t_re[i:i + U_t].contiguous(), t_im[i:i + U_t].contiguous(),
        amp[:, i:i + U_t].contiguous(), w[:, i:i + U_t].contiguous(),
        u_base=i, block_u=bu, **kw) for i in range(0, U, U_t)]
    folded = [torch.cat([p[j] for p in parts], dim=1) for j in range(4)]
    y = fused_partials_reduce(SEED, *folded, K=K, sigma_z2=2.0, rx_base=1,
                              n_base=7)
    want = fused_mac_plain(SEED, t_re, t_im, amp, w, sigma_z2=2.0,
                           block_u=bu, **kw)
    assert torch.equal(y[0], want[0]) and torch.equal(y[1], want[1])
    assert torch.equal(folded[0], fused_mac_partials_plain(
        SEED, t_re, t_im, amp, w, block_u=bu, **kw)[0])
    assert torch.equal(y[1], fused_partials_reduce_plain(
        SEED, *folded, K=K, sigma_z2=2.0, rx_base=1, n_base=7)[1])


def test_partial_wrappers_run_plain_on_cpu_and_check_inputs():
    t_re, t_im, amp, w = (torch.as_tensor(a) for a in _inputs(2, 12, 64, 3))
    before = (fused_mac_partials.launches, fused_partials_reduce.launches,
              fused_mac.launches)
    parts = fused_mac_partials(SEED, t_re, t_im, amp, w, K=3, sigma_h2=1.0,
                               block_u=4)
    fused_partials_reduce(SEED, *parts, K=3, sigma_z2=1.0)
    assert (fused_mac_partials.launches, fused_partials_reduce.launches,
            fused_mac.launches) == before
    with pytest.raises(ValueError, match="divisible"):
        fused_mac_partials(SEED, t_re, t_im, amp, w, K=3, sigma_h2=1.0,
                           block_u=5)
    with pytest.raises(ValueError, match="antenna rows"):
        fused_partials_reduce(SEED, *parts, K=4, sigma_z2=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        fused_partials_reduce(SEED, parts[0].transpose(2, 3), *parts[1:],
                              K=3, sigma_z2=1.0)
    meta = [p.to("meta") for p in parts]
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_partials_reduce(SEED, *meta, K=3, sigma_z2=1.0)


# ---------------------------------------------------------------------------
# the sharded engine
# ---------------------------------------------------------------------------

def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.fixture(scope="module")
def single_runs():
    """The single engine's runs the sharded ones are held to."""
    return {name: sweep.SweepRunner([sc], seeds=2, keep_state=True,
                                    batch="map", device="cpu").run()[0]
            for name, sc in (("fused", _small()),
                             ("equivalent", _small(
                                 ota_mode="equivalent", ota_backend="")),
                             ("conventional", _small(mode="conventional")))}


@pytest.mark.parametrize("combine", ["gathered", "u_sharded"])
@pytest.mark.parametrize("mesh,padded", [("1x1", None), ("2x2", None),
                                         ("2x3", "2x9"), ("3x2", "3x8")])
def test_sharded_equals_single_engine_bitwise(single_runs, mesh, padded,
                                              combine):
    ref = single_runs["fused"]
    got = ShardedSweepRunner([_small()], seeds=2, keep_state=True,
                             device="cpu", mesh=mesh,
                             combine=combine).run()[0]
    for key in ("rounds", "acc", "loss", "edge_power", "is_power"):
        assert getattr(got, key) == getattr(ref, key), key
    assert _equal(got.final_state, ref.final_state)
    info = got.exec_info
    assert (info["name"], info["mesh"], info["padded"], info["combine"],
            info["device_count"]) == ("sharded", mesh, padded, combine, 1)
    assert info["peak_symbol_bytes"] > 0


@pytest.mark.parametrize("name,mesh", [("equivalent", "2x3"),
                                       ("conventional", "3x2")])
def test_sharded_other_hops_equal_single_engine_bitwise(single_runs, name,
                                                        mesh):
    ref = single_runs[name]
    got = ShardedSweepRunner([ref.scenario], seeds=2, keep_state=True,
                             device="cpu", mesh=mesh,
                             combine="u_sharded").run()[0]
    for key in ("acc", "loss", "edge_power", "is_power"):
        assert getattr(got, key) == getattr(ref, key), key
    assert _equal(got.final_state, ref.final_state)


def test_sharded_u_sharded_matches_jax_1x1():
    """The JAX ShardedSweepRunner, u_sharded on a 1x1 mesh in this
    process, against the port's, with test_torch_slice's bounds."""
    jsc = J_SCENARIOS["scale_u256"].replace(**SMALL)
    ref = JShardedSweepRunner([jsc], seeds=2, mesh="1x1", keep_state=True,
                              combine="u_sharded").run()[0]
    got = ShardedSweepRunner([get_scenario("scale_u256").replace(**SMALL)],
                             seeds=2, mesh="1x1", keep_state=True,
                             device="cpu", combine="u_sharded").run()[0]
    assert got.rounds == ref.rounds and got.seeds == ref.seeds
    np.testing.assert_allclose(got.acc, ref.acc, rtol=0,
                               atol=1.0 / jsc.n_test)
    for key in ("loss", "edge_power", "is_power"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   rtol=RTOL, err_msg=key)
    for leaf in ("w", "b"):
        want = np.asarray(ref.final_state["theta"][leaf])
        have = got.final_state["theta"][leaf].numpy()
        assert np.abs(have - want).max() <= THETA_RTOL * np.abs(want).max()
    for key in ("combine", "mesh", "padded"):
        assert got.exec_info[key] == ref.exec_info[key]


def test_cli_runs_sharded_and_keeps_the_schema(tmp_path):
    doc = sweep.main(["--scenarios", "scale_u256", "--quick", "--device",
                      "cpu", "--exec", "sharded", "--mesh", "2x3",
                      "--combine", "u_sharded", "--bench-out",
                      str(tmp_path / "bench.json")])
    assert doc["schema"] == "repro.sim.sweep/v1"
    rec = doc["scenarios"][0]
    assert tuple(rec) == sweep.RECORD_KEYS
    assert (rec["exec"]["name"], rec["exec"]["mesh"], rec["exec"]["padded"],
            rec["exec"]["combine"]) == ("sharded", "2x3", "2x3",
                                        "u_sharded")      # C=2, M=2
    assert (tmp_path / "bench.json").exists()


@pytest.mark.parametrize("argv", [
    ["--combine", "u_sharded"],                       # single engine
    ["--exec", "sharded", "--mesh", "2by4"],
    ["--exec", "sharded", "--combine", "psum"],
])
def test_cli_rejects_bad_engine_options(argv):
    with pytest.raises(SystemExit):
        sweep.main(["--scenarios", "scale_u256", "--quick", "--device",
                    "cpu", *argv])


def test_unported_sharded_options_raise():
    # participation and telemetry (ROADMAP queue A, items 7 and 9) run
    # on the sharded engine: the block on the real C; an unknown engine
    # still raises
    sc = get_scenario("fig2_drop10").quick().replace(telemetry=True,
                                                     total_IT=2)
    rec = ShardedSweepRunner([sc], device="cpu",
                             mesh="2x2").run()[0].to_record()
    assert np.asarray(rec["telemetry"]["snr"][0][0]).shape == (sc.C,)
    with pytest.raises(ValueError, match="unknown execution engine"):
        make_runner("turbo", ["scale_u256"], device="cpu")
    assert type(make_runner("single", ["scale_u256"], device="cpu")) \
        is sweep.SweepRunner


def test_sharded_runner_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedSweepRunner(["scale_u256"], mesh="2x4")
