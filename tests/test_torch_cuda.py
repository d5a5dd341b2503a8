"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one: a CUDA kernel has no
CPU mode.  They import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch; there, skip the JAX-side conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-4 of the largest output magnitude (the JAX package's own
kernel gate); a kernel and its plain version see the same channels
(drawn alike, or handed in) and differ only in float summation order.
Flash attention: float32 outputs within 1e-5 of max |o|; bfloat16
outputs within that plus one bf16 ULP of each value, since both sides
compute in float32 and round once (near zero the float32 gap spans
many ULPs, so a strict 1-ULP rule fails for any change of summation
order).  bfloat16 runs on the tensor-core kernel
(``csrc/flash_attn_wgmma.cu``), which splits each softmax weight into
two bf16 parts to stay inside that gate; float32 on the float32
tensor-core kernel (``csrc/flash_attn_tf32.cu``, 3xTF32: every product
split into tf32 hi and lo parts; hd 16 on its hd-32 instance,
zero-padded, as hd 112 on its hd-128 one); both at hd 16, 32, 64, 112
and 128 (the bf16 kernel's hd 112 on its hd-128 instance, TMA boxes
zero-filled past column 112).  Each test checks which
kernel served it by the wrapper's two launch counts.
`ota_combine` splits its antennas over a thread-block cluster where B
alone would not fill the card; its cluster size comes from the built
library (``ota_combine_cluster_size``).
With a sliding window both kernels are held to their plain versions by
the same gates, and a window of at least L keys to the unwindowed
launch bit for bit.
Two launches must give identical bits: the kernels sum in a fixed order
and use no atomics.  For the same reason the partial combine and its
fold give `fused_mac`'s output bit for bit: the three kernels share the
per-block sum, the noise draw and the finalize.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attn as flash_module
from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 flash_mha, flash_mha_plain, flash_route,
                                 fused_mac,
                                 fused_mac_partials,
                                 fused_mac_partials_plain, fused_mac_plain,
                                 fused_partials_reduce,
                                 fused_partials_reduce_plain, ota_combine,
                                 ota_combine_plain)

TOL = 1e-4
SEED = np.array([0xC0FFEE, 42], np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("B,U,K,N,bases", [
    (1, 1, 1, 64, (0, 0, 0)),
    (1, 4, 8, 256, (0, 0, 0)),
    (3, 5, 7, 130, (2, 3, 5)),
    (2, 33, 16, 513, (0, 0, 0)),
    (1, 70, 100, 1000, (0, 0, 0)),
    (4, 256, 16, 3925, (0, 0, 0)),     # scale_u256 cluster hop
    (1, 4, 16, 3925, (0, 0, 0)),       # scale_u256 IS->PS hop
    (4, 20, 100, 3925, (0, 0, 0)),     # fig2 cluster hop (fused backend)
    (1, 4, 100, 3925, (0, 0, 0)),      # fig2 IS->PS hop
])
def test_fused_mac_kernel_matches_plain_on_card(B, U, K, N, bases):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rb, ub, nb = bases
    rng = np.random.default_rng(B * 100 + U + K + N)
    tens = [torch.as_tensor(a, device="cuda") for a in (
        rng.standard_normal((U, N)).astype(np.float32),
        rng.standard_normal((U, N)).astype(np.float32),
        rng.uniform(0.5, 2.0, (B, U)).astype(np.float32),
        np.ones((B, U), np.float32))]
    seed = torch.as_tensor(SEED, device="cuda")
    kw = dict(K=K, sigma_h2=1.0, sigma_z2=2.0, rx_base=rb, u_base=ub,
              n_base=nb)
    before = fused_mac.launches
    y1 = fused_mac(seed, *tens, **kw)
    y2 = fused_mac(seed, *tens, **kw)
    torch.cuda.synchronize()
    assert fused_mac.launches == before + 2
    assert torch.equal(y1[0], y2[0]) and torch.equal(y1[1], y2[1])
    want = fused_mac_plain(seed, *tens, **kw)
    scale = float(torch.complex(*want).abs().max())
    err = max(float((y1[0] - want[0]).abs().max()),
              float((y1[1] - want[1]).abs().max()))
    assert err <= TOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("B,U,K,N,bu", [
    (4, 20, 100, 154197, 5),     # fig3 cluster hop: a ragged last N tile
    (1, 4, 100, 154197, 32),     # fig3 IS->PS hop
])
def test_fused_mac_at_fig3_shapes_on_card(B, U, K, N, bu):
    """The CIFAR CNN's N = 154,197 symbols, at the block size the round
    gives each hop (`canonical_block_u(M)` on the cluster hop)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(N + B)
    M = U // B
    own = np.zeros((B, U), np.float32)
    for b in range(B):
        own[b, b * M:(b + 1) * M] = 1.0
    tens = [torch.as_tensor(a, device="cuda") for a in (
        1e-2 * rng.standard_normal((U, N)).astype(np.float32),
        1e-2 * rng.standard_normal((U, N)).astype(np.float32),
        rng.uniform(0.2, 1.2, (B, U)).astype(np.float32),
        own if B > 1 else np.ones((B, U), np.float32))]
    seed = torch.as_tensor(SEED, device="cuda")
    kw = dict(K=K, sigma_h2=1.0, sigma_z2=1.0, block_u=bu)
    y1 = fused_mac(seed, *tens, **kw)
    y2 = fused_mac(seed, *tens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y1[0], y2[0]) and torch.equal(y1[1], y2[1])
    want = fused_mac_plain(seed, *tens, **kw)
    scale = float(torch.complex(*want).abs().max())
    err = max(float((y1[0] - want[0]).abs().max()),
              float((y1[1] - want[1]).abs().max()))
    assert err <= TOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["single", "sharded 2x2 u_sharded"])
def test_captured_windows_equal_eager_rounds_on_card(engine):
    """The chunked driver's CUDA graphs (windows of 1 and 2 rounds) give
    the stepwise driver's bits, final state and metrics, and launch what
    it launches: the stepwise run's launch counters against the chunked
    drive's replays, counted from its graphs (a replay runs no Python,
    so the counters cannot see it: each graph's kernel nodes at its
    capture, times its replays), and a device trace of the drive must
    see no more (it can lose a long replay's records, never make one
    up).  fig3 faithful/fused cut to C 2, M 2, warmed, so the drive
    holds replays only.  The drive is counted as the smoke counts it
    (`kernels.trace_probe.count_drives`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chunked driver's graphs")
    from repro_torch.exec import make_runner
    from repro_torch.kernels import LAUNCH_COUNTERS
    from repro_torch.kernels.trace_probe import count_drives
    from repro_torch.sim import SweepRunner
    from repro_torch.sim.scenario import get_scenario
    from repro_torch.tree import tree_leaves

    kernels = {"fused_mac": "fused_mac_kernel",
               "fused_mac_partials": "fused_partials_kernel",
               "fused_partials_reduce": "fused_reduce_kernel"}
    sc = get_scenario("fig3_cifar").replace(
        C=2, M=2, batch=8, tau=2, n_train=400, n_test=64, K=4, K_ps=4,
        total_IT=3, eval_every=2, ota_mode="faithful", ota_backend="fused")
    name = "single" if engine == "single" else "sharded"

    def runner(driver):
        return make_runner(
            name, [sc], seeds=2, keep_state=True, mesh="2x2",
            combine="gathered" if name == "single" else "u_sharded",
            driver=driver, warmup=driver == "chunked", device="cuda",
            batch="map")

    for fn, attr in LAUNCH_COUNTERS.values():
        setattr(fn, attr, 0)
    a = runner("stepwise").run()[0]
    counted = {k: getattr(*LAUNCH_COUNTERS[k]) for k in kernels}
    b, seen, traced = count_drives(lambda: runner("chunked").run()[0],
                                   kernels, SweepRunner)
    assert b.exec_info["dispatches"] == 2          # windows of 1 and 2
    assert seen == counted
    assert all(traced[k] <= counted[k] for k in kernels), traced
    assert counted["fused_mac"] == 2 * 3 * (2 if name == "single" else 1)
    for k in ("acc", "loss", "edge_power", "is_power"):
        assert getattr(a, k) == getattr(b, k), k
    for (p, x), (_, y) in zip(tree_leaves(a.final_state),
                              tree_leaves(b.final_state)):
        assert torch.equal(x, y), p


@pytest.mark.cuda
def test_sweep_on_gloo_ranks_sharing_the_card_equals_one_process():
    """scale_u256 cut to C 2, M 8, K 4, 2 rounds (Adam) on 2x2 u_sharded
    as four gloo ranks sharing the card, through both drivers (the
    chunked one replays the graphs between the ranks' collectives),
    equals the one-process sharded run on the card bit for bit: final
    state and every metric.  Each rank launches one partial combine and
    one fold a hop, and the IS -> PS `fused_mac` a round, each a round
    and seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranks share it")
    from repro_torch.exec import ShardedSweepRunner
    from repro_torch.sim.scenario import get_scenario
    from repro_torch.tree import tree_leaves

    sc = get_scenario("scale_u256").replace(
        C=2, M=8, K=4, K_ps=4, total_IT=2, n_train=4 * 16 * 4, opt="adam")
    kw = dict(seeds=2, keep_state=True, device="cuda", mesh="2x2",
              combine="u_sharded")
    want = ShardedSweepRunner([sc], **kw).run()[0]
    for driver in ("stepwise", "chunked"):
        runner = ShardedSweepRunner([sc], ranks="gloo", driver=driver,
                                    warmup=driver == "chunked", **kw)
        got = runner.run()[0]
        for k in ("rounds", "acc", "loss", "edge_power", "is_power"):
            assert getattr(got, k) == getattr(want, k), (driver, k)
        for (p, x), (_, y) in zip(tree_leaves(want.final_state),
                                  tree_leaves(got.final_state)):
            assert torch.equal(x, y), (driver, p)
        assert got.exec_info["device_count"] == 4
        if driver == "stepwise":
            hops = got.rounds[-1] * 2                # rounds x seeds
            for rep in runner.rank_reports:
                assert {k: rep["launches"][k] for k in (
                    "fused_mac", "fused_mac_partials",
                    "fused_partials_reduce")} == {
                    "fused_mac": hops, "fused_mac_partials": hops,
                    "fused_partials_reduce": hops}, rep["rank"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fig2_drop50", "fig2_straggler",
                                  "fig2_byzantine1_median"])
def test_participation_masks_in_captured_rounds_on_card(name):
    """A participation round takes its mask from the device round index,
    so the chunked driver's graphs replay every round's own mask: the
    chunked run equals the stepwise one bit for bit (quick, 5 rounds,
    windows of 1 and 2), and the card's realised masks equal the CPU's
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chunked driver's graphs")
    from repro_torch.sim import sweep
    from repro_torch.sim.scenario import get_scenario
    from repro_torch.tree import tree_leaves

    sc = get_scenario(name).quick().replace(total_IT=5)
    a, b = (sweep.SweepRunner([sc], seeds=2, keep_state=True, driver=d,
                              warmup=d == "chunked", device="cuda",
                              batch="map").run()[0]
            for d in ("stepwise", "chunked"))
    for k in ("acc", "loss", "edge_power", "is_power"):
        assert getattr(a, k) == getattr(b, k), k
    for (p, x), (_, y) in zip(tree_leaves(a.final_state),
                              tree_leaves(b.final_state)):
        assert torch.equal(x, y), p
    sched = sc.participation_schedule()
    assert (sched.history(9, 4, 5, device="cuda").tobytes()
            == sched.history(9, 4, 5, device="cpu").tobytes())


def test_fused_mac_rejects_other_devices():
    """A tensor on neither the CPU nor a CUDA card is refused, not run
    through the plain version."""
    t = torch.zeros((2, 8), device="meta")
    a = torch.ones((1, 2), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_mac(SEED, t, t, a, a, K=2, sigma_h2=1.0, sigma_z2=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,U,K,N", [
    (None, 1, 1, 64),
    (3, 1, 1, 64),
    (None, 4, 7, 130),
    (3, 4, 7, 130),
    (None, 3, 33, 513),
    (3, 3, 33, 513),
    (4, 20, 100, 3925),     # fig2 cluster hop (slab backend)
    (None, 4, 100, 3925),   # fig2 IS->PS hop
    (None, 20, 100, 3925),  # fig2 conventional hop
    (4, 256, 16, 3925),     # scale_u256 cluster hop (slab backend)
])
def test_ota_combine_kernel_matches_plain_on_card(B, U, K, N):
    """B = None is the unbatched layout, which runs as B = 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(U * 1000 + K * 10 + N)
    lead = () if B is None else (B,)
    cx = lambda *shape: torch.randn(*shape, dtype=torch.complex64,
                                    generator=g).to("cuda")
    args = (cx(*lead, U, K, N), cx(U, N), cx(*lead, K, N),
            torch.randn(*lead, U, generator=g).to("cuda"))
    before = ota_combine.launches
    y1 = ota_combine(*args)
    y2 = ota_combine(*args)
    torch.cuda.synchronize()
    assert ota_combine.launches == before + 2
    assert torch.equal(y1, y2)
    want = ota_combine_plain(*args)
    assert y1.shape == want.shape == (*lead, N)
    assert float((y1 - want).abs().max()) <= TOL * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,S,B,U,K,N,shared", [
    ("fused_mac", 4, 4, 20, 100, 3925, True),    # fig2 cluster hop
    ("fused_mac", 4, 1, 4, 100, 3925, False),    # fig2 IS->PS hop
    ("fused_mac", 3, 3, 5, 7, 130, False),
    ("fused_mac", 2, 4, 256, 16, 3925, True),    # scale_u256 cluster hop
    ("ota_combine", 4, 4, 20, 100, 3925, True),  # fig2 cluster hop
    ("ota_combine", 4, 1, 4, 100, 3925, False),  # fig2 IS->PS, split
    ("ota_combine", 4, 1, 20, 100, 3925, False),  # conventional, split
    ("ota_combine", 2, 4, 256, 16, 3925, True),  # scale_u256 cluster hop
])
def test_seed_batched_launch_equals_unbatched_launches_on_card(
        kernel, S, B, U, K, N, shared):
    """S seeds in one launch (the gains shared with a seed stride of 0
    where `shared`, as the vmapped hops pass them) equal S unbatched
    launches bit for bit, and the plain version within TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(S * 1000 + B + U + K + N)
    rnd = lambda *s: torch.randn(*s, generator=g).to("cuda")
    gains = (rnd(B, U).abs() + 0.5).expand(S, B, U) if shared else (
        rnd(S, B, U).abs() + 0.5)
    fn = fused_mac if kernel == "fused_mac" else ota_combine
    if kernel == "fused_mac":
        seeds = torch.randint(0, 2 ** 32, (S, 2), generator=g).to("cuda")
        args = (rnd(S, U, N), rnd(S, U, N), gains, gains)
        kw = dict(K=K, sigma_h2=1.0, sigma_z2=2.0, block_u=min(U, 32))
        call = lambda *a: fused_mac(*a, **kw)
        plain = lambda *a: fused_mac_plain(*a, **kw)
        args = (seeds, *args)
    else:
        cx = lambda *s: torch.complex(rnd(*s), rnd(*s))
        args = (cx(S, B, U, K, N), cx(S, U, N), cx(S, B, K, N), gains)
        call, plain = ota_combine, ota_combine_plain
    before = fn.launches
    y = call(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    y = torch.stack(y, -1) if isinstance(y, tuple) else torch.view_as_real(y)
    assert y.shape[:3] == (S, B, N)
    for s in range(S):
        one = call(*(a[s] for a in args))
        one = (torch.stack(one, -1) if isinstance(one, tuple)
               else torch.view_as_real(one))
        assert torch.equal(y[s], one), s
    want = plain(*args)
    want = (torch.stack(want, -1) if isinstance(want, tuple)
            else torch.view_as_real(want))
    scale = float(torch.linalg.vector_norm(want, dim=-1).max())
    assert float((y - want).abs().max()) <= TOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fused", "slab_kernel"])
def test_vmapped_hops_launch_once_for_all_seeds_on_card(backend):
    """`vmap_seeds` over fig2's cluster and IS->PS hops: one launch a
    hop for 4 seeds, each seed's estimate its own call's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch import prng
    from repro_torch.core import (OTAConfig, cluster_ota, global_ota,
                                  vmap_seeds)
    from repro_torch.sim.scenario import get_scenario
    topo = get_scenario("fig2_iid").make_topology()
    cfg = OTAConfig(mode="faithful", backend=backend)
    fn = fused_mac if backend == "fused" else ota_combine
    keys = prng.split(prng.PRNGKey(3, "cuda"), 4)
    g = torch.Generator(device="cuda").manual_seed(4)
    P = torch.tensor(2.0, device="cuda")
    for hop, shape in ((cluster_ota, (4, topo.C, topo.M, 7850)),
                       (global_ota, (4, topo.C, 7850))):
        d = 1e-2 * torch.randn(*shape, generator=g, device="cuda")
        before = fn.launches
        est = vmap_seeds(hop)(keys, d, topo, P, cfg)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        for s in range(4):
            assert torch.equal(est[s], hop(keys[s], d[s], topo, P, cfg))


@pytest.mark.cuda
def test_ota_combine_refuses_strided_views_on_card():
    """A `.real`-style or transposed view of a slab is refused, not
    copied: the kernel reads contiguous interleaved complex64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    h = torch.zeros((2, 3, 4, 64), dtype=torch.complex64, device="cuda")
    t = torch.zeros((3, 64), dtype=torch.complex64, device="cuda")
    z = torch.zeros((2, 4, 64), dtype=torch.complex64, device="cuda")
    w = torch.ones((2, 3), device="cuda")
    before = ota_combine.launches
    for args in ((h.transpose(2, 3).contiguous().transpose(2, 3), t, z, w),
                 (h, t, z, w.t().contiguous().t()),
                 (h, t.conj(), z, w)):
        with pytest.raises(ValueError):
            ota_combine(*args)
    assert ota_combine.launches == before



def _cluster_size(B, K, N):
    fn = build.load("ota_combine").ota_combine_cluster_size
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return fn(B, K, N)


@pytest.mark.cuda
@pytest.mark.parametrize("B,U,K,N", [
    (None, 20, 100, 3925),  # fig2 conventional hop (B = 1)
    (None, 3, 33, 513),     # a ragged last row group
    (2, 20, 100, 3925),
    (2, 5, 40, 700),
])
def test_ota_combine_cluster_split_matches_plain_on_card(B, U, K, N):
    """Shapes whose grid alone would not fill the card run as clusters
    of more than one block; within 1e-4 of the plain version, and two
    launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    assert _cluster_size(B or 1, K, N) > 1
    g = torch.Generator().manual_seed((B or 1) + U + K + N)
    lead = () if B is None else (B,)
    cx = lambda *shape: torch.randn(*shape, dtype=torch.complex64,
                                    generator=g).to("cuda")
    args = (cx(*lead, U, K, N), cx(U, N), cx(*lead, K, N),
            torch.randn(*lead, U, generator=g).to("cuda"))
    before = ota_combine.launches
    y1 = ota_combine(*args)
    y2 = ota_combine(*args)
    torch.cuda.synchronize()
    assert ota_combine.launches == before + 2
    assert torch.equal(y1, y2)
    want = ota_combine_plain(*args)
    assert float((y1 - want).abs().max()) <= TOL * float(want.abs().max())

PARTIAL_SHAPES = [              # B, U, K, N, block_u, (rx, u, n bases)
    (2, 16, 4, 130, 4, (0, 0, 0)),
    (3, 40, 7, 130, 8, (2, 40, 5)),      # ragged K and N
    (4, 256, 16, 3925, 64, (0, 0, 0)),   # scale_u256, 1x1 mesh
    (4, 128, 16, 982, 64, (0, 128, 982)),  # scale_u256, a 2x4 tile
    (16, 1024, 4, 3925, 1024, (0, 0, 0)),  # a scale_u16384 tile
]


def _partial_inputs(B, U, N, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(a, device="cuda") for a in (
        rng.standard_normal((U, N)).astype(np.float32),
        rng.standard_normal((U, N)).astype(np.float32),
        rng.uniform(0.5, 2.0, (B, U)).astype(np.float32),
        rng.integers(0, 2, (B, U)).astype(np.float32))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,U,K,N,bu,bases", PARTIAL_SHAPES)
def test_partial_kernels_match_plain_and_fused_mac_on_card(B, U, K, N, bu,
                                                          bases):
    """Each new kernel within 1e-4 of its plain version with identical
    bits over two launches, and partials + fold == fused_mac, bit for
    bit, over the tile and split into two tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rb, ub, nb = bases
    tens = _partial_inputs(B, U, N, B + U + K + N)
    seed = torch.as_tensor(SEED, device="cuda")
    kw = dict(K=K, sigma_h2=1.0, rx_base=rb, u_base=ub, n_base=nb,
              block_u=bu)
    fold = dict(K=K, sigma_z2=2.0, rx_base=rb, n_base=nb)
    before = (fused_mac_partials.launches, fused_partials_reduce.launches)
    p1 = fused_mac_partials(seed, *tens, **kw)
    p2 = fused_mac_partials(seed, *tens, **kw)
    y1 = fused_partials_reduce(seed, *p1, **fold)
    y2 = fused_partials_reduce(seed, *p2, **fold)
    torch.cuda.synchronize()
    assert (fused_mac_partials.launches, fused_partials_reduce.launches) \
        == (before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert all(torch.equal(a, b) for a, b in zip(y1, y2))
    want_p = fused_mac_partials_plain(seed, *tens, **kw)
    for a, b in zip(p1, want_p):
        assert a.shape == (B, U // bu, K, N)
        assert float((a - b).abs().max()) <= TOL * float(b.abs().max())
    want_y = fused_partials_reduce_plain(seed, *p1, **fold)
    scale = float(torch.complex(*want_y).abs().max())
    assert max(float((a - b).abs().max())
               for a, b in zip(y1, want_y)) <= TOL * scale
    y = fused_mac(seed, *tens, sigma_z2=2.0, **kw)
    assert torch.equal(y[0], y1[0]) and torch.equal(y[1], y1[1])
    if U // bu >= 2:
        h = U // bu // 2 * bu
        halves = [fused_mac_partials(
            seed, tens[0][i:j].contiguous(), tens[1][i:j].contiguous(),
            tens[2][:, i:j].contiguous(), tens[3][:, i:j].contiguous(),
            **{**kw, "u_base": ub + i}) for i, j in ((0, h), (h, U))]
        cat = [torch.cat([a, b], dim=1) for a, b in zip(*halves)]
        yt = fused_partials_reduce(seed, *cat, **fold)
        assert torch.equal(yt[0], y[0]) and torch.equal(yt[1], y[1])


FLASH_SHAPES = [                  # B, L, H, KV, hd
    (2, 64, 4, 2, 16),
    (1, 32, 2, 1, 16),            # a q tile straddles fold groups
    (2, 96, 6, 2, 32),
    (1, 128, 8, 8, 64),
    (1, 256, 2, 2, 128),
    (2, 50, 6, 2, 32),            # ragged rows and keys
    (1, 77, 14, 2, 64),
    (1, 200, 4, 1, 128),
    (4, 4096, 14, 2, 64),         # qwen2-0.5b prefill, B 4, L 4096
    (1, 4096, 12, 2, 128),        # qwen2-1.5b prefill, B 1, L 4096
]


def bf16_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Within 1e-5 of max |want| plus one bf16 ULP of the larger value."""
    big = torch.maximum(got.abs(), want.abs()).contiguous()
    ulp = (big.view(torch.int16) + 1).view(torch.bfloat16).float() - (
        big.float())
    gap = (got.float() - want.float()).abs()
    return bool((gap <= 1e-5 * want.float().abs().max() + ulp).all())


def _flash_inputs(B, L, H, KV, hd, dtype, seed, S=None):
    g = torch.Generator().manual_seed(seed)
    S = L if S is None else S
    return [torch.randn(*s, generator=g).to("cuda", dtype)
            for s in ((B, L, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def _flash_close(got, want):
    if got.dtype == torch.bfloat16:
        return bf16_close(got, want)
    return float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def _launch_counts():
    return {"flash_attn_wgmma": flash_mha.wgmma_launches,
            "flash_attn_tf32": flash_mha.tf32_launches}


def _served_by(before, q, n):
    """The kernel `flash_route` names for q launched n times since
    `before`, and the other kernel not at all."""
    want = dict(before)
    want[flash_route(q)] += n
    return _launch_counts() == want


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,KV,hd", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_on_card(B, L, H, KV, hd, dtype, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _flash_inputs(B, L, H, KV, hd, dtype, B + L + H + hd)
    before = _launch_counts()
    o1 = flash_attention(q, k, v, causal=causal)
    o2 = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _served_by(before, q, 2)
    assert o1.shape == (B, L, H * hd) and o1.dtype == dtype
    assert torch.equal(o1, o2)
    assert _flash_close(o1, flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,S,H,KV,hd", [
    (1, 200, 200, 14, 2, 64),     # 128-row tiles straddle fold groups
    (1, 200, 333, 14, 2, 64),     # more keys than queries, ragged
    (2, 300, 130, 14, 2, 64),     # fewer keys than queries
    (1, 1000, 1000, 14, 2, 64),
    (2, 96, 200, 12, 2, 128),
    (1, 300, 130, 8, 8, 128),
    (1, 640, 640, 32, 8, 128),
    (2, 1, 1, 14, 2, 64),         # one query, one key
    (3, 5, 7, 4, 1, 128),         # 20 rows in a 128-row block; S > L
    (1, 64, 64, 1, 1, 32),        # one tile: 64 rows, 64 keys
    (1, 64, 64, 1, 1, 16),
    (1, 200, 333, 4, 2, 32),      # the 64- and 32-byte swizzles: straddle,
    (2, 300, 130, 4, 2, 16),      # ragged keys, S != L
    (1, 1000, 1000, 4, 2, 32),
    (3, 5, 7, 4, 1, 16),
    (1, 200, 333, 4, 2, 112),     # hd 112 on the hd-128 instance, its
    (2, 300, 130, 32, 32, 112),   # boxes zero-filled past column 112
    (3, 5, 7, 4, 1, 112),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_kernel_matches_plain_on_card(B, L, S, H, KV, hd,
                                                  causal):
    """The tensor-core kernel at its edges: L not a multiple of the
    128-row tile (a tile holds rows of two heads), S != L, S not a
    multiple of the 128-key tile, hd 16, 32, 64, 112 and 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _flash_inputs(B, L, H, KV, hd, torch.bfloat16, L + S + hd, S)
    assert flash_route(q) == "flash_attn_wgmma"
    before = _launch_counts()
    o1 = flash_attention(q, k, v, causal=causal)
    o2 = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _served_by(before, q, 2)
    assert torch.equal(o1, o2)
    assert torch.isfinite(o1).all()
    assert _flash_close(o1, flash_attention_plain(q, k, v, causal=causal))



@pytest.mark.cuda
@pytest.mark.parametrize("B,L,S,H,KV,hd", [
    (1, 200, 200, 14, 2, 64),     # 128-row tiles straddle fold groups
    (1, 200, 333, 14, 2, 64),     # more keys than queries, ragged
    (2, 300, 130, 14, 2, 64),     # fewer keys than queries
    (1, 1000, 1000, 14, 2, 64),
    (2, 1, 1, 14, 2, 64),         # one query, one key
    (3, 5, 7, 4, 1, 64),          # 20 rows in a 128-row block; S > L
    (1, 130, 70, 4, 4, 64),       # keys not a multiple of 8
    (2, 96, 200, 12, 2, 128),     # hd 128: 32-key tiles, 1 V^T stage
    (1, 200, 200, 12, 2, 128),    # straddling tiles at hd 128
    (1, 300, 130, 8, 8, 128),
    (1, 640, 640, 32, 8, 128),
    (3, 5, 7, 4, 1, 128),
    (1, 130, 70, 4, 4, 128),
    (1, 64, 64, 1, 1, 32),        # hd 32: one tile, 64 rows and 64 keys
    (1, 200, 333, 4, 2, 32),      # straddling tiles, ragged keys
    (1, 130, 70, 4, 4, 32),
    (1, 64, 64, 1, 1, 16),        # hd 16 on the hd-32 instance, padded
    (2, 300, 130, 4, 2, 16),
    (3, 5, 7, 4, 1, 16),
    (1, 200, 333, 4, 2, 112),     # hd 112 on the hd-128 instance, padded
    (2, 300, 130, 32, 32, 112),
    (3, 5, 7, 4, 1, 112),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tf32_kernel_matches_plain_on_card(B, L, S, H, KV, hd,
                                                 causal):
    """The float32 tensor-core kernel at its edges: L not a multiple of
    the 128-row tile (a tile holds rows of two heads), S != L, S not a
    multiple of the key tile (64 keys at hd 32 and 64, 32 at hd 128) or
    of 8, hd 16 zero-padded to 32 and hd 112 to 128; within 1e-5 of max
    |o|, one count per call, identical repeats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _flash_inputs(B, L, H, KV, hd, torch.float32, L + S + hd, S)
    assert flash_route(q) == "flash_attn_tf32"
    before = _launch_counts()
    o1 = flash_attention(q, k, v, causal=causal)
    o2 = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _served_by(before, q, 2)
    assert torch.equal(o1, o2)
    assert torch.isfinite(o1).all()
    assert _flash_close(o1, flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("B,S,KV", [(2, 333, 2), (1, 64, 1), (1, 1, 2)])
def test_flash_tf32_prepass_matches_its_plain_version_on_card(B, S, KV, hd):
    """The scratch the kernel's pre-pass writes (K and V^T split into
    tf32 hi and lo, V^T's keys permuted, hd 16 zero-padded to 32 and hd
    112 to 128) equals
    `tf32_prepass_plain`'s, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    L, H = 40, 2 * KV
    q, k, v = _flash_inputs(B, L, H, KV, hd, torch.float32, S, S)
    o = torch.empty_like(q)
    scratch = flash_module.tf32_scratch(B * KV, S, hd, "cuda")
    err = flash_module.call(
        flash_module._kernel_fn("flash_attn_tf32"), q, k, v, o, causal=True,
        NB=B * KV, KV=KV, G=H // KV, L=L, S=S,
        strides=flash_module.model_strides(q, k), scratch=scratch)
    torch.cuda.synchronize()
    assert err == 0
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(B * KV, S, hd)
    ks, vts = flash_module.tf32_prepass_plain(fold(k), fold(v))
    assert torch.equal(scratch, torch.cat([ks.reshape(-1), vts.reshape(-1)]))

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_mha_folded_layout_on_card(dtype, hd):
    """The folded [N, G*L, hd] layout with seq_len: the kernels read it
    through other strides than the model layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(*s, generator=g).to("cuda", dtype)
               for s in ((4, 150, hd), (4, 50, hd), (4, 50, hd)))
    before = _launch_counts()
    o = flash_mha(q, k, v, seq_len=50)
    torch.cuda.synchronize()
    assert _served_by(before, q, 1)
    assert _flash_close(o, flash_mha_plain(q, k, v, seq_len=50))
    assert torch.equal(o, flash_mha(q, k, v, seq_len=50))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,S,H,KV,hd", [
    (1, 200, 200, 14, 2, 64),     # 128-row tiles straddle fold groups
    (1, 1000, 1000, 14, 2, 64),
    (2, 300, 130, 14, 2, 64),     # fewer keys than queries (L < S + W)
    (1, 200, 333, 12, 2, 128),    # more keys than queries, ragged
    (1, 640, 640, 32, 8, 128),
    (2, 333, 333, 4, 2, 32),
    (1, 300, 300, 4, 2, 16),
    (1, 130, 130, 32, 32, 112),
    (3, 77, 77, 4, 1, 112),
])
@pytest.mark.parametrize("window", [1, 5, 100, 128, 129, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_window_matches_plain_on_card(B, L, S, H, KV, hd, window,
                                            dtype, causal):
    """Both kernels with a sliding window: W 1 (each row keeps its own
    key alone), below, at and past the 128-key tile, blocks whose first
    tile is wholly masked for some rows, straddling tiles, S != L;
    within the flash gates of their plain version, repeats identical,
    each launch counted as windowed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if L >= S + window:
        pytest.skip("a row would keep no key (the wrappers refuse it)")
    q, k, v = _flash_inputs(B, L, H, KV, hd, dtype, L + S + window, S)
    before, wb = _launch_counts(), flash_mha.window_launches
    o1 = flash_attention(q, k, v, causal=causal, window=window)
    o2 = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _served_by(before, q, 2)
    assert flash_mha.window_launches == wb + 2
    assert torch.equal(o1, o2)
    assert torch.isfinite(o1).all()
    assert _flash_close(o1, flash_attention_plain(q, k, v, causal=causal,
                                                  window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,KV,hd", [(1, 200, 14, 2, 64),
                                         (2, 333, 12, 2, 128),
                                         (1, 300, 4, 2, 32),
                                         (1, 77, 4, 2, 16),
                                         (1, 130, 32, 32, 112)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_window_of_at_least_L_is_the_unwindowed_launch_on_card(
        B, L, H, KV, hd, dtype, causal):
    """A window of L keys or more masks nothing and skips no tile: the
    unwindowed launch's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _flash_inputs(B, L, H, KV, hd, dtype, L + hd)
    want = flash_attention(q, k, v, causal=causal)
    for window in (L, L + 1, 1 << 30):
        assert torch.equal(want, flash_attention(q, k, v, causal=causal,
                                                 window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,L,H,KV,hd,window", [(2, 700, 14, 2, 64, 100),
                                                (1, 333, 4, 2, 32, 1),
                                                (1, 300, 32, 32, 112, 129)])
def test_windowed_attention_gradient_route_on_card(B, L, H, KV, hd, window,
                                                   causal, dtype, tol):
    """`flash_attention_autograd(window=W)` on the card: one windowed
    launch, the bits of `flash_attention`, and its gradient within `tol`
    of max |g| of autograd through `flash_attention_plain(window=W)`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import flash_attention_autograd

    q, k, v = [t.requires_grad_() for t in _flash_inputs(
        B, L, H, KV, hd, dtype, L + window, L)]
    do = torch.randn(B, L, H * hd, device="cuda").to(dtype)
    before = _launch_counts()
    out = flash_attention_autograd(q, k, v, causal=causal, q_block=128,
                                   window=window)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert _served_by(before, q, 1)
    with torch.no_grad():
        assert torch.equal(out, flash_attention(q, k, v, causal=causal,
                                                window=window))
    want = torch.autograd.grad(flash_attention_plain(
        q, k, v, causal=causal, window=window), (q, k, v), do)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert float((g.float() - w.float()).abs().max()) <= tol * max(
            float(w.float().abs().max()), 1e-30)


@pytest.mark.cuda
def test_flash_refuses_offsets_and_strided_views_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for dtype, hd in ((torch.float32, 16), (torch.bfloat16, 64),
                      (torch.bfloat16, 32)):
        q = torch.zeros((1, 8, 2, hd), device="cuda", dtype=dtype)
        kv = torch.zeros((1, 8, 1, hd), device="cuda", dtype=dtype)
        before = _launch_counts()
        shifted = torch.zeros(q.numel() + 1, device="cuda",
                              dtype=dtype)[1:].view(q.shape)
        with pytest.raises(ValueError, match="aligned"):
            flash_attention(shifted, kv, kv)
        with pytest.raises(ValueError, match="contiguous"):
            flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            kv, kv)
        assert _launch_counts() == before


def _fig2_fused(rounds=3):
    from repro_torch.sim import get_scenario
    return get_scenario("fig2_iid").replace(
        total_IT=rounds, ota_mode="faithful", ota_backend="fused")


def _bitwise(a, b, drop=("telemetry", "guard_trips")):
    """Two runs' metrics and final states (without `drop`), bit for bit."""
    from repro_torch.tree import tree_leaves
    assert a.rounds == b.rounds
    for k in ("acc", "loss", "edge_power", "is_power"):
        assert getattr(a, k) == getattr(b, k), k
    la = [(p, x) for p, x in tree_leaves(a.final_state) if p[0] not in drop]
    lb = [(p, x) for p, x in tree_leaves(b.final_state) if p[0] not in drop]
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), p


@pytest.mark.cuda
@pytest.mark.parametrize("driver", ["stepwise", "chunked"])
def test_fig2_telemetry_and_guard_change_no_bit_on_card(driver):
    """fig2_iid fused at the paper's sizes (batch 500): with telemetry
    and the guard (no fault) every other output is the plain run's bit
    for bit; `fused_mac` launches twice a round and seed (stepwise; a
    replay runs no Python); a poison with zero_fill stays finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.ft import FaultPlan
    from repro_torch.sim import SweepRunner
    sc = _fig2_fused()
    run = lambda **kw: SweepRunner([sc], seeds=2, device="cuda",
                                   keep_state=True, driver=driver,
                                   batch="map", **kw).run()[0]
    plain = run()
    before = fused_mac.launches
    both = run(telemetry=True, guard="skip_round")
    if driver == "stepwise":
        assert fused_mac.launches - before == 2 * sc.rounds * 2
    _bitwise(plain, both)
    assert both.exec_info["guard_trips"] == 0
    tele = both.to_record()["telemetry"]
    assert np.isfinite(np.asarray(tele["snr"], np.float64)).all()
    zf = run(guard="zero_fill", faults=FaultPlan.parse("poison=nan@2:0:1"))
    assert np.isfinite(np.asarray(zf.loss)).all()
    assert zf.exec_info["guard_trips"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["2x4", "2x5", "4x5"])
def test_fig2_sharded_equals_single_bitwise_on_card(mesh):
    """The users' gradients run in passes of M users on every engine and
    mesh, so fig2 at batch 500 sharded equals the single engine bit for
    bit on the card, and a checkpoint cut on the single engine resumes
    on the mesh bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import os
    import tempfile

    from repro_torch.exec import ShardedSweepRunner
    from repro_torch.sim import SweepRunner
    sc = _fig2_fused()
    single = SweepRunner([sc], seeds=2, device="cuda", keep_state=True,
                         batch="map").run()[0]
    sharded = ShardedSweepRunner([sc], seeds=2, mesh=mesh,
                                 combine="u_sharded", device="cuda",
                                 keep_state=True).run()[0]
    _bitwise(single, sharded)
    with tempfile.TemporaryDirectory() as d:
        SweepRunner([sc], seeds=2, device="cuda", checkpoint=d,
                    batch="map").run()
        scdir = os.path.join(d, sc.name)
        for f in os.listdir(scdir):
            if f != "round_2.npz":
                os.unlink(os.path.join(scdir, f))
        res = ShardedSweepRunner([sc], seeds=2, mesh=mesh,
                                 combine="u_sharded", device="cuda",
                                 keep_state=True, checkpoint=d,
                                 resume=True).run()[0]
    assert res.exec_info["resumed_from"] == 2
    _bitwise(single, res)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,L,H,KV,hd", [(2, 200, 14, 2, 64),
                                         (1, 333, 4, 2, 32),
                                         (1, 130, 32, 32, 112)])
def test_attention_gradient_route_on_card(B, L, H, KV, hd, causal, dtype,
                                          tol):
    """`flash_attention_autograd` on the card: its forward is the routed
    kernel (one launch, the bits of `flash_attention`), its gradient
    (`attention_vjp`, no kernel of ours) within `tol` of max |g| of
    autograd through `flash_attention_plain` (the same function in
    another order; at bf16 each side rounds once from float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import flash_attention_autograd

    q, k, v = [t.requires_grad_() for t in _flash_inputs(
        B, L, H, KV, hd, dtype, L + hd, L)]
    do = torch.randn(B, L, H * hd, device="cuda").to(dtype)
    before = _launch_counts()
    out = flash_attention_autograd(q, k, v, causal=causal, q_block=128)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert _served_by(before, q, 1)
    with torch.no_grad():
        assert torch.equal(out, flash_attention(q, k, v, causal=causal))
    want = torch.autograd.grad(flash_attention_plain(q, k, v, causal=causal),
                               (q, k, v), do)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert float((g.float() - w.float()).abs().max()) <= tol * float(
            w.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("build", ["build_train_step",
                                     "build_fused_train_step"])
def test_train_step_on_card_matches_cpu(build):
    """Reduced qwen2-0.5b at float32 compute, TF32 off: 2 steps (outer
    "add", equivalent channel) on the card against the CPU from one
    state, losses and edge powers within 1e-4, the parameters within
    1e-4 of max |theta| (the forward's attention on the float32
    tensor-core kernel, its gradient through `attention_vjp`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2-0.5b").reduced().with_(compute_dtype="float32")
    shape = InputShape("tiny", 64, 8, "train")
    tcfg = train.TrainConfig(users_per_cluster=2, eta_local=0.05,
                             outer="add", grad_accum=2)
    params = lm.init_params(prng.PRNGKey(0), cfg)
    g = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab, (8, 64), generator=g,
                              dtype=torch.int32) for k in ("tokens",
                                                           "labels")}
    out = {}
    for dev in ("cuda", "cpu"):
        step, _ = getattr(train, build)(cfg, shape, {"data": 4}, tcfg,
                                          device=dev)
        state = {"params": tree_map(lambda t: t.clone().to(dev), params),
                 "opt": {}, "step": torch.zeros((), dtype=torch.int32,
                                                device=dev)}
        ms = []
        for i in range(2):
            state, m = step(state, {k: v.to(dev) for k, v in batch.items()},
                            prng.PRNGKey(i))
            ms.append([float(m["loss"]), float(m["edge_power"])])
        out[dev] = (np.array(ms), dict(tree_leaves(state["params"])))
    (m_card, p_card), (m_cpu, p_cpu) = out["cuda"], out["cpu"]
    assert np.all(np.abs(m_card - m_cpu) <= 1e-4 * np.abs(m_cpu))
    theta = max(float(t.abs().max()) for t in p_cpu.values())
    assert max(float((p_card[k].cpu() - t).abs().max())
               for k, t in p_cpu.items()) <= 1e-4 * theta
