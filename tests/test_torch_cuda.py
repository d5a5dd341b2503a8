"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one: a CUDA kernel has no
CPU mode.  They import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch; there, skip the JAX-side conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-4 of the largest output magnitude (the JAX package's own
kernel gate); a kernel and its plain version see the same channels
(drawn alike, or handed in) and differ only in float summation order.
Two launches must give identical bits: the kernels sum in a fixed order
and use no atomics.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (fused_mac, fused_mac_plain, ota_combine,
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
