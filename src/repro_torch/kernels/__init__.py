from repro_torch.kernels.fused_mac import (canonical_block_u, fused_mac,
                                           fused_mac_plain, fused_mac_ref)
from repro_torch.kernels.ops import fused_combine
from repro_torch.prng import assert_draw_invariance, fused_channels

__all__ = ["fused_combine", "fused_mac", "fused_mac_plain", "fused_mac_ref",
           "fused_channels", "assert_draw_invariance", "canonical_block_u"]
