from repro_torch.kernels.fused_mac import (canonical_block_u, fused_mac,
                                           fused_mac_plain, fused_mac_ref)
from repro_torch.kernels.ota_combine import ota_combine, ota_combine_plain
from repro_torch.kernels.ops import fused_combine, mf_combine
from repro_torch.prng import assert_draw_invariance, fused_channels

__all__ = ["fused_combine", "mf_combine", "fused_mac", "fused_mac_plain",
           "fused_mac_ref", "ota_combine", "ota_combine_plain",
           "fused_channels", "assert_draw_invariance", "canonical_block_u"]
