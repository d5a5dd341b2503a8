from repro_torch.kernels.flash_attn import (attention_vjp, flash_attention,
                                            flash_attention_autograd,
                                            flash_attention_plain, flash_mha,
                                            flash_mha_plain)
from repro_torch.kernels.flash_attn import route as flash_route
from repro_torch.kernels.fused_mac import (canonical_block_u, fused_mac,
                                           fused_mac_partials,
                                           fused_mac_partials_plain,
                                           fused_mac_plain, fused_mac_ref,
                                           fused_noise,
                                           fused_partials_reduce,
                                           fused_partials_reduce_plain)
from repro_torch.kernels.ota_combine import ota_combine, ota_combine_plain
from repro_torch.kernels.ops import fused_combine, mf_combine
from repro_torch.prng import assert_draw_invariance, fused_channels

# every kernel wrapper's launch count: record name -> (wrapper, attribute)
LAUNCH_COUNTERS = {
    "fused_mac": (fused_mac, "launches"),
    "ota_combine": (ota_combine, "launches"),
    "fused_mac_partials": (fused_mac_partials, "launches"),
    "fused_partials_reduce": (fused_partials_reduce, "launches"),
    "flash_mha_wgmma": (flash_mha, "wgmma_launches"),
    "flash_mha_tf32": (flash_mha, "tf32_launches"),
}

__all__ = ["fused_combine", "mf_combine", "fused_mac", "fused_mac_plain",
           "fused_mac_ref", "fused_mac_partials", "fused_mac_partials_plain",
           "fused_noise", "fused_partials_reduce",
           "fused_partials_reduce_plain", "ota_combine", "ota_combine_plain",
           "fused_channels", "assert_draw_invariance", "canonical_block_u",
           "flash_mha", "flash_mha_plain", "flash_attention",
           "flash_attention_plain", "flash_attention_autograd",
           "attention_vjp", "flash_route", "LAUNCH_COUNTERS"]
