from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                         apply_updates, clip_by_global_norm,
                                         global_norm, momentum, sgd)

__all__ = ["Optimizer", "sgd", "momentum", "adam", "adamw", "apply_updates",
           "global_norm", "clip_by_global_norm"]
