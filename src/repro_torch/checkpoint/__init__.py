from repro_torch.checkpoint.store import (latest, load, read_meta, save,
                                          save_step)

__all__ = ["save", "load", "latest", "read_meta", "save_step"]
