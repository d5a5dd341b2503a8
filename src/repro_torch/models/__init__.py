from repro_torch.models import lm, paper_models

__all__ = ["lm", "paper_models"]
