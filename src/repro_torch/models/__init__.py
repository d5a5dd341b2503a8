from repro_torch.models import paper_models

__all__ = ["paper_models"]
