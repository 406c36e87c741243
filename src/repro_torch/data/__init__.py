"""Data pipeline: deterministic, checkpoint-restartable (counterpart of
repro/data)."""
from repro_torch.data.pipeline import (DataConfig, Prefetcher, SyntheticLM,
                                       make_global_batch)

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM", "make_global_batch"]
