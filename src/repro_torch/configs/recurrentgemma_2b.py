"""recurrentgemma-2b — Griffin: RG-LRU + local attention, (R,R,A) cycle
[arXiv:2402.19427]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid", num_layers=26, d_model=2560,
    num_heads=10, num_kv_heads=1, head_dim=256, d_ff=7680,
    vocab_size=256000, lru_width=2560,
    block_pattern=("rglru", "rglru", "swa"), window=2048,
    tie_embeddings=True,
)
