"""internvl2-76b — InternViT + InternLM2 backbone [arXiv:2404.16821].

Backbone only: the ViT frontend is a stub; input_specs() provides
precomputed patch embeddings (task spec)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=28672,
    vocab_size=128256, input_mode="embeddings",
)
