"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

Backbone only: the EnCodec frontend is a stub; input_specs() provides
precomputed frame embeddings (task spec)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio", num_layers=48, d_model=2048,
    num_heads=32, num_kv_heads=32, head_dim=64, d_ff=8192,
    vocab_size=2048, input_mode="embeddings",
)
