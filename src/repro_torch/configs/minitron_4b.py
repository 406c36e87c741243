"""minitron-4b — pruned Nemotron, GQA [arXiv:2407.14679]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense", num_layers=32, d_model=3072,
    num_heads=24, num_kv_heads=8, head_dim=128, d_ff=9216,
    vocab_size=256000, tie_embeddings=True,  # published 4.19B implies tying
)
