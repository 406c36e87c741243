"""mixtral-8x22b — MoE 8 experts top-2, sliding-window attn [arXiv:2401.04088]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe", num_layers=56, d_model=6144,
    num_heads=48, num_kv_heads=8, head_dim=128, d_ff=16384,
    vocab_size=32768, num_experts=8, experts_per_token=2,
    block_pattern=("swa",), window=4096,
)
