"""mamba2-1.3b — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm", num_layers=48, d_model=2048,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    block_pattern=("ssd",), tie_embeddings=True,
)
