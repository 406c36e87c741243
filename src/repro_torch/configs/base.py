"""Architecture + shape configuration for the assigned workload pool."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ArchConfig:
    """One architecture from the assigned pool (exact published dims).

    `block_pattern` is the repeating cycle of mixer types through the stack:
    "attn" (full causal), "swa" (sliding-window causal), "ssd" (Mamba-2),
    "rglru" (Griffin recurrent block). Homogeneous stacks scan over layers;
    patterned stacks scan over pattern groups.
    """

    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int              # query heads (0 for attention-free archs)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    aux_free_bias: bool = False     # moonshot/deepseek-style aux-loss-free routing
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # --- hybrid (RG-LRU) ---
    lru_width: int = 0          # 0 -> d_model
    # --- structure ---
    block_pattern: tuple[str, ...] = ("attn",)
    window: int = 0             # sliding-window size for "swa"/local attn
    input_mode: str = "tokens"  # tokens | embeddings (audio/vlm stub frontends)
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # --- runtime knobs (hillclimbable) ---
    remat: str = "block"        # none | block | dots
    scan_layers: bool = True
    fused_ce: bool = False      # chunked/fused cross-entropy (beyond-paper opt)
    attn_impl: str = "auto"     # auto | naive | blockwise | flash

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return all(b in ("ssd", "rglru") for b in self.block_pattern)

    @property
    def subquadratic(self) -> bool:
        """True if no block attends to unbounded context quadratically."""
        return all(b in ("ssd", "rglru", "swa") for b in self.block_pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    def pattern_at(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        return _param_count(self, active_only=True)

    def reduced(self, **over) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        d = {
            "num_layers": min(self.num_layers, len(self.block_pattern) * 2),
            "d_model": 64,
            "num_heads": min(self.num_heads, 4) or 0,
            "num_kv_heads": min(self.num_kv_heads, 2) or 0,
            "head_dim": 16 if self.num_heads else 0,
            "d_ff": 128 if self.d_ff else 0,
            "vocab_size": 256,
            "num_experts": min(self.num_experts, 4),
            "experts_per_token": min(self.experts_per_token, 2),
            # no-drop capacity so cached/split passes equal the full pass
            # (capacity-based MoE drops depend on segment length)
            "moe_capacity_factor": (float(min(self.num_experts, 4))
                                    / max(min(self.experts_per_token, 2), 1)
                                    if self.num_experts else 1.25),
            "ssm_state": min(self.ssm_state, 16),
            "ssm_head_dim": 16 if self.ssm_state else 64,
            "ssm_chunk": 32,
            "lru_width": 64 if self.lru_width or self.family == "hybrid" else 0,
            "window": min(self.window, 32) if self.window else 0,
            "scan_layers": self.scan_layers,
        }
        d.update(over)
        return dataclasses.replace(self, **d)


def _param_count(c: ArchConfig, active_only: bool = False) -> int:
    hd = c.resolved_head_dim
    total = 0
    if c.input_mode == "tokens":
        total += c.vocab_size * c.d_model     # embedding
    if not c.tie_embeddings:
        total += c.d_model * c.vocab_size     # lm head
    total += c.d_model                        # final norm
    for layer in range(c.num_layers):
        kind = c.pattern_at(layer)
        total += c.d_model                    # pre-mixer norm
        if kind in ("attn", "swa"):
            total += c.d_model * (c.num_heads + 2 * c.num_kv_heads) * hd
            total += c.num_heads * hd * c.d_model
        elif kind == "ssd":
            din, h, n = c.d_inner, c.ssm_heads, c.ssm_state
            total += c.d_model * (2 * din + 2 * n + h)     # in_proj
            total += (din + 2 * n) * c.ssm_conv            # conv
            total += 3 * h                                  # A, dt_bias, D
            total += din                                    # gate norm
            total += din * c.d_model                        # out_proj
        elif kind == "rglru":
            w = c.resolved_lru_width
            total += c.d_model * w * 2          # proj_x, proj_gate
            total += 2 * w * w + 2 * w          # dense r/i gates + biases
            total += w * c.ssm_conv + w         # conv + lambda
            total += w * c.d_model              # out_proj
        if c.d_ff and kind != "ssd":
            total += c.d_model                # pre-ffn norm
            ffn = 3 * c.d_model * c.d_ff      # SwiGLU
            if c.num_experts:
                total += c.d_model * c.num_experts          # router
                if c.aux_free_bias:
                    total += c.num_experts                  # selection bias
                e = c.experts_per_token if active_only else c.num_experts
                total += e * ffn
            else:
                total += ffn
    return total


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell from the assignment."""

    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatch: int = 0     # 0 -> no gradient accumulation

    @property
    def tokens_per_step(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs, per the assignment rules."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("skipped-by-design: full quadratic attention at 512k "
                       "context (see DESIGN.md §3)")
    return True, ""
