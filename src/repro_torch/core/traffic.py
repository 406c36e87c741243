"""Analytic per-device HBM + interconnect traffic model (counterpart of
repro/core/traffic.py).

Following the paper's own methodology (a back-of-the-envelope
bytes-accessed model, Eqs. 1-10), this module derives the memory and
collective roofline terms of one step analytically from the architecture
+ shape + sharding strategy, rather than from a compiler's byte counts,
which also count dtype conversions and layout copies the device would
never issue.

Strategies: "megatron" (baseline TP+FSDP+DP), "dp" (no TP), "cp"
(context parallel), "2d" (decode 2D weight residency).

Conventions:
- weights/activations bf16 (2 B), optimizer state + master fp32,
  logits read for CE in fp32.
- FSDP weight traffic: all-gather writes the gathered copy to HBM, matmuls
  read it back (per pass). Block remat adds one forward re-read+re-gather.
- flash/blockwise attention: no score materialization; K/V re-read once per
  1024-row query block (causal halves it).
- ACT_ALPHA: residual-stream read/write passes per layer that survive
  fusion (x-in, norm, mixer out, +res, ffn in/out ~= 6 each way).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, ShapeSpec

BF16 = 2
F32 = 4
ACT_ALPHA = 6.0
QBLOCK = 1024


@dataclass(frozen=True)
class MeshShape:
    chips: int
    tp: int          # |model|
    fsdp: int        # |data| (x |pod| when params use it)
    dp: int          # batch shards = chips / tp (pod x data)

    @classmethod
    def production(cls, multi_pod: bool):
        """The reference's production mesh: 256 chips (512 with
        multi_pod), a 16-way model axis."""
        chips = 512 if multi_pod else 256
        tp = 16
        dp = chips // tp
        return cls(chips=chips, tp=tp, fsdp=dp, dp=dp)


@dataclass(frozen=True)
class Layout:
    """Strategy-resolved sharding factors."""
    tp: int            # weight TP shards (activation all-reduce group)
    fsdp: int          # weight FSDP shards (gather group)
    dp: int            # batch shards
    seq_shard: int     # sequence shards (context parallelism)
    regather_decode: bool  # weights re-gathered per decode step

    @property
    def token_shards(self) -> int:
        return self.dp * self.seq_shard


def layout_for(strategy: str, mesh: MeshShape) -> Layout:
    if strategy == "megatron":
        return Layout(tp=mesh.tp, fsdp=mesh.fsdp, dp=mesh.dp, seq_shard=1,
                      regather_decode=True)
    if strategy in ("dp", "dp_noremat"):
        return Layout(tp=1, fsdp=mesh.fsdp, dp=mesh.chips, seq_shard=1,
                      regather_decode=True)
    if strategy == "cp":
        return Layout(tp=1, fsdp=mesh.fsdp, dp=mesh.dp,
                      seq_shard=mesh.tp, regather_decode=True)
    if strategy in ("2d", "2d_splitcache"):
        # weights resident (fsdp x tp)-sharded; activations reduced instead
        return Layout(tp=mesh.tp, fsdp=mesh.fsdp, dp=mesh.dp, seq_shard=1,
                      regather_decode=False)
    raise ValueError(strategy)


def _attention_layers(cfg: ArchConfig) -> int:
    return sum(1 for i in range(cfg.num_layers)
               if cfg.pattern_at(i) in ("attn", "swa"))


def _state_bytes_per_row(cfg: ArchConfig) -> float:
    """Recurrent state bytes per batch row (SSM / RG-LRU archs)."""
    total = 0.0
    for i in range(cfg.num_layers):
        k = cfg.pattern_at(i)
        if k == "ssd":
            total += cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * F32
            total += (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * BF16
        elif k == "rglru":
            total += cfg.resolved_lru_width * (F32 + (cfg.ssm_conv - 1) * BF16)
    return total


def _kv_bytes_per_row(cfg: ArchConfig, seq_len: int) -> float:
    per_layer = 0.0
    for i in range(cfg.num_layers):
        k = cfg.pattern_at(i)
        if k == "attn":
            per_layer += seq_len * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * BF16
        elif k == "swa":
            win = min(cfg.window or seq_len, seq_len)
            per_layer += win * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * BF16
    return per_layer


def hbm_traffic(cfg: ArchConfig, shape: ShapeSpec, mesh: MeshShape,
                strategy: str = "megatron") -> dict:
    """Per-device HBM bytes for one step. Returns breakdown + total."""
    lay = layout_for(strategy, mesh)
    n = cfg.param_count()
    w_gathered = BF16 * n / lay.tp           # weights a chip touches/pass
    d = cfg.d_model
    v = cfg.vocab_size
    vocab_shards = lay.tp
    out: dict[str, float] = {}

    if shape.kind == "train":
        tok_local = shape.tokens_per_step / lay.token_shards
        remat_passes = 1.0 if cfg.remat != "none" else 0.0
        # gather-write + read, for fwd / bwd(dL/dx) / remat re-forward
        out["weights"] = w_gathered * 2 * (2.0 + remat_passes)
        out["grads"] = w_gathered * 2            # write local, read for RS
        out["optimizer"] = (n / (lay.tp * lay.fsdp)) * (
            3 * F32 * 2          # m, v, master read+write
            + F32                # reduced grad shard read
            + BF16)              # bf16 param write
        out["activations"] = (cfg.num_layers * ACT_ALPHA * 2  # fwd+bwd
                              * tok_local * d * BF16)
        rows_local = shape.global_batch / lay.dp
        # blockwise attention: all K/V (<= window) re-read once per query
        # block (causal ~halves it); kv heads sharded tp-way; 3 passes
        out["attention_kv"] = (_kv_bytes_per_row(cfg, shape.seq_len)
                               * rows_local
                               * 0.5 * (shape.seq_len / QBLOCK)
                               / (lay.tp * lay.seq_shard) * 3)
        ce_bytes = BF16 + F32 if not cfg.fused_ce else BF16 * 0.25
        out["logits_ce"] = tok_local * (v / vocab_shards) * ce_bytes * 2
    elif shape.kind == "prefill":
        tok_local = shape.tokens_per_step / lay.token_shards
        rows_local = shape.global_batch / lay.dp
        out["weights"] = w_gathered * 2
        out["activations"] = cfg.num_layers * ACT_ALPHA * tok_local * d * BF16
        out["attention_kv"] = (_kv_bytes_per_row(cfg, shape.seq_len)
                               * rows_local
                               * 0.5 * (shape.seq_len / QBLOCK)
                               / (lay.tp * lay.seq_shard))
        out["cache_write"] = (_kv_bytes_per_row(cfg, shape.seq_len)
                              * shape.global_batch / mesh.chips)
        out["logits_ce"] = rows_local * (v / vocab_shards) * BF16
    else:  # decode
        b = shape.global_batch
        n_act = cfg.active_param_count()
        if lay.regather_decode:
            # ZeRO-inference: params re-gathered each step (write + read)
            out["weights"] = BF16 * n_act / lay.tp * 2
        else:
            # 2D-resident: each chip reads only its own shard
            out["weights"] = BF16 * n_act / (lay.tp * lay.fsdp)
        cache_global = (_kv_bytes_per_row(cfg, shape.seq_len)
                        + _state_bytes_per_row(cfg)) * b
        out["cache_read"] = cache_global / mesh.chips
        out["cache_write"] = (_kv_bytes_per_row(cfg, 1)
                              + _state_bytes_per_row(cfg)) * b / mesh.chips
        out["activations"] = (cfg.num_layers * ACT_ALPHA
                              * max(b / lay.dp, 1) * d * BF16)
        out["logits_ce"] = max(b / lay.dp, 1) * (v / vocab_shards) * F32

    out["total"] = sum(out.values())
    return out


def collective_traffic(cfg: ArchConfig, shape: ShapeSpec, mesh: MeshShape,
                       strategy: str = "megatron") -> dict:
    """Per-device ring bytes crossing chip-to-chip links for one step
    (analytic)."""
    lay = layout_for(strategy, mesh)
    n = cfg.param_count()
    d = cfg.d_model
    rg_f = (lay.fsdp - 1) / lay.fsdp if lay.fsdp > 1 else 0.0
    rg_t = (lay.tp - 1) / lay.tp if lay.tp > 1 else 0.0
    # "dp"/"cp" replicate weights over the model axis -> grads also need an
    # all-reduce across it
    model_rep = mesh.tp if lay.tp == 1 and lay.seq_shard == 1 else 1
    rg_rep = (model_rep - 1) / model_rep if model_rep > 1 else 0.0
    cp = lay.seq_shard
    rg_cp = (cp - 1) / cp if cp > 1 else 0.0
    w_gathered = BF16 * n / lay.tp
    out: dict[str, float] = {}

    def ep_alltoall(tokens_local: float, passes: float) -> float:
        """MoE expert-parallel dispatch: each routed token copy crosses the
        expert-sharding axis there and back (all-to-all), per MoE layer.
        Applies only when experts are actually EP-sharded (E >= |model|
        under megatron rules; replicated experts under dp/cp dispatch
        locally)."""
        if not cfg.num_experts or lay.tp == 1 \
                or cfg.num_experts < mesh.tp:
            return 0.0
        per_layer = (2.0 * tokens_local * cfg.experts_per_token
                     * cfg.d_model * BF16 * rg_t)
        return cfg.num_layers * per_layer * passes

    if shape.kind == "train":
        tok_local = shape.tokens_per_step / lay.token_shards
        rows_local = shape.global_batch / lay.dp
        passes = 3.0 if cfg.remat != "none" else 2.0
        out["fsdp_allgather"] = w_gathered * rg_f * passes
        out["grad_reduce_scatter"] = w_gathered * rg_f
        out["grad_allreduce_rep"] = 2.0 * w_gathered * rg_rep
        # Megatron TP: 2 all-reduces per layer fwd, 2 bwd, on (tok, d) bf16
        out["tp_allreduce"] = (cfg.num_layers * 4
                               * 2.0 * tok_local * d * BF16 * rg_t)
        # CP: K/V all-gathered across seq shards, fwd + bwd
        out["cp_kv_allgather"] = (_kv_bytes_per_row(cfg, shape.seq_len)
                                  * rows_local * rg_cp * 3.0)
        out["ep_alltoall"] = ep_alltoall(tok_local, 3.0)
    elif shape.kind == "prefill":
        tok_local = shape.tokens_per_step / lay.token_shards
        rows_local = shape.global_batch / lay.dp
        out["fsdp_allgather"] = w_gathered * rg_f
        out["tp_allreduce"] = (cfg.num_layers * 2
                               * 2.0 * tok_local * d * BF16 * rg_t)
        out["cp_kv_allgather"] = (_kv_bytes_per_row(cfg, shape.seq_len)
                                  * rows_local * rg_cp)
        out["ep_alltoall"] = ep_alltoall(tok_local, 1.0)
    else:
        b = shape.global_batch
        n_act = cfg.active_param_count()
        rows_local = max(b / lay.dp, 1)
        if lay.regather_decode:
            out["fsdp_allgather"] = BF16 * n_act / lay.tp * rg_f
            out["tp_allreduce"] = (cfg.num_layers * 2
                                   * 2.0 * rows_local * d * BF16 * rg_t)
            out["ep_alltoall"] = ep_alltoall(rows_local, 1.0)
        else:
            # 2D: activations reduced over BOTH axes per layer (partial-sum
            # psum over fsdp + the usual tp all-reduce), weights stay put
            out["act_reduce_2d"] = (cfg.num_layers * 2 * 2.0 * rows_local
                                    * d * BF16 * (rg_t + rg_f))
        out["logits_gather"] = rows_local * cfg.vocab_size / lay.tp * F32 * rg_t

    out["total"] = sum(out.values())
    return out
