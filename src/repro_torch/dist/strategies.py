"""Named sharding strategies: per-cell rule overrides + config tweaks
(counterpart of repro/dist/strategies.py; the reference's code, which
uses no framework).

A strategy is a dict of logical-rule overrides layered on top of
`repro_torch.launch.specs.rules_for` (which itself layers on
`repro_torch.dist.sharding.DEFAULT_RULES`). The analytic traffic model
(repro_torch.core.traffic.layout_for) mirrors these semantics when
deriving roofline terms.

- megatron:      baseline TP over |model| + FSDP over |data| + DP.
- dp:            no TP — batch shards over every axis; weights FSDP only.
- dp_noremat:    dp + remat disabled (trade HBM for recompute FLOPs):
                 the step keeps every activation instead of
                 rematerialising each block (repro_torch.models.remat).
- cp:            context parallel — sequence shards over |model|, K/V
                 replicated via the "cp_seq"/"kv_full" hooks in
                 repro_torch.models.attention (for head counts indivisible by
                 |model|).
- 2d:            decode 2D weight residency — weights stay (data x model)
                 sharded, no per-step re-gather.
- 2d_splitcache: 2d + the KV ring sharded over |model| (split-K decode).
"""
from __future__ import annotations

import dataclasses

_NO_TP = {"mlp": None, "vocab": None, "heads": None, "kv_heads": None,
          "experts": None, "expert_mlp": None}

STRATEGIES: dict = {
    "megatron": {},
    "dp": dict(_NO_TP, batch=("pod", "data", "model")),
    "dp_noremat": dict(_NO_TP, batch=("pod", "data", "model")),
    "cp": dict(_NO_TP, cp_seq="model", kv_full=None),
    "2d": {"embed": ("data", "pod"), "batch": ("data",)},
    "2d_splitcache": {"embed": ("data", "pod"), "batch": ("data",),
                      "kv_seq": "model"},
}

# Hillclimbed winners per (arch, shape) cell — populated by sweeps over the
# dry-run grid (repro_torch.launch.dryrun --opt); absent cells use
# "megatron".
OPTIMIZED: dict = {}


def strategy_for(cfg, shape, name: str = "megatron"):
    """Resolve a strategy name to (rules_extra, cfg, name).

    The config comes back possibly adjusted (e.g. dp_noremat disables
    remat) so callers thread it through instead of the original.
    """
    if name is None:
        name = "megatron"
    rules = dict(STRATEGIES[name])
    if name == "dp_noremat":
        cfg = dataclasses.replace(cfg, remat="none")
    return rules, cfg, name
