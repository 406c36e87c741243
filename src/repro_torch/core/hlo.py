"""Parse collective ops (+ per-device byte counts) out of compiled HLO text
(counterpart of repro/core/hlo.py; the reference's code, which uses no
framework).

`cost_analysis()` does not report collective traffic, so the roofline's
third term comes from here: every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute in the post-SPMD module, with operand bytes
and replica-group size, converted to per-link ring traffic.

The port compiles no HLO: its dry run (repro_torch.launch.dryrun) builds
the `CollectiveOp`s itself from sharding propagation over a meta-device
run, and shares `CollectiveOp.ring_bytes` and `summarize` with the parser.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1,
    "f8e5m2": 1, "f8e4m3": 1, "f8e4m3b11fnuz": 1, "f8e5m2fnuz": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "c64": 8,
    "s64": 8, "u64": 8, "f64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(
    r"\b(" + "|".join(sorted(_DTYPE_BYTES, key=len, reverse=True))
    + r")\[([0-9,]*)\]")

_OP_RE = re.compile(
    r"=\s*(?:\([^)]*\)|[a-z0-9_]+\[[0-9,]*\][^ ]*)\s+"
    r"(" + "|".join(_COLLECTIVES) + r")(-start)?\(")

_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=\[")
_GROUPS_EXPLICIT_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")


@dataclass(frozen=True)
class CollectiveOp:
    kind: str
    result_bytes: int      # per-device result bytes (sum over tuple parts)
    group_size: int
    line: str

    @property
    def ring_bytes(self) -> float:
        """Per-device bytes crossing links under ring algorithms."""
        g = max(self.group_size, 1)
        n = self.result_bytes
        if self.kind == "collective-permute":
            return float(n)            # point-to-point: no group scaling
        if g == 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * n * (g - 1) / g
        if self.kind == "all-gather":
            return n * (g - 1) / g          # n = gathered (full) bytes
        if self.kind == "reduce-scatter":
            return n * (g - 1)              # n = scattered (small) bytes
        if self.kind == "all-to-all":
            return n * (g - 1) / g
        return float(n)                     # collective-permute


def _shape_bytes(expr: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(expr):
        elems = 1
        if dims:
            for d in dims.split(","):
                elems *= int(d)
        total += elems * _DTYPE_BYTES[dt]
    return total


def parse_collectives(hlo_text: str) -> list[CollectiveOp]:
    ops = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        kind, start = m.group(1), m.group(2)
        # result expression is everything between '=' and the op name
        head = line.split("=", 1)[1].split(kind)[0]
        nbytes = _shape_bytes(head)
        if start:
            nbytes //= 2   # async start carries (operand, result) tuple
        g = 1
        gm = _GROUPS_RE.search(line)
        if gm:
            g = int(gm.group(2))
        else:
            ge = _GROUPS_EXPLICIT_RE.search(line)
            if ge:
                g = len([x for x in ge.group(1).split(",") if x.strip()])
        ops.append(CollectiveOp(kind, nbytes, g, line.strip()[:160]))
    return ops


def summarize(ops) -> dict:
    """Counts, result bytes and ring bytes of `ops` by kind, and totals."""
    ops = list(ops)
    by_kind: dict[str, dict] = {}
    for op in ops:
        d = by_kind.setdefault(op.kind, {"count": 0, "result_bytes": 0,
                                         "ring_bytes": 0.0})
        d["count"] += 1
        d["result_bytes"] += op.result_bytes
        d["ring_bytes"] += op.ring_bytes
    return {
        "ops": by_kind,
        "total_count": len(ops),
        "total_result_bytes": sum(o.result_bytes for o in ops),
        "total_ring_bytes": sum(o.ring_bytes for o in ops),
    }


def collective_summary(hlo_text: str) -> dict:
    return summarize(parse_collectives(hlo_text))
