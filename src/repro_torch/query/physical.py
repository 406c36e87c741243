"""Physical query execution: kernel-dispatch operators over packed columns
(counterpart of repro/query/physical.py).

A logical Plan tree binds to a table's packed columns as `ColumnSlice`s
(words + validity mask + width) and executes bottom-up:

- every leaf Pred is a dispatch-routed scan (kernels.scan_filter) whose
  mask is ANDed with the column's validity mask, so rows that exist only
  as the pack()-to-a-word-multiple tail can never match a predicate;
- AND/OR combine masks word-wise; when children live at different code
  widths the masks are repacked (delimiter-bit layout of one width ->
  boolean rows -> delimiter layout of the other) with plain torch on the
  device, as the reference does with plain jnp;
- each aggregate column reduces the selection through the dispatch-routed
  masked aggregate, and the dominant single-predicate/single-aggregate
  query takes the fused scan+aggregate kernel instead (no mask round trip
  through device memory).

A sharded table (query.sharded) runs `shard_rows`: each column's padded
words view as (n_shards, words_per_shard) and the batched kernels take
the shard as their chunk axis. The counterpart of the reference's
cross-shard psum (`_psum_aggs`, `execute(axis=)`) is `combine_rows` over
the shards of one device, and `psum_rows` over the ranks of a process
group.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.aggregate import ops as agg_ops
from repro_torch.kernels.aggregate.ref import as_dict
from repro_torch.kernels.scan_aggregate import ops as fused_ops
from repro_torch.kernels.scan_filter import ops as scan_ops
from repro_torch.kernels.scan_filter.ref import (SLICE_WORDS, codes_per_word,
                                                 pack_bits, unpack_mask)
from repro_torch.query.plan import And, Or, Plan, Pred, columns_of


@dataclass(frozen=True)
class ColumnSlice:
    """One column's packed words + validity mask, bound for execution.

    `valid` has a delimiter bit set exactly for rows < num_rows; all
    evaluation happens masked by it.
    """
    words: Any                  # (n_words,) int32
    valid: Any                  # (n_words,) int32 delimiter-bit mask
    code_bits: int


def table_slices(table) -> dict[str, ColumnSlice]:
    """Bind a repro_torch.db Table's columns for execution."""
    return {name: ColumnSlice(col.words, col.valid_words, col.code_bits)
            for name, col in table.columns.items()}


def pack_mask(sel, code_bits: int):
    """Inverse of unpack_mask on the device: boolean rows -> packed
    delimiter mask (rows padded to a word multiple with False)."""
    c = codes_per_word(code_bits)
    sel = torch.nn.functional.pad(sel.to(torch.bool), (0, (-sel.shape[0]) % c))
    n_words = sel.shape[0] // c
    out = torch.empty(n_words, dtype=torch.int32, device=sel.device)
    step = SLICE_WORDS * c
    for lo in range(0, n_words, SLICE_WORDS):
        out[lo:lo + SLICE_WORDS] = pack_bits(sel[lo * c:lo * c + step],
                                             code_bits)
    return out


def repack_mask(mask_words, from_bits: int, to_bits: int, to_words: int):
    """Repack a delimiter-bit mask from one code width to another.

    Row counts may differ by padding (each width pads to its own word
    multiple); rows beyond either count are padding and carry zero bits, so
    slicing/zero-extending is exact.
    """
    sel = unpack_mask(mask_words, from_bits)
    rows = to_words * codes_per_word(to_bits)
    if sel.shape[0] >= rows:
        sel = sel[:rows]
    else:
        sel = torch.nn.functional.pad(sel, (0, rows - sel.shape[0]))
    return pack_mask(sel, to_bits)


def bind_check(plan: Plan, aggregates, columns: dict) -> None:
    """Validate a logical plan against table metadata; raises ValueError."""
    known = set(columns)
    missing = (columns_of(plan) | set(aggregates)) - known
    if missing:
        raise ValueError(f"unknown column(s) {sorted(missing)}; table has "
                         f"{sorted(known)}")

    def walk(node):
        if isinstance(node, Pred):
            bits = columns[node.column].code_bits
            vmax = (1 << (bits - 1)) - 1
            if node.constant > vmax:
                raise ValueError(
                    f"constant {node.constant} exceeds the {bits}-bit "
                    f"payload max {vmax} of column {node.column!r}")
        else:
            for c in node.children:
                walk(c)

    walk(plan)


def eval_mask(plan: Plan, slices: dict[str, ColumnSlice], mode=None):
    """Evaluate a predicate tree -> (packed mask, code_bits of its layout).

    The mask layout is the leftmost leaf's width; sibling masks at other
    widths are repacked to it before combining. Always validity-masked.
    """
    if isinstance(plan, Pred):
        s = slices[plan.column]
        m = scan_ops.scan_filter(s.words, plan.constant, plan.op,
                                 s.code_bits, mode=mode)
        return m & s.valid, s.code_bits
    if not isinstance(plan, (And, Or)):
        raise ValueError(f"unknown plan node {type(plan).__name__!r}")
    parts = [eval_mask(c, slices, mode) for c in plan.children]
    out, bits = parts[0]
    combine = torch.bitwise_and if isinstance(plan, And) else torch.bitwise_or
    for m, b in parts[1:]:
        if b != bits or m.shape != out.shape:
            m = repack_mask(m, b, bits, out.shape[0])
        out = combine(out, m)
    return out, bits


def finalize_aggs(out: dict) -> dict:
    """{column: device aggregate dict} -> {column: exact host-int dict}
    with the 16-bit sum planes reassembled (one host copy per column,
    which also waits for the device)."""
    return {col: agg_ops.finalize(d) for col, d in out.items()}


def referenced_bytes(plan: Plan, aggregates, columns: dict) -> int:
    """Bytes a query streams from memory — every referenced column's
    packed footprint (the model's `percent accessed` numerator)."""
    return sum(columns[c].nbytes
               for c in columns_of(plan) | set(aggregates))


def referenced_logical_bytes(plan: Plan, aggregates, columns: dict) -> int:
    """Bytes the query covers in the plain format — equal to
    referenced_bytes on uncompressed tables."""
    return sum(getattr(columns[c], "logical_nbytes", columns[c].nbytes)
               for c in columns_of(plan) | set(aggregates))


# --- chunk-granular accounting (tier placement, a later slice) -------------

def align_chunk_rows(columns: dict, chunk_rows: int) -> int:
    """Round `chunk_rows` up so a row-range boundary is a word boundary
    for every column (multiple of each width's codes-per-word)."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows={chunk_rows} must be >= 1")
    align = math.lcm(*(32 // c.code_bits for c in columns.values()))
    return -(-chunk_rows // align) * align


def column_chunk_bytes(total_words: int, code_bits: int,
                       chunk_rows: int) -> list[int]:
    """Packed bytes per row-chunk of one column (last chunk ragged).
    `chunk_rows` must already be word-aligned for this width."""
    wpc = chunk_rows * code_bits // 32
    return [4 * (min((i + 1) * wpc, total_words) - i * wpc)
            for i in range(-(-total_words // wpc))]


def chunk_universe(source: dict, chunk_rows: int,
                   names=None) -> dict[tuple[str, int], int]:
    """(column, chunk-index) -> bytes over `source` columns (objects with
    `.words`/`.code_bits`). `chunk_rows` must already be aligned
    (align_chunk_rows)."""
    out: dict[tuple[str, int], int] = {}
    for name in (sorted(names) if names is not None else source):
        col = source[name]
        if hasattr(col, "chunk_physical_bytes"):
            per_chunk = col.chunk_physical_bytes(chunk_rows)
        else:
            per_chunk = column_chunk_bytes(int(col.words.numel()),
                                           col.code_bits, chunk_rows)
        for i, b in enumerate(per_chunk):
            out[(name, i)] = b
    return out


def referenced_chunk_bytes(plan: Plan, aggregates, columns: dict,
                           chunk_rows: int) -> dict[tuple[str, int], int]:
    """Per-(column, chunk) bytes a query streams: every chunk of every
    referenced column."""
    return chunk_universe(columns, align_chunk_rows(columns, chunk_rows),
                          names=columns_of(plan) | set(aggregates))


def _fused(plan: Plan, aggregates: tuple, slices: dict) -> bool:
    """The single-predicate / single-aggregate shape at one width: the
    fused scan+aggregate kernel's."""
    return (isinstance(plan, Pred) and len(aggregates) == 1
            and slices[plan.column].code_bits
            == slices[aggregates[0]].code_bits
            and slices[plan.column].words.shape
            == slices[aggregates[0]].words.shape)


def execute(plan: Plan, aggregates: tuple, slices: dict[str, ColumnSlice],
            mode=None) -> dict:
    """Run a bound plan -> {agg_column: device aggregate dict}."""
    out: dict[str, dict] = {}
    if _fused(plan, aggregates, slices):
        p, a = slices[plan.column], slices[aggregates[0]]
        out[aggregates[0]] = fused_ops.scan_aggregate(
            p.words, a.words, p.valid, plan.constant, plan.op, p.code_bits,
            mode=mode)
    else:
        mask, mbits = eval_mask(plan, slices, mode)
        for col in aggregates:
            s = slices[col]
            m = mask
            if s.code_bits != mbits or m.shape != s.words.shape:
                m = repack_mask(m, mbits, s.code_bits, s.words.shape[0])
            out[col] = agg_ops.aggregate(s.words, m, s.code_bits, mode=mode)
    return out


# --- the sharded path: the shard as the batched kernels' chunk axis ---------

SPLIT_CHUNKS = 1024     # chunks of one batched launch over the shards, at most
SPLIT_WORDS = 4096      # words a sub-chunk of a shard, at least


@functools.lru_cache(maxsize=None)
def shard_split(words_per_shard: int, max_split: int, min_words: int) -> int:
    """How many equal sub-chunks a shard's words split into for the
    batched kernels: the most, up to `max_split`, that divide the shard
    evenly while each keeps at least `min_words` words (1 when none
    does). The batched kernels run a block a chunk, so eight shards as
    eight chunks would leave all but eight of the card's SMs idle; the
    host packs one predicate triple a chunk, so the split stops at
    SPLIT_CHUNKS chunks a launch."""
    best = 1
    for d in range(1, math.isqrt(words_per_shard) + 1):
        if words_per_shard % d == 0:
            for k in (d, words_per_shard // d):
                if best < k <= max_split \
                        and words_per_shard // k >= min_words:
                    best = k
    return best


def _fold(rows, n_shards: int):
    """(n_shards * k, 5) sub-chunk rows -> (n_shards, 5) normalized int32
    rows: each shard's sub-chunks combine as the shards do."""
    r = rows.to(torch.int64).view(n_shards, -1, 5)
    s = ((r[..., 1] << 16) + r[..., 0]).sum(1)
    return torch.stack([s & 0xFFFF, s >> 16, r[..., 2].sum(1),
                        r[..., 3].min(1).values,
                        r[..., 4].max(1).values], 1).to(torch.int32)


def shard_rows(plan: Plan, aggregates: tuple,
               slices: dict[str, ColumnSlice], n_shards: int,
               mode=None) -> dict:
    """Run a bound plan over shard-padded slices -> {agg_column: (n_shards,
    5) int32 rows}, one normalized [sum_lo, sum_hi, count, min, max] row a
    shard.

    Every column holds n_shards * rows_per_shard rows, so each word plane
    views as (n_shards, words_per_shard), and further as (n_shards * k,
    words_per_shard / k) with k from `shard_split`: the
    batched kernels take the shard (split k ways) as their chunk axis, one
    launch for all shards, and each shard's k rows fold into its row. A
    fused plan is one scan_aggregate_batched launch with the same
    canonical triple for every chunk; any other plan builds its mask
    through eval_mask over the whole padded column (row-wise, so it equals
    the per-shard masks), then one aggregate_batched launch per aggregate
    column. Dispatches count as the unsharded `execute` counts them."""
    def planes(*ts):
        k = n_shards * shard_split(ts[0].numel() // n_shards,
                                   max(1, SPLIT_CHUNKS // n_shards),
                                   SPLIT_WORDS)
        return [t.view(k, -1) for t in ts]

    out: dict = {}
    if _fused(plan, aggregates, slices):
        p, a = slices[plan.column], slices[aggregates[0]]
        bits = p.code_bits
        p3, a3, v3 = planes(p.words, a.words, p.valid)
        out[aggregates[0]] = _fold(fused_ops.scan_aggregate_batched(
            p3, a3, v3, [scan_ops.canonical_pred(plan.op, plan.constant,
                                                 bits)] * p3.shape[0],
            bits, mode=mode), n_shards)
        if plan.op == "le" and plan.constant >= (1 << (bits - 1)) - 1 \
                and dispatch.resolve(mode, p.words):
            # the one-launch op aggregates the validity mask there
            dispatch.count_launch("aggregate")
        return out
    mask, mbits = eval_mask(plan, slices, mode)
    for col in aggregates:
        s = slices[col]
        m = mask
        if s.code_bits != mbits or m.shape != s.words.shape:
            m = repack_mask(m, mbits, s.code_bits, s.words.shape[0])
        w3, m3 = planes(s.words, m)
        out[col] = _fold(agg_ops.aggregate_batched(w3, m3, s.code_bits,
                                                   mode=mode), n_shards)
    return out


def psum_rows(rows, group):
    """(k, 5) rows of this rank -> the (k, 5) rows combined over the ranks
    of `group`, the reference's `_psum_aggs`: all-reduce SUM of sum_lo,
    sum_hi and count, MIN of min, MAX of max. Each rank's sum planes are
    normalized (lo < 2^16), so the int32 all-reduce stays exact, as the
    reference's psum does, below 2^15 ranks and a total of 2^47."""
    import torch.distributed as dist
    sums = rows[:, :3].contiguous()
    lows = rows[:, 3].contiguous()
    highs = rows[:, 4].contiguous()
    dist.all_reduce(sums, dist.ReduceOp.SUM, group=group)
    dist.all_reduce(lows, dist.ReduceOp.MIN, group=group)
    dist.all_reduce(highs, dist.ReduceOp.MAX, group=group)
    return torch.cat([sums, lows[:, None], highs[:, None]], 1)


def combine_rows(rows) -> dict:
    """(n_shards, 5) rows -> one aggregate dict, the counterpart of the
    reference's psum/pmin/pmax combine: the sum planes and counts add (in
    int64, which agrees with the reference's int32 psum below 2^31 rows),
    min takes the min, max the max. A shard of padding only holds the
    identity row, which moves neither."""
    r = rows.to(torch.int64)
    return as_dict(torch.stack([r[:, 0].sum(), r[:, 1].sum(),
                                r[:, 2].sum(), r[:, 3].min(),
                                r[:, 4].max()]))
