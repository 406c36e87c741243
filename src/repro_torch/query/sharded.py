"""Row-wise table sharding over a mesh + per-shard query execution
(counterpart of repro/query/sharded.py).

Each shard holds a contiguous row range of every column. Rows are padded
so one shard boundary works for every column: rows_per_shard is a
multiple of every column's codes-per-word (lcm), hence each column's word
array splits evenly on the same row boundaries despite mixed code widths,
and validity masks cancel all padding rows.

On one card the shards are virtual (launch.mesh): each column's padded
words view as (n_shards, words_per_shard) and the batched kernels run
with the shard as their chunk axis, one launch for all shards
(query.physical.shard_rows); the reference's psum/pmin/pmax combine is
`physical.combine_rows` and its all-gather a (n_shards, G, 3) stack.
The paper's provisioning model maps as the reference maps it, chips =
shards (QueryEngine.model_check), so there a chip is a virtual shard.

Dispatch counts follow the reference's: it counts when it traces the
shard_map it caches per query shape, so a shape counts at its first
execution on a table and not again (`_traced`); the grouped fallback
counts n_shards at every call.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.db.columnar import prefix_valid
from repro_torch.kernels import dispatch
from repro_torch.kernels.aggregate import ops as agg_ops
from repro_torch.kernels.group_aggregate import ops as gops
from repro_torch.kernels.scan_filter.ref import unpack, unpack_mask
from repro_torch.query import physical, relational
from repro_torch.query.physical import ColumnSlice
from repro_torch.query.plan import columns_of


def _mode_key(mode):
    return None if mode is None else str(mode)


@dataclass
class ShardedTable:
    """A repro_torch.db Table partitioned row-wise along one mesh axis."""

    table: Any                      # the logical Table
    mesh: Any
    axis: str
    rows_per_shard: int
    slices: dict[str, ColumnSlice]  # shard-padded words and validity
    _traced: set = field(default_factory=set, repr=False)
    _ranges: dict = field(default_factory=dict, repr=False)

    @property
    def num_rows(self) -> int:
        return self.table.num_rows

    @property
    def n_shards(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def columns(self):              # metadata view, same duck type as Table
        return self.table.columns

    @property
    def name(self) -> str:
        return self.table.name

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def nbytes(self) -> int:
        """Device-resident bytes (includes shard-alignment padding)."""
        return sum(int(s.words.numel()) * 4 for s in self.slices.values())

    @classmethod
    def shard(cls, table, mesh, axis: str = "data") -> "ShardedTable":
        """Pad every column to rows_per_shard * n_shards rows, with fresh
        validity masks. A column that needs no padding keeps the table's
        own words and validity mask (no copy; the same bits)."""
        if not table.columns:
            raise ValueError("cannot shard an empty table")
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis!r}; axes are "
                             f"{tuple(mesh.shape)}")
        if table.device != mesh.device:
            raise ValueError(f"table {table.name!r} lives on {table.device} "
                             f"but the mesh on {mesh.device}")
        n = int(mesh.shape[axis])
        rps = physical.align_chunk_rows(table.columns,
                                        max(1, -(-table.num_rows // n)))
        total_rows = rps * n
        slices = {}
        for name, col in table.columns.items():
            n_words = total_rows // col.codes_per_word
            if n_words == col.words.numel():
                # no padding: the table's words, and its validity mask,
                # which is this prefix mask
                slices[name] = ColumnSlice(col.words, col.valid_words,
                                           col.code_bits)
                continue
            words = torch.zeros(n_words, dtype=torch.int32,
                                device=mesh.device)
            words[:col.words.numel()] = col.words
            slices[name] = ColumnSlice(
                words, prefix_valid(n_words, table.num_rows, col.code_bits,
                                    mesh.device), col.code_bits)
        return cls(table, mesh, axis, rps, slices)

    # --- tier accounting --------------------------------------------------
    def chunk_bytes(self, plan, aggregates,
                    chunk_rows: int) -> dict[tuple[str, int], int]:
        """Per-(column, chunk) device-resident bytes this query streams
        (shard-alignment padding included), in the padded row space."""
        return physical.chunk_universe(
            self.slices,
            physical.align_chunk_rows(self.table.columns, chunk_rows),
            names=self._referenced(plan, tuple(aggregates)))

    # --- execution --------------------------------------------------------
    def _referenced(self, plan, aggregates: tuple) -> tuple:
        return tuple(sorted(columns_of(plan) | set(aggregates)))

    def _rows(self, plan, aggregates: tuple, mode, tag: str) -> dict:
        """{agg_column: (n_shards, 5) rows}, dispatches counted once per
        (plan, aggregates, mode, tag)."""
        key = (plan, aggregates, _mode_key(mode), tag)
        with dispatch.muted(key in self._traced):
            rows = physical.shard_rows(plan, aggregates, self.slices,
                                       self.n_shards, mode)
        self._traced.add(key)
        return rows

    def execute(self, plan, aggregates, mode=None) -> dict:
        """Scan+aggregate of every shard in one launch, combined across
        shards; returns {agg_column: {sum, count, min, max}} as exact host
        ints."""
        aggregates = tuple(aggregates)
        rows = self._rows(plan, aggregates, mode, "execute")
        return physical.finalize_aggs({c: physical.combine_rows(r)
                                       for c, r in rows.items()})

    def execute_partials(self, plan, aggregates, mode=None) -> list[dict]:
        """Per-shard finalized aggregates in shard order (exact host ints):
        the degraded-mode combine surface. Merging all partials equals
        `execute`."""
        aggregates = tuple(aggregates)
        rows = self._rows(plan, aggregates, mode, "partials")
        host = {c: r.tolist() for c, r in rows.items()}
        return [{c: agg_ops.finalize_row(host[c][i]) for c in aggregates}
                for i in range(self.n_shards)]

    # --- degraded-mode recovery source ------------------------------------
    def shard_row_range(self, shard: int) -> tuple[int, int]:
        """Logical (unpadded) row range [lo, hi) shard `shard` owns; empty
        when the shard holds only alignment padding."""
        if shard < 0 or shard >= self.n_shards:
            raise ValueError(f"shard={shard} outside [0, {self.n_shards})")
        lo = shard * self.rows_per_shard
        return lo, max(lo, min(lo + self.rows_per_shard, self.num_rows))

    def host_shard_slices(self, shard: int, names=None
                          ) -> dict[str, ColumnSlice]:
        """One shard's row range bound from the logical table's words, on
        the device where that table lives: the capacity-tier replica
        degraded execution re-reads when that shard's copy is lost.
        rows_per_shard is word-aligned for every column, so the word slice
        is exact (a view); a fresh validity mask cancels rows past
        num_rows."""
        lo, hi = self.shard_row_range(shard)
        out = {}
        for name in (sorted(names) if names is not None else
                     self.table.columns):
            col = self.table.columns[name]
            cpw = col.codes_per_word
            w0 = lo // cpw
            w1 = min(w0 + self.rows_per_shard // cpw, int(col.words.numel()))
            words = col.words[w0:w1]
            out[name] = ColumnSlice(
                words, prefix_valid(int(words.numel()), hi - lo,
                                    col.code_bits, words.device),
                col.code_bits)
        return out

    # --- grouped execution (GroupBy / HashJoin) ---------------------------
    def key_code_range(self, key: str) -> tuple[int, int]:
        """Observed (kmin, kmax) of a column's codes over the logical
        rows, cached per column (codes are immutable)."""
        hit = self._ranges.get(key)
        if hit is None:
            col = self.table.columns[key]
            codes = unpack(col.words, col.code_bits)[:col.num_rows]
            hit = self._ranges[key] = (
                tuple(int(x) for x in torch.aminmax(codes))
                if codes.numel() else (0, -1))
        return hit

    def execute_grouped_planes(self, plan, key: str, aggs: tuple, domain,
                               mode=None) -> dict:
        """Per-shard grouped accumulator planes, the all-gather combine
        surface: {value_column_or_'': (n_shards, n_groups, 3)} int32 stacks
        on the device, one normalized [sum_lo, sum_hi, count] plane per
        shard per value column (one '' plane when aggs is empty).

        One group_sum_count_batched launch per value column with the shard
        as its chunk axis. Each shard's unpacked codes pad to a multiple
        of LANES with sel = 0 (rows_per_shard is aligned to codes-per-word,
        not to LANES). `domain` holds sorted group keys in THIS table's
        code domain (the delta domain for the encoded view)."""
        aggs = tuple(aggs)
        names = self._referenced(plan, aggs + (key,))
        n, rps = self.n_shards, self.rows_per_shard
        cols = {nm: unpack(self.slices[nm].words,
                           self.slices[nm].code_bits).view(n, rps)
                for nm in names}
        valid = unpack_mask(self.slices[key].valid,
                            self.slices[key].code_bits).view(n, rps)
        sel = relational.eval_plan_codes(plan, cols) & valid
        pad = (-rps) % gops.LANES

        def lift(x):
            if pad:
                x = torch.nn.functional.pad(x, (0, pad))
            return x.reshape(n, -1, gops.LANES)

        keys3 = lift(cols[key])
        sel3 = lift(sel.to(torch.int32))
        out = {}
        cache_key = (plan, key, aggs, _mode_key(mode), "grouped")
        with dispatch.muted(cache_key in self._traced):
            for name in (aggs if aggs else ("",)):
                vals3 = lift(cols[name]) if name \
                    else torch.zeros_like(keys3)
                out[name] = gops.group_sum_count_batched(
                    keys3, vals3, sel3, domain, mode=mode)
        self._traced.add(cache_key)
        return out

    def execute_grouped(self, query, mode=None) -> dict:
        """GroupBy/HashJoin across the shards: per-shard dense accumulator
        planes merged in exact ints. Group domains past the dense cutoff
        fall back to the oracle on the logical table (counted as n_shards
        group_aggregate_fallback launches)."""
        relational.bind_check(query, self.table.columns)
        if self.num_rows == 0:
            return relational.empty_result()
        kmin, kmax = self.key_code_range(query.key)
        domain = relational.group_domain(query, kmin, kmax,
                                         device=self.device)
        if len(domain) == 0:
            return relational.empty_result()
        if not relational.dense_ok(domain):
            dispatch.count_launch("group_aggregate_fallback",
                                  self.n_shards)
            return relational.execute_grouped_oracle(query, self.table)
        planes = self.execute_grouped_planes(
            query.plan(), query.key, query.aggs, domain, mode=mode)
        return absorb_shard_planes(query, planes, domain)


def absorb_shard_planes(query, planes: dict, domain, *, keep=None,
                        bases=None, key_base: int = 0,
                        part=None) -> dict:
    """Fold (n_shards, G, 3) planes into a host partial and finalize it.

    The shards' normalized planes add in int64 on the device (the partial
    algebra is associative in exact ints), so each value column absorbs
    once. `keep` is a boolean mask of the shards to take (degraded
    execution drops the lost ones); `bases` maps value columns to their
    FOR base, `key_base` shifts the keys back to logical codes (the delta
    view); `part` is a partial to add to."""
    part = relational.new_partial() if part is None else part
    first = query.aggs[0] if query.aggs else ""
    for name, stack in planes.items():
        r = stack.to(torch.int64)
        if keep is not None:
            r = r[keep]
        s = ((r[..., 1] << 16) + r[..., 0]).sum(0)
        plane = torch.stack([s & 0xFFFF, s >> 16, r[..., 2].sum(0)], 1)
        relational.absorb_plane(part, domain, plane, name or None,
                                base=(bases or {}).get(name, 0),
                                key_base=key_base,
                                count_source=(name == first))
    return relational.finalize(part)
