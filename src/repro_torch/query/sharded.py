"""Row-wise table sharding over a mesh + per-shard query execution
(counterpart of repro/query/sharded.py).

Each shard holds a contiguous row range of every column. Rows are padded
so one shard boundary works for every column: rows_per_shard is a
multiple of every column's codes-per-word (lcm), hence each column's word
array splits evenly on the same row boundaries despite mixed code widths,
and validity masks cancel all padding rows.

On a mesh of virtual positions (launch.mesh.make_mesh(shape, axes)) the
shards live on one device: each column's padded words view as (n_shards,
words_per_shard) and the batched kernels run with the shard as their
chunk axis, one launch for all shards (query.physical.shard_rows); the
reference's psum/pmin/pmax combine is `physical.combine_rows` and its
all-gather a (n_shards, G, 3) stack.

On a mesh of ranks (launch.mesh.RankMesh, make_mesh(..., group=)) each
rank copies only its own shard's row range to its device and runs the
same body on it alone (shard_rows over one shard); only the [sum_lo,
sum_hi, count, min, max] rows (`physical.psum_rows`, an all-reduce over
the axis's subgroup), the (G, 3) grouped planes and the groups of the
wide-key fallback (all-gathers) cross ranks. Every rank of the mesh
calls every method alike (SPMD) and gets the same host ints. The logical
table stays on the host (`table`, moved there by `shard`): the
capacity-tier copy that `host_shard_slices` re-reads onto the rank's
device for degraded execution. `key_code_range` all-reduces the shards'
ranges, and the fallback groups each shard's rows on its rank.

The paper's provisioning model maps as the reference maps it, chips =
shards (QueryEngine.model_check): a virtual shard, or a rank.

Dispatch counts follow the reference's, on every rank: it counts when it
traces the shard_map it caches per query shape, so a shape counts at its
first execution on a table and not again (`_traced`); the grouped
fallback counts n_shards at every call.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.db.columnar import BitPackedColumn, Table, prefix_valid
from repro_torch.dist import world
from repro_torch.kernels import dispatch
from repro_torch.kernels.aggregate import ops as agg_ops
from repro_torch.kernels.aggregate.ref import as_dict
from repro_torch.kernels.group_aggregate import ops as gops
from repro_torch.kernels.scan_filter.ref import unpack, unpack_mask
from repro_torch.query import physical, relational
from repro_torch.query.physical import ColumnSlice
from repro_torch.query.plan import columns_of


def _mode_key(mode):
    return None if mode is None else str(mode)


@dataclass(frozen=True)
class ColumnMeta:
    """The metadata surface the engine reads per column of a table whose
    words are not all on this device: logical width for plan validation,
    physical (device-resident) bytes for admission, logical bytes beside
    them, and the device (a join's bind check)."""
    code_bits: int
    nbytes: int
    logical_nbytes: int
    device: torch.device


@dataclass
class ShardedTable:
    """A repro_torch.db Table partitioned row-wise along one mesh axis.

    `slices` holds the shard-padded words and validity masks the kernels
    read: every shard's on a virtual mesh, this rank's shard's on a rank
    mesh. `layout` has the padded global shapes in both cases."""

    table: Any                      # the logical Table
    mesh: Any
    axis: str
    rows_per_shard: int
    slices: dict[str, ColumnSlice]  # shard-padded words and validity
    _traced: set = field(default_factory=set, repr=False)
    _ranges: dict = field(default_factory=dict, repr=False)
    _layout: dict | None = field(default=None, repr=False)

    @property
    def num_rows(self) -> int:
        return self.table.num_rows

    @property
    def n_shards(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def columns(self):              # metadata view, same duck type as Table
        if not self.ranked:
            return self.table.columns
        return {name: ColumnMeta(col.code_bits, col.nbytes, col.nbytes,
                                 self.device)
                for name, col in self.table.columns.items()}

    @property
    def name(self) -> str:
        return self.table.name

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def ranked(self) -> bool:
        """True on a mesh of ranks: one shard here, the rest elsewhere."""
        return self.mesh.group is not None

    @property
    def layout(self) -> dict[str, ColumnSlice]:
        """Every column's padded global words and validity, as shapes:
        `slices` on a virtual mesh; on a rank mesh, tensors on the meta
        device of n_shards times this rank's shape (nothing allocated).
        The tier universe and byte counts read this."""
        if not self.ranked:
            return self.slices
        if self._layout is None:
            def whole(t):
                return torch.empty(self.n_shards * int(t.numel()),
                                   dtype=t.dtype, device="meta")
            self._layout = {name: ColumnSlice(whole(s.words), whole(s.valid),
                                              s.code_bits)
                            for name, s in self.slices.items()}
        return self._layout

    @property
    def nbytes(self) -> int:
        """Device-resident bytes (includes shard-alignment padding), over
        all shards, as the reference's global arrays count them."""
        return sum(int(s.words.numel()) * 4 for s in self.layout.values())

    @classmethod
    def shard(cls, table, mesh, axis: str = "data") -> "ShardedTable":
        """Pad every column to rows_per_shard * n_shards rows, with fresh
        validity masks. A column that needs no padding keeps the table's
        own words and validity mask (no copy; the same bits). On a rank
        mesh the table (a Table, on the host or this rank's device, or a
        source with `columns`, `num_rows` and `words(name, w0, w1,
        device)`) stays on the host as `table`, and each rank copies its
        shard's range of the words to its device, zero-padded, with a
        fresh validity mask."""
        if not table.columns:
            raise ValueError("cannot shard an empty table")
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis!r}; axes are "
                             f"{tuple(mesh.shape)}")
        ranked = mesh.group is not None
        if ranked and isinstance(table, Table):
            if table.device not in (torch.device("cpu"), mesh.device):
                raise ValueError(f"table {table.name!r} lives on "
                                 f"{table.device}, neither the host nor "
                                 f"this rank's {mesh.device}")
            table = _host_table(table)
        elif not ranked and table.device != mesh.device:
            raise ValueError(f"table {table.name!r} lives on {table.device} "
                             f"but the mesh on {mesh.device}")
        n = int(mesh.shape[axis])
        rps = physical.align_chunk_rows(table.columns,
                                        max(1, -(-table.num_rows // n)))
        if ranked:
            return cls(table, mesh, axis, rps, _rank_slices(
                table, rps, mesh.coords[axis], mesh.device))
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
            self.layout,
            physical.align_chunk_rows(self.table.columns, chunk_rows),
            names=self._referenced(plan, tuple(aggregates)))

    # --- execution --------------------------------------------------------
    def _referenced(self, plan, aggregates: tuple) -> tuple:
        return tuple(sorted(columns_of(plan) | set(aggregates)))

    def _rows(self, plan, aggregates: tuple, mode, tag: str) -> dict:
        """{agg_column: (n_shards, 5) rows} on a virtual mesh, this
        shard's (1, 5) on a rank mesh; dispatches counted once per (plan,
        aggregates, mode, tag)."""
        key = (plan, aggregates, _mode_key(mode), tag)
        with dispatch.muted(key in self._traced):
            rows = physical.shard_rows(plan, aggregates, self.slices,
                                       1 if self.ranked else self.n_shards,
                                       mode)
        self._traced.add(key)
        return rows

    def execute(self, plan, aggregates, mode=None) -> dict:
        """Scan+aggregate of every shard in one launch, combined across
        shards (on a rank mesh: this shard's, all-reduced over the axis);
        returns {agg_column: {sum, count, min, max}} as exact host
        ints."""
        aggregates = tuple(aggregates)
        rows = self._rows(plan, aggregates, mode, "execute")
        if self.ranked:
            total = physical.psum_rows(
                torch.cat([rows[c] for c in aggregates]),
                self.mesh.axis_group(self.axis))
            return physical.finalize_aggs({c: as_dict(total[i]) for i, c
                                           in enumerate(aggregates)})
        return physical.finalize_aggs({c: physical.combine_rows(r)
                                       for c, r in rows.items()})

    def execute_partials(self, plan, aggregates, mode=None) -> list[dict]:
        """Per-shard finalized aggregates in shard order (exact host ints):
        the degraded-mode combine surface. Merging all partials equals
        `execute`. On a rank mesh the shards' rows are all-gathered."""
        aggregates = tuple(aggregates)
        rows = self._rows(plan, aggregates, mode, "partials")
        if self.ranked:
            every = world.all_gather(
                torch.cat([rows[c] for c in aggregates]),
                self.mesh.axis_group(self.axis))
            rows = {c: every[:, i] for i, c in enumerate(aggregates)}
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
        num_rows. On a rank mesh the host copy's range is copied to this
        rank's device."""
        lo, hi = self.shard_row_range(shard)
        out = {}
        for name in (sorted(names) if names is not None else
                     self.table.columns):
            col = self.table.columns[name]
            cpw = col.codes_per_word
            w0 = lo // cpw
            w1 = w0 + self.rows_per_shard // cpw
            if self.ranked:
                words = _source_words(self.table, name, w0, w1, self.device)
            else:
                words = col.words[w0:min(w1, int(col.words.numel()))]
            out[name] = ColumnSlice(
                words, prefix_valid(int(words.numel()), hi - lo,
                                    col.code_bits, words.device),
                col.code_bits)
        return out

    def shard_groups(self, query, plan, shard: int, *, slices=None,
                     key_base: int = 0, bases=None, keep_keys=None
                     ) -> tuple:
        """The fallback's (keys, counts, {agg: sums}) groups of one shard's
        selected rows: from `slices` (this rank's, say) or else re-read
        (host_shard_slices). `plan` is in the slices' code domain;
        `key_base` and `bases` map keys and values to logical codes; only
        keys in `keep_keys` count (a join's build keys, a dense domain)."""
        lo, hi = self.shard_row_range(shard)
        if hi <= lo:
            none = torch.zeros(0, dtype=torch.int64, device=self.device)
            return none, none, {a: none for a in query.aggs}
        names = self._referenced(plan, tuple(query.aggs) + (query.key,))
        if slices is None:
            slices = self.host_shard_slices(shard, names=names)
        cols = {c: unpack(slices[c].words, slices[c].code_bits)[:hi - lo]
                .to(torch.int64) for c in names}
        sel = relational.eval_plan_codes(plan, cols)
        keys = cols[query.key] + key_base
        if keep_keys is not None:
            sel = sel & torch.isin(keys, keep_keys)
        return relational.fallback_groups(
            keys, {a: cols[a] + (bases or {}).get(a, 0) for a in query.aggs},
            sel)

    def ranked_oracle(self, query, plan, *, key_base: int = 0, bases=None,
                      lost=()) -> dict:
        """The grouped fallback on a rank mesh: each rank groups its own
        shard's rows (unless its shard is in `lost`) and the lost shards
        dealt to it in turn (re-read from the capacity tier); the groups
        merge over the axis on every rank. Equal to the oracle over the
        logical table."""
        me, n = self.mesh.coords[self.axis], self.n_shards
        lost = sorted(lost)
        join = (relational.build_keys(query)
                if isinstance(query, relational.HashJoin) else None)
        kw = {"key_base": key_base, "bases": bases, "keep_keys": join}
        parts = [] if me in lost else [
            self.shard_groups(query, plan, me, slices=self.slices, **kw)]
        parts += [self.shard_groups(query, plan, i, **kw)
                  for j, i in enumerate(lost) if j % n == me]
        merged = self.merge_groups(parts, tuple(query.aggs))
        return relational.finalize(
            relational.absorb_groups(relational.new_partial(), *merged))

    def merge_groups(self, parts: list, aggs: tuple) -> tuple:
        """This rank's (keys, counts, sums) parts merged with every other
        rank's over the axis: one all-gather of zero-padded (2 + len(aggs),
        L) int64 stacks, L the longest, then summed per key on the
        device. Every rank gets the same groups."""
        group = self.mesh.axis_group(self.axis)
        rows = [torch.stack([k, c, *(s[a] for a in aggs)])
                for k, c, s in parts]
        mine = torch.cat(rows, 1) if rows else torch.zeros(
            (2 + len(aggs), 0), dtype=torch.int64, device=self.device)
        width = torch.tensor([mine.shape[1]], dtype=torch.int64,
                             device=self.device)
        dist.all_reduce(width, dist.ReduceOp.MAX, group=group)
        stack = torch.zeros((2 + len(aggs), int(width)), dtype=torch.int64,
                            device=self.device)
        stack[:, :mine.shape[1]] = mine
        every = world.all_gather(stack, group).permute(1, 0, 2) \
            .reshape(2 + len(aggs), -1)
        every = every[:, every[1] > 0]
        keys, inv = torch.unique(every[0], return_inverse=True)
        out = torch.zeros((1 + len(aggs), keys.numel()), dtype=torch.int64,
                          device=self.device)
        out.index_add_(1, inv, every[1:])
        return keys, out[0], {a: out[1 + j] for j, a in enumerate(aggs)}

    # --- grouped execution (GroupBy / HashJoin) ---------------------------
    def key_code_range(self, key: str) -> tuple[int, int]:
        """Observed (kmin, kmax) of a column's codes over the logical
        rows, cached per column (codes are immutable); on a rank mesh each
        shard's, all-reduced over the axis."""
        hit = self._ranges.get(key)
        if hit is None and self.ranked:
            s = self.slices[key]
            lo, hi = self.shard_row_range(self.mesh.coords[self.axis])
            codes = unpack(s.words, s.code_bits)[:hi - lo].to(torch.int64)
            big = 1 << 62
            ends = (torch.stack([codes.min(), -codes.max()]) if hi > lo
                    else torch.full((2,), big, device=self.device))
            dist.all_reduce(ends, dist.ReduceOp.MIN,
                            group=self.mesh.axis_group(self.axis))
            hit = self._ranges[key] = ((int(ends[0]), -int(ends[1]))
                                       if int(ends[0]) < big else (0, -1))
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
        code domain (the delta domain for the encoded view). On a rank
        mesh each rank's launch covers its shard, and the planes are
        all-gathered over the axis."""
        aggs = tuple(aggs)
        names = self._referenced(plan, aggs + (key,))
        n = 1 if self.ranked else self.n_shards
        rps = self.rows_per_shard
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
        if self.ranked:
            every = world.all_gather(torch.cat(list(out.values())),
                                     self.mesh.axis_group(self.axis))
            out = {name: every[:, i] for i, name in enumerate(out)}
        return out

    def execute_grouped(self, query, mode=None) -> dict:
        """GroupBy/HashJoin across the shards: per-shard dense accumulator
        planes merged in exact ints. Group domains past the dense cutoff
        fall back to the oracle on the logical table (counted as n_shards
        group_aggregate_fallback launches; on a rank mesh
        `ranked_oracle`)."""
        relational.bind_check(query, self.columns)
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
            if self.ranked:
                return self.ranked_oracle(query, query.plan())
            return relational.execute_grouped_oracle(query, self.table)
        planes = self.execute_grouped_planes(
            query.plan(), query.key, query.aggs, domain, mode=mode)
        return absorb_shard_planes(query, planes, domain)


def _host_table(table):
    """The table with its words on the host (the same object if they are
    there already)."""
    if table.device == torch.device("cpu"):
        return table
    out = Table(table.name)
    for name, col in table.columns.items():
        out.add(BitPackedColumn(name, col.code_bits, col.num_rows,
                                col.words.cpu()))
    return out


def _source_words(source, name: str, w0: int, w1: int, device):
    """Words [w0, w1) of a column of `source` (fewer past its end) as a
    copy on `device`: a Table's slice, or the source's own `words`."""
    if hasattr(source, "words"):
        return source.words(name, w0, w1, device)
    words = source.columns[name].words
    return words[w0:min(w1, int(words.numel()))].to(device, copy=True)


def _rank_slices(source, rps: int, shard: int,
                 device) -> dict[str, ColumnSlice]:
    """Shard `shard`'s range of every column, padded to `rps` rows, copied
    to `device`: the same words and validity bits as that shard's range of
    the padded columns ShardedTable.shard builds on one device."""
    out = {}
    for name, col in source.columns.items():
        wps = rps // col.codes_per_word
        got = _source_words(source, name, shard * wps, (shard + 1) * wps,
                            device)
        words = got if got.numel() == wps else torch.nn.functional.pad(
            got, (0, wps - got.numel()))
        valid = prefix_valid(wps, min(rps, max(0, source.num_rows
                                               - shard * rps)),
                             col.code_bits, device)
        out[name] = ColumnSlice(words, valid, col.code_bits)
    return out


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
