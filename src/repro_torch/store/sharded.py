"""Sharded execution over a compressed store: the delta view on a mesh
(counterpart of repro/store/sharded.py).

Row-aligned encodings are what shard: a FOR plane is a plain BitWeaving
plane in delta space, so a compressed table shards by building one global
frame of reference per column (base = column min, payload width = span
width), bit-packing the deltas, and handing that *delta table* to the
unmodified `query.sharded.ShardedTable`: one batched scan over every
shard's compressed words, combined planes, validity masks. Queries
translate into the delta domain on the way in (store.exec.translate_plan)
and aggregates fix up their base on the way out, in exact host ints.

RLE is a chunk-local layout (runs do not align across shard boundaries),
so sharding re-encodes every column, RLE-chosen ones included, into the
global FOR frame; the device-resident bytes the tier/energy ledgers
charge are the delta words. The columns decode and the deltas pack on
the store's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.db.columnar import BitPackedColumn, Table
from repro_torch.query.sharded import ShardedTable, absorb_shard_planes
from repro_torch.store.encode import EncodedTable, width_for_span
from repro_torch.store.exec import (column_codes, fixup_base, pack_codes,
                                    translate_plan)


@dataclass(frozen=True)
class _ColMeta:
    """The metadata surface the engine reads per column: logical width
    for plan validation, physical (device-resident, compressed) bytes
    for admission, logical bytes beside them, and the device (a join's
    bind check)."""
    code_bits: int
    nbytes: int
    logical_nbytes: int
    device: torch.device


class ShardedEncodedTable:
    """An EncodedTable partitioned row-wise along one mesh axis.

    Duck-types ShardedTable where QueryEngine touches it: `columns`,
    `num_rows`, `n_shards`, `nbytes`, `slices`, `device`, `execute`,
    `execute_grouped`, `chunk_bytes`.
    """

    def __init__(self, store: EncodedTable, inner: ShardedTable,
                 frames: dict[str, tuple[int, int]]):
        self.store = store
        self.inner = inner
        self.frames = frames           # column -> (base, payload width)

    @classmethod
    def shard(cls, store: EncodedTable, mesh,
              axis: str = "data") -> "ShardedEncodedTable":
        if not store.columns:
            raise ValueError("cannot shard an empty encoded table")
        delta = Table(f"{store.name}-delta")
        frames: dict[str, tuple[int, int]] = {}
        for name, col in store.columns.items():
            codes = column_codes(col).to(mesh.device)
            if codes.numel():
                lo, hi = (int(x) for x in torch.aminmax(codes))
                base, width = lo, width_for_span(hi - lo)
                words = pack_codes(codes - base, width)
            else:
                base, width = 0, 2
                words = torch.zeros(0, dtype=torch.int32, device=mesh.device)
            frames[name] = (base, width)
            delta.add(BitPackedColumn(name, width, col.num_rows, words))
            del codes
        return cls(store, ShardedTable.shard(delta, mesh, axis), frames)

    # --- metadata ---------------------------------------------------------
    @property
    def columns(self) -> dict[str, _ColMeta]:
        out = {}
        for name, col in self.store.columns.items():
            dev = 4 * int(self.inner.slices[name].words.numel())
            out[name] = _ColMeta(col.code_bits, dev, col.logical_nbytes,
                                 self.device)
        return out

    @property
    def name(self) -> str:
        return self.store.name

    @property
    def device(self) -> torch.device:
        return self.inner.device

    @property
    def num_rows(self) -> int:
        return self.store.num_rows

    @property
    def n_shards(self) -> int:
        return self.inner.n_shards

    @property
    def nbytes(self) -> int:
        """Device-resident compressed bytes (shard padding included)."""
        return self.inner.nbytes

    @property
    def slices(self):
        """Delta-word device slices — the tier placement universe, so
        placement chunks hold compressed bytes."""
        return self.inner.slices

    # --- tier accounting --------------------------------------------------
    def chunk_bytes(self, plan, aggregates, chunk_rows: int) -> dict:
        """Per-(column, chunk) device-resident *compressed* bytes this
        query streams (same chunk ids as PlacementEngine.for_table)."""
        return self.inner.chunk_bytes(plan, aggregates, chunk_rows)

    # --- execution --------------------------------------------------------
    def execute(self, plan, aggregates, mode=None) -> dict:
        """One batched scan over every shard's compressed delta words,
        combined, exact host-int base fix-up; bit-identical to the plain
        table."""
        aggregates = tuple(aggregates)
        raw = self.inner.execute(translate_plan(plan, self.frames),
                                 aggregates, mode=mode)
        return {a: fixup_base(raw[a], self.frames[a][0],
                              self.store.columns[a].code_bits)
                for a in aggregates}

    def execute_grouped(self, query, mode=None) -> dict:
        """GroupBy/HashJoin over the sharded compressed view: the where
        plan translates into the delta domain, the group domain shifts by
        the key's frame base, and the dense kernel runs on delta words
        directly. The host absorb restores logical keys (key_base=kbase)
        and value sums (sum += vbase * count), both exact, so the result
        is bit-identical to every other surface."""
        from repro_torch.kernels import dispatch
        from repro_torch.query import relational
        relational.bind_check(query, self.columns)
        if self.num_rows == 0:
            return relational.empty_result()
        kbase, _ = self.frames[query.key]
        dmin, dmax = self.inner.key_code_range(query.key)
        if dmax < dmin:
            return relational.empty_result()
        domain = relational.group_domain(query, kbase + dmin, kbase + dmax,
                                         device=self.device)
        if len(domain) == 0:
            return relational.empty_result()
        if not relational.dense_ok(domain):
            dispatch.count_launch("group_aggregate_fallback",
                                  self.n_shards)
            return relational.execute_grouped_oracle(
                query, self.store.decode_table())
        planes = self.inner.execute_grouped_planes(
            translate_plan(query.plan(), self.frames), query.key,
            query.aggs, domain - kbase, mode=mode)
        return absorb_shard_planes(
            query, planes, domain - kbase, key_base=kbase,
            bases={a: self.frames[a][0] for a in query.aggs})
