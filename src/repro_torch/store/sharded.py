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
charge are the delta words. The frames come from the chunks' recorded
bounds; the columns decode and the deltas pack on the mesh's device
(`_DeltaSource`). On a mesh of ranks the store is the capacity-tier copy
(on the host, say): each rank decodes only the chunks of its own shard's
rows, and `_DeltaSource` re-reads a lost shard's deltas for degraded
execution; the rows and planes cross ranks as ShardedTable's do.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.db.columnar import BitPackedColumn, Table
from repro_torch.query.sharded import (ColumnMeta, ShardedTable,
                                       absorb_shard_planes)
from repro_torch.store.encode import EncodedTable, width_for_span
from repro_torch.store.exec import (_decode_rows, fixup_base, pack_codes,
                                    translate_plan)


@dataclass(frozen=True)
class _Shape:
    """A delta column's shape: what ShardedTable reads of a column it
    does not hold."""
    code_bits: int
    num_rows: int

    @property
    def codes_per_word(self) -> int:
        return 32 // self.code_bits

    @property
    def nbytes(self) -> int:
        return 4 * -(-self.num_rows // self.codes_per_word)


def _codes(col, lo: int, hi: int, device) -> torch.Tensor:
    """Logical codes of rows [lo, hi) of an encoded column on `device`:
    the payloads of the chunks that hold them copied there and decoded
    there."""
    if hi <= lo:
        return torch.zeros(0, dtype=torch.int32, device=device)
    cr = col.chunk_rows
    cids = np.arange(lo // cr, -(-hi // cr))
    rows = _decode_rows(col, cids, cr, device)
    base = col.chunk_arrays().base[cids]
    if base.any():
        rows += torch.from_numpy(base.astype(np.int32)).to(device)[:, None]
    return rows.reshape(-1)[lo - cids[0] * cr:hi - cids[0] * cr]


class _DeltaSource:
    """The delta table of a store, packed on demand a range at a time:
    `ShardedTable.shard`'s source on a rank mesh, and the whole delta
    table's on one device."""

    def __init__(self, store: EncodedTable, frames: dict):
        self.store, self.frames = store, frames
        self.name = f"{store.name}-delta"
        self.num_rows = store.num_rows
        self.columns = {name: _Shape(frames[name][1], col.num_rows)
                        for name, col in store.columns.items()}

    def words(self, name: str, w0: int, w1: int, device) -> torch.Tensor:
        """Delta words [w0, w1) of a column (fewer past its end), packed on
        `device`: the same bits as the whole column's packing there."""
        base, width = self.frames[name]
        cpw = 32 // width
        codes = _codes(self.store.columns[name], w0 * cpw,
                       min(w1 * cpw, self.num_rows), device)
        if not codes.numel():
            return torch.zeros(0, dtype=torch.int32, device=device)
        return pack_codes(codes - base, width)


def _frames(store: EncodedTable) -> dict:
    """The global frames ((base, width) a column) from the chunks'
    recorded bounds: the same as the codes' bounds, with nothing decoded
    (on a rank mesh every rank reads the same host metadata)."""
    frames = {}
    for name, col in store.columns.items():
        bounds = [(c.stats.vmin, c.stats.vmax) for c in col.chunks
                  if c.n_rows]
        if bounds:
            lo = min(b[0] for b in bounds)
            frames[name] = (lo, width_for_span(max(b[1] for b in bounds)
                                               - lo))
        else:
            frames[name] = (0, 2)
    return frames


class ShardedEncodedTable:
    """An EncodedTable partitioned row-wise along one mesh axis.

    Duck-types ShardedTable where QueryEngine touches it: `columns`,
    `num_rows`, `n_shards`, `nbytes`, `slices`, `layout`, `device`,
    `execute`, `execute_grouped`, `chunk_bytes`.
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
        frames = _frames(store)
        source = _DeltaSource(store, frames)
        if mesh.group is None:          # every shard on this device
            delta = Table(source.name)
            for name, shape in source.columns.items():
                delta.add(BitPackedColumn(
                    name, shape.code_bits, shape.num_rows,
                    source.words(name, 0, shape.nbytes // 4, mesh.device)))
            source = delta
        return cls(store, ShardedTable.shard(source, mesh, axis), frames)

    # --- metadata ---------------------------------------------------------
    @property
    def columns(self) -> dict[str, ColumnMeta]:
        out = {}
        for name, col in self.store.columns.items():
            dev = 4 * int(self.inner.layout[name].words.numel())
            out[name] = ColumnMeta(col.code_bits, dev, col.logical_nbytes,
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
        """Delta-word device slices (this rank's shard on a rank mesh)."""
        return self.inner.slices

    @property
    def layout(self):
        """The delta words' padded global shapes — the tier placement
        universe, so placement chunks hold compressed bytes."""
        return self.inner.layout

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
            if self.inner.ranked:
                return self.inner.ranked_oracle(
                    query, translate_plan(query.plan(), self.frames),
                    key_base=kbase,
                    bases={a: self.frames[a][0] for a in query.aggs})
            return relational.execute_grouped_oracle(
                query, self.store.decode_table())
        planes = self.inner.execute_grouped_planes(
            translate_plan(query.plan(), self.frames), query.key,
            query.aggs, domain - kbase, mode=mode)
        return absorb_shard_planes(
            query, planes, domain - kbase, key_base=kbase,
            bases={a: self.frames[a][0] for a in query.aggs})
