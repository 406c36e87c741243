"""Chunk-granular compressed encodings over the bit-packed code planes, on
a torch device (counterpart of repro/store/encode.py).

Three encodings per row chunk, chosen from per-chunk statistics:

- RLE: sorted / low-cardinality chunks become (value, length) run planes,
  padded with zero-length runs to a power of two; scans aggregate on the
  runs (the scan_compressed kernels).
- FOR (frame of reference): `code - min(chunk)` packed at the narrowest
  width whose payload holds the chunk's span. The delta plane is a valid
  BitWeaving plane, so the packed-word kernels scan it at the narrower
  width with a translated constant (store.exec).
- PLAIN: the packed layout of db.columnar; the selector never loses to it
  (PLAIN wins ties).

The reference encodes one chunk at a time in host numpy. Here a column is
encoded on its own device, all chunks together: the codes are reshaped to
(n_chunks, chunk_rows), statistics come from row-wise min/max, a row-wise
sort (distinct values) and row-wise differences (runs), and each group of
chunks sharing an (encoding, width) is packed in one pass. A chunk's
planes are views into its group's tensor. The checksums hash the same
bytes as the reference's (int32 bit views of its uint32 words), from one
host copy per group. Encodings, statistics, planes and checksums equal the
reference's exactly.
"""
from __future__ import annotations

import enum
import math
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.scan_filter import ref as packref

#: Widths the BitWeaving word layout supports (fields divide 32 bits and
#: payloads stay below 2^15 so exact aggregation holds).
WIDTHS = (2, 4, 8, 16)

#: Hard cap on rows per chunk: keeps every per-chunk sum partial
#: (vmax * rows < 2^31) int32-exact and bounds run lengths to int32.
MAX_CHUNK_ROWS = 65536

DEFAULT_CHUNK_ROWS = 4096


class Encoding(str, enum.Enum):
    PLAIN = "plain"
    RLE = "rle"
    FOR = "for"


def width_for_span(span: int) -> int:
    """Narrowest supported field width whose payload (2^(w-1)-1) holds
    `span`."""
    if span < 0:
        raise ValueError(f"span={span} must be non-negative")
    for w in WIDTHS:
        if span <= (1 << (w - 1)) - 1:
            return w
    raise ValueError(f"span={span} exceeds the 16-bit payload max 32767; "
                     f"codes this wide cannot be stored exactly")


def next_pow2(n: int) -> int:
    return 0 if n <= 0 else 1 << (n - 1).bit_length()


def plain_nbytes(n_rows: int, code_bits: int) -> int:
    """Packed bytes of `n_rows` codes at `code_bits` (the logical size a
    chunk streams uncompressed)."""
    cpw = 32 // code_bits
    return 4 * (-(-n_rows // cpw))


@dataclass(frozen=True)
class EncodingStats:
    """Per-chunk statistics the encoding selector decides from."""

    n_rows: int
    n_runs: int
    n_distinct: int
    vmin: int
    vmax: int
    delta_bits: int          # FOR field width for (vmax - vmin)
    plain_nbytes: int
    rle_nbytes: int          # 8 bytes per pow2-padded run (value + length)
    for_nbytes: int          # delta words + 8 bytes (base, width) metadata

    @classmethod
    def of(cls, n_rows: int, n_runs: int, n_distinct: int, vmin: int,
           vmax: int, code_bits: int) -> "EncodingStats":
        if n_rows == 0:
            return cls(0, 0, 0, 0, 0, WIDTHS[0], 0, 0, 0)
        dbits = width_for_span(vmax - vmin)
        return cls(n_rows=n_rows, n_runs=n_runs, n_distinct=n_distinct,
                   vmin=vmin, vmax=vmax, delta_bits=dbits,
                   plain_nbytes=plain_nbytes(n_rows, code_bits),
                   rle_nbytes=8 * next_pow2(n_runs),
                   for_nbytes=plain_nbytes(n_rows, dbits) + 8)

    @classmethod
    def from_codes(cls, codes, code_bits: int) -> "EncodingStats":
        """Statistics of one chunk's codes (host numpy)."""
        codes = np.asarray(codes)
        if len(codes) == 0:
            return cls.of(0, 0, 0, 0, 0, code_bits)
        return cls.of(len(codes), 1 + int(np.count_nonzero(np.diff(codes))),
                      int(len(np.unique(codes))), int(codes.min()),
                      int(codes.max()), code_bits)

    def nbytes(self, encoding: Encoding) -> int:
        return {Encoding.PLAIN: self.plain_nbytes,
                Encoding.RLE: self.rle_nbytes,
                Encoding.FOR: self.for_nbytes}[Encoding(encoding)]


def choose_encoding(stats: EncodingStats) -> Encoding:
    """Smallest physical footprint wins; PLAIN wins ties, so a chosen
    encoding is never larger than the plain format."""
    best = Encoding.PLAIN
    for cand in (Encoding.RLE, Encoding.FOR):
        if stats.nbytes(cand) < stats.nbytes(best):
            best = cand
    return best


def _checksum(encoding: Encoding, n_rows: int, code_bits: int, width: int,
              base: int, n_runs: int, planes) -> int:
    """crc32 over the layout metadata and then each host plane's bytes, in
    the reference's order (words, values, lengths)."""
    crc = zlib.crc32(f"{encoding.value}|{n_rows}|{code_bits}|{width}|"
                     f"{base}|{n_runs}".encode())
    for plane in planes:
        crc = zlib.crc32(np.ascontiguousarray(plane), crc)
    return crc


@dataclass
class EncodedChunk:
    """One row-range of one column in its chosen physical layout.

    PLAIN/FOR hold a packed word plane at `width` (== code_bits for PLAIN,
    the delta width for FOR) plus the matching packed validity mask; the
    codes it stores are `base + packed_field`. RLE holds pow2-padded
    (values, lengths) int32 planes (zero-length runs are padding) plus a
    validity mask at the logical width for the decoded path. Planes are
    int32 tensors on the column's device.
    """

    encoding: Encoding
    n_rows: int
    code_bits: int                        # logical width of decoded codes
    stats: EncodingStats
    width: int = 0                        # payload field width (PLAIN/FOR)
    base: int = 0                         # frame of reference (FOR)
    words: torch.Tensor | None = None     # packed payload (PLAIN/FOR)
    values: torch.Tensor | None = None    # (n_runs_padded,) int32 (RLE)
    lengths: torch.Tensor | None = None   # (n_runs_padded,) int32 (RLE)
    n_runs: int = 0
    valid: torch.Tensor | None = field(default=None, repr=False)
    checksum: int = 0                     # crc32 over payload + layout meta

    @property
    def nbytes(self) -> int:
        """Physical bytes a scan streams for this chunk (a zero-row
        chunk streams nothing, metadata included)."""
        if self.encoding is Encoding.RLE:
            return 4 * (int(self.values.numel()) + int(self.lengths.numel()))
        n = 4 * int(self.words.numel())
        return n + 8 if self.encoding is Encoding.FOR and n else n

    @property
    def logical_nbytes(self) -> int:
        return plain_nbytes(self.n_rows, self.code_bits)

    @property
    def device(self) -> torch.device:
        return (self.values if self.encoding is Encoding.RLE
                else self.words).device

    # --- integrity --------------------------------------------------------
    def payload_checksum(self) -> int:
        """crc32 over the payload planes plus the layout metadata that
        interprets them (one host copy of each plane)."""
        return _checksum(self.encoding, self.n_rows, self.code_bits,
                         self.width, self.base, self.n_runs,
                         [p.cpu().numpy() for p in (self.words, self.values,
                                                    self.lengths)
                          if p is not None])

    def seal(self) -> "EncodedChunk":
        """Stamp the checksum of the current payload."""
        self.checksum = self.payload_checksum()
        return self

    def verify(self) -> bool:
        """Does the stored payload still match its sealed checksum?"""
        return self.payload_checksum() == self.checksum

    def decode(self) -> np.ndarray:
        """Exact logical codes back out of the physical layout (host)."""
        if self.n_rows == 0:
            return np.zeros(0, np.uint32)
        if self.encoding is Encoding.RLE:
            lens = self.lengths.cpu().numpy()[:self.n_runs]
            return np.repeat(self.values.cpu().numpy().astype(np.uint32)
                             [:self.n_runs], lens)
        vals = packref.unpack(self.words, self.width).cpu().numpy()
        return vals[:self.n_rows].astype(np.uint32) + np.uint32(self.base)


def verify_chunks(chunks) -> list[bool]:
    """EncodedChunk.verify() of each chunk, exactly (crc32 over the host
    bytes of each payload plane and the layout metadata), with every
    plane copied to the host in one transfer instead of one a plane."""
    planes = [[p for p in (ch.words, ch.values, ch.lengths) if p is not None]
              for ch in chunks]
    flat = [p.reshape(-1) for ps in planes for p in ps]
    host = (torch.cat(flat).cpu().numpy() if flat
            else np.zeros(0, np.int32))
    out, at = [], 0
    for ch, ps in zip(chunks, planes):
        views = []
        for p in ps:
            views.append(host[at:at + p.numel()])
            at += p.numel()
        out.append(_checksum(ch.encoding, ch.n_rows, ch.code_bits, ch.width,
                             ch.base, ch.n_runs, views) == ch.checksum)
    return out


# --------------------------------------------------------------------------
# encoding, all chunks of a column at once
# --------------------------------------------------------------------------

def pack_rows(codes2: torch.Tensor, width: int) -> torch.Tensor:
    """(k, rows) int32 codes < 2^(width-1) -> (k, ceil(rows / cpw)) int32
    packed words, rows padded with zero codes (the torch counterpart of
    scan_filter.ref.pack, one row per chunk). Fields never reach bit 31,
    so int32 shifts are exact."""
    cpw = 32 // width
    c = torch.nn.functional.pad(codes2, (0, (-codes2.shape[1]) % cpw))
    c = c.reshape(codes2.shape[0], -1, cpw)
    out = c[..., 0].clone()
    for i in range(1, cpw):
        out |= c[..., i] << (i * width)
    return out


class _ValidPlanes:
    """Shared validity planes: every chunk of `n_rows` rows at one width
    has the same mask, so one tensor serves them all."""

    def __init__(self, device):
        self.device = device
        self._planes: dict[tuple[int, int], torch.Tensor] = {}

    def get(self, width: int, n_rows: int) -> torch.Tensor:
        key = (width, n_rows)
        if key not in self._planes:
            cpw = 32 // width
            n_words = -(-n_rows // cpw)
            self._planes[key] = packref.to_torch(packref.pack_mask(
                np.arange(n_words * cpw) < n_rows, width), self.device)
        return self._planes[key]


def _batch_stats(c2: torch.Tensor, code_bits: int) -> list[EncodingStats]:
    """EncodingStats of every row of (k, rows) codes, computed on the
    device (row min/max, run starts, a row-wise sort for distinct values)
    and copied to the host in one piece."""
    rows = c2.shape[1]
    runs = 1 + (c2[:, 1:] != c2[:, :-1]).sum(1)
    srt = c2.sort(dim=1).values
    distinct = 1 + (srt[:, 1:] != srt[:, :-1]).sum(1)
    host = torch.stack([runs, distinct, c2.amin(1).to(torch.int64),
                        c2.amax(1).to(torch.int64)], dim=1).cpu().tolist()
    return [EncodingStats.of(rows, nr, nd, lo, hi, code_bits)
            for nr, nd, lo, hi in host]


def _encode_packed(c2, idx, enc, width, stats, code_bits, valid, out):
    """PLAIN/FOR chunks `idx` of the batch: one pack at `width`."""
    rows = c2.shape[1]
    sub = c2 if len(idx) == c2.shape[0] else c2[torch.tensor(idx,
                                                             device=c2.device)]
    bases = [stats[i].vmin if enc is Encoding.FOR else 0 for i in idx]
    if enc is Encoding.FOR:
        sub = sub - torch.tensor(bases, dtype=torch.int32,
                                 device=c2.device)[:, None]
    words = pack_rows(sub, width)
    host = words.cpu().numpy()
    vplane = valid.get(width, rows)
    for j, i in enumerate(idx):
        out[i] = EncodedChunk(
            enc, rows, code_bits, stats[i], width=width, base=bases[j],
            words=words[j], valid=vplane,
            checksum=_checksum(enc, rows, code_bits, width, bases[j], 0,
                               [host[j]]))


def _encode_rle(c2, idx, stats, code_bits, valid, out):
    """RLE chunks `idx` of the batch: run starts of every chunk at once,
    scattered into one flat buffer of pow2-padded run planes."""
    dev = c2.device
    sub = c2 if len(idx) == c2.shape[0] else c2[torch.tensor(idx,
                                                             device=dev)]
    g, rows = sub.shape
    start = torch.ones((g, rows), dtype=torch.bool, device=dev)
    start[:, 1:] = sub[:, 1:] != sub[:, :-1]
    row_i, col_i = start.nonzero(as_tuple=True)
    nxt = torch.full_like(col_i, rows)
    nxt[:-1] = torch.where(row_i[1:] == row_i[:-1], col_i[1:], rows)
    n_runs = [stats[i].n_runs for i in idx]
    padded = [next_pow2(n) for n in n_runs]
    first = np.concatenate([[0], np.cumsum(n_runs)[:-1]])
    off = np.concatenate([[0], np.cumsum(padded)[:-1]])
    pos = (torch.from_numpy(off - first).to(dev)[row_i]
           + torch.arange(row_i.numel(), device=dev))
    values = torch.zeros(sum(padded), dtype=torch.int32, device=dev)
    lengths = torch.zeros_like(values)
    values[pos] = sub[row_i, col_i]
    lengths[pos] = (nxt - col_i).to(torch.int32)
    hv, hl = values.cpu().numpy(), lengths.cpu().numpy()
    vplane = valid.get(code_bits, rows)
    for j, i in enumerate(idx):
        a, b = int(off[j]), int(off[j]) + padded[j]
        out[i] = EncodedChunk(
            Encoding.RLE, rows, code_bits, stats[i], n_runs=n_runs[j],
            values=values[a:b], lengths=lengths[a:b], valid=vplane,
            checksum=_checksum(Encoding.RLE, rows, code_bits, 0, 0,
                               n_runs[j], [hv[a:b], hl[a:b]]))


def _encode_batch(c2, code_bits, forced, valid) -> list[EncodedChunk]:
    """Encode the k chunks of (k, rows) codes (all of one row count)."""
    stats = _batch_stats(c2, code_bits)
    groups: dict[tuple[Encoding, int], list[int]] = {}
    for i, st in enumerate(stats):
        enc = forced if forced is not None else choose_encoding(st)
        width = {Encoding.PLAIN: code_bits, Encoding.FOR: st.delta_bits,
                 Encoding.RLE: 0}[enc]
        groups.setdefault((enc, width), []).append(i)
    out: list[EncodedChunk | None] = [None] * len(stats)
    for (enc, width), idx in groups.items():
        if enc is Encoding.RLE:
            _encode_rle(c2, idx, stats, code_bits, valid, out)
        else:
            _encode_packed(c2, idx, enc, width, stats, code_bits, valid, out)
    return out


def _payload_max_error(code_bits: int) -> ValueError:
    vmax = (1 << (code_bits - 1)) - 1
    return ValueError(
        f"codes exceed the {code_bits}-bit payload max {vmax}; encode "
        f"after db.columnar validation, not before")


def encode_codes(codes: torch.Tensor, code_bits: int, chunk_rows: int,
                 encoding: Encoding | None = None) -> list[EncodedChunk]:
    """(n,) int32 codes on a device -> the chunks of a column of
    `chunk_rows`-row chunks (the last one ragged), encoded on that device;
    `encoding=None` lets the selector pick per chunk."""
    n = codes.shape[0]
    vmax = (1 << (code_bits - 1)) - 1
    if n and (int(codes.max()) > vmax or int(codes.min()) < 0):
        raise _payload_max_error(code_bits)
    forced = None if encoding is None else Encoding(encoding)
    valid = _ValidPlanes(codes.device)
    n_full, rem = divmod(n, chunk_rows)
    chunks: list[EncodedChunk] = []
    if n_full:
        chunks += _encode_batch(codes[:n_full * chunk_rows].reshape(
            n_full, chunk_rows), code_bits, forced, valid)
    if rem:
        chunks += _encode_batch(codes[n_full * chunk_rows:].reshape(1, rem),
                                code_bits, forced, valid)
    return chunks


def encode_chunk(codes, code_bits: int, encoding: Encoding | None = None,
                 device=None) -> EncodedChunk:
    """Encode one chunk of dictionary codes on `device` (the CUDA device
    unless the caller passes one); `encoding=None` lets the stats selector
    pick. Round-trips exactly (chunk.decode() == codes)."""
    codes = np.ascontiguousarray(codes, np.uint32)
    n = len(codes)
    if n > MAX_CHUNK_ROWS:
        raise ValueError(
            f"chunk of {n} rows exceeds MAX_CHUNK_ROWS={MAX_CHUNK_ROWS} "
            f"(the bound that keeps per-chunk sum partials int32-exact); "
            f"re-chunk the column")
    if n and int(codes.max()) > (1 << (code_bits - 1)) - 1:
        raise _payload_max_error(code_bits)
    device = resolve_device(device)
    if n:
        return encode_codes(torch.from_numpy(codes.view(np.int32)).to(device),
                            code_bits, n, encoding)[0]
    stats = EncodingStats.from_codes(codes, code_bits)
    enc = Encoding(encoding) if encoding is not None \
        else choose_encoding(stats)
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    if enc is Encoding.RLE:
        return EncodedChunk(enc, 0, code_bits, stats, values=empty,
                            lengths=empty.clone(), valid=empty.clone()).seal()
    width = stats.delta_bits if enc is Encoding.FOR else code_bits
    return EncodedChunk(enc, 0, code_bits, stats, width=width, base=0,
                        words=empty, valid=empty.clone()).seal()


@dataclass(frozen=True)
class ChunkArrays:
    """Per-chunk metadata of a column as numpy arrays (one entry a chunk),
    for the per-query work that would otherwise walk thousands of chunk
    objects in Python."""
    n_rows: np.ndarray          # int64
    rle: np.ndarray             # bool: RLE-encoded
    width: np.ndarray           # int64: payload width the chunk scans at
    #                             (the logical width for RLE, decoded)
    base: np.ndarray            # int64: frame of reference (0 unless FOR)
    nbytes: np.ndarray          # int64: physical bytes
    logical_nbytes: np.ndarray  # int64: plain-format bytes


@dataclass
class EncodedColumn:
    """A column as a sequence of independently encoded row chunks.

    Duck-types the metadata surface the query layer needs from
    `db.columnar.BitPackedColumn`: `code_bits`, `num_rows`, `nbytes`
    (physical, compressed: what a scan streams) plus `logical_nbytes`
    (what the plain format would stream).

    `chunks` is a tuple: a chunk's payload is never edited, and replacing
    a chunk (`replace_chunk`) assigns a new tuple, whose identity keys
    every cache derived from the chunks (`cached`).
    """

    name: str
    code_bits: int
    num_rows: int
    chunk_rows: int
    chunks: tuple[EncodedChunk, ...]
    dictionary: np.ndarray | None = None
    _cache: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)
    _cache_of: tuple | None = field(default=None, init=False, repr=False,
                                    compare=False)

    def __post_init__(self):
        self.chunks = tuple(self.chunks)

    def replace_chunk(self, ci: int, chunk: EncodedChunk) -> None:
        """Swap chunk `ci` for `chunk` (a new tuple: the caches follow)."""
        self.chunks = self.chunks[:ci] + (chunk,) + self.chunks[ci + 1:]

    def cached(self, key, build):
        """`build()`'s result, memoized under `key` while the column holds
        the same chunks tuple: for state derived from the chunks alone
        (metadata arrays, bound planes, stacked run planes)."""
        if self._cache_of is not self.chunks:
            self._cache, self._cache_of = {}, self.chunks
        hit = self._cache.get(key)
        if hit is None:
            hit = self._cache[key] = build()
        return hit

    @staticmethod
    def _check_chunk_rows(name: str, chunk_rows: int) -> None:
        if not 1 <= chunk_rows <= MAX_CHUNK_ROWS:
            raise ValueError(
                f"column {name!r}: chunk_rows={chunk_rows} outside "
                f"[1, {MAX_CHUNK_ROWS}]")

    @classmethod
    def from_values(cls, name: str, values, code_bits: int,
                    chunk_rows: int = DEFAULT_CHUNK_ROWS,
                    encoding: Encoding | None = None,
                    dictionary=None, device=None) -> "EncodedColumn":
        """Encode host codes on `device` (the CUDA device unless the
        caller passes one)."""
        values = np.ascontiguousarray(values, np.uint32)
        cls._check_chunk_rows(name, chunk_rows)
        device = resolve_device(device)
        codes = torch.from_numpy(values.view(np.int32)).to(device)
        return cls(name, code_bits, len(values), chunk_rows,
                   encode_codes(codes, code_bits, chunk_rows, encoding),
                   None if dictionary is None else np.asarray(dictionary))

    @classmethod
    def from_column(cls, col, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                    encoding: Encoding | None = None) -> "EncodedColumn":
        """Encode a repro_torch BitPackedColumn on its own device."""
        cls._check_chunk_rows(col.name, chunk_rows)
        codes = packref.unpack(col.words, col.code_bits)[:col.num_rows]
        return cls(col.name, col.code_bits, col.num_rows, chunk_rows,
                   encode_codes(codes, col.code_bits, chunk_rows, encoding),
                   col.dictionary)

    @property
    def device(self) -> torch.device | None:
        return self.chunks[0].device if self.chunks else None

    def chunk_arrays(self) -> ChunkArrays:
        """The chunks' metadata as numpy arrays (cached)."""
        return self.cached("arrays", self._chunk_arrays)

    def _chunk_arrays(self) -> ChunkArrays:
        chs = self.chunks

        def arr(values, dtype=np.int64):
            return np.fromiter(values, dtype, len(chs))

        return ChunkArrays(
            n_rows=arr(c.n_rows for c in chs),
            rle=arr((c.encoding is Encoding.RLE for c in chs), bool),
            width=arr(c.code_bits if c.encoding is Encoding.RLE else c.width
                      for c in chs),
            base=arr(c.base for c in chs),
            nbytes=arr(c.nbytes for c in chs),
            logical_nbytes=arr(c.logical_nbytes for c in chs))

    @property
    def nbytes(self) -> int:
        """Physical (compressed) bytes: the scan-traffic numerator."""
        return int(self.chunk_arrays().nbytes.sum())

    @property
    def logical_nbytes(self) -> int:
        return int(self.chunk_arrays().logical_nbytes.sum())

    @property
    def ratio(self) -> float:
        return self.logical_nbytes / self.nbytes if self.nbytes else 1.0

    def chunk_physical_bytes(self, chunk_rows: int) -> list[int]:
        """Physical bytes per placement chunk. `chunk_rows` must be a
        multiple of the store's chunking so placement chunks aggregate
        whole encoded chunks."""
        if chunk_rows % self.chunk_rows:
            raise ValueError(
                f"column {self.name!r}: placement chunk_rows={chunk_rows} "
                f"is not a multiple of the store's chunk_rows="
                f"{self.chunk_rows}; build the PlacementEngine with the "
                f"store's chunking (or a multiple of it)")
        k = chunk_rows // self.chunk_rows
        return [sum(c.nbytes for c in self.chunks[i:i + k])
                for i in range(0, len(self.chunks), k)]

    def decode(self) -> np.ndarray:
        """Exact logical codes (dictionary not applied)."""
        if not self.chunks:
            return np.zeros(0, np.uint32)
        return np.concatenate([c.decode() for c in self.chunks])

    def encodings(self) -> dict[str, int]:
        out = {e.value: 0 for e in Encoding}
        for c in self.chunks:
            out[c.encoding.value] += 1
        return out


@dataclass
class EncodedTable:
    """A compressed columnar table the QueryEngine executes directly.

    Duck-types `db.columnar.Table` where the engine reads metadata
    (`columns`, `num_rows`, `nbytes`, `device`); `nbytes` is physical, with
    `logical_nbytes` beside it.
    """

    name: str
    chunk_rows: int
    columns: dict[str, EncodedColumn] = field(default_factory=dict)

    @classmethod
    def from_table(cls, table, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                   encodings: dict[str, Encoding] | None = None
                   ) -> "EncodedTable":
        """Encode a repro_torch db.Table chunk by chunk, on the table's
        device. `chunk_rows` is aligned so a chunk boundary is a word
        boundary for every column's logical width; `encodings` pins named
        columns, others use the selector."""
        if not table.columns:
            return cls(table.name, max(1, chunk_rows))
        align = math.lcm(*(32 // c.code_bits
                           for c in table.columns.values()))
        chunk_rows = -(-max(1, chunk_rows) // align) * align
        if chunk_rows > MAX_CHUNK_ROWS:
            raise ValueError(
                f"chunk_rows={chunk_rows} exceeds MAX_CHUNK_ROWS="
                f"{MAX_CHUNK_ROWS} after width alignment")
        forced = dict(encodings or {})
        unknown = set(forced) - set(table.columns)
        if unknown:
            raise ValueError(f"encodings pin unknown column(s) "
                             f"{sorted(unknown)}; table has "
                             f"{sorted(table.columns)}")
        t = cls(table.name, chunk_rows)
        for name, col in table.columns.items():
            t.columns[name] = EncodedColumn.from_column(
                col, chunk_rows, forced.get(name))
        return t

    @property
    def num_rows(self) -> int:
        return (next(iter(self.columns.values())).num_rows
                if self.columns else 0)

    @property
    def n_chunks(self) -> int:
        return (len(next(iter(self.columns.values())).chunks)
                if self.columns else 0)

    @property
    def device(self) -> torch.device | None:
        """The device the chunks live on (None without chunks)."""
        for col in self.columns.values():
            if col.chunks:
                return col.device
        return None

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns.values())

    @property
    def logical_nbytes(self) -> int:
        return sum(c.logical_nbytes for c in self.columns.values())

    @property
    def ratio(self) -> float:
        return self.logical_nbytes / self.nbytes if self.nbytes else 1.0

    def decode_table(self):
        """The exact plain-format table (the parity oracle's input), on
        this table's device: each column decoded and packed there."""
        from repro_torch.db.columnar import BitPackedColumn, Table
        from repro_torch.store.exec import column_codes, pack_codes
        t = Table(self.name)
        for name, col in self.columns.items():
            t.add(BitPackedColumn(name, col.code_bits, col.num_rows,
                                  pack_codes(column_codes(col),
                                             col.code_bits),
                                  col.dictionary))
        return t

    def stats(self) -> dict:
        return {
            "chunk_rows": self.chunk_rows,
            "physical_bytes": self.nbytes,
            "logical_bytes": self.logical_nbytes,
            "ratio": round(self.ratio, 4),
            "encodings": {n: c.encodings()
                          for n, c in self.columns.items()},
        }


def encoded_table_from_arrays(arrays: dict, chunk_rows: int,
                              name: str = "table",
                              device=None) -> EncodedTable:
    """Build an EncodedTable bit for bit from exported chunk planes, the
    store's counterpart of db.columnar.table_from_arrays:

        {column: {"code_bits": int, "num_rows": int, "dictionary": array or
                  None, "chunks": [{"encoding": str, "n_rows": int,
                  "code_bits": int, "width": int, "base": int,
                  "words" | "values" and "lengths": int32/uint32 numpy,
                  "valid": numpy, "checksum": int}, ...]}}

    e.g. a reference EncodedTable's chunks through `np.asarray`. Every
    chunk's crc32 is checked against its planes on the way in (a mismatch
    raises ValueError naming the column and chunk); statistics are
    recomputed from the decoded codes. Planes are copied to `device` (the
    CUDA device unless the caller passes one)."""
    device = resolve_device(device)
    t = EncodedTable(name, chunk_rows)
    for cname, col in arrays.items():
        code_bits = int(col["code_bits"])
        chunks = []
        for ci, d in enumerate(col["chunks"]):
            enc = Encoding(d["encoding"])
            n_rows = int(d["n_rows"])
            if int(d["code_bits"]) != code_bits:
                raise ValueError(f"column {cname!r} chunk {ci}: code_bits "
                                 f"{d['code_bits']} != {code_bits}")
            planes = {k: np.asarray(d[k]).view(np.int32)
                      for k in ("words", "values", "lengths")
                      if d.get(k) is not None}
            n_runs = (int(np.count_nonzero(planes["lengths"]))
                      if enc is Encoding.RLE else 0)
            width = int(d.get("width", 0))
            base = int(d.get("base", 0))
            crc = _checksum(enc, n_rows, code_bits, width, base, n_runs,
                            list(planes.values()))
            if crc != int(d["checksum"]):
                raise ValueError(
                    f"column {cname!r} chunk {ci}: crc32 {crc} of the "
                    f"exported planes != its checksum {d['checksum']}")
            tens = {k: torch.from_numpy(v.copy()).to(device)
                    for k, v in planes.items()}
            ch = EncodedChunk(
                enc, n_rows, code_bits, None, width=width, base=base,
                n_runs=n_runs,
                valid=torch.from_numpy(np.asarray(d["valid"]).view(
                    np.int32).copy()).to(device),
                checksum=crc, **tens)
            ch.stats = EncodingStats.from_codes(ch.decode(), code_bits)
            chunks.append(ch)
        num_rows = int(col["num_rows"])
        if sum(c.n_rows for c in chunks) != num_rows:
            raise ValueError(f"column {cname!r}: chunks hold "
                             f"{sum(c.n_rows for c in chunks)} rows, not "
                             f"{num_rows}")
        dictionary = col.get("dictionary")
        t.columns[cname] = EncodedColumn(
            cname, code_bits, num_rows, chunk_rows, chunks,
            None if dictionary is None else np.asarray(dictionary))
    return t
