"""Compressed columnar store of the port: scan-over-compressed as a
bandwidth multiplier (counterpart of repro.store).

- `encode`: chunk-granular RLE / frame-of-reference / plain encodings over
  the bit-packed code planes, chosen per chunk from statistics computed on
  the device, never larger than the plain format.
- `exec`: query execution over compressed chunks: RLE runs through the
  scan_compressed kernels, FOR planes through the packed-word kernels at
  the delta width (translated predicates, exact base fix-up), every chunk
  of a column group in one launch; GroupBy/HashJoin over the chunks
  through the group_aggregate kernels (`execute_grouped_encoded`).

- `sharded`: `ShardedEncodedTable`, the delta view on a mesh of virtual
  shards: one global frame of reference per column, the deltas packed
  and handed to query.sharded.ShardedTable.

QueryEngine(EncodedTable) executes compressed directly; `bytes_scanned`
is physical (compressed) traffic with `logical_bytes` beside it.
"""
from repro_torch.store.encode import (DEFAULT_CHUNK_ROWS, MAX_CHUNK_ROWS,
                                      EncodedChunk, EncodedColumn,
                                      EncodedTable, Encoding, EncodingStats,
                                      choose_encoding, encode_chunk,
                                      encoded_table_from_arrays,
                                      width_for_span)
from repro_torch.store.exec import (execute_encoded,
                                    execute_grouped_encoded, translate_plan,
                                    translate_pred)
from repro_torch.store.sharded import ShardedEncodedTable

__all__ = [
    "Encoding", "EncodingStats", "EncodedChunk", "EncodedColumn",
    "EncodedTable", "ShardedEncodedTable", "choose_encoding",
    "encode_chunk",
    "encoded_table_from_arrays", "execute_encoded",
    "execute_grouped_encoded", "translate_plan",
    "translate_pred", "width_for_span", "DEFAULT_CHUNK_ROWS",
    "MAX_CHUNK_ROWS",
]
