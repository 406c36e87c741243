"""In-memory analytic DB substrate (the paper's workload) on a torch device.

Storage lives here (bit-packed columns, tables); execution lives in
repro_torch.query.
"""
from repro_torch.db.columnar import BitPackedColumn, Table, table_from_arrays
from repro_torch.db.queries import Predicate, scan_aggregate_query

__all__ = ["BitPackedColumn", "Table", "Predicate", "scan_aggregate_query",
           "table_from_arrays"]
