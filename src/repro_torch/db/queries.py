"""Legacy scan/aggregate entry points over the bit-packed store
(counterpart of repro/db/queries.py).

They keep the reference's call signatures and route through the query
engine's one execution path. Kernel selection is a dispatch `mode=`
(KernelMode.CUDA | TORCH_REF | AUTO).
"""
from __future__ import annotations

from repro_torch.db.columnar import Table
from repro_torch.query import physical
from repro_torch.query.plan import Predicate, normalize

__all__ = ["Predicate", "bytes_scanned", "scan_aggregate_query",
           "scan_query"]


def scan_query(table: Table, predicates, mode=None):
    """Predicate tree (or legacy list = conjunction) -> packed selection
    mask in the delimiter-bit layout of the leftmost predicate's column.
    Mixed column widths are repacked automatically; padding rows never
    match."""
    plan = normalize(predicates)
    physical.bind_check(plan, (), table.columns)
    mask, _ = physical.eval_mask(plan, physical.table_slices(table), mode)
    return mask


def scan_aggregate_query(table: Table, predicates, agg_column: str,
                         mode=None) -> dict:
    """SELECT agg(agg_column) WHERE <predicates> — the paper's query.
    Returns exact host ints (sum/count/min/max) + selectivity."""
    plan = normalize(predicates)
    physical.bind_check(plan, (agg_column,), table.columns)
    out = physical.finalize_aggs(physical.execute(
        plan, (agg_column,), physical.table_slices(table), mode=mode))
    res = out[agg_column]
    res["selectivity"] = res["count"] / max(table.num_rows, 1)
    return res


def bytes_scanned(table: Table, predicates, agg_column: str) -> int:
    """Bytes a query streams from memory — the model's `percent accessed`
    numerator for this workload."""
    plan = normalize(predicates)
    physical.bind_check(plan, (agg_column,), table.columns)
    return physical.referenced_bytes(plan, (agg_column,), table.columns)
