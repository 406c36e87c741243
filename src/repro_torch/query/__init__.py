"""SLA-aware query engine of the port: the paper's workload, on the card.

Logical plans (Pred/And/Or trees + multi-column aggregates) compile to
kernel-dispatch physical operators and batch through the shared EDF
deadline scheduler; GroupBy/HashJoin compile through `relational`; a
`ShardedTable` splits a table row-wise into virtual shards on one card.
Counterpart of repro.query.
"""
from repro_torch.query import relational
from repro_torch.query.engine import QueryEngine, QueryResult
from repro_torch.query.plan import (And, GroupBy, HashJoin, Or, Plan, Pred,
                                    Predicate, Query, is_grouped)
from repro_torch.query.sharded import ShardedTable

__all__ = ["And", "GroupBy", "HashJoin", "Or", "Plan", "Pred",
           "Predicate", "Query", "QueryEngine", "QueryResult",
           "ShardedTable", "is_grouped", "relational"]
