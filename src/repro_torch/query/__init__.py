"""SLA-aware query engine of the port: the paper's workload, on the card.

Logical plans (Pred/And/Or trees + multi-column aggregates) compile to
kernel-dispatch physical operators and batch through the shared EDF
deadline scheduler; GroupBy/HashJoin compile through `relational`.
Counterpart of repro.query's flat-table path.
"""
from repro_torch.query import relational
from repro_torch.query.engine import QueryEngine, QueryResult
from repro_torch.query.plan import (And, GroupBy, HashJoin, Or, Plan, Pred,
                                    Predicate, Query, is_grouped)

__all__ = ["And", "GroupBy", "HashJoin", "Or", "Plan", "Pred",
           "Predicate", "Query", "QueryEngine", "QueryResult", "is_grouped",
           "relational"]
