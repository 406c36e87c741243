"""ChaosHarness: the fault-injected query path, end to end (counterpart
of repro/resilience/harness.py).

Owns the per-query choreography the QueryEngine delegates to when
`chaos=` is set: circuit-breaker gating of the fast tier, checksum
verify-on-read (through the store executor), shard-loss failover
(recover.execute_degraded), nominal tier charging, and the stall /
retry / failover time model for every fast-tier chunk read. Everything
runs on the engine's VirtualClock from seeded draws — a chaos run is a
pure function of (workload, FaultSpec, RetryPolicy), replayable bit for
bit (examples/chaos_replay.py).

Accounting contract (the property tests pin this down):

- the nominal access is charged exactly once (PlacementEngine.on_access,
  kind="query"), covering one clean read of every chunk;
- every *extra* byte recovery streams — re-issued reads after a timeout,
  capacity-tier failover, oracle re-reads for chunk repair, lost-shard
  re-execution — lands in exactly one kind="recovery" ledger line per
  query; retries never double-charge;
- extra modeled seconds are `total_time - one_clean_read` per chunk, so
  a fault-free run charges zero extras and is bit-identical to the
  plain tiered path.
"""
from __future__ import annotations

from repro_torch.query.plan import is_grouped
from repro_torch.resilience.faults import FaultInjector, FaultSpec
from repro_torch.resilience.recover import (ChunkGuard, CircuitBreaker,
                                            DegradedResultError,
                                            execute_degraded,
                                            execute_grouped_degraded)
from repro_torch.resilience.retry import RetryPolicy


class ChaosHarness:
    """Fault injection + recovery policy bundle for one QueryEngine.

    `recover=False` keeps the faults but disables every recovery: stalls
    ride to completion, corruption raises typed, lost shards fail the
    query — the no-recovery baseline BENCH_resilience compares against.
    """

    # reserved stall-draw slot for prefetch streams: far above any retry
    # policy's attempt numbers, so stream-stall draws are independent of
    # (and never aliased with) the fast-read stall draws per chunk
    PREFETCH_ATTEMPT = 1 << 20

    def __init__(self, spec: FaultSpec | FaultInjector, *,
                 retry: RetryPolicy | None = None,
                 breaker: CircuitBreaker | None = None,
                 guard: ChunkGuard | None = None,
                 recover: bool = True):
        self.injector = (spec if isinstance(spec, FaultInjector)
                         else FaultInjector(spec))
        self.spec = self.injector.spec
        self.retry = retry
        self.breaker = breaker
        self.guard = guard
        self.recover = bool(recover)
        if self.guard is not None:
            self.guard.repair = self.recover
        # fault/recovery counters (summary + modeled MTTR)
        self.stalls = 0
        self.prefetch_stalls = 0     # capacity->fast streams that stalled
        self.retries = 0
        self.failovers = 0
        self.repairs = 0
        self.shard_losses = 0
        self.shard_recoveries = 0
        self.failures = 0            # queries that ended typed-degraded
        self._recovered_faults = 0
        self._recovery_s = 0.0

    # --- fault application (setup-time) -----------------------------------
    def inject_corruption(self) -> list:
        """Flip one seeded payload bit in each chunk the injector picks
        (requires a ChunkGuard — its oracle was captured pre-corruption).
        Each flipped copy replaces its chunk (EncodedColumn.replace_chunk,
        so no plane cached from the old chunks survives). Returns the
        corrupted (column, chunk-index) ids."""
        if self.guard is None:
            raise ValueError("corruption injection needs guard=ChunkGuard "
                             "(the repair oracle must be captured before "
                             "any bit flips)")
        out = []
        for name, ci in self.injector.corrupt_chunks(self.guard.chunk_ids()):
            col = self.guard.table.columns[name]
            flipped = self.injector.flip_bit(col.chunks[ci], name, ci)
            if flipped is not None:
                col.replace_chunk(ci, flipped)
                out.append((name, ci))
        return out

    # --- admission --------------------------------------------------------
    def inflate_estimate(self, est_s: float, n_chunks: int) -> float:
        """Fold first-order expected recovery overhead into the admission
        service estimate: a query whose retry-inflated estimate no longer
        fits its deadline (or, downstream, its watt budget) is rejected
        at submit instead of missing after the fact."""
        p = self.spec.stall_rate
        if p <= 0.0:
            return est_s
        if not (self.recover and self.retry is not None):
            # stalls ride to completion: expected slowdown on the stalled
            # fraction of the stream
            return est_s * (1.0 + p * (self.spec.stall_factor - 1.0))
        # with retries: each stalled read is abandoned near timeout_s and
        # re-issued; E[abandons per chunk] = p/(1-p) (geometric)
        exp_abandons = p / max(1.0 - p, 1e-9)
        per_chunk = exp_abandons * (self.retry.timeout_s
                                    + self.retry.backoff(0))
        return est_s * (1.0 + exp_abandons) + max(n_chunks, 1) * per_chunk

    # --- the fault-injected query path ------------------------------------
    def run_query(self, engine, pend, t0: float, trace=None):
        """Execute one admitted query under injected faults.

        Returns (aggs | None, access, busy_s, query_j, error | None):
        `busy_s` is nominal tiered service plus recovery extras, `query_j`
        the nominal charge plus the recovery line, `error` a typed
        degraded message (aggs is None exactly when error is set).

        `trace` (obs.trace.QueryTrace) gets the recovery span tree on top
        of the nominal reads: repair / shard_failover / stall / retry /
        failover / prefetch_stall spans whose byte sums are exactly the
        (extra_fast_b, extra_cap_b) this method folds into its single
        kind="recovery" ledger line — the conservation the obs.audit
        checker proves per query.
        """
        pe = engine.tiered
        chips = engine.n_shards
        error = None
        extra_s = 0.0
        extra_fast_b = 0
        extra_cap_b = 0
        rec_events = []   # (kind, bytes, seconds, attrs) gathered during
        #                   execution, laid out after the nominal reads
        # 1. circuit breaker gates the fast tier for this access
        if self.breaker is not None:
            pe.demoted = not self.breaker.allow_fast(t0)
        # 2. snapshot which chunk reads hit the fast tier *before*
        #    on_access mutates placement — stalls afflict only those
        #    (the capacity tier is the durable, stable failover target)
        if pe.demoted:
            fast_cids = {}
        else:
            fast_cids = {cid: b for cid, b in pend.chunks.items()
                         if pe.resident(cid)}
        # prefetch (if the engine carries a pipeline) plans against the
        # same pre-access residency; capacity->fast streams can stall too
        # — a seeded draw at a reserved attempt slot, independent of the
        # fast-read stall draws below — and a stalled stream degrades its
        # chunk to the synchronous path (never a wrong answer)
        pplan = None
        if engine.prefetch is not None:
            pplan = engine.prefetch.plan(
                pend.chunks, chips=chips,
                stalled=lambda cid: self.injector.stalled(
                    pend.qid, cid, self.PREFETCH_ATTEMPT))
            engine.prefetch.begin(pplan, pend.chunks)
        # 3. execute — verify-on-read + repair (store tables) or shard
        #    failover (sharded tables); typed errors, never silent
        aggs = None
        repaired_b0 = (self.guard.repair_logical_bytes_total
                       if self.guard is not None else 0)
        repaired_n0 = len(self.guard.repaired) if self.guard else 0
        lost = (self.injector.lost_shards(pend.qid, chips)
                if engine.sharded else ())
        try:
            if lost:
                self.shard_losses += 1
                if not self.recover:
                    raise DegradedResultError(
                        f"shard {lost[0]} lost during qid={pend.qid} and "
                        f"recovery is disabled")
                if is_grouped(pend.query):
                    aggs, rec_b = execute_grouped_degraded(
                        engine.table, pend.query, lost, mode=engine.mode)
                else:
                    aggs, rec_b = execute_degraded(
                        engine.table, pend.query.plan(),
                        pend.query.aggregates, lost, mode=engine.mode)
                extra_cap_b += rec_b
                rs = pe.tiers.service_s(0, rec_b, chips)
                extra_s += rs
                self._recovered(rs)
                self.shard_recoveries += 1
                rec_events.append(("shard_failover", rec_b, rs,
                                   {"shards": tuple(lost)}))
            else:
                aggs = engine._execute(pend.query)
        except DegradedResultError as e:
            error = str(e)
            self.failures += 1
        if self.guard is not None:
            rb = self.guard.repair_logical_bytes_total - repaired_b0
            if rb:
                # repair re-read the oracle bytes from the capacity tier
                extra_cap_b += rb
                rs = pe.tiers.service_s(0, rb, chips)
                extra_s += rs
                self._recovered(rs)
                n_rep = len(self.guard.repaired) - repaired_n0
                self.repairs += n_rep
                rec_events.append(("repair", rb, rs, {"chunks": n_rep}))
        # 4. nominal access: charged once whether or not the query
        #    degraded — the bytes streamed up to the failure either way;
        #    with a prefetch pipeline the busy time is the pipelined
        #    (stall-degraded) service, the byte charge is unchanged
        acc = pe.on_access(pend.chunks, qid=pend.qid, tenant=pend.tenant,
                           trace=trace)
        busy = pplan.service_s if pplan is not None \
            else pe.service_s(acc, chips)
        pe.meter.charge_compute(acc.charge, busy, chips)
        cursor = t0
        if trace is not None:
            from repro_torch.obs.trace import layout_pipeline, layout_sync
            cursor = (layout_pipeline(trace, t0, pplan, pe.tiers, chips)
                      if pplan is not None
                      else layout_sync(trace, t0, pe.tiers, chips))
            trace.compute(t0, busy, chips,
                          pe.meter.compute_w * chips * busy)
            cap_e = pe.tiers.capacity.energy_per_byte
            for kind, b, rs, attrs in rec_events:
                trace.add(kind, t0=cursor, dur_s=rs, nbytes=b,
                          tier="capacity", ledger="recovery",
                          joules=b * cap_e, **attrs)
                cursor += rs
        query_j_extra = 0.0
        if pplan is not None:
            # overlap's own traffic on the kind="prefetch" line; the
            # *stalled* streams' wasted bytes instead join this query's
            # single kind="recovery" line below — charged exactly once
            self.prefetch_stalls += pplan.n_stalled
            extra_cap_b += pplan.stalled_bytes
            line = engine.prefetch.finish(pplan, qid=pend.qid,
                                          tenant=pend.tenant)
            if line is not None:
                query_j_extra += line.total_j
        # 5. stall / retry / failover on each fast-tier chunk read
        saw_stall = False
        for cid in sorted(fast_cids):
            ex, fb, cb, stalled, cursor = self._chunk_read(
                engine, pend.qid, cid, fast_cids[cid], chips,
                trace=trace, at=cursor)
            extra_s += ex
            extra_fast_b += fb
            extra_cap_b += cb
            saw_stall = saw_stall or stalled
        if self.breaker is not None and not saw_stall and fast_cids:
            self.breaker.record_ok(t0)
        # 6. every recovery byte lands in one ledger line — exactly once
        recovery_j = 0.0
        if extra_fast_b or extra_cap_b:
            line = pe.charge_recovery(extra_fast_b, extra_cap_b,
                                      qid=pend.qid, tenant=pend.tenant)
            recovery_j = line.total_j
        return (aggs, acc, busy + extra_s,
                acc.charge.total_j + query_j_extra + recovery_j, error)

    def _chunk_read(self, engine, qid: int, cid, nbytes: int, chips: int,
                    trace=None, at: float = 0.0):
        """Model one fast-tier chunk read under the stall fault + retry
        policy. Returns (extra_s, extra_fast_bytes, extra_capacity_bytes,
        stalled, cursor): extras beyond the one clean read the nominal
        service already priced; `cursor` advances past the recovery spans
        emitted on `trace` starting at `at`."""
        pe = engine.tiered
        clean_s = pe.tiers.service_s(nbytes, 0, chips)
        fast_e = pe.tiers.fast.energy_per_byte
        cap_e = pe.tiers.capacity.energy_per_byte
        total = 0.0
        fast_b = 0
        cap_b = 0
        attempt = 0
        faulted = False
        while True:
            stalled = self.injector.stalled(qid, cid, attempt)
            if not stalled:
                total += clean_s
                break
            faulted = True
            self.stalls += 1
            if self.breaker is not None:
                self.breaker.record_fault(engine.clock())
            if not (self.recover and self.retry is not None):
                # no retry policy: the stalled read rides to completion
                total += self.spec.stall_factor * clean_s
                if trace is not None:
                    ride = (self.spec.stall_factor - 1.0) * clean_s
                    trace.add("stall", t0=at, dur_s=ride, cid=cid,
                              attempt=attempt)
                    at += ride
                break
            if self.spec.stall_factor * clean_s <= self.retry.timeout_s:
                # slow, but lands inside the timeout: no abandon
                total += self.spec.stall_factor * clean_s
                if trace is not None:
                    ride = (self.spec.stall_factor - 1.0) * clean_s
                    trace.add("stall", t0=at, dur_s=ride, cid=cid,
                              attempt=attempt)
                    at += ride
                break
            if attempt >= self.retry.max_retries:
                # retry budget exhausted: fail over to the durable
                # capacity copy
                fo = (self.retry.timeout_s
                      + pe.tiers.service_s(0, nbytes, chips))
                total += fo
                cap_b += nbytes
                self.failovers += 1
                if trace is not None:
                    # the span's duration is the failover's *extra* beyond
                    # the clean read the nominal service already priced
                    # (this method returns total - clean_s), so the
                    # recovery timeline closes exactly at the query's
                    # modeled t_end — the critical-path closure invariant
                    ride = max(fo - clean_s, 0.0)
                    trace.add("failover", t0=at, dur_s=ride, nbytes=nbytes,
                              tier="capacity", ledger="recovery",
                              joules=nbytes * cap_e, cid=cid,
                              attempt=attempt)
                    at += ride
                break
            rt = self.retry.timeout_s + self.retry.backoff(attempt)
            total += rt
            fast_b += nbytes        # the re-issued read streams again
            self.retries += 1
            if trace is not None:
                trace.add("retry", t0=at, dur_s=rt, nbytes=nbytes,
                          tier="fast", ledger="recovery",
                          joules=nbytes * fast_e, cid=cid,
                          attempt=attempt)
                at += rt
            attempt += 1
        extra = max(total - clean_s, 0.0)
        if faulted and self.recover and self.retry is not None:
            self._recovered(extra)
        return extra, fast_b, cap_b, faulted, at

    # --- reporting --------------------------------------------------------
    def _recovered(self, seconds: float) -> None:
        self._recovered_faults += 1
        self._recovery_s += seconds

    @property
    def mttr_s(self) -> float | None:
        """Modeled mean time to recover: extra seconds per recovered
        fault (None until something recovered)."""
        if self._recovered_faults == 0:
            return None
        return self._recovery_s / self._recovered_faults

    def summary(self) -> dict:
        out = {
            "spec": self.spec.as_dict(),
            "recover": self.recover,
            "retry": self.retry.as_dict() if self.retry else None,
            "stalls": self.stalls,
            "prefetch_stalls": self.prefetch_stalls,
            "retries": self.retries,
            "failovers": self.failovers,
            "repairs": self.repairs,
            "shard_losses": self.shard_losses,
            "shard_recoveries": self.shard_recoveries,
            "degraded_queries": self.failures,
            "recovered_faults": self._recovered_faults,
            "mttr_s": self.mttr_s,
        }
        if self.breaker is not None:
            out["breaker"] = self.breaker.summary()
        if self.guard is not None:
            out["integrity"] = self.guard.summary()
        return out
