"""Parity of the port's energy layer (repro_torch.energy: the meter and the
power cap) with repro.energy on the CPU.

The meter's ledger lines, totals and per-tenant bill must equal the
reference's with ==, its totals summed over the charges in the
reference's order; the power cap must give the reference's throttled
service times and reports on seeded random streams and never let any
window average above its budget; the metered, capped engine must answer,
admit and reject as the reference's does (tests/test_energy.py's table:
8 columns of 8-bit codes, 4096 rows, placement chunks of 256 rows).
"""
import numpy as np
import pytest

import repro.db as rdb
import repro.query as rq
import repro.tier as rt
import repro_torch.db as tdb
import repro_torch.query as tq
import repro_torch.tier as tt
from repro.core.systems import BIG_MEMORY as J_BIG_MEMORY
from repro.core.systems import DIE_STACKED as J_DIE_STACKED
from repro.core.systems import TRADITIONAL as J_TRADITIONAL
from repro.energy import EnergyMeter as JEnergyMeter
from repro.energy import PowerCap as JPowerCap
from repro.energy import chip_compute_watts as j_chip_compute_watts
from repro.serve.sla import VirtualClock as JClock
from repro_torch.core.systems import BIG_MEMORY, DIE_STACKED, TRADITIONAL
from repro_torch.energy import (EnergyCharge, EnergyMeter, PowerCap,
                                chip_compute_watts)
from repro_torch.energy.caps import _TOL
from repro_torch.serve.sla import VirtualClock

CHUNK_ROWS = 256


@pytest.fixture(scope="module")
def ref_table():
    return rdb.Table.synthetic("energy", 4096,
                               {f"c{i:02d}": 8 for i in range(8)}, seed=1)


@pytest.fixture(scope="module")
def table(ref_table):
    return tdb.table_from_arrays(
        {n: (np.asarray(c.words), c.code_bits, c.num_rows, c.dictionary)
         for n, c in ref_table.columns.items()}, name="energy",
        device="cpu")


@pytest.fixture(scope="module")
def tiers(table):
    return (rt.paper_tiers(table.nbytes * 0.25, fast_gbps=0.016),
            tt.paper_tiers(table.nbytes * 0.25, fast_gbps=0.016))


def err(call):
    """(type, message) of what `call` raises."""
    with pytest.raises(Exception) as e:
        call()
    return type(e.value), str(e.value)


# --------------------------------------------------------------------------
# meter: the joules ledger
# --------------------------------------------------------------------------
class TestEnergyMeter:
    def test_charges_equal_the_reference(self, tiers):
        jm, m = JEnergyMeter(tiers[0], compute_w=2.0), EnergyMeter(
            tiers[1], compute_w=2.0)
        rng = np.random.default_rng(0)
        for k in range(50):
            fb, cb = (int(x) for x in rng.integers(0, 1 << 20, 2))
            kind = ("query", "recovery", "prefetch")[k % 3]
            ch = m.charge(fb, cb, qid=k, tenant=k % 4, kind=kind)
            jch = jm.charge(fb, cb, qid=k, tenant=k % 4, kind=kind)
            busy = float(rng.exponential(1e-3))
            m.charge_compute(ch, busy, chips=1 + k % 2)
            jm.charge_compute(jch, busy, chips=1 + k % 2)
            assert ch.as_dict() == jch.as_dict()
            assert (ch.memory_j, ch.total_j) == (jch.memory_j, jch.total_j)
        for prop in ("fast_j", "capacity_j", "compute_j", "memory_j",
                     "total_j", "recovery_j", "prefetch_j"):
            assert getattr(m, prop) == getattr(jm, prop), prop
        assert m.by_tenant() == jm.by_tenant()
        assert m.summary() == jm.summary()
        assert m.summary()["queries"] == 17

    def test_totals_sum_the_ledger_in_order(self, tiers):
        """The totals are Python sums over the charges in the order they
        were charged, as the reference's are (their last bits depend on
        it: a running float total differs by an ulp, ROADMAP.md queue 3)."""
        m = EnergyMeter(tiers[1], compute_w=0.5)
        jm = JEnergyMeter(tiers[0], compute_w=0.5)
        for meter in (m, jm):
            for k in range(30):
                meter.charge_compute(meter.charge(7919 * k % 1000,
                                                  104729 * k % 997),
                                     1e-4 * k)
        assert m.memory_j == jm.memory_j == sum(c.memory_j
                                                for c in m.charges)
        assert m.total_j == jm.total_j == sum(c.total_j for c in m.charges)
        assert m.summary() == jm.summary()

    def test_charge_components(self, tiers):
        m = EnergyMeter(tiers[1], compute_w=2.0)
        ch = m.charge(1000, 500, qid=7, tenant=3)
        assert ch.fast_j == 1000 * tiers[1].fast.energy_per_byte
        assert ch.capacity_j == 500 * tiers[1].capacity.energy_per_byte
        assert ch.compute_j == 0.0 and ch.kind == "query"
        m.charge_compute(ch, busy_s=0.5, chips=4)
        assert ch.compute_j == pytest.approx(2.0 * 4 * 0.5)
        assert ch.busy_s == 0.5
        assert isinstance(ch, EnergyCharge)

    def test_chip_compute_watts_from_table1(self):
        assert chip_compute_watts(DIE_STACKED) == \
            j_chip_compute_watts(J_DIE_STACKED) == pytest.approx(96.0)
        for cores in (1, 7, 32):
            assert chip_compute_watts(DIE_STACKED, cores) == \
                j_chip_compute_watts(J_DIE_STACKED, cores)
        assert chip_compute_watts(TRADITIONAL) == \
            j_chip_compute_watts(J_TRADITIONAL) == 18 * 3.0
        assert chip_compute_watts(BIG_MEMORY) == \
            j_chip_compute_watts(J_BIG_MEMORY)
        assert err(lambda: chip_compute_watts(DIE_STACKED, cores=0)) == \
            err(lambda: j_chip_compute_watts(J_DIE_STACKED, cores=0))

    @pytest.mark.parametrize("case", (
        lambda mod, m: mod(m.tiers, compute_w=-1.0),
        lambda mod, m: mod(m.tiers, compute_w=float("nan")),
        lambda mod, m: m.charge(-1, 0),
        lambda mod, m: m.charge(0, float("inf")),
        lambda mod, m: m.charge_compute(m.charge(1, 1), busy_s=-0.1),
        lambda mod, m: m.charge_compute(m.charge(1, 1),
                                        busy_s=float("nan")),
    ))
    def test_guards_match_the_reference(self, tiers, case):
        got = err(lambda: case(EnergyMeter, EnergyMeter(tiers[1])))
        want = err(lambda: case(JEnergyMeter, JEnergyMeter(tiers[0])))
        assert got == want
        assert got[0] is ValueError


# --------------------------------------------------------------------------
# caps: the sliding-window governor
# --------------------------------------------------------------------------
class TestPowerCap:
    @pytest.mark.parametrize("case", (
        lambda mod: mod(0.0, 1.0),
        lambda mod: mod(10.0, float("inf")),
        lambda mod: mod(10.0, 1.0).record(2.0, 1.0, 1.0),
        lambda mod: mod(10.0, 1.0).record(0.0, 1.0, -1.0),
        lambda mod: mod(10.0, 1.0).record(1.0, 1.0, 5.0),
        lambda mod: mod(10.0, 1.0).throttled_service_s(0.0, 1.0, -1.0),
        lambda mod: mod(10.0, 1.0).throttled_service_s(0.0, float("nan"),
                                                       1.0),
    ))
    def test_guards_match_the_reference(self, case):
        got, want = err(lambda: case(PowerCap)), err(lambda: case(JPowerCap))
        assert got == want and got[0] is ValueError

    def test_time_ordered_ledger(self):
        for mod in (PowerCap, JPowerCap):
            cap = mod(10.0, 1.0)
            cap.record(0.0, 1.0, 5.0)
            with pytest.raises(ValueError, match="time-ordered"):
                cap.record(-1.0, 2.0, 1.0)

    def test_max_window_watts_exact(self):
        cap = PowerCap(100.0, 1.0)
        cap.record(0.0, 0.5, 10.0)
        assert cap.max_window_watts() == pytest.approx(10.0)
        cap.record(0.75, 1.0, 10.0)
        assert cap.max_window_watts() == pytest.approx(20.0)
        assert cap.watts(1.0) == pytest.approx(20.0)
        cap.record(10.0, 10.5, 10.0)
        assert cap.max_window_watts() == pytest.approx(20.0)
        assert cap.report(now=10.5) == {
            "budget_w": 100.0, "window_s": 1.0, "segments": 3,
            "total_j": 30.0, "max_window_w": cap.max_window_watts(),
            "budget_utilization": cap.max_window_watts() / 100.0,
            "current_w": cap.watts(10.5), "throttled_queries": 0,
            "throttle_s_total": 0.0}

    def test_throttle_floor_and_congestion(self):
        for mod in (PowerCap, JPowerCap):
            cap = mod(budget_w=10.0, window_s=1.0)
            assert cap.throttled_service_s(0.0, 5.0, 0.01) == \
                pytest.approx(0.01)
            assert cap.throttled_service_s(0.0, 25.0, 0.01) == \
                pytest.approx(2.5, rel=1e-6)
            assert cap.throttled_service_s(0.0, 0.0, 0.25) == 0.25
        caps = PowerCap(10.0, 1.0), JPowerCap(10.0, 1.0)
        s0 = [c.throttled_service_s(0.0, 10.0, 0.1) for c in caps]
        assert s0[0] == s0[1]
        for c in caps:
            c.record(0.0, s0[0], 10.0)
        s1 = [c.throttled_service_s(s0[0], 5.0, 0.1) for c in caps]
        assert s1[0] == s1[1] > 0.1

    def test_tiny_service_does_not_collapse_to_zero_segment(self):
        cap = PowerCap(10.0, 1.0)
        cap.record(0.0, 1.0, 10.0)
        s = cap.throttled_service_s(1.0, 3.0, 0.0)
        assert 1.0 + s > 1.0
        cap.record(1.0, 1.0 + s, 3.0, natural_s=0.0)
        assert cap.max_window_watts() <= 10.0 * (1 + 1e-9)
        assert cap.throttled_queries == 1
        assert cap.throttle_s_total == pytest.approx(s)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
    def test_random_stream_never_over_budget_and_equal(self, seed):
        """tests/test_energy.py's seeded property on the port, beside the
        reference: the same throttled service a query, every window at
        or under budget (exact max, not sampled)."""
        rng = np.random.default_rng(seed)
        budget = float(rng.uniform(5.0, 50.0))
        window = float(rng.uniform(0.1, 2.0))
        cap, jcap = PowerCap(budget, window), JPowerCap(budget, window)
        now = 0.0
        for _ in range(60):
            joules = float(rng.gamma(2.0, budget * window / 4))
            natural = float(rng.gamma(2.0, window / 20))
            s = cap.throttled_service_s(now, joules, natural)
            assert s == jcap.throttled_service_s(now, joules, natural)
            assert s >= natural
            cap.record(now, now + s, joules, natural_s=natural)
            jcap.record(now, now + s, joules, natural_s=natural)
            now += s + (float(rng.exponential(window / 4))
                        if rng.random() < 0.5 else 0.0)
        assert cap.max_window_watts() <= budget * (1 + 1e-9)
        assert cap.report(now=now) == jcap.report(now=now)
        assert len(cap) == 60

    def test_governs_a_ledger_left_at_the_limit(self):
        """Where the bisection leaves the ledger at the budget and a later
        sum reads it one rounding over, the reference refuses every
        service time (ROADMAP.md, queue 3); the port's governor checks
        only the windows that hold the new query, so it goes on and stays
        within budget. Microsecond queries dominated by compute power, as
        a capped replay at 96 W makes them."""
        rng = np.random.default_rng(11)
        budget, window = 49.0036496350365, 3.6864e-05
        cap, jcap = PowerCap(budget, window), JPowerCap(budget, window)
        now, ref_fault = 0.0, None
        for _ in range(400):
            joules = float(rng.uniform(1e-4, 3e-4))
            natural = float(rng.uniform(1e-6, 3e-6))
            s = cap.throttled_service_s(now, joules, natural)
            if ref_fault is None:
                try:
                    assert jcap.throttled_service_s(now, joules,
                                                    natural) == s
                    jcap.record(now, now + s, joules, natural_s=natural)
                except RuntimeError as e:
                    ref_fault = e
            cap.record(now, now + s, joules, natural_s=natural)
            now += s
        assert cap.max_window_watts() <= budget * (1 + 1e-9)
        assert cap.report()["throttled_queries"] > 0
        # the reference stopped on this stream (at its 168th query); up to
        # there the two governors agreed on every service time
        assert "cannot be met" in str(ref_fault)

    @staticmethod
    def window_peak_after(cap, now, extra):
        """Peak window-average power over the windows that end after
        `now`, with segment `extra` = (t0, t1, joules) added, each window
        summed by `window_j`'s loop: the governor's own criterion through
        another code path. Windows are checked at every candidate end
        (the segment boundaries and those plus one window length)."""
        trial = PowerCap(cap.budget_w, cap.window_s)
        for t0, t1, j in zip(cap._t0, cap._t1, cap._j):
            if t1 > now - cap.window_s:
                trial.record(t0, t1, j)
        trial.record(*extra)
        bounds = np.asarray(trial._t0 + trial._t1)
        ends = np.unique(np.concatenate([bounds, bounds + cap.window_s]))
        return max(trial.watts(float(e)) for e in ends if e > now)

    @pytest.mark.parametrize("budget,window,natural,watts,seed", (
        # the chip smoke's capped replay: 289 W over a 10.47 ms window,
        # sub-millisecond queries demanding about twice the budget
        (289.00248079683104, 0.010474417777777778, (2e-4, 7e-4),
         (300.0, 900.0), 3),
        # microsecond queries at 49 W, where the reference's governor stops
        (49.0036496350365, 3.6864e-05, (1e-6, 3e-6), (33.0, 300.0), 11),
    ))
    def test_card_like_stream_least_stretch_within_budget(
            self, budget, window, natural, watts, seed):
        """The port's governor on its own, at the service times and watts
        of a capped replay on the card: every window at or under
        budget × (1 + _TOL), and every stretched service time the least
        feasible one — a stretch shorter by a part in 1e9 puts a window
        that holds the query over that limit. The governor bisects onto
        the limit in its own sum; another order of the same sum reads up
        to 2 units in the last place above it on these streams (the
        rounding at which the reference's governor stops), so every
        window sum here is held to the limit plus 4 such units."""
        rng = np.random.default_rng(seed)
        cap = PowerCap(budget, window)
        limit = budget * (1.0 + _TOL)
        limit_sum = limit + 4 * np.spacing(limit)
        now, stretched = 0.0, 0
        for _ in range(150):
            nat = float(rng.uniform(*natural))
            joules = float(rng.uniform(*watts)) * nat
            s = cap.throttled_service_s(now, joules, nat)
            assert s >= nat
            assert self.window_peak_after(
                cap, now, (now, now + s, joules)) <= limit_sum
            if s > nat:
                stretched += 1
                short = now + s * (1.0 - 1e-9)
                assert self.window_peak_after(
                    cap, now, (now, short, joules)) > limit_sum
            cap.record(now, now + s, joules, natural_s=nat)
            now += s + (float(rng.exponential(window / 8))
                        if rng.random() < 0.3 else 0.0)
        assert stretched > 10
        assert cap.report()["max_window_w"] <= limit_sum


# --------------------------------------------------------------------------
# the metered, capped engine against the reference's
# --------------------------------------------------------------------------
class TestMeteredEngine:
    def replays(self, ref_table, table, tiers, budget_w, sla_s=0.010,
                n_queries=45, compute_w=1e-3):
        spec = dict(n_queries=n_queries, skew=1.1, seed=5)
        jtrace = rt.make_trace(ref_table, rt.TraceSpec(**spec))
        trace = tt.make_trace(table, tt.TraceSpec(**spec))
        caps = ((JPowerCap(budget_w, 20 * sla_s),
                 PowerCap(budget_w, 20 * sla_s)) if budget_w is not None
                else (None, None))
        ref = rt.replay_trace(ref_table, jtrace, tiers[0], "memcache",
                              sla_s=sla_s, chunk_rows=CHUNK_ROWS,
                              mode="xla_ref", compute_w=compute_w,
                              power_cap=caps[0])
        mine = tt.replay_trace(table, trace, tiers[1], "memcache",
                               sla_s=sla_s, chunk_rows=CHUNK_ROWS,
                               compute_w=compute_w, power_cap=caps[1])
        return ref, mine

    def test_tenant_tagged_ledger(self, ref_table, table, tiers):
        (jpe, jeng, jatt), (pe, eng, att) = self.replays(ref_table, table,
                                                         tiers, None)
        assert att == jatt
        bill = eng.summary()["energy"]["by_tenant"]
        assert bill == jeng.summary()["energy"]["by_tenant"]
        assert set(bill) <= {0, 1, 2, 3}
        assert sum(t["queries"] for t in bill.values()) == \
            len(pe.meter.charges)
        qids = [c.qid for c in pe.meter.charges]
        assert len(set(qids)) == len(qids)
        assert [c.as_dict() for c in pe.meter.charges] == \
            [c.as_dict() for c in jpe.meter.charges]
        assert eng.summary()["energy"]["compute_j"] > 0

    def test_capped_replay_property(self, ref_table, table, tiers):
        """The governed replay never exceeds budget over any window, still
        reports attainment (never above the uncapped one), and equals the
        reference's replay."""
        (_, jeng0, jatt0), (_, eng0, att0) = self.replays(ref_table, table,
                                                          tiers, None)
        assert att0 == jatt0
        demand_w = (eng0.summary()["energy"]["total_j"]
                    / eng0.seconds_total)
        for frac in (0.5, 0.8):
            (jpe, jeng, jatt), (pe, eng, att) = self.replays(
                ref_table, table, tiers, frac * demand_w)
            rep = eng.power_cap.report(now=eng.clock())
            assert rep == jeng.power_cap.report(now=jeng.clock())
            assert rep["max_window_w"] <= eng.power_cap.budget_w \
                * (1 + 1e-9)
            assert att == jatt and 0.0 <= att <= att0 + 1e-9
            assert eng.summary() == jeng.summary()
            assert [r.tier for r in eng.results] == \
                [r.tier for r in jeng.results]
        s = eng.summary()
        assert s["power"]["budget_utilization"] <= 1 + 1e-9
        assert s["power"]["segments"] == s["served"]

    def test_power_infeasible_rejected_at_admission(self, ref_table, table,
                                                    tiers):
        """A deadline feasible at the bandwidth rate but not at the
        power-derated rate is rejected at submit, in both packages."""
        pe = tt.PlacementEngine.for_table(table, tiers[1], "static",
                                          chunk_rows=CHUNK_ROWS,
                                          meter=EnergyMeter(tiers[1]))
        q = tq.Query(tq.Pred("c00", "lt", 64), aggregates=("c01",))
        jq = rq.Query(rq.Pred("c00", "lt", 64), aggregates=("c01",))
        probe = tq.QueryEngine(table, device="cpu", tiered=pe,
                               clock=VirtualClock())
        nbytes = sum(probe.chunk_accesses(q).values())
        bw_est = nbytes / probe.measured_bps
        acc = pe.project(probe.chunk_accesses(q))
        e_query = tiers[1].energy_j(acc.fast_bytes, acc.capacity_bytes)
        budget, window = e_query / (10 * bw_est), bw_est
        out = []
        for mod, qq, t, cap, kw in (
                (tq, q, table, PowerCap(budget, window),
                 dict(device="cpu", clock=VirtualClock())),
                (rq, jq, ref_table, JPowerCap(budget, window),
                 dict(mode="xla_ref", clock=JClock()))):
            tmod = tt if mod is tq else rt
            pe2 = tmod.PlacementEngine.for_table(
                t, tiers[0 if mod is rq else 1], "static",
                chunk_rows=CHUNK_ROWS)
            eng = mod.QueryEngine(t, tiered=pe2, power_cap=cap, **kw)
            assert eng.submit(qq, deadline=2 * bw_est) is None
            assert eng.submit(qq, deadline=1e9) == 2
            res = eng.run()[0]
            assert res.tier["throttle_s"] > 0 and res.met
            assert cap.max_window_watts() <= cap.budget_w * (1 + 1e-9)
            out.append((res.tier, res.latency_s, cap.report(),
                        eng.summary()))
        assert out[0] == out[1]

    def test_power_cap_requires_tiered(self, ref_table, table):
        got = err(lambda: tq.QueryEngine(table, device="cpu",
                                         power_cap=PowerCap(1.0, 1.0),
                                         clock=VirtualClock()))
        want = err(lambda: rq.QueryEngine(ref_table,
                                          power_cap=JPowerCap(1.0, 1.0),
                                          clock=JClock()))
        assert got == want and "tiered" in got[1]

    def test_project_does_not_mutate_placement(self, table, tiers):
        pe = tt.PlacementEngine.for_table(table, tiers[1], "memcache",
                                          chunk_rows=CHUNK_ROWS)
        chunks = {cid: int(pe.nbytes[i])
                  for cid, i in list(pe.index.items())[:6]}
        before = (pe.in_fast.copy(), pe.freq.copy(), pe.last_access.copy(),
                  pe._clock, len(pe.meter.charges))
        split = pe.project(chunks)
        assert split.total_bytes == sum(chunks.values())
        np.testing.assert_array_equal(before[0], pe.in_fast)
        np.testing.assert_array_equal(before[1], pe.freq)
        np.testing.assert_array_equal(before[2], pe.last_access)
        assert before[3:] == (pe._clock, len(pe.meter.charges))
