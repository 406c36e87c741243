"""The port's serving engine and SLA scheduler (repro_torch.serve) against
the reference's (repro.serve), on the CPU.

The engine's invariant is the reference's: whatever it generates (slots,
refills, bucketed prompts, ring caches) equals naive one-request-at-a-time
greedy decoding. Here it is held both within the port (against its own
naive greedy) and across packages (against the reference engine's tokens,
with the reference's weights carried across by params_from_reference).
The scheduler cases are tests/test_scheduler_metrics.py::TestSLAScheduler's
on a fake clock.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.models import convert, lm
from repro_torch.models.attention import INF_POS
from repro_torch.serve.engine import (Request, ServeEngine, bucket_len,
                                      make_prefill_step, make_serve_step)
from repro_torch.serve.scheduler import SLAScheduler


@pytest.fixture(scope="module")
def setup():
    """tests/test_serve_engine.py's model: internlm2-1.8b reduced to two
    layers in float32, weights from jax.random.PRNGKey(0)."""
    jcfg = jget_config("internlm2-1.8b").reduced(dtype="float32",
                                                 num_layers=2)
    cfg = get_config("internlm2-1.8b").reduced(dtype="float32",
                                               num_layers=2)
    # jitted: the same numbers as eager jlm.init, compiled once
    params = jax.jit(lambda k: jlm.init(k, jcfg)[0])(jax.random.PRNGKey(0))
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    return jcfg, params, cfg, model


def naive_greedy(cfg, model, prompt, n_new):
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n_new):
            x = torch.tensor(toks, dtype=torch.int32)[None]
            logits, _, _ = lm.prefill(model, cfg, x, caches=None)
            toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def run_both(setup, make_requests, batch_slots, max_len, impl="auto"):
    """The same requests through the port's engine and the reference's;
    returns {rid: (port tokens, reference tokens, request)}."""
    jcfg, params, cfg, model = setup
    jcfg, cfg = (dataclasses.replace(c, attn_impl=impl)
                 for c in (jcfg, cfg))
    port = ServeEngine(cfg, model, batch_slots=batch_slots, max_len=max_len,
                       device="cpu").run(make_requests(Request))
    ref = JServeEngine(jcfg, params, batch_slots=batch_slots,
                       max_len=max_len).run(make_requests(JRequest))
    assert sorted(r.rid for r in port) == sorted(r.rid for r in ref)
    ref = {r.rid: r for r in ref}
    return {r.rid: (r.generated, ref[r.rid].generated, r) for r in port}


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_single_request_matches_naive_and_reference(setup, impl):
    _, _, cfg, model = setup
    prompt = np.array([5, 9, 2, 7], np.int32)
    got = run_both(setup, lambda R: [R(rid=0, prompt=prompt,
                                       max_new_tokens=6)], 2, 64, impl)
    port, ref, _ = got[0]
    assert port == ref == naive_greedy(cfg, model, prompt, 6)


def test_continuous_batching_matches_naive_and_reference(setup):
    _, _, cfg, model = setup

    def requests(R):
        rng = np.random.default_rng(0)
        return [R(rid=i, prompt=rng.integers(0, cfg.vocab_size, 3 + i),
                  max_new_tokens=4 + (i % 3)) for i in range(5)]

    got = run_both(setup, requests, 2, 64, "flash")
    assert sorted(got) == [0, 1, 2, 3, 4]
    for rid, (port, ref, r) in got.items():
        assert port == ref, rid
        assert port == naive_greedy(cfg, model, r.prompt, r.max_new_tokens)


def test_slot_reuse(setup):
    got = run_both(setup, lambda R: [
        R(rid=i, prompt=np.array([i + 1], np.int32), max_new_tokens=2)
        for i in range(3)], 1, 32)
    assert len(got) == 3
    assert all(port == ref and len(port) == 2
               for port, ref, _ in got.values())


def test_prefill_bucket_clamped_to_ring(setup):
    """bucket_len(40) = 64 > max_len 48: the bucket is clamped so pad
    writes never wrap the ring."""
    _, _, cfg, model = setup
    prompt = (np.arange(1, 41, dtype=np.int32) % cfg.vocab_size)
    got = run_both(setup, lambda R: [R(rid=0, prompt=prompt,
                                       max_new_tokens=4)], 1, 48, "flash")
    port, ref, _ = got[0]
    assert port == ref == naive_greedy(cfg, model, prompt, 4)


def test_refilled_slot_does_not_see_the_previous_request(setup):
    """A long request then a short one through one slot: the refill
    replaces the whole row, pos plane included, so the second request's
    tokens equal its own naive greedy decode."""
    _, _, cfg, model = setup
    eng = ServeEngine(cfg, model, batch_slots=1, max_len=64, device="cpu")
    long_prompt = np.arange(3, 40, dtype=np.int32)
    short_prompt = np.array([11, 4], np.int32)
    done = eng.run([Request(rid=0, prompt=long_prompt, max_new_tokens=5),
                    Request(rid=1, prompt=short_prompt, max_new_tokens=5)])
    assert done[1].generated == naive_greedy(cfg, model, short_prompt, 5)
    # the short request wrote positions 0 .. 5 only
    assert bool((eng.caches[0]["pos"][0, 2 + 4:] == INF_POS).all())


def test_bucket_len_and_steps():
    assert [bucket_len(n) for n in (1, 8, 9, 1024, 1025, 4096)] == \
        [8, 8, 16, 1024, 2048, 4096]
    cfg = get_config("internlm2-1.8b").reduced(dtype="float32",
                                               num_layers=1)
    model = lm.init(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    caches = lm.init_caches(cfg, 2, 16, device="cpu")
    with torch.no_grad():
        last, caches = make_prefill_step(cfg)(model, toks, caches)
        full, _, _ = lm.prefill(model, cfg, toks, None)
    torch.testing.assert_close(last, full[:, -1])
    step = make_serve_step(cfg)
    nxt, logits, _ = step(model, toks[:, :1], torch.tensor([12, 12]),
                          caches, None)
    assert nxt.dtype == torch.int32 and logits.dtype == torch.float32
    assert torch.equal(nxt, torch.argmax(logits, dim=-1).to(torch.int32))


def test_categorical_sampling_draws_on_the_generator():
    """Sampling draws on the explicit generator: the same seed gives the
    same tokens, and at a tiny temperature it is greedy."""
    cfg = get_config("internlm2-1.8b").reduced(dtype="float32",
                                               num_layers=1)
    model = lm.init(cfg, seed=2, device="cpu")
    toks = torch.tensor([[3], [7]], dtype=torch.int32)
    lens = torch.tensor([0, 0])

    def draw(seed, temperature):
        caches = lm.init_caches(cfg, 2, 8, device="cpu")
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return make_serve_step(cfg, "categorical", temperature)(
                model, toks, lens, caches, g)

    a, logits, _ = draw(0, 1.0)
    b, _, _ = draw(0, 1.0)
    assert torch.equal(a, b) and bool(((a >= 0) & (a < cfg.vocab_size)).all())
    cold, _, _ = draw(1, 1e-4)
    assert torch.equal(cold, torch.argmax(logits, dim=-1).to(torch.int32))


# --------------------------------------------------------------------------
# SLAScheduler (tests/test_scheduler_metrics.py::TestSLAScheduler)
# --------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture
def engine(setup):
    _, _, cfg, model = setup
    return ServeEngine(cfg, model, batch_slots=2, max_len=64, device="cpu")


class TestSLAScheduler:
    def test_infeasible_requests_rejected_upfront(self, engine):
        sched = SLAScheduler(engine, decode_rate_tps=10.0, clock=FakeClock())
        req = Request(rid=1, prompt=np.array([3, 4], np.int32),
                      max_new_tokens=100)
        # 100 tokens at 10 tok/s = 10s > 1s deadline
        assert not sched.submit(req, deadline=1.0)
        assert sched.rejected == [1]

    def test_feasible_requests_served_and_reported(self, engine):
        sched = SLAScheduler(engine, decode_rate_tps=1e9, clock=FakeClock())
        rng = np.random.default_rng(0)
        for i in range(4):
            assert sched.submit(
                Request(rid=i, prompt=rng.integers(0, 200, 4),
                        max_new_tokens=3), deadline=1e9)
        reports = sched.run()
        assert sorted(r.rid for r in reports) == [0, 1, 2, 3]
        s = sched.summary()
        assert s["served"] == 4 and s["rejected"] == 0
        assert s["sla_attainment"] == 1.0
        assert s["tokens"] == 4 * 3

    def test_edf_ordering(self, engine):
        sched = SLAScheduler(engine, decode_rate_tps=1e9, clock=FakeClock())
        rng = np.random.default_rng(1)
        for rid, dl in ((0, 500.0), (1, 400.0), (2, 100.0), (3, 200.0)):
            sched.submit(Request(rid=rid, prompt=rng.integers(0, 200, 3),
                                 max_new_tokens=2), deadline=dl)
        assert [r.rid for r in sched.queue.ordered_items()] == [2, 3, 1, 0]
        sched.run()
        assert sched.summary()["served"] == 4

    def test_summary_reports_latency_percentiles(self, engine):
        clock = FakeClock()
        sched = SLAScheduler(engine, decode_rate_tps=1e9, clock=clock)
        rng = np.random.default_rng(2)
        for i in range(3):
            sched.submit(Request(rid=i, prompt=rng.integers(0, 200, 3),
                                 max_new_tokens=2), deadline=1e9)
            clock.t += 1.0                   # staggered arrivals
        sched.run()
        s = sched.summary()
        # all finish together; latencies are the staggered waits 1s/2s/3s
        assert s["latency_p50_s"] == pytest.approx(2.0)
        longest = max(r.latency_s for r in sched.reports)
        assert s["latency_p50_s"] < s["latency_p99_s"] <= longest

    def test_zero_decode_rate_is_guarded(self, engine):
        """A zero rate estimates infinitely slow decode: finite deadlines
        reject upfront and deadline-free requests still run."""
        sched = SLAScheduler(engine, decode_rate_tps=0.0, clock=FakeClock())
        rng = np.random.default_rng(3)
        assert not sched.submit(
            Request(rid=0, prompt=rng.integers(0, 200, 3),
                    max_new_tokens=2), deadline=1e9)
        assert sched.submit(Request(rid=1, prompt=rng.integers(0, 200, 3),
                                    max_new_tokens=2),
                            deadline=float("inf"))
        assert [r.rid for r in sched.run()] == [1]
        assert sched.rejected == [0]


# --------------------------------------------------------------------------
# Mamba-2 (SSD blocks): raw prompts, recurrent states
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_setup():
    """mamba2-1.3b reduced (two SSD layers, chunk 32) in float32, weights
    from jax.random.PRNGKey(0)."""
    jcfg = jget_config("mamba2-1.3b").reduced(dtype="float32")
    cfg = get_config("mamba2-1.3b").reduced(dtype="float32")
    params = jax.jit(lambda k: jlm.init(k, jcfg)[0])(jax.random.PRNGKey(0))
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    return jcfg, params, cfg, model


def recurrent_greedy(cfg, model, prompt, n_new):
    """One request alone: a 1-row prefill, then one-token decode steps on
    its own state (a full re-prefill of each longer sequence would pass
    through lengths the chunked scan refuses)."""
    with torch.no_grad():
        caches = lm.init_caches(cfg, 1, 256, device="cpu")
        logits, caches, _ = lm.prefill(
            model, cfg, torch.from_numpy(np.asarray(prompt, np.int32))[None],
            caches)
        toks = [int(torch.argmax(logits[0, -1]))]
        for t in range(len(prompt), len(prompt) + n_new - 1):
            logits, caches, _ = lm.decode_step(
                model, cfg, torch.tensor([[toks[-1]]], dtype=torch.int32),
                torch.tensor([t]), caches)
            toks.append(int(torch.argmax(logits[0, -1])))
    return toks


@pytest.mark.parametrize("n", [20, 64])
def test_mamba_single_request_matches_reference(mamba_setup, n):
    """A prompt shorter than a chunk, and one of two chunks."""
    _, _, cfg, model = mamba_setup
    prompt = (np.arange(n, dtype=np.int32) * 7 + 3) % cfg.vocab_size
    got = run_both(mamba_setup, lambda R: [R(rid=0, prompt=prompt,
                                             max_new_tokens=6)], 2, 128)
    port, ref, _ = got[0]
    assert port == ref == recurrent_greedy(cfg, model, prompt, 6)


def test_mamba_continuous_batching_matches_reference(mamba_setup):
    _, _, cfg, model = mamba_setup

    def requests(R):
        rng = np.random.default_rng(5)
        lens = (5, 32, 17, 64, 1, 9)
        return [R(rid=i, prompt=rng.integers(0, cfg.vocab_size, n),
                  max_new_tokens=3 + (i % 3)) for i, n in enumerate(lens)]

    got = run_both(mamba_setup, requests, 2, 128)
    assert sorted(got) == list(range(6))
    for rid, (port, ref, r) in got.items():
        assert port == ref, rid
        assert port == recurrent_greedy(cfg, model, r.prompt,
                                        r.max_new_tokens)


def test_mamba_refilled_slot_does_not_see_the_previous_state(mamba_setup):
    """A 64-token request then a 3-token one through one slot: the refill
    replaces the row's SSM and conv states, so the second request's
    tokens and states equal its own from a fresh engine."""
    _, _, cfg, model = mamba_setup
    long_prompt = np.arange(3, 67, dtype=np.int32)
    short_prompt = np.array([11, 4, 9], np.int32)
    eng = ServeEngine(cfg, model, batch_slots=1, max_len=128, device="cpu")
    done = eng.run([Request(rid=0, prompt=long_prompt, max_new_tokens=4),
                    Request(rid=1, prompt=short_prompt, max_new_tokens=4)])
    fresh = ServeEngine(cfg, model, batch_slots=1, max_len=128,
                        device="cpu")
    alone = fresh.run([Request(rid=1, prompt=short_prompt,
                               max_new_tokens=4)])
    assert done[1].generated == alone[0].generated == recurrent_greedy(
        cfg, model, short_prompt, 4)
    for c, f in zip(eng.caches, fresh.caches):
        for name in ("ssm", "conv"):
            torch.testing.assert_close(c[name], f[name], rtol=0, atol=0)


def test_mamba_prompt_of_no_whole_chunk_is_refused(mamba_setup):
    """40 tokens at chunk 32: the chunked scan asserts in both packages
    (models/ssm.py:71); the port's slot stays free and the engine serves
    the next request."""
    jcfg, params, cfg, model = mamba_setup
    prompt = np.arange(1, 41, dtype=np.int32)
    with pytest.raises(AssertionError, match="40, 32"):
        JServeEngine(jcfg, params, batch_slots=1, max_len=128).submit(
            JRequest(rid=0, prompt=prompt, max_new_tokens=2))
    eng = ServeEngine(cfg, model, batch_slots=1, max_len=128, device="cpu")
    with pytest.raises(AssertionError, match="40, 32"):
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=2))
    assert eng.slots == [None]
    done = eng.run([Request(rid=1, prompt=prompt[:32], max_new_tokens=2)])
    assert [r.rid for r in done] == [1] and len(done[0].generated) == 2
