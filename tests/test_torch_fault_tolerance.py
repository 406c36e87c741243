"""The port's fault tolerance (repro_torch.dist.fault_tolerance) against
the reference's, on the CPU; stands in for tests/test_fault_tolerance.py
and tests/test_resilience.py::TestTornFiles.

Heartbeats, the straggler detector and the restart policy are driven
through one scripted sequence under a VirtualClock in both packages and
must give the same verdicts and numbers. The slice as a whole: reduced
fp32 internlm2 trains 6 steps under run_supervised with a crash at step
3, checkpointed by the port's CheckpointManager in the reference's
layout; the result equals the port's uninterrupted run bit for bit, and
the reference's supervised run within tests/test_torch_train.py's
MAMBA_TOL (its tolerance for a quantity taken after optimizer steps)."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist import fault_tolerance as jft
from repro.resilience import FaultInjector as JFaultInjector
from repro.resilience import FaultSpec as JFaultSpec
from repro.serve.sla import VirtualClock as JVirtualClock
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist.fault_tolerance import (Heartbeat, RestartPolicy,
                                              StragglerDetector,
                                              run_supervised)
from repro_torch.models import convert
from repro_torch.resilience import FaultInjector, FaultSpec
from repro_torch.serve.sla import VirtualClock
from repro_torch.train import optim, step as step_lib

MAMBA_TOL = dict(rtol=2e-3, atol=2e-3)     # tests/test_torch_train.py's


# --------------------------------------------------------------------------
# one scripted sequence through both packages
# --------------------------------------------------------------------------

def heartbeat_script(hb_cls, clock, root):
    """Three hosts beat, stall, lag and come back on a virtual clock; the
    verdicts after each event."""
    a = hb_cls(root, "node.0", timeout_s=10.0, clock=clock)
    b = hb_cls(root, "node.1", timeout_s=10.0, clock=clock)
    c = hb_cls(root, "plain", timeout_s=10.0, clock=clock)
    out = []

    def look(label):
        out.append((label, a.fleet(), a.dead_hosts(),
                    a.lagging_hosts(behind_steps=5),
                    a.lagging_hosts(behind_steps=1)))

    look("empty")
    a.beat(1)
    b.beat(1)
    look("two")
    clock.advance(4.0)
    c.beat(0)
    look("three")
    clock.advance(7.0)
    a.beat(12)
    look("b stale")
    b.beat(8)
    clock.advance(9.5)
    c.beat(13)
    look("a at the edge")
    clock.advance(1.0)
    look("a dead")
    leftovers = sorted(p.name for p in root.iterdir()
                       if not p.name.endswith(".heartbeat"))
    return out, leftovers


def straggler_script(det_cls):
    det = det_cls(threshold=2.0, warmup=3, window=4)
    times = [1.0, 1.1, 0.9, 5.0, 1.0, 2.5, 1.05, 1.2, 9.0, 0.95, 2.01,
             1.0, 3.0, 1.1]
    verdicts = [det.observe(s, t) for s, t in enumerate(times)]
    return verdicts, det.flagged, det.ewma, det._clean


def supervise_script(policy_cls, supervise, clock):
    calls = {"n": 0}

    def loop(state):
        calls["n"] += 1
        if calls["n"] <= 3:
            raise RuntimeError(f"boom {calls['n']}")
        return state + 100

    restores = []

    def restore():
        restores.append(clock())
        return len(restores)

    out, policy = supervise(loop, restore,
                            policy_cls(max_restarts=3, backoff_s=0.25),
                            clock=clock)
    return (out, policy.restarts, policy.failures, restores, clock(),
            [policy.backoff(k) for k in (1, 2, 5)])


def test_heartbeats_match_reference(tmp_path):
    got = heartbeat_script(Heartbeat, VirtualClock(), tmp_path / "port")
    want = heartbeat_script(jft.Heartbeat, JVirtualClock(), tmp_path / "ref")
    assert got == want
    assert got[0][-1][2] == ["node.0", "node.1"] and got[1] == []


def test_straggler_detector_matches_reference():
    got = straggler_script(StragglerDetector)
    want = straggler_script(jft.StragglerDetector)
    assert got == want
    assert got[1] and not got[0][0]


def test_supervision_and_backoff_match_reference():
    got = supervise_script(RestartPolicy, run_supervised, VirtualClock())
    want = supervise_script(jft.RestartPolicy, jft.run_supervised,
                            JVirtualClock())
    assert got == want
    assert got[0] == 104 and got[1] == 3 and got[4] == pytest.approx(1.5)


@pytest.mark.parametrize("kw, match", [({"backoff_s": -1.0}, "backoff_s"),
                                       ({"backoff_s": float("nan")},
                                        "backoff_s"),
                                       ({"max_restarts": -1},
                                        "max_restarts")])
def test_policy_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        RestartPolicy(**kw)
    with pytest.raises(ValueError, match=match):
        jft.RestartPolicy(**kw)


def test_backoff_rejects_restart_zero():
    with pytest.raises(ValueError, match="restart="):
        RestartPolicy().backoff(0)


def test_gives_up_after_max_restarts():
    def loop(_):
        raise RuntimeError("persistent failure")

    policy = RestartPolicy(max_restarts=2)
    with pytest.raises(RuntimeError, match="persistent"):
        run_supervised(loop, lambda: None, policy)
    assert policy.restarts == 3 and len(policy.failures) == 3


def test_backoff_sleeps_on_wall_clock(monkeypatch):
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    calls = {"n": 0}

    def loop(_):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        return "ok"

    out, policy = run_supervised(
        loop, lambda: None, RestartPolicy(max_restarts=1, backoff_s=0.2))
    assert out == "ok" and slept == [pytest.approx(0.2)]


def test_dotted_hostnames_beat_atomically(tmp_path):
    for host in ("node.0", "node.1", "plain"):
        Heartbeat(tmp_path, host).beat(1)
    assert Heartbeat(tmp_path, "node.0").fleet() == ["node.0", "node.1",
                                                     "plain"]
    assert [p.name for p in tmp_path.iterdir()
            if not p.name.endswith(".heartbeat")] == []


def test_torn_heartbeat_reads_as_missing(tmp_path):
    clk = VirtualClock()
    hb = Heartbeat(tmp_path / "port", "node.0", timeout_s=10, clock=clk)
    hb.beat(3)
    assert hb.fleet() == ["node.0"]
    assert FaultInjector(FaultSpec(seed=6)).tear_file(
        tmp_path / "port" / "node.0.heartbeat")
    assert hb.fleet() == [] and hb.dead_hosts() == []
    hb.beat(4)
    assert hb.fleet() == ["node.0"]
    # the same seed tears the reference's beat at the same byte
    jhb = jft.Heartbeat(tmp_path / "ref", "node.0", timeout_s=10,
                        clock=JVirtualClock())
    jhb.beat(3)
    JFaultInjector(JFaultSpec(seed=6)).tear_file(
        tmp_path / "ref" / "node.0.heartbeat")
    torn = (tmp_path / "ref" / "node.0.heartbeat").read_bytes()
    hb2 = Heartbeat(tmp_path / "port2", "node.0", timeout_s=10,
                    clock=VirtualClock())
    hb2.beat(3)
    FaultInjector(FaultSpec(seed=6)).tear_file(
        tmp_path / "port2" / "node.0.heartbeat")
    assert (tmp_path / "port2" / "node.0.heartbeat").read_bytes() == torn


# --------------------------------------------------------------------------
# the slice as a whole: supervised crash-restart of a train run
# --------------------------------------------------------------------------

STEPS, CRASH_AT = 6, 3
OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=10)


@pytest.fixture(scope="module")
def setup():
    """Reduced fp32 internlm2 (2 layers) as in the reference's test, its
    initial train state drawn by the reference, as numpy."""
    jcfg = jget_config("internlm2-1.8b").reduced(dtype="float32",
                                                 num_layers=2)
    cfg = get_config("internlm2-1.8b").reduced(dtype="float32",
                                               num_layers=2)
    jopt = joptim.AdamWConfig(**OPT)
    init, _ = jstep.init_state(jax.random.PRNGKey(0), jcfg, jopt)
    return jcfg, cfg, jax.tree.map(np.asarray, init)


def port_state(cfg, init_np):
    return convert.state_from_reference(init_np, cfg, device="cpu")


def port_batch(ds, s):
    return {k: torch.from_numpy(v) for k, v in ds.batch(s).items()}


def flat_bits(state) -> dict:
    tree = convert.state_to_reference(state)
    out = {}

    def rec(node, prefix):
        if isinstance(node, dict):
            for k in node:
                rec(node[k], f"{prefix}{k}.")
        elif isinstance(node, tuple):
            for i, v in enumerate(node):
                rec(v, f"{prefix}{i}.")
        else:
            out[prefix[:-1]] = node.detach().numpy().copy()
    rec(tree, "")
    return out


def reference_supervised(jcfg, init_np, tmp_path):
    """tests/test_fault_tolerance.py's supervised run, verbatim in
    substance: crash at step 3, restore from the per-step checkpoints."""
    opt_cfg = joptim.AdamWConfig(**OPT)
    ds = JSyntheticLM(JDataConfig(seed=1, vocab_size=jcfg.vocab_size,
                                  seq_len=16, global_batch=2))
    step_fn = jax.jit(jstep.make_train_step(jcfg, opt_cfg))
    init = jax.tree.map(jnp.asarray, init_np)
    mgr = JCheckpointManager(tmp_path)
    mgr.save(0, init)
    armed = {"on": True}

    def restore():
        return mgr.restore(init)[0]

    def loop(state):
        s = int(state["step"])
        while s < STEPS:
            if armed["on"] and s == CRASH_AT:
                armed["on"] = False
                raise RuntimeError("simulated host failure")
            batch = {k: jnp.asarray(v) for k, v in ds.batch(s).items()}
            state, _ = step_fn(state, batch)
            s = int(state["step"])
            mgr.save(s, state)
        return state

    final, policy = jft.run_supervised(loop, restore,
                                       jft.RestartPolicy(max_restarts=2))
    assert policy.restarts == 1
    return jax.tree.map(np.asarray, final)


def test_supervised_restart_resumes_bit_for_bit(setup, tmp_path):
    jcfg, cfg, init_np = setup
    opt_cfg = optim.AdamWConfig(**OPT)
    ds = SyntheticLM(DataConfig(seed=1, vocab_size=cfg.vocab_size,
                                seq_len=16, global_batch=2))
    step_fn = step_lib.make_train_step(cfg, opt_cfg)

    # uninterrupted, on a fresh state
    ref = port_state(cfg, init_np)
    while int(ref["step"]) < STEPS:
        ref.update(step_fn(ref, port_batch(ds, int(ref["step"])))[0])
    want = flat_bits(ref)
    del ref

    # crashing run: the step at CRASH_AT updates the state in place and
    # then the host fails, so the restore must overwrite every leaf
    state = port_state(cfg, init_np)
    mgr = CheckpointManager(tmp_path / "port", async_save=True)
    mgr.save(0, convert.state_to_reference(state))
    armed = {"on": True}

    def restore():
        mgr.wait()
        skeleton = convert.state_to_reference(state)
        skeleton = jax.tree.map(lambda t: torch.empty_like(t), skeleton,
                                is_leaf=torch.is_tensor)
        tree, meta = mgr.restore(skeleton)
        convert.load_reference_state(state, tree)
        return state

    def loop(state):
        while int(state["step"]) < STEPS:
            s = int(state["step"])
            new, _ = step_fn(state, port_batch(ds, s))
            if armed["on"] and s == CRASH_AT:
                armed["on"] = False
                raise RuntimeError("simulated host failure")
            state.update(new)
            mgr.save(int(state["step"]), convert.state_to_reference(state))
        return state

    final, policy = run_supervised(loop, restore,
                                   RestartPolicy(max_restarts=2))
    mgr.wait()
    assert policy.restarts == 1 and final is state
    assert mgr.latest_step() == STEPS
    got = flat_bits(final)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k

    # the reference's own supervised run, through convert
    ref_final = reference_supervised(jcfg, init_np, tmp_path / "ref")
    for k, v in got.items():
        node = ref_final
        for part in k.split("."):
            node = node[int(part) if part.isdigit() else part]
        np.testing.assert_allclose(v, np.asarray(node), err_msg=k,
                                   **MAMBA_TOL)
