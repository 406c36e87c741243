"""Supervision inside a torch.distributed world, on the CPU: gloo ranks,
`device="cpu"`.

- `world.supervise` against the reference's `run_supervised`: a
  2-rank world whose rank 1 fails (raises, or dies by os._exit) on a
  scripted set of attempts, and the reference's loop failing on the same
  calls, give the same value, restarts, failures and re-raise, and the
  same virtual time, under a VirtualClock that takes the backoff.
- The reference's supervised run on ranks: tests/multidevice_child.py's
  `check_elastic_rescale` set-up on an 8-rank (2, 4) world, a
  checkpoint a step gathered and written by rank 0, rank 5 failing at
  step 3 of the first world; the second world restores its blocks from
  step 2 and ends bit for bit as its own uninterrupted run, and within
  ELASTIC_TOL of the reference's (`elastic_ref`: the reference's
  supervised run resumes bit for bit in its own process).
- The launcher under `launch.train.run_world`: rank 5 dies at the start
  of its 3rd step call, or rank 0 dies inside its step-4 checkpoint
  write; one restart, the reference's two printed lines, eight
  heartbeats, the metrics of every step, and a final checkpoint equal
  to the run with no fault, member for member.
- Refusals: `--max-restarts` on a rank of a plain `spawn` world.
"""
from __future__ import annotations

import json
import os
import time
import zipfile
from pathlib import Path

import pytest

from repro_torch.dist import world
from repro_torch.dist.fault_tolerance import Heartbeat, RestartPolicy
from repro_torch.serve.sla import VirtualClock

# The ranks unpickle their functions from this module, so it imports
# nothing of JAX at its top (that would add ~3 s to each rank's start):
# the reference's side is imported where the parent uses it.

DEADLINE_S = 120
TIMEOUT_S = 60
# a backoff that a real sleep would make the tests' whole budget: the
# supervisor must take it on the VirtualClock
BACKOFF_S = 600.0
WORLD = 8
FAULT_RANK, FAULT_CALL = 5, 3         # dies at the start of this step call
LAUNCH = ["--arch", "mamba2-1.3b", "--reduced", "--seq-len", "16",
          "--global-batch", "4", "--mesh", "2,4", "--device", "cpu",
          "--lr", "1e-3", "--steps", "4", "--checkpoint-every", "2",
          "--max-restarts", "2"]
HOSTS = [f"host-{r}" for r in range(WORLD)]


# --------------------------------------------------------------------------
# what the ranks run (module level, so a spawned rank can unpickle it)
# --------------------------------------------------------------------------

def _scripted(fail_on: tuple, how: str) -> int:
    """Rank 1 fails on the attempts in `fail_on`, by an exception or by
    os._exit(1); the world's value is 100 + its attempt."""
    import torch.distributed as dist
    # both ranks past their connections first: a rank 0 that returned
    # and closed them could fail rank 1's process-group start instead
    dist.barrier()
    a = world.attempt()
    if dist.get_rank() == 1 and a in fail_on:
        if how == "exit":
            os._exit(1)
        raise RuntimeError(f"boom {a}")
    return 100 + a


def _elastic_supervised(init_file: str, ck_dir: str) -> dict:
    """check_elastic_rescale's (2, 4) run of 4 steps under supervision,
    from the reference's initial state (pickled in `init_file`: as a
    spawn argument its 1.7 MB would hold each rank's start until the one
    before has imported this module): a checkpoint after every step,
    gathered and written by rank 0; rank 5 raises at step 3 of attempt
    0; a later attempt restores this rank's blocks of the latest
    checkpoint, and also runs the 4 steps uninterrupted."""
    import pickle

    import torch.distributed as dist
    from test_torch_specs import ELASTIC_OPT
    from test_torch_world_train import _gather_state, _run, _setup, _tiny

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import convert
    with open(init_file, "rb") as f:
        init_np = pickle.load(f)
    cfg = _tiny()
    mesh, fn, state, sh, bsh, ds = _setup(cfg, (2, 4), 8, ELASTIC_OPT,
                                          init_np)
    ref_sh = convert.shardings_to_reference(state, sh)
    mgr = CheckpointManager(ck_dir)
    restored = mgr.latest_step()
    if restored is not None:
        tree, _ = mgr.restore(convert.state_to_reference(state),
                              step=restored, shardings=ref_sh)
        convert.load_reference_state(state, tree)
    for s in range(restored or 0, 4):
        if world.attempt() == 0 and dist.get_rank() == FAULT_RANK and s == 2:
            raise RuntimeError(f"rank {FAULT_RANK} fails at step 3")
        _run(fn, state, ds, mesh, bsh, s, s + 1)
        mgr.save(s + 1, convert.state_to_reference(state),
                 shardings=ref_sh)
    out = {"attempt": world.attempt(), "restored": restored,
           "steps": mgr.all_steps(), "final": _gather_state(state, sh, cfg)}
    if world.attempt():
        _, _, whole, _, _, _ = _setup(cfg, (2, 4), 8, ELASTIC_OPT, init_np)
        _run(fn, whole, ds, mesh, bsh, 0, 4)
        out["uninterrupted"] = _gather_state(whole, sh, cfg)
    return out


class Probe:
    """run_world's `wrap_step`, on every rank of every world: rank 0's
    printed lines go to `root`/rank0.out; with `fault="step"` rank 5 of
    the first world dies at the start of its 3rd step call, once the
    step-2 checkpoint is published; with `fault="writer"` rank 0 of the
    first world dies inside its step-4 checkpoint write, after the
    arrays and before the rename. Rank 0 of a later world lists the
    checkpoint directory as it finds it (`root`/found.json)."""

    def __init__(self, root: str, ck_dir: str, fault: str | None = None):
        self.root, self.ck, self.fault = Path(root), Path(ck_dir), fault

    def __call__(self, step_fn):
        import sys

        import torch.distributed as dist
        rank, attempt = dist.get_rank(), world.attempt()
        if rank == 0:
            sys.stdout = open(self.root / "rank0.out", "a", buffering=1)
            if attempt:
                (self.root / "found.json").write_text(json.dumps(sorted(
                    p.name for p in self.ck.iterdir())))
        if self.fault == "writer" and rank == 0 and attempt == 0:
            from repro_torch.checkpoint import store
            real = store._write_npz

            def write_then_die(path, host):
                real(path, host)
                if path.parent.name == "step_0000000004.tmp":
                    os._exit(1)
            store._write_npz = write_then_die
        calls = [0]

        def step(state, batch):
            calls[0] += 1
            if (self.fault == "step" and rank == FAULT_RANK and attempt == 0
                    and calls[0] == FAULT_CALL):
                published = self.ck / "step_0000000002"
                t0 = time.monotonic()
                while not published.exists():
                    if time.monotonic() - t0 > DEADLINE_S:
                        raise TimeoutError(f"no {published}")
                    time.sleep(0.02)
                os._exit(1)
            return step_fn(state, batch)
        return step


def _refusals(hb_dir: str) -> str | None:
    """On a rank of a plain spawn world: main with --max-restarts (its
    ValueError's message), then main with --heartbeat-dir alone."""
    from repro_torch.launch import train
    argv = ["--arch", "mamba2-1.3b", "--reduced", "--seq-len", "16",
            "--global-batch", "2", "--steps", "1", "--device", "cpu"]
    try:
        train.main(argv + ["--max-restarts", "2"])
    except ValueError as e:
        message = str(e)
    else:
        message = None
    train.main(argv + ["--heartbeat-dir", hb_dir])
    return message


# --------------------------------------------------------------------------
# helpers of the parent
# --------------------------------------------------------------------------

def _outcome(run, policy, clock) -> tuple:
    """({value, restarts, failures, raised, clock}, the exception)."""
    try:
        value, _ = run()
        err = None
    except RuntimeError as e:
        value, err = None, e
    return ({"value": value, "restarts": policy.restarts,
             "failures": len(policy.failures), "raised": err is not None,
             "clock": clock()}, err)


def _reference_script(fail_on: tuple, max_restarts: int) -> tuple:
    """The reference's run_supervised over a loop whose call k fails
    where `_scripted`'s attempt k does."""
    from repro.dist import fault_tolerance as jft
    from repro.serve.sla import VirtualClock as JVirtualClock
    calls = {"n": 0}

    def loop(_):
        a = calls["n"]
        calls["n"] += 1
        if a in fail_on:
            raise RuntimeError(f"boom {a}")
        return 100 + a

    clock = JVirtualClock()
    policy = jft.RestartPolicy(max_restarts=max_restarts,
                               backoff_s=BACKOFF_S)
    return _outcome(lambda: jft.run_supervised(loop, lambda: None, policy,
                                               clock=clock), policy, clock)


def _run_world(tmp_path_factory, name: str, fault: str | None) -> dict:
    from repro_torch.launch import train
    root = tmp_path_factory.mktemp(name)
    ck, hb, metrics = root / "ck", root / "hb", root / "m.jsonl"
    argv = LAUNCH + ["--checkpoint-dir", str(ck), "--heartbeat-dir",
                     str(hb), "--metrics-file", str(metrics)]
    step, policy = train.run_world(
        argv, WORLD, backend="gloo", device="cpu",
        wrap_step=Probe(str(root), str(ck), fault),
        deadline_s=DEADLINE_S, timeout_s=TIMEOUT_S)
    found = root / "found.json"
    return {"step": step, "policy": policy, "ck": ck, "hb": hb,
            "lines": (root / "rank0.out").read_text().splitlines(),
            "metrics": [json.loads(x)["step"] for x in
                        metrics.read_text().splitlines()],
            "found": json.loads(found.read_text()) if found.exists()
            else None}


def _members(ck: Path, step: int) -> dict:
    """Every member of a checkpoint's arrays.npz, as bytes."""
    with zipfile.ZipFile(ck / f"step_{step:010d}" / "arrays.npz") as zf:
        return {n: zf.read(n) for n in zf.namelist()}


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def faulted(tmp_path_factory):
    return _run_world(tmp_path_factory, "faulted", "step")


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    return _run_world(tmp_path_factory, "clean", None)


@pytest.fixture(scope="module")
def killed_writer(tmp_path_factory):
    return _run_world(tmp_path_factory, "killed_writer", "writer")


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fail_on, how, max_restarts", [
    ((0,), "raise", 2), ((0,), "exit", 2), ((0, 1), "raise", 1),
    ((0,), "raise", 0)], ids=["raise", "exit", "exhausted", "no-budget"])
def test_supervise_matches_the_reference_run_supervised(fail_on, how,
                                                        max_restarts):
    """The same restarts, failures, value or re-raise and virtual time
    as the reference's run_supervised; the backoff is taken on the
    VirtualClock (a real sleep would outlast the test); the error names
    rank 1."""
    clock = VirtualClock()
    policy = RestartPolicy(max_restarts=max_restarts, backoff_s=BACKOFF_S)
    t0 = time.monotonic()
    got, err = _outcome(lambda: world.supervise(
        _scripted, 2, backend="gloo", policy=policy, args=(fail_on, how),
        deadline_s=DEADLINE_S, timeout_s=TIMEOUT_S, clock=clock),
        policy, clock)
    assert time.monotonic() - t0 < BACKOFF_S / 2
    want, want_err = _reference_script(fail_on, max_restarts)
    assert got == want
    assert (err is None) == (want_err is None)
    if err is not None:
        assert isinstance(err, world.RankError) and err.rank == 1
    for failure in policy.failures:
        assert failure.startswith("RankError('rank 1: ")
        assert ("boom" if how == "raise" else "exited with code 1") \
            in failure


def test_supervised_elastic_run_on_ranks_resumes_bit_for_bit(
        tmp_path_factory):
    """Rank 5 fails at step 3 of the first world; the second restores its
    blocks from step 2 and ends bit for bit as its uninterrupted run,
    within ELASTIC_TOL of the reference's (2, 4) run."""
    from test_torch_specs import ELASTIC_TOL, assert_state, reference_outputs
    from test_torch_world_train import _port_state, _same_tree, _tiny
    import pickle
    ref = reference_outputs(tmp_path_factory)
    root = tmp_path_factory.mktemp("elastic_supervised")
    with open(root / "init.pkl", "wb") as f:
        pickle.dump(ref["elastic_init"], f)
    policy = RestartPolicy(max_restarts=2)
    got, _ = world.supervise(
        _elastic_supervised, WORLD, backend="gloo", policy=policy,
        args=(str(root / "init.pkl"), str(root / "ck")),
        deadline_s=DEADLINE_S, timeout_s=TIMEOUT_S)
    assert policy.restarts == 1 and len(policy.failures) == 1
    assert f"rank {FAULT_RANK}: RuntimeError" in policy.failures[0]
    assert got["attempt"] == 1 and got["restored"] == 2
    assert got["steps"] == [2, 3, 4]
    _same_tree(got["final"], got["uninterrupted"])
    cfg = _tiny()
    assert_state(_port_state(got["final"], cfg), ref["elastic_ref"], cfg,
                 ELASTIC_TOL, ELASTIC_TOL)


def test_a_rank_that_dies_mid_step_restarts_the_whole_world(faulted):
    """One restart, charged to rank 5; rank 0 of the second world prints
    the reference's two lines, and only that world finishes."""
    policy = faulted["policy"]
    assert faulted["step"] == 4
    assert policy.restarts == 1 and len(policy.failures) == 1
    assert f"rank {FAULT_RANK}: exited with code 1" in policy.failures[0]
    lines = faulted["lines"]
    assert "[restore] resumed from step 2" in lines
    assert [x for x in lines if x.startswith("done")] == \
        ["done at step 4 (restarts: 1)"]
    assert lines.index("[restore] resumed from step 2") < \
        lines.index("done at step 4 (restarts: 1)")


def test_every_rank_beats_its_heartbeat(faulted):
    hb = Heartbeat(faulted["hb"], "x")
    assert hb.fleet() == HOSTS
    for host in HOSTS:
        rec = json.loads((faulted["hb"] / f"{host}.heartbeat").read_text())
        assert rec["step"] == 4, host


def test_metrics_hold_each_step_once_in_order(faulted):
    """Steps 1-2 of the first world, 3-4 of the second, appended."""
    assert faulted["metrics"] == [1, 2, 3, 4]


def test_the_restarted_world_ends_as_the_run_with_no_fault(faulted, clean):
    assert clean["policy"].restarts == 0 and clean["step"] == 4
    assert "done at step 4 (restarts: 0)" in clean["lines"]
    assert clean["metrics"] == [1, 2, 3, 4]
    from repro_torch.checkpoint import CheckpointManager
    for run in (faulted, clean):
        assert CheckpointManager(run["ck"]).all_steps() == [2, 4]
    want = _members(clean["ck"], 4)
    assert len(want) > 10
    assert _members(faulted["ck"], 4) == want


def test_a_writer_killed_mid_write_leaves_a_tmp_that_the_restart_replaces(
        killed_writer, clean):
    """Rank 0 died after step 4's arrays and before the rename: the next
    world found step_4.tmp beside step 2, resumed from step 2, replaced
    the .tmp, and ended as the run with no fault."""
    from repro_torch.checkpoint import CheckpointManager
    run = killed_writer
    assert run["policy"].restarts == 1
    assert "rank 0: exited with code 1" in run["policy"].failures[0]
    assert run["found"] == ["step_0000000002", "step_0000000004.tmp"]
    assert "[restore] resumed from step 2" in run["lines"]
    assert "done at step 4 (restarts: 1)" in run["lines"]
    assert sorted(p.name for p in run["ck"].iterdir()) == \
        ["step_0000000002", "step_0000000004"]
    assert CheckpointManager(run["ck"]).all_steps() == [2, 4]
    assert _members(run["ck"], 4) == _members(clean["ck"], 4)


def test_a_plain_spawn_world_refuses_restarts_and_beats_every_rank(
        tmp_path):
    hb = tmp_path / "hb"
    message = world.spawn(_refusals, 2, backend="gloo", args=(str(hb),),
                          deadline_s=DEADLINE_S, timeout_s=TIMEOUT_S)
    assert message is not None and "run_world" in message
    assert Heartbeat(hb, "x").fleet() == ["host-0", "host-1"]
    for host in ("host-0", "host-1"):
        assert json.loads((hb / f"{host}.heartbeat").read_text())[
            "step"] == 1
