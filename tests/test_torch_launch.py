"""The port's train and serve launchers (repro_torch.launch.train,
repro_torch.launch.serve) on the CPU, at reduced sizes.

The train launcher writes checkpoints in the reference's layout, a
heartbeat and a metrics JSONL; a second call with more steps resumes, and
a supervised run that crashes resumes: both end bit for bit where one
uninterrupted call ends. It resumes a reduced bf16 run that the
reference's launcher checkpointed, and re-saves it byte for byte."""
import dataclasses
import json
import shutil
import zipfile

import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models import lm

ARCHS = ("mamba2-1.3b", "internlm2-1.8b")
SMALL = ["--reduced", "--seq-len", "16", "--global-batch", "2",
         "--device", "cpu"]


def args(arch, steps, ck=None, every=2, extra=()):
    out = ["--arch", arch, "--steps", str(steps), *SMALL, *extra]
    if ck is not None:
        out += ["--checkpoint-dir", str(ck), "--checkpoint-every",
                str(every)]
    return out


def members(ck, step):
    with zipfile.ZipFile(ck / f"step_{step:010d}" / "arrays.npz") as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def manifest(ck, step):
    m = json.loads((ck / f"step_{step:010d}" / "manifest.json").read_text())
    m.pop("time")
    return m


@pytest.mark.parametrize("arch", ARCHS)
def test_train_writes_checkpoints_heartbeat_and_metrics(tmp_path, arch,
                                                        capsys):
    state = train.main(args(arch, 4, tmp_path / "ck", extra=(
        "--heartbeat-dir", str(tmp_path / "hb"),
        "--metrics-file", str(tmp_path / "m.jsonl"))))
    assert int(state["step"]) == 4
    out = capsys.readouterr().out
    assert "done at step 4 (restarts: 0)" in out
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_0000000002", "step_0000000004"]
    m = manifest(tmp_path / "ck", 4)
    assert m["step"] == 4 and m["user"] == {"final": True}
    assert manifest(tmp_path / "ck", 2)["user"] == {"arch": arch}
    dtypes = {v["dtype"] for v in m["leaves"].values()}
    assert dtypes == {"bfloat16", "float32", "int32"}
    assert m["leaves"]["step"] == {"shape": [], "dtype": "int32"}
    beat = json.loads((tmp_path / "hb" / "host-0.heartbeat").read_text())
    assert beat["host"] == "host-0" and beat["step"] == 4
    recs = [json.loads(line) for line in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and r["step_s"] > 0 for r in recs)


@pytest.mark.parametrize("arch", ARCHS)
def test_second_call_resumes_bit_for_bit(tmp_path, arch, capsys):
    train.main(args(arch, 5, tmp_path / "one"))
    train.main(args(arch, 3, tmp_path / "two"))
    train.main(args(arch, 5, tmp_path / "two"))
    assert "[restore] resumed from step 3" in capsys.readouterr().out
    assert members(tmp_path / "two", 5) == members(tmp_path / "one", 5)
    assert manifest(tmp_path / "two", 5) == manifest(tmp_path / "one", 5)


class CrashOnce:
    """Wraps the built step: call number `at` runs the real step (which
    updates the state in place) and then raises, once."""

    def __init__(self, at):
        self.at, self.calls = at, 0

    def __call__(self, fn):
        def step(state, batch):
            self.calls += 1
            out = fn(state, batch)
            if self.calls == self.at:
                del out
                raise RuntimeError("simulated host failure")
            return out
        return step


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("crash_at", [4, 1], ids=["after_save",
                                                  "before_any_save"])
def test_supervised_crash_resumes_bit_for_bit(tmp_path, arch, crash_at,
                                              capsys):
    """A crash after the step-3 save rolls back to step 3; one before any
    save re-draws the fresh state. Either way the run restarts once and
    its last checkpoint equals an uninterrupted run's."""
    crash = CrashOnce(crash_at)
    state = train.main(args(arch, 5, tmp_path / "crash", every=3),
                       wrap_step=crash)
    out = capsys.readouterr().out
    assert "done at step 5 (restarts: 1)" in out
    assert ("[restore] resumed from step 3" in out) == (crash_at == 4)
    assert crash.calls == 6
    assert int(state["step"]) == 5
    train.main(args(arch, 5, tmp_path / "plain", every=3))
    assert members(tmp_path / "crash", 5) == members(tmp_path / "plain", 5)


def test_cross_package_resume_of_a_bf16_run(tmp_path, capsys):
    """The reference's launcher checkpoints a reduced bf16 internlm2 run
    (which it cannot resume itself: ROADMAP.md queue 3); the port's
    launcher restores it and, at --steps equal to the saved step, re-saves
    it: every member byte for byte."""
    ck = tmp_path / "ck"
    common = ["--reduced", "--steps", "2", "--seq-len", "16",
              "--global-batch", "2", "--checkpoint-dir", str(ck),
              "--checkpoint-every", "1"]
    jtrain.main(common)
    shutil.copytree(ck / "step_0000000002", tmp_path / "ref")
    with zipfile.ZipFile(tmp_path / "ref" / "arrays.npz") as zf:
        want = {n: zf.read(n) for n in zf.namelist()}
    state = train.main(common + ["--device", "cpu"])
    assert "[restore] resumed from step 2" in capsys.readouterr().out
    assert int(state["step"]) == 2
    assert state["params"].embed.dtype == torch.bfloat16
    assert members(ck, 2) == want
    ref_manifest = json.loads((tmp_path / "ref" / "manifest.json")
                              .read_text())
    ref_manifest.pop("time")
    assert manifest(ck, 2) == ref_manifest


@pytest.mark.parametrize("mesh, ok", [("2", False), ("1,2", False),
                                      ("1", True), ("1,1", True)])
def test_mesh_beyond_one_position_names_10c(tmp_path, mesh, ok):
    argv = args("mamba2-1.3b", 1, extra=("--mesh", mesh))
    if ok:
        assert int(train.main(argv)["step"]) == 1
    else:
        with pytest.raises(NotImplementedError, match="10c"):
            train.main(argv)


def test_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "mamba2-1.3b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mamba2-1.3b", "--requests", "1"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_answers_every_request(arch, capsys):
    done = serve.main(["--arch", arch, "--requests", "6", "--max-new", "5",
                       "--slots", "4", "--device", "cpu"])
    assert sorted(r.rid for r in done) == list(range(6))
    vocab = get_config(arch).reduced().vocab_size
    for r in done:
        assert len(r.generated) == 5
        assert all(0 <= t < vocab for t in r.generated)
    out = capsys.readouterr().out
    assert "served 6 requests, 30 tokens" in out and "p99=" in out


@pytest.mark.parametrize("flag, reduced", [((), True), (("--reduced",), True),
                                           (("--no-reduced",), False)])
def test_serve_reduced_flag(monkeypatch, flag, reduced):
    """--reduced stays on by default; --no-reduced serves the config as
    get_config gives it (here a small stand-in, so that nothing full-width
    is built on the CPU)."""
    small = dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                                name="stand-in")
    monkeypatch.setattr(serve, "get_config", lambda arch: small)
    seen = []
    real = lm.init
    monkeypatch.setattr(lm, "init", lambda cfg, **kw: (seen.append(cfg),
                                                       real(cfg, **kw))[1])
    serve.main(["--requests", "1", "--max-new", "2", "--device", "cpu",
                *flag])
    assert (seen[0] is small) != reduced
