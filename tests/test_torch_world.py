"""The port's worlds of ranks (repro_torch.dist.world) and its meshes over
them (repro_torch.launch.mesh.make_mesh(..., group=)), on the CPU.

Each world is a set of processes spawned by `world.spawn` over the gloo
backend, one CPU shard a rank. Held against the reference: the (4, 2)
coordinates against the order of `repro.launch.mesh.make_mesh` over 8
host devices (a child process, as tests/test_torch_dist.py runs its
own), and the compressed psum over a (4, 2) mesh of ranks against the
port's virtual (4, 2) mesh bit for bit and the reference's int8 bound on
tests/test_torch_dist.py's inputs. The world's own contract: the two
backends never stand in for each other, a rank's failure or a world that
outlives its deadline fails the spawn and names the rank, and a mesh
whose shape is not the world's raises.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.dist import world

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 120
HANG_DEADLINE_S = 30         # past the ranks' start on a loaded host
WRONG_SHAPES = ((4,), (2, 2), (1,))
COMPRESS_BOUND = 2e-2       # tests/multidevice_child.py's int8 bound


def compression_inputs():
    """tests/test_torch_dist.py's inputs."""
    rng = np.random.default_rng(1)
    return {"a": rng.standard_normal((64, 32), dtype=np.float32),
            "b": rng.standard_normal((8,), dtype=np.float32) * 10,
            "c": np.zeros((3, 5), np.float32),
            "d": np.float32(-2.5) * np.ones((), np.float32)}


# --------------------------------------------------------------------------
# what the ranks run (module level, so a spawned rank can unpickle it)
# --------------------------------------------------------------------------

def _gather(obj) -> list:
    import torch.distributed as dist
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, obj)
    return every


def _grid(shape, axes) -> list:
    """Each rank's coordinates, and the ranks each axis group gathers."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, axes, group=dist.group.WORLD)
    me = torch.tensor([dist.get_rank()])
    lines = {a: world.all_gather(me, mesh.axis_group(a)).view(-1).tolist()
             for a in axes}
    total = torch.tensor([dist.get_rank()], dtype=torch.int32)
    dist.all_reduce(total)
    return _gather({"rank": mesh.rank, "coords": mesh.coords,
                    "shape": mesh.shape, "size": mesh.size,
                    "device": str(mesh.device), "lines": lines,
                    "sum": int(total), "world_size": dist.get_world_size()})


def _wrong_shapes() -> dict:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    out = {}
    for shape in WRONG_SHAPES:
        try:
            make_mesh(shape, tuple(f"ax{i}" for i in range(len(shape))),
                      group=dist.group.WORLD)
            out[shape] = "no error"
        except ValueError as e:
            out[shape] = str(e)
    return out


def _raise_on(rank: int) -> None:
    import torch.distributed as dist
    if dist.get_rank() == rank:
        raise ValueError(f"planted failure on rank {rank}")
    dist.barrier()


def _hang_on(rank: int) -> None:
    import torch.distributed as dist
    if dist.get_rank() == rank:
        time.sleep(3600)


def _needs_a_build() -> None:
    from repro_torch.kernels import _build
    _build.library_path = lambda name: Path("/nonexistent") / f"{name}.so"
    _build.load("scan_filter")


def _compressed(inputs) -> dict:
    import torch.distributed as dist

    from repro_torch.dist.compression import compressed_psum_pod
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((4, 2), ("pod", "data"), group=dist.group.WORLD)
    tree = {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}
    got = compressed_psum_pod(tree, mesh, axis="pod")
    return _gather({k: v.numpy() for k, v in got.items()})


def _restore(ck_dir: str) -> list:
    import torch.distributed as dist

    from repro_torch.checkpoint.store import CheckpointManager
    from repro_torch.dist.sharding import NamedSharding, PartitionSpec
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((4, 2), ("pod", "data"), group=dist.group.WORLD)
    mgr = CheckpointManager(ck_dir)
    out = {}
    for label, sh in (("mesh", mesh),
                      ("replicated", NamedSharding(mesh, PartitionSpec()))):
        skel = {"w": torch.full((8, 16), 3.0),
                "n": torch.zeros(3, dtype=torch.int32), "s": np.float32(0)}
        tree, _ = mgr.restore(skel, shardings=sh)
        out[label] = {k: (np.asarray(v).tobytes(), str(getattr(v, "device",
                                                               "")))
                      for k, v in tree.items()}
    block = torch.zeros(4, 16)
    tree, _ = mgr.restore({"w": block, "s": np.float32(0)}, shardings={
        "w": NamedSharding(mesh, PartitionSpec("data")),
        "s": NamedSharding(mesh, PartitionSpec())})
    out["split"] = {"coords": mesh.coords, "in_place": tree["w"] is block,
                    "w": tree["w"].numpy().tobytes(),
                    "s": (tree["s"].numpy().tobytes(), str(tree["s"].device))}
    try:
        mgr.restore({"w": torch.zeros(8, 16)}, shardings={
            "w": NamedSharding(mesh, PartitionSpec("data"))})
        out["whole into a block"] = "no error"
    except ValueError as e:
        out["whole into a block"] = str(e)
    return _gather(out)


# --------------------------------------------------------------------------
# the reference's device order, in a child on 8 host devices
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_order():
    code = ("from repro.launch.mesh import make_mesh\n"
            "m = make_mesh((4, 2), ('pod', 'data'))\n"
            "print([[d.id for d in row] for row in m.devices])\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    return eval(run.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """One 8-rank world for the (4, 2) checks: the grid, the compressed
    psum and a checkpoint restored on every rank."""
    from repro_torch.checkpoint.store import CheckpointManager
    ck = tmp_path_factory.mktemp("ck")
    mgr = CheckpointManager(ck)
    rng = np.random.default_rng(4)
    saved = {"w": torch.from_numpy(rng.standard_normal((8, 16),
                                                       dtype=np.float32)),
             "n": torch.tensor([1, -2, 3], dtype=torch.int32),
             "s": np.float32(2.5)}
    mgr.save(1, saved)
    mgr.wait()
    out = world.spawn(_eight, 8, backend="gloo", args=(str(ck),),
                      deadline_s=DEADLINE_S)
    out["saved"] = {k: np.asarray(v).tobytes() for k, v in saved.items()}
    return out


def _eight(ck_dir: str) -> dict:
    return {"grid": _grid((4, 2), ("pod", "data")),
            "psum": _compressed(compression_inputs()),
            "restore": _restore(ck_dir)}


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [((2,), ("data",)),
                                        ((1, 2), ("data", "model"))])
def test_world_of_two(shape, axes):
    every = world.spawn(_grid, 2, backend="gloo", args=(shape, axes),
                        deadline_s=DEADLINE_S)
    assert [e["rank"] for e in every] == [0, 1]
    for e in every:
        assert e["world_size"] == 2 and e["sum"] == 1
        assert e["size"] == 2 and tuple(e["shape"].values()) == shape
        assert e["device"] == "cpu"
    last = axes[-1]
    assert [e["coords"][last] for e in every] == [0, 1]
    assert every[0]["lines"][last] == every[1]["lines"][last] == [0, 1]
    if len(axes) == 2:
        assert every[0]["lines"]["data"] == [0]
        assert every[1]["lines"]["data"] == [1]


def test_grid_of_eight_follows_the_reference_order(eight, reference_order):
    """Rank r sits where jax.make_mesh puts device r, and each axis group
    gathers the ranks of its line in coordinate order."""
    grid = eight["grid"]
    assert len(grid) == 8
    for e in grid:
        p, d = e["coords"]["pod"], e["coords"]["data"]
        assert reference_order[p][d] == e["rank"]
        assert e["lines"]["pod"] == [reference_order[k][d] for k in range(4)]
        assert e["lines"]["data"] == [reference_order[p][k]
                                      for k in range(2)]
        assert e["shape"] == {"pod": 4, "data": 2} and e["size"] == 8
        assert e["sum"] == 28


@pytest.mark.parametrize("key", sorted(compression_inputs()))
def test_compressed_psum_over_ranks_equals_the_virtual_mesh(eight, key):
    """Every rank's result equals the virtual (4, 2) mesh's bit for bit,
    and 4x the leaf within the reference's int8 bound."""
    from repro_torch.dist.compression import compressed_psum_pod
    from repro_torch.launch.mesh import make_mesh
    x = compression_inputs()[key]
    mesh = make_mesh((4, 2), ("pod", "data"), device="cpu")
    want = compressed_psum_pod({key: torch.from_numpy(np.array(x))}, mesh,
                               axis="pod")[key].numpy()
    for rank, got in enumerate(eight["psum"]):
        a = got[key]
        assert a.dtype == np.float32 and a.shape == x.shape
        assert a.tobytes() == want.tobytes(), (rank, key)
        b = 4.0 * x
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-9) \
            < COMPRESS_BOUND, key


def test_checkpoint_restores_on_a_rank_mesh(eight):
    """A rank mesh, and a replicated NamedSharding over it, restore each
    leaf whole on every rank's device; a leaf split over "data" restores
    each rank's block of it into the skeleton's block, in place, and a
    whole leaf where a block belongs raises."""
    saved = eight["saved"]
    w = np.frombuffer(saved["w"], np.float32).reshape(8, 16)
    for rank, got in enumerate(eight["restore"]):
        for label in ("mesh", "replicated"):
            for k, want in saved.items():
                assert got[label][k][0] == want, (rank, label, k)
            assert got[label]["w"][1] == "cpu"
        split = got["split"]
        d = split["coords"]["data"]
        assert split["in_place"], rank
        assert split["w"] == w[4 * d:4 * d + 4].tobytes(), rank
        assert split["s"] == (saved["s"], "cpu"), rank
        assert "block under" in got["whole into a block"], rank


@pytest.fixture(scope="module")
def wrong_shapes():
    return world.spawn(_wrong_shapes, 2, backend="gloo",
                       deadline_s=DEADLINE_S)


@pytest.mark.parametrize("shape", WRONG_SHAPES)
def test_a_shape_that_is_not_the_world_raises(wrong_shapes, shape):
    assert f"{np.prod(shape)} positions, the group 2 ranks" in \
        wrong_shapes[shape]


def test_a_failing_rank_fails_the_spawn_and_is_named():
    t0 = time.monotonic()
    with pytest.raises(world.RankError) as e:
        world.spawn(_raise_on, 3, backend="gloo", args=(1,),
                    deadline_s=DEADLINE_S)
    assert e.value.rank == 1 and "planted failure on rank 1" in str(e.value)
    assert isinstance(e.value.__cause__, ValueError)
    assert time.monotonic() - t0 < DEADLINE_S


def test_a_world_past_its_deadline_is_ended():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks still running: \[1\]"):
        world.spawn(_hang_on, 2, backend="gloo", args=(1,),
                    deadline_s=HANG_DEADLINE_S)
    assert time.monotonic() - t0 < HANG_DEADLINE_S + 30


def test_a_rank_never_compiles_a_kernel():
    with pytest.raises(world.RankError, match="does not compile kernels"):
        world.spawn(_needs_a_build, 1, backend="gloo",
                    deadline_s=DEADLINE_S)


def test_backends_never_stand_in_for_each_other():
    if not torch.cuda.is_available():
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="nccl needs one distinct"):
            world.spawn(_grid, 1, backend="nccl", args=((1,), ("data",)))
        assert time.monotonic() - t0 < 1.0
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="ranks that share a card"):
        world.check_backend("nccl", cards + 1)
    with pytest.raises(ValueError, match="one of"):
        world.check_backend("mpi", 2)
    with pytest.raises(ValueError, match="nccl runs on CUDA"):
        world.check_backend("nccl", 1, "cpu")
    with pytest.raises(ValueError, match="gloo serves"):
        world.check_backend("gloo", 2, "meta")
    assert world.check_backend("gloo", 8) == torch.device("cpu")
    assert world.check_backend("gloo", 8, "cuda") == torch.device("cuda", 0)


def test_outside_a_world_there_is_no_rank_device():
    with pytest.raises(RuntimeError, match="no process group"):
        world.device()
    from repro_torch.launch.mesh import make_mesh
    with pytest.raises(ValueError, match="this rank's device"):
        make_mesh((2,), ("data",), device=["cpu", "cpu"], group=object())
