"""The port's checkpoint store (repro_torch.checkpoint) against the
reference's (repro.checkpoint), on the CPU; stands in for
tests/test_checkpoint.py.

For the same tree the two packages write the same files: member names,
every member's bytes, and the manifest apart from its `time`. The port
reads the reference's files bit for bit, bf16 included; the reference
reads the port's fp32 and int32 files, and raises on a bf16 leaf, its own
as well (ROADMAP.md, queue 3: a reference fault the port does not assert
against)."""
import json
import zipfile

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.mesh import make_mesh


def np_tree(seed=0, bf16=True):
    """fp32, int32, scalar, tuple and (optionally) bf16 leaves, as the
    reference's test tree has them."""
    rng = np.random.default_rng(seed)
    groups = [rng.standard_normal((3, 4)).astype(np.float32),
              rng.standard_normal((2, 2)).astype(np.float32)]
    if bf16:
        groups.append(rng.standard_normal((5, 3)).astype(ml_dtypes.bfloat16))
    return {
        "params": {"w": rng.standard_normal((8, 16)).astype(np.float32),
                   "scale": np.float32(2.5),
                   "groups": tuple(groups)},
        "opt": {"m": np.zeros((8, 16), np.float32),
                "count": np.int32(7 + seed)},
        "step": np.int32(42 + seed),
    }


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def torch_tree(tree):
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(torch_tree(v) for v in tree)
    return to_torch(tree)


def skeleton_of(tree):
    """Tensors of the tree's shapes and dtypes, filled with garbage."""
    return _map(lambda t: torch.full_like(t, 3), torch_tree(tree))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v) for v in tree)
    return fn(tree)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}{k}.")
        return out
    if isinstance(tree, tuple):
        out = []
        for i, v in enumerate(tree):
            out += leaves(v, f"{prefix}{i}.")
        return out
    return [(prefix[:-1], tree)]


def bits(x):
    """A leaf's bytes (bf16 by its bit patterns)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes(), tuple(x.shape)
    x = np.asarray(x)
    return x.tobytes(), x.shape


def assert_tree_equal(got, want):
    g, w = leaves(got), leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        assert bits(a) == bits(b), k


def step_dir(root, step):
    return root / f"step_{step:010d}"


def members(root, step):
    with zipfile.ZipFile(step_dir(root, step) / "arrays.npz") as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def manifest(root, step):
    m = json.loads((step_dir(root, step) / "manifest.json").read_text())
    assert isinstance(m.pop("time"), float)
    return m


# --------------------------------------------------------------------------
# the reference's tests, on the port
# --------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = torch_tree(np_tree())
    mgr.save(3, tree, metadata={"data_step": 3})
    restored, meta = mgr.restore(skeleton_of(np_tree()))
    assert_tree_equal(restored, tree)
    assert meta["step"] == 3 and meta["user"]["data_step"] == 3


def test_versioning_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, torch_tree(np_tree(s)))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    restored, meta = mgr.restore(skeleton_of(np_tree()), step=3)
    assert_tree_equal(restored, torch_tree(np_tree(3)))
    assert meta["step"] == 3 and mgr.metadata(4)["step"] == 4


def test_atomicity_tmp_dirs_invisible(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, torch_tree(np_tree()))
    (tmp_path / "step_0000000009.tmp").mkdir()
    assert mgr.all_steps() == [1]
    assert mgr.latest_step() == 1
    restored, meta = mgr.restore(skeleton_of(np_tree()))
    assert meta["step"] == 1


def test_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    tree = torch_tree(np_tree())
    mgr.save(5, tree)
    mgr.wait()
    restored, _ = mgr.restore(skeleton_of(np_tree()))
    assert_tree_equal(restored, tree)


def test_async_gc_keeps_the_last(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2, async_save=True)
    for s in range(1, 6):
        mgr.save(s, torch_tree(np_tree(s)))
    mgr.wait()
    assert mgr.all_steps() == [4, 5]


def test_restore_onto_the_one_device_mesh(tmp_path):
    """The reference's elastic restore with explicit shardings, on the
    port's one-position mesh: one mesh for every leaf, or a tree of them;
    numpy leaves become tensors on the mesh's device."""
    mgr = CheckpointManager(tmp_path)
    tree = torch_tree(np_tree())
    mgr.save(1, tree)
    mesh = make_mesh((1,), ("data",), device="cpu")
    restored, _ = mgr.restore(skeleton_of(np_tree()), shardings=mesh)
    assert_tree_equal(restored, tree)
    restored, _ = mgr.restore(skeleton_of(np_tree()),
                              shardings=_map(lambda _: mesh, tree))
    assert_tree_equal(restored, tree)
    restored, _ = mgr.restore(np_tree(seed=9), shardings=mesh)
    for (k, got), (_, want) in zip(leaves(restored), leaves(tree)):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.dtype == want.dtype and bits(got) == bits(want), k


def test_restore_over_mesh_positions_names_5b(tmp_path):
    """A mesh of many positions on one device restores each leaf whole, as
    does a tree of NamedShardings over it; a sharding whose positions span
    more than one device in one process raises, pointing to a mesh of
    ranks, whose split restore tests/test_torch_world.py and
    tests/test_torch_world_train.py hold."""
    from types import SimpleNamespace

    from repro_torch.dist.sharding import NamedSharding, PartitionSpec
    mgr = CheckpointManager(tmp_path)
    tree = torch_tree(np_tree())
    mgr.save(1, tree)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    restored, _ = mgr.restore(skeleton_of(np_tree()), shardings=mesh)
    assert_tree_equal(restored, tree)
    named = _map(lambda _: NamedSharding(mesh, PartitionSpec("data")), tree)
    restored, _ = mgr.restore(np_tree(seed=9), shardings=named)
    for (k, got), (_, want) in zip(leaves(restored), leaves(tree)):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert bits(got) == bits(want), k
    two = SimpleNamespace(device_set={torch.device("cpu"),
                                      torch.device("meta")})
    with pytest.raises(NotImplementedError,
                       match="lives on one device.*make_mesh"):
        mgr.restore(skeleton_of(np_tree()), shardings=two)
    with pytest.raises(TypeError):
        mgr.restore(skeleton_of(np_tree()), shardings="data")


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        mgr.restore(skeleton_of(np_tree()))
    mgr.save(2, torch_tree(np_tree()))
    with pytest.raises(FileNotFoundError):
        mgr.restore(skeleton_of(np_tree()), step=3)


def test_restore_checks_the_skeleton(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, torch_tree(np_tree()))
    sk = skeleton_of(np_tree())
    sk["params"]["w"] = torch.zeros(16, 8)
    with pytest.raises(ValueError, match="params.w"):
        mgr.restore(sk)
    sk = skeleton_of(np_tree())
    sk["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params.extra"):
        mgr.restore(sk)


# --------------------------------------------------------------------------
# the same files as the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("as_tensors", [True, False],
                         ids=["tensors", "numpy"])
@pytest.mark.parametrize("seed", [0, 1])
def test_files_equal_the_reference(tmp_path, as_tensors, seed):
    tree = np_tree(seed)
    JCheckpointManager(tmp_path / "ref").save(4, tree, metadata={"a": [1]})
    CheckpointManager(tmp_path / "port").save(
        4, torch_tree(tree) if as_tensors else tree, metadata={"a": [1]})
    want, got = members(tmp_path / "ref", 4), members(tmp_path / "port", 4)
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    assert manifest(tmp_path / "port", 4) == manifest(tmp_path / "ref", 4)
    assert manifest(tmp_path / "port", 4)["leaves"]["params.groups.2"] == \
        {"shape": [5, 3], "dtype": "bfloat16"}


def test_non_contiguous_and_module_leaves(tmp_path):
    """A transposed tensor is stored in C order; a module is the dict of
    its state_dict entries."""
    lin = torch.nn.Linear(3, 2)
    tree = {"t": torch.arange(12.0).reshape(3, 4).T, "mod": lin}
    CheckpointManager(tmp_path / "port").save(1, tree)
    JCheckpointManager(tmp_path / "ref").save(1, {
        "t": np.arange(12.0, dtype=np.float32).reshape(3, 4).T.copy(),
        "mod": {k: v.detach().numpy() for k, v in lin.state_dict().items()}})
    assert members(tmp_path / "port", 1) == members(tmp_path / "ref", 1)
    fresh = torch.nn.Linear(3, 2)
    w = fresh.weight.data_ptr()
    out, _ = CheckpointManager(tmp_path / "ref").restore(
        {"t": torch.zeros(4, 3), "mod": fresh})
    assert out["mod"] is fresh and fresh.weight.data_ptr() == w
    assert torch.equal(fresh.weight, lin.weight)
    assert torch.equal(out["t"], tree["t"])


@pytest.mark.parametrize("seed", [0, 1])
def test_port_restores_reference_files_bit_for_bit(tmp_path, seed):
    tree = np_tree(seed)
    JCheckpointManager(tmp_path).save(6, tree)
    restored, meta = CheckpointManager(tmp_path).restore(
        skeleton_of(np_tree()))
    assert_tree_equal(restored, torch_tree(tree))
    assert restored["params"]["groups"][2].dtype == torch.bfloat16
    assert meta["step"] == 6


def test_reference_restores_port_fp32_and_int32_files(tmp_path):
    tree = np_tree(bf16=False)
    CheckpointManager(tmp_path).save(2, torch_tree(tree))
    restored, meta = JCheckpointManager(tmp_path).restore(tree)
    assert_tree_equal(_map(np.asarray, restored), tree)
    assert meta["step"] == 2


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_reference_cannot_restore_a_bf16_leaf(tmp_path, writer):
    """The reference stores a bf16 leaf as raw |V2 bytes and cannot cast
    them back (a reference fault, ROADMAP.md queue 3): asserted here as
    the reference's behaviour, not the port's."""
    tree = np_tree()
    if writer == "port":
        CheckpointManager(tmp_path).save(1, torch_tree(tree))
    else:
        JCheckpointManager(tmp_path).save(1, tree)
    with pytest.raises(ValueError, match="No cast function"):
        JCheckpointManager(tmp_path).restore(tree)


# --------------------------------------------------------------------------
# snapshots and in-place restore
# --------------------------------------------------------------------------

@pytest.mark.parametrize("async_save", [True, False])
def test_save_snapshots_before_returning(tmp_path, async_save):
    """An in-place update right after save() (as the next optimizer step
    makes) must not reach the checkpoint: on the CPU `t.cpu()` is `t`."""
    mgr = CheckpointManager(tmp_path, async_save=async_save)
    tree = torch_tree(np_tree())
    want = _map(torch.clone, tree)
    mgr.save(1, tree)
    for _, t in leaves(tree):
        t.add_(1)
    mgr.wait()
    restored, _ = mgr.restore(skeleton_of(np_tree()))
    assert_tree_equal(restored, want)


def test_restore_writes_into_the_skeletons_storage(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = torch_tree(np_tree())
    mgr.save(1, tree)
    sk = skeleton_of(np_tree())
    sk["params"]["groups"] = (sk["params"]["groups"][0].T.contiguous().T,
                              *sk["params"]["groups"][1:])
    before = [(k, t, t.data_ptr()) for k, t in leaves(sk)]
    restored, _ = mgr.restore(sk)
    for (k, t, ptr), (_, got) in zip(before, leaves(restored)):
        assert got is t and got.data_ptr() == ptr, k
    assert_tree_equal(restored, tree)


def test_restore_casts_to_the_skeletons_dtype(tmp_path):
    """As the reference casts to the skeleton's dtype."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": torch.arange(6, dtype=torch.float32) / 3,
                 "b": torch.arange(4, dtype=torch.int32)})
    sk = {"a": torch.zeros(6, dtype=torch.float64),
          "b": np.zeros(4, np.int64)}
    out, _ = mgr.restore(sk)
    assert out["a"] is sk["a"] and out["b"].dtype == np.int64
    np.testing.assert_array_equal(
        out["a"].numpy(), (np.arange(6, dtype=np.float32) / 3)
        .astype(np.float64))
    np.testing.assert_array_equal(out["b"], np.arange(4))


def test_a_flipped_byte_fails_the_crc_in_both_packages(tmp_path):
    """Restore reads the data straight from the file and checks its
    CRC-32 as zipfile does for the reference."""
    tree = np_tree(bf16=False)
    CheckpointManager(tmp_path).save(1, torch_tree(tree))
    path = step_dir(tmp_path, 1) / "arrays.npz"
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo("params.w.npy")
    raw = bytearray(path.read_bytes())
    raw[info.header_offset + 200] ^= 0x10       # inside params.w's data
    path.write_bytes(bytes(raw))
    with pytest.raises(zipfile.BadZipFile, match="params.w"):
        CheckpointManager(tmp_path).restore(skeleton_of(tree))
    with pytest.raises(zipfile.BadZipFile):
        JCheckpointManager(tmp_path).restore(tree)
