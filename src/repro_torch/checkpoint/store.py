"""Checkpoint store: versioned, atomic, async (counterpart of
repro/checkpoint/store.py).

The files are the reference's: `step_%010d/` directories, each an
`arrays.npz` (one `.npy` member a leaf, named by the `.`-joined path of
`_flatten`) and a `manifest.json` (step, time, each leaf's shape and
dtype, user metadata). For the same tree of numpy arrays the port writes
the same members, byte for byte, and the same manifest apart from `time`.

- atomic publish: writes go to step_K.tmp/, fsync'd, then renamed — a
  crash mid-write never corrupts the latest checkpoint;
- versioned: keep_last N steps retained, `latest` resolves dynamically;
- async: save() snapshots every leaf to host memory before it returns,
  then (async_save=True) writes in a background thread, overlapping the
  next train step;
- bf16: a bf16 leaf is stored as the reference stores it, its raw 2-byte
  patterns under the `<V2` descriptor with "bfloat16" in the manifest,
  and read back as bf16 by the manifest's dtype (no ml_dtypes). The
  reference writes such files but cannot read them back (ROADMAP.md,
  queue 3); the port reads its own and the reference's;
- in place: restore() reads each stored array into the skeleton's own
  tensors, so a restored train state needs no second copy on the card;
  a host tensor's bytes come straight from the file (CRC-32 checked as
  zipfile checks it) with no copy between;
- over ranks (the reference's "per-host shards gathered on save and
  re-sharded on load onto any mesh"): given the tree's shardings over a
  launch.mesh.RankMesh, save() gathers each split leaf whole on every
  rank, on the calling thread, and rank 0 alone writes the files a
  single process writes; a barrier follows the write (in wait() when the
  write runs in the background), so no rank reads the directory early.
  restore() with such shardings reads each member whole (its CRC-32
  checked) and copies this rank's block into the skeleton's block, for
  a mesh of any shape.

Leaves may be tensors (on any device), numpy arrays or scalars; an
nn.Module is a dict of its state_dict() entries.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import struct
import threading
import time
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch.dist import sharding as shlib

_SEP = "."
BF16 = "bfloat16"
BF16_DESCR = "<V2"       # what np.save writes for the reference's bf16


def _flatten(tree, prefix=""):
    """Flatten to {path: leaf} with deterministic key order."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict(keep_vars=True)
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    elif tree is None:
        pass
    else:
        out[prefix[:-1]] = tree
    return out


def _snapshot(leaf) -> tuple:
    """(a C-ordered host array that shares no memory with `leaf`, its npy
    descriptor, its manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        # a fresh host tensor: on the CPU `t.cpu()` would be `t` itself,
        # and the next in-place optimizer step would tear an async write
        host = torch.empty(t.shape, dtype=t.dtype, device="cpu")
        host.copy_(t)
        if t.dtype == torch.bfloat16:
            return (host.view(torch.int16).numpy().view(np.dtype("V2")),
                    BF16_DESCR, BF16)
        a = host.numpy()
    else:
        a = np.array(leaf, order="C", copy=True)
    return a, np.lib.format.dtype_to_descr(a.dtype), str(a.dtype)


def _write_npz(path: Path, host: dict) -> None:
    """np.savez's layout (stored zip64 members, npy format 1.0 headers)
    with each leaf's own descriptor; the data goes out in one write."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (a, descr, _) in host.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array_header_1_0(
                    fid, {"descr": descr, "fortran_order": False,
                          "shape": a.shape})
                fid.write(memoryview(a.reshape(-1).view(np.uint8)))


def _read_exact(f, view: memoryview, key: str) -> None:
    got = 0
    while got < len(view):
        n = f.readinto(view[got:])
        if not n:
            raise EOFError(f"{key}: {len(view) - got} bytes missing")
        got += n


def _member_header(f, zf: zipfile.ZipFile, key: str) -> tuple:
    """Seek `f` (the archive, opened for reading) to the array data of
    stored member `key` and return (ZipInfo, shape, fortran order, stored
    dtype, CRC-32 of the npy header so far). The data is read straight
    from the file, not through zipfile's buffers, and its CRC checked
    against the archive's."""
    info = zf.getinfo(key + ".npy")
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{key}: a compressed member")
    f.seek(info.header_offset)
    local = f.read(30)
    if len(local) != 30 or local[:4] != b"PK\x03\x04":
        raise zipfile.BadZipFile(f"{key}: no local file header")
    name_len, extra_len = struct.unpack("<HH", local[26:30])
    start = info.header_offset + 30 + name_len + extra_len
    f.seek(start)
    version = np.lib.format.read_magic(f)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, fortran, stored = read_header(f)
    if stored.hasobject:
        raise ValueError(f"{key}: object arrays are not restored")
    head = f.tell() - start
    if head + math.prod(shape) * stored.itemsize != info.file_size:
        raise zipfile.BadZipFile(f"{key}: member size {info.file_size} "
                                 f"does not hold a {shape} {stored} array")
    f.seek(start)
    crc = zlib.crc32(f.read(head))
    return info, shape, fortran, stored, crc


def _read_data(f, info, crc: int, buf: np.ndarray, key: str) -> None:
    view = memoryview(buf.reshape(-1).view(np.uint8))
    _read_exact(f, view, key)
    if zlib.crc32(view, crc) != info.CRC:
        raise zipfile.BadZipFile(f"{key}: CRC-32 mismatch")


def _as_tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A host array read from a checkpoint as a tensor of the manifest's
    dtype (bf16 from its raw 2-byte patterns)."""
    if dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _numpy_view(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _read_leaf(f, zf: zipfile.ZipFile, key: str, dtype: str, into):
    """Read member `key` (manifest dtype `dtype`) into the skeleton leaf
    `into`: a tensor is overwritten in place and returned; any other leaf
    is replaced by the stored array, cast to the leaf's dtype."""
    info, shape, fortran, stored, crc = _member_header(f, zf, key)
    if isinstance(into, torch.Tensor) and tuple(into.shape) != shape:
        raise ValueError(f"{key}: stored {shape}, skeleton "
                         f"{tuple(into.shape)}")
    if (isinstance(into, torch.Tensor) and not fortran and stored.isnative
            and into.device.type == "cpu" and into.is_contiguous()
            and into.dtype == _as_tensor(np.empty(0, stored), dtype).dtype):
        # straight from the file into the skeleton's own storage
        _read_data(f, info, crc, _numpy_view(into), key)
        return into
    a = np.empty(shape[::-1] if fortran else shape, stored)
    _read_data(f, info, crc, a, key)
    if fortran:
        a = a.T
    if isinstance(into, torch.Tensor):
        with torch.no_grad():
            into.copy_(_as_tensor(np.array(a, order="C"), dtype))
        return into
    dt = getattr(into, "dtype", None)
    return a if dt is None or a.dtype.kind == "V" else a.astype(dt)


def _mesh_device(sharding):
    """The device a sharding puts a leaf on. A sharding is one of the
    port's meshes or NamedShardings (repro_torch.launch.mesh.Mesh,
    repro_torch.dist.sharding.NamedSharding). Over virtual positions,
    however many, on one device, that device holds the leaf whole. Over
    the ranks of a process group (a RankMesh) it is this rank's device,
    which holds its block of a split leaf (the leaf whole where nothing
    splits it)."""
    devices = getattr(sharding, "device_set", None)
    if devices is None:
        raise TypeError(f"a sharding is one of the port's meshes or "
                        f"NamedShardings, not {sharding!r}")
    mesh = getattr(sharding, "mesh", sharding)
    if getattr(mesh, "group", None) is not None:
        return mesh.device
    if len(devices) > 1:
        raise NotImplementedError(
            f"restoring onto the {len(devices)} devices of {sharding}: a "
            f"single process's mesh lives on one device; a position a "
            f"device is a mesh of ranks, make_mesh(..., group=), whose "
            f"shardings restore a block a rank")
    return next(iter(devices))


def _split(sharding) -> bool:
    """A NamedSharding over ranks that splits its leaf."""
    return (isinstance(sharding, shlib.NamedSharding)
            and getattr(sharding.mesh, "group", None) is not None
            and bool(sharding.splits()))


def _read_block(f, zf: zipfile.ZipFile, key: str, dtype: str, into,
                sharding):
    """Read member `key` whole (its CRC-32 checked) and copy this rank's
    block of it under `sharding` into the skeleton's tensor `into`, which
    must have the block's shape. Returns `into`."""
    info, shape, fortran, stored, crc = _member_header(f, zf, key)
    want = sharding.shard_shape(shape)
    if not isinstance(into, torch.Tensor) or tuple(into.shape) != want:
        raise ValueError(f"{key}: stored {shape}, whose block under "
                         f"{sharding.spec} is a {want} tensor; skeleton "
                         f"{getattr(into, 'shape', into)!r}")
    a = np.empty(shape[::-1] if fortran else shape, stored)
    _read_data(f, info, crc, a, key)
    with torch.no_grad():
        into.copy_(shlib.local_block(
            _as_tensor(np.ascontiguousarray(a.T if fortran else a), dtype),
            sharding))
    return into


def _placed(leaf, device, dtype: str):
    """`leaf`, restored, on `device` (None: where it is)."""
    if device is None:
        return leaf
    if isinstance(leaf, torch.Tensor):
        if leaf.device != torch.empty(0, device=device).device:
            raise ValueError(f"the skeleton's leaf lives on {leaf.device}, "
                             f"the restore asks for {device}: leaves are "
                             f"restored in place")
        return leaf
    return _as_tensor(np.array(leaf, order="C"), dtype).to(device)


def _flat_shardings(shardings, flat: dict) -> dict:
    """{path: sharding or None} for the leaves of `flat`, from a tree of
    shardings or one sharding for every leaf."""
    if isinstance(shardings, (dict, list, tuple)):
        return _flatten(shardings)
    return dict.fromkeys(flat, shardings)


def _rank_group(shardings) -> object | None:
    """The process group of the rank mesh the shardings lie on, or None
    for virtual meshes and no shardings."""
    for sh in shardings:
        group = getattr(getattr(sh, "mesh", sh), "group", None)
        if group is not None:
            return group
    return None


class CheckpointManager:
    def __init__(self, directory, keep_last: int = 3,
                 async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._group = None        # a rank mesh's group after its save

    # ------------------------------------------------------------------
    def save(self, step: int, tree, metadata: dict | None = None,
             shardings=None):
        """Snapshot to host memory, then write (optionally in background).
        `shardings` (a tree matching `tree`, or one sharding for every
        leaf) over a rank mesh: every rank calls save alike, each split
        leaf is gathered whole, and rank 0 alone snapshots and writes;
        the ranks meet at a barrier after the write."""
        flat = _flatten(tree)
        flat_sh = _flat_shardings(shardings, flat)
        group = _rank_group(flat_sh.values())
        writer = True
        if group is not None:
            import torch.distributed as dist
            if self.async_save:
                self.wait()           # every rank: the last save's barrier
            writer = dist.get_rank(group) == 0
        host = {}
        for k, v in flat.items():     # leaf by leaf: one whole at a time
            sh = flat_sh.get(k)
            whole = shlib.gather(v.detach(), sh) if _split(sh) else v
            if writer:
                host[k] = _snapshot(whole)                 # device->host
            del whole
        if writer:
            meta = {
                "step": int(step),
                "time": time.time(),
                "leaves": {k: {"shape": list(a.shape), "dtype": dtype}
                           for k, (a, _, dtype) in host.items()},
                "user": metadata or {},
            }
            if self.async_save:
                self.wait()
                self._thread = threading.Thread(
                    target=self._write, args=(step, host, meta),
                    daemon=True)
                self._thread.start()
            else:
                self._write(step, host, meta)
        self._group = group
        if group is not None and not self.async_save:
            self.wait()

    def wait(self):
        """Join a write still in flight; after a save over ranks, every
        rank then meets the others at a barrier."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._group is not None:
            from repro_torch.dist import world
            group, self._group = self._group, None
            world.barrier(group)

    def _write(self, step: int, host: dict, meta: dict):
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f"step_{step:010d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        _write_npz(tmp / "arrays.npz", host)
        (tmp / "manifest.json").write_text(json.dumps(meta))
        with open(tmp / "manifest.json") as f:   # durability barrier
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                         # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if not p.name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metadata(self, step: int) -> dict:
        return json.loads(
            (self.dir / f"step_{step:010d}" / "manifest.json").read_text())

    def restore(self, skeleton, step: int | None = None, mesh=None,
                shardings=None):
        """Read checkpoint `step` (the latest by default) into `skeleton`:
        each tensor leaf is overwritten in place, any other leaf replaced
        by the stored array, both cast to the leaf's dtype as the
        reference casts to the skeleton's. Returns (the tree in
        `skeleton`'s structure, the manifest).

        `shardings` is one of the port's meshes or NamedShardings, or a
        tree of them (None where a leaf needs none) matching `skeleton`:
        a non-tensor leaf becomes a tensor on that sharding's device, a
        tensor leaf must already live there. A mesh of any number of
        positions on one device restores each leaf whole. Over a mesh of
        ranks each rank restores onto its own device: the whole leaf
        where nothing splits it, else its block, which is what the
        skeleton's tensor must hold; the files may come from any mesh. A
        mesh over several devices in one process raises
        NotImplementedError. `mesh` is accepted and unused, as in the
        reference."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        meta = self.metadata(step)
        flat_sh = _flat_shardings(shardings, _flatten(skeleton))

        def device(key):
            sh = flat_sh.get(key)
            return None if sh is None else _mesh_device(sh)

        path = self.dir / f"step_{step:010d}" / "arrays.npz"
        with open(path, "rb") as f, zipfile.ZipFile(f) as zf:
            def rec(node, prefix=""):
                if isinstance(node, torch.nn.Module):
                    for k, t in node.state_dict(keep_vars=True).items():
                        rec(t, f"{prefix}{k}{_SEP}")
                    return node
                if isinstance(node, dict):
                    return {k: rec(v, f"{prefix}{k}{_SEP}")
                            for k, v in node.items()}
                if isinstance(node, tuple):
                    return tuple(rec(v, f"{prefix}{i}{_SEP}")
                                 for i, v in enumerate(node))
                if isinstance(node, list):
                    return [rec(v, f"{prefix}{i}{_SEP}")
                            for i, v in enumerate(node)]
                if node is None:
                    return None
                key = prefix[:-1]
                if key not in meta["leaves"]:
                    raise KeyError(f"{key} is not in checkpoint {step}")
                dtype = meta["leaves"][key]["dtype"]
                if _split(flat_sh.get(key)):
                    return _placed(_read_block(f, zf, key, dtype, node,
                                               flat_sh[key]),
                                   device(key), dtype)
                return _placed(_read_leaf(f, zf, key, dtype, node),
                               device(key), dtype)
            tree = rec(skeleton)
        return tree, meta
