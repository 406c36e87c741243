"""Ranks of a torch.distributed process group, one device a rank.

The reference needs no such module: JAX's runtime owns its devices, and
`jax.make_mesh` spreads a mesh over them. The port's rank meshes
(repro_torch.launch.mesh.make_mesh(..., group=)) sit on a process group
that this module sets up, with the backend named by the caller:

- "nccl" needs one distinct CUDA device a rank: rank r drives cuda:r.
  A world with more ranks than cards raises here, before NCCL's own
  refusal.
- "gloo" serves CPU tensors (the tests) and ranks that share one card
  (every rank on the same CUDA device, which gloo's collectives stage
  through host memory).

Neither backend stands in for the other. `spawn` runs a function on every
rank of a fresh world: processes started with the "spawn" method (the
parent may hold a CUDA context), a `file://` rendezvous in a temporary
directory, a join with a deadline, the first failing rank's exception
raised again in the parent with its rank, and rank 0's return value
handed back; each rank takes its share of the host's cores for its
intra-op threads. Ranks never compile kernels: the caller builds them first
(repro_torch.kernels._build.build()), and a rank that finds a library
missing raises.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
INIT_TIMEOUT_S = 60.0           # a collective that waits longer raises
DEADLINE_S = 300.0              # a world that runs longer is ended
EXIT_GRACE_S = 5.0              # a dead rank's report arrives within this

_DEVICE: torch.device | None = None     # this rank's device


class RankError(RuntimeError):
    """A rank of a spawned world failed; `rank` names it."""

    def __init__(self, rank: int, message: str):
        super().__init__(f"rank {rank}: {message}")
        self.rank = rank


def check_backend(backend: str, world_size: int, device=None
                  ) -> torch.device:
    """The device every rank of a `world_size` world on `backend` uses
    (for nccl: the device of rank 0; rank r uses cuda:r). Raises
    ValueError for an unknown backend or a device the backend cannot
    serve, RuntimeError for nccl without a card a rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if world_size < 1:
        raise ValueError(f"world_size={world_size} must be >= 1")
    if backend == "nccl":
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"nccl runs on CUDA devices, not {device}")
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if world_size > cards:
            raise RuntimeError(
                f"nccl needs one distinct CUDA device a rank: {world_size} "
                f"ranks on {cards} card(s); ranks that share a card take "
                f"backend='gloo'")
        return torch.device("cuda", 0)
    device = torch.device("cpu" if device is None else device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"gloo serves CPU and CUDA tensors, not {device}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return device


def init(rank: int, world_size: int, init_method: str, *, backend: str,
         device=None, timeout_s: float = INIT_TIMEOUT_S) -> torch.device:
    """Join this process to the world as `rank`; returns its device (the
    `device` given, for gloo; cuda:rank, for nccl)."""
    global _DEVICE
    dev = check_backend(backend, world_size, device)
    kw = {}
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        kw["device_id"] = dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _DEVICE = dev
    return dev


def device() -> torch.device:
    """This rank's device; raises outside a world."""
    if _DEVICE is None or not dist.is_initialized():
        raise RuntimeError("no process group: call world.init (or run "
                           "under world.spawn) first")
    return _DEVICE


def shutdown() -> None:
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def barrier(group=None) -> None:
    """Every rank of `group` (the default group when None) waits here
    for the others."""
    kw = {}
    if dist.get_backend(group) == "nccl":
        kw["device_ids"] = [device().index]
    dist.barrier(group=group, **kw)


def exchange(send: torch.Tensor, recv: torch.Tensor, to: int, frm: int,
             group) -> torch.Tensor:
    """One paired point-to-point step: `send` goes to rank `to` while
    `recv` is filled from rank `frm` (ranks of the default group, both in
    `group`). Returns `recv`. Under nccl the tensors stay on their
    device. gloo's send and recv serve host buffers, so under gloo a CUDA
    tensor is copied to host memory and back here."""
    staged = dist.get_backend(group) == "gloo" and send.is_cuda
    out = recv
    if staged:
        send = send.cpu()
        recv = torch.empty(recv.shape, dtype=recv.dtype)
    ops = [dist.P2POp(dist.isend, send.contiguous(), to, group),
           dist.P2POp(dist.irecv, recv, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        out.copy_(recv)
    return out


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): every rank's `t` in the group's rank order.
    all_gather_into_tensor on both backends and both devices."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    out = torch.empty((n * t.numel(),), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.reshape(-1), group=group)
    return out.view(n, *t.shape)


# --------------------------------------------------------------------------
# spawn
# --------------------------------------------------------------------------

def _rank_main(rank, world_size, init_method, backend, dev, timeout_s, fn,
               args, results) -> None:
    from repro_torch.kernels import _build
    _build.BUILDS_ALLOWED = False
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        init(rank, world_size, init_method, backend=backend, device=dev,
             timeout_s=timeout_s)
        value = fn(*args)
        # pickled here, so a value that does not pickle fails this rank
        # (a queue pickles in a thread of its own and only prints)
        results.put(("ok", rank, pickle.dumps(value) if rank == 0
                     else None))
    except BaseException as e:
        try:
            exc = pickle.loads(pickle.dumps(e))
        except Exception:               # noqa: BLE001 - not picklable
            exc = None
        results.put(("err", rank, f"{type(e).__name__}: {e}\n"
                     f"{traceback.format_exc()}", exc))
        raise
    finally:
        shutdown()


def _end(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()


def spawn(fn, world_size: int, *, backend: str, device=None, args=(),
          deadline_s: float = DEADLINE_S,
          timeout_s: float = INIT_TIMEOUT_S):
    """Run `fn(*args)` on every rank of a fresh `world_size` world and
    return rank 0's value. `fn` and `args` must pickle (a module-level
    function). Raises RankError with the first failing rank's exception
    (as its __cause__ where that pickles), and TimeoutError when the
    world has not finished `deadline_s` after the start; every process
    is ended either way."""
    check_backend(backend, world_size, device)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro-world-")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world_size, init_method, backend, device, timeout_s, fn, args,
        results)) for r in range(world_size)]
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.start()
        done, value = set(), None
        while len(done) < world_size:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"a world of {world_size} ranks ({backend}) did not "
                    f"finish within {deadline_s} s; ranks still running: "
                    f"{sorted(set(range(world_size)) - done)}")
            dead = [r for r, p in enumerate(procs)
                    if r not in done and p.exitcode not in (None, 0)]
            try:
                # a rank that died has flushed its report, if it made one
                msg = results.get(timeout=EXIT_GRACE_S if dead
                                  else min(left, 1.0))
            except queue_mod.Empty:
                if dead:
                    raise RankError(dead[0], f"exited with code "
                                             f"{procs[dead[0]].exitcode} "
                                             f"before it reported")
                continue
            if msg[0] == "err":
                raise RankError(msg[1], msg[2]) from msg[3]
            done.add(msg[1])
            if msg[1] == 0:
                value = pickle.loads(msg[2])
        return value
    finally:
        _end(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
