"""Production training launcher (counterpart of repro/launch/train.py).

Wires the substrates together: mesh + logical-rule shardings, the
sharded train step (with optional microbatch accumulation), the
deterministic data pipeline with prefetch, versioned async checkpoints,
heartbeats, straggler detection, and crash-restart supervision.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --reduced --steps 20 --seq-len 128 --global-batch 8 --device cpu

`--mesh d,m` lays a (data, model) mesh of virtual positions over the one
device (repro_torch.launch.mesh): the state stays whole on it, its
shardings record what each position would hold, and the step gives the
same bits on any mesh shape. It runs on the card unless `--device` names
another device. The port has
one train state and updates it in place: a restart after a crash reads
the latest checkpoint back into that state (the loop may have left it
half-updated), or, with no checkpoint yet, drops it and draws a fresh one.
Checkpoints are written in the reference's layout
(`convert.state_to_reference`), so either package can resume the other's
run (the reference reads a bf16 leaf back only through the port), and a
run resumes on another mesh shape.

Run on every rank of an initialised torch.distributed world (as the
reference runs one process a host under jax.distributed), `--mesh d,m`
is a mesh over the world's ranks (launch.mesh.RankMesh; without
`--mesh`, all ranks on "data"): each rank holds its blocks of the train
state and its rows of each batch, the step gathers and reduces
(train.step.make_rank_train_step), checkpoints gather on save and restore
a block a rank onto any mesh shape, and rank 0 alone prints, writes the
metrics and writes the checkpoint files. On the CPU:

  world.spawn(train.main, 8, backend="gloo", args=(["--arch",
      "mamba2-1.3b", "--reduced", "--mesh", "2,4", "--device", "cpu",
      ...],))

Heartbeats and restarts inside a world (`--heartbeat-dir`,
`--max-restarts`) raise: a failing rank ends the world (world.spawn),
and supervising the ranks is ROADMAP.md's item 5e.
"""
from __future__ import annotations

import argparse
import gc
import time

import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import DataConfig, SyntheticLM, make_global_batch
from repro_torch.data.pipeline import Prefetcher
from repro_torch.dist.fault_tolerance import (Heartbeat, RestartPolicy,
                                              StragglerDetector,
                                              run_supervised)
from repro_torch.dist.sharding import check_placed
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import convert
from repro_torch.train import optim, step as step_lib


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="",
                    help="comma dims for (data,model); default 1 device")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--heartbeat-dir", default="")
    ap.add_argument("--max-restarts", type=int, default=None,
                    help="restarts after a crash (default 2; none inside "
                         "a world)")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--metrics-file", default="",
                    help="JSONL per-step metrics incl. MFU vs roofline")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def build(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dims, group = (1,), None
    if torch.distributed.is_initialized():
        if args.heartbeat_dir or args.max_restarts is not None:
            raise NotImplementedError(
                "--heartbeat-dir and --max-restarts inside a world of "
                "ranks: a failing rank ends the world (dist.world.spawn); "
                "heartbeats and restarts of its ranks are ROADMAP.md's "
                "item 5e")
        dims, group = ((torch.distributed.get_world_size(),),
                       torch.distributed.group.WORLD)
    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split(","))
    mesh = make_mesh(dims, ("data", "model")[:len(dims)], args.device,
                     group=group)
    shape = ShapeSpec("cli", "train", args.seq_len, args.global_batch,
                      microbatch=args.microbatches)
    opt_cfg = optim.AdamWConfig(lr=args.lr, warmup_steps=10,
                                decay_steps=max(args.steps, 100))
    step_fn, _ = specs.build_train(cfg, shape, mesh, opt_cfg=opt_cfg,
                                   num_microbatches=args.microbatches)
    return cfg, mesh, shape, opt_cfg, step_fn


def _release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None, *, wrap_step=None):
    """Train as the command line says; returns the final state.
    `wrap_step(step_fn)` replaces the built step, for fault injection."""
    args = parse_args(argv)
    cfg, mesh, shape, opt_cfg, step_fn = build(args)
    state_sh, batch_sh = step_fn.in_shardings
    if wrap_step is not None:
        step_fn = wrap_step(step_fn)
    rules = specs.rules_for(cfg, shape)
    ranks = mesh.group is not None
    lead = not ranks or mesh.rank == 0     # prints, metrics and files

    ds = SyntheticLM(DataConfig(
        seed=1234, vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch,
        embed_dim=cfg.d_model if cfg.input_mode == "embeddings" else 0))

    mgr = (CheckpointManager(args.checkpoint_dir, async_save=True)
           if args.checkpoint_dir else None)
    hb = Heartbeat(args.heartbeat_dir, "host-0") if args.heartbeat_dir \
        else None
    straggler = StragglerDetector()
    mlog = None
    if args.metrics_file and lead:
        from repro_torch.train.metrics import MetricsLogger
        mlog = MetricsLogger(args.metrics_file, cfg, shape, chips=mesh.size)

    # the one train state: every restart refills this dict
    state: dict = {}

    def fresh_state():
        state.clear()                 # drop the crashed state first
        _release(mesh.device)
        fresh, _ = step_lib.init_state(0, cfg, opt_cfg, device=mesh.device,
                                       mesh=mesh, rules=rules)
        state.update(check_placed(fresh, state_sh))
        return state

    def ref_shardings():
        """The files' shardings: a rank mesh's checkpoints gather on save
        and restore this rank's blocks."""
        return (convert.shardings_to_reference(state, state_sh) if ranks
                else None)

    def restore():
        if mgr:
            mgr.wait()                # a write still in flight counts
        if mgr and mgr.latest_step() is not None:
            if not state:
                fresh_state()
            skeleton = pytree.tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype, device=(
                    mesh.device if ranks else "cpu")),
                convert.state_to_reference(state, device="meta"))
            tree, meta = mgr.restore(skeleton, shardings=ref_shardings())
            convert.load_reference_state(state, tree)
            del tree, skeleton
            if lead:
                print(f"[restore] resumed from step {meta['step']}")
            return state
        return fresh_state()

    # the batch's resolved split: a rank keeps its rows of it
    batch_spec = {k: sh.spec for k, sh in batch_sh.items()}

    def loop(state):
        step0 = int(state["step"])
        pf = Prefetcher(ds, start_step=step0)
        try:
            while int(state["step"]) < args.steps:
                t0 = time.time()
                _, host_batch = pf.next()
                batch = make_global_batch(host_batch, mesh, batch_spec)
                new, metrics = step_fn(state, batch)
                state.update(new)
                del new
                s = int(state["step"])
                dt = time.time() - t0
                if straggler.observe(s, dt):
                    print(f"[straggler] step {s} took {dt:.2f}s "
                          f"(ewma {straggler.ewma:.2f}s)")
                if hb:
                    hb.beat(s)
                if mlog:
                    mlog.log(s, dt, {"loss": metrics["loss"],
                                     "grad_norm": metrics["grad_norm"]})
                if mgr and s % args.checkpoint_every == 0:
                    mgr.save(s, convert.state_to_reference(state),
                             metadata={"arch": cfg.name},
                             shardings=ref_shardings())
                if lead and s % args.log_every == 0:
                    print(f"step {s:5d} loss {float(metrics['loss']):.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} "
                          f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
            return state
        finally:
            pf.close()

    restarts = (0 if ranks else 2) if args.max_restarts is None \
        else args.max_restarts
    state, policy = run_supervised(loop, restore,
                                   RestartPolicy(max_restarts=restarts))
    if mgr:
        mgr.save(int(state["step"]), convert.state_to_reference(state),
                 metadata={"final": True}, shardings=ref_shardings())
        mgr.wait()
    if mlog:
        mlog.close()
    if lead:
        print(f"done at step {int(state['step'])} "
              f"(restarts: {policy.restarts})")
    return state


if __name__ == "__main__":
    main()
