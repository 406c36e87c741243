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
from repro_torch.device import resolve_device
from repro_torch.dist.fault_tolerance import (Heartbeat, RestartPolicy,
                                              StragglerDetector,
                                              run_supervised)
from repro_torch.dist.sharding import (PartitionSpec as P, check_placed,
                                       sharding_tree)
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
    ap.add_argument("--max-restarts", type=int, default=2)
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
    device = resolve_device(args.device)
    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split(","))
        mesh = make_mesh(dims, ("data", "model")[:len(dims)], device)
    else:
        mesh = make_mesh((1,), ("data",), device)
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
    if wrap_step is not None:
        step_fn = wrap_step(step_fn)
    rules = specs.rules_for(cfg, shape)

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
    if args.metrics_file:
        from repro_torch.train.metrics import MetricsLogger
        mlog = MetricsLogger(args.metrics_file, cfg, shape, chips=mesh.size)

    # the one train state: every restart refills this dict
    state: dict = {}

    def fresh_state():
        state.clear()                 # drop the crashed state first
        _release(mesh.device)
        fresh, axes = step_lib.init_state(0, cfg, opt_cfg,
                                          device=mesh.device)
        state.update(check_placed(fresh, sharding_tree(fresh, axes, mesh,
                                                       rules)))
        return state

    def restore():
        if mgr:
            mgr.wait()                # a write still in flight counts
        if mgr and mgr.latest_step() is not None:
            if not state:
                fresh_state()
            skeleton = pytree.tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype),
                convert.state_to_reference(state, device="meta"))
            tree, meta = mgr.restore(skeleton)
            convert.load_reference_state(state, tree)
            del tree, skeleton
            print(f"[restore] resumed from step {meta['step']}")
            return state
        return fresh_state()

    batch_spec = {"inputs": P("data"), "labels": P("data")}

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
                             metadata={"arch": cfg.name})
                if s % args.log_every == 0:
                    print(f"step {s:5d} loss {float(metrics['loss']):.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} "
                          f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
            return state
        finally:
            pf.close()

    state, policy = run_supervised(
        loop, restore, RestartPolicy(max_restarts=args.max_restarts))
    if mgr:
        mgr.save(int(state["step"]), convert.state_to_reference(state),
                 metadata={"final": True})
        mgr.wait()
    if mlog:
        mlog.close()
    print(f"done at step {int(state['step'])} "
          f"(restarts: {policy.restarts})")
    return state


if __name__ == "__main__":
    main()
