"""Serving launcher: the continuous-batching engine (counterpart of
repro/launch/serve.py).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
      --requests 8 --max-new 16 --device cpu

Reports per-step latency percentiles — the SLA the paper provisions for.
It runs on the card unless `--device` names another device. `--reduced`
is on by default, as in the reference; `--no-reduced` serves the
published widths (the reference's flag cannot be turned off).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    params = lm.init(cfg, seed=args.seed, device=device)
    engine = ServeEngine(cfg, params, batch_slots=args.slots,
                         max_len=args.max_len, device=device)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(4, 17))),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]

    lat = []
    queue = list(reqs)
    done = []
    t_start = time.time()
    while queue or any(s is not None for s in engine.slots):
        while queue and engine.submit(queue[0]):
            queue.pop(0)
        t0 = time.time()
        done.extend(engine.step())
        lat.append(time.time() - t0)
    wall = time.time() - t_start

    toks = sum(len(r.generated) for r in done)
    lat_ms = np.array(lat) * 1e3
    print(f"served {len(done)} requests, {toks} tokens in {wall:.2f}s")
    if len(lat_ms):
        print(f"per-step latency ms: p50={np.percentile(lat_ms, 50):.1f} "
              f"p95={np.percentile(lat_ms, 95):.1f} "
              f"p99={np.percentile(lat_ms, 99):.1f}")
    print(f"throughput: {toks / wall:.1f} tok/s")
    return done


if __name__ == "__main__":
    main()
