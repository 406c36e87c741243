"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):

1. device  — a CUDA device of compute capability 9.0 is required; prints
             the card's name and power limit (nvidia-smi), torch and CUDA
             versions.
2. build   — compiles the three CUDA kernels from src/repro_torch/csrc
             (one nvcc per source, in parallel).
3. parity  — each kernel against its plain PyTorch version, bit for bit,
             over code_bits {2, 4, 8, 16} x the six predicates x constants
             {0, 1, vmax//2, vmax-1, vmax} x n_words {1, 127, 32771,
             2^22+17}, a 16-bit all-selected column whose sum passes 2^31,
             and a numpy oracle on the small sizes.
4. main    — the query engine's main path at full size: a 2^30-row table
             {"a": 8, "b": 8, "w": 16, "x": 4} built on the card from a
             seeded torch.Generator, the eleven plan shapes of the engine
             tests answered by QueryEngine(mode="auto") and compared with
             QueryEngine(mode="torch_ref") on the same table; every
             kernel's launch counter must have moved.
5. times   — each kernel at the main path's shapes: median of 20 timed
             runs after 3 warm-ups (CUDA events), its plain version's
             time, and the bound: the larger of bytes over the card's
             memory rate and operations over its CUDA-core rate.
6. profile — the eleven queries again, warm, then under torch.profiler:
             the device's busy share and device time by kernel name.

The second-to-last line of output is one JSON object {"kernels": [...]};
the last is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# The smoke drives one card: expose only the first visible one, so
# torch.cuda.device_count() is 1 whatever the host holds.
os.environ["CUDA_VISIBLE_DEVICES"] = \
    os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

SRC = Path(__file__).resolve().parent / "src"
SEED = 0
MAIN_ROWS = 1 << 30
MAIN_SPEC = {"a": 8, "b": 8, "w": 16, "x": 4}
PARITY_WORDS = (1, 127, 32771, (1 << 22) + 17)
ORACLE_MAX_WORDS = 127
WARMUP, TIMED = 3, 20

# The H100 SXM (torch names it "H100 80GB HBM3") datasheet rates: memory
# 3.35 TB/s; CUDA cores 67 TFLOP/s float32 outside the tensor cores, an
# upper bound on its int32 rate.
CARD = "H100 80GB HBM3"
MEM_BPS = 3.35e12
CORE_OPS = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------

def device_phase() -> dict:
    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}; the kernels are built for sm_90a")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {name}")
    if CARD not in name:
        fail(f"the bounds use the {CARD} datasheet; {name!r} needs its own "
             "MEM_BPS")
    return {"name": name, "smi": smi}


# --------------------------------------------------------------------------
# 3. parity
# --------------------------------------------------------------------------

def random_words(n: int, mask_u32: int, g: torch.Generator) -> torch.Tensor:
    """n int32 words of random bits restricted to mask_u32 (random_ draws
    [0, 2^31), and bit 31 is a delimiter bit at every width)."""
    from repro_torch.kernels.scan_filter.ref import as_int32
    w = torch.empty(n, dtype=torch.int32, device="cuda")
    w.random_(generator=g)
    return w & as_int32(mask_u32)


def np_fields(words: torch.Tensor, bits: int) -> np.ndarray:
    w = words.cpu().numpy().view(np.uint32).astype(np.int64)
    c = 32 // bits
    return np.stack([(w >> (i * bits)) & ((1 << bits) - 1)
                     for i in range(c)], axis=1)


def np_scan(words, constant, op, bits) -> np.ndarray:
    vals = np_fields(words, bits)
    hit = {"lt": np.less, "le": np.less_equal, "gt": np.greater,
           "ge": np.greater_equal, "eq": np.equal,
           "ne": np.not_equal}[op](vals, constant)
    pos = np.arange(32 // bits) * bits + bits - 1
    return (hit.astype(np.int64) << pos).sum(axis=1).astype(np.uint32) \
        .view(np.int32)


def np_aggregate(words, mask, bits) -> dict:
    vals = np_fields(words, bits).reshape(-1)
    sel = (np_fields(mask, bits) >> (bits - 1)).astype(bool).reshape(-1)
    v = vals[sel]
    vmax = (1 << (bits - 1)) - 1
    return {"sum": int(v.sum()), "count": int(sel.sum()),
            "min": int(v.min()) if v.size else vmax,
            "max": int(v.max()) if v.size else 0}


def agg_err(a: dict, b: dict) -> int:
    return max(abs(a[k] - b[k]) for k in ("sum", "count", "min", "max"))


def parity_phase() -> dict:
    phase("parity")
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.scan_aggregate import ops as fused_ops
    from repro_torch.kernels.scan_filter import ops as scan_ops
    from repro_torch.kernels.scan_filter.ref import OPS, as_int32, field_masks

    g = torch.Generator(device="cuda").manual_seed(SEED)
    err = {"scan_filter": 0, "aggregate": 0, "scan_aggregate": 0}
    cases = {"scan_filter": 0, "aggregate": 0, "scan_aggregate": 0}
    bad = []
    t0 = time.perf_counter()
    for bits in (2, 4, 8, 16):
        delim, _, value = field_masks(bits)
        vmax = int(value)
        payload = ~int(delim) & 0xFFFFFFFF
        consts = sorted({0, 1, vmax // 2, vmax - 1, vmax})
        for n in PARITY_WORDS:
            pred = random_words(n, payload, g)
            agg = random_words(n, payload, g)
            mask = random_words(n, int(delim), g)
            masks = {"random": mask,
                     "all": torch.full_like(mask, as_int32(delim)),
                     "none": torch.zeros_like(mask)}
            small = n <= ORACLE_MAX_WORDS
            for mname, m in masks.items():
                k = agg_ops.finalize(agg_ops.aggregate(agg, m, bits,
                                                       mode="cuda"))
                r = agg_ops.finalize(agg_ops.aggregate(agg, m, bits,
                                                       mode="torch_ref"))
                e = agg_err(k, r)
                if small:
                    e = max(e, agg_err(k, np_aggregate(agg, m, bits)))
                err["aggregate"] = max(err["aggregate"], e)
                cases["aggregate"] += 1
                if e:
                    bad.append(("aggregate", bits, n, mname, k, r))
            for op in OPS:
                for c in consts:
                    k = scan_ops.scan_filter(pred, c, op, bits, mode="cuda")
                    r = scan_ops.scan_filter(pred, c, op, bits,
                                             mode="torch_ref")
                    e = int((k.long() - r.long()).abs().max())
                    if small:
                        o = torch.from_numpy(np_scan(pred, c, op, bits))
                        e = max(e, int((k.cpu().long() - o.long()).abs()
                                       .max()))
                    err["scan_filter"] = max(err["scan_filter"], e)
                    cases["scan_filter"] += 1
                    if e:
                        bad.append(("scan_filter", bits, n, op, c))
                    k = agg_ops.finalize(fused_ops.scan_aggregate(
                        pred, agg, mask, c, op, bits, mode="cuda"))
                    r = agg_ops.finalize(fused_ops.scan_aggregate(
                        pred, agg, mask, c, op, bits, mode="torch_ref"))
                    e = agg_err(k, r)
                    if small:
                        sel = torch.from_numpy(np_scan(pred, c, op, bits)) \
                            .cuda() & mask
                        e = max(e, agg_err(k, np_aggregate(agg, sel, bits)))
                    err["scan_aggregate"] = max(err["scan_aggregate"], e)
                    cases["scan_aggregate"] += 1
                    if e:
                        bad.append(("scan_aggregate", bits, n, op, c, k, r))
    # a 16-bit column, every row selected, whose sum passes 2^31
    n = PARITY_WORDS[-1]
    delim, _, _ = field_masks(16)
    agg = random_words(n, ~int(delim) & 0xFFFFFFFF, g)
    allm = torch.full_like(agg, as_int32(delim))
    k = agg_ops.finalize(agg_ops.aggregate(agg, allm, 16, mode="cuda"))
    r = agg_ops.finalize(agg_ops.aggregate(agg, allm, 16, mode="torch_ref"))
    big = int(np_fields(agg, 16).sum())
    if k != r or k["sum"] != big or big <= 2**31 or k["count"] != 2 * n:
        bad.append(("aggregate_past_2^31", k, r, big))
    k = agg_ops.finalize(fused_ops.scan_aggregate(agg, agg, allm, 0, "ge",
                                                  16, mode="cuda"))
    if k["sum"] != big:
        bad.append(("scan_aggregate_past_2^31", k, big))
    cases["aggregate"] += 1
    cases["scan_aggregate"] += 1
    print(f"16-bit all-selected sum {k['sum']} (> 2^31: {big > 2**31})")
    torch.cuda.synchronize()
    print(f"parity cases {cases} max_abs_err {err} "
          f"in {time.perf_counter() - t0:.3f} s", flush=True)
    if bad:
        for b in bad[:20]:
            print("MISMATCH", b, file=sys.stderr)
        fail(f"{len(bad)} kernel/plain mismatches")
    return err


# --------------------------------------------------------------------------
# 4. main path
# --------------------------------------------------------------------------

def plan_shapes():
    """The eleven plan shapes of tests/test_query_engine.py::PLAN_SHAPES."""
    from repro_torch.query import And, Or, Pred
    return [
        ("single_pred_fused", Pred("a", "lt", 50), ("b",)),
        ("fused_ge", Pred("a", "ge", 100), ("b",)),
        ("fused_gt", Pred("a", "gt", 100), ("b",)),
        ("fused_eq", Pred("a", "eq", 64), ("b",)),
        ("fused_ne", Pred("a", "ne", 64), ("b",)),
        ("and_same_width", Pred("a", "lt", 50) & Pred("b", "ge", 100),
         ("b",)),
        ("and_mixed_width", Pred("a", "lt", 50) & Pred("w", "ge", 9000),
         ("w",)),
        ("or_mixed_width", Pred("x", "eq", 3) | Pred("w", "lt", 500),
         ("a",)),
        ("nested_and_or",
         And.of(Or.of(Pred("a", "le", 20), Pred("b", "gt", 120)),
                Pred("x", "ne", 0)), ("b",)),
        ("multi_agg_mixed", Pred("a", "ge", 64), ("b", "w", "x")),
        ("empty_selection", Pred("x", "gt", 7), ("a",)),
    ]


def build_table():
    """2^30 rows built on the card (host numpy would need GBs a column):
    random payload bits from a seeded generator, delimiters cleared."""
    from repro_torch.db import BitPackedColumn, Table
    from repro_torch.kernels.scan_filter.ref import field_masks
    g = torch.Generator(device="cuda").manual_seed(SEED)
    t = Table("main")
    for name, bits in MAIN_SPEC.items():
        delim, _, _ = field_masks(bits)
        words = random_words(MAIN_ROWS * bits // 32,
                             ~int(delim) & 0xFFFFFFFF, g)
        t.add(BitPackedColumn(name, bits, MAIN_ROWS, words))
    for col in t.columns.values():
        col.valid_words       # build the cached validity masks up front
    torch.cuda.synchronize()
    return t


def kernel_modules():
    from repro_torch.kernels.aggregate import kernel as agg_k
    from repro_torch.kernels.scan_aggregate import kernel as fused_k
    from repro_torch.kernels.scan_filter import kernel as scan_k
    return {"scan_filter": scan_k, "aggregate": agg_k,
            "scan_aggregate": fused_k}


def main_phase(table) -> dict:
    phase("main")
    from repro_torch.query import Query, QueryEngine
    gib = table.nbytes / 2**30
    print(f"table {table.num_rows} rows, {gib:.3f} GiB packed "
          f"+ {gib:.3f} GiB validity masks on {table.device}")
    shapes = plan_shapes()
    mods = kernel_modules()
    eng = QueryEngine(table, mode="auto")
    for m in mods.values():
        m.LAUNCHES = 0
    got = []
    for name, plan, aggs in shapes:
        eng.submit(Query(plan, aggregates=aggs))
        got.append(eng.run()[0])
    launches = {k: m.LAUNCHES for k, m in mods.items()}
    print(f"kernel launches on the main path: {launches}; "
          f"dispatch counts {eng.metrics.launch_counts()}")
    ref = QueryEngine(table, mode="torch_ref")
    bad = []
    for (name, plan, aggs), res in zip(shapes, got):
        ref.submit(Query(plan, aggregates=aggs))
        want = ref.run()[0]
        same = res.aggregates == want.aggregates
        print(f"{name:18s} auto {res.latency_s * 1e3:9.3f} ms "
              f"{res.bytes_scanned / res.latency_s / 1e9:8.1f} GB/s | "
              f"torch_ref {want.latency_s * 1e3:9.3f} ms | "
              f"count {res.count} equal={same}")
        ok = same and all(
            0 <= d["count"] <= table.num_rows and d["min"] >= 0
            and d["max"] <= (1 << (MAIN_SPEC[c] - 1)) - 1
            for c, d in res.aggregates.items())
        if not ok:
            bad.append((name, res.aggregates, want.aggregates))
    if got[-1].count != 0:
        bad.append(("empty_selection count", got[-1].count))
    print("summary auto", json.dumps(eng.summary()))
    print("summary torch_ref", json.dumps(ref.summary()))
    if bad:
        for b in bad:
            print("MISMATCH", b, file=sys.stderr)
        fail(f"{len(bad)} main-path results differ from torch_ref")
    zero = [k for k, n in launches.items() if n == 0]
    if zero:
        fail(f"kernels never launched on the main path: {zero}")
    return launches


def profile_phase(table) -> None:
    """Where a warm query's time goes: each plan shape again (the caching
    allocator now holds its blocks), then once more under torch.profiler
    for the device's busy share and the device time by kernel name."""
    phase("profile")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.query import Query, QueryEngine
    shapes = plan_shapes()
    eng = QueryEngine(table, mode="auto")
    for name, plan, aggs in shapes:
        eng.submit(Query(plan, aggregates=aggs))
        res = eng.run()[0]
        print(f"warm {name:18s} {res.latency_s * 1e3:9.3f} ms "
              f"{res.bytes_scanned / res.latency_s / 1e9:8.1f} GB/s")
    print("summary warm", json.dumps(eng.summary()))
    eng = QueryEngine(table, mode="auto")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, plan, aggs in shapes:
            eng.submit(Query(plan, aggregates=aggs))
            eng.run()
    wall_us = eng.seconds_total * 1e6
    # device-side rows only (kernels, memcpy, memset: no host time of their
    # own); the aten:: rows carry the same device time a second time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.self_cpu_time_total == 0 and e.self_device_time_total > 0]
    busy_us = sum(r[0] for r in rows)
    ours_us = sum(r[0] for r in rows
                  if "scan_kernel" in r[2] or "aggregate_kernel" in r[2])
    print(f"profiled 11 queries: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, busy share {busy_us / wall_us:.4f}; "
          f"the port's CUDA kernels {ours_us / 1e3:.3f} ms, other device "
          f"work {(busy_us - ours_us) / 1e3:.3f} ms")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  device {us / 1e3:10.3f} ms  x{count:5d}  {key[:100]}")


# --------------------------------------------------------------------------
# 5. times
# --------------------------------------------------------------------------

def time_ms(fn) -> float:
    """Median of TIMED CUDA-event timings after WARMUP runs."""
    for _ in range(WARMUP):
        fn()
    ts = []
    for _ in range(TIMED):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def times_phase(table, dev: dict, launches: dict, parity_err: dict) -> list:
    phase("times")
    mods = kernel_modules()
    from repro_torch.kernels.aggregate import ref as agg_ref
    from repro_torch.kernels.scan_aggregate import ref as fused_ref
    from repro_torch.kernels.scan_filter import ref as scan_ref

    a, b = table.columns["a"], table.columns["b"]
    n, bits, cpw = a.words.shape[0], a.code_bits, 32 // a.code_bits
    # the main path's shapes: a lt 50 scanned (and_same_width), b
    # aggregated under that validity-masked mask, a lt 50 fused over b
    mask = mods["scan_filter"].scan_packed(a.words, 50, op="ge",
                                           code_bits=bits, invert=True) \
        & a.valid_words

    runs = {
        "scan_filter": (
            lambda: mods["scan_filter"].scan_packed(
                a.words, 50, op="ge", code_bits=bits, invert=True),
            lambda: scan_ref.scan_ref(a.words, 50, "lt", bits),
            8 * n, 4 * n),
        "aggregate": (
            lambda: mods["aggregate"].aggregate_packed(
                b.words, mask, code_bits=bits)[0],
            lambda: agg_ref.aggregate_ref(b.words, mask, bits).row,
            8 * n + 20, 6 * n * cpw + 2 * n),
        "scan_aggregate": (
            lambda: mods["scan_aggregate"].scan_aggregate_packed(
                a.words, b.words, a.valid_words, constant=50, op="ge",
                invert=True, code_bits=bits)[0],
            lambda: fused_ref.scan_aggregate_ref(
                a.words, b.words, a.valid_words, 50, "lt", bits).row,
            12 * n + 20, 6 * n * cpw + 7 * n),
    }
    replaces = {"scan_filter": "src/repro/kernels/scan_filter/kernel.py:68",
                "aggregate": "src/repro/kernels/aggregate/kernel.py:182",
                "scan_aggregate":
                    "src/repro/kernels/scan_aggregate/kernel.py:233"}
    out = []
    for name, (kern, plain, nbytes, ops) in runs.items():
        e = int((kern().long() - plain().long()).abs().max())
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        bytes_ms = nbytes / MEM_BPS * 1e3
        ops_ms = ops / CORE_OPS * 1e3
        rec = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/csrc/{name}.cu",
               "replaces": replaces[name], "launches": launches[name],
               "max_abs_err": max(e, parity_err[name]), "ms": ms,
               "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": None, "bytes": nbytes, "ops": ops,
               "n_words": n, "code_bits": bits}
        print(f"{name:15s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})  "
              f"{nbytes / ms / 1e6:.1f} GB/s  [{dev['smi']}]", flush=True)
        if e:
            fail(f"{name} differs from its plain version at the main "
                 f"path's shape (max abs err {e})")
        out.append(rec)
    return out


def main() -> None:
    dev = device_phase()
    sys.path.insert(0, str(SRC))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        fail(f"cannot import the port from {SRC}: {e}")
    phase("build")
    t0 = time.perf_counter()
    for name, rep in _build.build().items():
        print(f"built {name} in {rep['seconds']:.3f} s")
        print(rep["log"].strip())
    print(f"build total {time.perf_counter() - t0:.3f} s", flush=True)
    parity_err = parity_phase()
    table = build_table()
    launches = main_phase(table)
    kernels = times_phase(table, dev, launches, parity_err)
    profile_phase(table)
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"],
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
