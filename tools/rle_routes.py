"""Device and host time of the RLE scan+aggregate kernels' two routes
(kernels 6-7, src/repro_torch/csrc/scan_compressed.cu) on one CUDA card.

    python3 tools/rle_routes.py [--parent DIR] [--out FILE]

1. Builds the scan_compressed library from the checkout. With --parent,
   also the same source of an earlier checkout at DIR, whose C entries
   take no route (one block a chunk), driven through that checkout's
   wrapper logic: "parent" in the tables below.
2. Checks both routes (and the parent) against the plain version on
   random planes, aligned and one int32 off a 16-byte boundary.
3. Device µs a launch of each route over a grid of (chunks, runs): 20
   launches queued behind a sleep kernel, so the events time the card
   and not the host; the median of five samples. Routes alternate
   (warp, block, block, warp) and the parent sits on both ends.
4. Host µs a call of the wrappers and of the pieces of their host path:
   2000 calls enqueued with no synchronise, the min and median of nine
   rounds.
5. With --parent, the parent's wrappers against this checkout's at
   kernel 6's [1, 1] and [1, 4096] and kernel 7's [4096, 2] and [4096,
   4096]: ten pairs, alternating which side runs first, of
   chip_smoke.py's back-to-back time and of host µs a call.
6. Steps 4's wrappers and 5 again after one torch.profiler window, as
   chip_smoke.py times kernels after its profiled phases.

Prints the card's name and power limit first; with --out, writes the
tables as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.scan_compressed import kernel as K  # noqa: E402
from repro_torch.kernels.scan_compressed import ref  # noqa: E402
from repro_torch.kernels.scan_filter.ref import OPS  # noqa: E402

CHUNKS = (1, 8, 33, 132, 264, 528, 1056, 2112, 4096)
RUNS = (1, 2, 64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 4096)


def parent_entries(parent: Path):
    """The parent checkout's library, built here, and its two wrappers
    with that checkout's host path (check_operand twice, a
    torch.cuda.device context, torch.empty by device, no route)."""
    src = parent / "src" / "repro_torch" / "csrc"
    so = ROOT / "build" / "rle_routes_parent.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
                    str(so), str(src / "scan_compressed.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rle_scan_aggregate_launch.argtypes = [p, p, p, ll, i, i, i, p]
    lib.rle_scan_aggregate_batched_launch.argtypes = [p, p, p, ll, ll, i, i,
                                                      i, p]
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p

    def check(op, constant, code_bits):
        if op not in OPS or code_bits not in (2, 4, 8, 16) or \
                not -2**31 <= int(constant) < 2**31:
            raise ValueError(op)

    def single(values, lengths, *, constant, op, code_bits):
        check(op, constant, code_bits)
        _build.check_operand(values, "values")
        _build.check_operand(lengths, "lengths", like=values)
        out = torch.empty((1, 5), dtype=torch.int32, device=values.device)
        with torch.cuda.device(values.device):
            err = lib.rle_scan_aggregate_launch(
                values.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                values.shape[0], int(constant), OPS.index(op), code_bits,
                _build.stream_of(values))
        _build.check(lib, err, "parent")
        return out

    def batched(values2, lengths2, *, constant, op, code_bits):
        check(op, constant, code_bits)
        _build.check_operand(values2, "values2", ndim=2)
        _build.check_operand(lengths2, "lengths2", like=values2, ndim=2)
        n_chunks, n_runs = values2.shape
        out = torch.empty((n_chunks, 5), dtype=torch.int32,
                          device=values2.device)
        with torch.cuda.device(values2.device):
            err = lib.rle_scan_aggregate_batched_launch(
                values2.data_ptr(), lengths2.data_ptr(), out.data_ptr(),
                n_chunks, n_runs, int(constant), OPS.index(op), code_bits,
                _build.stream_of(values2))
        _build.check(lib, err, "parent")
        return out
    return single, batched


def b2b_ms(fn, reps: int = 20, samples: int = 20) -> float:
    """chip_smoke.py's back-to-back time: the median over `samples` of
    `reps` calls between two CUDA events, host work included."""
    for _ in range(3):
        fn()
    ts = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts)


def quartiles(xs) -> list[float]:
    q = statistics.quantiles(xs, n=4)
    return [q[0], statistics.median(xs), q[2]]


def parent_vs_new(shapes: dict, pairs: int = 10) -> dict:
    """At each shape, `pairs` pairs of the parent's wrapper and this
    checkout's, alternating which runs first: back-to-back ms (b2b_ms)
    and host µs a call (one round of 1000 calls). Returns each side's
    quartiles and the pairs the new wrapper won."""
    out = {}
    for name, sides in shapes.items():
        got = {k: {"b2b_ms": [], "host_us": []} for k in sides}
        for p in range(pairs):
            for k in (("parent", "new") if p % 2 == 0 else ("new", "parent")):
                got[k]["b2b_ms"].append(b2b_ms(sides[k]))
                got[k]["host_us"].append(host_us(sides[k], 1000, 1)[0])
        rec = {k: {m: quartiles(x) for m, x in v.items()}
               for k, v in got.items()}
        for m in ("b2b_ms", "host_us"):
            rec[f"new_wins_{m}"] = sum(
                a < b for a, b in zip(got["new"][m], got["parent"][m]))
        out[name] = rec
        print(f"{name}: b2b ms quartiles parent "
              f"{[round(x, 4) for x in rec['parent']['b2b_ms']]} new "
              f"{[round(x, 4) for x in rec['new']['b2b_ms']]} (new wins "
              f"{rec['new_wins_b2b_ms']}/{pairs}); host us parent "
              f"{[round(x, 2) for x in rec['parent']['host_us']]} new "
              f"{[round(x, 2) for x in rec['new']['host_us']]} (new wins "
              f"{rec['new_wins_host_us']}/{pairs})", flush=True)
    return out


def device_us(fn, reps: int = 20, samples: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(samples):
        torch.cuda._sleep(5_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps * 1e3)
    return statistics.median(ts)


def host_us(fn, n: int = 2000, rounds: int = 9) -> tuple[float, float]:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return min(out), statistics.median(out)


def planes(g, n_chunks: int, n_runs: int, offset: int = 0):
    return tuple(torch.randint(0, hi, (n_chunks * n_runs + offset,),
                               device="cuda", dtype=torch.int32,
                               generator=g)[offset:].view(n_chunks, n_runs)
                 for hi in (128, 17))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rle_routes: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, f"torch {torch.__version__}", flush=True)
    _build.build(("scan_compressed",))
    calls = {w: (lambda v, l, w=w: K.rle_scan_aggregate_batched_packed(
        v, l, constant=60, op="lt", code_bits=8, way=w)) for w in K.ROUTES}
    if args.parent is not None:
        ps, pb = parent_entries(args.parent)
        calls["parent"] = lambda v, l: pb(v, l, constant=60, op="lt",
                                          code_bits=8)
    g = torch.Generator(device="cuda").manual_seed(18)

    bad = 0
    for n_chunks, n_runs in ((1, 1), (9, 33), (4096, 2), (7, 1000),
                             (4096, 1536), (1, 4096)):
        for offset in (0, 1):
            v, l = planes(g, n_chunks, n_runs, offset)
            for op in OPS:
                want = ref.rle_scan_aggregate_batched_ref(v, l, 60, op, 8)
                got = [K.rle_scan_aggregate_batched_packed(
                    v, l, constant=60, op=op, code_bits=8, way=w)
                    for w in K.ROUTES]
                if "parent" in calls:
                    got.append(pb(v, l, constant=60, op=op, code_bits=8))
                    if n_chunks == 1:
                        got.append(ps(v[0], l[0], constant=60, op=op,
                                      code_bits=8)[0][None])
                bad += sum(not torch.equal(x, want) for x in got)
    print(f"{' and '.join(k for k in calls)} against the plain version: "
          f"{bad} differ", flush=True)
    if bad:
        raise SystemExit(1)

    device = {}
    order = ["parent", "warp", "block", "block", "warp", "parent"]
    order = [k for k in order if k in calls]
    for n_chunks in CHUNKS:
        row = {}
        for n_runs in RUNS:
            v, l = planes(g, n_chunks, n_runs)
            t = {}
            for k in order:
                t.setdefault(k, []).append(
                    device_us(lambda k=k: calls[k](v, l)))
            row[n_runs] = {k: statistics.mean(x) for k, x in t.items()}
        device[n_chunks] = row
        print(f"[{n_chunks} chunks] device us a launch, runs: " + "  ".join(
            f"{r}: " + "/".join(f"{row[r][k]:.2f}" for k in
                                ("parent", "warp", "block") if k in row[r])
            for r in RUNS), flush=True)
    print("(columns: " + "/".join(k for k in ("parent", "warp", "block")
                                  if k in calls) + ")")

    v, l = planes(g, 4096, 2)
    v1, l1 = v[0, :1], l[0, :1]
    out = torch.empty((4096, 5), dtype=torch.int32, device="cuda")
    index, dev = v.get_device(), v.device
    call_on = (lambda: _build.call_on(v, entry, 0, 0, 0, 0, 2, 60, 0, 8, 1,
                                      _build.stream_of(v)))
    lib = _build.load("scan_compressed")
    entry = lib.rle_scan_aggregate_batched_launch
    stream = _build.stream_of(v)

    def with_device():
        with torch.cuda.device(dev):
            pass
    pieces = {
        "tensor.get_device()": lambda: v.get_device(),
        "check_operand": lambda: _build.check_operand(v, "v", ndim=2),
        "check_operand, like=": lambda: _build.check_operand(
            l, "l", like=v, ndim=2),
        "kernel._check_planes (both planes)": lambda: K._check_planes(
            v, l, ("v", "l"), 2),
        "with torch.cuda.device": with_device,
        "torch.empty, device object": lambda: torch.empty(
            (4096, 5), dtype=torch.int32, device=dev),
        "torch.empty, sizes as arguments": lambda: torch.empty(
            4096, 5, dtype=torch.int32, device=dev),
        "torch.empty, device index": lambda: torch.empty(
            (4096, 5), dtype=torch.int32, device=index),
        "C entry, no launch": lambda: entry(0, 0, 0, 0, 2, 60, 0, 8, 1,
                                            stream),
        "_build.call_on + stream_of, C entry, no launch": call_on,
        "C entry with its launch": lambda: entry(
            v.data_ptr(), l.data_ptr(), out.data_ptr(), 4096, 2, 4, 0, 8, 1,
            stream),
        "wrapper, kernel 6 at [1, 1]": lambda: K.rle_scan_aggregate_packed(
            v1, l1, constant=4, op="lt", code_bits=8),
        "wrapper, kernel 7 at [4096, 2]":
            lambda: K.rle_scan_aggregate_batched_packed(
                v, l, constant=4, op="lt", code_bits=8),
    }
    if "parent" in calls:
        pieces["parent wrapper, kernel 7 at [4096, 2]"] = \
            lambda: calls["parent"](v, l)
    host = {}
    for name, fn in pieces.items():
        host[name] = host_us(fn)
        print(f"host {name:40s} min {host[name][0]:7.3f} us  median "
              f"{host[name][1]:7.3f} us", flush=True)
    ab = {}
    if "parent" in calls:
        big = planes(g, 4096, 4096)
        kw = dict(constant=60, op="lt", code_bits=8)
        shapes = {
            "kernel 6 at [1, 1]": {
                "parent": lambda: ps(v1, l1, **kw),
                "new": lambda: K.rle_scan_aggregate_packed(v1, l1, **kw)},
            "kernel 6 at [1, 4096]": {
                "parent": lambda: ps(big[0][0], big[1][0], **kw),
                "new": lambda: K.rle_scan_aggregate_packed(
                    big[0][0], big[1][0], **kw)},
            "kernel 7 at [4096, 2]": {
                "parent": lambda: pb(v, l, **kw),
                "new": lambda: K.rle_scan_aggregate_batched_packed(
                    v, l, **kw)},
            "kernel 7 at [4096, 4096]": {
                "parent": lambda: pb(*big, **kw),
                "new": lambda: K.rle_scan_aggregate_batched_packed(
                    *big, **kw)}}
        print("parent vs new, before any profiler window:")
        ab["before_profiler"] = parent_vs_new(shapes)
    # chip_smoke.py profiles earlier phases before it times these wrappers:
    # the same wrappers again after one torch.profiler window
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(20):
            pieces["wrapper, kernel 7 at [4096, 2]"]()
        torch.cuda.synchronize()
    for name in ("wrapper, kernel 6 at [1, 1]",
                 "wrapper, kernel 7 at [4096, 2]"):
        key = f"{name}, after a profiler window"
        host[key] = host_us(pieces[name])
        print(f"host {key:40s} min {host[key][0]:7.3f} us  median "
              f"{host[key][1]:7.3f} us", flush=True)
    if "parent" in calls:
        print("parent vs new, after a profiler window:")
        ab["after_profiler"] = parent_vs_new(shapes)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "device_us": device,
                                        "host_us": host,
                                        "parent_vs_new": ab}, indent=1))
    print(f"done [{smi}]")


if __name__ == "__main__":
    main()
