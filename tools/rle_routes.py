"""Device and host time of the two-route RLE kernels on one CUDA card:
the scan+aggregate (kernels 6-7, src/repro_torch/csrc/scan_compressed.cu)
and the grouped accumulate (kernel 9, src/repro_torch/csrc/
group_aggregate.cu).

    python3 tools/rle_routes.py [--parent DIR] [--family NAME] [--out FILE]

For each family (both, or the one --family names):
1. Builds its library from the checkout. With --parent, also the same
   source of an earlier checkout at DIR from before that family's two
   routes, whose C entries take no route (one block a chunk), driven
   through that checkout's wrapper logic: "parent" in the tables below.
   A checkout that has one family's routes but not the other's serves
   as the parent of the other only (--family).
2. Checks both routes (and the parent) against the plain version on
   random planes, aligned and one int32 off a 16-byte boundary (kernel
   9: contiguous and join keys, with and without a predicate).
3. Device µs a launch of each route over a grid of (chunks, runs), and
   for kernel 9 of G: 20 launches queued behind a sleep kernel, so the
   events time the card and not the host; the median of five samples.
   Routes alternate (warp, block, block, warp) and the parent sits on
   both ends.
4. Host µs a call of the wrappers and of the pieces of their host path:
   2000 calls enqueued with no synchronise, the min and median of nine
   rounds.
5. With --parent, the parent's wrappers against this checkout's (kernel
   6 at [1, 1] and [1, 4096], kernel 7 at [4096, 2] and [4096, 4096];
   kernel 9 at [4096, 2], G = 8 and [4096, 4096], G = 128): ten pairs,
   alternating which side runs first, of chip_smoke.py's back-to-back
   time and of host µs a call.
6. Steps 4's wrappers and 5 again after one torch.profiler window, as
   chip_smoke.py times kernels after its profiled phases.

Prints the card's name and power limit first; with --out, writes the
tables as JSON, by family.
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
from repro_torch.kernels.group_aggregate import kernel as GK  # noqa: E402
from repro_torch.kernels.group_aggregate import ref as gref  # noqa: E402
from repro_torch.kernels.scan_compressed import kernel as K  # noqa: E402
from repro_torch.kernels.scan_compressed import ref  # noqa: E402
from repro_torch.kernels.scan_filter.ref import OPS  # noqa: E402

FAMILIES = ("scan_compressed", "group_aggregate")
CHUNKS = (1, 8, 33, 132, 264, 528, 1056, 2112, 4096)
RUNS = (1, 2, 64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 4096)
GROUP_CHUNKS = (1, 8, 132, 528, 1056, 2112, 4096)
GROUP_RUNS = (1, 2, 32, 128, 512, 1536, 4096)
GROUP_SIZES = (1, 8, 32, 128, 1024)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def parent_library(parent: Path, family: str) -> ctypes.CDLL:
    """The parent checkout's `family` library, built here."""
    src = parent / "src" / "repro_torch" / "csrc"
    so = ROOT / "build" / f"rle_routes_parent_{family}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
                    str(so), str(src / _build.SOURCES[family])], check=True)
    lib = ctypes.CDLL(str(so))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def parent_entries(parent: Path):
    """The parent checkout's scan_compressed library and its two wrappers
    with that checkout's host path (check_operand twice, a
    torch.cuda.device context, torch.empty by device, no route)."""
    lib = parent_library(parent, "scan_compressed")
    lib.rle_scan_aggregate_launch.argtypes = [_P, _P, _P, _LL, _I, _I, _I, _P]
    lib.rle_scan_aggregate_batched_launch.argtypes = [_P, _P, _P, _LL, _LL,
                                                      _I, _I, _I, _P]

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


def planes(g, n_chunks: int, n_runs: int, offset: int = 0,
           vmax: int = 128):
    """Random (n_chunks, n_runs) run values below vmax and lengths below
    17; with offset 1, views one int32 into their buffers."""
    return tuple(torch.randint(0, hi, (n_chunks * n_runs + offset,),
                               device="cuda", dtype=torch.int32,
                               generator=g)[offset:].view(n_chunks, n_runs)
                 for hi in (vmax, 17))


def device_grid(calls: dict, points, inputs, label) -> dict:
    """Device µs a launch (device_us) of each entry of `calls` at each
    point of `points`, `inputs(point)` the call's arguments there: the
    routes in turns (warp, block, block, warp) and the parent on both
    ends, the mean of each side's two readings. Prints a line a point
    and returns {str(point): {side: µs}}."""
    order = [k for k in ("parent", "warp", "block", "block", "warp",
                         "parent") if k in calls]
    sides = [k for k in ("parent", "warp", "block") if k in calls]
    out = {}
    for point in points:
        args = inputs(point)
        t = {}
        for k in order:
            t.setdefault(k, []).append(
                device_us(lambda k=k: calls[k](*args)))
        out[str(point)] = {k: statistics.mean(x) for k, x in t.items()}
        print(f"{label} {list(point)} device us a launch, "
              f"{'/'.join(sides)}: " + "/".join(
                  f"{out[str(point)][k]:.2f}" for k in sides), flush=True)
    return out


def host_table(pieces: dict) -> dict:
    """host_us of each named piece, printed as it is read."""
    host = {}
    for name, fn in pieces.items():
        host[name] = host_us(fn)
        print(f"host {name:48s} min {host[name][0]:7.3f} us  median "
              f"{host[name][1]:7.3f} us", flush=True)
    return host


def around_profiler(pieces: dict, warm: str, shapes: dict | None,
                    host: dict) -> dict:
    """With `shapes`, parent_vs_new before and after one torch.profiler
    window over 20 calls of pieces[warm]; the wrapper pieces (names that
    start with "wrapper") timed again after it, into `host`."""
    ab = {}
    if shapes:
        print("parent vs new, before any profiler window:")
        ab["before_profiler"] = parent_vs_new(shapes)
    # chip_smoke.py profiles earlier phases before it times these wrappers:
    # the same wrappers again after one torch.profiler window
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(20):
            pieces[warm]()
        torch.cuda.synchronize()
    host.update(host_table({f"{name}, after a profiler window": fn
                            for name, fn in pieces.items()
                            if name.startswith("wrapper")}))
    if shapes:
        print("parent vs new, after a profiler window:")
        ab["after_profiler"] = parent_vs_new(shapes)
    return ab


def scan_family(args, g) -> dict:
    """Steps 1-6 for kernels 6-7 (scan_compressed)."""
    _build.build(("scan_compressed",))
    calls = {w: (lambda v, l, w=w: K.rle_scan_aggregate_batched_packed(
        v, l, constant=60, op="lt", code_bits=8, way=w)) for w in K.ROUTES}
    if args.parent is not None:
        ps, pb = parent_entries(args.parent)
        calls["parent"] = lambda v, l: pb(v, l, constant=60, op="lt",
                                          code_bits=8)

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
    print(f"kernels 6-7: {' and '.join(k for k in calls)} against the "
          f"plain version: {bad} differ", flush=True)
    if bad:
        raise SystemExit(1)

    device = device_grid(calls, [(c, r) for c in CHUNKS for r in RUNS],
                         lambda pt: planes(g, *pt), "kernel 7 at")

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
    host = host_table(pieces)
    shapes = None
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
    ab = around_profiler(pieces, "wrapper, kernel 7 at [4096, 2]", shapes,
                         host)
    return {"device_us": device, "host_us": host, "parent_vs_new": ab}


def group_parent_entry(parent: Path):
    """The parent checkout's group_aggregate library and its RLE wrapper
    with that checkout's host path (check_operand three times, a device
    compare, a torch.cuda.device context, torch.empty by shape tuple, no
    route)."""
    lib = parent_library(parent, "group_aggregate")
    lib.rle_group_accumulate_launch.argtypes = [_P, _P, _P, _P, _LL, _LL, _I,
                                                _I, _I, _I, _I, _P]

    def batched(values2, lengths2, group_keys, pred=None):
        _build.check_operand(values2, "values2", ndim=2)
        _build.check_operand(lengths2, "lengths2", like=values2, ndim=2)
        _build.check_operand(group_keys, "group_keys")
        if group_keys.device != values2.device:
            raise ValueError("group_keys")
        g = group_keys.shape[0]
        if not 1 <= g <= GK.MAX_GROUPS:
            raise ValueError("group_keys")
        prim, const, invert = ("ge", 0, False) if pred is None else pred
        if prim not in ("ge", "eq") or not -2**31 <= int(const) < 2**31:
            raise ValueError(prim)
        n_chunks, n_runs = values2.shape
        out = torch.empty((n_chunks, g, 3), dtype=torch.int32,
                          device=values2.device)
        with torch.cuda.device(values2.device):
            err = lib.rle_group_accumulate_launch(
                values2.data_ptr(), lengths2.data_ptr(),
                group_keys.data_ptr(), out.data_ptr(), n_chunks, n_runs, g,
                int(pred is not None), ("ge", "eq").index(prim), int(const),
                int(bool(invert)), _build.stream_of(values2))
        _build.check(lib, err, "parent")
        return out
    return batched


def group_keys(g, n_groups: int, join: bool) -> tuple[torch.Tensor, int]:
    """Sorted int32 keys on the card and a value bound a little past them:
    0 .. G - 1 (a GROUP BY's domain), or G distinct keys drawn from [0,
    8G + 64) (a join's build keys)."""
    if join:
        gk = torch.randperm(8 * n_groups + 64, device="cuda",
                            generator=g)[:n_groups].sort().values
    else:
        gk = torch.arange(n_groups, device="cuda")
    gk = gk.to(torch.int32)
    return gk, int(gk.max()) + 1 + n_groups // 8


def group_family(args, g) -> dict:
    """Steps 1-6 for kernel 9 (group_aggregate's RLE entry)."""
    _build.build(("group_aggregate",))
    calls = {w: (lambda v, l, k, w=w: GK.rle_group_accumulate_batched_planes(
        v, l, k, way=w)) for w in GK.ROUTES}
    if args.parent is not None:
        pg = group_parent_entry(args.parent)
        calls["parent"] = pg

    bad = 0
    preds = (None, ("ge", 5, False), ("eq", 3, True))
    for n_chunks, n_runs in ((1, 1), (9, 33), (4096, 2), (7, 1000),
                             (4096, 1536), (1, 4096)):
        for n_groups, join in ((1, False), (8, False), (100, True),
                               (1024, False), (1024, True)):
            keys, vmax = group_keys(g, n_groups, join)
            for offset in (0, 1):
                v, l = planes(g, n_chunks, n_runs, offset, vmax)
                for pred in preds:
                    want = gref.rle_group_accumulate_batched_ref(v, l, keys,
                                                                 pred)
                    got = [GK.rle_group_accumulate_batched_planes(
                        v, l, keys, pred=pred, way=w) for w in GK.ROUTES]
                    if "parent" in calls:
                        got.append(pg(v, l, keys, pred))
                    bad += sum(not torch.equal(x, want) for x in got)
    print(f"kernel 9: {' and '.join(k for k in calls)} against the plain "
          f"version: {bad} differ", flush=True)
    if bad:
        raise SystemExit(1)

    keys_by_g = {n: torch.arange(n, dtype=torch.int32, device="cuda")
                 for n in GROUP_SIZES}
    device = device_grid(
        calls, [(c, r, n) for n in GROUP_SIZES for c in GROUP_CHUNKS
                for r in GROUP_RUNS],
        lambda pt: (*planes(g, pt[0], pt[1], vmax=pt[2] + 1),
                    keys_by_g[pt[2]]),
        "kernel 9 at [chunks, runs, G]")

    d8 = keys_by_g[8]
    v, l = planes(g, 4096, 2, vmax=9)
    out = torch.empty(4096, 8, 3, dtype=torch.int32, device="cuda")
    dev = v.device
    lib = _build.load("group_aggregate")
    entry = lib.rle_group_accumulate_launch
    stream = _build.stream_of(v)
    call_on = (lambda: _build.call_on(v, entry, 0, 0, 0, 0, 0, 2, 8, 0, 0,
                                      0, 0, 1, _build.stream_of(v)))

    def with_device():
        with torch.cuda.device(dev):
            pass

    def parent_checks():
        _build.check_operand(v, "v", ndim=2)
        _build.check_operand(l, "l", like=v, ndim=2)
        _build.check_operand(d8, "group_keys")
        return d8.device != v.device
    pieces = {
        "kernel._check_operands (both planes, the keys)":
            lambda: GK._check_operands((v, l), ("v", "l"), 2, d8),
        "the parent's checks (check_operand x 3, a device compare)":
            parent_checks,
        "with torch.cuda.device": with_device,
        "torch.empty, shape tuple": lambda: torch.empty(
            (4096, 8, 3), dtype=torch.int32, device=dev),
        "torch.empty, sizes as arguments": lambda: torch.empty(
            4096, 8, 3, dtype=torch.int32, device=dev),
        "C entry, no launch": lambda: entry(0, 0, 0, 0, 0, 2, 8, 0, 0, 0, 0,
                                            1, stream),
        "_build.call_on + stream_of, C entry, no launch": call_on,
        "C entry with its launch, warp route": lambda: entry(
            v.data_ptr(), l.data_ptr(), d8.data_ptr(), out.data_ptr(), 4096,
            2, 8, 0, 0, 0, 0, 1, stream),
        "wrapper, kernel 9 at [4096, 2], G = 8":
            lambda: GK.rle_group_accumulate_batched_planes(v, l, d8),
    }
    if "parent" in calls:
        pieces["parent wrapper, kernel 9 at [4096, 2], G = 8"] = \
            lambda: pg(v, l, d8)
    host = host_table(pieces)
    shapes = None
    if "parent" in calls:
        d128 = keys_by_g[128]
        big = planes(g, 4096, 4096)
        shapes = {
            "kernel 9 at [4096, 2], G = 8": {
                "parent": lambda: pg(v, l, d8),
                "new": lambda: GK.rle_group_accumulate_batched_planes(
                    v, l, d8)},
            "kernel 9 at [4096, 4096], G = 128": {
                "parent": lambda: pg(*big, d128),
                "new": lambda: GK.rle_group_accumulate_batched_planes(
                    *big, d128)}}
    ab = around_profiler(pieces, "wrapper, kernel 9 at [4096, 2], G = 8",
                         shapes, host)
    return {"device_us": device, "host_us": host, "parent_vs_new": ab}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--family", choices=FAMILIES, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rle_routes: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, f"torch {torch.__version__}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(18)
    runs = {"scan_compressed": scan_family, "group_aggregate": group_family}
    tables = {"card": smi}
    for family in ([args.family] if args.family else FAMILIES):
        tables[family] = runs[family](args, g)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(tables, indent=1))
    print(f"done [{smi}]")


if __name__ == "__main__":
    main()
