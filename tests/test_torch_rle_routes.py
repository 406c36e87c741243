"""The two routes of the port's RLE scan+aggregate kernel (kernels 6-7,
csrc/scan_compressed.cu), emulated on the CPU.

The CUDA kernel runs only on the card. What it does differently from the
plain version is how it splits a chunk's runs among threads and folds
the threads' partials: the warp route gives lane i runs i, i + 32, ... (by
16-byte groups of four, then a scalar tail) and folds the 32 lanes by an
xor-shuffle tree; the block route does the same over 256 threads, folds
each warp by shuffles down and the eight warps in thread 0.
`route_ref` emulates that partition and fold in numpy, with the kernel's
integer types (a 64-bit sum and count a thread, int32 min/max, the
int32[5] output row), and the tests hold it against the port's plain
version and the reference (its jnp oracle, and its Pallas kernel in
interpret mode) bit for bit. `kernel.route` picks the route.
"""
import numpy as np
import pytest
import torch

from repro.kernels.scan_compressed import ops as jops
from repro_torch.kernels.scan_compressed import kernel as tkernel
from repro_torch.kernels.scan_compressed import ref as tref

OPS = ("lt", "le", "gt", "ge", "eq", "ne")
RUN_COUNTS = (1, 2, 3, 31, 32, 33, 127, 128, 129, 1001, 4096)
THREADS = {"warp": 32, "block": 256}
U64 = (1 << 64) - 1


def _select(v, c, op):
    return {"lt": v < c, "le": v <= c, "gt": v > c, "ge": v >= c,
            "eq": v == c, "ne": v != c}[op]


def _int32(x: int) -> int:
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def _combine(a, b):
    """One shuffle step: (sum, count, min, max) of two partials."""
    return ((a[0] + b[0]) & U64, (a[1] + b[1]) & U64, min(a[2], b[2]),
            max(a[3], b[3]))


def thread_partials(v, n, constant, op, code_bits, threads, vec):
    """Each thread's (sum, count, min, max) over its runs: with `vec`
    (the 16-byte body exists: an aligned row of n_runs % 4 == 0), int4 i
    of the body goes to thread i % threads, then run head + j of the tail
    to thread j % threads; without, run j to thread j % threads."""
    n_runs = v.shape[0]
    head = n_runs // 4 * 4 if vec else 0
    r = np.arange(n_runs)
    owner = np.where(r < head, (r // 4) % threads, (r - head) % threads)
    vmax = (1 << (code_bits - 1)) - 1
    sel = _select(v, constant, op) & (n > 0)
    out = []
    for t in range(threads):
        mine = sel & (owner == t)
        vv, nn = v[mine].astype(np.int64), n[mine].astype(np.int64)
        out.append((int((vv * nn).sum()) & U64, int(nn.sum()) & U64,
                    int(vv.min()) if vv.size else vmax,
                    int(vv.max()) if vv.size else 0))
    return out


def warp_fold(acc):
    """__shfl_xor_sync over offsets 16 .. 1: every lane ends with the
    warp's total; lane 0's is returned."""
    for off in (16, 8, 4, 2, 1):
        acc = [_combine(acc[i], acc[i ^ off]) for i in range(32)]
    return acc[0]


def block_fold(acc):
    """bitweave.cuh's block_reduce: __shfl_down_sync over 16 .. 1 in each
    warp (a lane past 31 reads its own value), then thread 0 folds warps
    1 .. 7 into warp 0's total."""
    warps = []
    for w in range(len(acc) // 32):
        lanes = acc[32 * w:32 * (w + 1)]
        for off in (16, 8, 4, 2, 1):
            lanes = [_combine(lanes[i], lanes[i + off if i + off < 32
                                                else i])
                     for i in range(32)]
        warps.append(lanes[0])
    total = warps[0]
    for w in warps[1:]:
        total = _combine(total, w)
    return total


def route_ref(values2, lengths2, constant, op, code_bits, way,
              aligned=True):
    """(n_chunks, n_runs) run planes -> int32[n_chunks, 5] as route `way`
    of the CUDA kernel computes them (a chunk a warp, or a chunk a block),
    `aligned` saying whether the planes' base lies on 16 bytes."""
    rows = []
    vec = aligned and values2.shape[1] % 4 == 0
    fold = warp_fold if way == "warp" else block_fold
    for v, n in zip(values2, lengths2):
        s, cnt, mn, mx = fold(thread_partials(v, n, constant, op, code_bits,
                                              THREADS[way], vec))
        rows.append([_int32(s & 0xFFFF), _int32(s >> 16), _int32(cnt),
                     mn, mx])
    return np.asarray(rows, dtype=np.int32).reshape(-1, 5)


def warp_route_ref(values2, lengths2, constant, op, code_bits,
                   aligned=True):
    """The warp route: lane i sums runs i::32 (16-byte body, then the
    scalar tail) and the lanes fold by an xor-shuffle tree."""
    return route_ref(values2, lengths2, constant, op, code_bits, "warp",
                     aligned)


def _planes(rng, code_bits):
    """One chunk a run count of RUN_COUNTS, values in [0, vmax], lengths in
    [0, 16] (zero-length runs included)."""
    vmax = (1 << (code_bits - 1)) - 1
    return [(rng.integers(0, vmax + 1, k).astype(np.int32),
             rng.integers(0, 17, k).astype(np.int32)) for k in RUN_COUNTS]


@pytest.mark.parametrize("n_chunks", (1, 8, 9, 264, 1056, 2112, 3072,
                                      4096, 8192))
def test_route_at_the_threshold_edges(n_chunks):
    """Threshold - 1 and the threshold take the warp route, threshold + 1
    the block; 0 and 1 runs the warp."""
    limit = tkernel.warp_limit(n_chunks)
    assert limit == min(1536, max(128, n_chunks // 2))
    assert [tkernel.route(n_chunks, r) for r in
            (0, 1, limit - 1, limit, limit + 1)] == \
        ["warp", "warp", "warp", "warp", "block"]


def test_route_codes():
    """The C entries' route codes: block 0, warp 1."""
    assert tkernel.ROUTES == ("block", "warp")


def test_store_path_shapes_take_their_routes():
    """Kernel 6 at one run and kernel 7 at the store's 4096 chunks of 2
    runs take the warp route; one chunk of 4096 runs and the largest legal
    plane (4096 x 4096) the block route."""
    assert tkernel.route(1, 1) == tkernel.route(4096, 2) == "warp"
    assert tkernel.route(4096, 4096) == tkernel.route(1, 4096) == "block"


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("bits", (2, 4, 8, 16))
def test_warp_route_matches_plain_and_reference(bits, op):
    """Random planes of every RUN_COUNTS length, constants in range, at
    vmax and past it: the warp route's emulation equals the plain version
    and the reference's oracle bit for bit, aligned and not; its Pallas
    kernel at vmax and vmax + 1."""
    rng = np.random.default_rng(100 * bits + OPS.index(op))
    planes = _planes(rng, bits)
    vmax = (1 << (bits - 1)) - 1
    for c in (0, vmax // 2, vmax, vmax + 1):
        want = np.asarray(jops.rle_scan_aggregate_batched(
            planes, c, op, bits, mode="xla_ref"))
        if c >= vmax:
            np.testing.assert_array_equal(np.asarray(
                jops.rle_scan_aggregate_batched(planes, c, op, bits,
                                                mode="pallas")), want)
        for k, (v, n) in enumerate(planes):
            plain = tref.rle_scan_aggregate_batched_ref(
                torch.from_numpy(v)[None], torch.from_numpy(n)[None], c, op,
                bits).numpy()
            np.testing.assert_array_equal(plain[0], want[k])
            for aligned in (True, False):
                got = warp_route_ref(v[None], n[None], c, op, bits, aligned)
                np.testing.assert_array_equal(got[0], want[k],
                                              err_msg=f"{v.size} {c}")


@pytest.mark.parametrize("bits", (2, 16))
def test_block_route_matches_plain(bits):
    """The block route's emulation (256 threads, block_reduce's fold) on
    the same planes: equal to the plain version for every op."""
    rng = np.random.default_rng(bits)
    planes = _planes(rng, bits)
    vmax = (1 << (bits - 1)) - 1
    for op in OPS:
        for c in (vmax // 2, vmax + 1):
            for v, n in planes:
                want = tref.rle_scan_aggregate_batched_ref(
                    torch.from_numpy(v)[None], torch.from_numpy(n)[None], c,
                    op, bits).numpy()
                for aligned in (True, False):
                    got = route_ref(v[None], n[None], c, op, bits, "block",
                                    aligned)
                    np.testing.assert_array_equal(got, want)


def test_routes_split_many_chunks_as_one():
    """A (9, 40) plane through the warp route, chunk by chunk, equals the
    plain version's rows: one warp a chunk, none reading its neighbour's
    runs."""
    rng = np.random.default_rng(7)
    v = rng.integers(0, 128, (9, 40)).astype(np.int32)
    n = rng.integers(0, 17, (9, 40)).astype(np.int32)
    want = tref.rle_scan_aggregate_batched_ref(torch.from_numpy(v),
                                               torch.from_numpy(n), 60, "lt",
                                               8).numpy()
    np.testing.assert_array_equal(warp_route_ref(v, n, 60, "lt", 8), want)


def test_sum_at_the_chunk_bound_on_both_routes():
    """A full chunk of the 16-bit payload max as one run, and as 4096
    runs of 16: the 64-bit lane sums reach 32767 * 65536 exactly."""
    for k, length in ((1, 65536), (4096, 16)):
        v = np.full((1, k), 32767, np.int32)
        n = np.full((1, k), length, np.int32)
        for way in ("warp", "block"):
            row = route_ref(v, n, 0, "ge", 16, way)[0]
            assert (int(row[1]) << 16) + int(row[0]) == 32767 * 65536
            assert int(row[2]) == 65536


def test_unknown_route_and_cpu_tensors_raise():
    one = torch.ones(4, dtype=torch.int32)
    before = (tkernel.LAUNCHES, tkernel.BATCHED_LAUNCHES)
    with pytest.raises(ValueError, match="route 'lane'"):
        tkernel.rle_scan_aggregate_packed(one, one, constant=1, op="lt",
                                          code_bits=8, way="lane")
    with pytest.raises(ValueError, match="route 'lane'"):
        tkernel.rle_scan_aggregate_batched_packed(
            one[None], one[None], constant=1, op="lt", code_bits=8,
            way="lane")
    for way in tkernel.ROUTES:
        with pytest.raises(ValueError, match="CUDA tensor"):
            tkernel.rle_scan_aggregate_packed(one, one, constant=1, op="lt",
                                              code_bits=8, way=way)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tkernel.rle_scan_aggregate_batched_packed(
                one[None], one[None], constant=1, op="lt", code_bits=8,
                way=way)
    with pytest.raises(ValueError, match="code_bits=3"):
        tkernel.rle_scan_aggregate_packed(one, one, constant=1, op="lt",
                                          code_bits=3)
    with pytest.raises(ValueError, match="not an int32"):
        tkernel.rle_scan_aggregate_batched_packed(
            one[None], one[None], constant=2**31, op="lt", code_bits=8)
    assert (tkernel.LAUNCHES, tkernel.BATCHED_LAUNCHES) == before
