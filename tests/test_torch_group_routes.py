"""The two routes of the port's RLE grouped accumulate (kernel 9,
csrc/group_aggregate.cu), emulated on the CPU.

The CUDA kernel runs only on the card. What its routes do differently from
the plain version is how they split a chunk's runs among threads and
where the threads add: the warp route gives lane i runs i, i + 32, ... (by
16-byte groups of four, then a scalar tail) and adds into the warp's one
uint32 sub-histogram; the block route gives thread t of 256 the same
partition with stride 256, adds into its warp's sub-histogram (eight a
block) and folds the eight in uint32 at the end. A run's key finds its
slot by offset when the keys are contiguous and by a lower-bound search
otherwise. `route_ref` emulates that partition, lookup and fold in numpy
with the kernel's integer types (uint32 adds modulo 2^32, the sum split
as lo = s & 0xFFFF and hi = s >> 16 arithmetic), and the tests hold it
against the port's plain version and the reference (its jnp oracle, and
its Pallas kernel in interpret mode where no sum wraps) bit for bit.
`kernel.route` picks the route.
"""
import numpy as np
import pytest
import torch

from repro.kernels.group_aggregate import ops as jops
from repro_torch.kernels.group_aggregate import kernel as tkernel
from repro_torch.kernels.group_aggregate import ref as tref

RUN_COUNTS = (1, 2, 3, 4, 31, 32, 33, 127, 128, 129, 1001, 4096)
SIZES = (1, 8, 100, 128, 1024)
RUN_PREDS = (None, ("ge", 60, False), ("ge", 60, True), ("eq", 7, False),
             ("eq", 7, True))
THREADS = {"warp": 32, "block": 256}
U32 = np.uint32


def group_keys(n_groups: int, join: bool) -> np.ndarray:
    """0 .. G - 1 (a GROUP BY's domain), or G distinct sorted keys with
    gaps (a join's build keys)."""
    if not join:
        return np.arange(n_groups, dtype=np.int32)
    rng = np.random.default_rng(n_groups)
    return np.sort(rng.choice(8 * n_groups + 64, n_groups,
                              replace=False)).astype(np.int32)


def slot_of(v: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """The kernel's slot_of: the offset from the first key where the keys
    are contiguous, else the lower bound; -1 where v is no key."""
    g = keys.size
    if int(keys[-1]) - int(keys[0]) == g - 1:
        d = v.astype(np.int64) - int(keys[0])
        return np.where((d >= 0) & (d < g), d, -1)
    lo = np.searchsorted(keys, v, side="left")
    hit = (lo < g) & (keys[np.minimum(lo, g - 1)] == v)
    return np.where(hit, lo, -1)


def owners(n_runs: int, threads: int, vec: bool) -> np.ndarray:
    """The thread that adds each run: with `vec` (an aligned row of
    n_runs % 4 == 0), int4 i of the body goes to thread i % threads, then
    run head + j of the tail to thread j % threads; without, run j to
    thread j % threads."""
    head = n_runs // 4 * 4 if vec else 0
    r = np.arange(n_runs)
    return np.where(r < head, (r // 4) % threads, (r - head) % threads)


def route_ref(values2, lengths2, keys, pred, way, aligned=True):
    """(n_chunks, n_runs) int32 run planes -> int32[n_chunks, G, 3] as
    route `way` of the CUDA kernel computes them, `aligned` saying whether
    the planes' base lies on 16 bytes."""
    n_chunks, n_runs = values2.shape
    g = keys.size
    warp = owners(n_runs, THREADS[way], aligned and n_runs % 4 == 0) // 32
    out = np.zeros((n_chunks, g, 3), np.int32)
    for c in range(n_chunks):
        v, n = values2[c], lengths2[c]
        live = n > 0
        if pred is not None:
            prim, const, invert = pred
            live &= ((v == const) if prim == "eq" else (v >= const)) != invert
        slot = slot_of(v, keys)
        live &= slot >= 0
        sub_s = np.zeros((THREADS[way] // 32, g), U32)
        sub_c = np.zeros_like(sub_s)
        idx = (warp[live], slot[live])
        np.add.at(sub_s, idx, n[live].astype(U32) * v[live].astype(U32))
        np.add.at(sub_c, idx, n[live].astype(U32))
        s = sub_s.sum(axis=0, dtype=U32)          # the fold, modulo 2^32
        cnt = sub_c.sum(axis=0, dtype=U32)
        out[c, :, 0] = s & 0xFFFF
        out[c, :, 1] = s.view(np.int32) >> 16
        out[c, :, 2] = cnt.view(np.int32)
    return out


def ragged(rng, counts, vmax):
    """One chunk a run count of `counts`: values in [0, vmax), lengths in
    [0, 16] (zero-length runs included)."""
    return [(rng.integers(0, vmax, k).astype(np.int32),
             rng.integers(0, 17, k).astype(np.int32)) for k in counts]


def stacked(chunks):
    """stack_runs' (n_chunks, n_runs) planes, padded with zero-length
    runs, as numpy."""
    width = max(v.size for v, _ in chunks)
    v2 = np.zeros((len(chunks), width), np.int32)
    l2 = np.zeros_like(v2)
    for c, (v, n) in enumerate(chunks):
        v2[c, :v.size], l2[c, :n.size] = v, n
    return v2, l2


@pytest.mark.parametrize("join", (False, True), ids=("arange", "join"))
@pytest.mark.parametrize("n_groups", SIZES)
def test_routes_match_plain_and_reference(n_groups, join):
    """Ragged chunks of every RUN_COUNTS length, values past the keys,
    every RUN_PREDS: each route's emulation, on each chunk alone, aligned
    and one int32 off 16 bytes, equals the port's plain version and the
    reference's oracle on the stacked planes bit for bit."""
    keys = group_keys(n_groups, join)
    rng = np.random.default_rng(n_groups * 2 + join)
    chunks = ragged(rng, RUN_COUNTS, int(keys[-1]) + 2 + n_groups // 8)
    v2, l2 = stacked(chunks)
    for pred in RUN_PREDS:
        want = np.asarray(jops.rle_group_accumulate_batched(
            chunks, keys, pred=pred, mode="xla_ref"))
        plain = tref.rle_group_accumulate_batched_ref(
            torch.from_numpy(v2), torch.from_numpy(l2),
            torch.from_numpy(keys), pred).numpy()
        np.testing.assert_array_equal(plain, want)
        for k, (v, n) in enumerate(chunks):
            for way in tkernel.ROUTES:
                for aligned in (True, False):
                    got = route_ref(v[None], n[None], keys, pred, way,
                                    aligned)
                    np.testing.assert_array_equal(
                        got[0], want[k], err_msg=f"{way} {v.size} {pred}")
        # padding runs change nothing: the stacked planes, both routes
        for way in tkernel.ROUTES:
            np.testing.assert_array_equal(
                route_ref(v2, l2, keys, pred, way), want)


@pytest.mark.parametrize("n_groups,join", ((8, False), (128, False),
                                           (100, True)))
def test_routes_match_the_pallas_kernel(n_groups, join):
    """The reference's Pallas kernel in interpret mode (no sum wraps at
    these lengths) against both routes' emulation."""
    keys = group_keys(n_groups, join)
    rng = np.random.default_rng(7 + n_groups)
    chunks = ragged(rng, (1, 33, 1001), int(keys[-1]) + 2)
    v2, l2 = stacked(chunks)
    for pred in (None, ("ge", 60, True), ("eq", 7, False)):
        want = np.asarray(jops.rle_group_accumulate_batched(
            chunks, keys, pred=pred, mode="pallas"))
        for way in tkernel.ROUTES:
            np.testing.assert_array_equal(
                route_ref(v2, l2, keys, pred, way, aligned=False), want)


def test_sum_wraps_as_the_reference_on_both_routes():
    """One run of 65536 rows of 65535: the reference forms n * v in int32
    and gets [0, -1, 65536]; both routes' uint32 adds and arithmetic
    split give the same, as does the plain version. Spread over 4096 runs
    of 16, across lanes and warps, the wrap is the same."""
    keys = np.array([65535], np.int32)
    want = np.asarray(jops.rle_group_accumulate_batched(
        [(np.array([65535], np.int32), np.array([65536], np.int32))], keys,
        mode="xla_ref"))
    assert want.tolist() == [[[0, -1, 65536]]]
    for k, length in ((1, 65536), (4096, 16)):
        v = np.full((1, k), 65535, np.int32)
        n = np.full((1, k), length, np.int32)
        plain = tref.rle_group_accumulate_batched_ref(
            torch.from_numpy(v), torch.from_numpy(n), torch.from_numpy(keys))
        assert plain.tolist() == want.tolist()
        for way in tkernel.ROUTES:
            for aligned in (True, False):
                assert route_ref(v, n, keys, None, way,
                                 aligned).tolist() == want.tolist()


def test_routes_split_many_chunks_as_one():
    """A (9, 40) plane through each route, chunk by chunk, equals the
    plain version's planes: one warp (or block) a chunk, none reading its
    neighbour's runs."""
    rng = np.random.default_rng(3)
    v = rng.integers(0, 12, (9, 40)).astype(np.int32)
    n = rng.integers(0, 17, (9, 40)).astype(np.int32)
    keys = np.arange(2, 10, dtype=np.int32)
    want = tref.rle_group_accumulate_batched_ref(
        torch.from_numpy(v), torch.from_numpy(n),
        torch.from_numpy(keys)).numpy()
    for way in tkernel.ROUTES:
        np.testing.assert_array_equal(route_ref(v, n, keys, None, way), want)


@pytest.mark.parametrize("n_groups", SIZES)
@pytest.mark.parametrize("n_chunks", (1, 8, 132, 528, 1056, 1057, 4096,
                                      8192))
def test_route_at_the_threshold_edges(n_chunks, n_groups):
    """Threshold - 1 and the threshold take the warp route, threshold + 1
    the block; the threshold is 512 runs past one wave of the block route
    (1056 chunks), else 128 at G <= 8 and none at larger G."""
    limit = tkernel.warp_limit(n_chunks, n_groups)
    assert limit == (512 if n_chunks > 1056 else
                     128 if n_groups <= 8 else 0)
    runs = [r for r in (limit - 1, limit, limit + 1) if r >= 1]
    assert [tkernel.route(n_chunks, r, n_groups) for r in runs] == \
        ["warp", "warp", "block"][3 - len(runs):]


def test_route_codes_and_store_shapes():
    """The C entry's route codes (block 0, warp 1); the grouped store's
    [4096, 2] runs at G = 8 take the warp route, the largest legal plane
    [4096, 4096] at G = 128 the block route."""
    assert tkernel.ROUTES == ("block", "warp")
    assert tkernel.route(4096, 2, 8) == "warp"
    assert tkernel.route(4096, 4096, 128) == "block"


def test_unknown_route_and_cpu_tensors_raise():
    one = torch.ones(2, 4, dtype=torch.int32)
    keys = torch.arange(3, dtype=torch.int32)
    before = (tkernel.LAUNCHES, tkernel.RLE_LAUNCHES)
    with pytest.raises(ValueError, match="route 'lane'"):
        tkernel.rle_group_accumulate_batched_planes(one, one, keys,
                                                    way="lane")
    for way in (None, *tkernel.ROUTES):
        with pytest.raises(ValueError, match="CUDA tensor"):
            tkernel.rle_group_accumulate_batched_planes(one, one, keys,
                                                        way=way)
    with pytest.raises(ValueError, match="predicate primitive 'lt'"):
        tkernel.rle_group_accumulate_batched_planes(
            one, one, keys, pred=("lt", 1, False))
    with pytest.raises(ValueError, match="not an int32"):
        tkernel.rle_group_accumulate_batched_planes(
            one, one, keys, pred=("ge", 2**31, False))
    assert (tkernel.LAUNCHES, tkernel.RLE_LAUNCHES) == before
