"""Kernel 11's tensor-core tile at head dim 256 against its alternatives,
on one CUDA card (src/repro_torch/csrc/flash_attention.cu).

    python3 tools/flash_tiles.py [--parent DIR] [--out FILE]

1. Builds the checkout's kernel and, from edited copies of its source
   under build/flash_tiles/, two variants of its D 256 tile: "bn80", key
   tiles of 80 (FlashAttention-3's choice at this head dim; two stages
   still fit, 230,400 bytes with the alignment slack) in place of 64;
   "pv256", P V as one m64n256k16 wgmma a k-step in place of two
   m64n128k16; and "bn80_pv256", both. Prints ptxas's registers and
   spills of each flash_wgmma_kernel<256>. With --parent, also the
   kernel of an earlier checkout at DIR (a C entry with or without the
   route argument; without it, bf16 at D 256 ran on the CUDA cores).
2. Checks each against the plain version (chip_smoke.ATTN_TOL) in bf16
   at D 256: ragged tiles, Sq < Skv, windows ending inside a tile, G 3
   and 10, recurrentgemma-2b's prefill; with --parent, at D 128 too.
3. Times each back to back (chip_smoke.time_ms, KERNEL_REPS launches a
   sample) at recurrentgemma-2b's prefill, (1, 1, 10, 4096, 256) at
   window 2048, and the checkout and the parent at the serve path's
   (1, 8, 2, 4096, 128), causal: four rounds, the order reversed every
   other round.

Prints the card's name and power limit first; with --out, writes the
results as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402

OUT_DIR = ROOT / "build" / "flash_tiles"
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
BN_LINE = "  static constexpr int BN = D <= 128 ? 128 : 64;"
PV_LINE = "  static constexpr int PV_N = D < 128 ? D : 128;"
EDITS = {"bn80": {BN_LINE: BN_LINE.replace(": 64", ": 80")},
         "pv256": {PV_LINE: "  static constexpr int PV_N = D;"}}
EDITS["bn80_pv256"] = {**EDITS["bn80"], **EDITS["pv256"]}
D256_CASES = ((1, 2, 2, 1000, 1000, 0), (1, 2, 2, 130, 4100, 0),
              (1, 2, 2, 1000, 1000, 65), (1, 2, 2, 1000, 1000, 100),
              (2, 1, 3, 333, 777, 0), (1, 1, 10, 1037, 3001, 2048),
              (1, 1, 10, 4096, 4096, 2048))


def wgmma_asm(n: int, a_regs: bool) -> str:
    """The Wgmma<n>::ss (a_regs False) or ::rs specialisation, written as
    hopper.cuh writes its others."""
    regs = ", ".join(f"%{i}" for i in range(n // 2))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(n // 2))
    k = n // 2
    if a_regs:
        return (f"template <>\n__device__ __forceinline__ void Wgmma<{n}>::"
                f"rs(float* d, const uint32_t* a, uint64_t b) {{\n"
                f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, '
                f'%{k + 5}, 0;\\n"\n'
                f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.'
                f'bf16 {{{regs}}}, {{%{k}, %{k + 1}, %{k + 2}, %{k + 3}}}, '
                f'%{k + 4}, p, 1, 1, 1;\\n}}\\n"\n'
                f'      : {outs}\n      : "r"(a[0]), "r"(a[1]), "r"(a[2]), '
                f'"r"(a[3]), "l"(b), "r"(1));\n}}\n')
    return (f"template <>\n__device__ __forceinline__ void Wgmma<{n}>::"
            f"ss(float* d, uint64_t a, uint64_t b, int scale_d) {{\n"
            f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{k + 2}, '
            f'0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 '
            f'{{{regs}}}, %{k}, %{k + 1}, p, 1, 1, 0, 0;\\n}}\\n"\n'
            f'      : {outs}\n      : "l"(a), "l"(b), "r"(scale_d));\n}}\n')


def write_variant(name: str) -> Path:
    """build/flash_tiles/<name>/: the checkout's csrc with the edits, and
    the two wgmma shapes the variants need added to hopper.cuh."""
    d = OUT_DIR / name
    d.mkdir(parents=True, exist_ok=True)
    for f in _build.HEADERS:
        (d / f).write_text((_build.CSRC / f).read_text())
    hop = (d / "hopper.cuh").read_text()
    marker = "// cuTensorMapEncodeTiled"
    (d / "hopper.cuh").write_text(hop.replace(
        marker, wgmma_asm(80, False) + wgmma_asm(256, True) + marker))
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for old, new in EDITS[name].items():
        if old not in src:
            raise SystemExit(f"flash_attention.cu has no line {old!r}")
        src = src.replace(old, new)
    (d / "flash_attention.cu").write_text(src)
    return d


def build_all(parent: Path | None) -> dict:
    """{name: (library, takes a route argument)}; prints ptxas's report
    of each flash_wgmma_kernel<256>."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    dirs = {"this": _build.CSRC}
    dirs.update({name: write_variant(name) for name in EDITS})
    if parent is not None:
        dirs["parent"] = parent / "src" / "repro_torch" / "csrc"
    procs = {}
    for name, d in dirs.items():
        so = OUT_DIR / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-I", str(d),
             "-o", str(so), str(d / "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so,
            "int route" in (d / "flash_attention.cu").read_text())
    libs = {}
    for name, (proc, so, routed) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        # the report's lines after the D 256 wgmma kernel's entry line
        m = re.search(r"flash_wgmma_kernelILi256E.*?\n(.*?)\n(.*?)\n"
                      r"(.*?)\n", log, re.S)
        report = " / ".join(x.strip() for x in m.groups()[1:]) if m else ""
        print(f"{name}: flash_wgmma_kernel<256> {report}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.flash_attention_launch.argtypes = (
            [P, P, P, P, I, I, I, I, LL, LL, I, I] + ([I] if routed else [])
            + [P])
        lib.flash_attention_launch.restype = I
        libs[name] = (lib, routed)
    return libs


def run(entry, q, k, v, window: int) -> torch.Tensor:
    lib, routed = entry
    out = torch.empty_like(q)
    b, kvh, g, sq, d = q.shape
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.FLOAT_DTYPES[q.dtype], b, kvh, g, sq, k.shape[2], d, window,
        *((1,) if routed else ()), torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"launch failed: CUDA error {err}")
    return out


def inputs(gen, b, kvh, g, sq, skv, d):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    return randn(b, kvh, g, sq, d), randn(b, kvh, skv, d), \
        randn(b, kvh, skv, d)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    dev = cs.device_phase()
    t0 = time.perf_counter()
    libs = build_all(args.parent)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 40)
    worst = dict.fromkeys(libs, 0.0)
    cases = list(D256_CASES) + ([(1, 2, 2, 1000, 1000, 0, 128),
                                 (1, 8, 2, 4096, 4096, 0, 128)]
                                if args.parent else [])
    for case in cases:
        b, kvh, g, sq, skv, w, d = (*case, 256)[:7]
        q, k, v = inputs(gen, b, kvh, g, sq, skv, d)
        want = fref.attention_ref(q, k, v, window=w)
        for name, entry in libs.items():
            if d == 128 and name not in ("this", "parent"):
                continue
            got = run(entry, q, k, v, w)
            worst[name] = max(worst[name],
                              cs.float_err(got, want, torch.bfloat16)[1])
    torch.cuda.synchronize()
    print(f"largest err / limit (ATTN_TOL bf16): {json.dumps(worst)}",
          flush=True)
    if not all(r <= 1.0 for r in worst.values()):
        raise SystemExit("a kernel is out of tolerance")
    times = {}
    for label, (kvh, g, sq, d, w), names in (
            ("recurrentgemma (1, 1, 10, 4096, 256), window 2048",
             (1, 10, 4096, 256, 2048), list(libs)),
            ("serve (1, 8, 2, 4096, 128), causal", (8, 2, 4096, 128, 0),
             [n for n in libs if n in ("this", "parent")])):
        q, k, v = inputs(gen, 1, kvh, g, sq, sq, d)
        res = {n: [] for n in names}
        for r in range(4):
            for n in names if r % 2 == 0 else names[::-1]:
                res[n].append(cs.time_ms(lambda: run(libs[n], q, k, v, w),
                                         cs.KERNEL_REPS))
        times[label] = {n: {"median_ms": statistics.median(t), "ms": t}
                        for n, t in res.items()}
        print(f"{label}, ms a launch back to back (median of four rounds): "
              + ", ".join(f"{n} {statistics.median(t):.4f}"
                          for n, t in res.items()) + f" [{dev['smi']}]",
              flush=True)
    if args.out:
        args.out.write_text(json.dumps({"device": dev, "worst": worst,
                                        "times": times}, indent=1))


if __name__ == "__main__":
    main()
