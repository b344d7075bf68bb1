#!/usr/bin/env python3
"""Where a layer's cycles go in the band B1/B2: clock64() phase counters.

Copies a checkout's band kernel sources (``csrc/euler_common.cuh``,
``fused_euler_fwd.cu``, ``fused_euler_bwd.cu``) into a scratch directory,
adds clock64() counters around each phase of a layer (text patches
anchored in the sources of this design, whose bands trade edge rows
through device memory), builds them beside the real ones and runs both at
the main shapes:

    python3 tools/band_phases.py [--tree DIR] [--out FILE]

For each kernel and shape it prints the uninstrumented and the
instrumented time (CUDA events), and each phase's cycles per layer and
warp: the counters' sums over every warp (lane 0's clock), divided by the
warps and the layers.  B2's reverse sweep runs in two roles of warps, so
its phases are each role's, over that role's warps: ``conv_*`` (K^T wait,
halo wait, the K^T conv, the halves' combine, the wait for the dK warps to
free a g_z buffer, the epilogue, the layer's end barrier) and ``dk_*``
(the wait for g_z, the wait for y_l, dK, the dK warps' barrier).  A warp's cycles in a phase include the cycles its
scheduler spent on other warps, so the phases add up to the layer's wall
time, not to issue slots.  ``eff_clock_GHz`` (a warp's cycles over the
kernel's time) falls below the SM clock where warps live shorter than the
kernel: blocks waiting for a second wave, or SMs with fewer blocks.
``blocks a SM`` is the histogram of the SM ids the blocks ran on
(``%smid``).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

READ = '''
int deqres_prof_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, deqres_prof, sizeof(deqres_prof)));
}
int deqres_prof_reset() {
  static unsigned long long zero[64] = {};
  return static_cast<int>(cudaMemcpyToSymbol(deqres_prof, zero, sizeof(zero)));
}
int deqres_smid_read(unsigned* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, deqres_smid, sizeof(deqres_smid)));
}
'''

PROF_DECL = (
    "__device__ unsigned long long deqres_prof[64];\n__device__ unsigned deqres_smid[8192];\n"
    "__device__ __forceinline__ void record_smid() { if (threadIdx.x == 0) { unsigned s; "
    "asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s)); deqres_smid[blockIdx.x] = s + 1; } }\n")

# Phase names of each counter slot: B1, B2's forward recompute (slots 0-11),
# its reverse sweep's conv warps (16-27) and dK warps (32-43); slots 60 and
# 61 count the conv and dK warps, 63 every warp; B1's and B2's totals.
PHASES = {
    "fwd": ["conv", "combine", "epilogue", "kwait", "halo_wait", "publish", "loop", "total"],
    "bwd_fwd": ["conv", "combine", "epilogue", "kwait", "halo_wait", "publish", "fwd_total"],
    "bwd_conv": {0: "kt_wait", 1: "halo_wait", 2: "KT_conv", 3: "combine", 4: "free_wait",
                 5: "epilogue", 6: "end_barrier", 10: "rev_total", 11: "total"},
    "bwd_dk": {0: "ready_wait", 1: "y_wait", 2: "dK", 3: "dk_barrier", 10: "rev_total",
               11: "total"},
}
FWD_TOTAL, BWD_TOTAL = 7, 27
CONV_SLOTS, DK_SLOTS, CONV_WARPS, DK_WARPS = 16, 32, 60, 61

BWD_FLUSH = (
    "  if ((threadIdx.x & 31) == 0) {\n"
    "    const int base = static_cast<int>(threadIdx.x) < roles.conv ? 16 : 32;\n"
    "    for (int i = 0; i < 12; ++i) {\n"
    "      atomicAdd(&deqres_prof[i], (unsigned long long)pt[i]);\n"
    "      atomicAdd(&deqres_prof[base + i], (unsigned long long)rt[i]);\n"
    "    }\n"
    "    atomicAdd(&deqres_prof[63], 1ull);\n"
    "    atomicAdd(&deqres_prof[base == 16 ? 60 : 61], 1ull);\n"
    "  }\n")


def patch(src: Path, out: Path, name: str, pairs) -> None:
    s = (src / name).read_text()
    for a, b in pairs:
        if s.count(a) != 1:
            raise RuntimeError(f"{name}: the anchor {a[:60]!r} is not found once")
        s = s.replace(a, b)
    (out / name).write_text(s)


def patch_sources(src: Path, out: Path) -> None:
    """The counters, into the copies in ``out`` of the sources in ``src``."""
    patch(src, out, "euler_common.cuh", [
        ("constexpr int kMaxSmemBytes", PROF_DECL + "constexpr int kMaxSmemBytes"),
        ("                                            unsigned short* __restrict__ mask) {\n  const int Cp = CP ? CP : b.Cp;\n  const float* bs",
         "                                            unsigned short* __restrict__ mask, long long (&pt)[12]) {\n  const int Cp = CP ? CP : b.Cp;\n  const float* bs"),
        ("    if (active) conv_half<BF16, CP, S>(cur, b, t, Ks, acc);\n    float z[4][4];\n    combine_halves<S>(acc, t.s, z);",
         "    long long t0 = clock64();\n    if (active) conv_half<BF16, CP, S>(cur, b, t, Ks, acc);\n    long long t1 = clock64(); pt[0] += t1 - t0;\n    float z[4][4];\n    combine_halves<S>(acc, t.s, z);\n    long long t2 = clock64(); pt[1] += t2 - t1;"),
        ("    if constexpr (RECORD) mask[it] = static_cast<unsigned short>(bits);\n  }\n}",
         "    if constexpr (RECORD) mask[it] = static_cast<unsigned short>(bits);\n    pt[2] += clock64() - t2;\n  }\n}\n"
         "__device__ __forceinline__ void prof_flush(long long (&pt)[12], int base) {\n"
         "  if ((threadIdx.x & 31) == 0) {\n    for (int i = 0; i < 12; ++i) atomicAdd(&deqres_prof[base + i], (unsigned long long)pt[i]);\n"
         "    atomicAdd(&deqres_prof[63], 1ull);\n  }\n}"),
    ])
    patch(src, out, "fused_euler_fwd.cu", [
        ("  const int image = blockIdx.x / b.n, rank = blockIdx.x % b.n;", "  long long pt[12] = {};\n  const long long tstart = clock64();\n  record_smid();\n  const int image = blockIdx.x / b.n, rank = blockIdx.x % b.n;"),
        ("  for (int l = 0; l < b.L; ++l) {", "  const long long tloop = clock64();\n  for (int l = 0; l < b.L; ++l) {"),
        ("    mbar_wait(bars + slot, phases, slot);", "    long long w0 = clock64();\n    mbar_wait(bars + slot, phases, slot);\n    pt[3] += clock64() - w0;"),
        ("    if (l > 0 && b.n > 1) take_halos(e, b, image, rank, rows, l - 1, cur);\n    layer_items<BF16, CP, S, false>(b, rows, cur, nxt, first, last, Ks, h, nullptr);",
         "    long long h0 = clock64();\n    if (l > 0 && b.n > 1) take_halos(e, b, image, rank, rows, l - 1, cur);\n    pt[4] += clock64() - h0;\n    layer_items<BF16, CP, S, false>(b, rows, cur, nxt, first, last, Ks, h, nullptr, pt);\n    long long p0 = clock64();"),
        ("      __syncthreads();\n    }\n  }\n  store_band", "      __syncthreads();\n    }\n    pt[5] += clock64() - p0;\n  }\n  pt[6] += clock64() - tloop;\n  store_band"),
        ("  store_band(state + (b.L & 1) * band, b, start, rows, out + img);\n}",
         "  store_band(state + (b.L & 1) * band, b, start, rows, out + img);\n  pt[7] += clock64() - tstart;\n  prof_flush(pt, 0);\n}"),
        ('extern "C" {', 'extern "C" {\n' + READ),
    ])
    patch(src, out, "fused_euler_bwd.cu", [
        ("  const int image = blockIdx.x / b.n, rank = blockIdx.x % b.n;", "  long long pt[12] = {}, rt[12] = {};\n  const long long tstart = clock64();\n  record_smid();\n  const int image = blockIdx.x / b.n, rank = blockIdx.x % b.n;"),
        ("      mbar_wait(bars + kKBar + slot, phases, kKBar + slot);", "      long long w0 = clock64();\n      mbar_wait(bars + kKBar + slot, phases, kKBar + slot);\n      pt[3] += clock64() - w0;"),
        ("      if (l > 0 && b.n > 1) take_halos(e, b, image, rank, rows, l - 1, cur);\n      layer_items<BF16, CP, S, true>(b, rows, cur, nxt, first, last, Ks, h, mask_words(l));",
         "      long long h0 = clock64();\n      if (l > 0 && b.n > 1) take_halos(e, b, image, rank, rows, l - 1, cur);\n      pt[4] += clock64() - h0;\n      layer_items<BF16, CP, S, true>(b, rows, cur, nxt, first, last, Ks, h, mask_words(l), pt);\n      long long p0 = clock64();"),
        ("        __syncthreads();\n      }\n    }\n    if (issuer) {\n      bulk_wait_all();",
         "        __syncthreads();\n      }\n      pt[5] += clock64() - p0;\n    }\n    pt[6] += clock64() - tstart;\n    if (issuer) {\n      bulk_wait_all();"),
        ("  if (static_cast<int>(threadIdx.x) < roles.conv) {\n    // Conv warps:",
         "  const long long trev = clock64();\n  if (static_cast<int>(threadIdx.x) < roles.conv) {\n    // Conv warps:"),
        ("      mbar_wait(bars + kTBar + ks, phases, kTBar + ks);",
         "      long long k0 = clock64();\n      mbar_wait(bars + kTBar + ks, phases, kTBar + ks);\n      rt[0] += clock64() - k0;"),
        ("      if (b.n > 1) {\n        copy_halos(e, b, image, rank, rows, step - 1, Gz);\n        bar_sync(kConvBar, roles.conv);\n      }",
         "      long long q0 = clock64();\n      if (b.n > 1) {\n        copy_halos(e, b, image, rank, rows, step - 1, Gz);\n        bar_sync(kConvBar, roles.conv);\n      }\n      rt[1] += clock64() - q0;"),
        ("        if (active) conv_half<BF16, CP, S>(Gz, b, t, Kt, acc);\n        float d[4][4];\n        combine_halves<S>(acc, t.s, d);",
         "        long long c0 = clock64();\n        if (active) conv_half<BF16, CP, S>(Gz, b, t, Kt, acc);\n        long long c1 = clock64(); rt[2] += c1 - c0;\n        float d[4][4];\n        combine_halves<S>(acc, t.s, d);\n        long long c2 = clock64(); rt[3] += c2 - c1;"),
        ("        if (base == 0 && l > 0 && l + 1 < L) bar_sync(kFreeBar + ((l + 1) & 1), both);",
         "        if (base == 0 && l > 0 && l + 1 < L) bar_sync(kFreeBar + ((l + 1) & 1), both);\n        long long e0 = clock64(); rt[4] += e0 - c2;"),
        ("          if (l > 0) store_gz(b, rows, t, q, kk, g, bits, h, Gn, first, last);\n        }\n      }\n",
         "          if (l > 0) store_gz(b, rows, t, q, kk, g, bits, h, Gn, first, last);\n        }\n        rt[5] += clock64() - e0;\n      }\n"),
        ("      if (l > 0) bar_arrive(kReadyBar + ((l - 1) & 1), both);",
         "      long long z0 = clock64();\n      if (l > 0) bar_arrive(kReadyBar + ((l - 1) & 1), both);"),
        ("store_release(e.steps + blockIdx.x, step + 1u);\n    }\n  } else {",
         "store_release(e.steps + blockIdx.x, step + 1u);\n      rt[6] += clock64() - z0;\n    }\n    rt[10] += clock64() - trev;\n  } else {"),
        ("      if (l < L - 1) bar_sync(kReadyBar + (l & 1), both);",
         "      long long d0 = clock64();\n      if (l < L - 1) bar_sync(kReadyBar + (l & 1), both);\n      long long d1 = clock64(); rt[0] += d1 - d0;"),
        ("      mbar_wait(bars + kYBar + ys, phases, kYBar + ys);",
         "      mbar_wait(bars + kYBar + ys, phases, kYBar + ys);\n      long long d2 = clock64(); rt[1] += d2 - d1;"),
        ("                       gk + (static_cast<size_t>(blockIdx.x) * L + l) * layer, tid, roles.dk);",
         "                       gk + (static_cast<size_t>(blockIdx.x) * L + l) * layer, tid, roles.dk);\n      long long d3 = clock64(); rt[2] += d3 - d2;"),
        ("      bar_sync(kDkBar, roles.dk);  // every read of y_l is done",
         "      bar_sync(kDkBar, roles.dk);  // every read of y_l is done\n      rt[3] += clock64() - d3;"),
        ("      if (loader && lay.ny == 1 && l > 0) issue_y(l - 1);\n    }\n  }\n  __syncthreads();",
         "      if (loader && lay.ny == 1 && l > 0) issue_y(l - 1);\n    }\n    rt[10] += clock64() - trev;\n  }\n  __syncthreads();"),
        ("    gx[img + (static_cast<size_t>(start) * W + p) * b.C + c] = gs[p * Cp + c];\n  }\n}",
         "    gx[img + (static_cast<size_t>(start) * W + p) * b.C + c] = gs[p * Cp + c];\n  }\n  rt[11] += clock64() - tstart;\n" + BWD_FLUSH + "}"),
        ('extern "C" {', 'extern "C" {\n' + READ),
    ])

SHAPES = ((32, 32, 32, 16, 64, False), (1, 32, 32, 16, 64, False), (32, 32, 32, 8, 64, True),
          (32, 28, 28, 16, 8, False))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", type=Path, default=ROOT,
                        help="checkout whose kernels to instrument (default this one)")
    parser.add_argument("--out", type=Path, default=None, help="JSON file for the results")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("band_phases: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.tree.resolve()))
    import chip_smoke as cs
    from differential_equations_resnet_tpu_torch.ops.kernels import _build
    from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi

    scratch = Path(tempfile.mkdtemp(prefix="band_phases_"))
    csrc = args.tree.resolve() / "differential_equations_resnet_tpu_torch" / "csrc"
    for name in ("euler_common.cuh", "fused_euler_fwd.cu", "fused_euler_bwd.cu"):
        shutil.copy(csrc / name, scratch / name)
    patch_sources(csrc, scratch)
    for name in ("fwd", "bwd"):
        _build.SOURCES[f"prof_{name}"] = _build.Source(scratch / f"fused_euler_{name}.cu", "nvcc",
                                                        _build.NVCC_FLAGS, "kernels", ("*.cuh",))
        signatures = dict(fi._SIGNATURES[f"fused_euler_{name}"])
        signatures.update(deqres_prof_read=([ctypes.c_void_p], ctypes.c_int),
                          deqres_prof_reset=([], ctypes.c_int),
                          deqres_smid_read=([ctypes.c_void_p], ctypes.c_int))
        fi._SIGNATURES[f"prof_{name}"] = signatures
    _build.build(["prof_fwd", "prof_bwd", "fused_euler_fwd", "fused_euler_bwd"])
    library, alias = fi._library, {}
    fi._library = lambda name: library(alias.get(name, name))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    phases, fwd_total, bwd_total = PHASES, FWD_TOTAL, BWD_TOTAL
    results = {"device": smi}
    for batch, height, width, channels, layers, unstructured in SHAPES:
        x, k, bias, g = cs.make_case(batch, height, width, channels, layers, 7,
                                     unstructured=unstructured)
        h = 1.0 / layers
        for name, backward in (("fwd", False), ("bwd", True)):
            run = ((lambda: fi.fused_euler_dense_bwd(x, k, bias, g, h)) if backward
                   else (lambda: fi.fused_euler_dense(x, k, bias, h)))
            alias.clear()
            plain_ms = cs.cuda_time_ms(run)
            alias[f"fused_euler_{name}"] = f"prof_{name}"
            lib = fi._library(f"fused_euler_{name}")
            inst_ms = cs.cuda_time_ms(run)
            assert lib.deqres_prof_reset() == 0
            run()
            torch.cuda.synchronize()
            counters = (ctypes.c_ulonglong * 64)()
            assert lib.deqres_prof_read(ctypes.cast(counters, ctypes.c_void_p)) == 0
            sm = (ctypes.c_uint * 8192)()
            assert lib.deqres_smid_read(ctypes.cast(sm, ctypes.c_void_p)) == 0
            v = list(counters)
            warps = v[63]
            if backward:
                cycles = {n: v[i] / warps / layers for i, n in enumerate(phases["bwd_fwd"])}
                for role, slots, count in (("conv", CONV_SLOTS, v[CONV_WARPS]),
                                           ("dk", DK_SLOTS, v[DK_WARPS])):
                    cycles.update({f"{role}_{n}": v[slots + i] / count / layers
                                   for i, n in phases[f"bwd_{role}"].items()})
                    cycles[f"{role}_warps"] = count
                total = v[bwd_total] / v[CONV_WARPS]
            else:
                cycles = {n: v[i] / warps / layers for i, n in enumerate(phases["fwd"])}
                total = v[fwd_total] / warps
            blocks = fi.launch_plan(x.shape, backward)["blocks"]
            per_sm = collections.Counter(s - 1 for s in list(sm)[:blocks])
            key = (f"{name} B={batch} {height}x{width}x{channels} L={layers}"
                   f"{' regular' if unstructured else ''}")
            results[key] = {
                "kernel_ms": plain_ms, "instrumented_ms": inst_ms, "warps": warps,
                "eff_clock_GHz": total / (inst_ms * 1e6),
                "blocks a SM": dict(sorted(collections.Counter(per_sm.values()).items())),
                "cycles_per_layer_per_warp": {n: round(c, 1) for n, c in cycles.items()}}
            print(json.dumps({key: results[key], "device": smi}), flush=True)
    shutil.rmtree(scratch, ignore_errors=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
