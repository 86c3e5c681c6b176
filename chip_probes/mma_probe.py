"""Probe the two tensor-core forms of a Hamming product on one CUDA card.

    python3 chip_probes/mma_probe.py

For 256-bit descriptors a Hamming distance is a product on the tensor
cores in one of two forms:

  (a) ``mma.sync.m16n8k256 .b1 .and.popc`` on the packed words:
      c = popc(a & b), ham = popc(a) + popc(b) - 2 c;
  (b) ``mma.sync.m16n8k32 .s8.u8``, the query bits as +-1 bytes and the
      candidate bits as 0/1 bytes: dot = 2 c - popc(b), ham = popc(a) - dot.

The probe builds both with nvcc for sm_90a (``-Xptxas -v``), checks one
16 x 8 tile of each against popcounts computed with numpy (exact), times a
long chain of independent mma instructions of each form on every SM
(CUDA events), and counts the SASS instructions that each form compiles
to (``cuobjdump -sass``): a tensor-core form shows an ``IMMA``/``BMMA``
instruction, an emulated one a run of integer instructions. Prints one
JSON line. Needs nvcc and a card; no part of the port depends on it.
"""

from __future__ import annotations

import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma_b1(unsigned (&d)[4],
                                       const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8u8(unsigned (&d)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4 bits -> 4 bytes of 0/1 (bit j -> byte j)
__device__ __forceinline__ unsigned nib01(unsigned w, int shift) {
  return (((w >> shift) & 0xFu) * 0x00204081u) & 0x01010101u;
}
// 4 bits -> 4 bytes of -1/+1
__device__ __forceinline__ unsigned nibpm(unsigned w, int shift) {
  return ~(nib01(w, shift) * 0xFEu);
}

// one warp: a (16, 8) words, b (8, 8) words -> popc(a & b) (16, 8)
__global__ void tile_b1(const unsigned* a, const unsigned* b, int* out) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  unsigned fa[4] = {a[g * 8 + t], a[(g + 8) * 8 + t], a[g * 8 + 4 + t],
                    a[(g + 8) * 8 + 4 + t]};
  unsigned fb[2] = {b[g * 8 + t], b[g * 8 + 4 + t]};
  unsigned d[4] = {0, 0, 0, 0};
  mma_b1(d, fa, fb);
  out[g * 8 + 2 * t] = d[0];
  out[g * 8 + 2 * t + 1] = d[1];
  out[(g + 8) * 8 + 2 * t] = d[2];
  out[(g + 8) * 8 + 2 * t + 1] = d[3];
}

// one warp: the same tile as +-1 x 0/1 bytes, 8 k-steps of 32 bits
__global__ void tile_s8(const unsigned* a, const unsigned* b, int* out) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  unsigned d[4] = {0, 0, 0, 0};
  for (int k = 0; k < 8; ++k) {
    unsigned fa[4] = {nibpm(a[g * 8 + k], 4 * t),
                      nibpm(a[(g + 8) * 8 + k], 4 * t),
                      nibpm(a[g * 8 + k], 16 + 4 * t),
                      nibpm(a[(g + 8) * 8 + k], 16 + 4 * t)};
    unsigned fb[2] = {nib01(b[g * 8 + k], 4 * t),
                      nib01(b[g * 8 + k], 16 + 4 * t)};
    mma_s8u8(d, fa, fb);
  }
  out[g * 8 + 2 * t] = d[0];
  out[g * 8 + 2 * t + 1] = d[1];
  out[(g + 8) * 8 + 2 * t] = d[2];
  out[(g + 8) * 8 + 2 * t + 1] = d[3];
}

// throughput: every warp runs `iters` x 4 independent mma chains
template <int kForm>
__global__ void chain(int iters, unsigned seed, unsigned* sink) {
  unsigned fa[4], fb[2];
  for (int i = 0; i < 4; ++i) fa[i] = seed * (threadIdx.x + 3 * i + 1);
  fb[0] = seed ^ threadIdx.x;
  fb[1] = seed + threadIdx.x;
  unsigned d[4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (kForm == 0) mma_b1(d[c], fa, fb); else mma_s8u8(d[c], fa, fb);
    }
  }
  unsigned s = 0;
  for (int c = 0; c < 4; ++c)
    for (int i = 0; i < 4; ++i) s += d[c][i];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" {
int probe_tile(int form, const void* a, const void* b, void* out) {
  if (form == 0)
    tile_b1<<<1, 32>>>((const unsigned*)a, (const unsigned*)b, (int*)out);
  else
    tile_s8<<<1, 32>>>((const unsigned*)a, (const unsigned*)b, (int*)out);
  cudaError_t e = cudaDeviceSynchronize();
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
// milliseconds for `blocks` x `warps` warps of `iters` x 4 mma each
float probe_chain(int form, int blocks, int warps, int iters, void* sink) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {  // first pass warms up
    cudaEventRecord(e0);
    if (form == 0)
      chain<0><<<blocks, 32 * warps>>>(iters, 12345u, (unsigned*)sink);
    else
      chain<1><<<blocks, 32 * warps>>>(iters, 12345u, (unsigned*)sink);
    cudaEventRecord(e1);
  }
  cudaEventSynchronize(e1);
  float ms = -1.0f;
  if (cudaGetLastError() == cudaSuccess) cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return ms;
}
}
"""


def _sass_counts(lib: pathlib.Path, cuobjdump: str) -> dict:
    """Instruction mnemonics of each probe kernel, counted from the
    SASS."""
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                      line)
        if fn and m:
            op = m.group(1)
            counts[fn][op] = counts[fn].get(op, 0) + 1
    keep = ("IMMA", "BMMA", "HMMA", "POPC", "LOP3", "IADD3", "IMAD")
    return {fn: {k: v for k, v in c.items() if k.split(".")[0] in keep}
            for fn, c in counts.items() if "tile" in fn or "chain" in fn}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_probe: no CUDA device", file=sys.stderr)
        return 2
    cuda = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    # the port's git-ignored build directory
    out_dir = (pathlib.Path(__file__).resolve().parents[1]
               / "matchinglib_poselib_torch" / "_build")
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "mma_probe.cu"
    lib = out_dir / "libmma_probe.so"
    src.write_text(SRC)
    build = subprocess.run(
        [str(cuda / "bin" / "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
         "-v", "-o", str(lib), str(src)],
        capture_output=True, text=True, timeout=300)
    print(build.stdout + build.stderr, file=sys.stderr)
    result = {"nvcc_rc": build.returncode}
    if build.returncode:
        print(json.dumps(result))
        return 1
    so = ctypes.CDLL(str(lib))
    so.probe_tile.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    so.probe_chain.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    so.probe_chain.restype = ctypes.c_float

    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, (16, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (8, 8), dtype=np.uint64).astype(np.uint32)
    a[3] = 0xFFFFFFFF  # all-ones and all-zero rows at the extremes
    a[4] = 0
    b[2] = 0xFFFFFFFF

    def popc(x):  # signed, so that 2 c - pb may go negative
        return np.unpackbits(x.view(np.uint8), axis=-1).sum(
            -1, dtype=np.int64)

    c = popc(a[:, None, :] & b[None, :, :])  # (16, 8)
    pb = popc(b)
    ta = torch.from_numpy(a.view(np.int32)).cuda()
    tb = torch.from_numpy(b.view(np.int32)).cuda()
    for form, name, want in ((0, "b1_and_popc", c),
                             (1, "s8u8", 2 * c - pb[None, :])):
        out = torch.zeros((16, 8), dtype=torch.int32, device="cuda")
        rc = so.probe_tile(form, ta.data_ptr(), tb.data_ptr(), out.data_ptr())
        got = out.cpu().numpy()
        result[name] = {"rc": rc, "exact": bool(rc == 0
                                                and np.array_equal(got, want)),
                        "n_wrong": int((got != want).sum())}

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.empty(sms * 4 * 8 * 32, dtype=torch.int32, device="cuda")
    iters = 4096
    for form, name, ops in ((0, "b1_and_popc", 16 * 8 * 256 * 2),
                            (1, "s8u8", 16 * 8 * 32 * 2)):
        for warps in (4, 8):
            blocks = sms * 4
            ms = so.probe_chain(form, blocks, warps, iters, sink.data_ptr())
            n_mma = blocks * warps * iters * 4
            result[name][f"chain_{warps}w"] = {
                "ms": ms, "mma_per_clk_per_sm_at_1.98GHz":
                n_mma / (ms * 1e-3) / sms / 1.98e9,
                "tops": n_mma * ops / (ms * 1e-3) / 1e12}
    result["sass"] = _sass_counts(lib, str(cuda / "bin" / "cuobjdump"))
    result["device"] = torch.cuda.get_device_name(0)
    result["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(result))
    ok = result["b1_and_popc"]["exact"] or result["s8u8"]["exact"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
