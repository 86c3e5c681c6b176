// Fused binary 2-NN search with an optional radius gate, on the tensor
// cores.
//
// Replaces the packed binary body of the Pallas TPU kernel
// matchinglib_poselib_tpu/ops/pallas/knn.py (knn2, kernel body
// _knn2_kernel_packed, :131; pallas_call at :285). For every query row:
// the Hamming distance to every candidate, the candidate validity penalty
// and, for xy_mode 1 (radius per query) or 2 (radius per candidate), the
// gate |pred_i - pts2_j|^2 <= r^2; then the best distance, its column
// (lowest column on ties) and the second-best distance. Output: d_best,
// d_second as float (1e9 when no candidate is valid and inside the gate)
// and idx (-1 then), bit-identical to the plain version in
// ops/kernels/knn2.py.
//
// The product. The TPU body multiplies +-1 signs on the MXU. Here each
// 16 x 8 tile of pairs is one mma.sync.m16n8k256 .b1 .and.popc on the
// packed words as they are: c = popc(a & b) exactly, in s32, and ham =
// pa + pb - 2 c with pa, pb the row and column popcounts. On sm_90a this
// is one BMMA instruction (a hardware tensor-core op, not an emulation;
// chip_probes/mma_probe.py shows it in the SASS and checks it exact). At
// 2048 x 2048 the whole product is 32 K such instructions, well under a
// microsecond on 132 SMs, so neither wgmma nor TMA would buy anything
// here: wgmma has no .b1 form, and the inputs (2 x 64 KB) live in L2.
//
// What bounds it, then: the epilogue, one key per pair in 32-bit integer
// ops (64 per clock per SM), and at the main path's size the fixed
// latency of one short launch (the first loads, the cluster's barrier and
// merge; PERF.md has the measured split). Design:
// - Keys. key = (field << 21) | column with field = pb - 2 c + 256, the
//   Hamming distance less the row's constant pa - 256 (a constant per row
//   moves no min), so one IMAD per pair builds the key from a per-column
//   constant ((pb + 256) << 21 | column). A fault (invalid column or
//   outside the gate) sets bit 31; valid fields are <= 512 < 1024, so a
//   faulted key sorts after every valid one and a second fault changes
//   nothing. Lowest-column ties fall out of the native 32-bit min; the
//   top-2 update is m2 = min(m2, max(m1, k)); m1 = min(m1, k). Columns
//   past the end stage as zero words with the key 0xffffffff (n2 <=
//   2^21, checked by the wrapper).
// - Filling the card. A block owns 64 query rows (4 warps x 16, the A
//   fragments in registers for the whole sweep) and one of 8 slices of
//   the columns; the 8 slices of one row block form a thread-block
//   cluster (8 is the portable cluster size; 32 x 8 = 256 blocks at the
//   main path's 2048 rows), and after the sweep the cluster merges its
//   slices' top-2 pairs through distributed shared memory. One launch per call, no scratch in device memory.
//   Each lane keeps four independent (min, second min) chains, one per
//   row and column parity of its accumulator fragment.
// - Overlapping loads. Candidates are staged 256 columns at a time by
//   cp.async into a 2-stage ring (at the main path's shape a slice is
//   one tile); the next tile's copies and the loads of its per-column
//   constants (validity, x, y, r^2) are in flight while the current tile
//   is multiplied, and the thread that copied a column computes its
//   popcount and key constant once per block. One barrier per tile.
//   Staged columns are padded to 12 words, so the fragment loads of a
//   warp hit 32 distinct banks. Each warp issues 8 products before their
//   epilogues, so the tensor-core latency overlaps.
// - The gate uses round-to-nearest multiplies and adds with no FMA
//   contraction, so it decides exactly as the plain version's separate
//   ops do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWords = 8;       // 256-bit descriptors
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows per block
constexpr int kTile = 256;      // candidate columns per stage
constexpr int kColsPerThread = kTile / kThreads;  // columns each thread stages
constexpr int kGroup = 8;       // 16 x 8 products in flight per warp
constexpr int kStride = 12;     // words per staged column (8 + 4 of padding)
constexpr int kColBits = 21;
constexpr unsigned kColMask = (1u << kColBits) - 1u;
constexpr unsigned kFault = 1u << 31;
constexpr unsigned kNone = ~0u;
constexpr int kSplits = 8;      // column slices = blocks per cluster (portable)

// d += popc(A & B) for one 16 x 8 tile: A (16 x 256 bits, row) in a[4],
// B (256 bits x 8, col) in b0, b1
__device__ __forceinline__ void mma_and_popc(unsigned (&d)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; bytes past `src_bytes` are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void push(unsigned k, unsigned& m1, unsigned& m2) {
  m2 = min(m2, max(m1, k));
  m1 = min(m1, k);
}

// merge the sorted pair (o1, o2) into the sorted pair (m1, m2)
__device__ __forceinline__ void merge(unsigned o1, unsigned o2, unsigned& m1,
                                      unsigned& m2) {
  m2 = min(max(m1, o1), min(m2, o2));
  m1 = min(m1, o1);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
knn2_kernel(const unsigned* __restrict__ desc1,
            const unsigned* __restrict__ desc2,
            const unsigned char* __restrict__ valid2,
            const float* __restrict__ pred, const float* __restrict__ rad2,
            const float* __restrict__ pts2, int n1, int n2,
            int cols_per_split, float* __restrict__ d_best,
            float* __restrict__ d_second, int* __restrict__ idx) {
  __shared__ __align__(16) unsigned s_desc[2][kTile][kStride];
  __shared__ __align__(8) unsigned s_key[2][kTile];
  __shared__ __align__(8) float s_x[2][kMode ? kTile : 2];
  __shared__ __align__(8) float s_y[2][kMode ? kTile : 2];
  __shared__ __align__(8) float s_r2[2][kMode == 2 ? kTile : 2];
  __shared__ unsigned s_m1[kRows], s_m2[kRows];
  __shared__ int s_pa[kRows];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, k group
  const int row0 = blockIdx.x * kRows;
  const int cbeg = blockIdx.y * cols_per_split;
  const int cend = min(n2, cbeg + cols_per_split);
  const int n_tiles = cend > cbeg ? (cend - cbeg + kTile - 1) / kTile : 0;

  // this lane's A fragment: rows g and g + 8 of the warp's 16, words t and
  // 4 + t (the m16n8k256 .b1 layout); rows past n1 repeat the last row
  unsigned a[4];
  float qx[2] = {0.0f, 0.0f}, qy[2] = {0.0f, 0.0f}, qr2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = min(row0 + warp * 16 + g + 8 * h, n1 - 1);
    a[h] = desc1[(size_t)row * kWords + t];
    a[2 + h] = desc1[(size_t)row * kWords + 4 + t];
    if constexpr (kMode != 0) {
      qx[h] = pred[2 * row];
      qy[h] = pred[2 * row + 1];
      if (kMode == 1) qr2[h] = rad2[row];
    }
  }
  // running top-2 keys of (row g + 8 h, column parity j) at [2 h + j]:
  // four independent chains
  unsigned m1[4] = {kNone, kNone, kNone, kNone};
  unsigned m2[4] = {kNone, kNone, kNone, kNone};

  // Thread tid stages columns tid + u * kThreads of a tile: fetch issues
  // their 16-byte copies and loads their validity and gate values into
  // registers; publish, once the copies have landed, writes each column's
  // key constant and gate values to shared memory.
  bool c_valid[kColsPerThread];
  float c_x[kColsPerThread], c_y[kColsPerThread], c_r2[kColsPerThread];
  auto fetch = [&](int tile, int s) {
#pragma unroll
    for (int u = 0; u < kColsPerThread; ++u) {
      const int c = tid + u * kThreads;
      const int col = cbeg + tile * kTile + c;
      const bool in = col < cend;
      const unsigned* src = desc2 + (size_t)(in ? col : 0) * kWords;
      cp_async16(&s_desc[s][c][0], src, in ? 16 : 0);
      cp_async16(&s_desc[s][c][4], src + 4, in ? 16 : 0);
      c_valid[u] = in && valid2[col];
      if constexpr (kMode != 0) {
        c_x[u] = in ? pts2[2 * col] : 0.0f;
        c_y[u] = in ? pts2[2 * col + 1] : 0.0f;
        if constexpr (kMode == 2) c_r2[u] = in ? rad2[col] : 0.0f;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto publish = [&](int tile, int s) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < kColsPerThread; ++u) {
      const int c = tid + u * kThreads;
      const int col = cbeg + tile * kTile + c;
      unsigned key = kNone;
      if (col < cend) {
        const uint4 lo = *reinterpret_cast<const uint4*>(&s_desc[s][c][0]);
        const uint4 hi = *reinterpret_cast<const uint4*>(&s_desc[s][c][4]);
        const unsigned pb = __popc(lo.x) + __popc(lo.y) + __popc(lo.z) +
                            __popc(lo.w) + __popc(hi.x) + __popc(hi.y) +
                            __popc(hi.z) + __popc(hi.w);
        key = (c_valid[u] ? 0u : kFault) | ((pb + 256u) << kColBits) |
              (unsigned)col;
      }
      s_key[s][c] = key;
      if constexpr (kMode != 0) {
        s_x[s][c] = c_x[u];
        s_y[s][c] = c_y[u];
        if constexpr (kMode == 2) s_r2[s][c] = c_r2[u];
      }
    }
  };

  if (n_tiles > 0) {
    fetch(0, 0);
    publish(0, 0);
  }
  __syncthreads();
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1;
    if (i + 1 < n_tiles) fetch(i + 1, s ^ 1);
    // n-blocks of 8 columns that hold a column of this slice
    const int n_nb = (min(kTile, cend - cbeg - i * kTile) + 7) / 8;
    for (int nb0 = 0; nb0 < n_nb; nb0 += kGroup) {
      // kGroup products in flight, then their epilogues
      unsigned d[kGroup][4];
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        const unsigned* w = s_desc[s][(nb0 + e) * 8 + g];
        d[e][0] = d[e][1] = d[e][2] = d[e][3] = 0u;
        mma_and_popc(d[e], a, w[t], w[4 + t]);
      }
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        // d[e][0], d[e][1]: row g, columns 2t, 2t + 1; d[e][2], d[e][3]:
        // row g + 8
        const int c = (nb0 + e) * 8 + 2 * t;
        const uint2 ck = *reinterpret_cast<const uint2*>(&s_key[s][c]);
        unsigned k[4] = {ck.x - d[e][0] * (1u << (kColBits + 1)),
                         ck.y - d[e][1] * (1u << (kColBits + 1)),
                         ck.x - d[e][2] * (1u << (kColBits + 1)),
                         ck.y - d[e][3] * (1u << (kColBits + 1))};
        if constexpr (kMode != 0) {
          const float2 cx = *reinterpret_cast<const float2*>(&s_x[s][c]);
          const float2 cy = *reinterpret_cast<const float2*>(&s_y[s][c]);
          float2 cr = make_float2(0.0f, 0.0f);
          if constexpr (kMode == 2)
            cr = *reinterpret_cast<const float2*>(&s_r2[s][c]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float dx = __fsub_rn(qx[h], j ? cx.y : cx.x);
              const float dy = __fsub_rn(qy[h], j ? cy.y : cy.x);
              const float d2 =
                  __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
              const float r2 = kMode == 1 ? qr2[h] : (j ? cr.y : cr.x);
              if (!(d2 <= r2)) k[2 * h + j] |= kFault;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) push(k[q], m1[q], m2[q]);
      }
    }
    if (i + 1 < n_tiles) publish(i + 1, s ^ 1);
    __syncthreads();
  }

  // merge the column parities, then the four lanes of a row group (they
  // hold disjoint columns); the row popcounts from the A fragments
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    merge(m1[2 * h + 1], m2[2 * h + 1], m1[2 * h], m2[2 * h]);
    int pa = __popc(a[h]) + __popc(a[2 + h]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const unsigned o1 = __shfl_xor_sync(0xffffffffu, m1[2 * h], off);
      const unsigned o2 = __shfl_xor_sync(0xffffffffu, m2[2 * h], off);
      merge(o1, o2, m1[2 * h], m2[2 * h]);
      pa += __shfl_xor_sync(0xffffffffu, pa, off);
    }
    if (t == 0) {
      s_m1[warp * 16 + g + 8 * h] = m1[2 * h];
      s_m2[warp * 16 + g + 8 * h] = m2[2 * h];
      s_pa[warp * 16 + g + 8 * h] = pa;
    }
  }

  // merge the cluster's column slices through distributed shared memory:
  // block r of the cluster finishes rows r, r + 8, ... of the 64
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int lr = (int)cluster.block_rank() + kSplits * tid;
  if (lr < kRows) {
    unsigned o1[kSplits], o2[kSplits];
#pragma unroll
    for (int q = 0; q < kSplits; ++q) {
      o1[q] = cluster.map_shared_rank(s_m1, q)[lr];
      o2[q] = cluster.map_shared_rank(s_m2, q)[lr];
    }
    unsigned b1 = kNone, b2 = kNone;
#pragma unroll
    for (int q = 0; q < kSplits; ++q) merge(o1[q], o2[q], b1, b2);
    const int row = row0 + lr;
    if (row < n1) {
      const int pa = s_pa[lr] - 256;  // the same rows in every block
      const bool ok1 = !(b1 & kFault);
      d_best[row] = ok1 ? (float)((int)(b1 >> kColBits) + pa) : 1e9f;
      idx[row] = ok1 ? (int)(b1 & kColMask) : -1;
      d_second[row] =
          (b2 & kFault) ? 1e9f : (float)((int)(b2 >> kColBits) + pa);
    }
  }
  cluster.sync();  // keep every block's s_m1 / s_m2 alive until read
}

template <int kMode>
cudaError_t launch(const void* desc1, const void* desc2, const void* valid2,
                   const void* pred, const void* rad2, const void* pts2,
                   int n1, int n2, float* d_best, float* d_second,
                   int* idx, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n1 + kRows - 1) / kRows, kSplits);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = kSplits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int cols_per_split = (n2 + kSplits - 1) / kSplits;
  return cudaLaunchKernelEx(
      &cfg, knn2_kernel<kMode>, static_cast<const unsigned*>(desc1),
      static_cast<const unsigned*>(desc2),
      static_cast<const unsigned char*>(valid2),
      static_cast<const float*>(pred), static_cast<const float*>(rad2),
      static_cast<const float*>(pts2), n1, n2, cols_per_split, d_best,
      d_second, idx);
}

}  // namespace

extern "C" {

// desc1 (n1, 8), desc2 (n2, 8) int32 bit patterns, 16-byte aligned;
// valid2 (n2,) bool; xy_mode 0: pred, rad2, pts2 unused (may be null);
// 1: pred (n1, 2), rad2 (n1,), pts2 (n2, 2); 2: pred (n1, 2), rad2 (n2,),
// pts2 (n2, 2). n1 >= 1, 0 <= n2 <= 2^21. The column sweep is cut into 8
// slices, one cluster of 8 blocks per 64 query rows. Outputs (n1,)
// float32, float32, int32. One launch on `stream`; returns its cudaError_t
// (0 on success).
int knn2_launch(const void* desc1, const void* desc2, const void* valid2,
                const void* pred, const void* rad2, const void* pts2, int n1,
                int n2, int xy_mode, void* d_best, void* d_second, void* idx,
                void* stream) {
  if (n1 < 1 || n2 < 0 || n2 > (1 << kColBits) || xy_mode < 0 ||
      xy_mode > 2)
    return (int)cudaErrorInvalidValue;
  auto* db = static_cast<float*>(d_best);
  auto* ds = static_cast<float*>(d_second);
  auto* ix = static_cast<int*>(idx);
  auto s = (cudaStream_t)stream;
  cudaError_t err;
  if (xy_mode == 0)
    err = launch<0>(desc1, desc2, valid2, pred, rad2, pts2, n1, n2, db, ds,
                    ix, s);
  else if (xy_mode == 1)
    err = launch<1>(desc1, desc2, valid2, pred, rad2, pts2, n1, n2, db, ds,
                    ix, s);
  else
    err = launch<2>(desc1, desc2, valid2, pred, rad2, pts2, n1, n2, db, ds,
                    ix, s);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

const char* knn2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
