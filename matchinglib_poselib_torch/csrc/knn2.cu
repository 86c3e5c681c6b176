// Fused binary 2-NN search with an optional radius gate, on the tensor
// cores, for 256- and 512-bit descriptors.
//
// Replaces the packed binary body of the Pallas TPU kernel
// matchinglib_poselib_tpu/ops/pallas/knn.py (knn2, kernel body
// _knn2_kernel_packed, :131; pallas_call at :285), which takes any
// descriptor width. For every query row: the Hamming distance to every
// candidate, the candidate validity penalty and, for xy_mode 1 (radius
// per query) or 2 (radius per candidate), the gate |pred_i - pts2_j|^2 <=
// r^2; then the best distance, its column (lowest column on ties) and the
// second-best distance. Output: d_best, d_second as float (1e9 when no
// candidate is valid and inside the gate) and idx (-1 then),
// bit-identical to the plain version in ops/kernels/knn2.py. The kernel
// is built for kWords = 8 (256 bits) and 16 (512 bits) 32-bit words per
// descriptor; the wrapper pads narrower descriptors with zero words,
// which add nothing to a popcount.
//
// The product. The TPU body multiplies +-1 signs on the MXU. Here each
// 16 x 8 tile of pairs is one mma.sync.m16n8k256 .b1 .and.popc per 256
// bits on the packed words as they are (two, accumulating into the same
// registers, at 512 bits): c = popc(a & b) exactly, in s32, and ham = pa
// + pb - 2 c with pa, pb the row and column popcounts. On sm_90a this is
// one BMMA instruction (a hardware tensor-core op, not an emulation;
// chip_probes/mma_probe.py shows it in the SASS and checks it exact). At
// 2048 x 2048 x 256 bits the whole product is 32 K such instructions,
// well under a microsecond on 132 SMs, so neither wgmma nor TMA would buy
// anything here: wgmma has no .b1 form, and the inputs (2 x 64 KB, or 2 x
// 128 KB at 512 bits) live in L2.
//
// What bounds it, then: the epilogue, one key per pair in 32-bit integer
// ops (64 per clock per SM), and at the main path's size the fixed
// latency of one short launch (the first loads, the cluster's barrier and
// merge; PERF.md has the measured split). Design:
// - Keys. key = (field << kColBits) | column with field = pb - 2 c +
//   kBits, the Hamming distance less the row's constant pa - kBits (a
//   constant per row moves no min), so one IMAD per pair builds the key
//   from a per-column constant ((pb + kBits) << kColBits | column). Since
//   c <= min(pa, pb), the field lies in 0..2 kBits: 0..512 at 256 bits,
//   10 bits with 21 column bits; 0..1024 at 512 bits (1024 for an
//   all-zero row against an all-ones column), 11 bits with 20 column
//   bits. A fault (invalid column or outside the gate)
//   sets bit 31, above every valid key, so a faulted key sorts after
//   every valid one and a second fault changes nothing. Lowest-column
//   ties fall out of the native 32-bit min; the top-2 update is m2 =
//   min(m2, max(m1, k)); m1 = min(m1, k). Columns past the end stage as
//   zero words with the key 0xffffffff (n2 <= 2^kColBits, checked by the
//   wrapper).
// - Filling the card. A block owns 64 query rows (4 warps x 16, the A
//   fragments in registers for the whole sweep) and one of 8 slices of
//   the columns; the 8 slices of one row block form a thread-block
//   cluster (8 is the portable cluster size; 32 x 8 = 256 blocks at the
//   main path's 2048 rows), and after the sweep the cluster merges its
//   slices' top-2 pairs through distributed shared memory. One launch
//   per call, no scratch in device memory. Each lane keeps four
//   independent (min, second min) chains, one per row and column parity
//   of its accumulator fragment.
// - Overlapping loads. Candidates are staged kTile columns at a time (256
//   at 256 bits, 128 at 512 bits, so the static shared memory stays
//   under 48 KB) by cp.async into a 2-stage ring; the next tile's copies
//   and the loads of its per-column constants (validity, x, y, r^2) are
//   in flight while the current tile is multiplied, and the thread that
//   copied a column computes its popcount and key constant once per
//   block. One barrier per tile. Staged columns are padded to kStride
//   words (12 for 8, 20 for 16: 16-byte multiples whose g * kStride mod
//   32 for the 8 fragment columns g are 8 distinct multiples of 4), so
//   the fragment loads of a warp (word t of column g, 0 <= t < 4) hit 32
//   distinct banks, for either 256-bit half. Each warp issues 8 products
//   before their epilogues, so the tensor-core latency overlaps.
// - The gate uses round-to-nearest multiplies and adds with no FMA
//   contraction, so it decides exactly as the plain version's separate
//   ops do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows per block
constexpr int kGroup = 8;       // 16 x 8 products in flight per warp
constexpr unsigned kFault = 1u << 31;
constexpr unsigned kNone = ~0u;
constexpr int kSplits = 8;      // column slices = blocks per cluster (portable)

// per descriptor width: candidate columns per stage, words per staged
// column (padding included), bits of the key's column field
template <int kWords>
struct Width;
template <>
struct Width<8> {
  static constexpr int kTile = 256, kStride = 12, kColBits = 21;
};
template <>
struct Width<16> {
  static constexpr int kTile = 128, kStride = 20, kColBits = 20;
};

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

template <int kWords, int kMode>
__global__ void __launch_bounds__(kThreads)
knn2_kernel(const unsigned* __restrict__ desc1,
            const unsigned* __restrict__ desc2,
            const unsigned char* __restrict__ valid2,
            const float* __restrict__ pred, const float* __restrict__ rad2,
            const float* __restrict__ pts2, int n1, int n2,
            int cols_per_split, float* __restrict__ d_best,
            float* __restrict__ d_second, int* __restrict__ idx) {
  constexpr int kTile = Width<kWords>::kTile;
  constexpr int kStride = Width<kWords>::kStride;
  constexpr int kColBits = Width<kWords>::kColBits;
  constexpr unsigned kColMask = (1u << kColBits) - 1u;
  constexpr int kBits = 32 * kWords;
  constexpr int kChunks = kWords / 8;  // 256-bit products per tile
  constexpr int kColsPerThread = kTile / kThreads;  // columns staged each
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

  // this lane's A fragments, one per 256 bits q: rows g and g + 8 of the
  // warp's 16, words 8 q + t and 8 q + 4 + t (the m16n8k256 .b1 layout);
  // rows past n1 repeat the last row
  unsigned a[kChunks][4];
  float qx[2] = {0.0f, 0.0f}, qy[2] = {0.0f, 0.0f}, qr2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = min(row0 + warp * 16 + g + 8 * h, n1 - 1);
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      a[q][h] = desc1[(size_t)row * kWords + 8 * q + t];
      a[q][2 + h] = desc1[(size_t)row * kWords + 8 * q + 4 + t];
    }
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
#pragma unroll
      for (int v = 0; v < kWords / 4; ++v)
        cp_async16(&s_desc[s][c][4 * v], src + 4 * v, in ? 16 : 0);
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
        unsigned pb = 0u;
#pragma unroll
        for (int v = 0; v < kWords / 4; ++v) {
          const uint4 w =
              *reinterpret_cast<const uint4*>(&s_desc[s][c][4 * v]);
          pb += __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
        }
        key = (c_valid[u] ? 0u : kFault) | ((pb + kBits) << kColBits) |
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
#pragma unroll
        for (int q = 0; q < kChunks; ++q)
          mma_and_popc(d[e], a[q], w[8 * q + t], w[8 * q + 4 + t]);
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
    int pa = 0;
#pragma unroll
    for (int q = 0; q < kChunks; ++q)
      pa += __popc(a[q][h]) + __popc(a[q][2 + h]);
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
      const int pa = s_pa[lr] - kBits;  // the same rows in every block
      const bool ok1 = !(b1 & kFault);
      d_best[row] = ok1 ? (float)((int)(b1 >> kColBits) + pa) : 1e9f;
      idx[row] = ok1 ? (int)(b1 & kColMask) : -1;
      d_second[row] =
          (b2 & kFault) ? 1e9f : (float)((int)(b2 >> kColBits) + pa);
    }
  }
  cluster.sync();  // keep every block's s_m1 / s_m2 alive until read
}

template <int kWords, int kMode>
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
      &cfg, knn2_kernel<kWords, kMode>, static_cast<const unsigned*>(desc1),
      static_cast<const unsigned*>(desc2),
      static_cast<const unsigned char*>(valid2),
      static_cast<const float*>(pred), static_cast<const float*>(rad2),
      static_cast<const float*>(pts2), n1, n2, cols_per_split, d_best,
      d_second, idx);
}

template <int kWords>
cudaError_t dispatch(const void* desc1, const void* desc2, const void* valid2,
                     const void* pred, const void* rad2, const void* pts2,
                     int n1, int n2, int xy_mode, float* d_best,
                     float* d_second, int* idx, cudaStream_t stream) {
  if (n2 > (1 << Width<kWords>::kColBits)) return cudaErrorInvalidValue;
  if (xy_mode == 0)
    return launch<kWords, 0>(desc1, desc2, valid2, pred, rad2, pts2, n1, n2,
                             d_best, d_second, idx, stream);
  if (xy_mode == 1)
    return launch<kWords, 1>(desc1, desc2, valid2, pred, rad2, pts2, n1, n2,
                             d_best, d_second, idx, stream);
  return launch<kWords, 2>(desc1, desc2, valid2, pred, rad2, pts2, n1, n2,
                           d_best, d_second, idx, stream);
}

}  // namespace

extern "C" {

// desc1 (n1, words), desc2 (n2, words) int32 bit patterns, words 8 or 16,
// 16-byte aligned; valid2 (n2,) bool; xy_mode 0: pred, rad2, pts2 unused
// (may be null); 1: pred (n1, 2), rad2 (n1,), pts2 (n2, 2); 2: pred (n1,
// 2), rad2 (n2,), pts2 (n2, 2). n1 >= 1, 0 <= n2 <= 2^21 at 8 words, 2^20
// at 16. The column sweep is cut into 8 slices, one cluster of 8 blocks
// per 64 query rows. Outputs (n1,) float32, float32, int32. One launch on
// `stream`; returns its cudaError_t (0 on success).
int knn2_launch(const void* desc1, const void* desc2, const void* valid2,
                const void* pred, const void* rad2, const void* pts2, int n1,
                int n2, int words, int xy_mode, void* d_best, void* d_second,
                void* idx, void* stream) {
  if (n1 < 1 || n2 < 0 || xy_mode < 0 || xy_mode > 2 ||
      (words != 8 && words != 16))
    return (int)cudaErrorInvalidValue;
  auto* db = static_cast<float*>(d_best);
  auto* ds = static_cast<float*>(d_second);
  auto* ix = static_cast<int*>(idx);
  auto s = (cudaStream_t)stream;
  const cudaError_t err =
      words == 8 ? dispatch<8>(desc1, desc2, valid2, pred, rad2, pts2, n1,
                               n2, xy_mode, db, ds, ix, s)
                 : dispatch<16>(desc1, desc2, valid2, pred, rad2, pts2, n1,
                                n2, xy_mode, db, ds, ix, s);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

const char* knn2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
