// Fused binary 2-NN search with an optional radius gate, on the tensor
// cores, for descriptors of any width.
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
// bit-identical to the plain version in ops/kernels/knn2.py. Three
// instantiations: kWords = 8 (256 bits) and 16 (512 bits) 32-bit words
// per descriptor, with the query rows' fragments in registers, and a
// runtime width for wider descriptors (a multiple of 8 words), with the
// fragments staged in shared memory; the wrapper pads narrower
// descriptors with zero words, which add nothing to a popcount.
//
// The product. The TPU body multiplies +-1 signs on the MXU. Here each
// 16 x 8 tile of pairs is one mma.sync.m16n8k256 .b1 .and.popc per 256
// bits on the packed words as they are (two, accumulating into the same
// registers, at 512 bits; one per 256-bit chunk at a runtime width): c =
// popc(a & b) exactly, in s32, and ham = pa + pb - 2 c with pa, pb the
// row and column popcounts. On sm_90a this is one BMMA instruction (a
// hardware tensor-core op, not an emulation; chip_probes/mma_probe.py
// shows it in the SASS and checks it exact). At 2048 x 2048 x 256 bits
// the whole product is 32 K such instructions, well under a microsecond
// on 132 SMs, so neither wgmma nor TMA would buy anything here: wgmma has
// no .b1 form, and the inputs (2 x 64 KB, or 2 x 128 KB at 512 bits)
// live in L2.
//
// What bounds it, then: the epilogue, one key per pair in 32-bit integer
// ops (64 per clock per SM), and at the main path's size the fixed
// latency of one short launch (the first loads, the cluster's barrier and
// merge; PERF.md has the measured split). Design:
// - Keys. key = (field << col_bits) | column with field = pb - 2 c +
//   bits, the Hamming distance less the row's constant pa - bits (a
//   constant per row moves no min), so one IMAD per pair builds the key
//   from a per-column constant ((pb + bits) << col_bits | column). Since
//   c <= min(pa, pb), the field lies in 0..2 bits: bit_length(2 bits)
//   bits (10 at 256 bits, 11 at 512, 12 at 1024), and the column field is
//   what remains of 31 bits (21, 20, 19). The column is relative to the
//   block's column slice. A fault (invalid column or outside the gate)
//   sets bit 31, above every valid key, so a faulted key sorts after
//   every valid one and a second fault changes nothing. Lowest-column
//   ties fall out of the native 32-bit min; the top-2 update is m2 =
//   min(m2, max(m1, k)); m1 = min(m1, k). Columns past the end stage as
//   zero words with the key 0xffffffff.
// - Filling the card. A block owns 64 query rows (4 warps x 16) and one
//   of 8 slices of the columns; the 8 slices of one row block form a
//   thread-block cluster (8 is the portable cluster size; 32 x 8 = 256
//   blocks at the main path's 2048 rows), and after the sweep the cluster
//   merges its slices' top-2 pairs through distributed shared memory,
//   each key widened to 64 bits as (fault and field, slice start +
//   column), so the lowest column still wins a tie across slices. A
//   slice holds at most 2^col_bits columns, so one launch takes 8 x
//   2^col_bits (2^24 at 8 words, 2^23 at 16); the wrapper launches once
//   per such chunk of a longer candidate set and merges the chunks. One
//   launch per chunk, no scratch in device memory. Each lane keeps four
//   independent (min, second min) chains, one per row and column parity
//   of its accumulator fragment.
// - Overlapping loads, kWords 8 and 16. Candidates are staged kTile
//   columns at a time (256 at 256 bits, 128 at 512 bits, so the static
//   shared memory stays under 48 KB) by cp.async into a 2-stage ring; the
//   next tile's copies and the loads of its per-column constants
//   (validity, x, y, r^2) are in flight while the current tile is
//   multiplied, and the thread that copied a column computes its popcount
//   and key constant once per block. One barrier per tile. Staged columns
//   are padded to kStride words (12 for 8, 20 for 16: 16-byte multiples
//   whose g * kStride mod 32 for the 8 fragment columns g are 8 distinct
//   multiples of 4), so the fragment loads of a warp (word t of column g,
//   0 <= t < 4) hit 32 distinct banks, for either 256-bit half. Each warp
//   issues 8 products before their epilogues, so the tensor-core latency
//   overlaps.
// - A runtime width (knn2_wide_kernel). The 64 query rows and 128
//   candidate columns stream through a 2-stage cp.async ring in depth
//   chunks of 16 words (two 256-bit products), rows and columns at a
//   20-word stride (the same conflict-free fragment loads); each warp's
//   16 x 128 accumulators stay in registers across the depth chunks, the
//   column popcounts accumulate from the staged chunks, the row popcounts
//   come from a pre-pass. One barrier per chunk; the epilogue runs once
//   per tile on the summed products, with the tile's keys double-buffered
//   so the next tile's keys never overwrite ones still read.
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
// runtime width: candidate columns per tile, words per depth chunk and
// per staged row or column (padding included)
constexpr int kWideTile = 128;
constexpr int kWideDepth = 16;
constexpr int kWideStride = 20;
constexpr int kWideNb = kWideTile / 8;  // 8-column n-blocks per tile
// widest descriptor: the distance field 0..64 words must fit 31 bits
constexpr int kMaxWords = (1 << 25) - 8;

// bits of the key's column field at `words` words: what 31 bits leave
// beside the distance field, bit_length(2 * 32 * words)
__host__ __device__ constexpr int col_bits_for(int words) {
  int field = 0;
  for (unsigned v = 64u * (unsigned)words; v != 0u; v >>= 1) ++field;
  return 31 - field;
}

// per descriptor width: candidate columns per stage, words per staged
// column (padding included), bits of the key's column field
template <int kWords>
struct Width;
template <>
struct Width<8> {
  static constexpr int kTile = 256, kStride = 12,
                       kColBits = col_bits_for(8);
};
template <>
struct Width<16> {
  static constexpr int kTile = 128, kStride = 20,
                       kColBits = col_bits_for(16);
};
static_assert(Width<8>::kColBits == 21 && Width<16>::kColBits == 20,
              "the 8- and 16-word keys' column fields");

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
template <typename T>
__device__ __forceinline__ void merge(T o1, T o2, T& m1, T& m2) {
  m2 = min(max(m1, o1), min(m2, o2));
  m1 = min(m1, o1);
}

// a slice's key as (fault and field, column of the launch) in 64 bits:
// ordered as (field, slice, column in the slice)
__device__ __forceinline__ unsigned long long widen(unsigned key, int slice,
                                                    int cols_per_split,
                                                    int col_bits) {
  const unsigned col = key & ((1u << col_bits) - 1u);
  return ((unsigned long long)(key >> col_bits) << 32) |
         (unsigned)(slice * cols_per_split + (int)col);
}

// After the sweep: every block's top-2 keys of its 64 rows (relative to
// its slice) in s_m1 / s_m2, the rows' popcounts in s_pa. The cluster's
// blocks merge the 8 slices through distributed shared memory in slice
// order; block r finishes rows r, r + 8, ... of the 64.
__device__ __forceinline__ void finish_rows(
    const unsigned* s_m1, const unsigned* s_m2, const int* s_pa, int bits,
    int col_bits, int cols_per_split, int row0, int n1, int tid,
    float* __restrict__ d_best, float* __restrict__ d_second,
    int* __restrict__ idx) {
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
    unsigned long long b1 = ~0ull, b2 = ~0ull;
#pragma unroll
    for (int q = 0; q < kSplits; ++q)
      merge(widen(o1[q], q, cols_per_split, col_bits),
            widen(o2[q], q, cols_per_split, col_bits), b1, b2);
    const int row = row0 + lr;
    if (row < n1) {
      const int pa = s_pa[lr] - bits;  // the same rows in every block
      const unsigned fault = kFault >> col_bits;
      const unsigned h1 = (unsigned)(b1 >> 32), h2 = (unsigned)(b2 >> 32);
      const bool ok1 = !(h1 & fault);
      d_best[row] = ok1 ? (float)((int)h1 + pa) : 1e9f;
      idx[row] = ok1 ? (int)(unsigned)b1 : -1;
      d_second[row] = (h2 & fault) ? 1e9f : (float)((int)h2 + pa);
    }
  }
  cluster.sync();  // keep every block's s_m1 / s_m2 alive until read
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
              (unsigned)(col - cbeg);
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
  finish_rows(s_m1, s_m2, s_pa, kBits, kColBits, cols_per_split, row0, n1,
              tid, d_best, d_second, idx);
}

// The runtime width: words > 16, a multiple of 8. Step s of the sweep is
// (tile s / n_kc, depth chunk s % n_kc); its 64 query rows and kWideTile
// columns of kWideDepth words land in ring slot s & 1.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
knn2_wide_kernel(const unsigned* __restrict__ desc1,
                 const unsigned* __restrict__ desc2,
                 const unsigned char* __restrict__ valid2,
                 const float* __restrict__ pred,
                 const float* __restrict__ rad2,
                 const float* __restrict__ pts2, int n1, int n2, int words,
                 int col_bits, int cols_per_split, float* __restrict__ d_best,
                 float* __restrict__ d_second, int* __restrict__ idx) {
  __shared__ __align__(16) unsigned s_a[2][kRows][kWideStride];
  __shared__ __align__(16) unsigned s_b[2][kWideTile][kWideStride];
  // keys and gate values of the tile, by tile parity
  __shared__ __align__(8) unsigned s_key[2][kWideTile];
  __shared__ __align__(8) float s_x[2][kMode ? kWideTile : 2];
  __shared__ __align__(8) float s_y[2][kMode ? kWideTile : 2];
  __shared__ __align__(8) float s_r2[2][kMode == 2 ? kWideTile : 2];
  __shared__ unsigned s_m1[kRows], s_m2[kRows];
  __shared__ int s_pa[kRows];
  static_assert(kWideTile == kThreads, "one staged column per thread");

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, k group
  const int row0 = blockIdx.x * kRows;
  const int cbeg = blockIdx.y * cols_per_split;
  const int cend = min(n2, cbeg + cols_per_split);
  const int n_tiles =
      cend > cbeg ? (cend - cbeg + kWideTile - 1) / kWideTile : 0;
  const int n_kc = (words + kWideDepth - 1) / kWideDepth;
  const int n_steps = n_tiles * n_kc;
  const int bits = 32 * words;

  // row popcounts: two threads per row, each over every other word
  {
    const int r = tid >> 1;
    const unsigned* src = desc1 + (size_t)min(row0 + r, n1 - 1) * words;
    int p = 0;
    for (int w = tid & 1; w < words; w += 2) p += __popc(src[w]);
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    if ((tid & 1) == 0) s_pa[r] = p;
  }

  // stage step s: 16-byte copies, words past `words` and columns past
  // the slice zero-filled; query rows past n1 repeat the last row
  auto fetch = [&](int s) {
    const int tile = s / n_kc, kc = s - tile * n_kc, b = s & 1;
    const int k0 = kc * kWideDepth;
#pragma unroll
    for (int u = 0; u < kRows * kWideDepth / 4 / kThreads; ++u) {
      const int e = tid + u * kThreads;
      const int r = e >> 2, k = k0 + 4 * (e & 3);
      const unsigned* src =
          desc1 + (size_t)min(row0 + r, n1 - 1) * words + k;
      cp_async16(&s_a[b][r][4 * (e & 3)], k < words ? src : desc1,
                 k < words ? 16 : 0);
    }
#pragma unroll
    for (int u = 0; u < kWideTile * kWideDepth / 4 / kThreads; ++u) {
      const int e = tid + u * kThreads;
      const int c = e >> 2, k = k0 + 4 * (e & 3);
      const int col = cbeg + tile * kWideTile + c;
      const bool in = col < cend && k < words;
      cp_async16(&s_b[b][c][4 * (e & 3)],
                 in ? desc2 + (size_t)col * words + k : desc2, in ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  unsigned m1[4] = {kNone, kNone, kNone, kNone};
  unsigned m2[4] = {kNone, kNone, kNone, kNone};
  unsigned d[kWideNb][4];
  float qx[2] = {0.0f, 0.0f}, qy[2] = {0.0f, 0.0f}, qr2[2] = {0.0f, 0.0f};
  if constexpr (kMode != 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = min(row0 + warp * 16 + g + 8 * h, n1 - 1);
      qx[h] = pred[2 * row];
      qy[h] = pred[2 * row + 1];
      if (kMode == 1) qr2[h] = rad2[row];
    }
  }
  // column tid of the current tile: validity, gate values, popcount
  bool c_valid = false;
  float c_x = 0.0f, c_y = 0.0f, c_r2 = 0.0f;
  unsigned pb = 0u;

  if (n_steps > 0) fetch(0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    const int tile = s / n_kc, kc = s - tile * n_kc, b = s & 1;
    const int c0 = cbeg + tile * kWideTile;
    if (s + 1 < n_steps) fetch(s + 1);
    if (kc == 0) {
      const int col = c0 + tid;
      const bool in = col < cend;
      c_valid = in && valid2[col];
      if constexpr (kMode != 0) {
        c_x = in ? pts2[2 * col] : 0.0f;
        c_y = in ? pts2[2 * col + 1] : 0.0f;
        if constexpr (kMode == 2) c_r2 = in ? rad2[col] : 0.0f;
      }
      pb = 0u;
#pragma unroll
      for (int e = 0; e < kWideNb; ++e) d[e][0] = d[e][1] = d[e][2] =
          d[e][3] = 0u;
    }
#pragma unroll
    for (int v = 0; v < kWideDepth / 4; ++v) {
      const uint4 w = *reinterpret_cast<const uint4*>(&s_b[b][tid][4 * v]);
      pb += __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
    }
    // n-blocks of 8 columns that hold a column of this slice
    const int n_nb = (min(kWideTile, cend - c0) + 7) / 8;
#pragma unroll
    for (int q = 0; q < kWideDepth / 8; ++q) {
      if (kc * kWideDepth + 8 * q < words) {  // else a zero-filled half
        unsigned a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[h] = s_a[b][warp * 16 + g + 8 * h][8 * q + t];
          a[2 + h] = s_a[b][warp * 16 + g + 8 * h][8 * q + 4 + t];
        }
#pragma unroll
        for (int e = 0; e < kWideNb; ++e) {
          if (e < n_nb) {
            const unsigned* w = s_b[b][e * 8 + g];
            mma_and_popc(d[e], a, w[8 * q + t], w[8 * q + 4 + t]);
          }
        }
      }
    }
    const bool last = kc == n_kc - 1;
    const int tb = tile & 1;
    if (last) {
      const int col = c0 + tid;
      s_key[tb][tid] =
          col < cend ? (c_valid ? 0u : kFault) |
                           ((pb + (unsigned)bits) << col_bits) |
                           (unsigned)(col - cbeg)
                     : kNone;
      if constexpr (kMode != 0) {
        s_x[tb][tid] = c_x;
        s_y[tb][tid] = c_y;
        if constexpr (kMode == 2) s_r2[tb][tid] = c_r2;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (!last) continue;
    // epilogue of the tile: its summed products against its keys
#pragma unroll
    for (int e = 0; e < kWideNb; ++e) {
      if (e >= n_nb) continue;
      const int c = e * 8 + 2 * t;
      const uint2 ck = *reinterpret_cast<const uint2*>(&s_key[tb][c]);
      const unsigned step = 1u << (col_bits + 1);
      unsigned k[4] = {ck.x - d[e][0] * step, ck.y - d[e][1] * step,
                       ck.x - d[e][2] * step, ck.y - d[e][3] * step};
      if constexpr (kMode != 0) {
        const float2 cx = *reinterpret_cast<const float2*>(&s_x[tb][c]);
        const float2 cy = *reinterpret_cast<const float2*>(&s_y[tb][c]);
        float2 cr = make_float2(0.0f, 0.0f);
        if constexpr (kMode == 2)
          cr = *reinterpret_cast<const float2*>(&s_r2[tb][c]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float dx = __fsub_rn(qx[h], j ? cx.y : cx.x);
            const float dy = __fsub_rn(qy[h], j ? cy.y : cy.x);
            const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
            const float r2 = kMode == 1 ? qr2[h] : (j ? cr.y : cr.x);
            if (!(d2 <= r2)) k[2 * h + j] |= kFault;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) push(k[q], m1[q], m2[q]);
    }
  }

  // merge the column parities, then the four lanes of a row group
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    merge(m1[2 * h + 1], m2[2 * h + 1], m1[2 * h], m2[2 * h]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const unsigned o1 = __shfl_xor_sync(0xffffffffu, m1[2 * h], off);
      const unsigned o2 = __shfl_xor_sync(0xffffffffu, m2[2 * h], off);
      merge(o1, o2, m1[2 * h], m2[2 * h]);
    }
    if (t == 0) {
      s_m1[warp * 16 + g + 8 * h] = m1[2 * h];
      s_m2[warp * 16 + g + 8 * h] = m2[2 * h];
    }
  }
  finish_rows(s_m1, s_m2, s_pa, bits, col_bits, cols_per_split, row0, n1,
              tid, d_best, d_second, idx);
}

// one launch of `kernel` over n2 <= kSplits << col_bits columns: a
// cluster of kSplits blocks per 64 query rows, one column slice each
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int n1, cudaStream_t stream,
                   Args... args) {
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
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int kWords, int kMode>
cudaError_t launch_width(const unsigned* desc1, const unsigned* desc2,
                         const unsigned char* valid2, const float* pred,
                         const float* rad2, const float* pts2, int n1, int n2,
                         int words, float* d_best, float* d_second, int* idx,
                         cudaStream_t stream) {
  const int cols_per_split = (n2 + kSplits - 1) / kSplits;
  if constexpr (kWords == 0)
    return launch(knn2_wide_kernel<kMode>, n1, stream, desc1, desc2,
                  valid2, pred, rad2, pts2, n1, n2, words,
                  col_bits_for(words), cols_per_split, d_best, d_second, idx);
  else
    return launch(knn2_kernel<kWords, kMode>, n1, stream, desc1, desc2,
                  valid2, pred, rad2, pts2, n1, n2, cols_per_split, d_best,
                  d_second, idx);
}

template <int kWords>
cudaError_t dispatch(int xy_mode, const unsigned* desc1,
                     const unsigned* desc2, const unsigned char* valid2,
                     const float* pred, const float* rad2, const float* pts2,
                     int n1, int n2, int words, float* d_best,
                     float* d_second, int* idx, cudaStream_t stream) {
  if (xy_mode == 0)
    return launch_width<kWords, 0>(desc1, desc2, valid2, pred, rad2, pts2,
                                   n1, n2, words, d_best, d_second, idx,
                                   stream);
  if (xy_mode == 1)
    return launch_width<kWords, 1>(desc1, desc2, valid2, pred, rad2, pts2,
                                   n1, n2, words, d_best, d_second, idx,
                                   stream);
  return launch_width<kWords, 2>(desc1, desc2, valid2, pred, rad2, pts2, n1,
                                 n2, words, d_best, d_second, idx, stream);
}

// Most candidate columns one launch takes at `words` words (8 column
// slices of 2^col_bits), or 0 for a width the kernel does not take.
int max_columns(int words) {
  if (words != 8 && (words < 16 || words % 8 != 0 || words > kMaxWords))
    return 0;
  return kSplits << col_bits_for(words);
}

}  // namespace

extern "C" {

// desc1 (n1, words), desc2 (n2, words) int32 bit patterns, words 8, 16 or
// a larger multiple of 8, 16-byte aligned; valid2 (n2,) bool; xy_mode 0:
// pred, rad2, pts2 unused (may be null); 1: pred (n1, 2), rad2 (n1,), pts2
// (n2, 2); 2: pred (n1, 2), rad2 (n2,), pts2 (n2, 2). n1 >= 1, 0 <= n2 <=
// max_columns(words). The column sweep is cut into 8 slices, one
// cluster of 8 blocks per 64 query rows. Outputs (n1,) float32, float32,
// int32. One launch on `stream`; returns its cudaError_t (0 on success).
int knn2_launch(const void* desc1, const void* desc2, const void* valid2,
                const void* pred, const void* rad2, const void* pts2, int n1,
                int n2, int words, int xy_mode, void* d_best, void* d_second,
                void* idx, void* stream) {
  if (n1 < 1 || n2 < 0 || xy_mode < 0 || xy_mode > 2 ||
      n2 > max_columns(words))
    return (int)cudaErrorInvalidValue;
  const auto* a = static_cast<const unsigned*>(desc1);
  const auto* b = static_cast<const unsigned*>(desc2);
  const auto* v = static_cast<const unsigned char*>(valid2);
  const auto* p = static_cast<const float*>(pred);
  const auto* r = static_cast<const float*>(rad2);
  const auto* x = static_cast<const float*>(pts2);
  auto* db = static_cast<float*>(d_best);
  auto* ds = static_cast<float*>(d_second);
  auto* ix = static_cast<int*>(idx);
  auto s = (cudaStream_t)stream;
  cudaError_t err;
  if (words == 8)
    err = dispatch<8>(xy_mode, a, b, v, p, r, x, n1, n2, words, db, ds, ix, s);
  else if (words == 16)
    err = dispatch<16>(xy_mode, a, b, v, p, r, x, n1, n2, words, db, ds, ix,
                       s);
  else
    err = dispatch<0>(xy_mode, a, b, v, p, r, x, n1, n2, words, db, ds, ix, s);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

const char* knn2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
