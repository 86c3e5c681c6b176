// Fused float 2-NN search (squared L2) with an optional radius gate.
//
// Replaces the general body of the Pallas TPU kernel
// matchinglib_poselib_tpu/ops/pallas/knn.py (_knn2_kernel, :51, reached
// through the pallas_call at :285). For every query row i and candidate
// column j:
//
//   dist = max((|a_i|^2 + |b_j|^2) - 2 <a_i, b_j>, 0) + pen_j
//
// with pen_j = 0 for a valid column and 1e9 for an invalid one, plus 1e9
// more when xy_mode is 1 (radius per query) or 2 (radius per candidate)
// and the candidate lies outside |pred_i - pts2_j|^2 <= r^2. The running
// pair starts at (1e9, column -1) and pairs are ordered by (dist, column),
// so d_best = min(1e9, min_j dist), idx = the lowest column reaching it
// (-1 when nothing is below 1e9), and d_second = min(1e9, the smallest
// dist once that one column is removed) — the TPU body's tie rule.
// Everything is true fp32 on the CUDA cores: no TF32, no bf16, no tensor
// cores (the semantics asked for; the tensor cores have no fp32 mode).
//
// What bounds it: fp32 FMA. 2 N1 N2 D flops against (N1 + N2) D 4 bytes
// of input, ~500 flops per byte at the main path's 2048 x 2048 x 128,
// far above the card's ~20 fp32 flops per byte of HBM. So the design
// keeps the FMA pipe fed, wastes few FMA on padding, and pays for one
// launch only:
// - One launch per call. A block owns 64 query rows and one slice of the
//   candidate columns; the slices of a row block form a thread-block
//   cluster and merge their top-2 pairs through distributed shared memory.
//   A second cluster barrier keeps every block's shared memory alive until
//   it has been read. No scratch in device memory, no second kernel.
// - Filling the card. The slice count (1-8, the cluster size) is chosen
//   per call from the row blocks, the columns and what fits on the card
//   at once: clusters of each size and blocks per SM, asked of the
//   occupancy calculator once per device, xy_mode and depth and kept. It
//   takes the count with the least work on the busiest SM, counted in
//   64-column tiles (a block sweeps whole tiles). A fixed 8 would not fit
//   2048 rows' 256 blocks in one wave: the clusters of 8 that fit hold
//   fewer blocks than that.
// - The query tile stays in shared memory at D <= 640. The block's 64
//   rows are staged once, at full depth, by cp.async, as [row][k + pad];
//   candidates stream through a 3-stage cp.async ring of 64 columns x 64
//   depths, so the next two chunks load while the current one is
//   multiplied. One barrier per chunk. Shared memory: 64 (ceil64(D) + 4)
//   + 3 x 64 x 68 + 768 floats, 89,088 bytes at D = 128; at least 80 KB
//   is asked for (D = 64 needs 72,704), so that no third block shares an
//   SM: with room for three, the cluster scheduler packs some SMs with
//   three blocks and leaves others with one. At most 128 registers
//   (launch bounds). ptxas figures are in PERF.md.
// - Past D = 640 the full-depth query tile no longer fits, and a second
//   instantiation (kStream) streams it: each step of the ring stages the
//   64 query rows' chunk of 64 depths beside the candidates' chunk (3 x
//   64 x 68 floats more, 107,520 bytes in all, so two blocks still share
//   an SM), and the row norms come from a pre-pass over device memory in
//   the columns' order. The accumulators of a 64-column tile stay in
//   registers across the depth chunks, as at D <= 640.
// - 256 threads (8 warps), each with a 4 x 4 register tile (rows ty + 16 i,
//   columns tx + 16 j): per 4 depths, 4 float4 of A and 4 float4 of B
//   feed 64 FFMA, each float read feeding 4, one depth at a time over the
//   tile so that an accumulator's FMAs stand 16 apart. A warp reads 2
//   rows (broadcast) and 16 columns; the row and chunk strides are 4 mod
//   32 words, so the float4 reads of 8 neighbouring columns hit 8
//   distinct bank quads, and cp.async fills the layout as it lies in
//   memory, without a transpose. With 2 blocks per SM that is 16 warps to
//   hide latency; 8 x 8 and 4 x 8 tiles on 128 threads measured no faster.
// - Every pair sums over k = 0, 1, ..., D - 1 in that order, one FFMA per
//   depth (depths past D are zero-filled, adding exactly 0), so duplicate
//   candidates give bit-identical distances wherever they sit. Row and
//   column norms come from shared memory in one fixed order: two partial
//   sums, over the first and the second 32 depths of every 64-deep chunk,
//   each sequential, then added; two threads share each row and column.
// - Epilogue: fmaf(-2, acc, sq1 + sq2) rounds once, exactly as the plain
//   version's (sq1 + sq2) - 2 acc does, since 2 acc is exact; the gate
//   uses round-to-nearest intrinsics, so no FMA contraction moves a
//   decision. A thread meets its columns in increasing order, so its
//   running pair needs a strict < only; the cross-thread and cross-slice
//   merges compare (dist, column).
// - Any shape: ragged n1 and n2 zero-fill through cp.async's source size;
//   D % 4 != 0 or unaligned rows take 4-byte copies instead of 16-byte
//   ones; any D >= 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;       // query rows per block
constexpr int kCols = 64;       // candidate columns per tile
constexpr int kDepth = 64;      // depths per streamed chunk
constexpr int kHalf = kDepth / 2;  // depths per partial norm sum
constexpr int kChunkStride = kDepth + 4;  // words per staged column
constexpr int kStages = 3;      // cp.async ring depth
constexpr int kTm = 4, kTn = 4;  // register tile: rows, columns
constexpr int kRowGroups = kRows / kTm;  // a thread's rows: ty + 16 i
constexpr int kColGroups = kCols / kTn;  // its columns: tx + 16 j
constexpr int kThreads = kRowGroups * kColGroups;
constexpr int kMaxSplits = 8;   // column slices = blocks per cluster
constexpr int kSmall = 7 * kRows + 5 * kCols;  // small arrays, floats
constexpr int kMaxSmem = 232448;  // opt-in shared memory per block
// dynamic shared memory asked for at least: no third block fits on an SM
constexpr int kMinSmem = 80 * 1024;
constexpr int kMaxTileDepth = 640;  // deepest query tile kept whole
constexpr float kBig = 1e9f;
static_assert(kThreads >= 2 * kRows && kThreads >= 2 * kCols &&
                  2 * kRows % 32 == 0 && 2 * kCols % 32 == 0,
              "two threads, of whole warps, share each row's and each "
              "column's norm");

__host__ __device__ constexpr int a_stride(int d) {
  return (d + kDepth - 1) / kDepth * kDepth + 4;
}

// the query rows' shared memory: the whole tile, or a ring of chunks
__host__ __device__ constexpr int a_floats(int d, bool stream) {
  return stream ? kStages * kRows * kChunkStride : kRows * a_stride(d);
}

__host__ __device__ constexpr int smem_floats(int d, bool stream) {
  return a_floats(d, stream) + kStages * kCols * kChunkStride + kSmall;
}

__host__ __device__ constexpr int smem_bytes(int d, bool stream) {
  return smem_floats(d, stream) * 4 > kMinSmem ? smem_floats(d, stream) * 4
                                               : kMinSmem;
}
static_assert(smem_bytes(kMaxTileDepth, false) <= kMaxSmem &&
                  smem_bytes(kMaxTileDepth + 1, false) > kMaxSmem,
              "the whole query tile fits up to kMaxTileDepth");

// (d, c) < (bd, bc) lexicographically
__device__ __forceinline__ bool better(float d, int c, float bd, int bc) {
  return d < bd || (d == bd && c < bc);
}

// merge pair (o1, oi, o2) into (b1, i1, b2): the union's best and the
// smaller of the winner's second and the loser's best
__device__ __forceinline__ void merge(float o1, int oi, float o2, float& b1,
                                      int& i1, float& b2) {
  if (better(o1, oi, b1, i1)) {
    b2 = fminf(o2, b1);
    b1 = o1;
    i1 = oi;
  } else {
    b2 = fminf(b2, o1);
  }
}

// q += the squares of kHalf consecutive floats, in order
__device__ __forceinline__ float sq_half(const float* p, float q) {
#pragma unroll
  for (int k = 0; k < kHalf; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + k);
    q = fmaf(v.x, v.x, q);
    q = fmaf(v.y, v.y, q);
    q = fmaf(v.z, v.z, q);
    q = fmaf(v.w, v.w, q);
  }
  return q;
}

// global -> shared copies of 16 or 4 bytes; bytes past `src_bytes` are
// zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// stage `rows` rows of `src` (n valid rows of depth d, from row r0 and
// depth k0) as `width` depths into dst[row * stride + k]; rows past n and
// depths past d are zero-filled
__device__ __forceinline__ void stage(float* dst, int stride,
                                      const float* __restrict__ src, int r0,
                                      int n, int d, int k0, int rows,
                                      int width, bool vec, int tid) {
  if (vec) {
    const int q = width / 4;
    for (int e = tid; e < rows * q; e += kThreads) {
      const int r = e / q, k = k0 + (e - r * q) * 4;
      const bool in = r0 + r < n && k < d;
      cp_async16(dst + r * stride + (k - k0),
                 in ? src + (size_t)(r0 + r) * d + k : src, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < rows * width; e += kThreads) {
      const int r = e / width, k = k0 + (e - r * width);
      const bool in = r0 + r < n && k < d;
      cp_async4(dst + r * stride + (k - k0),
                in ? src + (size_t)(r0 + r) * d + k : src, in ? 4 : 0);
    }
  }
}

// q += the squares of depths k0 .. k0 + kHalf - 1 of a row in device
// memory, in order; depths past d add nothing (as the zero-filled staged
// depths do)
__device__ __forceinline__ float sq_half_global(const float* row, int k0,
                                                int d, float q) {
#pragma unroll 8
  for (int k = k0; k < k0 + kHalf; ++k)
    if (k < d) q = fmaf(row[k], row[k], q);
  return q;
}

template <int kMode, bool kStream>
__global__ void __launch_bounds__(kThreads, 2)
knn2_l2_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const unsigned char* __restrict__ valid2,
               const float* __restrict__ pred, const float* __restrict__ rad2,
               const float* __restrict__ pts2, int n1, int n2, int d,
               int cols_per_split, bool vec, float* __restrict__ d_best,
               float* __restrict__ d_second, int* __restrict__ idx) {
  extern __shared__ __align__(16) float smem[];
  // query rows: [kRows][sa] at full depth, or [kStages][kRows][sa] chunks
  const int sa = kStream ? kChunkStride : a_stride(d);
  float* s_a = smem;
  float* s_b = s_a + a_floats(d, kStream);            // [kStages][kCols][68]
  float* s_sq1 = s_b + kStages * kCols * kChunkStride;
  float* s_qx = s_sq1 + kRows;
  float* s_qy = s_qx + kRows;
  float* s_qr2 = s_qy + kRows;
  float* s_m1 = s_qr2 + kRows;
  float* s_m2 = s_m1 + kRows;
  int* s_i1 = reinterpret_cast<int*>(s_m2 + kRows);
  float* s_sq2 = reinterpret_cast<float*>(s_i1 + kRows);
  float* s_pen = s_sq2 + kCols;
  float* s_x = s_pen + kCols;
  float* s_y = s_x + kCols;
  float* s_r2 = s_y + kCols;

  const int tid = threadIdx.x;
  const int tx = tid % kColGroups;  // columns tx + kColGroups j of a tile
  const int ty = tid / kColGroups;  // rows ty + kRowGroups i of the block
  const int nr = tid >> 1;  // the row, and the tile's column, whose norm
  const int nh = tid & 1;   // half this thread sums
  const int row0 = blockIdx.x * kRows;
  const int cbeg = min(n2, (int)blockIdx.y * cols_per_split);
  const int cend = min(n2, cbeg + cols_per_split);
  const int n_kc = (d + kDepth - 1) / kDepth;
  const int n_tiles = (cend - cbeg + kCols - 1) / kCols;
  const int n_steps = n_tiles * n_kc;

  // step s = (tile s / n_kc, chunk s % n_kc) -> ring slot s % kStages
  auto load_chunk = [&](int s) {
    if (s < n_steps) {
      const int tile = s / n_kc, kc = s - tile * n_kc;
      stage(s_b + (s % kStages) * kCols * kChunkStride, kChunkStride, b,
            cbeg + tile * kCols, cend, d, kc * kDepth, kCols, kDepth, vec,
            tid);
      if (kStream)
        stage(s_a + (s % kStages) * kRows * kChunkStride, kChunkStride, a,
              row0, n1, d, kc * kDepth, kRows, kDepth, vec, tid);
    }
    cp_async_commit();
  };

  if (n_steps > 0 && !kStream)
    stage(s_a, sa, a, row0, n1, d, 0, kRows, sa - 4, vec, tid);
  load_chunk(0);
  load_chunk(1);
  if (kStream && n_steps > 0 && nr < kRows) {
    // row norms in the columns' order: each half over every chunk, then
    // added; rows past n1 are zero (staged as zeros, never written out)
    float q = 0.0f;
    if (row0 + nr < n1) {
      const float* row = a + (size_t)(row0 + nr) * d;
      for (int k = nh * kHalf; k < n_kc * kDepth; k += kDepth)
        q = sq_half_global(row, k, d, q);
    }
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    if (nh == 0) s_sq1[nr] = q;
  }
  if (tid < kRows && kMode != 0) {
    const int row = min(row0 + tid, n1 - 1);
    s_qx[tid] = pred[2 * row];
    s_qy[tid] = pred[2 * row + 1];
    s_qr2[tid] = kMode == 1 ? rad2[row] : 0.0f;
  }

  float acc[kTm][kTn];
#pragma unroll
  for (int i = 0; i < kTm; ++i)
#pragma unroll
    for (int j = 0; j < kTn; ++j) acc[i][j] = 0.0f;
  float b1[kTm], b2[kTm];
  int i1[kTm];
#pragma unroll
  for (int i = 0; i < kTm; ++i) {
    b1[i] = kBig;
    b2[i] = kBig;
    i1[i] = -1;
  }
  // column nr of the current tile: this thread's half of its norm, and
  // (nh == 0) its validity and gate values, loaded at the tile's first
  // chunk and published at its last
  float c_sq = 0.0f, c_x = 0.0f, c_y = 0.0f, c_r2 = 0.0f;
  bool c_valid = false;

  for (int s = 0; s < n_steps; ++s) {
    const int tile = s / n_kc, kc = s - tile * n_kc;
    const int c0 = cbeg + tile * kCols;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk s (and at s = 0 the query tile) has landed
    load_chunk(s + kStages - 1);
    if (!kStream && s == 0 && nr < kRows) {  // row norms, columns' order
      float q = 0.0f;
      for (int k = nh * kHalf; k < sa - 4; k += kDepth)
        q = sq_half(s_a + nr * sa + k, q);
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      if (nh == 0) s_sq1[nr] = q;
    }
    if (kc == 0 && nr < kCols) {
      const int col = c0 + nr;
      const bool in = col < cend && nh == 0;
      c_sq = 0.0f;
      c_valid = in && valid2[col];
      if (kMode != 0) {
        c_x = in ? pts2[2 * col] : 0.0f;
        c_y = in ? pts2[2 * col + 1] : 0.0f;
        if (kMode == 2) c_r2 = in ? rad2[col] : 0.0f;
      }
    }

    const float* ca = kStream ? s_a + (s % kStages) * kRows * kChunkStride
                              : s_a + kc * kDepth;
    const float* cb = s_b + (s % kStages) * kCols * kChunkStride;
    if (nr < kCols) c_sq = sq_half(cb + nr * kChunkStride + nh * kHalf, c_sq);
#pragma unroll
    for (int k = 0; k < kDepth; k += 4) {
      float4 av[kTm], bv[kTn];
#pragma unroll
      for (int i = 0; i < kTm; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            ca + (ty + kRowGroups * i) * sa + k);
#pragma unroll
      for (int j = 0; j < kTn; ++j)
        bv[j] = *reinterpret_cast<const float4*>(
            cb + (tx + kColGroups * j) * kChunkStride + k);
      // one depth at a time over the whole register tile
#pragma unroll
      for (int i = 0; i < kTm; ++i)
#pragma unroll
        for (int j = 0; j < kTn; ++j)
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < kTm; ++i)
#pragma unroll
        for (int j = 0; j < kTn; ++j)
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < kTm; ++i)
#pragma unroll
        for (int j = 0; j < kTn; ++j)
          acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < kTm; ++i)
#pragma unroll
        for (int j = 0; j < kTn; ++j)
          acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
    }

    if (kc == n_kc - 1) {  // the tile is summed: epilogue
      const float q = c_sq + __shfl_xor_sync(0xffffffffu, c_sq, 1);
      if (nh == 0 && nr < kCols) {
        s_sq2[nr] = q;
        s_pen[nr] = c_valid ? 0.0f : kBig;
        if (kMode != 0) {
          s_x[nr] = c_x;
          s_y[nr] = c_y;
          s_r2[nr] = c_r2;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        const int c = tx + kColGroups * j;
        const int col = c0 + c;
        if (col < cend) {
          const float sq2 = s_sq2[c];
          const float pen = s_pen[c];
#pragma unroll
          for (int i = 0; i < kTm; ++i) {
            const int r = ty + kRowGroups * i;
            float dist = fmaxf(
                fmaf(-2.0f, acc[i][j], __fadd_rn(s_sq1[r], sq2)), 0.0f);
            dist = __fadd_rn(dist, pen);
            if (kMode != 0) {
              const float dx = __fsub_rn(s_qx[r], s_x[c]);
              const float dy = __fsub_rn(s_qy[r], s_y[c]);
              const float dd =
                  __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
              const float r2 = kMode == 1 ? s_qr2[r] : s_r2[c];
              if (!(dd <= r2)) dist = __fadd_rn(dist, kBig);
            }
            // columns arrive in increasing order: an equal dist keeps the
            // lower column already held
            b2[i] = fminf(b2[i], fmaxf(b1[i], dist));
            if (dist < b1[i]) {
              b1[i] = dist;
              i1[i] = col;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kTm; ++i)
#pragma unroll
        for (int j = 0; j < kTn; ++j) acc[i][j] = 0.0f;
    }
  }
  cp_async_wait<0>();

  // merge the kColGroups threads of each row group (neighbouring lanes of
  // one warp), which hold disjoint columns
#pragma unroll
  for (int i = 0; i < kTm; ++i) {
#pragma unroll
    for (int off = kColGroups / 2; off > 0; off >>= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, b1[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, i1[i], off);
      const float o2 = __shfl_xor_sync(0xffffffffu, b2[i], off);
      merge(o1, oi, o2, b1[i], i1[i], b2[i]);
    }
    if (tx == 0) {
      s_m1[ty + kRowGroups * i] = b1[i];
      s_i1[ty + kRowGroups * i] = i1[i];
      s_m2[ty + kRowGroups * i] = b2[i];
    }
  }

  // merge the cluster's column slices through distributed shared memory:
  // block r of the cluster finishes rows r, r + splits, ... of the 64
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)gridDim.y;
  cluster.sync();
  const int lr = (int)cluster.block_rank() + splits * tid;
  if (lr < kRows) {
    float m1 = kBig, m2 = kBig;
    int mi = -1;
    for (int q = 0; q < splits; ++q)
      merge(cluster.map_shared_rank(s_m1, q)[lr],
            cluster.map_shared_rank(s_i1, q)[lr],
            cluster.map_shared_rank(s_m2, q)[lr], m1, mi, m2);
    const int row = row0 + lr;
    if (row < n1) {
      d_best[row] = m1;
      d_second[row] = m2;
      idx[row] = mi;
    }
  }
  cluster.sync();  // keep every block's s_m1 / s_i1 / s_m2 alive until read
}

// What fits on the card at once for one kernel and shared-memory size:
// clusters of 1..8 blocks, and blocks per SM. Asked of the occupancy
// calculator once per (device, xy_mode, shared memory) and kept.
struct Fit {
  const void* kernel = nullptr;
  int dev = -1, mode = -1, smem = 0;
  int per_sm = 0;
  int clusters[kMaxSplits + 1] = {};
};

cudaError_t fit_for(const void* kernel, int mode, int smem, Fit* out) {
  static Fit cache[16];
  static int next = 0;
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (const Fit& f : cache)
    if (f.kernel == kernel && f.dev == dev && f.mode == mode &&
        f.smem == smem) {
      *out = f;
      return cudaSuccess;
    }
  // one opt-in for every depth: the attribute is one value per kernel
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  Fit f;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  for (int s = 1; s <= kMaxSplits; ++s) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, s);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = s;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&f.clusters[s], kernel, &cfg);
    if (err != cudaSuccess) return err;
  }
  f.kernel = kernel;
  f.dev = dev;
  f.mode = mode;
  f.smem = smem;
  cache[next] = f;
  next = (next + 1) % 16;
  *out = f;
  return cudaSuccess;
}

// Column slices per row block: the count that puts the least work on the
// busiest SM. A block's work is its whole 64-column tiles; the grid runs
// in waves of the clusters that fit, a wave spread over the SMs they
// occupy; an SM with one block counts as two, since a lone block cannot
// keep its FMA pipes busy. Among equals, the most slices.
int choose_splits(const Fit& f, int row_blocks, int n2) {
  int best = 1;
  long long best_cost = -1;
  const int per_sm = f.per_sm > 0 ? f.per_sm : 1;
  for (int s = kMaxSplits; s >= 1; --s) {
    if (f.clusters[s] < 1) continue;
    const long long blocks = (long long)row_blocks * s;
    const long long resident = (long long)f.clusters[s] * s;
    const long long sms = resident / per_sm > 0 ? resident / per_sm : 1;
    const long long waves = (blocks + resident - 1) / resident;
    const long long in_wave = blocks < resident ? blocks : resident;
    long long per_sm_wave = (in_wave + sms - 1) / sms;
    if (per_sm_wave < 2) per_sm_wave = 2;
    const long long cols = (n2 + s - 1) / s;
    const long long tiles = cols > kCols ? (cols + kCols - 1) / kCols : 1;
    const long long cost = waves * per_sm_wave * tiles;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  return best;
}

template <int kMode, bool kStream>
cudaError_t launch(const void* desc1, const void* desc2, const void* valid2,
                   const void* pred, const void* rad2, const void* pts2,
                   int n1, int n2, int d, float* d_best, float* d_second,
                   int* idx, cudaStream_t stream) {
  const int smem = smem_bytes(d, kStream);
  Fit fit;
  const cudaError_t err = fit_for(
      (const void*)knn2_l2_kernel<kMode, kStream>, kMode, smem, &fit);
  if (err != cudaSuccess) return err;
  const int row_blocks = (n1 + kRows - 1) / kRows;
  const int splits = choose_splits(fit, row_blocks, n2);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_blocks, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int cols_per_split = (n2 + splits - 1) / splits;
  const bool vec = d % 4 == 0 && (size_t)desc1 % 16 == 0 &&
                   (size_t)desc2 % 16 == 0;
  return cudaLaunchKernelEx(
      &cfg, knn2_l2_kernel<kMode, kStream>, static_cast<const float*>(desc1),
      static_cast<const float*>(desc2),
      static_cast<const unsigned char*>(valid2),
      static_cast<const float*>(pred), static_cast<const float*>(rad2),
      static_cast<const float*>(pts2), n1, n2, d, cols_per_split, vec,
      d_best, d_second, idx);
}

template <bool kStream>
cudaError_t dispatch(const void* desc1, const void* desc2, const void* valid2,
                     const void* pred, const void* rad2, const void* pts2,
                     int n1, int n2, int d, int xy_mode, float* d_best,
                     float* d_second, int* idx, cudaStream_t stream) {
  if (xy_mode == 0)
    return launch<0, kStream>(desc1, desc2, valid2, pred, rad2, pts2, n1, n2,
                              d, d_best, d_second, idx, stream);
  if (xy_mode == 1)
    return launch<1, kStream>(desc1, desc2, valid2, pred, rad2, pts2, n1, n2,
                              d, d_best, d_second, idx, stream);
  return launch<2, kStream>(desc1, desc2, valid2, pred, rad2, pts2, n1, n2,
                            d, d_best, d_second, idx, stream);
}

}  // namespace

extern "C" {

// desc1 (n1, d), desc2 (n2, d) float32 row-major; valid2 (n2,) bool;
// xy_mode 0: pred, rad2, pts2 unused (may be null); 1: pred (n1, 2),
// rad2 (n1,), pts2 (n2, 2); 2: pred (n1, 2), rad2 (n2,), pts2 (n2, 2).
// n1 >= 1, 0 <= n2 <= 2^30, d >= 1 (past 640 the query tile streams).
// The column sweep is cut into 1-8 slices, one cluster per 64 query
// rows. Outputs (n1,) float32, float32, int32. One launch on `stream`;
// returns its cudaError_t (0 on success).
int knn2_l2_launch(const void* desc1, const void* desc2, const void* valid2,
                   const void* pred, const void* rad2, const void* pts2,
                   int n1, int n2, int d, int xy_mode, void* d_best,
                   void* d_second, void* idx, void* stream) {
  if (n1 < 1 || n2 < 0 || n2 > (1 << 30) || d < 1 || xy_mode < 0 ||
      xy_mode > 2)
    return (int)cudaErrorInvalidValue;
  auto* db = static_cast<float*>(d_best);
  auto* ds = static_cast<float*>(d_second);
  auto* ix = static_cast<int*>(idx);
  auto s = (cudaStream_t)stream;
  const cudaError_t err =
      d > kMaxTileDepth
          ? dispatch<true>(desc1, desc2, valid2, pred, rad2, pts2, n1, n2, d,
                           xy_mode, db, ds, ix, s)
          : dispatch<false>(desc1, desc2, valid2, pred, rad2, pts2, n1, n2, d,
                            xy_mode, db, ds, ix, s);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

const char* knn2_l2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
