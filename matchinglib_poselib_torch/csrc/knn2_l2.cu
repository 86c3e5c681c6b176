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
// Everything is true fp32: no TF32, no bf16.
//
// What bounds it on an H100: fp32 arithmetic. At N1 = N2 = 2048 and
// D = 128 the products are 2 N1 N2 D = 1.07 GFLOP, 16 us at 67 TFLOP/s
// (8 us at D = 64), against 2.1 MB of input, 0.6 us at 3.35 TB/s.
// Design: a block owns 64 query rows and one slice of the candidate
// columns (the column sweep is split across blocks so that 2048 rows give
// >= 2 blocks per SM), and sweeps the slice in 64-column tiles. Per
// 16-deep chunk of D the two sub-tiles are staged in shared memory; each
// of 256 threads keeps a 4 x 4 register tile of dot products and adds
// to it with FFMA in the same order over D for every pair, so duplicate
// candidates give bit-identical distances. Row and column norms are
// computed in the block, one warp per row, in a fixed order. The epilogue
// applies norms, penalty and gate (round-to-nearest intrinsics: no FMA
// contraction moves a decision) and updates per-thread (dist, column)
// top-2 pairs; the 16 threads of a row merge with shuffles, and a second
// small kernel merges the slices' pairs per row. The tiles are fed by
// plain loads and FFMA, not by TMA and wgmma: fp32 on the CUDA cores is
// the semantics asked for, and the tensor cores have no fp32 mode.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;          // query rows per block
constexpr int kBN = 64;          // candidate columns per tile
constexpr int kBK = 16;          // depth of one shared-memory chunk
constexpr int kPad = 4;          // row padding of the A chunk (banks)
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 pairs each
constexpr float kBig = 1e9f;

// (d, c) < (bd, bc) lexicographically
__device__ __forceinline__ bool better(float d, int c, float bd, int bc) {
  return d < bd || (d == bd && c < bc);
}

// add candidate (d, c) to the running (b1, i1, b2)
__device__ __forceinline__ void push(float d, int c, float& b1, int& i1,
                                     float& b2) {
  if (better(d, c, b1, i1)) {
    b2 = b1;
    b1 = d;
    i1 = c;
  } else {
    b2 = fminf(b2, d);
  }
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

// squared norm of one row of length d, by one warp, in a fixed order;
// every lane returns the same value
__device__ __forceinline__ float warp_sqnorm(const float* __restrict__ row,
                                             int d, int lane) {
  float s = 0.0f;
  for (int k = lane; k < d; k += 32) s = fmaf(row[k], row[k], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

__global__ void __launch_bounds__(kThreads)
knn2_l2_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const unsigned char* __restrict__ valid2,
               const float* __restrict__ pred, const float* __restrict__ rad2,
               const float* __restrict__ pts2, int n1, int n2, int d,
               int xy_mode, int cols_per_split, float* __restrict__ part_d1,
               int* __restrict__ part_i1, float* __restrict__ part_d2) {
  __shared__ __align__(16) float s_a[kBK][kBM + kPad];
  __shared__ __align__(16) float s_b[kBK][kBN + kPad];
  __shared__ float s_sq1[kBM];
  __shared__ float s_sq2[kBN];
  __shared__ float s_pen[kBN];
  __shared__ float s_x[kBN], s_y[kBN], s_r2[kBN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group: columns tx*4 .. tx*4+3
  const int ty = tid >> 4;  // row group: rows ty*4 .. ty*4+3
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kBM;
  const int cbeg = blockIdx.y * cols_per_split;
  const int cend = min(n2, cbeg + cols_per_split);

  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = row0 + r;
    const float s = row < n1 ? warp_sqnorm(a + (size_t)row * d, d, lane)
                             : 0.0f;
    if (lane == 0) s_sq1[r] = s;
  }
  float qx[4], qy[4], qr2[4];
  float b1[4], b2[4];
  int i1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = min(row0 + ty * 4 + i, n1 - 1);
    qx[i] = xy_mode ? pred[2 * row] : 0.0f;
    qy[i] = xy_mode ? pred[2 * row + 1] : 0.0f;
    qr2[i] = xy_mode == 1 ? rad2[row] : 0.0f;
    b1[i] = kBig;
    b2[i] = kBig;
    i1[i] = -1;
  }

  // chunk loaders: thread t stages 4 consecutive depths of one row
  const int lr = tid >> 2;         // row / column within the tile, 0..63
  const int lk = (tid & 3) * 4;    // first depth within the chunk

  for (int c0 = cbeg; c0 < cend; c0 += kBN) {
    __syncthreads();  // previous tile's epilogue is done with s_*
    for (int c = warp; c < kBN; c += kThreads / 32) {
      const int col = c0 + c;
      const float s = col < cend ? warp_sqnorm(b + (size_t)col * d, d, lane)
                                 : 0.0f;
      if (lane == 0) s_sq2[c] = s;
    }
    if (tid < kBN) {
      const int col = c0 + tid;
      const bool in = col < cend;
      s_pen[tid] = in && valid2[col] ? 0.0f : kBig;
      if (xy_mode) {
        s_x[tid] = in ? pts2[2 * col] : 0.0f;
        s_y[tid] = in ? pts2[2 * col + 1] : 0.0f;
        s_r2[tid] = in && xy_mode == 2 ? rad2[col] : 0.0f;
      }
    }

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += kBK) {
      {
        const int row = row0 + lr;
        const int col = c0 + lr;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int k = k0 + lk + m;
          s_a[lk + m][lr] =
              row < n1 && k < d ? a[(size_t)row * d + k] : 0.0f;
          s_b[lk + m][lr] =
              col < cend && k < d ? b[(size_t)col * d + k] : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&s_a[k][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&s_b[k][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j;
      const int col = c0 + c;
      if (col >= cend) continue;
      const float sq2 = s_sq2[c];
      const float pen = s_pen[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        float dist = fmaxf(
            __fsub_rn(__fadd_rn(s_sq1[r], sq2), __fmul_rn(2.0f, acc[i][j])),
            0.0f);
        dist = __fadd_rn(dist, pen);
        if (xy_mode) {
          const float dx = __fsub_rn(qx[i], s_x[c]);
          const float dy = __fsub_rn(qy[i], s_y[c]);
          const float dd = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          const float r2 = xy_mode == 1 ? qr2[i] : s_r2[c];
          if (!(dd <= r2)) dist = __fadd_rn(dist, kBig);
        }
        push(dist, col, b1[i], i1[i], b2[i]);
      }
    }
  }

  // merge the 16 threads of each row (lanes of one half-warp)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, b1[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, i1[i], off);
      const float o2 = __shfl_xor_sync(0xffffffffu, b2[i], off);
      merge(o1, oi, o2, b1[i], i1[i], b2[i]);
    }
    const int row = row0 + ty * 4 + i;
    if (tx == 0 && row < n1) {
      const size_t o = (size_t)blockIdx.y * n1 + row;
      part_d1[o] = b1[i];
      part_i1[o] = i1[i];
      part_d2[o] = b2[i];
    }
  }
}

// merge the per-slice pairs of every row into the outputs
__global__ void knn2_l2_merge_kernel(const float* __restrict__ part_d1,
                                     const int* __restrict__ part_i1,
                                     const float* __restrict__ part_d2,
                                     int n1, int splits,
                                     float* __restrict__ d_best,
                                     float* __restrict__ d_second,
                                     int* __restrict__ idx) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n1) return;
  float b1 = kBig, b2 = kBig;
  int i1 = -1;
  for (int s = 0; s < splits; ++s) {
    const size_t o = (size_t)s * n1 + row;
    merge(part_d1[o], part_i1[o], part_d2[o], b1, i1, b2);
  }
  d_best[row] = b1;
  d_second[row] = b2;
  idx[row] = i1;
}

}  // namespace

extern "C" {

// desc1 (n1, d), desc2 (n2, d) float32 row-major; valid2 (n2,) bool;
// xy_mode 0: pred, rad2, pts2 unused (may be null); 1: pred (n1, 2),
// rad2 (n1,), pts2 (n2, 2); 2: pred (n1, 2), rad2 (n2,), pts2 (n2, 2).
// The column sweep is cut into `splits` slices of `cols_per_split`
// columns (a multiple of 64); part_* are (splits, n1) scratch. Outputs
// (n1,) float32, float32, int32. Launches both kernels on `stream` and
// returns cudaGetLastError() (0 on success).
int knn2_l2_launch(const void* desc1, const void* desc2, const void* valid2,
                   const void* pred, const void* rad2, const void* pts2,
                   int n1, int n2, int d, int xy_mode, int splits,
                   int cols_per_split, void* part_d1, void* part_i1,
                   void* part_d2, void* d_best, void* d_second, void* idx,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((n1 + kBM - 1) / kBM, splits);
  knn2_l2_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(desc1), static_cast<const float*>(desc2),
      static_cast<const unsigned char*>(valid2),
      static_cast<const float*>(pred), static_cast<const float*>(rad2),
      static_cast<const float*>(pts2), n1, n2, d, xy_mode, cols_per_split,
      static_cast<float*>(part_d1), static_cast<int*>(part_i1),
      static_cast<float*>(part_d2));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn2_l2_merge_kernel<<<(n1 + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_d1), static_cast<const int*>(part_i1),
      static_cast<const float*>(part_d2), n1, splits,
      static_cast<float*>(d_best), static_cast<float*>(d_second),
      static_cast<int*>(idx));
  return (int)cudaGetLastError();
}

const char* knn2_l2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
