// Fused binary 2-NN search with an optional radius gate.
//
// Replaces the packed binary body of the Pallas TPU kernel
// matchinglib_poselib_tpu/ops/pallas/knn.py (knn2, kernel body
// _knn2_kernel_packed). For every query row: the Hamming distance to every
// candidate (popcount of the XOR of the 8 descriptor words), the candidate
// validity penalty and, for xy_mode 1 (radius per query) or 2 (radius per
// candidate), the gate |pred_i - pts2_j|^2 <= r^2. The pair (distance,
// column) rides in one 64-bit key, so a running min and a masked second
// min give the best distance, its column (lowest column on ties) and the
// second-best distance, exactly like the TPU body's packed f32 key, but
// with no 2^24 bound on the column count. Output: d_best, d_second as
// float (1e9 when no candidate is valid and inside the gate) and idx
// (-1 then), bit-identical to the plain version in ops/kernels/knn2.py.
//
// What bounds it on an H100: integer ALU. At N1 = N2 = 2048 and 256-bit
// descriptors it is 33.5 M XOR + popcount pairs and 4.2 M key updates;
// its inputs (2 x 64 KB of descriptors) sit in L2, so device memory moves
// almost nothing. Design: candidates are staged in shared memory in tiles
// of 256, stored word-major so that 32 lanes reading 32 consecutive
// candidates hit 32 banks; each warp keeps two query rows in registers,
// every lane scans a strided subset of the tile, and the lanes' running
// (min, second min) keys merge with warp shuffles at the end. The gate
// uses round-to-nearest multiplies and adds with no FMA contraction, so it
// decides exactly as the plain version's separate ops do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;            // 256-bit descriptors
constexpr int kWarps = 8;
constexpr int kQueriesPerWarp = 2;
constexpr int kTile = 256;           // candidates per shared-memory tile
constexpr int kThreads = kWarps * 32;
constexpr unsigned long long kPenalty = 1ull << 16;  // invalid or gated
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ void push(unsigned long long k,
                                     unsigned long long& m1,
                                     unsigned long long& m2) {
  if (k < m1) {
    m2 = m1;
    m1 = k;
  } else if (k < m2) {
    m2 = k;
  }
}

__global__ void __launch_bounds__(kThreads)
knn2_kernel(const int* __restrict__ desc1, const int* __restrict__ desc2,
            const unsigned char* __restrict__ valid2,
            const float* __restrict__ pred, const float* __restrict__ rad2,
            const float* __restrict__ pts2, int n1, int n2, int xy_mode,
            float* __restrict__ d_best, float* __restrict__ d_second,
            int* __restrict__ idx) {
  __shared__ unsigned int s_desc[kWords][kTile];
  __shared__ float s_x[kTile];
  __shared__ float s_y[kTile];
  __shared__ float s_r2[kTile];
  __shared__ unsigned char s_valid[kTile];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = (blockIdx.x * kWarps + warp) * kQueriesPerWarp;

  unsigned int qd[kQueriesPerWarp][kWords];
  float qx[kQueriesPerWarp], qy[kQueriesPerWarp], qr2[kQueriesPerWarp];
  unsigned long long m1[kQueriesPerWarp], m2[kQueriesPerWarp];
#pragma unroll
  for (int q = 0; q < kQueriesPerWarp; ++q) {
    const int row = min(q0 + q, n1 - 1);
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      qd[q][w] = (unsigned int)desc1[(size_t)row * kWords + w];
    qx[q] = xy_mode ? pred[2 * row] : 0.0f;
    qy[q] = xy_mode ? pred[2 * row + 1] : 0.0f;
    qr2[q] = xy_mode == 1 ? rad2[row] : 0.0f;
    m1[q] = kNone;
    m2[q] = kNone;
  }

  for (int j0 = 0; j0 < n2; j0 += kTile) {
    const int tn = min(kTile, n2 - j0);
    for (int i = threadIdx.x; i < tn * kWords; i += blockDim.x) {
      const int j = i / kWords;
      const int w = i - j * kWords;
      s_desc[w][j] = (unsigned int)desc2[(size_t)(j0 + j) * kWords + w];
    }
    for (int j = threadIdx.x; j < tn; j += blockDim.x) {
      s_valid[j] = valid2[j0 + j];
      if (xy_mode) {
        s_x[j] = pts2[2 * (j0 + j)];
        s_y[j] = pts2[2 * (j0 + j) + 1];
        s_r2[j] = xy_mode == 2 ? rad2[j0 + j] : 0.0f;
      }
    }
    __syncthreads();

    for (int j = lane; j < tn; j += 32) {
      unsigned int cd[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) cd[w] = s_desc[w][j];
      const unsigned long long base_pen = s_valid[j] ? 0ull : kPenalty;
      const unsigned long long col = (unsigned long long)(j0 + j);
#pragma unroll
      for (int q = 0; q < kQueriesPerWarp; ++q) {
        int ham = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) ham += __popc(qd[q][w] ^ cd[w]);
        unsigned long long pen = base_pen;
        if (xy_mode) {
          const float dx = __fsub_rn(qx[q], s_x[j]);
          const float dy = __fsub_rn(qy[q], s_y[j]);
          const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          const float r2 = xy_mode == 1 ? qr2[q] : s_r2[j];
          if (!(d2 <= r2)) pen += kPenalty;
        }
        push((((unsigned long long)ham + pen) << 32) | col, m1[q], m2[q]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < kQueriesPerWarp; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o1 = __shfl_xor_sync(0xffffffffu, m1[q], off);
      const unsigned long long o2 = __shfl_xor_sync(0xffffffffu, m2[q], off);
      const unsigned long long lo = m1[q] < o1 ? m1[q] : o1;
      const unsigned long long hi = m1[q] < o1 ? o1 : m1[q];
      const unsigned long long s2 = m2[q] < o2 ? m2[q] : o2;
      m1[q] = lo;
      m2[q] = hi < s2 ? hi : s2;
    }
    const int row = q0 + q;
    if (lane == 0 && row < n1) {
      const unsigned long long h1 = m1[q] >> 32;
      const unsigned long long h2 = m2[q] >> 32;
      const bool ok1 = h1 < kPenalty;
      d_best[row] = ok1 ? (float)h1 : 1e9f;
      idx[row] = ok1 ? (int)(m1[q] & 0xffffffffull) : -1;
      d_second[row] = h2 < kPenalty ? (float)h2 : 1e9f;
    }
  }
}

}  // namespace

extern "C" {

// desc1 (n1, 8), desc2 (n2, 8) int32 bit patterns; valid2 (n2,) bool;
// xy_mode 0: pred, rad2, pts2 unused (may be null); 1: pred (n1, 2),
// rad2 (n1,), pts2 (n2, 2); 2: pred (n1, 2), rad2 (n2,), pts2 (n2, 2).
// Outputs (n1,) float32, float32, int32. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int knn2_launch(const void* desc1, const void* desc2, const void* valid2,
                const void* pred, const void* rad2, const void* pts2, int n1,
                int n2, int xy_mode, void* d_best, void* d_second, void* idx,
                void* stream) {
  const int rows_per_block = kWarps * kQueriesPerWarp;
  dim3 grid((n1 + rows_per_block - 1) / rows_per_block);
  knn2_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(desc1), static_cast<const int*>(desc2),
      static_cast<const unsigned char*>(valid2),
      static_cast<const float*>(pred), static_cast<const float*>(rad2),
      static_cast<const float*>(pts2), n1, n2, xy_mode,
      static_cast<float*>(d_best), static_cast<float*>(d_second),
      static_cast<int*>(idx));
  return (int)cudaGetLastError();
}

const char* knn2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
