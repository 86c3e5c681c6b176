// Fused FAST-9/16 corner score + (2r+1)^2 non-maximum suppression.
//
// Replaces the Pallas TPU kernel matchinglib_poselib_tpu/ops/pallas/fast.py
// (fast_nms_score_batch, kernel body _kernel). Same arithmetic as the plain
// PyTorch version nms(fast_score(img, t), r) in ops/features.py: the 16
// ring differences d = I(p-o) - I(p) in ring order, the bright/dark relu
// sums accumulated in that order, the >= 9 contiguous-arc test as a packed
// run-length reduction (wrap-doubled word, 8 rounds of w &= w >> 1), score
// = max(bright, dark) on a corner else 0, then keep score >= window max
// and score > 0 (ties kept). Pixels outside the image read as 0, like the
// Pallas kernel's zero padding (the plain version wraps instead; the two
// differ only within r + 3 pixels of the border, which keypoint selection
// discards).
//
// What bounds it on an H100: device memory, one f32 read and one f32 write
// per pixel (5.7 MB for a 1392x512 pair at 3.35 TB/s is ~2 us), plus ~100
// ALU ops per pixel for the ring test. Design: one block per (image,
// 64x32 output tile). The tile plus a halo of 3 + r pixels is staged in
// shared memory once, so every ring sample and every window sample is a
// shared-memory read, never a second trip to device memory. Pass 1 scores
// the tile and the r-pixel ring the NMS needs; pass 2 takes the window max
// separably (row max, then column max) in shared memory. r is a runtime
// argument: the halo, and so the dynamic shared memory, is sized from it.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out,
                int H, int W, float t, int r) {
  extern __shared__ float smem[];
  const int halo = 3 + r;
  const int iw = kTileW + 2 * halo;  // image tile
  const int ih = kTileH + 2 * halo;
  const int sw = kTileW + 2 * r;     // score tile
  const int sh = kTileH + 2 * r;
  float* tile = smem;
  float* score = smem + ih * iw;

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const float* im = img + (size_t)b * H * W;

  for (int i = threadIdx.x; i < ih * iw; i += blockDim.x) {
    const int ly = i / iw;
    const int lx = i - ly * iw;
    const int gy = y0 - halo + ly;
    const int gx = x0 - halo + lx;
    tile[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? im[(size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  // ring offsets (dy, dx), radius 3, in the order of features.FAST_RING.
  // The plain version takes roll(img, (dy, dx)) - img, which samples
  // I(p - o): the kernel reads the same pixel in the same order, so the
  // relu sums accumulate identically (the Pallas kernel reads I(p + o),
  // which differs from its XLA reference in the last ulp).
  const int ring_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                           3, 3, 2, 1, 0, -1, -2, -3};
  const int ring_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                           0, -1, -2, -3, -3, -3, -2, -1};
  for (int i = threadIdx.x; i < sh * sw; i += blockDim.x) {
    const int sy = i / sw;
    const int sx = i - sy * sw;
    const float* c = tile + (sy + 3) * iw + (sx + 3);
    const float v = c[0];
    float sb = 0.0f;
    float sd = 0.0f;
    unsigned wb = 0u;
    unsigned wd = 0u;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const float d = c[-ring_dy[s] * iw - ring_dx[s]] - v;
      sb = sb + fmaxf(d - t, 0.0f);
      sd = sd + fmaxf(-d - t, 0.0f);
      wb |= (d > t ? 1u : 0u) << s;
      wd |= (d < -t ? 1u : 0u) << s;
    }
    unsigned yb = wb | (wb << 16);
    unsigned yd = wd | (wd << 16);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      yb &= yb >> 1;
      yd &= yd >> 1;
    }
    const bool corner = ((yb & 0xFFFFu) != 0u) || ((yd & 0xFFFFu) != 0u);
    score[i] = corner ? fmaxf(sb, sd) : 0.0f;
  }
  __syncthreads();

  // separable window max; the image tile is dead now and holds row maxima
  float* rowmax = tile;
  for (int i = threadIdx.x; i < sh * kTileW; i += blockDim.x) {
    const int y = i / kTileW;
    const int x = i - y * kTileW;
    const float* row = score + y * sw + x;
    float m = row[0];
    for (int k = 1; k <= 2 * r; ++k) m = fmaxf(m, row[k]);
    rowmax[i] = m;
  }
  __syncthreads();

  float* o = out + (size_t)b * H * W;
  for (int i = threadIdx.x; i < kTileH * kTileW; i += blockDim.x) {
    const int y = i / kTileW;
    const int x = i - y * kTileW;
    const int gy = y0 + y;
    const int gx = x0 + x;
    if (gy >= H || gx >= W) continue;
    float m = rowmax[y * kTileW + x];
    for (int k = 1; k <= 2 * r; ++k) m = fmaxf(m, rowmax[(y + k) * kTileW + x]);
    const float s = score[(y + r) * sw + (x + r)];
    o[(size_t)gy * W + gx] = (s >= m && s > 0.0f) ? s : 0.0f;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for NMS radius r (bytes).
long long fast_nms_smem_bytes(int r) {
  const long long halo = 3 + r;
  return ((kTileH + 2 * halo) * (kTileW + 2 * halo) +
          (long long)(kTileH + 2 * r) * (kTileW + 2 * r)) *
         (long long)sizeof(float);
}

// imgs, out: (B, H, W) contiguous float32 on the device. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int fast_nms_launch(const void* imgs, void* out, int B, int H, int W,
                    float threshold, int radius, void* stream) {
  const long long smem = fast_nms_smem_bytes(radius);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fast_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  fast_nms_kernel<<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(imgs), static_cast<float*>(out), H, W,
      threshold, radius);
  return (int)cudaGetLastError();
}

const char* fast_nms_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
