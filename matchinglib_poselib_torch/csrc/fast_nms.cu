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
// Pallas kernel's zero padding: the kernel equals the plain version of the
// image zero-padded by 3 + r, cropped back, at every pixel (the plain
// version of the unpadded image wraps, and differs within r + 3 pixels of
// the border, which keypoint selection discards).
//
// What bounds it on an H100: not device memory (one f32 read and one f32
// write per pixel, 5.7 MB for a 1392x512 pair, ~2 us at 3.35 TB/s) but
// the compare / integer pipe, which runs at half the fp32 add rate: per
// pixel 32 FSETP, ~24 ops of arc test and score, 4r + 3 of window max and
// keep test, beside 98 FADD. Design:
// - the radius is a template argument (0..5, the Pallas kernel's limit),
//   so the tile, halo and strides are compile-time constants, the ring
//   offsets are immediates and every loop unrolls; no integer division
//   by a runtime value anywhere;
// - one block per (image, 128x16 output tile), 128 x 4 threads; the tile
//   plus a halo of 3 + r is staged in shared memory once with coalesced
//   loads (x fastest), all issued before the first store, out-of-image
//   pixels stored as 0;
// - phase A scores the (16 + 2r) x (128 + 2r) score tile into shared
//   memory: thread (x, y) walks score column x down a strip of rows, and
//   the 2r halo columns are spread over all threads in one extra trip;
// - one FSETP per side serves the relu and the mask bit: for finite
//   floats d > t exactly when d - t > 0, so `if (d > t) sb += d - t` is a
//   predicated FADD whose sums are bit-identical to adding max(d - t, 0);
//   the mask bit is a predicated FADD of 2^s under the same predicate,
//   and the arc test takes 4 shift rounds instead of 8 (same bits);
// - the threshold's sign picks one of two instantiations: at t >= 0 one
//   |d| - t serves both sides (a sample passes at most one test); at
//   t < 0 a sample with |d| < -t passes both, so each side keeps its own
//   argument, d - t and -d - t, as the Pallas body's two relu sums do (16
//   more FADD per pixel). A flat region then scores 16 |t| everywhere and
//   the NMS keeps every tie, as the plain version does;
// - phase B: each thread owns a strip of P = 4 output rows of one column;
//   it takes the row max (2r + 1 shared reads) of the P + 2r score rows
//   the strip needs, slides the vertical window max over them in
//   registers and writes its P outputs. Two barriers in all.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 128;                    // output columns per block
constexpr int kTileH = 16;                     // output rows per block
constexpr int kRows = 4;                       // output rows per thread
constexpr int kThreadsY = kTileH / kRows;
constexpr int kThreads = kTileW * kThreadsY;

// FAST score of the pixel at `c` in an image tile of row stride IW.
// Ring offsets (dy, dx), radius 3, in the order of features.FAST_RING.
// The plain version takes roll(img, (dy, dx)) - img, which samples
// I(p - o): the kernel reads the same pixel in the same order, so the relu
// sums accumulate identically (the Pallas kernel reads I(p + o), which
// differs from its XLA reference in the last ulp).
template <int IW, bool kNeg>
__device__ __forceinline__ float fast_score(const float* c, float t) {
  const int ring_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                           3, 3, 2, 1, 0, -1, -2, -3};
  const int ring_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                           0, -1, -2, -3, -3, -3, -2, -1};
  const float v = c[0];
  float sb = 0.0f;
  float sd = 0.0f;
  // mask bit s is added as the float 2^s under the same predicate as the
  // relu sum: a predicated FADD on the fp32 pipe, not an integer op
  float wb = 0.0f;
  float wd = 0.0f;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const float d = c[-ring_dy[s] * IW - ring_dx[s]] - v;
    if constexpr (kNeg) {
      // t < 0: both tests can hold, each side adds its own argument
      if (d > t) {
        sb = sb + (d - t);
        wb = wb + (float)(1u << s);
      }
      if (d < -t) {
        sd = sd + (-d - t);
        wd = wd + (float)(1u << s);
      }
    } else {
      // |d| - t is d - t where d > t and -d - t where d < -t: the same
      // operation on the same operands, so one FADD serves both sides
      // (at t >= 0 at most one side holds)
      const float e = fabsf(d) - t;
      if (d > t) {
        sb = sb + e;
        wb = wb + (float)(1u << s);
      }
      if (d < -t) {
        sd = sd + e;
        wd = wd + (float)(1u << s);
      }
    }
  }
  // The masks are integers < 2^16, exact in f32: adding 2^23 puts them in
  // the low mantissa bits, and multiplying by 65537 doubles them (w | w <<
  // 16) in bits 0..23 (the exponent lands in bits 24..31, which the arc
  // test never reads). Bit i (i < 16) of the result is the AND of bits
  // i..i + 8, as after 8 rounds of y &= y >> 1, in 4 rounds (runs of 2,
  // 4, 8, 9).
  unsigned yb = __float_as_uint(wb + 8388608.0f) * 65537u;
  unsigned yd = __float_as_uint(wd + 8388608.0f) * 65537u;
  const int shift[4] = {1, 2, 4, 1};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    yb &= yb >> shift[k];
    yd &= yd >> shift[k];
  }
  const bool corner = ((yb | yd) & 0xFFFFu) != 0u;
  return corner ? fmaxf(sb, sd) : 0.0f;
}

template <int R, bool kNeg>
__global__ void __launch_bounds__(kThreads)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out,
                int H, int W, float t) {
  constexpr int kHalo = 3 + R;
  constexpr int IW = kTileW + 2 * kHalo;  // image tile
  constexpr int IH = kTileH + 2 * kHalo;
  constexpr int SW = kTileW + 2 * R;      // score tile
  constexpr int SH = kTileH + 2 * R;
  __shared__ float tile[IH * IW];
  __shared__ float score[SH * SW];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const float* im = img + (size_t)blockIdx.z * H * W;

  // stage the image tile: rows ty + k * kThreadsY, columns tx and, for
  // the first 2 kHalo lanes, tx + kTileW. Every load is issued before the
  // first store (addresses clamped into the image, the value zeroed
  // outside it; rows past the tile re-read its last row), so they are all
  // in flight at once.
  static_assert(2 * kHalo <= 32, "the right halo is one warp's lanes");
  constexpr int KT = (IH + kThreadsY - 1) / kThreadsY;
  const bool right = tx < 2 * kHalo;  // also stages column tx + kTileW
  const int gx0 = x0 - kHalo + tx;
  const int cx0 = min(max(gx0, 0), W - 1);
  const int cx1 = min(gx0 + kTileW, W - 1);
  float staged[KT][2];
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const int gy = y0 - kHalo + min(ty + k * kThreadsY, IH - 1);
    const int cy = min(max(gy, 0), H - 1);
    const float* row = im + (size_t)cy * W;
    staged[k][0] = __ldg(row + cx0);
    if (gy != cy || gx0 != cx0) staged[k][0] = 0.0f;
    if (right) {
      staged[k][1] = __ldg(row + cx1);
      if (gy != cy || gx0 + kTileW != cx1) staged[k][1] = 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const int ly = ty + k * kThreadsY;
    if (ly < IH) {
      tile[ly * IW + tx] = staged[k][0];
      if (right) tile[ly * IW + tx + kTileW] = staged[k][1];
    }
  }
  __syncthreads();

  // phase A: score tile. Score (sr, sx) is image tile (sr + 3, sx + 3).
  // Main columns: thread (tx, ty) scores column tx, rows ty * SA ...
  constexpr int SA = (SH + kThreadsY - 1) / kThreadsY;
  {
    const int sr0 = ty * SA;
    const float* c = tile + (sr0 + 3) * IW + (tx + 3);
#pragma unroll
    for (int i = 0; i < SA; ++i) {
      if (sr0 + i < SH) {
        score[(sr0 + i) * SW + tx] = fast_score<IW, kNeg>(c + i * IW, t);
      }
    }
  }
  // ... and the 2R halo columns kTileW .. SW - 1, spread over all threads
  if constexpr (R > 0) {
    constexpr int kExtra = 2 * R * SH;
    const int tid = ty * kTileW + tx;
#pragma unroll
    for (int k = 0; k < (kExtra + kThreads - 1) / kThreads; ++k) {
      const int j = tid + k * kThreads;
      if (j < kExtra) {
        const int sr = j / (2 * R);  // compile-time divisor
        const int sx = kTileW + (j - sr * 2 * R);
        score[sr * SW + sx] =
            fast_score<IW, kNeg>(tile + (sr + 3) * IW + sx + 3, t);
      }
    }
  }
  __syncthreads();

  // phase B: output (oy, ox) = score (oy + R, ox + R); its window is score
  // rows oy .. oy + 2R, columns ox .. ox + 2R
  const int r0 = ty * kRows;
  float rowmax[kRows + 2 * R];
  float centre[kRows];
#pragma unroll
  for (int i = 0; i < kRows + 2 * R; ++i) {
    const float* row = score + (r0 + i) * SW + tx;
    float m = row[0];
#pragma unroll
    for (int k = 1; k <= 2 * R; ++k) m = fmaxf(m, row[k]);
    rowmax[i] = m;
    if (i >= R && i < R + kRows) centre[i - R] = row[R];
  }
  const int gx = x0 + tx;
  float* o = out + (size_t)blockIdx.z * H * W + gx;
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    float m = rowmax[p];
#pragma unroll
    for (int k = 1; k <= 2 * R; ++k) m = fmaxf(m, rowmax[p + k]);
    const float s = centre[p];
    const int gy = y0 + r0 + p;
    if (gx < W && gy < H) {
      o[(size_t)gy * W] = (s >= m && s > 0.0f) ? s : 0.0f;
    }
  }
}

template <int R>
int launch(const void* imgs, void* out, int B, int H, int W, float t,
           cudaStream_t stream) {
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  const dim3 block(kTileW, kThreadsY);
  const auto* in = static_cast<const float*>(imgs);
  auto* o = static_cast<float*>(out);
  if (t < 0.0f)
    fast_nms_kernel<R, true><<<grid, block, 0, stream>>>(in, o, H, W, t);
  else
    fast_nms_kernel<R, false><<<grid, block, 0, stream>>>(in, o, H, W, t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// imgs, out: (B, H, W) contiguous float32 on the device; radius 0..5;
// any finite threshold (its sign picks the instantiation). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int fast_nms_launch(const void* imgs, void* out, int B, int H, int W,
                    float threshold, int radius, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (radius) {
    case 0: return launch<0>(imgs, out, B, H, W, threshold, s);
    case 1: return launch<1>(imgs, out, B, H, W, threshold, s);
    case 2: return launch<2>(imgs, out, B, H, W, threshold, s);
    case 3: return launch<3>(imgs, out, B, H, W, threshold, s);
    case 4: return launch<4>(imgs, out, B, H, W, threshold, s);
    case 5: return launch<5>(imgs, out, B, H, W, threshold, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fast_nms_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
