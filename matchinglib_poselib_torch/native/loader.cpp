// Native data loader: PNG / PGM / PPM decode + threaded batch loading.
//
// Fills the role of the reference's C++ IO layer
// (tests/matchinglib-test/io_data.cpp, 845 LoC: image/sequence loading for
// the CLIs) for the PyTorch port: decoded frames land in host buffers as
// float32 grayscale in [0, 1], ready for the copy to the card. A
// std::thread pool decodes a batch of frames in parallel. (A copy of the
// JAX package's native/loader.cpp.)
//
// Formats: 8/16-bit grayscale, RGB, RGBA and palette PNG (non-interlaced;
// zlib inflate + all 5 scanline filters), binary/ASCII PGM/PPM. Anything
// else -> error code, the Python wrapper falls back to PIL.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 loader.cpp -lz -o <lib>.so
// Binding: ctypes (matchinglib_poselib_torch/native/__init__.py), which
// builds into matchinglib_poselib_torch/_build/ under a source-hash name.

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int h = 0, w = 0;
  std::vector<float> gray;  // h*w in [0, 1]
};

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(n));
  size_t got = std::fread(out.data(), 1, out.size(), f);
  std::fclose(f);
  return got == out.size();
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// ---- PNG ------------------------------------------------------------------

bool decode_png(const std::vector<uint8_t>& buf, Image& img) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (buf.size() < 8 || std::memcmp(buf.data(), sig, 8) != 0) return false;

  int w = 0, h = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // rgb triples

  size_t off = 8;
  while (off + 8 <= buf.size()) {
    uint32_t len = be32(&buf[off]);
    if (off + 12 + len > buf.size()) return false;
    const uint8_t* type = &buf[off + 4];
    const uint8_t* data = &buf[off + 8];
    if (!std::memcmp(type, "IHDR", 4)) {
      if (len < 13) return false;
      w = int(be32(data));
      h = int(be32(data + 4));
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
    } else if (!std::memcmp(type, "PLTE", 4)) {
      palette.assign(data, data + len);
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    off += 12 + len;
  }
  if (w <= 0 || h <= 0 || interlace != 0) return false;
  if (bit_depth != 8 && bit_depth != 16) return false;

  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // rgb
    case 3: channels = 1; break;  // palette index
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // rgba
    default: return false;
  }
  if (color_type == 3 && bit_depth != 8) return false;

  const int bpp = channels * (bit_depth / 8);          // bytes per pixel
  const size_t stride = size_t(w) * bpp;               // bytes per scanline
  std::vector<uint8_t> raw(size_t(h) * (stride + 1));
  uLongf raw_len = uLongf(raw.size());
  if (uncompress(raw.data(), &raw_len, idat.data(), uLong(idat.size())) !=
          Z_OK ||
      raw_len != raw.size())
    return false;

  // unfilter scanlines in place into `pix`
  std::vector<uint8_t> pix(size_t(h) * stride);
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = &raw[size_t(y) * (stride + 1)];
    uint8_t filter = src[0];
    ++src;
    uint8_t* dst = &pix[size_t(y) * stride];
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
      int b = prev ? prev[x] : 0;
      int c = (prev && x >= size_t(bpp)) ? prev[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = uint8_t(v & 0xff);
    }
    prev = dst;
  }

  img.h = h;
  img.w = w;
  img.gray.resize(size_t(h) * w);
  const float inv8 = 1.0f / 255.0f;
  const float inv16 = 1.0f / 65535.0f;
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = &pix[size_t(y) * stride];
    float* out = &img.gray[size_t(y) * w];
    for (int x = 0; x < w; ++x) {
      const uint8_t* px = row + size_t(x) * bpp;
      float r, g, b;
      if (color_type == 3) {
        int idx = px[0] * 3;
        if (size_t(idx) + 2 >= palette.size()) return false;
        r = palette[idx] * inv8;
        g = palette[idx + 1] * inv8;
        b = palette[idx + 2] * inv8;
      } else if (bit_depth == 8) {
        if (channels <= 2) {
          r = g = b = px[0] * inv8;
        } else {
          r = px[0] * inv8;
          g = px[1] * inv8;
          b = px[2] * inv8;
        }
      } else {  // 16-bit big-endian
        auto s16 = [&](int ch) {
          return float((px[2 * ch] << 8) | px[2 * ch + 1]) * inv16;
        };
        if (channels <= 2) {
          r = g = b = s16(0);
        } else {
          r = s16(0);
          g = s16(1);
          b = s16(2);
        }
      }
      // ITU-R BT.601 luma, same weights as OpenCV/PIL "L" conversion
      out[x] = 0.299f * r + 0.587f * g + 0.114f * b;
    }
  }
  return true;
}

// ---- PGM / PPM ------------------------------------------------------------

bool decode_pnm(const std::vector<uint8_t>& buf, Image& img) {
  if (buf.size() < 2 || buf[0] != 'P') return false;
  char kind = char(buf[1]);
  if (kind < '2' || kind > '6' || kind == '4') return false;  // no PBM
  size_t pos = 2;
  auto skip_ws = [&]() {
    while (pos < buf.size()) {
      if (buf[pos] == '#') {
        while (pos < buf.size() && buf[pos] != '\n') ++pos;
      } else if (std::isspace(buf[pos])) {
        ++pos;
      } else {
        break;
      }
    }
  };
  auto read_int = [&]() -> long {
    skip_ws();
    long v = 0;
    bool any = false;
    while (pos < buf.size() && std::isdigit(buf[pos])) {
      v = v * 10 + (buf[pos] - '0');
      ++pos;
      any = true;
    }
    return any ? v : -1;
  };
  long w = read_int(), h = read_int(), maxval = read_int();
  if (w <= 0 || h <= 0 || maxval <= 0 || maxval > 65535) return false;
  bool color = (kind == '3' || kind == '6');
  bool ascii = (kind == '2' || kind == '3');
  int channels = color ? 3 : 1;
  const float inv = 1.0f / float(maxval);

  img.h = int(h);
  img.w = int(w);
  img.gray.resize(size_t(h) * w);

  if (ascii) {
    for (size_t i = 0; i < size_t(h) * w; ++i) {
      float r = float(read_int()) * inv, g = r, b = r;
      if (color) {
        g = float(read_int()) * inv;
        b = float(read_int()) * inv;
      }
      img.gray[i] = color ? (0.299f * r + 0.587f * g + 0.114f * b) : r;
    }
    return true;
  }
  ++pos;  // single whitespace after maxval
  int bytes = maxval > 255 ? 2 : 1;
  size_t need = size_t(h) * w * channels * bytes;
  if (pos + need > buf.size()) return false;
  const uint8_t* p = &buf[pos];
  for (size_t i = 0; i < size_t(h) * w; ++i) {
    auto sample = [&](size_t k) {
      const uint8_t* q = p + (i * channels + k) * bytes;
      return float(bytes == 2 ? ((q[0] << 8) | q[1]) : q[0]) * inv;
    };
    if (color) {
      img.gray[i] =
          0.299f * sample(0) + 0.587f * sample(1) + 0.114f * sample(2);
    } else {
      img.gray[i] = sample(0);
    }
  }
  return true;
}

bool decode_any(const char* path, Image& img) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return false;
  if (decode_png(buf, img)) return true;
  return decode_pnm(buf, img);
}

}  // namespace

extern "C" {

// Two-phase single-image API: decode into an owned buffer, hand out the
// pointer, free on release.
void* mlp_load_gray(const char* path, int* h, int* w) {
  Image img;
  if (!decode_any(path, img)) return nullptr;
  auto* holder = new std::vector<float>(std::move(img.gray));
  *h = img.h;
  *w = img.w;
  return holder;
}

const float* mlp_data(void* handle) {
  return static_cast<std::vector<float>*>(handle)->data();
}

void mlp_release(void* handle) {
  delete static_cast<std::vector<float>*>(handle);
}

// Threaded batch decode: n images into caller-provided, equally-sized
// buffers (h*w each, images must share the batch shape — the framework's
// fixed-shape contract). Returns the number of successfully decoded
// images; failed slots are zero-filled.
int mlp_load_batch_gray(const char** paths, int n, float* out, int h, int w,
                        int n_threads) {
  if (n <= 0) return 0;
  if (n_threads <= 0) n_threads = int(std::thread::hardware_concurrency());
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0), good(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      Image img;
      float* dst = out + size_t(i) * h * w;
      if (decode_any(paths[i], img) && img.h == h && img.w == w) {
        std::memcpy(dst, img.gray.data(), sizeof(float) * size_t(h) * w);
        good.fetch_add(1);
      } else {
        std::memset(dst, 0, sizeof(float) * size_t(h) * w);
      }
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(size_t(n_threads));
  for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return good.load();
}

}  // extern "C"
