// Native runtime tier: serial/OpenMP stencil baseline + raw image block I/O.
//
// The reference's native components are plain C: the serial convolute()
// baseline (component C1/C2), its OpenMP-threaded hybrid variant (C9), and
// raw-image I/O (C7).  The card's compute path is the CUDA kernels of
// csrc/; this library is the *host-side* native tier: the honest CPU
// baseline the benchmarks compare against (what "1 process / N threads"
// buys on the host) and block I/O for huge images.  The port's own copy of
// the JAX package's native/src/pctpu.cpp, byte for byte in its code.
//
// Semantics contract (must match ops/oracle.py bit-exactly):
//   * zero ghost ring of width r = k/2 each iteration;
//   * per pixel/channel: float32 accumulation over taps in row-major order
//     (one fused multiply-add per tap is NOT allowed — an fma would round
//     differently than a*b+c in two steps, so we compile without
//     -ffast-math and keep the explicit  acc += tap * px  form);
//   * store-back: clip(rint(acc), 0, 255) with rint in round-half-to-even
//     (the default FE_TONEAREST mode of std::nearbyintf).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// One u8-semantics iteration: src -> dst, both interleaved (H, W, C) u8.
// taps: k*k float32, row-major.  threads <= 0 means "all available".
static void convolve_once_u8(const uint8_t* src, uint8_t* dst,
                             int64_t H, int64_t W, int64_t C,
                             const float* taps, int k, int threads) {
  const int r = k / 2;
#ifdef _OPENMP
  if (threads > 0) omp_set_num_threads(threads);
#pragma omp parallel for schedule(static)
#endif
  for (int64_t y = 0; y < H; ++y) {
    for (int64_t x = 0; x < W; ++x) {
      for (int64_t c = 0; c < C; ++c) {
        float acc = 0.0f;
        int t = 0;
        for (int dy = -r; dy <= r; ++dy) {
          const int64_t yy = y + dy;
          for (int dx = -r; dx <= r; ++dx, ++t) {
            const int64_t xx = x + dx;
            float px = 0.0f;  // zero ghost ring outside the image
            if (yy >= 0 && yy < H && xx >= 0 && xx < W)
              px = (float)src[(yy * W + xx) * C + c];
            acc += taps[t] * px;  // fixed order, no fma (see header note)
          }
        }
        float q = std::nearbyintf(acc);  // round half to even
        q = q < 0.0f ? 0.0f : (q > 255.0f ? 255.0f : q);
        dst[(y * W + x) * C + c] = (uint8_t)q;
      }
    }
  }
}

// iters u8 iterations with double buffering (the reference's pointer swap).
void pctpu_run_serial_u8(const uint8_t* img, uint8_t* out,
                         int64_t H, int64_t W, int64_t C,
                         const float* taps, int k, int iters, int threads) {
  if (iters <= 0) {
    std::memcpy(out, img, (size_t)(H * W * C));
    return;
  }
  std::vector<uint8_t> buf;
  uint8_t* bufs[2] = {out, out};
  if (iters > 1) {
    buf.resize((size_t)(H * W * C));
    bufs[1] = buf.data();
  }
  const uint8_t* src = img;
  for (int t = 0; t < iters; ++t) {
    // Alternate destinations so iteration iters-1 lands in `out`; the
    // source is always the other buffer (or `img` on the first pass).
    uint8_t* dst = bufs[(iters - 1 - t) % 2];
    convolve_once_u8(src, dst, H, W, C, taps, k, threads);
    src = dst;
  }
}

int pctpu_num_threads(void) {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// ---- raw image block I/O (C7): pread/pwrite at row offsets --------------

// Read rows [r0, r1) x cols [c0, c1) of a (rows, cols, ch) u8 raw file
// into `out` (contiguous (r1-r0, c1-c0, ch)).  Returns 0 on success.
int pctpu_read_block(const char* path, int64_t rows, int64_t cols, int64_t ch,
                     int64_t r0, int64_t r1, int64_t c0, int64_t c1,
                     uint8_t* out) {
  if (r0 < 0 || c0 < 0 || r1 > rows || c1 > cols || r0 > r1 || c0 > c1)
    return -2;
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  const int64_t bw = (c1 - c0) * ch;
  for (int64_t y = r0; y < r1; ++y) {
    const int64_t off = (y * cols + c0) * ch;
    if (std::fseek(f, (long)off, SEEK_SET) != 0 ||
        std::fread(out + (y - r0) * bw, 1, (size_t)bw, f) != (size_t)bw) {
      std::fclose(f);
      return -3;
    }
  }
  std::fclose(f);
  return 0;
}

// Write a (r1-r0, c1-c0, ch) block into a pre-sized raw file in place.
int pctpu_write_block(const char* path, int64_t rows, int64_t cols, int64_t ch,
                      int64_t r0, int64_t r1, int64_t c0, int64_t c1,
                      const uint8_t* block) {
  if (r0 < 0 || c0 < 0 || r1 > rows || c1 > cols || r0 > r1 || c0 > c1)
    return -2;
  FILE* f = std::fopen(path, "r+b");
  if (!f) return -1;
  const int64_t bw = (c1 - c0) * ch;
  for (int64_t y = r0; y < r1; ++y) {
    const int64_t off = (y * cols + c0) * ch;
    if (std::fseek(f, (long)off, SEEK_SET) != 0 ||
        std::fwrite(block + (y - r0) * bw, 1, (size_t)bw, f) != (size_t)bw) {
      std::fclose(f);
      return -3;
    }
  }
  std::fclose(f);
  return 0;
}

// ---- layout conversion: interleaved (H,W,C) <-> planar (C,H,W) ----------

void pctpu_interleaved_to_planar(const uint8_t* in, uint8_t* out,
                                 int64_t H, int64_t W, int64_t C) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t y = 0; y < H; ++y)
    for (int64_t x = 0; x < W; ++x)
      for (int64_t c = 0; c < C; ++c)
        out[c * H * W + y * W + x] = in[(y * W + x) * C + c];
}

void pctpu_planar_to_interleaved(const uint8_t* in, uint8_t* out,
                                 int64_t H, int64_t W, int64_t C) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t y = 0; y < H; ++y)
    for (int64_t x = 0; x < W; ++x)
      for (int64_t c = 0; c < C; ++c)
        out[(y * W + x) * C + c] = in[c * H * W + y * W + x];
}

}  // extern "C"
