// Device helpers shared by the port's kernels (csrc/stencil.cu, csrc/rdma.cu):
// the tap table, the f32 / bf16 / u8 loads and stores, the u8 store-back,
// the tap chains, and the T-level loop of K2, K3 and K4.
//
// Semantics (the normative spec is ops/oracle.py):
//  * accumulation in f32 in the fixed row-major tap order, or the rank-1
//    two-pass order (row pass over th+k-1 rows, then the column pass) when
//    separable, each tap one single-rounding FMA (__fmaf_rn) -- the order the
//    JAX package's XLA and Pallas tiers contract to;
//  * quantize: rintf (round half to even), then clip to [0, 255] unless the
//    filter is convex (the clip is the identity there);
//  * loads convert f32 / bf16 / u8 to f32, stores convert back
//    (__float2bfloat16_rn for bf16; u8 through int, exact for 0..255).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace pc {

constexpr int kMaxK = 9;
constexpr int kFusedThreadsX = 32, kFusedThreadsY = 16;
constexpr int kStaticSmem = 48 * 1024;

enum DType : int { kF32 = 0, kBF16 = 1, kU8 = 2 };

struct Taps {
  float t[kMaxK * kMaxK];  // row-major k x k taps
  float col[kMaxK];        // separable column factor (when sep)
  float row[kMaxK];        // separable row factor (when sep)
};

__device__ __forceinline__ float load_f32(const void* p, int dtype,
                                          long long i) {
  switch (dtype) {
    case kBF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case kU8:
      return static_cast<float>(
          static_cast<int>(static_cast<const uint8_t*>(p)[i]));
    default:
      return static_cast<const float*>(p)[i];
  }
}

__device__ __forceinline__ void store_f32(void* p, int dtype, long long i,
                                          float v) {
  switch (dtype) {
    case kBF16:
      static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
      break;
    case kU8:
      static_cast<uint8_t*>(p)[i] =
          static_cast<uint8_t>(static_cast<int>(v));
      break;
    default:
      static_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ float quantize(float acc, int convex) {
  acc = rintf(acc);
  if (!convex) acc = fminf(fmaxf(acc, 0.f), 255.f);
  return acc;
}

// 2D row-major tap chain for the output at (y, x) of window s (row stride S).
template <int KT>
__device__ __forceinline__ float corr2d(const float* __restrict__ s, int S,
                                        int y, int x, const Taps& tp, int k) {
  const int K = KT > 0 ? KT : k;
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const float* line = s + (y + dy) * S + x;
#pragma unroll
    for (int dx = 0; dx < K; ++dx)
      acc = __fmaf_rn(tp.t[dy * K + dx], line[dx], acc);
  }
  return acc;
}

// Separable row pass: sum_dx row[dx] * s[y][x + dx].
template <int KT>
__device__ __forceinline__ float row_pass(const float* __restrict__ s, int S,
                                          int y, int x, const Taps& tp,
                                          int k) {
  const int K = KT > 0 ? KT : k;
  const float* line = s + y * S + x;
  float acc = 0.f;
#pragma unroll
  for (int dx = 0; dx < K; ++dx) acc = __fmaf_rn(tp.row[dx], line[dx], acc);
  return acc;
}

// Separable column pass: sum_dy col[dy] * s[y + dy][x].
template <int KT>
__device__ __forceinline__ float col_pass(const float* __restrict__ s, int S,
                                          int y, int x, const Taps& tp,
                                          int k) {
  const int K = KT > 0 ? KT : k;
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < K; ++dy)
    acc = __fmaf_rn(tp.col[dy], s[(y + dy) * S + x], acc);
  return acc;
}

// T stencil levels of one th x tw output tile, all in shared memory.
//
// On entry `a` holds the level-0 window (th+2rT) x (tw+2rT), row stride S,
// its out-of-image positions already exactly 0 when `mask` is set.  The
// levels ping-pong between the f32 buffers `a` and `b`; level s lives in
// the top-left (th+2r(T-s)) x (tw+2r(T-s)) of one of them.  With `mask`,
// every level is multiplied by a 0/1 row mask and a 0/1 column mask
// against the global image extent (valid_h, valid_w), as the JAX package's
// _iterate_levels does; (row0, col0) are the global coordinates of the
// level-0 window's top-left.  Returns the buffer holding level T.  The
// caller synchronises after the level-0 fill; this returns synchronised.
template <int KT>
__device__ float* fused_levels(float* a, float* b, int S, int th, int tw,
                               int T, int r, const Taps& tp, int k, int sep,
                               int quant, int convex, int mask, int row0,
                               int col0, int valid_h, int valid_w) {
  for (int s = 1; s <= T; ++s) {
    const int ch = th + 2 * r * (T - s), cw = tw + 2 * r * (T - s);
    const int grow = row0 + r * s, gcol = col0 + r * s;  // level-s origin
    float* dst;
    if (sep) {
      // Row pass over all ch + 2r rows of the previous level into b, then
      // the column pass from b back into a (a is fully consumed by then).
      for (int y = threadIdx.y; y < ch + 2 * r; y += blockDim.y)
        for (int x = threadIdx.x; x < cw; x += blockDim.x)
          b[y * S + x] = row_pass<KT>(a, S, y, x, tp, k);
      __syncthreads();
      dst = a;
    } else {
      dst = b;
    }
    for (int y = threadIdx.y; y < ch; y += blockDim.y) {
      const float mrow =
          (grow + y >= 0 && grow + y < valid_h) ? 1.f : 0.f;
      for (int x = threadIdx.x; x < cw; x += blockDim.x) {
        float acc = sep ? col_pass<KT>(b, S, y, x, tp, k)
                        : corr2d<KT>(a, S, y, x, tp, k);
        if (quant) acc = quantize(acc, convex);
        if (mask) {
          const float mcol =
              (gcol + x >= 0 && gcol + x < valid_w) ? 1.f : 0.f;
          acc = acc * mrow;
          acc = acc * mcol;
        }
        dst[y * S + x] = acc;
      }
    }
    __syncthreads();
    if (!sep) {
      float* t = a;
      a = b;
      b = t;
    }
  }
  return a;
}

inline bool fill_taps(Taps* tp, const float* taps, const float* col,
                      const float* row, int k, int sep) {
  if (k < 1 || k > kMaxK || k % 2 == 0) return false;
  for (int i = 0; i < k * k; ++i) tp->t[i] = taps[i];
  for (int i = 0; i < k; ++i) {
    tp->col[i] = sep ? col[i] : 0.f;
    tp->row[i] = sep ? row[i] : 0.f;
  }
  return true;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kStaticSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace pc
