// Device helpers shared by the port's kernels (csrc/step.cu, csrc/stencil.cu,
// csrc/rdma.cu, csrc/probes.cu): the tap table, the f32 / bf16 / u8 loads and
// stores, the u8 store-back, the register strip (K1 and the level loop), and
// the T-level loop of K2, K3 and K4.
//
// Semantics (the normative spec is ops/oracle.py):
//  * accumulation in f32 in the fixed row-major tap order, or the rank-1
//    two-pass order (row pass over th+k-1 rows, then the column pass) when
//    separable, each tap one single-rounding FMA (__fmaf_rn) -- the order the
//    JAX package's XLA and Pallas tiers contract to;
//  * quantize: round half to even, then clip to [0, 255] unless the filter
//    is convex (the clip is the identity there).  Every kernel rounds with
//    the two-add magic number (acc + 1.5*2^23) - 1.5*2^23, exact for
//    |acc| < 2^22, wherever the host's rule admits it (255 * L1(taps) < 2^21,
//    the JAX package's _round_mode_for); else with rintf.  The
//    two give the same value; only a zero's sign may differ (-0.4 rounds to
//    +0 by magic, to -0 by rintf), which no comparison by value and no u8
//    store sees;
//  * loads convert f32 / bf16 / u8 to f32, stores convert back
//    (__float2bfloat16_rn for bf16; u8 through int, exact for 0..255).
//
// The level loop (run_levels) is held by the H100's shared-memory pipe before
// its FMA pipe when each thread computes one output from k*k shared-memory
// loads, so it is built to spend fewer:
//  * register strips: a thread owns V vertically adjacent outputs of one
//    column (V = 16 for k <= 5, 8 for k = 7, 9; probes/loop_sweep.py) and
//    streams the V+k-1 input rows through registers, k loads a row, so an
//    output costs k(V+k-1)/V shared-memory loads instead of k*k (3.4 for
//    blur3, 6.25 for edge5), and the V chains are independent (ILP).  Each
//    output keeps its own FMA chain in the spec's order: the rows arrive top
//    to bottom and each row's taps left to right.  The separable order keeps
//    the row pass of its V+2r rows in registers and runs the column pass
//    from them: no row-pass buffer and no barrier between the passes;
//  * one f32 buffer, levels in place: level s lives in the top-left of the
//    level-0 window.  A level runs in waves of one strip per thread; each
//    wave computes into registers, waits at a barrier and writes back.  The
//    strips go in row-major (strip row, column) order, and an output at
//    (y, x) only reads positions below and right of it, so a later wave never
//    reads what an earlier wave wrote.  The last level stores straight to
//    device memory;
//  * a warp takes 32 consecutive columns of one strip row (the columns are
//    padded to a multiple of 32), so every shared-memory load and store of a
//    warp is one row of consecutive words: conflict-free at any row stride;
//  * everything that varies by filter or tile is a template parameter: the
//    tap count, the store-back (float, magic or rintf, clip or not), the
//    order (2-D or separable) and the masks.  A tile whose level-0 window
//    lies wholly inside the image runs the loop with no masks (a multiply by
//    1.0 is the identity, bit for bit); edge tiles mask every level, the
//    column mask once per strip.  The choice is one block-uniform branch.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#ifndef PC_STRIP_V
#define PC_STRIP_V 16
#endif

namespace pc {

constexpr int kMaxK = 9;
constexpr int kStripV = PC_STRIP_V;       // outputs per register strip, k <= 5
constexpr int kMaxThreads = 512;          // threads per block of K2 / K3 / K4
// __launch_bounds__'s blocks per SM at kMaxThreads: 2 (<= 64 registers) for
// k <= 5; 1 (<= 128) for k = 7, 9, whose strips spill at 64.
__host__ __device__ constexpr int min_blocks(int k) {
  return k <= 5 ? 2 : 1;
}
// The strip height of a k-tap level loop: kStripV, or 8 for k = 7, 9, whose
// wide rows keep more registers live per strip row.
__host__ __device__ constexpr int strip_v(int k) {
  return k <= 5 ? kStripV : 8;
}
constexpr int kStaticSmem = 48 * 1024;
constexpr float kMagic = 12582912.0f;     // 1.5 * 2^23

enum DType : int { kF32 = 0, kBF16 = 1, kU8 = 2 };

// The u8 store-back of every kernel, a template parameter; the host picks it
// (ops/stencil.py:epilogue_code) and passes the code as `epi`.
enum Epi : int {
  kEpiFloat = 0,      // no store-back (float mode)
  kEpiMagic = 1,      // magic round, convex filter (no clip)
  kEpiMagicClip = 2,  // magic round, then clip to [0, 255]
  kEpiRint = 3,       // rintf, convex
  kEpiRintClip = 4,   // rintf, then clip
};

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

template <int DT>
__device__ __forceinline__ float load_as(const void* p, long long i) {
  if constexpr (DT == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if constexpr (DT == kU8)
    return static_cast<float>(
        static_cast<int>(static_cast<const uint8_t*>(p)[i]));
  return static_cast<const float*>(p)[i];
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

// The store-back.  __fadd_rn keeps nvcc from contracting or folding the
// magic pair.
template <int EPI>
__device__ __forceinline__ float epilogue(float acc) {
  if constexpr (EPI == kEpiMagic || EPI == kEpiMagicClip)
    acc = __fadd_rn(__fadd_rn(acc, kMagic), -kMagic);
  if constexpr (EPI == kEpiRint || EPI == kEpiRintClip) acc = rintf(acc);
  if constexpr (EPI == kEpiMagicClip || EPI == kEpiRintClip)
    acc = fminf(fmaxf(acc, 0.f), 255.f);
  return acc;
}

// A level's input rows in shared memory as f32, row stride S: element
// (i, dx) of the strip whose top-left input is p.
struct F32Rows {
  const float* __restrict__ p;
  int S;
  __device__ __forceinline__ float operator()(int i, int dx) const {
    return p[i * S + dx];
  }
};

// One register strip: the V outputs (y0 .. y0+V-1, x) of a level whose input
// rows `in` gives as in(i, dx) = input[y0 + i][x + dx] in f32 (F32Rows for
// the level loop, K1's typed rows in csrc/step.cu).  FULL: all V outputs are
// live; else only the first `rows`, and the strip reads only the rows + K - 1
// input rows they need (none past the live window).
template <int K, int V, bool SEP, bool FULL, typename Rows>
__device__ __forceinline__ void strip(const Rows& in, const Taps& tp,
                                      int rows, float (&acc)[V]) {
  constexpr int NR = V + K - 1;
  if constexpr (!SEP) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      float line[K];
      if (FULL || i < rows + K - 1) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) line[dx] = in(i, dx);
      } else {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) line[dx] = 0.f;
      }
      // Input row i is tap row dy = i - v of output v: each output's chain
      // takes its rows in order, each row's taps in order.
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int dy = i - v;
        if (dy >= 0 && dy < K) {
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
            acc[v] = __fmaf_rn(tp.t[dy * K + dx], line[dx], acc[v]);
        }
      }
    }
  } else {
    float rp[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      float a = 0.f;
      if (FULL || i < rows + K - 1) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
          a = __fmaf_rn(tp.row[dx], in(i, dx), a);
      }
      rp[i] = a;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float a = 0.f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) a = __fmaf_rn(tp.col[dy], rp[v + dy], a);
      acc[v] = a;
    }
  }
}

// Where the last level of a tile goes: device memory at out[base + y*ld + x]
// for y < nh, x < nw (the rest of the th x tw tile lies past the output).
struct TileOut {
  void* out;
  int dtype;
  long long base;
  long long ld;
  int nh, nw;
};

// T stencil levels of one th x tw output tile, in place in shared memory.
//
// On entry `buf` holds the level-0 window (th+2rT) x (tw+2rT), row stride S,
// its out-of-image positions already exactly 0 when masked; the caller has
// synchronised.  Level s is computed into the top-left (th+2r(T-s)) x
// (tw+2r(T-s)) of `buf`; level T goes to `o`.  EDGE: every level is
// multiplied by a 0/1 row mask and then a 0/1 column mask against the global
// image extent (valid_h, valid_w), as the JAX package's _iterate_levels does;
// (row0, col0) are the global coordinates of the level-0 window's top-left.
// Without EDGE the caller has shown that every mask is 1.
template <int K, int EPI, bool SEP, bool EDGE>
__device__ void run_levels(float* __restrict__ buf, int S, int th, int tw,
                           int T, const Taps& tp, int row0, int col0,
                           int valid_h, int valid_w, const TileOut& o) {
  constexpr int r = K / 2, V = strip_v(K);
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int s = 1; s <= T; ++s) {
    const int ch = th + 2 * r * (T - s), cw = tw + 2 * r * (T - s);
    const int grow = row0 + r * s, gcol = col0 + r * s;  // level-s origin
    const int cwp = (cw + 31) & ~31;  // a warp never spans two strip rows
    const int n = (ch + V - 1) / V * cwp;
    const bool last = s == T;
    for (int base = 0; base < n; base += nt) {
      const int i = base + tid;
      const int sr = i / cwp, x = i - sr * cwp, y0 = sr * V;
      const bool active = i < n && x < cw;
      const int rows = active ? min(V, ch - y0) : 0;
      float acc[V];
      if (active) {
        const F32Rows p{buf + y0 * S + x, S};
        if (rows == V)
          strip<K, V, SEP, true>(p, tp, rows, acc);
        else
          strip<K, V, SEP, false>(p, tp, rows, acc);
        float mcol = 1.f;
        if constexpr (EDGE) mcol = (gcol + x >= 0 && gcol + x < valid_w);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[v] = epilogue<EPI>(acc[v]);
          if constexpr (EDGE) {
            const int gy = grow + y0 + v;
            const float mrow = (gy >= 0 && gy < valid_h) ? 1.f : 0.f;
            acc[v] = acc[v] * mrow;
            acc[v] = acc[v] * mcol;
          }
        }
      }
      if (last) {
        if (active && x < o.nw) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (v < rows && y0 + v < o.nh)
              store_f32(o.out, o.dtype,
                        o.base + static_cast<long long>(y0 + v) * o.ld + x,
                        acc[v]);
        }
      } else {
        __syncthreads();  // the wave has read its inputs
        if (active) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (v < rows) buf[(y0 + v) * S + x] = acc[v];
        }
      }
    }
    if (!last) __syncthreads();  // level s complete before level s+1 reads
  }
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

// Dynamic shared memory of K2 / K3 / K4: one f32 buffer of the level-0
// window of T levels of a th x tw tile (ops/stencil.py:fused_smem_bytes).
inline size_t window_bytes(int k, int T, int th, int tw) {
  const int R = (k / 2) * T;
  return sizeof(float) * static_cast<size_t>(th + 2 * R) *
         static_cast<size_t>(tw + 2 * R);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kStaticSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Host-side dispatch of runtime values onto template instances: f is called
// with std::integral_constant arguments.
template <typename F>
cudaError_t with_k(int k, F&& f) {
  switch (k) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 9: return f(std::integral_constant<int, 9>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_epi(int epi, F&& f) {
  switch (epi) {
    case kEpiFloat: return f(std::integral_constant<int, kEpiFloat>{});
    case kEpiMagic: return f(std::integral_constant<int, kEpiMagic>{});
    case kEpiMagicClip: return f(std::integral_constant<int, kEpiMagicClip>{});
    case kEpiRint: return f(std::integral_constant<int, kEpiRint>{});
    case kEpiRintClip: return f(std::integral_constant<int, kEpiRintClip>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_bool(int b, F&& f) {
  return b ? f(std::true_type{}) : f(std::false_type{});
}

// A launch's thread count: a whole number of warps, 32..kMaxThreads.
inline bool threads_ok(int threads) {
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0;
}

}  // namespace pc
