// Hand-written Hopper (sm_90a) kernels that replace TPU kernel 5, the three
// probe scripts of the JAX package, behind plain C entry points loaded with
// ctypes (ops/_build.py builds this file with nvcc; the modules of
// parallel_convolution_tpu_torch/probes/ bind and check every argument).
//
// 5a op_chain_kernel -- replaces scripts/vpu_op_probe.py:102 (a Pallas
//    kernel streaming (512, 512) blocks through VMEM with K dependent
//    elementwise steps each).  Here one thread per element holds kChains
//    independent chains of K = kSteps dependent steps in registers: one
//    read of the element, kChains writes, and kChains * K operations, so at
//    (8192, 512) elements it is bound by instruction issue, not by device
//    memory (512 steps per 20 bytes for f32).  Several chains per thread
//    keep more than one instruction of each thread in flight, so the rate
//    is the issue rate and not the latency of one dependent chain.  Float
//    steps use the _rn intrinsics, which nvcc neither contracts nor
//    reassociates, so the magic round (y + M) - M is not folded away;
//    integer steps are volatile PTX, so a chain of adds is not folded into
//    one multiply.
//
// 5b smem_probe_kernel -- replaces scripts/helper_crash_probe.py:100 (out =
//    in + 1 with a VMEM scratch of 4 to 32 MB, asking whether a budget
//    overrun fails cleanly or kills the compile helper).  Here out = in + 1
//    with a dynamic shared-memory scratch of a given size, with or without
//    the opt-in attribute: the question is whether a launch above the
//    card's limits is refused cleanly or loses the context.  Trivial work;
//    bound by launch latency.
//
// 5c rdma_ladder_kernel -- replaces scripts/tiled_repro_probe.py:101-218 (a
//    ladder of Pallas kernels, each adding one construct of the tiled RDMA
//    kernel).  Here one kernel, templated on the rung, adds one construct
//    of K4 (csrc/rdma.cu) per rung over K4's own tiles:
//      r0 a tile of the block into shared memory and back (base pointer);
//      r1 the block's address from the pointer table (base + b * stride);
//      r2 the r*T-deep ghost window gathered through the neighbour table
//         (-1 reads zeros) and written whole: a halo exchange;
//      r3 the T levels on that window: K4 itself (rdma_common.cuh), the
//         level loop and all (stencil_common.cuh).
//    r0 and r1 are bound by bytes, r3 by operations (as K4); the rungs'
//    times split K4's time into copy, gather and compute.

#include "rdma_common.cuh"

using namespace pc;

namespace {

// ---------------------------------------------------------------------------
// 5a: op_chain
// ---------------------------------------------------------------------------

constexpr int kSteps = 128;   // dependent steps per chain (the probe's K)
constexpr int kChains = 4;    // independent chains per thread
constexpr int kChainThreads = 256;

enum Op : int {
  kFmaF32 = 0,
  kFmaBF16 = 1,
  kMulAddI32 = 2,
  kMulAddI16 = 3,
  kAddI32 = 4,
  kAddI16 = 5,
  kAddF32 = 6,
  kRintAdd = 7,
  kMagicAdd = 8,
  kClampAdd = 9,
};

struct ChainConsts {
  float af[kChains], bf[kChains];  // float chains: y = step(y, a, b)
  int ai[kChains], bi[kChains];    // integer chains
};

template <int OP>
__device__ __forceinline__ float float_step(float y, float a, float b) {
  if constexpr (OP == kFmaF32) return __fmaf_rn(y, a, b);
  if constexpr (OP == kAddF32) return __fadd_rn(y, b);
  if constexpr (OP == kRintAdd) return __fadd_rn(rintf(y), b);
  if constexpr (OP == kMagicAdd)
    return __fadd_rn(__fsub_rn(__fadd_rn(y, kMagic), kMagic), b);
  return __fadd_rn(fminf(fmaxf(y, 0.f), 255.f), b);  // kClampAdd
}

template <int OP>
__device__ __forceinline__ unsigned int int_step(unsigned int y,
                                                 unsigned int a,
                                                 unsigned int b) {
  if constexpr (OP == kMulAddI32) {
    asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(y) : "r"(a), "r"(b));
  } else {
    asm volatile("add.u32 %0, %0, %1;" : "+r"(y) : "r"(b));
  }
  return y;
}

template <int OP>
__device__ __forceinline__ unsigned short short_step(unsigned short y,
                                                     unsigned short a,
                                                     unsigned short b) {
  if constexpr (OP == kMulAddI16) {
    asm volatile("mad.lo.u16 %0, %0, %1, %2;" : "+h"(y) : "h"(a), "h"(b));
  } else {
    asm volatile("add.u16 %0, %0, %1;" : "+h"(y) : "h"(b));
  }
  return y;
}

// out[c * n + i] = chain c (kSteps steps) started from in[i].  For bf16, n
// counts packed pairs: each step is one __hfma2 on two elements.
template <int OP>
__global__ void __launch_bounds__(kChainThreads)
    op_chain_kernel(const void* __restrict__ in, void* __restrict__ out,
                    long long n, ChainConsts k) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if constexpr (OP == kFmaBF16) {
    const __nv_bfloat162 x = static_cast<const __nv_bfloat162*>(in)[i];
    __nv_bfloat162 y[kChains], a[kChains], b[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      y[c] = x;
      a[c] = __float2bfloat162_rn(k.af[c]);
      b[c] = __float2bfloat162_rn(k.bf[c]);
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int c = 0; c < kChains; ++c) y[c] = __hfma2(y[c], a[c], b[c]);
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      static_cast<__nv_bfloat162*>(out)[c * n + i] = y[c];
  } else if constexpr (OP == kMulAddI32 || OP == kAddI32) {
    const unsigned int x = static_cast<const unsigned int*>(in)[i];
    unsigned int y[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) y[c] = x;
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int c = 0; c < kChains; ++c)
        y[c] = int_step<OP>(y[c], static_cast<unsigned int>(k.ai[c]),
                            static_cast<unsigned int>(k.bi[c]));
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      static_cast<unsigned int*>(out)[c * n + i] = y[c];
  } else if constexpr (OP == kMulAddI16 || OP == kAddI16) {
    const unsigned short x = static_cast<const unsigned short*>(in)[i];
    unsigned short y[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) y[c] = x;
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int c = 0; c < kChains; ++c)
        y[c] = short_step<OP>(y[c], static_cast<unsigned short>(k.ai[c]),
                              static_cast<unsigned short>(k.bi[c]));
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      static_cast<unsigned short*>(out)[c * n + i] = y[c];
  } else {
    const float x = static_cast<const float*>(in)[i];
    float y[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) y[c] = x;
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int c = 0; c < kChains; ++c)
        y[c] = float_step<OP>(y[c], k.af[c], k.bf[c]);
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      static_cast<float*>(out)[c * n + i] = y[c];
  }
}

template <int OP>
cudaError_t launch_chain(const void* in, void* out, long long n,
                         const ChainConsts& k, cudaStream_t st) {
  const long long blocks = (n + kChainThreads - 1) / kChainThreads;
  op_chain_kernel<OP><<<static_cast<unsigned int>(blocks), kChainThreads, 0,
                        st>>>(in, out, n, k);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 5b: smem_probe
// ---------------------------------------------------------------------------

// OPT = 1 is the instance whose dynamic shared-memory attribute the probe
// raises; OPT = 0 keeps the default, so "without opt-in" stays true however
// the steps are ordered.
template <int OPT>
__global__ void smem_probe_kernel(const float* __restrict__ in,
                                  float* __restrict__ out, int n, int words) {
  extern __shared__ float scratch[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // Write the scratch's first and last word and read one back, so the
  // allocation is used: out = in + 1 + 0.
  if (threadIdx.x == 0 && words > 0) {
    scratch[0] = 0.f;
    scratch[words - 1] = 0.f;
  }
  __syncthreads();
  const float z = words > 0 ? scratch[(words - 1) * (threadIdx.x & 1)] : 0.f;
  if (i < n) out[i] = in[i] + 1.f + z;
}

// ---------------------------------------------------------------------------
// 5c: rdma_ladder
// ---------------------------------------------------------------------------

template <int RUNG, int K, int EPI>
__global__ void __launch_bounds__(kMaxThreads, min_blocks(K))
    rdma_ladder_kernel(BlockGrid g, const void* __restrict__ base,
                       void* __restrict__ out, int out_dtype, int T, Taps tp,
                       int mask, int valid_h, int valid_w, int th, int tw) {
  extern __shared__ float smem[];
  const int b = blockIdx.z / g.C, c = blockIdx.z % g.C;
  const int y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  const int h = g.h, w = g.w;
  // A 1-D block: warp (threadIdx.x >> 5) takes rows, its lanes columns.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  if constexpr (RUNG == 3) {
    // + the T levels: K4's tile body, exactly as csrc/rdma.cu runs it.
    rdma_tile<K, EPI, false>(g, b, c, y0, x0, th, tw, /*E=*/0, T, tp, mask,
                             valid_h, valid_w, out, out_dtype);
  } else if constexpr (RUNG == 2) {
    // + the r*T-deep ghost window from the neighbours, written whole into
    // the padded (h+2d, w+2d) output.  Neighbouring tiles' windows overlap
    // there and write the same values.
    const int d = (K / 2) * T;
    const int w0h = th + 2 * d, S = tw + 2 * d;
    const int ly0 = y0 - d, lx0 = x0 - d;
    const int row0 = (b / g.gcols) * h + ly0, col0 = (b % g.gcols) * w + lx0;
    fill_window(g, b, c, ly0, lx0, w0h, S, d, mask != 0, row0, col0, valid_h,
                valid_w, smem);
    __syncthreads();
    const int ph = h + 2 * d, pw = w + 2 * d;
    const int nh = min(w0h, ph - y0), nw = min(S, pw - x0);
    const long long obase =
        (static_cast<long long>(b) * g.C + c) * ph * static_cast<long long>(pw);
    for (int y = warp; y < nh; y += warps)
      for (int x = lane; x < nw; x += 32)
        store_f32(out, out_dtype,
                  obase + static_cast<long long>(y0 + y) * pw + x0 + x,
                  smem[y * S + x]);
  } else {
    // r0: the tile from the stacked grid's base pointer; r1: + the block's
    // address from the pointer table.  Into shared memory and back out.
    const void* src = RUNG == 0 ? base : reinterpret_cast<const void*>(g.ptrs[b]);
    const long long plane =
        (RUNG == 0 ? static_cast<long long>(b) * g.C + c
                   : static_cast<long long>(c)) * h * static_cast<long long>(w);
    const int nh = min(th, h - y0), nw = min(tw, w - x0);
    for (int y = warp; y < nh; y += warps)
      for (int x = lane; x < nw; x += 32)
        smem[y * tw + x] = load_f32(
            src, g.in_dtype, plane + static_cast<long long>(y0 + y) * w + x0 + x);
    __syncthreads();
    const long long obase =
        (static_cast<long long>(b) * g.C + c) * h * static_cast<long long>(w);
    for (int y = warp; y < nh; y += warps)
      for (int x = lane; x < nw; x += 32)
        store_f32(out, out_dtype,
                  obase + static_cast<long long>(y0 + y) * w + x0 + x,
                  smem[y * tw + x]);
  }
}

template <int RUNG, int K, int EPI>
cudaError_t launch_ladder(const BlockGrid& g, const void* base, int nb,
                          void* out, int out_dtype, int T, const Taps& tp,
                          int mask, int valid_h, int valid_w, int th, int tw,
                          size_t bytes, int threads, cudaStream_t st) {
  const cudaError_t e = allow_smem(rdma_ladder_kernel<RUNG, K, EPI>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((g.w + tw - 1) / tw, (g.h + th - 1) / th, nb * g.C);
  rdma_ladder_kernel<RUNG, K, EPI><<<grid, threads, bytes, st>>>(
      g, base, out, out_dtype, T, tp, mask, valid_h, valid_w, th, tw);
  return cudaGetLastError();
}

}  // namespace

// All entry points return a cudaError_t value: 0 on a successful launch.

// 5a.  `in` holds n elements (bf16: n packed pairs), `out` kChains * n;
// af / bf / ai / bi are host arrays of kChains constants.
extern "C" int pc_op_chain(int op, const void* in, void* out, long long n,
                           const float* af, const float* bf, const int* ai,
                           const int* bi, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  ChainConsts k;
  for (int c = 0; c < kChains; ++c) {
    k.af[c] = af[c];
    k.bf[c] = bf[c];
    k.ai[c] = ai[c];
    k.bi[c] = bi[c];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kFmaF32: return launch_chain<kFmaF32>(in, out, n, k, st);
    case kFmaBF16: return launch_chain<kFmaBF16>(in, out, n, k, st);
    case kMulAddI32: return launch_chain<kMulAddI32>(in, out, n, k, st);
    case kMulAddI16: return launch_chain<kMulAddI16>(in, out, n, k, st);
    case kAddI32: return launch_chain<kAddI32>(in, out, n, k, st);
    case kAddI16: return launch_chain<kAddI16>(in, out, n, k, st);
    case kAddF32: return launch_chain<kAddF32>(in, out, n, k, st);
    case kRintAdd: return launch_chain<kRintAdd>(in, out, n, k, st);
    case kMagicAdd: return launch_chain<kMagicAdd>(in, out, n, k, st);
    case kClampAdd: return launch_chain<kClampAdd>(in, out, n, k, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 5b.  One launch of out = in + 1 (n floats) with `bytes` of dynamic
// shared memory; with opt_in the attribute is raised to `bytes` first and
// its return code lands in *attr_err.  Returns the launch's code.
extern "C" int pc_smem_probe(const float* in, float* out, int n,
                             long long bytes, int opt_in, int* attr_err,
                             void* stream) {
  *attr_err = 0;
  if (n < 1 || bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int words = static_cast<int>(bytes / sizeof(float));
  const dim3 grid((n + 255) / 256), block(256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (opt_in) {
    *attr_err = static_cast<int>(cudaFuncSetAttribute(
        smem_probe_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes)));
    smem_probe_kernel<1><<<grid, block, static_cast<size_t>(bytes), st>>>(
        in, out, n, words);
  } else {
    smem_probe_kernel<0><<<grid, block, static_cast<size_t>(bytes), st>>>(
        in, out, n, words);
  }
  return static_cast<int>(cudaGetLastError());
}

// The runtime's own reading of the opt-in limit (5b prints it beside
// torch's and beside what launches accept).
extern "C" int pc_smem_optin(int device, int* value) {
  return static_cast<int>(cudaDeviceGetAttribute(
      value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// 5c.  Arguments as pc_rdma_step (csrc/rdma.cu) with E = 0, plus the rung
// and the stacked grid's base pointer (r0).  Output: r0 / r1 the stacked
// grid (nb, C, h, w); r2 the padded grid (nb, C, h+2rT, w+2rT); r3 the
// stacked grid after T levels.  r0-r2 are instantiated once (k = 3, float);
// their k only sets r2's depth.
extern "C" int pc_rdma_ladder(int rung, const void* base,
                              const long long* ptrs, const int* nbr,
                              int in_dtype, void* out, int out_dtype, int nb,
                              int gcols, int C, int h, int w, int T,
                              const float* taps, int k, int epi, int mask,
                              int valid_h, int valid_w, int th, int tw,
                              int threads, void* stream) {
  Taps tp;
  if (!fill_taps(&tp, taps, nullptr, nullptr, k, 0) || rung < 0 || rung > 3 ||
      T < 1 || nb < 1 || gcols < 1 || nb % gcols != 0 || C < 1 || h < 1 ||
      w < 1 || (k / 2) * T > (h < w ? h : w) || th < 1 || tw < 1 ||
      nb * C > 65535 || !threads_ok(threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const BlockGrid g{ptrs, nbr, gcols, C, h, w, in_dtype};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t tile = sizeof(float) * th * tw;
  switch (rung) {
    case 0:
      return launch_ladder<0, 3, kEpiFloat>(g, base, nb, out, out_dtype, T,
                                            tp, mask, valid_h, valid_w, th,
                                            tw, tile, threads, st);
    case 1:
      return launch_ladder<1, 3, kEpiFloat>(g, base, nb, out, out_dtype, T,
                                            tp, mask, valid_h, valid_w, th,
                                            tw, tile, threads, st);
    case 2:
      // r2's depth is (k / 2) * T: instantiate on k for it.
      return static_cast<int>(with_k(k, [&](auto K) {
        return launch_ladder<2, decltype(K)::value, kEpiFloat>(
            g, base, nb, out, out_dtype, T, tp, mask, valid_h, valid_w, th,
            tw, window_bytes(k, T, th, tw), threads, st);
      }));
    default:
      return static_cast<int>(with_k(k, [&](auto K) {
        return with_epi(epi, [&](auto E) {
          return launch_ladder<3, decltype(K)::value, decltype(E)::value>(
              g, base, nb, out, out_dtype, T, tp, mask, valid_h, valid_w, th,
              tw, window_bytes(k, T, th, tw), threads, st);
        });
      }));
  }
}

PC_EXPORT_ERROR_NAME
