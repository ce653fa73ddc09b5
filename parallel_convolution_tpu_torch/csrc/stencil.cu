// Hand-written Hopper (sm_90a) stencil kernels of parallel_convolution_tpu_torch.
//
// K2 here, and the entry point of K1 (csrc/step.cu), each behind a plain C
// entry point loaded with ctypes (parallel_convolution_tpu_torch/ops/_build.py
// builds this file and step.cu's parts with nvcc and links them into
// libstencil.so; ops/stencil.py binds and checks every argument before it
// gets here):
//
// K2 fused_iterate_kernel -- replaces the TPU kernel
//    parallel_convolution_tpu/ops/pallas_stencil.py:_fused_kernel (launched by
//    fused_iterate_pallas, levels as in _iterate_levels).  T stencil levels on
//    a deep-padded (C, h+2rT, w+2rT) block in one launch: one device-memory
//    read and one write buy T iterations.  Bound on the H100 at T = 32:
//    operations (T levels of k*k FMAs per pixel against one read and one write).
//    In practice the level loop is held by the shared-memory pipe before the
//    FMA pipe, so the design spends shared-memory words sparingly: the levels
//    run in place in ONE f32 buffer of the level-0 window, in register strips
//    (k(V+k-1)/V loads per output, the row pass of the separable order kept in
//    registers), mask-free on tiles inside the image, with the magic round,
//    every variant a template instance (run_levels, stencil_common.cuh).  One
//    buffer instead of two doubles the blocks an SM holds.  The rim recompute
//    (th+2rT)(tw+2rT)/(th*tw) is the price of no device-memory traffic between
//    levels; where T levels of a tile do not fit in shared memory, or the rim
//    would cost more than a launch, the wrapper runs them in level groups.
//
// The semantics K1 and K2 share with K3 and K4 (csrc/rdma.cu) -- tap
// order, FMA, round and clip, dtype conversions -- and K2's level loop live
// in stencil_common.cuh.
//
// K2 also re-zeroes the ghost ring at every level: one select on the level-0
// window (out-of-image positions become exactly 0), then after each level a
// multiply by a 0/1 row mask and a 0/1 column mask against the global image
// extent, as _iterate_levels does, so even signed zeros agree in float mode.

#include "stencil_common.cuh"

using namespace pc;

namespace {

// ---------------------------------------------------------------------------
// K2: T fused levels.  Block = one (channel, th x tw output tile), a 1-D
// block of a whole number of warps.  Shared memory: ONE f32 buffer of the
// level-0 window (th+2rT) x (tw+2rT), row stride tw+2rT; level s lives in
// its top-left (th+2r(T-s)) x (tw+2r(T-s)).
// ---------------------------------------------------------------------------

// Level 0 from the deep-padded block: positions past the padded extent (the
// ragged last tile) and, when `masked`, outside the global image read as
// exactly 0 (the select tier).
template <int DT>
__device__ void fill_dense(float* __restrict__ a, const void* __restrict__ in,
                           long long in_base, int Hp, int Wp, int y0, int x0,
                           int w0h, int S, bool masked, int row0, int col0,
                           int valid_h, int valid_w) {
  const int lane = threadIdx.x & 31, rows_step = blockDim.x >> 5;
  for (int wy = threadIdx.x >> 5; wy < w0h; wy += rows_step) {
    const int gy = y0 + wy;
    const bool row_ok =
        gy < Hp && (!masked || (row0 + wy >= 0 && row0 + wy < valid_h));
    const long long line = in_base + static_cast<long long>(gy) * Wp + x0;
    for (int wx = lane; wx < S; wx += 32) {
      const bool ok = row_ok && x0 + wx < Wp &&
                      (!masked || (col0 + wx >= 0 && col0 + wx < valid_w));
      a[wy * S + wx] = ok ? load_as<DT>(in, line + wx) : 0.f;
    }
  }
}

// A dropped mask axis (the interior split's patches): its bounds never bind.
constexpr int kUnbounded = 1 << 30;

template <int K, int EPI, bool SEP>
__global__ void __launch_bounds__(kMaxThreads, min_blocks(K))
    fused_iterate_kernel(const void* __restrict__ in, int in_dtype,
                         void* __restrict__ out, int out_dtype, int Hp,
                         int Wp, int h, int w, int T, Taps tp, int off_r,
                         int off_c, int mask_rows, int mask_cols,
                         int valid_h, int valid_w, int th, int tw, int ti0,
                         int tj0) {
  extern __shared__ float smem[];
  constexpr int r = K / 2;
  const int R = r * T;
  const int w0h = th + 2 * R, S = tw + 2 * R;
  const int c = blockIdx.z;
  // The launch covers the patch of the tile grid at (ti0, tj0).
  const int y0 = (blockIdx.y + ti0) * th, x0 = (blockIdx.x + tj0) * tw;
  // Global image coordinates of the level-0 window's top-left corner, and
  // the extent each axis masks against.  A dropped axis (mask_rows or
  // mask_cols 0: a periodic torus, or a patch whose tiles cannot cross
  // that pair of image edges) reads as an origin of 0 in an unbounded
  // extent, so every mask along it is 1: the multiply by 1.0 leaves the
  // bits of the launch that keeps it.
  const int row0 = mask_rows ? off_r - R + y0 : 0;
  const int col0 = mask_cols ? off_c - R + x0 : 0;
  const int vh = mask_rows ? valid_h : kUnbounded;
  const int vw = mask_cols ? valid_w : kUnbounded;
  const long long in_base = static_cast<long long>(c) * Hp * Wp;
  // Block-uniform: no mask of any level can be 0 inside this window.
  const bool interior =
      row0 >= 0 && row0 + w0h <= vh && col0 >= 0 && col0 + S <= vw;
  const bool masked = !interior;
  switch (in_dtype) {
    case kBF16:
      fill_dense<kBF16>(smem, in, in_base, Hp, Wp, y0, x0, w0h, S, masked,
                        row0, col0, vh, vw);
      break;
    case kU8:
      fill_dense<kU8>(smem, in, in_base, Hp, Wp, y0, x0, w0h, S, masked,
                      row0, col0, vh, vw);
      break;
    default:
      fill_dense<kF32>(smem, in, in_base, Hp, Wp, y0, x0, w0h, S, masked,
                       row0, col0, vh, vw);
  }
  __syncthreads();

  const TileOut o{out, out_dtype,
                  static_cast<long long>(c) * h * w +
                      static_cast<long long>(y0) * w + x0,
                  w, min(th, h - y0), min(tw, w - x0)};
  if (interior)
    run_levels<K, EPI, SEP, false>(smem, S, th, tw, T, tp, row0, col0, vh,
                                   vw, o);
  else
    run_levels<K, EPI, SEP, true>(smem, S, th, tw, T, tp, row0, col0, vh,
                                  vw, o);
}

}  // namespace

// K1's parts (csrc/step.cu), one per input dtype and order.
#define PC_STEP_PART(name)                                                    \
  extern "C" int name(const void*, void*, int, int, int, int, int, int,      \
                      const float*, const float*, const float*, int, int,    \
                      int, int, int, int, int, int, int, int, int, int*,     \
                      void*);
PC_STEP_PART(pc_step_in0_sep0)
PC_STEP_PART(pc_step_in0_sep1)
PC_STEP_PART(pc_step_in1_sep0)
PC_STEP_PART(pc_step_in1_sep1)
PC_STEP_PART(pc_step_in2_sep0)
PC_STEP_PART(pc_step_in2_sep1)
#undef PC_STEP_PART

// K1 (csrc/step.cu).  Returns a cudaError_t value: 0 on a successful launch.
// Pointers are device pointers except taps/col/row (host arrays of k*k, k and
// k floats).  epi is the store-back (Epi); th x tw the output tile, rows x
// cols its computed extent, pitch / out_pitch the shared-memory row pitches,
// stages the input stages, threads and grid the launch
// (ops/stencil.py:step_plan).  With `blocks` non-null nothing launches:
// *blocks gets the number of such blocks one SM holds.
extern "C" int pc_stencil_step(const void* in, int in_dtype, void* out,
                               int out_dtype, int C, int Hp, int Wp, int H,
                               int W, const float* taps, const float* col,
                               const float* row, int k, int sep, int epi,
                               int th, int tw, int rows, int cols, int pitch,
                               int out_pitch, int stages, int threads,
                               int grid, int* blocks, void* stream) {
  using Part = int (*)(const void*, void*, int, int, int, int, int, int,
                       const float*, const float*, const float*, int, int,
                       int, int, int, int, int, int, int, int, int, int*,
                       void*);
  static const Part parts[3][2] = {{pc_step_in0_sep0, pc_step_in0_sep1},
                                   {pc_step_in1_sep0, pc_step_in1_sep1},
                                   {pc_step_in2_sep0, pc_step_in2_sep1}};
  if (in_dtype < kF32 || in_dtype > kU8)
    return static_cast<int>(cudaErrorInvalidValue);
  return parts[in_dtype][sep ? 1 : 0](
      in, out, out_dtype, C, Hp, Wp, H, W, taps, col, row, k, epi, th, tw,
      rows, cols, pitch, out_pitch, stages, threads, grid, blocks, stream);
}

// K1's strip height for a k-tap filter (csrc/stencil_common.cuh:strip_v).
extern "C" int pc_step_strip(int k) { return strip_v(k); }

// K2.  epi is the store-back (Epi: float, or the magic round or rintf, with
// or without the clip); mask_rows / mask_cols say which ghost-ring mask
// axes run (both 0: no masks); the launch covers the gh x gw patch of the
// output's th x tw tile grid at tile (ti0, tj0) (the interior split,
// ops/stencil.py:split_patches; the whole grid otherwise); threads is the
// block's thread count, a whole number of warps.  With `blocks` non-null
// nothing launches: *blocks gets the number of such blocks one SM holds.
extern "C" int pc_fused_iterate(const void* in, int in_dtype, void* out,
                                int out_dtype, int C, int Hp, int Wp, int h,
                                int w, int T, const float* taps,
                                const float* col, const float* row, int k,
                                int sep, int epi, int off_r, int off_c,
                                int mask_rows, int mask_cols, int valid_h,
                                int valid_w, int th, int tw, int ti0,
                                int tj0, int gh, int gw, int threads,
                                int* blocks, void* stream) {
  Taps tp;
  if (!fill_taps(&tp, taps, col, row, k, sep) || T < 1 || th < 1 || tw < 1 ||
      !threads_ok(threads) || ti0 < 0 || tj0 < 0 || gh < 1 || gw < 1 ||
      static_cast<long long>(ti0 + gh - 1) * th >= h ||
      static_cast<long long>(tj0 + gw - 1) * tw >= w)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = window_bytes(k, T, th, tw);
  const dim3 grid(gw, gh, C);
  return static_cast<int>(with_k(k, [&](auto K) {
    return with_epi(epi, [&](auto E) {
      return with_bool(sep, [&](auto SEP) {
        auto kernel = fused_iterate_kernel<decltype(K)::value,
                                           decltype(E)::value,
                                           decltype(SEP)::value>;
        cudaError_t e = allow_smem(kernel, bytes);
        if (e != cudaSuccess) return e;
        if (blocks)
          return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              blocks, kernel, threads, bytes);
        kernel<<<grid, threads, bytes, st>>>(
            in, in_dtype, out, out_dtype, Hp, Wp, h, w, T, tp, off_r, off_c,
            mask_rows, mask_cols, valid_h, valid_w, th, tw, ti0, tj0);
        return cudaGetLastError();
      });
    });
  }));
}

// The strip height of the level loop for k <= 5 (k = 7, 9 use 8).
extern "C" int pc_strip_height() { return kStripV; }

PC_EXPORT_ERROR_NAME
