// Hand-written Hopper (sm_90a) stencil kernels of parallel_convolution_tpu_torch.
//
// Two kernels, each behind a plain C entry point loaded with ctypes
// (parallel_convolution_tpu_torch/ops/_build.py builds this file with nvcc,
// ops/stencil.py binds and checks every argument before it gets here):
//
// K1 stencil_step_kernel -- replaces the TPU kernel
//    parallel_convolution_tpu/ops/pallas_stencil.py:_stencil_kernel (launched by
//    correlate_padded_pallas).  One stencil step on an already-padded
//    (C, H+2r, W+2r) block -> (C, H, W), with the optional fused u8 store-back.
//    Bound on the H100: bytes.  Every output pixel reads one input pixel's worth
//    of new data and does k*k (or 2k separable) FMAs, far below the card's
//    ~20 FP32 operations per byte.  The design reads each haloed input window
//    from device memory once into shared memory (neighbouring threads on
//    neighbouring addresses) and writes each output once; the taps are kernel
//    parameters (constant bank), so the inner loop touches only shared memory.
//
// K2 fused_iterate_kernel -- replaces the TPU kernel
//    parallel_convolution_tpu/ops/pallas_stencil.py:_fused_kernel (launched by
//    fused_iterate_pallas, levels as in _iterate_levels).  T stencil levels on
//    a deep-padded (C, h+2rT, w+2rT) block in one launch: one device-memory
//    read and one write buy T iterations.  Bound on the H100 at T = 32:
//    operations (T levels of k*k FMAs per pixel against one read and one write).
//    The design keeps every level in shared memory, ping-ponging between two
//    f32 buffers whose live window shrinks by r on every side per level, and
//    pays the rim recompute (th+2rT)(tw+2rT)/(th*tw) to avoid any device-memory
//    traffic between levels.  Where T levels of a tile do not fit in shared
//    memory the wrapper runs the levels in groups, one launch each.
//
// The semantics both kernels share with K3 and K4 (csrc/rdma.cu) -- tap
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

constexpr int kStepThreadsX = 32, kStepThreadsY = 8;

// ---------------------------------------------------------------------------
// K1: one stencil step.  Block = one (channel, th x tw output tile).
// Shared memory: the (th+2r) x (tw+2r) window, plus (th+2r) x tw for the
// separable row pass.
// ---------------------------------------------------------------------------
template <int KT>
__global__ void stencil_step_kernel(const void* __restrict__ in, int in_dtype,
                                    void* __restrict__ out, int out_dtype,
                                    int Hp, int Wp, int H, int W, Taps tp,
                                    int k, int sep, int quant, int convex,
                                    int th, int tw) {
  extern __shared__ float smem[];
  const int r = k / 2;
  const int wh = th + 2 * r, ww = tw + 2 * r;
  float* win = smem;
  float* acc1 = smem + wh * ww;
  const int c = blockIdx.z;
  const int y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  const long long in_base = static_cast<long long>(c) * Hp * Wp;
  const long long out_base = static_cast<long long>(c) * H * W;

  // Stage the haloed window; positions past the padded extent (the ragged
  // last tile) read as 0 and only feed outputs that are never stored.
  for (int wy = threadIdx.y; wy < wh; wy += blockDim.y) {
    const int gy = y0 + wy;
    for (int wx = threadIdx.x; wx < ww; wx += blockDim.x) {
      const int gx = x0 + wx;
      float v = 0.f;
      if (gy < Hp && gx < Wp)
        v = load_f32(in, in_dtype, in_base + static_cast<long long>(gy) * Wp + gx);
      win[wy * ww + wx] = v;
    }
  }
  __syncthreads();

  const int oh = min(th, H - y0), ow = min(tw, W - x0);
  if (sep) {
    for (int y = threadIdx.y; y < wh; y += blockDim.y)
      for (int x = threadIdx.x; x < ow; x += blockDim.x)
        acc1[y * tw + x] = row_pass<KT>(win, ww, y, x, tp, k);
    __syncthreads();
  }
  for (int y = threadIdx.y; y < oh; y += blockDim.y) {
    for (int x = threadIdx.x; x < ow; x += blockDim.x) {
      float acc = sep ? col_pass<KT>(acc1, tw, y, x, tp, k)
                      : corr2d<KT>(win, ww, y, x, tp, k);
      if (quant) acc = quantize(acc, convex);
      store_f32(out, out_dtype,
                out_base + static_cast<long long>(y0 + y) * W + x0 + x, acc);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: T fused levels.  Block = one (channel, th x tw output tile).
// Shared memory: two f32 buffers of the level-0 window (th+2rT) x (tw+2rT),
// row stride tw+2rT; level s lives in the top-left (th+2r(T-s)) x
// (tw+2r(T-s)) of one of them.
// ---------------------------------------------------------------------------
template <int KT>
__global__ void fused_iterate_kernel(const void* __restrict__ in, int in_dtype,
                                     void* __restrict__ out, int out_dtype,
                                     int Hp, int Wp, int h, int w, int T,
                                     Taps tp, int k, int sep, int quant,
                                     int convex, int off_r, int off_c,
                                     int mask, int valid_h, int valid_w,
                                     int th, int tw) {
  extern __shared__ float smem[];
  const int r = k / 2;
  const int R = r * T;
  const int w0h = th + 2 * R, S = tw + 2 * R;
  float* a = smem;
  float* b = smem + w0h * S;
  const int c = blockIdx.z;
  const int y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  // Global image coordinates of the level-0 window's top-left corner.
  const int row0 = off_r - R + y0, col0 = off_c - R + x0;
  const long long in_base = static_cast<long long>(c) * Hp * Wp;
  const long long out_base = static_cast<long long>(c) * h * w;

  // Level 0 with the select tier: out-of-image positions become exactly 0.
  for (int wy = threadIdx.y; wy < w0h; wy += blockDim.y) {
    const int gy = y0 + wy;
    const bool row_ok = !mask || (row0 + wy >= 0 && row0 + wy < valid_h);
    for (int wx = threadIdx.x; wx < S; wx += blockDim.x) {
      const int gx = x0 + wx;
      float v = 0.f;
      const bool ok =
          row_ok && (!mask || (col0 + wx >= 0 && col0 + wx < valid_w));
      if (ok && gy < Hp && gx < Wp)
        v = load_f32(in, in_dtype, in_base + static_cast<long long>(gy) * Wp + gx);
      a[wy * S + wx] = v;
    }
  }
  __syncthreads();

  a = fused_levels<KT>(a, b, S, th, tw, T, r, tp, k, sep, quant, convex, mask,
                       row0, col0, valid_h, valid_w);

  const int oh = min(th, h - y0), ow = min(tw, w - x0);
  for (int y = threadIdx.y; y < oh; y += blockDim.y)
    for (int x = threadIdx.x; x < ow; x += blockDim.x)
      store_f32(out, out_dtype,
                out_base + static_cast<long long>(y0 + y) * w + x0 + x,
                a[y * S + x]);
}

template <int KT>
cudaError_t launch_step(const void* in, int in_dtype, void* out, int out_dtype,
                        int C, int Hp, int Wp, int H, int W, const Taps& tp,
                        int k, int sep, int quant, int convex, int th, int tw,
                        cudaStream_t stream) {
  const int r = k / 2;
  const size_t bytes =
      sizeof(float) * static_cast<size_t>(th + 2 * r) *
      static_cast<size_t>((tw + 2 * r) + (sep ? tw : 0));
  cudaError_t e = allow_smem(stencil_step_kernel<KT>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 block(kStepThreadsX, kStepThreadsY);
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, C);
  stencil_step_kernel<KT><<<grid, block, bytes, stream>>>(
      in, in_dtype, out, out_dtype, Hp, Wp, H, W, tp, k, sep, quant, convex,
      th, tw);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_fused(const void* in, int in_dtype, void* out,
                         int out_dtype, int C, int Hp, int Wp, int h, int w,
                         int T, const Taps& tp, int k, int sep, int quant,
                         int convex, int off_r, int off_c, int mask,
                         int valid_h, int valid_w, int th, int tw,
                         cudaStream_t stream) {
  const int R = (k / 2) * T;
  const size_t bytes = 2 * sizeof(float) * static_cast<size_t>(th + 2 * R) *
                       static_cast<size_t>(tw + 2 * R);
  cudaError_t e = allow_smem(fused_iterate_kernel<KT>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 block(kFusedThreadsX, kFusedThreadsY);
  const dim3 grid((w + tw - 1) / tw, (h + th - 1) / th, C);
  fused_iterate_kernel<KT><<<grid, block, bytes, stream>>>(
      in, in_dtype, out, out_dtype, Hp, Wp, h, w, T, tp, k, sep, quant,
      convex, off_r, off_c, mask, valid_h, valid_w, th, tw);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value: 0 on a successful launch.  Pointers are device
// pointers except taps/col/row (host arrays of k*k, k and k floats).
extern "C" int pc_stencil_step(const void* in, int in_dtype, void* out,
                               int out_dtype, int C, int Hp, int Wp, int H,
                               int W, const float* taps, const float* col,
                               const float* row, int k, int sep, int quant,
                               int convex, int th, int tw, void* stream) {
  Taps tp;
  if (!fill_taps(&tp, taps, col, row, k, sep) || th < 1 || tw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3:
      return launch_step<3>(in, in_dtype, out, out_dtype, C, Hp, Wp, H, W, tp,
                            k, sep, quant, convex, th, tw, st);
    case 5:
      return launch_step<5>(in, in_dtype, out, out_dtype, C, Hp, Wp, H, W, tp,
                            k, sep, quant, convex, th, tw, st);
    default:
      return launch_step<0>(in, in_dtype, out, out_dtype, C, Hp, Wp, H, W, tp,
                            k, sep, quant, convex, th, tw, st);
  }
}

extern "C" int pc_fused_iterate(const void* in, int in_dtype, void* out,
                                int out_dtype, int C, int Hp, int Wp, int h,
                                int w, int T, const float* taps,
                                const float* col, const float* row, int k,
                                int sep, int quant, int convex, int off_r,
                                int off_c, int mask, int valid_h, int valid_w,
                                int th, int tw, void* stream) {
  Taps tp;
  if (!fill_taps(&tp, taps, col, row, k, sep) || T < 1 || th < 1 || tw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3:
      return launch_fused<3>(in, in_dtype, out, out_dtype, C, Hp, Wp, h, w, T,
                             tp, k, sep, quant, convex, off_r, off_c, mask,
                             valid_h, valid_w, th, tw, st);
    case 5:
      return launch_fused<5>(in, in_dtype, out, out_dtype, C, Hp, Wp, h, w, T,
                             tp, k, sep, quant, convex, off_r, off_c, mask,
                             valid_h, valid_w, th, tw, st);
    default:
      return launch_fused<0>(in, in_dtype, out, out_dtype, C, Hp, Wp, h, w, T,
                             tp, k, sep, quant, convex, off_r, off_c, mask,
                             valid_h, valid_w, th, tw, st);
  }
}
