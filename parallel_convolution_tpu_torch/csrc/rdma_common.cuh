// The body of K3 / K4 (csrc/rdma.cu), shared with the construct ladder of
// csrc/probes.cu, whose last rung is K4 itself: the grid of blocks as the
// kernels see it, the level-0 window gather from a block and its eight
// neighbours, and one output tile of T levels (the level loop of
// stencil_common.cuh).

#pragma once

#include "stencil_common.cuh"

namespace pc {

// The grid of input blocks as the kernels see it.
struct BlockGrid {
  const long long* ptrs;  // device: base address of input block b, (C, h, w)
  const int* nbr;         // device: nb x 9 neighbourhood table, row-major
                          // over (di, dj) in {-1, 0, 1}^2; -1 = no block
  int gcols;              // grid columns: block b sits at (b / gcols, b % gcols)
  int C, h, w;
  int in_dtype;
};

__device__ __forceinline__ const void* source_block(const BlockGrid& g, int b,
                                                    int slot) {
  const int s = g.nbr[b * 9 + slot];
  return s < 0 ? nullptr : reinterpret_cast<const void*>(g.ptrs[s]);
}

// Fill the w0h x S window `a` (row stride S) whose top-left is the
// block-local (ly0, lx0) of block b, channel c: each window row comes from
// the block row above, this one or the one below (di), each column from the
// block column left, this one or right (dj).  Positions beyond the d-deep
// ring (the ragged last tile) and, when `masked`, outside the global image
// read as exactly 0; (row0, col0) are the window's global coordinates.
// A 1-D block: each warp fills whole rows.  The caller synchronises.
template <int DT>
__device__ void fill_window_as(const BlockGrid& g, int b, int c, int ly0,
                               int lx0, int w0h, int S, int d, bool masked,
                               int row0, int col0, int valid_h, int valid_w,
                               float* __restrict__ a) {
  const int h = g.h, w = g.w;
  const long long plane = static_cast<long long>(c) * h * w;
  const int lane = threadIdx.x & 31, rows_step = blockDim.x >> 5;
  for (int wy = threadIdx.x >> 5; wy < w0h; wy += rows_step) {
    const int ly = ly0 + wy;
    const int di = ly < 0 ? 0 : (ly < h ? 1 : 2);
    const bool row_ok = ly >= -d && ly < h + d &&
                        (!masked || (row0 + wy >= 0 && row0 + wy < valid_h));
    const long long line =
        plane + static_cast<long long>(ly - (di - 1) * h) * w;
    const void* src_l = source_block(g, b, di * 3);
    const void* src_c = source_block(g, b, di * 3 + 1);
    const void* src_r = source_block(g, b, di * 3 + 2);
    for (int wx = lane; wx < S; wx += 32) {
      const int lx = lx0 + wx;
      const int dj = lx < 0 ? 0 : (lx < w ? 1 : 2);
      const void* p = dj == 0 ? src_l : (dj == 1 ? src_c : src_r);
      const bool ok = row_ok && p != nullptr && lx >= -d && lx < w + d &&
                      (!masked || (col0 + wx >= 0 && col0 + wx < valid_w));
      a[wy * S + wx] = ok ? load_as<DT>(p, line + lx - (dj - 1) * w) : 0.f;
    }
  }
}

__device__ __forceinline__ void fill_window(const BlockGrid& g, int b, int c,
                                            int ly0, int lx0, int w0h, int S,
                                            int d, bool masked, int row0,
                                            int col0, int valid_h,
                                            int valid_w, float* a) {
  switch (g.in_dtype) {
    case kBF16:
      fill_window_as<kBF16>(g, b, c, ly0, lx0, w0h, S, d, masked, row0, col0,
                            valid_h, valid_w, a);
      break;
    case kU8:
      fill_window_as<kU8>(g, b, c, ly0, lx0, w0h, S, d, masked, row0, col0,
                          valid_h, valid_w, a);
      break;
    default:
      fill_window_as<kF32>(g, b, c, ly0, lx0, w0h, S, d, masked, row0, col0,
                           valid_h, valid_w, a);
  }
}

// One th x tw output tile at (y0, x0) of block b, channel c.  Output
// coordinates are block-local coordinates shifted by E (the output is the
// block extended by E on every side); the level-0 window reaches
// d = r*T + E <= min(h, w) beyond the block, so every window position lies
// in the block or in one of its eight neighbours.  Shared memory: one f32
// buffer of the (th+2rT) x (tw+2rT) window.
template <int K, int EPI>
__device__ void rdma_tile(const BlockGrid& g, int b, int c, int y0, int x0,
                          int th, int tw, int E, int T, const Taps& tp,
                          int mask, int valid_h, int valid_w,
                          void* __restrict__ out, int out_dtype) {
  extern __shared__ float smem[];
  constexpr int r = K / 2;
  const int R = r * T, d = R + E;
  const int h = g.h, w = g.w;
  const int w0h = th + 2 * R, S = tw + 2 * R;
  const int ly0 = y0 - d, lx0 = x0 - d;  // window top-left, block-local
  // Global image coordinates of the level-0 window's top-left corner.
  const int row0 = (b / g.gcols) * h + ly0, col0 = (b % g.gcols) * w + lx0;
  // Block-uniform: no mask of any level can be 0 inside this window.
  const bool interior = !mask || (row0 >= 0 && row0 + w0h <= valid_h &&
                                  col0 >= 0 && col0 + S <= valid_w);

  fill_window(g, b, c, ly0, lx0, w0h, S, d, !interior, row0, col0, valid_h,
              valid_w, smem);
  __syncthreads();

  const int oh = h + 2 * E, ow = w + 2 * E;
  const TileOut o{out, out_dtype,
                  (static_cast<long long>(b) * g.C + c) * oh *
                          static_cast<long long>(ow) +
                      static_cast<long long>(y0) * ow + x0,
                  ow, min(th, oh - y0), min(tw, ow - x0)};
  if (interior)
    run_levels<K, EPI, false, false>(smem, S, th, tw, T, tp, row0, col0,
                                     valid_h, valid_w, o);
  else
    run_levels<K, EPI, false, true>(smem, S, th, tw, T, tp, row0, col0,
                                    valid_h, valid_w, o);
}

}  // namespace pc
