// The body of K3 / K4 (csrc/rdma.cu), shared with the construct ladder of
// csrc/probes.cu, whose last rung is K4 itself: the grid of blocks as the
// kernels see it, the level-0 window gather from a block and its eight
// neighbours, and one output tile of T levels.

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
// ring (the ragged last tile) and, under `mask`, outside the global image
// read as exactly 0; (row0, col0) are the window's global coordinates.
// The caller synchronises.
__device__ __forceinline__ void fill_window(const BlockGrid& g, int b, int c,
                                            int ly0, int lx0, int w0h, int S,
                                            int d, int mask, int row0,
                                            int col0, int valid_h,
                                            int valid_w, float* a) {
  const int h = g.h, w = g.w;
  const long long plane = static_cast<long long>(c) * h * w;
  for (int wy = threadIdx.y; wy < w0h; wy += blockDim.y) {
    const int ly = ly0 + wy;
    const int di = ly < 0 ? 0 : (ly < h ? 1 : 2);
    const bool row_ok = ly >= -d && ly < h + d &&
                        (!mask || (row0 + wy >= 0 && row0 + wy < valid_h));
    const long long line =
        plane + static_cast<long long>(ly - (di - 1) * h) * w;
    const void* src_l = source_block(g, b, di * 3);
    const void* src_c = source_block(g, b, di * 3 + 1);
    const void* src_r = source_block(g, b, di * 3 + 2);
    for (int wx = threadIdx.x; wx < S; wx += blockDim.x) {
      const int lx = lx0 + wx;
      const int dj = lx < 0 ? 0 : (lx < w ? 1 : 2);
      const void* p = dj == 0 ? src_l : (dj == 1 ? src_c : src_r);
      const bool ok = row_ok && p != nullptr && lx >= -d && lx < w + d &&
                      (!mask || (col0 + wx >= 0 && col0 + wx < valid_w));
      a[wy * S + wx] =
          ok ? load_f32(p, g.in_dtype, line + lx - (dj - 1) * w) : 0.f;
    }
  }
}

// One th x tw output tile at (y0, x0) of block b, channel c.  Output
// coordinates are block-local coordinates shifted by E (the output is the
// block extended by E on every side); the level-0 window reaches
// d = r*T + E <= min(h, w) beyond the block, so every window position lies
// in the block or in one of its eight neighbours.
template <int KT>
__device__ void rdma_tile(const BlockGrid& g, int b, int c, int y0, int x0,
                          int th, int tw, int E, int T, const Taps& tp, int k,
                          int quant, int convex, int mask, int valid_h,
                          int valid_w, void* __restrict__ out, int out_dtype) {
  extern __shared__ float smem[];
  const int r = k / 2, R = r * T, d = R + E;
  const int h = g.h, w = g.w;
  const int w0h = th + 2 * R, S = tw + 2 * R;
  float* a = smem;
  float* b2 = smem + w0h * S;
  const int ly0 = y0 - d, lx0 = x0 - d;  // window top-left, block-local
  // Global image coordinates of the level-0 window's top-left corner.
  const int row0 = (b / g.gcols) * h + ly0, col0 = (b % g.gcols) * w + lx0;

  fill_window(g, b, c, ly0, lx0, w0h, S, d, mask, row0, col0, valid_h,
              valid_w, a);
  __syncthreads();

  a = fused_levels<KT>(a, b2, S, th, tw, T, r, tp, k, /*sep=*/0, quant,
                       convex, mask, row0, col0, valid_h, valid_w);

  const int oh = h + 2 * E, ow = w + 2 * E;
  const int nh = min(th, oh - y0), nw = min(tw, ow - x0);
  const long long obase =
      (static_cast<long long>(b) * g.C + c) * oh * static_cast<long long>(ow);
  for (int y = threadIdx.y; y < nh; y += blockDim.y)
    for (int x = threadIdx.x; x < nw; x += blockDim.x)
      store_f32(out, out_dtype,
                obase + static_cast<long long>(y0 + y) * ow + x0 + x,
                a[y * S + x]);
}

}  // namespace pc
