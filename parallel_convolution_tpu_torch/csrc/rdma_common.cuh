// The body of K3 / K4 (csrc/rdma.cu), shared with the construct ladder of
// csrc/probes.cu, whose last rung is K4 itself: the grid of blocks as the
// kernels see it, the level-0 window gather from a block and its eight
// neighbours (or, with the packed column transport, from its upper and
// lower neighbours and the left and right neighbours' staged slabs), and
// one output tile of T levels (the level loop of stencil_common.cuh).

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
  // device: per block the address of its staged column slabs (the packed
  // transport, rdma_pack_kernel), 0 where a block stages none (strided);
  // null: no staging at all.
  const long long* stage = nullptr;
  int b0 = 0;  // the first block a launch computes; its output is block 0
};

// A rectangle of a launch's output frame: rows [y0, y0 + h), columns
// [x0, x0 + w).
struct Rect {
  int y0, x0, h, w;
};

__device__ __forceinline__ const void* source_block(const BlockGrid& g, int b,
                                                    int slot) {
  const int s = g.nbr[b * 9 + slot];
  return s < 0 ? nullptr : reinterpret_cast<const void*>(g.ptrs[s]);
}

// The staged column slabs of the neighbour in `slot` (3: left, 5: right),
// or null where it has none (no neighbour, or the strided transport).
__device__ __forceinline__ const void* staged_block(const BlockGrid& g, int b,
                                                    int slot) {
  if (g.stage == nullptr) return nullptr;
  const int s = g.nbr[b * 9 + slot];
  return s < 0 ? nullptr : reinterpret_cast<const void*>(g.stage[s]);
}

// Layout of one block's staging at ring depth d: (2, C, h + 2d, d) in the
// input dtype; side 0 holds the block's first d columns, side 1 its last
// d, each at the row-padded height (rows -d .. h+d-1, the rows beyond the
// block from its upper / lower neighbour: the corners' first hop).
__device__ __forceinline__ long long staged_index(const BlockGrid& g, int side,
                                                  int c, int ly, int col,
                                                  int d) {
  return ((static_cast<long long>(side) * g.C + c) * (g.h + 2 * d) + ly + d) *
             d + col;
}

// Fill the w0h x S window `a` (row stride S) whose top-left is the
// block-local (ly0, lx0) of block b, channel c: each window row comes from
// the block row above, this one or the one below (di), each column from the
// block column left, this one or right (dj).  Positions beyond the d-deep
// ring (the ragged last tile) and, when `masked`, outside the global image
// read as exactly 0; (row0, col0) are the window's global coordinates.
// Block-local rows from ly_lim on and columns from lx_lim on are not read
// either (0): a tile reads nothing beyond the cones of the outputs it
// stores (a region of the overlapped pipeline reads no ghost it has not
// waited for).  With STAGED, a ghost column of a neighbour that stages
// its slabs (the packed transport) is read from that staging instead.  A
// 1-D block: each warp fills whole rows.
// The caller synchronises.
template <int DT, bool STAGED>
__device__ void fill_window_as(const BlockGrid& g, int b, int c, int ly0,
                               int lx0, int w0h, int S, int d, bool masked,
                               int row0, int col0, int valid_h, int valid_w,
                               int ly_lim, int lx_lim,
                               float* __restrict__ a) {
  const int h = g.h, w = g.w;
  const int ly_end = min(h + d, ly_lim), lx_end = min(w + d, lx_lim);
  const long long plane = static_cast<long long>(c) * h * w;
  const int lane = threadIdx.x & 31, rows_step = blockDim.x >> 5;
  for (int wy = threadIdx.x >> 5; wy < w0h; wy += rows_step) {
    const int ly = ly0 + wy;
    const int di = ly < 0 ? 0 : (ly < h ? 1 : 2);
    const bool row_ok = ly >= -d && ly < ly_end &&
                        (!masked || (row0 + wy >= 0 && row0 + wy < valid_h));
    const long long line =
        plane + static_cast<long long>(ly - (di - 1) * h) * w;
    const void* src_l = source_block(g, b, di * 3);
    const void* src_c = source_block(g, b, di * 3 + 1);
    const void* src_r = source_block(g, b, di * 3 + 2);
    if constexpr (STAGED) {
      // Packed: the ghost columns (corners included) from the left /
      // right neighbour's staged slabs, its right / left side.
      const void* stg_l = staged_block(g, b, 3);
      const void* stg_r = staged_block(g, b, 5);
      for (int wx = lane; wx < S; wx += 32) {
        const int lx = lx0 + wx;
        const int dj = lx < 0 ? 0 : (lx < w ? 1 : 2);
        const bool in_ring =
            row_ok && lx >= -d && lx < lx_end &&
            (!masked || (col0 + wx >= 0 && col0 + wx < valid_w));
        const void* stg = dj == 0 ? stg_l : (dj == 2 ? stg_r : nullptr);
        float v = 0.f;
        if (stg != nullptr) {
          if (in_ring)
            v = load_as<DT>(stg, dj == 0
                                     ? staged_index(g, 1, c, ly, lx + d, d)
                                     : staged_index(g, 0, c, ly, lx - w, d));
        } else {
          const void* p = dj == 0 ? src_l : (dj == 1 ? src_c : src_r);
          if (in_ring && p != nullptr)
            v = load_as<DT>(p, line + lx - (dj - 1) * w);
        }
        a[wy * S + wx] = v;
      }
    } else {
      for (int wx = lane; wx < S; wx += 32) {
        const int lx = lx0 + wx;
        const int dj = lx < 0 ? 0 : (lx < w ? 1 : 2);
        const void* p = dj == 0 ? src_l : (dj == 1 ? src_c : src_r);
        const bool ok = row_ok && p != nullptr && lx >= -d && lx < lx_end &&
                        (!masked || (col0 + wx >= 0 && col0 + wx < valid_w));
        a[wy * S + wx] =
            ok ? load_as<DT>(p, line + lx - (dj - 1) * w) : 0.f;
      }
    }
  }
}

template <bool STAGED = false>
__device__ __forceinline__ void fill_window(const BlockGrid& g, int b, int c,
                                            int ly0, int lx0, int w0h, int S,
                                            int d, bool masked, int row0,
                                            int col0, int valid_h,
                                            int valid_w, float* a,
                                            int ly_lim = 1 << 30,
                                            int lx_lim = 1 << 30) {
  switch (g.in_dtype) {
    case kBF16:
      fill_window_as<kBF16, STAGED>(g, b, c, ly0, lx0, w0h, S, d, masked,
                                    row0, col0, valid_h, valid_w, ly_lim,
                                    lx_lim, a);
      break;
    case kU8:
      fill_window_as<kU8, STAGED>(g, b, c, ly0, lx0, w0h, S, d, masked, row0,
                                  col0, valid_h, valid_w, ly_lim, lx_lim, a);
      break;
    default:
      fill_window_as<kF32, STAGED>(g, b, c, ly0, lx0, w0h, S, d, masked,
                                   row0, col0, valid_h, valid_w, ly_lim,
                                   lx_lim, a);
  }
}

// One th x tw output tile at (y0, x0) of block b, channel c.  Output
// coordinates are block-local coordinates shifted by E (the output is the
// block extended by E on every side); the level-0 window reaches
// d = r*T + E <= min(h, w) beyond the block, so every window position lies
// in the block or in one of its eight neighbours.  Shared memory: one f32
// buffer of the (th+2rT) x (tw+2rT) window.  STAGED reads the staged
// column slabs of the packed transport where a neighbour has them (K3 /
// K4); the construct ladder of csrc/probes.cu runs the strided form.  The
// tile stores no output at or beyond row ye or column xe (the far edges of
// an output rectangle; the output's own by default), and reads nothing
// beyond the level-0 window of what it stores.
template <int K, int EPI, bool STAGED = true>
__device__ void rdma_tile(const BlockGrid& g, int b, int c, int y0, int x0,
                          int th, int tw, int E, int T, const Taps& tp,
                          int mask, int valid_h, int valid_w,
                          void* __restrict__ out, int out_dtype,
                          int ye = 1 << 30, int xe = 1 << 30) {
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

  fill_window<STAGED>(g, b, c, ly0, lx0, w0h, S, d, !interior, row0, col0,
                      valid_h, valid_w, smem, ye - E + R, xe - E + R);
  __syncthreads();

  const int oh = h + 2 * E, ow = w + 2 * E;
  const TileOut o{out, out_dtype,
                  (static_cast<long long>(b - g.b0) * g.C + c) * oh *
                          static_cast<long long>(ow) +
                      static_cast<long long>(y0) * ow + x0,
                  ow, min(min(th, oh - y0), ye - y0),
                  min(min(tw, ow - x0), xe - x0)};
  if (interior)
    run_levels<K, EPI, false, false>(smem, S, th, tw, T, tp, row0, col0,
                                     valid_h, valid_w, o);
  else
    run_levels<K, EPI, false, true>(smem, S, th, tw, T, tp, row0, col0,
                                    valid_h, valid_w, o);
}

}  // namespace pc
