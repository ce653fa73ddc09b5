// Hand-written Hopper (sm_90a) kernels of the cuda_rdma backend: the halo
// exchange and T stencil levels of every block of an R x C grid in ONE launch.
//
// Two kernels behind one plain C entry point loaded with ctypes
// (ops/_build.py builds this file with nvcc; ops/rdma.py binds and checks
// every argument before it gets here):
//
// K3 rdma_block_kernel -- replaces the TPU kernel
//    parallel_convolution_tpu/ops/pallas_rdma.py:_rdma_kernel
//    (fused_rdma_step(tiled=False)).  One CUDA block per (grid block, channel)
//    holds that grid block's whole level-0 window -- the block plus its
//    r*T-deep ghosts -- in shared memory, fills it from its own buffer and its
//    neighbours' (edge rows, edge columns, and the corners straight from the
//    diagonal block), runs the T levels there and writes its block.
//
// K4 rdma_tiled_kernel -- replaces the TPU kernel
//    parallel_convolution_tpu/ops/pallas_rdma.py:_rdma_tiled_kernel
//    (fused_rdma_step(tiled=True)), for blocks whose window does not fit in
//    one CUDA block's shared memory.  The grid runs over K2's output tiles of
//    every block; each tile gathers its window from up to nine blocks.
//
// What bounds them on the H100: at the main path's depths (T = 8 and 32)
// operations, as for K2 -- T levels of k*k FMAs per pixel against one read
// and one write of the block; at T = 1 bytes.  What the design does about
// it: the ghost exchange costs no device-memory traffic of its own.  On the
// TPU each device pushed edge slabs into its neighbours' buffers, behind a
// neighbour barrier, before computing; here every block of the grid lives on
// the one card, so the level-0 fill reads a neighbour's edge straight from
// that block's buffer.  There is no padded copy of any block in device
// memory and no launch per block, and each input byte is read from device
// memory about once (ghost reads are the neighbours' edges, mostly from L2).
// The levels then run in shared memory exactly as in K2 (the shared
// fused_levels loop), paying the same rim recompute.
//
// The TPU's two-hop corner propagation (rows first, then full-height
// columns) becomes a direct read of the diagonal block: the same bytes.
// Neither kernel ever writes a block it reads: the output is a separate
// buffer, so a CUDA block writing its output cannot race another reading
// that block's edge (the hazard the TPU's _neighbor_barrier closes between
// devices); stream order between launches stands in for the barrier.
//
// Semantics, as K2 (stencil_common.cuh): the 2-D row-major tap order (the
// JAX package runs RDMA with sep = None), one __fmaf_rn per tap, rintf, the
// clip skipped for convex filters.  With `mask` (zero boundary), level-0
// positions outside the global image are exactly 0 and every level is
// masked against the global image (valid_h, valid_w).  The output may be
// extended by E ghost rows and columns on every side (f32), for the K2
// launches that run the later level groups of a deep chunk.

#include "stencil_common.cuh"

using namespace pc;

namespace {

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
  const long long plane = static_cast<long long>(c) * h * w;

  // Level 0: each window row comes from the block row above, this one or
  // the one below (di), each column from the block column left, this one
  // or right (dj).  Positions beyond the d-deep ring (the ragged last
  // tile) and, under `mask`, outside the image read as exactly 0.
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

// K3: one CUDA block per (grid block, channel), the whole block as one tile.
template <int KT>
__global__ void __launch_bounds__(kFusedThreadsX * kFusedThreadsY)
    rdma_block_kernel(BlockGrid g, void* __restrict__ out, int out_dtype,
                      int E, int T, Taps tp, int k, int quant, int convex,
                      int mask, int valid_h, int valid_w) {
  const int b = blockIdx.x / g.C, c = blockIdx.x % g.C;
  rdma_tile<KT>(g, b, c, 0, 0, g.h + 2 * E, g.w + 2 * E, E, T, tp, k, quant,
                convex, mask, valid_h, valid_w, out, out_dtype);
}

// K4: one CUDA block per (th x tw output tile, grid block, channel).
template <int KT>
__global__ void __launch_bounds__(kFusedThreadsX * kFusedThreadsY)
    rdma_tiled_kernel(BlockGrid g, void* __restrict__ out, int out_dtype,
                      int E, int T, Taps tp, int k, int quant, int convex,
                      int mask, int valid_h, int valid_w, int th, int tw) {
  const int b = blockIdx.z / g.C, c = blockIdx.z % g.C;
  rdma_tile<KT>(g, b, c, blockIdx.y * th, blockIdx.x * tw, th, tw, E, T, tp,
                k, quant, convex, mask, valid_h, valid_w, out, out_dtype);
}

template <int KT>
cudaError_t launch_rdma(int tiled, const BlockGrid& g, int nb, void* out,
                        int out_dtype, int E, int T, const Taps& tp, int k,
                        int quant, int convex, int mask, int valid_h,
                        int valid_w, int th, int tw, cudaStream_t stream) {
  const int R = (k / 2) * T;
  const int oh = g.h + 2 * E, ow = g.w + 2 * E;
  if (!tiled) {
    th = oh;
    tw = ow;
  }
  const size_t bytes = 2 * sizeof(float) * static_cast<size_t>(th + 2 * R) *
                       static_cast<size_t>(tw + 2 * R);
  const dim3 block(kFusedThreadsX, kFusedThreadsY);
  cudaError_t e;
  if (tiled) {
    e = allow_smem(rdma_tiled_kernel<KT>, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid((ow + tw - 1) / tw, (oh + th - 1) / th, nb * g.C);
    rdma_tiled_kernel<KT><<<grid, block, bytes, stream>>>(
        g, out, out_dtype, E, T, tp, k, quant, convex, mask, valid_h, valid_w,
        th, tw);
  } else {
    e = allow_smem(rdma_block_kernel<KT>, bytes);
    if (e != cudaSuccess) return e;
    rdma_block_kernel<KT><<<nb * g.C, block, bytes, stream>>>(
        g, out, out_dtype, E, T, tp, k, quant, convex, mask, valid_h,
        valid_w);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value: 0 on a successful launch.  `ptrs` (nb int64
// addresses) and `nbr` (nb x 9 int32) are device arrays; `out` is one device
// buffer of nb x (C, h+2E, w+2E) blocks; taps is a host array of k*k floats.
// tiled = 0 launches K3 (th, tw unused), 1 launches K4.
extern "C" int pc_rdma_step(int tiled, const long long* ptrs, const int* nbr,
                            int in_dtype, void* out, int out_dtype, int nb,
                            int gcols, int C, int h, int w, int E, int T,
                            const float* taps, int k, int quant, int convex,
                            int mask, int valid_h, int valid_w, int th,
                            int tw, void* stream) {
  Taps tp;
  if (!fill_taps(&tp, taps, nullptr, nullptr, k, 0) || T < 1 || nb < 1 ||
      gcols < 1 || nb % gcols != 0 || C < 1 || h < 1 || w < 1 || E < 0 ||
      (k / 2) * T + E > (h < w ? h : w) || th < 1 || tw < 1 ||
      (tiled && nb * C > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  const BlockGrid g{ptrs, nbr, gcols, C, h, w, in_dtype};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3:
      return launch_rdma<3>(tiled, g, nb, out, out_dtype, E, T, tp, k, quant,
                            convex, mask, valid_h, valid_w, th, tw, st);
    case 5:
      return launch_rdma<5>(tiled, g, nb, out, out_dtype, E, T, tp, k, quant,
                            convex, mask, valid_h, valid_w, th, tw, st);
    default:
      return launch_rdma<0>(tiled, g, nb, out, out_dtype, E, T, tp, k, quant,
                            convex, mask, valid_h, valid_w, th, tw, st);
  }
}
