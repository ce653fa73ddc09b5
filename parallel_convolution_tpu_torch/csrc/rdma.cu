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
// run_levels loop of stencil_common.cuh: one f32 buffer, register strips,
// the magic round, no masks on tiles inside the image), paying the same rim
// recompute.
//
// The TPU's two-hop corner propagation (rows first, then full-height
// columns) becomes a direct read of the diagonal block: the same bytes.
// Neither kernel ever writes a block it reads: the output is a separate
// buffer, so a CUDA block writing its output cannot race another reading
// that block's edge (the hazard the TPU's _neighbor_barrier closes between
// devices); stream order between launches stands in for the barrier.
//
// The grid, the level-0 gather and the tile body live in rdma_common.cuh,
// which csrc/probes.cu's construct ladder shares.
//
// Semantics, as K2 (stencil_common.cuh): the 2-D row-major tap order (the
// JAX package runs RDMA with sep = None), one __fmaf_rn per tap, the magic
// round (rintf above the L1 bound), the clip skipped for convex filters.  With `mask` (zero boundary), level-0
// positions outside the global image are exactly 0 and every level is
// masked against the global image (valid_h, valid_w).  The output may be
// extended by E ghost rows and columns on every side (f32), for the K2
// launches that run the later level groups of a deep chunk.

#include "rdma_common.cuh"

using namespace pc;

namespace {

// K3: one CUDA block per (grid block, channel), the whole block as one tile.
template <int K, int EPI>
__global__ void __launch_bounds__(kMaxThreads, min_blocks(K))
    rdma_block_kernel(BlockGrid g, void* __restrict__ out, int out_dtype,
                      int E, int T, Taps tp, int mask, int valid_h,
                      int valid_w) {
  const int b = blockIdx.x / g.C, c = blockIdx.x % g.C;
  rdma_tile<K, EPI>(g, b, c, 0, 0, g.h + 2 * E, g.w + 2 * E, E, T, tp, mask,
                    valid_h, valid_w, out, out_dtype);
}

// K4: one CUDA block per (th x tw output tile, grid block, channel).
template <int K, int EPI>
__global__ void __launch_bounds__(kMaxThreads, min_blocks(K))
    rdma_tiled_kernel(BlockGrid g, void* __restrict__ out, int out_dtype,
                      int E, int T, Taps tp, int mask, int valid_h,
                      int valid_w, int th, int tw) {
  const int b = blockIdx.z / g.C, c = blockIdx.z % g.C;
  rdma_tile<K, EPI>(g, b, c, blockIdx.y * th, blockIdx.x * tw, th, tw, E, T,
                    tp, mask, valid_h, valid_w, out, out_dtype);
}

template <int K, int EPI>
cudaError_t launch_rdma(int tiled, const BlockGrid& g, int nb, void* out,
                        int out_dtype, int E, int T, const Taps& tp, int mask,
                        int valid_h, int valid_w, int th, int tw, int threads,
                        int* blocks, cudaStream_t stream) {
  const int oh = g.h + 2 * E, ow = g.w + 2 * E;
  if (!tiled) {
    th = oh;
    tw = ow;
  }
  const size_t bytes = window_bytes(K, T, th, tw);
  cudaError_t e;
  if (tiled) {
    e = allow_smem(rdma_tiled_kernel<K, EPI>, bytes);
    if (e != cudaSuccess) return e;
    if (blocks)
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, rdma_tiled_kernel<K, EPI>, threads, bytes);
    const dim3 grid((ow + tw - 1) / tw, (oh + th - 1) / th, nb * g.C);
    rdma_tiled_kernel<K, EPI><<<grid, threads, bytes, stream>>>(
        g, out, out_dtype, E, T, tp, mask, valid_h, valid_w, th, tw);
  } else {
    e = allow_smem(rdma_block_kernel<K, EPI>, bytes);
    if (e != cudaSuccess) return e;
    if (blocks)
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, rdma_block_kernel<K, EPI>, threads, bytes);
    rdma_block_kernel<K, EPI><<<nb * g.C, threads, bytes, stream>>>(
        g, out, out_dtype, E, T, tp, mask, valid_h, valid_w);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value: 0 on a successful launch.  `ptrs` (nb int64
// addresses) and `nbr` (nb x 9 int32) are device arrays; `out` is one device
// buffer of nb x (C, h+2E, w+2E) blocks; taps is a host array of k*k floats.
// tiled = 0 launches K3 (th, tw unused), 1 launches K4; epi is the
// store-back (Epi, stencil_common.cuh); threads is the block's thread count,
// a whole number of warps.  With `blocks` non-null nothing launches:
// *blocks gets the number of such blocks one SM holds.
extern "C" int pc_rdma_step(int tiled, const long long* ptrs, const int* nbr,
                            int in_dtype, void* out, int out_dtype, int nb,
                            int gcols, int C, int h, int w, int E, int T,
                            const float* taps, int k, int epi, int mask,
                            int valid_h, int valid_w, int th, int tw,
                            int threads, int* blocks, void* stream) {
  Taps tp;
  if (!fill_taps(&tp, taps, nullptr, nullptr, k, 0) || T < 1 || nb < 1 ||
      gcols < 1 || nb % gcols != 0 || C < 1 || h < 1 || w < 1 || E < 0 ||
      (k / 2) * T + E > (h < w ? h : w) || th < 1 || tw < 1 ||
      (tiled && nb * C > 65535) || !threads_ok(threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const BlockGrid g{ptrs, nbr, gcols, C, h, w, in_dtype};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_k(k, [&](auto K) {
    return with_epi(epi, [&](auto E_) {
      return launch_rdma<decltype(K)::value, decltype(E_)::value>(
          tiled, g, nb, out, out_dtype, E, T, tp, mask, valid_h, valid_w, th,
          tw, threads, blocks, st);
    });
  }));
}
