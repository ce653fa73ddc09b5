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
// The per-device form (a grid of slots, ops/rdma.py): the same kernels take
// a subset of the grid's blocks, [b0, b0 + count), one launch per slot on
// that slot's device and stream.  The pointer table holds every block's
// address on its own device; with peer access between distinct cards
// (pc_enable_peer) a neighbour's edge is read over NVLink straight from its
// buffer, on one card the same pointer is local.  The wrapper's barrier
// between slots (events, no host synchronisation) stands in for the TPU's
// _neighbor_barrier.  The packed column transport adds rdma_pack_kernel:
// each slot first stages its two edge column slabs, at the row-padded
// height, in a contiguous buffer on its own device, which the left and
// right neighbours' K3 / K4 then read densely (the JAX package's
// _packed_slab_copy); the strided transport reads the edge columns in
// place.  The two give the same bytes.
//
// The overlapped pipeline (ops/rdma.py, overlap=True on a grid of slots)
// -- replaces the overlap=True / partitioned schedules of _rdma_kernel
// (pallas_rdma.py:486-553) and _rdma_tiled_kernel (:830-965): the same two
// kernels launched on one output rectangle at a time, (y0, x0, rh, rw) at
// run time (no new instance).  K3 takes the rectangle as its one tile; K4
// covers it with its tiles, each clipped at the rectangle's edge so that
// it reads nothing outside the rectangle's level-0 window.  Each slot
// launches its interior first with no wait and every band after its own
// neighbours' events: the TPU's interior computed while the slabs are in
// flight becomes the interior computed while the neighbours' previous
// launches may still run.  What bounds a region launch: the same as its
// kernel's, and a thin band (r*T rows) fills few of K4's 64-row tiles.
//
// The grid, the level-0 gather and the tile body live in rdma_common.cuh,
// which csrc/probes.cu's construct ladder shares.
//
// Semantics, as K2 (stencil_common.cuh): the 2-D row-major tap order (the
// JAX package runs RDMA with sep = None), one __fmaf_rn per tap, the magic
// round (rintf above the L1 bound), the clip skipped for convex filters.  With `mask` (zero boundary), level-0
// positions outside the global image are exactly 0 and every level is
// masked against the global image (valid_h, valid_w).  The output may be
// extended by E ghost rows and columns on every side (in the dtype the
// wrapper picks: f32 in float mode, the storage dtype in quantize mode), for
// the K2 launches that run the later level groups of a deep chunk.

#include "rdma_common.cuh"

using namespace pc;

namespace {

// K3: one CUDA block per (grid block, channel), the output rectangle
// (y0, x0, rh, rw) as one tile; the whole output is (0, 0, h+2E, w+2E).
template <int K, int EPI>
__global__ void __launch_bounds__(kMaxThreads, min_blocks(K))
    rdma_block_kernel(BlockGrid g, void* __restrict__ out, int out_dtype,
                      int E, int T, Taps tp, int mask, int valid_h,
                      int valid_w, Rect rc) {
  const int b = g.b0 + blockIdx.x / g.C, c = blockIdx.x % g.C;
  rdma_tile<K, EPI>(g, b, c, rc.y0, rc.x0, rc.h, rc.w, E, T, tp, mask,
                    valid_h, valid_w, out, out_dtype);
}

// K4: one CUDA block per (th x tw tile of the output rectangle, grid block,
// channel); a tile is clipped at the rectangle's edge: it stores nothing
// beyond it and reads nothing beyond the rectangle's level-0 window.
template <int K, int EPI>
__global__ void __launch_bounds__(kMaxThreads, min_blocks(K))
    rdma_tiled_kernel(BlockGrid g, void* __restrict__ out, int out_dtype,
                      int E, int T, Taps tp, int mask, int valid_h,
                      int valid_w, int th, int tw, Rect rc) {
  const int b = g.b0 + blockIdx.z / g.C, c = blockIdx.z % g.C;
  const int y = rc.y0 + blockIdx.y * th, x = rc.x0 + blockIdx.x * tw;
  rdma_tile<K, EPI>(g, b, c, y, x, th, tw, E, T, tp, mask, valid_h, valid_w,
                    out, out_dtype, rc.y0 + rc.h, rc.x0 + rc.w);
}

// The packed transport's gather: for every block b of [b0, b0 + count),
// its two edge column slabs at ring depth D and row-padded height into its
// staging (staged_index's layout), in the input dtype, rows beyond the
// block from its upper / lower neighbour (zeros where there is none: the
// reader masks the image edge by global coordinates anyway).  One thread a
// staged element, column fastest.
template <typename E>
__global__ void rdma_pack_kernel(BlockGrid g, int count, int D) {
  const int h = g.h, w = g.w, H2 = h + 2 * D;
  const long long per = 2LL * g.C * H2 * D;
  const long long total = per * count;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int b = g.b0 + static_cast<int>(i / per);
    long long r = i % per;
    const int col = static_cast<int>(r % D);
    const int row = static_cast<int>((r / D) % H2);
    const int c = static_cast<int>((r / (static_cast<long long>(D) * H2)) %
                                   g.C);
    const int side = static_cast<int>(r / (static_cast<long long>(D) * H2 *
                                           g.C));
    const int ly = row - D;
    const int di = ly < 0 ? 0 : (ly < h ? 1 : 2);
    const E* src = static_cast<const E*>(source_block(g, b, di * 3 + 1));
    const int lx = side == 0 ? col : w - D + col;
    E v = E(0);
    if (src != nullptr)
      v = src[(static_cast<long long>(c) * h + ly - (di - 1) * h) * w + lx];
    reinterpret_cast<E*>(g.stage[b])[r] = v;
  }
}

template <int K, int EPI>
cudaError_t launch_rdma(int tiled, const BlockGrid& g, int count, void* out,
                        int out_dtype, int E, int T, const Taps& tp, int mask,
                        int valid_h, int valid_w, int th, int tw,
                        const Rect& rc, int threads, int* blocks,
                        cudaStream_t stream) {
  if (!tiled) {
    th = rc.h;
    tw = rc.w;
  }
  th = th < rc.h ? th : rc.h;
  tw = tw < rc.w ? tw : rc.w;
  const size_t bytes = window_bytes(K, T, th, tw);
  cudaError_t e;
  if (tiled) {
    e = allow_smem(rdma_tiled_kernel<K, EPI>, bytes);
    if (e != cudaSuccess) return e;
    if (blocks)
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, rdma_tiled_kernel<K, EPI>, threads, bytes);
    const dim3 grid((rc.w + tw - 1) / tw, (rc.h + th - 1) / th, count * g.C);
    rdma_tiled_kernel<K, EPI><<<grid, threads, bytes, stream>>>(
        g, out, out_dtype, E, T, tp, mask, valid_h, valid_w, th, tw, rc);
  } else {
    e = allow_smem(rdma_block_kernel<K, EPI>, bytes);
    if (e != cudaSuccess) return e;
    if (blocks)
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, rdma_block_kernel<K, EPI>, threads, bytes);
    rdma_block_kernel<K, EPI><<<count * g.C, threads, bytes, stream>>>(
        g, out, out_dtype, E, T, tp, mask, valid_h, valid_w, rc);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value: 0 on a successful launch.  `ptrs` (2 x nb
// int64: every block's address, then every block's staging address or 0)
// and `nbr` (nb x 9 int32) are device arrays on the launching device; the
// launch computes blocks [b0, b0 + count) into `out`, one device buffer of
// count x (C, h+2E, w+2E) blocks, and of each only the rectangle of rh x rw
// outputs at (y0, x0) of that frame (the whole block: 0, 0, h+2E, w+2E;
// the overlapped pipeline launches its regions one by one); taps is a host
// array of k*k floats.  tiled = 0 launches K3 (th, tw unused), 1 launches
// K4 with th x tw tiles over the rectangle; epi is the
// store-back (Epi, stencil_common.cuh); threads is the block's thread count,
// a whole number of warps.  With `blocks` non-null nothing launches:
// *blocks gets the number of such blocks one SM holds.
extern "C" int pc_rdma_step(int tiled, const long long* ptrs, const int* nbr,
                            int in_dtype, void* out, int out_dtype, int nb,
                            int gcols, int b0, int count, int C, int h, int w,
                            int E, int T, const float* taps, int k, int epi,
                            int mask, int valid_h, int valid_w, int th,
                            int tw, int y0, int x0, int rh, int rw,
                            int threads, int* blocks, void* stream) {
  Taps tp;
  if (!fill_taps(&tp, taps, nullptr, nullptr, k, 0) || T < 1 || nb < 1 ||
      gcols < 1 || nb % gcols != 0 || b0 < 0 || count < 1 ||
      b0 + count > nb || C < 1 || h < 1 || w < 1 || E < 0 ||
      (k / 2) * T + E > (h < w ? h : w) || th < 1 || tw < 1 || y0 < 0 ||
      x0 < 0 || rh < 1 || rw < 1 || y0 + rh > h + 2 * E ||
      x0 + rw > w + 2 * E ||
      (tiled && count * C > 65535) || !threads_ok(threads))
    return static_cast<int>(cudaErrorInvalidValue);
  BlockGrid g{ptrs, nbr, gcols, C, h, w, in_dtype};
  g.stage = ptrs + nb;
  g.b0 = b0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_k(k, [&](auto K) {
    return with_epi(epi, [&](auto E_) {
      return launch_rdma<decltype(K)::value, decltype(E_)::value>(
          tiled, g, count, out, out_dtype, E, T, tp, mask, valid_h, valid_w,
          th, tw, Rect{y0, x0, rh, rw}, threads, blocks, st);
    });
  }));
}

// The packed transport's gather (rdma_pack_kernel) for blocks [b0, b0 +
// count) at ring depth D: `ptrs` as pc_rdma_step's, every staging address
// of the range non-zero, (2, C, h + 2D, D) elements each.
extern "C" int pc_rdma_pack(const long long* ptrs, const int* nbr,
                            int in_dtype, int nb, int gcols, int b0,
                            int count, int C, int h, int w, int D,
                            void* stream) {
  if (nb < 1 || gcols < 1 || nb % gcols != 0 || b0 < 0 || count < 1 ||
      b0 + count > nb || C < 1 || h < 1 || w < 1 || D < 1 ||
      D > (h < w ? h : w))
    return static_cast<int>(cudaErrorInvalidValue);
  BlockGrid g{ptrs, nbr, gcols, C, h, w, in_dtype};
  g.stage = ptrs + nb;
  g.b0 = b0;
  const long long total = 2LL * C * (h + 2LL * D) * D * count;
  const int threads = 256;
  const int grid = static_cast<int>(
      (total + threads - 1) / threads < 8192 ? (total + threads - 1) / threads
                                             : 8192);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kU8:
      rdma_pack_kernel<unsigned char><<<grid, threads, 0, st>>>(g, count, D);
      break;
    case kBF16:
      rdma_pack_kernel<unsigned short><<<grid, threads, 0, st>>>(g, count, D);
      break;
    default:
      rdma_pack_kernel<float><<<grid, threads, 0, st>>>(g, count, D);
  }
  return static_cast<int>(cudaGetLastError());
}

// Peer access from `device` to `peer` (a grid of slots over several cards
// reads its neighbours' buffers in place).  0 when enabled (or already
// enabled); cudaErrorPeerAccessUnsupported when the pair cannot, else the
// runtime's error.  Restores the calling thread's device.
extern "C" int pc_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int cur = 0;
  e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear the sticky-free error state
      e = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(cur);
  return static_cast<int>(e != cudaSuccess ? e : back);
}

PC_EXPORT_ERROR_NAME
