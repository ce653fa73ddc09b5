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

// The packed transport's gather (rdma_pack_kernel; replaces the JAX
// package's _packed_slab_copy / _pack_cols, pallas_rdma.py:293 and :743):
// for every block b of [b0, b0 + count), its two edge column slabs at ring
// depth D and row-padded height into its staging (staged_index's layout),
// in the input dtype, rows beyond the block from its upper / lower
// neighbour (zeros where there is none: the reader masks the image edge by
// global coordinates anyway).
//
// What bounds it on the H100: bytes, and at the main path's slabs (a few
// hundred KB a block) the launch itself -- 2 * C * (h + 2D) * D elements
// read once and written once.  The design moves them as plain copies:
//   - a staged row is D contiguous elements, D * elt bytes; the source row
//     segment is contiguous too, at column 0 or w - D of the block row.  A
//     thread moves one vector of V bytes (V = sizeof(Vec): 16, 8, 4, 2 or
//     1), and neighbouring threads (threadIdx.x) move neighbouring vectors
//     of one staged row, so loads and stores are coalesced.  The host
//     (ops/rdma.py:pack_plan) picks the widest V that divides both base
//     addresses, the row pitch w * elt, the right slab's offset
//     (w - D) * elt and D * elt, and the launch shape; one instance a V,
//     the element type does not matter to a copy;
//   - blockIdx.z runs over (block of the range, side, channel) and
//     blockIdx.y / threadIdx.y over the h + 2D staged rows, both
//     grid-strided: one 32-bit division a (block, side, channel), none an
//     element;
//   - the upper, own and lower blocks' addresses are read from the
//     neighbour table once a thread, and each row picks one of the three
//     from its row alone;
//   - index math is 32-bit but for each row's two base offsets (the source
//     plane and the staging), which are 64-bit.
// Why not TMA: a tensor map needs a global row pitch that is a multiple
// of 16 bytes, which config 2's blocks (2520 B) and the 256-rank split's
// (158 B) do not have, and a gather of 8-96-byte row segments that every
// byte visits once has no shared-memory reuse for a bulk copy to win.
template <typename Vec>
__global__ void __launch_bounds__(256)
    rdma_pack_kernel(BlockGrid g, int count, int D, int elt) {
  const int h = g.h, w = g.w, H2 = h + 2 * D;
  const int nv = D * elt / static_cast<int>(sizeof(Vec));  // vectors a row
  const int per = 2 * g.C, nz = count * per;
  const int row_bytes = D * elt, pitch = w * elt;
  for (int z = blockIdx.z; z < nz; z += gridDim.z) {
    const int bi = z / per, sc = z - bi * per;
    const int side = sc / g.C, c = sc - side * g.C;
    const int b = g.b0 + bi;
    const char* up = static_cast<const char*>(source_block(g, b, 1));
    const char* own = static_cast<const char*>(source_block(g, b, 4));
    const char* down = static_cast<const char*>(source_block(g, b, 7));
    const int col0 = side == 0 ? 0 : (w - D) * elt;
    char* stage = reinterpret_cast<char*>(g.stage[b]) +
                  static_cast<long long>(side * g.C + c) * H2 * row_bytes;
    for (int row = blockIdx.y * blockDim.y + threadIdx.y; row < H2;
         row += gridDim.y * blockDim.y) {
      const int ly = row - D;
      // The source row: the upper neighbour's last D rows, the block's
      // own, or the lower neighbour's first D.
      const char* src = ly < 0 ? up : (ly < h ? own : down);
      const int sy = ly < 0 ? ly + h : (ly < h ? ly : ly - h);
      Vec* dst = reinterpret_cast<Vec*>(
          stage + static_cast<long long>(row) * row_bytes);
      if (src != nullptr) {
        const Vec* s = reinterpret_cast<const Vec*>(
            src + (static_cast<long long>(c) * h + sy) * pitch + col0);
        for (int v = threadIdx.x; v < nv; v += blockDim.x) dst[v] = s[v];
      } else {
        for (int v = threadIdx.x; v < nv; v += blockDim.x) dst[v] = Vec{};
      }
    }
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

// One pack launch's arguments, made once by the host for a slot (ops/
// rdma.py:_PackArgs mirrors it field for field) and passed by address, so
// that a launch costs the host one ctypes argument: `ptrs` and `nbr` as
// pc_rdma_step's (device arrays), the stream, blocks [b0, b0 + count) of
// nb (gcols to a grid row), each (C, h, w) in in_dtype, at ring depth D;
// the launch shape as ops/rdma.py:pack_plan gives it.
struct PackArgs {
  long long ptrs, nbr, stream;
  int in_dtype, nb, gcols, b0, count, C, h, w, D;
  int vec, tx, ty, gy, gz;
};

// The packed transport's gather (rdma_pack_kernel) for blocks [b0, b0 +
// count) at ring depth D: every staging address of the range non-zero,
// (2, C, h + 2D, D) elements each.  `vec` bytes a thread (16, 8, 4, 2 or
// 1; it must divide every block's and staging's address, which the caller
// has checked, and w * elt and D * elt, checked here), tx x ty threads, a
// 1 x gy x gz grid.
extern "C" int pc_rdma_pack(const PackArgs* a) {
  const int in_dtype = a->in_dtype, nb = a->nb, gcols = a->gcols;
  const int b0 = a->b0, count = a->count, C = a->C, h = a->h, w = a->w;
  const int D = a->D, vec = a->vec, tx = a->tx, ty = a->ty, gy = a->gy;
  const int gz = a->gz;
  const int elt = in_dtype == kU8 ? 1 : (in_dtype == kBF16 ? 2 : 4);
  if (nb < 1 || gcols < 1 || nb % gcols != 0 || b0 < 0 || count < 1 ||
      b0 + count > nb || C < 1 || h < 1 || w < 1 || D < 1 ||
      D > (h < w ? h : w) || (in_dtype != kU8 && in_dtype != kBF16 &&
                              in_dtype != kF32) ||
      vec < 1 || vec > 16 || (vec & (vec - 1)) != 0 ||
      (w * elt) % vec != 0 || (D * elt) % vec != 0 || tx < 1 || ty < 1 ||
      tx * ty > 256 || gy < 1 || gy > 65535 || gz < 1 || gz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* ptrs = reinterpret_cast<const long long*>(a->ptrs);
  const int* nbr = reinterpret_cast<const int*>(a->nbr);
  BlockGrid g{ptrs, nbr, gcols, C, h, w, in_dtype};
  g.stage = ptrs + nb;
  g.b0 = b0;
  const dim3 grid(1, gy, gz), block(tx, ty);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a->stream);
  switch (vec) {
    case 16:
      rdma_pack_kernel<uint4><<<grid, block, 0, st>>>(g, count, D, elt);
      break;
    case 8:
      rdma_pack_kernel<uint2><<<grid, block, 0, st>>>(g, count, D, elt);
      break;
    case 4:
      rdma_pack_kernel<unsigned int><<<grid, block, 0, st>>>(g, count, D,
                                                             elt);
      break;
    case 2:
      rdma_pack_kernel<unsigned short><<<grid, block, 0, st>>>(g, count, D,
                                                               elt);
      break;
    default:
      rdma_pack_kernel<unsigned char><<<grid, block, 0, st>>>(g, count, D,
                                                              elt);
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
