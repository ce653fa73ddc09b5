// K1 stencil_step_kernel -- replaces the TPU kernel
//    parallel_convolution_tpu/ops/pallas_stencil.py:_stencil_kernel (launched by
//    correlate_padded_pallas).  One stencil step on an already-padded
//    (C, H+2r, W+2r) block -> (C, H, W), f32 / bf16 / u8 in and out, with the
//    optional fused u8 store-back; the rank-1 order when separable.
//
// Bound on the H100: bytes.  blur3 in f32 does about 2.2 FP32 operations per
// byte it must move, against the card's ~20, so the kernel has to keep enough
// bytes in flight and spend few instructions on each.  The design:
//
//  * typed instances: input dtype, output dtype, k, the order (2-D or
//    separable) and the store-back (`epi`, ops/stencil.py:epilogue_code) are
//    template parameters picked on the host; nothing switches per element;
//  * 16-byte copies at any alignment: each window row is copied as the
//    16-byte-aligned superset of its span with cp.async.cg (16 B, L2 only)
//    into a shared-memory row congruent with its source mod 16.  The row
//    pitch in shared memory is congruent with the input's row pitch mod 16,
//    and a tile's window starts at its first row's byte shift, so every row
//    of the window lands at its own shift with one uniform stride: any
//    input pitch, odd in bytes or not, with no pitched copy of the input.
//    A 16-byte chunk that would reach outside the tensor's own bytes (its
//    first row under a storage offset, its last row's ceiling) is copied
//    byte by byte instead, the bytes inside the tensor only;
//  * copies in flight during compute: a persistent grid (blocks per SM from
//    the occupancy calculator x SMs, ops/stencil.py:step_plan) walks the
//    tiles in row-major order, block b taking tiles b, b+G, ...; each block
//    keeps `stages` input stages (one or two: two where two blocks still
//    fit an SM) and issues tile i+stages-1's copies before it computes tile
//    i (cp.async.wait_group + one barrier per stage);
//  * register strips: a thread computes V vertically adjacent outputs of one
//    column from V+k-1 rows (csrc/stencil_common.cuh:strip, shared with the
//    level loop), each output its own FMA chain in the spec's order; the
//    separable row pass stays in registers.  A tile computes its rows rounded
//    up to V and its columns up to 32; the extra outputs read stale shared
//    memory and are never stored;
//  * vector stores: the outputs go through a shared-memory tile whose rows
//    are congruent with their destination rows mod 16, then out as 16-byte
//    stores; only the head and tail of a row that is not 16-byte aligned
//    are stored element by element;
//  * the store-back is the shared epilogue<EPI>: the magic round where the
//    host's rule admits it, rintf above the L1 bound.
//
// ops/_build.py compiles this file once per input dtype and order
// (-DPC_STEP_IN, -DPC_STEP_SEP) and links the parts into libstencil.so beside
// csrc/stencil.cu, whose pc_stencil_step dispatches to them: the instances
// of one input dtype and order build in parallel with the others.

#include "stencil_common.cuh"

#include <atomic>

#ifndef PC_STEP_IN
#error "compile with -DPC_STEP_IN=<0|1|2> -DPC_STEP_SEP=<0|1> (ops/_build.py)"
#endif

using namespace pc;

namespace {

constexpr int kInDtype = PC_STEP_IN;
constexpr bool kSep = PC_STEP_SEP != 0;
// Input stages per block, at most (ops/stencil.py STEP_STAGES): on the H100
// two ran 3.4% faster than one for blur3 in f32 at 16x512 tiles
// (probes/loop_sweep.py step).
constexpr int kMaxStages = 2;

__host__ __device__ constexpr int dsize(int dt) {
  return dt == kF32 ? 4 : dt == kBF16 ? 2 : 1;
}

// The launch geometry, planned on the host (ops/stencil.py:step_plan).
struct StepGeom {
  const unsigned char* in;   // (C, Hp, Wp), contiguous
  unsigned char* out;        // (C, H, W), contiguous
  int C, Hp, Wp, H, W;
  int th, tw;                // output tile: every tile stores th x tw or less
  int rows, cols;            // computed extent: th up to V, tw up to 32
  int tiles_y, tiles_x, ntiles;
  int pitch;                 // input row pitch in shared memory, bytes
  int out_pitch;             // output row pitch in shared memory, bytes
  int stage_bytes;           // one input stage
  int stages;
};

// Shared-memory bytes of one input stage and of the output tile; the host
// plans with the same sums (ops/stencil.py:step_plan).
inline int stage_bytes(int k, int rows, int pitch) {
  return ((rows + k - 1) * pitch + 16 + 15) & ~15;
}
inline int out_bytes(int rows, int out_pitch) {
  return (rows * out_pitch + 16 + 15) & ~15;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until at most stages - 1 groups are pending (block-uniform; stages
// is 1 or kMaxStages).
__device__ __forceinline__ void cp_async_wait_stages(int stages) {
  if (stages == 1)
    cp_async_wait<0>();
  else
    cp_async_wait<1>();
}

__device__ __forceinline__ void st_global16(void* p, const uint4& v) {
  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

struct Tile {
  int c, y0, x0, oh, ow;
};

__device__ __forceinline__ Tile tile_of(const StepGeom& g, int t) {
  const int per_c = g.tiles_y * g.tiles_x;
  const int c = t / per_c, rem = t - c * per_c;
  const int ty = rem / g.tiles_x, tx = rem - ty * g.tiles_x;
  const int y0 = ty * g.th, x0 = tx * g.tw;
  return {c, y0, x0, min(g.th, g.H - y0), min(g.tw, g.W - x0)};
}

// Address of the tile's window at (row 0, column 0) in the input.
template <int ES>
__device__ __forceinline__ const unsigned char* window_of(const StepGeom& g,
                                                          const Tile& t) {
  return g.in + ((static_cast<long long>(t.c) * g.Hp + t.y0) * g.Wp + t.x0) *
                    ES;
}

// Issue the copies of tile t's window into `stage`: window row wy (those
// inside the block, at most th + k - 1) as the 16-byte-aligned superset of
// its span (at most tw + k - 1 columns, none past the row).  Row wy lands at
// base + wy * pitch, base = stage + (window & 15), congruent with its source.
template <int K, int ES>
__device__ __forceinline__ void issue_tile(const StepGeom& g, const Tile& t,
                           unsigned char* stage) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int nrows = min(g.th + K - 1, g.Hp - t.y0);
  const int span = min(g.tw + K - 1, g.Wp - t.x0) * ES;
  const unsigned char* a0 = window_of<ES>(g, t);
  const uintptr_t in_lo = reinterpret_cast<uintptr_t>(g.in);
  const uintptr_t in_hi =
      in_lo + static_cast<uintptr_t>(g.C) * g.Hp * g.Wp * ES;
  const long long row_bytes = static_cast<long long>(g.Wp) * ES;
  unsigned char* base = stage + (reinterpret_cast<uintptr_t>(a0) & 15);
  for (int wy = warp; wy < nrows; wy += nw) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(a0 + wy * row_bytes);
    const uintptr_t lo = a & ~uintptr_t{15};
    const int n = static_cast<int>((((a + span + 15) & ~uintptr_t{15}) - lo) >> 4);
    unsigned char* d = base + wy * g.pitch - (a & 15);  // 16-byte aligned
    const unsigned char* srow = a0 + wy * row_bytes - (a & 15);  // at lo
    for (int j = lane; j < n; j += 32) {
      const uintptr_t src = lo + 16 * static_cast<uintptr_t>(j);
      if (src >= in_lo && src + 16 <= in_hi) {
        cp_async16(d + 16 * j, srow + 16 * j);
      } else {  // the tensor's first or last bytes: those inside, one by one
        const int q0 = static_cast<int>((src > in_lo ? src : in_lo) - src);
        const int q1 =
            static_cast<int>((src + 16 < in_hi ? src + 16 : in_hi) - src);
        for (int q = 16 * j + q0; q < 16 * j + q1; ++q) d[q] = srow[q];
      }
    }
  }
}

// Typed rows of a window in shared memory, as the strip reads them: element
// (i, dx) at p + i * pitch + dx * size, converted to f32 exactly.
template <int DT>
struct SmemRows {
  const unsigned char* p;
  int pitch;
  __device__ __forceinline__ float operator()(int i, int dx) const {
    const unsigned char* q = p + i * pitch + dx * dsize(DT);
    if constexpr (DT == kF32) {
      return *reinterpret_cast<const float*>(q);
    } else if constexpr (DT == kBF16) {
      return __uint_as_float(
          static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(q))
          << 16);
    } else {
      // 2^23 + b, exact, minus 2^23: two full-rate ops instead of an I2F.
      return __fsub_rn(__uint_as_float(0x4B000000u | *q), 8388608.0f);
    }
  }
};

template <int DT>
__device__ __forceinline__ void put(unsigned char* p, float v) {
  if constexpr (DT == kF32)
    *reinterpret_cast<float*>(p) = v;
  else if constexpr (DT == kBF16)
    *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v);
  else
    *p = static_cast<uint8_t>(static_cast<int>(v));
}

// Tile t's outputs from `stage` into the output tile `obuf`: strips of V
// rows x one column, a warp on 32 consecutive columns of one strip row.
template <int DI, int DO, int K, int EPI, bool SEP>
__device__ __forceinline__ void compute_tile(const StepGeom& g, const Tile& t,
                             const unsigned char* stage, unsigned char* obuf,
                             const Taps& tp) {
  constexpr int V = strip_v(K), ESI = dsize(DI), ESO = dsize(DO);
  const unsigned char* base =
      stage + (reinterpret_cast<uintptr_t>(window_of<ESI>(g, t)) & 15);
  const unsigned char* o0 =
      g.out +
      ((static_cast<long long>(t.c) * g.H + t.y0) * g.W + t.x0) * ESO;
  unsigned char* obase = obuf + (reinterpret_cast<uintptr_t>(o0) & 15);
  const int n = (g.rows / V) * g.cols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int sr = i / g.cols, x = i - sr * g.cols, ys = sr * V;
    float acc[V];
    strip<K, V, SEP, true>(SmemRows<DI>{base + ys * g.pitch + x * ESI,
                                         g.pitch},
                            tp, V, acc);
    unsigned char* o = obase + ys * g.out_pitch + x * ESO;
#pragma unroll
    for (int v = 0; v < V; ++v) put<DO>(o + v * g.out_pitch, epilogue<EPI>(acc[v]));
  }
}

// Tile t's oh x ow outputs from `obuf` to device memory: per row, 16-byte
// stores for the chunks wholly inside the row, element stores for the head
// and tail.
template <int ESO>
__device__ __forceinline__ void store_tile(const StepGeom& g, const Tile& t,
                           const unsigned char* obuf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned char* o0 =
      g.out +
      ((static_cast<long long>(t.c) * g.H + t.y0) * g.W + t.x0) * ESO;
  const unsigned char* obase = obuf + (reinterpret_cast<uintptr_t>(o0) & 15);
  const long long row_bytes = static_cast<long long>(g.W) * ESO;
  const uintptr_t bytes = static_cast<uintptr_t>(t.ow) * ESO;
  for (int oy = warp; oy < t.oh; oy += nw) {
    unsigned char* row = o0 + oy * row_bytes;
    const uintptr_t b = reinterpret_cast<uintptr_t>(row);
    const uintptr_t e = b + bytes;
    const uintptr_t lo = b & ~uintptr_t{15};
    const int n = static_cast<int>((((e + 15) & ~uintptr_t{15}) - lo) >> 4);
    unsigned char* d = row - (b & 15);                              // aligned
    const unsigned char* s = obase + oy * g.out_pitch - (b & 15);  // aligned
    for (int j = lane; j < n; j += 32) {
      const uintptr_t dst = lo + 16 * static_cast<uintptr_t>(j);
      if (dst >= b && dst + 16 <= e) {
        st_global16(d + 16 * j, *reinterpret_cast<const uint4*>(s + 16 * j));
      } else {
        const int q0 = static_cast<int>((dst > b ? dst : b) - dst);
        const int q1 = static_cast<int>((dst + 16 < e ? dst + 16 : e) - dst);
        for (int q = 16 * j + q0; q < 16 * j + q1; q += ESO) {
          if constexpr (ESO == 4)
            *reinterpret_cast<float*>(d + q) =
                *reinterpret_cast<const float*>(s + q);
          else if constexpr (ESO == 2)
            *reinterpret_cast<unsigned short*>(d + q) =
                *reinterpret_cast<const unsigned short*>(s + q);
          else
            d[q] = s[q];
        }
      }
    }
  }
}

template <int DI, int DO, int K, int EPI, bool SEP>
__global__ void __launch_bounds__(kMaxThreads, min_blocks(K))
    stencil_step_kernel(StepGeom g, Taps tp) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ESI = dsize(DI), ESO = dsize(DO);
  unsigned char* obuf = smem + g.stages * g.stage_bytes;
  const int nb = gridDim.x;
  const int mine = (g.ntiles - static_cast<int>(blockIdx.x) + nb - 1) / nb;
  // Tile i of this block is blockIdx.x + i * nb, in stage i % stages.  One
  // cp.async group per tile slot, empty past the last tile, so that
  // wait_group(stages - 1) always means "tile i has landed".
  for (int j = 0; j < g.stages - 1; ++j) {
    if (j < mine)
      issue_tile<K, ESI>(g, tile_of(g, blockIdx.x + j * nb),
                         smem + j * g.stage_bytes);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    const int jn = i + g.stages - 1;
    if (jn < mine)
      issue_tile<K, ESI>(g, tile_of(g, blockIdx.x + jn * nb),
                         smem + (jn % g.stages) * g.stage_bytes);
    cp_async_commit();
    cp_async_wait_stages(g.stages);
    __syncthreads();  // tile i's window complete; the output tile is free
    const Tile t = tile_of(g, blockIdx.x + i * nb);
#ifndef PC_STEP_COPY_ONLY  // a measurement build: the copies alone
    compute_tile<DI, DO, K, EPI, SEP>(
        g, t, smem + (i % g.stages) * g.stage_bytes, obuf, tp);
#endif
    __syncthreads();  // outputs written; stage i % stages may be refilled
    store_tile<ESO>(g, t, obuf);
  }
}

// Once per instance and device (the first query or launch on it): let the
// kernel take up to the card's opt-in shared memory, and all of the SM's L1
// as shared memory (the copies bypass L1), so that the occupancy the grid is
// sized from is the one it gets.  Later calls cost one cudaGetDevice.
template <int DO, int K, int EPI, typename Kernel>
cudaError_t configure_once(Kernel kernel) {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

template <typename F>
cudaError_t with_dtype(int dt, F&& f) {
  switch (dt) {
    case kF32: return f(std::integral_constant<int, kF32>{});
    case kBF16: return f(std::integral_constant<int, kBF16>{});
    case kU8: return f(std::integral_constant<int, kU8>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#define PC_PASTE4(a, b, c, d) a##b##c##d
#define PC_NAME4(a, b, c, d) PC_PASTE4(a, b, c, d)

// K1 for this part's input dtype and order (pc_stencil_step in
// csrc/stencil.cu dispatches here).  Returns a cudaError_t value, 0 on a
// successful launch.  The geometry is ops/stencil.py:step_plan's; it is
// checked, not re-planned.  With `blocks` non-null nothing launches:
// *blocks gets the number of such blocks one SM holds.
extern "C" int PC_NAME4(pc_step_in, PC_STEP_IN, _sep, PC_STEP_SEP)(
    const void* in, void* out, int out_dtype, int C, int Hp, int Wp, int H,
    int W, const float* taps, const float* col, const float* row, int k,
    int epi, int th, int tw, int rows, int cols, int pitch, int out_pitch,
    int stages, int threads, int grid, int* blocks, void* stream) {
  Taps tp;
  if (!fill_taps(&tp, taps, col, row, k, kSep) || C < 1 || th < 1 ||
      tw < 1 || th > H || tw > W || Hp != H + k - 1 || Wp != W + k - 1 ||
      rows < th || rows % strip_v(k) != 0 || cols < tw || cols % 32 != 0 ||
      stages < 1 || stages > kMaxStages || !threads_ok(threads) || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int esi = dsize(kInDtype), eso = dsize(out_dtype);
  if (pitch < (cols + k - 1) * esi + 30 || (pitch - Wp * esi) % 16 != 0 ||
      out_pitch < cols * eso + 30 || (out_pitch - W * eso) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  StepGeom g;
  g.in = static_cast<const unsigned char*>(in);
  g.out = static_cast<unsigned char*>(out);
  g.C = C, g.Hp = Hp, g.Wp = Wp, g.H = H, g.W = W;
  g.th = th, g.tw = tw, g.rows = rows, g.cols = cols;
  g.tiles_y = (H + th - 1) / th, g.tiles_x = (W + tw - 1) / tw;
  g.ntiles = C * g.tiles_y * g.tiles_x;
  g.pitch = pitch, g.out_pitch = out_pitch;
  g.stage_bytes = stage_bytes(k, rows, pitch);
  g.stages = stages;
  const size_t bytes = static_cast<size_t>(stages) * g.stage_bytes +
                       out_bytes(rows, out_pitch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = grid < g.ntiles ? grid : g.ntiles;
  return static_cast<int>(with_k(k, [&](auto K) {
    return with_epi(epi, [&](auto E) {
      return with_dtype(out_dtype, [&](auto DO) -> cudaError_t {
        constexpr int kE = decltype(E)::value, kO = decltype(DO)::value;
        // u8 out needs a store-back; kEpiRint (rintf, convex) is never
        // chosen: a convex filter's L1 <= 1 always admits the magic round.
        if constexpr ((kO == kU8 && kE == kEpiFloat) || kE == kEpiRint) {
          return cudaErrorInvalidValue;
        } else {
          auto kernel =
              stencil_step_kernel<kInDtype, kO, decltype(K)::value, kE, kSep>;
          cudaError_t e =
              configure_once<kO, decltype(K)::value, kE>(kernel);
          if (e != cudaSuccess) return e;
          if (blocks)
            return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                blocks, kernel, threads, bytes);
          kernel<<<nb, threads, bytes, st>>>(g, tp);
          return cudaGetLastError();
        }
      });
    });
  }));
}
