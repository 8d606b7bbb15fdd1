// Per-channel f32 sums over the rows of an (R, C) matrix, for Hopper (sm_90a):
// the BatchNorm statistics of the forward (sum x, sum x^2) and of the backward
// (sum dy, sum dy*x), in one launch.
//
// Replaces the TPU kernels fcdgan_tpu/ops/pallas/channel_sums.py::_sum_kernel
// (pallas_call in channel_sums) and ::_pair_kernel (pallas_call in
// channel_sums_pair). The TPU grid walks the row blocks in order and carries
// the sums in its output block; here the blocks run in parallel, each writes
// its partial sums to a workspace, and the block that finishes last adds the
// partials per channel.
//
// Layouts. a (and b) are (R, C) contiguous: an NHWC activation with
// R = N*H*W, the memory of a channels_last NCHW tensor. T is float or
// __nv_bfloat16; every sum is accumulated in f32. out is (nstat, C) f32:
//   mode 0  out[0] = sum a
//   mode 1  out[0] = sum a,  out[1] = sum a^2
//   mode 2  out[0] = sum a,  out[1] = sum a*b
// The channels are cut into tiles of ctile 16-byte vectors (ctile a power
// of two, at most 8: 64 bf16 or 32 f32 channels); partial holds one row of
// nstat * ctile * V f32 per (tile, block), and counter[tile] is 0 before the
// launch and is left at 0 (the wrapper keeps 1024 per stream, so two
// launches in flight never share one).
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. It does one or two
// multiply-adds per element read, and must read R*C*itemsize once (twice in
// mode 2), e.g. 124 MB, 37 us, for the Segmentor's inc BN input
// (20, 220, 220, 64) in bf16. Below a few MB what bounds it is latency: the
// launch, one round of loads, and the final sum.
//
// What this design does about it:
//  * One launch. Each block writes its partial row, fences, and draws a
//    ticket of its channel tile (an integer atomicAdd); the tile's block
//    that draws the last ticket adds the tile's partial rows in block order
//    (each of its threads a fixed contiguous run of blocks for four
//    channels, then the runs in order through shared memory) and sets the
//    counter back to 0. The tiles finish on separate SMs, and a finish reads
//    at most a few blocks per thread. No float atomics: a result is bitwise
//    repeatable for a given shape, plan and card.
//  * A grid sized to the input by the wrapper (ops/channel_sums.py
//    reduction_plan): about 32 KB per block, at most one block of 512
//    threads per SM over all tiles, so a 1 MB input runs on 32 blocks and a
//    124 MB input on 132.
//  * Each block reads one contiguous range of rows. Its threads are (ctile
//    channel vectors) x (row lanes): a warp reads 128-byte row segments of
//    neighbouring rows, and each thread keeps 16 loads of 16 bytes in flight
//    (8 rows of a and b in mode 2) before it adds them: 128 KB a block; a
//    block's last rows are one such batch, predicated. The row lanes are
//    added by a fixed shuffle tree in each warp, then the warps in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCtile = 8;      // 16-byte channel vectors per channel tile
constexpr int kMaxTickets = 1024; // counters the wrapper keeps per stream

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <int V, int MODE, typename VT>
__device__ __forceinline__ void accumulate(float* s, float* q, const VT& va, const VT& vb) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float fa = to_f32(va.v[k]);
    s[k] += fa;
    if (MODE == 1) q[k] = fmaf(fa, fa, q[k]);
    if (MODE == 2) q[k] = fmaf(fa, to_f32(vb.v[k]), q[k]);
  }
}

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// The channel tile's sums from its blocks' partial rows (blocks rows of n
// floats: kStats x width, n % 4 == 0), added in block order by all threads
// of the calling block: `lanes` threads a column of four floats, each a
// contiguous run of blocks, then the runs in lane order. Channels past C
// (a partly filled last tile) are not written.
__device__ void sum_partials(const float* __restrict__ partial, float* __restrict__ out,
                             int blocks, int n, int width, int c0, int C, float4* scratch) {
  const int n4 = n / 4;
  const int lanes = min(kThreads / n4, blocks);
  const int col = threadIdx.x % n4;
  const int lane = threadIdx.x / n4;
  const float4* p4 = reinterpret_cast<const float4*>(partial);
  if (lane < lanes) {
    const int b0 = lane * blocks / lanes;
    const int b1 = (lane + 1) * blocks / lanes;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int b = b0; b < b1; ++b) add4(acc, __ldcg(p4 + static_cast<size_t>(b) * n4 + col));
    scratch[lane * n4 + col] = acc;
  }
  __syncthreads();
  if (threadIdx.x < n4) {
    float4 acc = scratch[threadIdx.x];
    for (int l = 1; l < lanes; ++l) add4(acc, scratch[l * n4 + threadIdx.x]);
    const int st = 4 * threadIdx.x / width;
    const int c = c0 + 4 * threadIdx.x % width;
    if (c < C) *reinterpret_cast<float4*>(out + static_cast<size_t>(st) * C + c) = acc;
  }
}

template <typename T, int V, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
channel_sums_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    float* __restrict__ out, float* __restrict__ partial,
                    unsigned int* __restrict__ counter, long long rows,
                    long long rows_per_block, int C, int ctile) {
  using VT = Vec<T, V>;
  constexpr int kStats = MODE == 0 ? 1 : 2;
  constexpr int kUnroll = MODE == 2 ? 8 : 16;  // 16-byte loads in flight a thread
  constexpr int kRed = kWarps * kStats * kMaxCtile * V;
  constexpr int kSmem = kRed > 4 * kThreads ? kRed : 4 * kThreads;
  __shared__ __align__(16) float smem[kSmem];
  __shared__ bool last;

  const int groups = C / V;
  const int g_local = threadIdx.x % ctile;
  const int row_lanes = kThreads / ctile;
  const int rl = threadIdx.x / ctile;
  const int g = blockIdx.y * ctile + g_local;
  const int width = ctile * V;  // channels of a tile
  const int n = kStats * width; // floats of a partial row

  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;

  if (g < groups) {
    const long long r_end = min(rows, (blockIdx.x + 1LL) * rows_per_block);
    const T* pa = a + static_cast<size_t>(g) * V;
    const T* pb = b + static_cast<size_t>(g) * V;
    long long r = blockIdx.x * rows_per_block + rl;
    const long long step = row_lanes;
    for (; r + (kUnroll - 1) * step < r_end; r += kUnroll * step) {
      VT va[kUnroll], vb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t off = static_cast<size_t>(r + u * step) * C;
        va[u] = *reinterpret_cast<const VT*>(pa + off);
        if (MODE == 2) vb[u] = *reinterpret_cast<const VT*>(pb + off);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) accumulate<V, MODE>(s, q, va[u], vb[u]);
    }
    if (r < r_end) {  // the last rows: one batch, every load in flight together
      VT va[kUnroll], vb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * step < r_end) {
          const size_t off = static_cast<size_t>(r + u * step) * C;
          va[u] = *reinterpret_cast<const VT*>(pa + off);
          if (MODE == 2) vb[u] = *reinterpret_cast<const VT*>(pb + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * step < r_end) accumulate<V, MODE>(s, q, va[u], vb[u]);
      }
    }
  }

  // the row lanes of a warp (ctile is a power of two) by a fixed shuffle
  // tree, then the warps in order
  for (int o = ctile; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
      if (MODE != 0) q[k] += __shfl_xor_sync(0xffffffffu, q[k], o);
    }
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < ctile) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      smem[warp * n + g_local * V + k] = s[k];
      if (MODE != 0) smem[warp * n + width + g_local * V + k] = q[k];
    }
  }
  __syncthreads();
  float* row = partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * n;
  if (threadIdx.x < n) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += smem[w * n + threadIdx.x];
    row[threadIdx.x] = acc;
  }

  // the ticket of this channel tile: its block that finishes last adds the
  // tile's partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_partials(partial + static_cast<size_t>(blockIdx.y) * gridDim.x * n, out, gridDim.x, n,
               width, blockIdx.y * width, C, reinterpret_cast<float4*>(smem));
  if (threadIdx.x == 0) counter[blockIdx.y] = 0u;  // the tile's other blocks are done
}

// 16-byte channel vectors of a tile: the largest power of two <= min(groups,
// kMaxCtile) (ops/channel_sums.py reduction_plan)
int ctile_of(int groups) {
  int t = 1;
  while (2 * t <= groups && 2 * t <= kMaxCtile) t *= 2;
  return t;
}

template <typename T, int MODE>
int launch_mode(const void* a, const void* b, void* out, void* partial, void* counter,
                long long rows, long long rows_per_block, int C, int blocks,
                cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int groups = C / V;
  const int ctile = ctile_of(groups);
  const int ctiles = (groups + ctile - 1) / ctile;
  if (ctiles > kMaxTickets) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(ctiles));
  channel_sums_kernel<T, V, MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(out),
      static_cast<float*>(partial), static_cast<unsigned int*>(counter), rows,
      rows_per_block, C, ctile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* b, void* out, void* partial, void* counter,
           long long rows, long long rows_per_block, int C, int blocks, int mode,
           void* stream) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(partial) |
                         (mode == 2 ? reinterpret_cast<uintptr_t>(b) : 0);
  // the wrapper checks these; a direct caller gets cudaErrorInvalidValue
  if (C <= 0 || C % V != 0 || bits % 16 != 0 || rows <= 0 || blocks <= 0 ||
      rows_per_block <= 0 || (blocks - 1) * rows_per_block >= rows ||
      static_cast<long long>(blocks) * rows_per_block < rows || counter == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    return launch_mode<T, 0>(a, b, out, partial, counter, rows, rows_per_block, C, blocks, s);
  if (mode == 1)
    return launch_mode<T, 1>(a, b, out, partial, counter, rows, rows_per_block, C, blocks, s);
  if (mode == 2)
    return launch_mode<T, 2>(a, b, out, partial, counter, rows, rows_per_block, C, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface for ctypes. Each returns the launch's cudaError_t (0 = ok).
// The channels are cut into tiles of ctile 16-byte vectors; each tile's
// block i sums rows [i * rows_per_block, min(rows, (i + 1) * rows_per_block))
// into partial row (tile * blocks + i) of nstat * ctile * V floats, and
// counter[tile] is the tile's ticket counter.
extern "C" int fcd_channel_sums_f32(const void* a, const void* b, void* out, void* partial,
                                    void* counter, long long rows, long long rows_per_block,
                                    int C, int blocks, int mode, void* stream) {
  return launch<float>(a, b, out, partial, counter, rows, rows_per_block, C, blocks, mode,
                       stream);
}

extern "C" int fcd_channel_sums_bf16(const void* a, const void* b, void* out, void* partial,
                                     void* counter, long long rows, long long rows_per_block,
                                     int C, int blocks, int mode, void* stream) {
  return launch<__nv_bfloat16>(a, b, out, partial, counter, rows, rows_per_block, C, blocks,
                               mode, stream);
}
