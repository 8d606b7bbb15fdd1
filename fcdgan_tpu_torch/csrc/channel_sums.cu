// Per-channel f32 sums over the rows of an (R, C) matrix, for Hopper (sm_90a):
// the BatchNorm statistics of the forward (sum x, sum x^2) and of the backward
// (sum dy, sum dy*x).
//
// Replaces the TPU kernels fcdgan_tpu/ops/pallas/channel_sums.py::_sum_kernel
// (pallas_call in channel_sums) and ::_pair_kernel (pallas_call in
// channel_sums_pair). The TPU grid walks the row blocks in order and carries
// the sums in its output block; here the blocks run in parallel, so each
// block writes its partial sums to a workspace and a second launch adds the
// partials per channel.
//
// Layouts. a (and b) are (R, C) contiguous: an NHWC activation with
// R = N*H*W, the memory of a channels_last NCHW tensor. T is float or
// __nv_bfloat16; every sum is accumulated in f32. out is (nstat, C) f32:
//   mode 0  out[0] = sum a
//   mode 1  out[0] = sum a,  out[1] = sum a^2
//   mode 2  out[0] = sum a,  out[1] = sum a*b
// partial is (blocks, nstat, C) f32 scratch.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. It does one or two
// multiply-adds per element read, and must read R*C*itemsize once (twice in
// mode 2), e.g. 124 MB, 37 us, for the Segmentor's inc BN input
// (20, 220, 220, 64) in bf16.
//
// What this design does about it: one pass over the input, no atomics. Each
// thread loads 16 bytes of channels (8 bf16 or 4 f32) per row, and
// neighbouring threads take neighbouring channel vectors and then
// neighbouring rows, so a warp reads whole contiguous rows. The block's
// threads are (ctile channel vectors) x (row lanes); each strides over the
// rows with four loads in flight and keeps its sums in registers. The row
// lanes are added in shared memory in a fixed order, one partial per block;
// the partials are added per channel in a fixed order by the second kernel,
// so a result is bitwise repeatable for a given shape and card. The wrapper
// sizes the grid to about 4 blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

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

template <typename T, int V, int MODE>
__global__ void __launch_bounds__(kThreads)
channel_partials_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        float* __restrict__ partial, long long rows, int C,
                        int ctile, int row_lanes) {
  using VT = Vec<T, V>;
  constexpr int kStats = MODE == 0 ? 1 : 2;
  __shared__ float smem[kStats * kThreads * V];

  const int groups = C / V;
  const int g_local = threadIdx.x % ctile;
  const int rl = threadIdx.x / ctile;
  const int g = blockIdx.y * ctile + g_local;
  const int width = ctile * V;

  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;

  if (rl < row_lanes && g < groups) {
    const long long stride = static_cast<long long>(gridDim.x) * row_lanes;
    const T* pa = a + static_cast<size_t>(g) * V;
    const T* pb = b + static_cast<size_t>(g) * V;
    long long r = static_cast<long long>(blockIdx.x) * row_lanes + rl;
    for (; r + (kUnroll - 1) * stride < rows; r += kUnroll * stride) {
      VT va[kUnroll], vb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t off = static_cast<size_t>(r + u * stride) * C;
        va[u] = *reinterpret_cast<const VT*>(pa + off);
        if (MODE == 2) vb[u] = *reinterpret_cast<const VT*>(pb + off);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) accumulate<V, MODE>(s, q, va[u], vb[u]);
    }
    for (; r < rows; r += stride) {
      const size_t off = static_cast<size_t>(r) * C;
      VT va = *reinterpret_cast<const VT*>(pa + off);
      VT vb = va;
      if (MODE == 2) vb = *reinterpret_cast<const VT*>(pb + off);
      accumulate<V, MODE>(s, q, va, vb);
    }
  }

  if (rl < row_lanes) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      smem[rl * width + g_local * V + k] = s[k];
      if (MODE != 0) smem[(row_lanes + rl) * width + g_local * V + k] = q[k];
    }
  }
  __syncthreads();

  // one output per thread: (stat, channel of this block's tile), the row
  // lanes added in order
  const int c0 = blockIdx.y * width;
  for (int o = threadIdx.x; o < kStats * width; o += kThreads) {
    const int st = o / width;
    const int j = o % width;
    if (c0 + j >= C) continue;
    const float* col = smem + st * row_lanes * width + j;
    float acc = 0.f;
    for (int l = 0; l < row_lanes; ++l) acc += col[l * width];
    partial[(static_cast<size_t>(blockIdx.x) * kStats + st) * C + c0 + j] = acc;
  }
}

// out[o] = sum over blocks of partial[block][o], in block order
__global__ void __launch_bounds__(kThreads)
channel_final_kernel(const float* __restrict__ partial, float* __restrict__ out,
                     int blocks, int n) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= n) return;
  float acc = 0.f;
  for (int i = 0; i < blocks; ++i) acc += partial[static_cast<size_t>(i) * n + o];
  out[o] = acc;
}

template <typename T, int MODE>
int launch_mode(const void* a, const void* b, void* out, void* partial, long long rows,
                int C, int blocks, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kStats = MODE == 0 ? 1 : 2;
  const int groups = C / V;
  const int ctile = groups < kThreads ? groups : kThreads;
  const int ctiles = (groups + ctile - 1) / ctile;
  const int row_lanes = kThreads / ctile;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(ctiles));
  channel_partials_kernel<T, V, MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(partial),
      rows, C, ctile, row_lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = kStats * C;
  channel_final_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), blocks, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* b, void* out, void* partial, long long rows, int C,
           int blocks, int mode, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         (mode == 2 ? reinterpret_cast<uintptr_t>(b) : 0);
  // the wrapper checks these; a direct caller gets cudaErrorInvalidValue
  if (C <= 0 || C % V != 0 || bits % 16 != 0 || rows <= 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch_mode<T, 0>(a, b, out, partial, rows, C, blocks, s);
  if (mode == 1) return launch_mode<T, 1>(a, b, out, partial, rows, C, blocks, s);
  if (mode == 2) return launch_mode<T, 2>(a, b, out, partial, rows, C, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface for ctypes. Each returns the launches' cudaError_t (0 = ok).
extern "C" int fcd_channel_sums_f32(const void* a, const void* b, void* out, void* partial,
                                    long long rows, int C, int blocks, int mode,
                                    void* stream) {
  return launch<float>(a, b, out, partial, rows, C, blocks, mode, stream);
}

extern "C" int fcd_channel_sums_bf16(const void* a, const void* b, void* out,
                                     void* partial, long long rows, int C, int blocks,
                                     int mode, void* stream) {
  return launch<__nv_bfloat16>(a, b, out, partial, rows, C, blocks, mode, stream);
}
