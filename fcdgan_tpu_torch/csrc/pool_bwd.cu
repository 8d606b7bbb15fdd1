// Backward of a 2x2, stride-2 max pool for Hopper (sm_90a), NHWC in and out.
//
// Replaces the TPU kernel fcdgan_tpu/ops/pallas/pool_bwd.py::_pool_bwd_kernel
// (pallas_call in _pool_bwd_pallas_even): dx from (x, dy), the routing
// recomputed from x instead of stored by the forward. Each 2x2 window routes
// dy to one element: the W-first-wins select of each row (a >= b keeps the
// left one) composed with the H-first-wins select of the two row maxima
// (top >= bottom keeps the top one), which is the row-major first maximum of
// XLA's select_and_scatter and of torch's max_pool2d backward. Every other
// element of dx is exactly +0, and so are the last row and column when H or
// W is odd (the floor pool never reads them). The comparisons run in f32,
// which is exact for bf16 values, so dx is bit-equal to the plain version.
//
// Layouts. x and dx are (N, H, W, C) contiguous (the memory of a
// channels_last NCHW tensor), dy is (N, H/2, W/2, C) contiguous; T is float
// or __nv_bfloat16.
//
// What bounds it on an H100 SXM (3.35 TB/s): nothing but bytes. It does
// about ten compares and selects per element and must read x once, dy once
// (a quarter of x) and write dx once: 2.25 * |x| * itemsize, e.g. 0.12 ms
// for the Segmentor's 20x220x220x64 bf16 block-1 pool.
//
// What this design does about it: one pass, no scratch. Each thread owns one
// 2x2 window and 16 bytes of channels (8 bf16 or 4 f32), so every load and
// store is a 16-byte vector and neighbouring threads touch neighbouring
// channels, then neighbouring windows: full coalescing along C on NHWC
// memory. Windows past the pooled extent (odd H or W) only store zeros.
// A channel count that is not a multiple of the vector width (or an
// unaligned pointer) takes the same kernel one element per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
pool_bwd_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     T* __restrict__ dx, int H, int W, int C, int Ho, int Wo,
                     int He, int We, long long total) {
  using VT = Vec<T, V>;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int groups = C / V;
  const int c0 = static_cast<int>(t % groups) * V;
  long long r = t / groups;
  const int j = static_cast<int>(r % We);
  r /= We;
  const int i = static_cast<int>(r % He);
  const long long n = r / He;

  const T zero = zero_of<T>();
  VT out[4];  // dx at (2i, 2j), (2i, 2j+1), (2i+1, 2j), (2i+1, 2j+1)
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < V; ++k) out[q].v[k] = zero;

  const size_t row = static_cast<size_t>(W) * C;
  const size_t base = ((static_cast<size_t>(n) * H + 2 * i) * W + 2 * j) * C + c0;
  if (i < Ho && j < Wo) {
    const VT a = *reinterpret_cast<const VT*>(x + base);
    const VT b = *reinterpret_cast<const VT*>(x + base + C);
    const VT c = *reinterpret_cast<const VT*>(x + base + row);
    const VT d = *reinterpret_cast<const VT*>(x + base + row + C);
    const VT g = *reinterpret_cast<const VT*>(
        dy + ((static_cast<size_t>(n) * Ho + i) * Wo + j) * C + c0);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float fa = to_f32(a.v[k]), fb = to_f32(b.v[k]);
      const float fc = to_f32(c.v[k]), fd = to_f32(d.v[k]);
      const bool w0 = fa >= fb;  // first wins along W, top row
      const bool w1 = fc >= fd;  // first wins along W, bottom row
      const bool h = (w0 ? fa : fb) >= (w1 ? fc : fd);  // first wins along H
      const T top = h ? g.v[k] : zero;
      const T bot = h ? zero : g.v[k];
      out[0].v[k] = w0 ? top : zero;
      out[1].v[k] = w0 ? zero : top;
      out[2].v[k] = w1 ? bot : zero;
      out[3].v[k] = w1 ? zero : bot;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int yy = 2 * i + q / 2;
    const int xx = 2 * j + q % 2;
    if (yy < H && xx < W)
      *reinterpret_cast<VT*>(dx + base + (q / 2) * row + (q % 2) * C) = out[q];
  }
}

template <typename T, int V>
int launch_v(const void* x, const void* dy, void* dx, int N, int H, int W, int C,
             cudaStream_t stream) {
  const int Ho = H / 2, Wo = W / 2, He = (H + 1) / 2, We = (W + 1) / 2;
  const long long total = static_cast<long long>(N) * He * We * (C / V);
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  pool_bwd_nhwc_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
      H, W, C, Ho, Wo, He, We, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* dy, void* dx, int N, int H, int W, int C,
           void* stream) {
  constexpr int V = 16 / sizeof(T);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(dx)) % 16) == 0;
  if (C % V == 0 && aligned) return launch_v<T, V>(x, dy, dx, N, H, W, C, s);
  return launch_v<T, 1>(x, dy, dx, N, H, W, C, s);
}

}  // namespace

// Plain C interface for ctypes. Each returns the launch's cudaError_t (0 = ok).
extern "C" int fcd_pool_bwd_f32(const void* x, const void* dy, void* dx, int N,
                                int H, int W, int C, void* stream) {
  return launch<float>(x, dy, dx, N, H, W, C, stream);
}

extern "C" int fcd_pool_bwd_bf16(const void* x, const void* dy, void* dx, int N,
                                 int H, int W, int C, void* stream) {
  return launch<__nv_bfloat16>(x, dy, dx, N, H, W, C, stream);
}
