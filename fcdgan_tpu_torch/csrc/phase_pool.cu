// Forward of a 2x2, stride-2 max pool for Hopper (sm_90a), NHWC in and out.
//
// Replaces the TPU kernel fcdgan_tpu/ops/pallas/phase_pool.py::
// _phase_pool_kernel (pallas_call in phase_pool_forward). That kernel takes
// the W-space-to-depth view (N, H, W/2, 2C) of an activation, selects the
// first-wins maximum of its two channel halves (the even and the odd
// column), then the first-wins maximum of each pair of rows. On NHWC memory
// the phase view is free: channel half 0 of phase column j is column 2j and
// half 1 is column 2j+1. So each output is the row-major first maximum of
// its 2x2 window: W first-wins (a >= b keeps the left), then H first-wins
// (top >= bottom keeps the top), the routing of pool_bwd.cu. An odd W
// leaves its last column out (the row stride stays W*C), an odd H its last
// row. The comparisons run in f32, which is exact for bf16 values, so the
// output is bit-equal to the plain version.
//
// Layouts. x is (N, H, W, C) contiguous (the memory of a channels_last NCHW
// tensor), y is (N, H/2, W/2, C) contiguous; T is float or __nv_bfloat16.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. Three compares and
// selects per output element; it must read the 2*Ho x 2*Wo input region
// once and write the quarter-size output once: 1.25 * |x| * itemsize,
// e.g. 0.07 ms for the Segmentor's 20x220x220x64 bf16 block-1 pool.
//
// What this design does about it: one pass, no scratch. Each thread owns one
// output vector of 16 bytes of channels (8 bf16 or 4 f32): four 16-byte
// loads, one 16-byte store, neighbouring threads on neighbouring channels
// and then neighbouring windows, so a warp's accesses are contiguous along
// C. The wrapper (ops/phase_pool.py) takes only a C whose row is a whole
// number of 16-byte vectors and 16-byte aligned bases, and raises otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
phase_pool_nhwc_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W, int C,
                       int Ho, int Wo, long long total) {
  using VT = Vec<T, V>;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int groups = C / V;
  const int c0 = static_cast<int>(t % groups) * V;
  long long r = t / groups;
  const int j = static_cast<int>(r % Wo);
  r /= Wo;
  const int i = static_cast<int>(r % Ho);
  const long long n = r / Ho;

  const size_t row = static_cast<size_t>(W) * C;
  const size_t base = ((static_cast<size_t>(n) * H + 2 * i) * W + 2 * j) * C + c0;
  const VT a = *reinterpret_cast<const VT*>(x + base);
  const VT b = *reinterpret_cast<const VT*>(x + base + C);
  const VT c = *reinterpret_cast<const VT*>(x + base + row);
  const VT d = *reinterpret_cast<const VT*>(x + base + row + C);
  VT out;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const T top = to_f32(a.v[k]) >= to_f32(b.v[k]) ? a.v[k] : b.v[k];  // W first-wins
    const T bot = to_f32(c.v[k]) >= to_f32(d.v[k]) ? c.v[k] : d.v[k];
    out.v[k] = to_f32(top) >= to_f32(bot) ? top : bot;                   // H first-wins
  }
  *reinterpret_cast<VT*>(y + ((static_cast<size_t>(n) * Ho + i) * Wo + j) * C + c0) = out;
}

template <typename T>
int launch(const void* x, void* y, int N, int H, int W, int C, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (C % V != 0 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = H / 2, Wo = W / 2;
  const long long total = static_cast<long long>(N) * Ho * Wo * (C / V);
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  phase_pool_nhwc_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), H, W, C, Ho, Wo, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Each returns the launch's cudaError_t (0 = ok).
extern "C" int fcd_phase_pool_f32(const void* x, void* y, int N, int H, int W, int C,
                                  void* stream) {
  return launch<float>(x, y, N, H, W, C, stream);
}

extern "C" int fcd_phase_pool_bf16(const void* x, void* y, int N, int H, int W, int C,
                                   void* stream) {
  return launch<__nv_bfloat16>(x, y, N, H, W, C, stream);
}
