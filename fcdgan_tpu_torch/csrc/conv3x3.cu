// 3x3, stride-1, SAME convolution forward for Hopper (sm_90a), NHWC in and out.
//
// Replaces the TPU kernel fcdgan_tpu/ops/pallas/conv3x3.py::_conv3x3_pallas_fwd
// (its body `_kernel`): a haloed H-strip, im2col in VMEM and one K = 9*C_in
// matmul with f32 accumulation, no bias. Same function here, same gate:
// C_in <= 64, C_out <= 128, H, W >= 8 (checked by the Python wrapper).
//
// Layouts. x is (N, H, W, C_in) contiguous, which is the memory of a
// channels_last NCHW tensor; w is the HWIO kernel (3, 3, C_in, C_out)
// contiguous, i.e. the (9*C_in, C_out) im2col weight matrix with row
// (dy*3 + dx)*C_in + ci; y is (N, H, W, C_out) in x's type. T is float or
// __nv_bfloat16; products are summed in f32 and rounded once at the store.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s), at the
// serving shapes of one chunk (patch 220, batch 10 stacked to 20), bf16:
//   inc conv1   20x220x220, 3 -> 64:   3.3 GFLOP, 130 MB -> bytes, 39 us
//   inc conv2   20x220x220, 64 -> 64:  71 GFLOP,  248 MB -> about even,
//                                                  74 us bytes, 72 us operations
//   down1 conv1 20x110x110, 64 -> 128: 36 GFLOP,   93 MB -> operations, 36 us
// (bytes: input read once plus output written once). Two of the three need
// the tensor cores to come near their bound.
//
// What this design does about it: nothing for the tensor cores yet. It is
// the simple first version: the im2col matrix is never materialised
// (the Pallas kernel's point, kept): each block stages a haloed 18x18 input
// tile, 8 input channels at a time, and the matching 9x8x64 weight slice in
// shared memory (zero-filled at the image border and past C_in), then every
// thread accumulates an 8-pixel x 8-channel f32 register tile with FMAs on
// the CUDA cores. So the input is read from device memory once per 64-wide
// output-channel tile, and the output written once, coalesced along C_out.
// The CUDA-core FMA rate (67 TFLOP/s f32 peak) caps it well above the
// bounds; mma.sync/wgmma, TMA and a multistage pipeline are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kCiChunk = 8;    // input channels staged per pass
constexpr int kCoTile = 64;    // output channels per block
constexpr int kThreads = 256;
constexpr int kPx = 8;         // pixels per thread: 8 consecutive columns of one row
constexpr int kCo = 8;         // output channels per thread: cg, cg+8, ..., cg+56

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, int H, int W, int C_in, int C_out,
                    int co_tiles) {
  // [ci][row][col]: the 4 distinct pixels a warp reads per step fall in
  // distinct banks (offsets 0, 8, 18, 26)
  __shared__ float xs[kCiChunk][kHaloH][kHaloW];
  __shared__ float ws[9][kCiChunk][kCoTile];

  const int tid = threadIdx.x;
  const int n = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * kCoTile;
  const int oy0 = blockIdx.y * kTileH;
  const int ox0 = blockIdx.x * kTileW;

  const int cg = tid % 8;
  const int pg = tid / 8;               // 0..31
  const int row = pg / 2;               // 0..15
  const int col0 = (pg % 2) * kPx;      // 0 or 8

  float acc[kPx][kCo];
#pragma unroll
  for (int p = 0; p < kPx; ++p)
#pragma unroll
    for (int j = 0; j < kCo; ++j) acc[p][j] = 0.f;

  const T* xn = x + (size_t)n * H * W * C_in;
  for (int c0 = 0; c0 < C_in; c0 += kCiChunk) {
    // haloed input tile; SAME padding and channels past C_in read as zero
    for (int i = tid; i < kCiChunk * kHaloH * kHaloW; i += kThreads) {
      const int ci = i % kCiChunk;
      const int p = i / kCiChunk;
      const int hx = p % kHaloW;
      const int hy = p / kHaloW;
      const int gy = oy0 + hy - 1;
      const int gx = ox0 + hx - 1;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + ci < C_in)
        v = to_f32(xn[((size_t)gy * W + gx) * C_in + c0 + ci]);
      xs[ci][hy][hx] = v;
    }
    // the nine taps' weight rows of these input channels
    for (int i = tid; i < 9 * kCiChunk * kCoTile; i += kThreads) {
      const int co = i % kCoTile;
      const int ci = (i / kCoTile) % kCiChunk;
      const int tap = i / (kCoTile * kCiChunk);
      float v = 0.f;
      if (c0 + ci < C_in && co0 + co < C_out)
        v = to_f32(w[((size_t)tap * C_in + c0 + ci) * C_out + co0 + co]);
      ws[tap][ci][co] = v;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int ci = 0; ci < kCiChunk; ++ci) {
        float a[kPx];
        float b[kCo];
#pragma unroll
        for (int p = 0; p < kPx; ++p) a[p] = xs[ci][row + dy][col0 + p + dx];
#pragma unroll
        for (int j = 0; j < kCo; ++j) b[j] = ws[tap][ci][cg + 8 * j];
#pragma unroll
        for (int p = 0; p < kPx; ++p)
#pragma unroll
          for (int j = 0; j < kCo; ++j) acc[p][j] = fmaf(a[p], b[j], acc[p][j]);
      }
    }
    __syncthreads();
  }

  const int oy = oy0 + row;
  if (oy >= H) return;
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    const int ox = ox0 + col0 + p;
    if (ox < W) {
      T* out = y + (((size_t)n * H + oy) * W + ox) * C_out + co0;
#pragma unroll
      for (int j = 0; j < kCo; ++j) {
        const int co = cg + 8 * j;
        if (co0 + co < C_out) out[co] = from_f32<T>(acc[p][j]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int N, int H, int W,
           int C_in, int C_out, void* stream) {
  const int co_tiles = (C_out + kCoTile - 1) / kCoTile;
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, N * co_tiles);
  conv3x3_nhwc_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      H, W, C_in, C_out, co_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Each returns the launch's cudaError_t (0 = ok).
extern "C" int fcd_conv3x3_f32(const void* x, const void* w, void* y, int N,
                               int H, int W, int C_in, int C_out, void* stream) {
  return launch<float>(x, w, y, N, H, W, C_in, C_out, stream);
}

extern "C" int fcd_conv3x3_bf16(const void* x, const void* w, void* y, int N,
                                int H, int W, int C_in, int C_out, void* stream) {
  return launch<__nv_bfloat16>(x, w, y, N, H, W, C_in, C_out, stream);
}
