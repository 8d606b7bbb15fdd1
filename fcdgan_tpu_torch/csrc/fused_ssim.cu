// One MS-SSIM level, fused, for Hopper (sm_90a): per (image, channel) plane
// the means of the SSIM and contrast-structure maps over the valid window.
//
// Replaces the TPU kernel fcdgan_tpu/ops/pallas/fused_ssim.py::_ssim_kernel
// (pallas_call in _ssim_level_fwd_pallas). Same formulas: the five
// separable valid-window Gaussian blurs of x, y, x^2, y^2 and x*y (along H,
// then along W, taps in order), sigma = E[x^2] - mu^2 in f32,
//   cs   = (2 sigma12 + c2) / (sigma1 + sigma2 + c2)
//   ssim = ((2 mu1 mu2 + c1) / (mu1^2 + mu2^2 + c1)) * cs
// and each map's mean over the VH x VW valid positions, VH = H - K + 1.
//
// Layouts. x and y are (N, H, W, C) float32 contiguous; the results are two
// (N, C) float32 tables. K (the window) is odd and at most kMaxWin.
//
// What bounds it on an H100 SXM: the inputs are read once (2 N H W C * 4
// bytes at 3.35 TB/s) and each valid position costs about 10 K + 15
// operations per blur direction (some 250 for K = 11) at 67 TFLOP/s in f32;
// at the level-0 shape 10x220x220x3 that is 3.5 us of bytes against about
// 5.5 us of operations, so it is bound by operations, a few microseconds.
//
// What this design does about it. The TPU grid ran one plane per step; 30
// planes (10 images x 3 bands) would fill 30 of the 132 SMs. Here every plane
// is cut into 32x32 output tiles, one block each (1470 blocks at level 0).
// A block stages its haloed input tile (42x42, zero past the border) of x
// and y in shared memory, blurs the five maps along H into shared memory,
// then along W in registers, forms both maps and sums the valid positions
// in a fixed order. One partial (ssim, cs) pair per tile goes to a small
// scratch table, and a second kernel adds each plane's partials in tile
// order and divides by VH * VW: no float atomics, so the result is the same
// on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                    // output positions per tile side
constexpr int kMaxWin = 11;
constexpr int kHalo = kTile + kMaxWin - 1;   // staged input rows and columns
constexpr int kThreads = 256;

struct Taps {
  float w[kMaxWin];
};

__global__ void __launch_bounds__(kThreads)
ssim_tile_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ partial, int H, int W, int C, int K,
                 Taps taps, float c1, float c2) {
  __shared__ float xs[kHalo][kHalo];
  __shared__ float ys[kHalo][kHalo];
  // the five maps blurred along H: [map][output row][staged column]
  __shared__ float vb[5][kTile][kHalo];
  __shared__ float red[2][kThreads / 32];

  const int tid = threadIdx.x;
  const int plane = blockIdx.z;
  const int n = plane / C;
  const int ch = plane % C;
  const int oy0 = blockIdx.y * kTile;
  const int ox0 = blockIdx.x * kTile;
  const int VH = H - K + 1;
  const int VW = W - K + 1;
  const int rows = min(kTile, VH - oy0) + K - 1;   // staged rows this tile needs
  const int cols = min(kTile, VW - ox0) + K - 1;

  const size_t img = static_cast<size_t>(n) * H * W * C + ch;
  for (int i = tid; i < kHalo * kHalo; i += kThreads) {
    const int r = i / kHalo;
    const int c = i % kHalo;
    float vx = 0.f, vy = 0.f;
    if (r < rows && c < cols) {
      const size_t off = img + (static_cast<size_t>(oy0 + r) * W + ox0 + c) * C;
      vx = x[off];
      vy = y[off];
    }
    xs[r][c] = vx;
    ys[r][c] = vy;
  }
  __syncthreads();

  // along H: (rows, cols) -> (rows - K + 1, cols)
  for (int i = tid; i < kTile * kHalo; i += kThreads) {
    const int r = i / kHalo;
    const int c = i % kHalo;
    float m0 = 0.f, m1 = 0.f, m2 = 0.f, m3 = 0.f, m4 = 0.f;
    for (int t = 0; t < K; ++t) {
      const float w = taps.w[t];
      const float a = xs[r + t][c];
      const float b = ys[r + t][c];
      m0 += w * a;
      m1 += w * b;
      m2 += w * (a * a);
      m3 += w * (b * b);
      m4 += w * (a * b);
    }
    vb[0][r][c] = m0;
    vb[1][r][c] = m1;
    vb[2][r][c] = m2;
    vb[3][r][c] = m3;
    vb[4][r][c] = m4;
  }
  __syncthreads();

  // along W, then the two maps at each valid position of the tile
  float s_sum = 0.f, cs_sum = 0.f;
  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile;
    const int c = i % kTile;
    if (oy0 + r >= VH || ox0 + c >= VW) continue;
    float mu1 = 0.f, mu2 = 0.f, sxx = 0.f, syy = 0.f, sxy = 0.f;
    for (int t = 0; t < K; ++t) {
      const float w = taps.w[t];
      mu1 += w * vb[0][r][c + t];
      mu2 += w * vb[1][r][c + t];
      sxx += w * vb[2][r][c + t];
      syy += w * vb[3][r][c + t];
      sxy += w * vb[4][r][c + t];
    }
    const float mu1_sq = mu1 * mu1;
    const float mu2_sq = mu2 * mu2;
    const float mu1_mu2 = mu1 * mu2;
    const float sigma1 = sxx - mu1_sq;
    const float sigma2 = syy - mu2_sq;
    const float sigma12 = sxy - mu1_mu2;
    const float cs = (2.f * sigma12 + c2) / (sigma1 + sigma2 + c2);
    s_sum += ((2.f * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs;
    cs_sum += cs;
  }

  // fixed-order block sum: warp shuffles, then warp 0 over the warp sums
  for (int o = 16; o > 0; o >>= 1) {
    s_sum += __shfl_down_sync(0xffffffffu, s_sum, o);
    cs_sum += __shfl_down_sync(0xffffffffu, cs_sum, o);
  }
  if (tid % 32 == 0) {
    red[0][tid / 32] = s_sum;
    red[1][tid / 32] = cs_sum;
  }
  __syncthreads();
  if (tid < 32) {
    s_sum = tid < kThreads / 32 ? red[0][tid] : 0.f;
    cs_sum = tid < kThreads / 32 ? red[1][tid] : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      s_sum += __shfl_down_sync(0xffffffffu, s_sum, o);
      cs_sum += __shfl_down_sync(0xffffffffu, cs_sum, o);
    }
    if (tid == 0) {
      const int tiles = gridDim.x * gridDim.y;
      const size_t slot = static_cast<size_t>(plane) * tiles + blockIdx.y * gridDim.x + blockIdx.x;
      partial[2 * slot] = s_sum;
      partial[2 * slot + 1] = cs_sum;
    }
  }
}

__global__ void ssim_plane_mean_kernel(const float* __restrict__ partial,
                                       float* __restrict__ ssim_out,
                                       float* __restrict__ cs_out, int planes,
                                       int tiles, double inv_count) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= planes) return;
  double s = 0.0, cs = 0.0;
  for (int t = 0; t < tiles; ++t) {  // tile order: the same sum every run
    s += partial[2 * (static_cast<size_t>(p) * tiles + t)];
    cs += partial[2 * (static_cast<size_t>(p) * tiles + t) + 1];
  }
  ssim_out[p] = static_cast<float>(s * inv_count);
  cs_out[p] = static_cast<float>(cs * inv_count);
}

}  // namespace

// Plain C interface for ctypes; returns the first launch error (0 = ok).
// ``partial`` is scratch of 2 * N * C * tiles_y * tiles_x floats, with
// tiles = ceil((H - K + 1) / 32) along each axis; ``taps`` holds K floats.
extern "C" int fcd_ssim_level_f32(const void* x, const void* y, void* ssim_out,
                                  void* cs_out, void* partial, int N, int H,
                                  int W, int C, int K, const float* taps,
                                  float c1, float c2, void* stream) {
  if (K < 1 || K > kMaxWin || H < K || W < K) return static_cast<int>(cudaErrorInvalidValue);
  Taps tp = {};
  for (int t = 0; t < K; ++t) tp.w[t] = taps[t];
  const int VH = H - K + 1, VW = W - K + 1;
  const dim3 grid((VW + kTile - 1) / kTile, (VH + kTile - 1) / kTile, N * C);
  const auto s = static_cast<cudaStream_t>(stream);
  ssim_tile_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(partial), H, W, C, K, tp, c1, c2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int planes = N * C;
  ssim_plane_mean_kernel<<<(planes + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(ssim_out),
      static_cast<float*>(cs_out), planes, grid.x * grid.y,
      1.0 / (static_cast<double>(VH) * VW));
  return static_cast<int>(cudaGetLastError());
}
