// One MS-SSIM level, fused, for Hopper (sm_90a): per (image, channel) plane
// the means of the SSIM and contrast-structure maps over the valid window,
// in one launch.
//
// Replaces the TPU kernel fcdgan_tpu/ops/pallas/fused_ssim.py::_ssim_kernel
// (pallas_call in _ssim_level_fwd_pallas). Same formulas: the five
// separable valid-window Gaussian blurs of x, y, x^2, y^2 and x*y (along H,
// then along W, taps in order), sigma = E[x^2] - mu^2 in f32,
//   cs   = (2 sigma12 + c2) / (sigma1 + sigma2 + c2)
//   ssim = ((2 mu1 mu2 + c1) / (mu1^2 + mu2^2 + c1)) * cs
// (IEEE division) and each map's mean over the VH x VW valid positions,
// VH = H - K + 1.
//
// Layouts. x and y are (N, H, W, C) float32 contiguous; the results are two
// (N, C) float32 tables. K (the window) is at most kMaxWin.
//
// What bounds it on an H100 SXM: the inputs are read once (2 N H W C * 4
// bytes at 3.35 TB/s) and each valid position costs about 10 K + 15
// operations per blur direction (some 250 for K = 11) at 67 TFLOP/s in f32;
// at the level-0 shape 10x220x220x3 that is 3.5 us of bytes against about
// 5.5 us of operations. What a design meets first is the shared-memory
// traffic of the blurs (44 four-byte reads a position per pass if every tap
// reads shared memory) and, at the small levels, latency.
//
// What this design does about it:
//  * A block covers an output tile of at most 8 x 32 positions of one image
//    for all C channels (C > 4: four channels at a time), so every input
//    line is fetched from device memory once: each thread loads the C
//    channels of up to three pixels of the haloed tile, neighbouring threads
//    on neighbouring pixels of a row (C loads of 4 bytes a pixel, all from
//    the same lines), every load issued before the first store into the
//    channel planes in shared memory.
//  * Only the rows and columns the tile needs are staged: (th + K - 1) x
//    (tw + K - 1), th and tw cut at the valid edge. The wrapper
//    (ops/fused_ssim.py tile_plan) picks the tile per level: 32 columns, and
//    8, 4, 2 or 1 rows, the most that still gives a block per SM, so the
//    28^2 level runs 180 blocks and the 14^2 level 40 (N = 10).
//  * Along H each thread walks one staged column of one channel, keeping
//    the 8 output rows of the five maps in registers: 18 shared reads of x
//    and y for 8 x 11 taps. Along W each thread forms 4 neighbouring
//    outputs of one row from 16 H-blurred values a map, read as four
//    16-byte vectors. Rows are 44 floats, neighbouring threads take
//    neighbouring columns: no bank conflicts. Taps run in order in both
//    passes (unrolled for K = 11, the MS-SSIM window); rows or columns past
//    the tile's are computed from stale shared memory and never used.
//  * One launch: each block writes one (ssim, cs) partial per channel,
//    fences, and draws a ticket of its image (integer atomicAdd); the
//    image's block that draws the last ticket adds each of its planes'
//    partials in tile order in f64 (contiguous runs of tiles per thread,
//    then the runs in order), divides by VH * VW and sets the counter back
//    to 0. The images finish on separate SMs. No float atomics: the result
//    is the same on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWin = 11;
constexpr int kTH = 8;                     // output rows of a tile, at most
constexpr int kTW = 32;                    // output columns of a tile, at most
constexpr int kSW = 44;                    // row stride: >= kTW + kMaxWin - 1, 4 | kSW
constexpr int kSR = kTH + kMaxWin - 1;     // staged rows of a plane
constexpr int kXPlane = kSR * kSW;         // floats of a staged channel plane
constexpr int kVPlane = kTH * kSW;         // floats of an H-blurred channel plane
constexpr int kMaxCB = 4;                  // channels staged at once
constexpr int kMaxImages = 65535;          // images: the grid's y extent
constexpr int kThreads = 256;              // kMaxCB x 64: H pass one column a thread,
constexpr int kWarps = kThreads / 32;      // W pass 8 rows x 8 quads of columns
// pixels of the staged region a thread loads
constexpr int kStage = (kSR * (kTW + kMaxWin - 1) + kThreads - 1) / kThreads;

struct Taps {
  float w[kMaxWin];
};

// floats of dynamic shared memory for cb channels: x and y staged, the five
// H-blurred maps
__host__ __device__ constexpr int smem_floats(int cb) {
  return cb * (2 * kXPlane + 5 * kVPlane);
}

template <int KT>  // the window if known at compile time (the taps unrolled), else 0
__global__ void __launch_bounds__(kThreads, 3)
ssim_level_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ partial, float* __restrict__ ssim_out,
                  float* __restrict__ cs_out, unsigned int* __restrict__ counter, int H,
                  int W, int C, int k_arg, int TH, int TW, Taps taps, float c1, float c2,
                  double inv_count) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2][kWarps];
  __shared__ double fin[kThreads];
  __shared__ bool last;

  constexpr int kWin = KT ? KT : kMaxWin;  // taps the loops run over
  const int K = KT ? KT : k_arg;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n = blockIdx.y;
  const int VH = H - K + 1;
  const int VW = W - K + 1;
  const int tiles_x = (VW + TW - 1) / TW;
  const int tiles = gridDim.x;
  const int oy0 = (blockIdx.x / tiles_x) * TH;
  const int ox0 = (blockIdx.x % tiles_x) * TW;
  const int th = min(TH, VH - oy0);  // output rows and columns of this tile
  const int tw = min(TW, VW - ox0);
  const int rows = th + K - 1;       // staged rows and columns it needs
  const int cols = tw + K - 1;
  const int cbm = min(C, kMaxCB);
  float* xs = smem;                  // [cbm][kSR][kSW]
  float* ys = xs + cbm * kXPlane;
  float* vb = ys + cbm * kXPlane;    // [5][cbm][kTH][kSW]
  const int vmap = cbm * kVPlane;
  const int tch = tid / 64;          // this thread's channel in both passes
  const int hc = tid % 64;           // H pass: its staged column
  const int wq = tid % 8;            // W pass: its output columns 4 wq .. 4 wq + 3
  const int wr = tid / 8 % kTH;      //         and its output row

  for (int ch0 = 0; ch0 < C; ch0 += kMaxCB) {
    const int cb = min(kMaxCB, C - ch0);
    if (ch0 > 0) __syncthreads();  // the previous channels' reads are done
    // every (row, column) of the staged region, kStage a thread: all loads
    // first, then the stores
    float vx[kStage][kMaxCB], vy[kStage][kMaxCB];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = tid + u * kThreads;
      if (i < rows * cols) {
        const size_t g =
            ((static_cast<size_t>(n) * H + oy0 + i / cols) * W + ox0 + i % cols) * C + ch0;
#pragma unroll
        for (int k = 0; k < kMaxCB; ++k) {
          if (k < cb) {
            vx[u][k] = x[g + k];
            vy[u][k] = y[g + k];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = tid + u * kThreads;
      if (i < rows * cols) {
        float* px = xs + (i / cols) * kSW + i % cols;
        float* py = ys + (i / cols) * kSW + i % cols;
#pragma unroll
        for (int k = 0; k < kMaxCB; ++k) {
          if (k < cb) {
            px[k * kXPlane] = vx[u][k];
            py[k * kXPlane] = vy[u][k];
          }
        }
      }
    }
    __syncthreads();

    // along H: the thread's column, kTH output rows of the five maps
    if (tch < cb && hc < kSW) {
      const float* px = xs + tch * kXPlane + hc;
      const float* py = ys + tch * kXPlane + hc;
      float acc[5][kTH];
#pragma unroll
      for (int r = 0; r < kTH; ++r) acc[0][r] = acc[1][r] = acc[2][r] = acc[3][r] = acc[4][r] = 0.f;
#pragma unroll
      for (int i = 0; i < kTH + kWin - 1; ++i) {
        const float a = px[i * kSW];
        const float b = py[i * kSW];
        const float aa = a * a, bb = b * b, ab = a * b;
#pragma unroll
        for (int r = 0; r < kTH; ++r) {
          const int t = i - r;  // tap t of output row r, in order as i grows
          if (t >= 0 && t < kWin && (KT || t < K)) {
            const float w = taps.w[t];
            acc[0][r] += w * a;
            acc[1][r] += w * b;
            acc[2][r] += w * aa;
            acc[3][r] += w * bb;
            acc[4][r] += w * ab;
          }
        }
      }
      float* pv = vb + tch * kVPlane + hc;
#pragma unroll
      for (int m = 0; m < 5; ++m) {
#pragma unroll
        for (int r = 0; r < kTH; ++r) pv[m * vmap + r * kSW] = acc[m][r];
      }
    }
    __syncthreads();

    // along W: four neighbouring outputs of one row, then the two maps
    float s_sum = 0.f, cs_sum = 0.f;
    if (tch < cb && wr < th) {
      const float* pv = vb + tch * kVPlane + wr * kSW + 4 * wq;
      float mu[5][4];
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        float v[16];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 q = *reinterpret_cast<const float4*>(pv + m * vmap + 4 * j);
          v[4 * j] = q.x;
          v[4 * j + 1] = q.y;
          v[4 * j + 2] = q.z;
          v[4 * j + 3] = q.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int t = 0; t < kWin; ++t) {
            if (KT || t < K) acc += taps.w[t] * v[j + t];
          }
          mu[m][j] = acc;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * wq + j < tw) {
          const float mu1 = mu[0][j], mu2 = mu[1][j];
          const float mu1_sq = mu1 * mu1;
          const float mu2_sq = mu2 * mu2;
          const float mu1_mu2 = mu1 * mu2;
          const float sigma1 = mu[2][j] - mu1_sq;
          const float sigma2 = mu[3][j] - mu2_sq;
          const float sigma12 = mu[4][j] - mu1_mu2;
          const float cs = (2.f * sigma12 + c2) / (sigma1 + sigma2 + c2);
          s_sum += ((2.f * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs;
          cs_sum += cs;
        }
      }
    }

    // per channel (two warps each): warp shuffles, then the two warps in order
    for (int o = 16; o > 0; o >>= 1) {
      s_sum += __shfl_down_sync(0xffffffffu, s_sum, o);
      cs_sum += __shfl_down_sync(0xffffffffu, cs_sum, o);
    }
    if (lane == 0) {
      red[0][warp] = s_sum;
      red[1][warp] = cs_sum;
    }
    __syncthreads();
    if (tid < 2 * cb) {
      const int ch = tid / 2;
      const int st = tid % 2;
      partial[((static_cast<size_t>(n) * C + ch0 + ch) * 2 + st) * tiles + blockIdx.x] =
          red[st][2 * ch] + red[st][2 * ch + 1];
    }
  }

  // the image's ticket: its block that finishes last forms its means
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter + n, 1u) == tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n_out = 2 * C;  // (channel, stat) rows of `tiles` partials
  const float* pp = partial + static_cast<size_t>(n) * n_out * tiles;
  if (n_out >= kThreads) {
    for (int o = tid; o < n_out; o += kThreads) {
      double acc = 0.0;
      for (int t = 0; t < tiles; ++t) acc += __ldcg(pp + static_cast<size_t>(o) * tiles + t);
      (o % 2 ? cs_out : ssim_out)[static_cast<size_t>(n) * C + o / 2] =
          static_cast<float>(acc * inv_count);
    }
  } else {
    const int runs = min(kThreads / n_out, tiles);
    const int o = tid % n_out;
    const int run = tid / n_out;
    if (run < runs) {
      const int t0 = run * tiles / runs;
      const int t1 = (run + 1) * tiles / runs;
      double acc = 0.0;
#pragma unroll 4
      for (int t = t0; t < t1; ++t) acc += __ldcg(pp + static_cast<size_t>(o) * tiles + t);
      fin[run * n_out + o] = acc;
    }
    __syncthreads();
    if (tid < n_out) {
      double acc = fin[tid];
      for (int r = 1; r < runs; ++r) acc += fin[r * n_out + tid];
      (tid % 2 ? cs_out : ssim_out)[static_cast<size_t>(n) * C + tid / 2] =
          static_cast<float>(acc * inv_count);
    }
  }
  if (tid == 0) counter[n] = 0u;  // the image's other blocks have drawn their tickets
}

int launch(const float* x, const float* y, float* ssim_out, float* cs_out, float* partial,
           unsigned int* counter, int N, int H, int W, int C, int K, int TH, int TW,
           const Taps& taps, float c1, float c2, cudaStream_t stream) {
  const int VH = H - K + 1, VW = W - K + 1;
  const dim3 grid(((VW + TW - 1) / TW) * ((VH + TH - 1) / TH), N);
  const size_t bytes = sizeof(float) * smem_floats(C < kMaxCB ? C : kMaxCB);
  const double inv_count = 1.0 / (static_cast<double>(VH) * VW);
  const auto kernel = K == kMaxWin ? ssim_level_kernel<kMaxWin> : ssim_level_kernel<0>;
  if (bytes + 4096 > 48 * 1024) {  // beyond the default, with the static arrays
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, bytes, stream>>>(x, y, partial, ssim_out, cs_out, counter, H, W,
                                            C, K, TH, TW, taps, c1, c2, inv_count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes; returns the launch's cudaError_t (0 = ok).
// Output tiles are TH x TW (TH <= 8, TW <= 32), tiles_x = ceil(VW / TW) per
// row of tiles; ``partial`` is scratch of 2 * N * C * tiles floats;
// ``counter`` holds N counters (one per image, N <= 65535) that are 0 and
// are left at 0; ``taps`` holds K floats.
extern "C" int fcd_ssim_level_f32(const void* x, const void* y, void* ssim_out,
                                  void* cs_out, void* partial, void* counter, int N, int H,
                                  int W, int C, int K, int TH, int TW, const float* taps,
                                  float c1, float c2, void* stream) {
  if (K < 1 || K > kMaxWin || H < K || W < K || N < 1 || N > kMaxImages || C < 1 || TH < 1 ||
      TH > kTH || TW < 1 || TW > kTW || counter == nullptr ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps tp = {};
  for (int t = 0; t < K; ++t) tp.w[t] = taps[t];
  return launch(static_cast<const float*>(x), static_cast<const float*>(y),
                static_cast<float*>(ssim_out), static_cast<float*>(cs_out),
                static_cast<float*>(partial), static_cast<unsigned int*>(counter), N, H, W,
                C, K, TH, TW, tp, c1, c2, static_cast<cudaStream_t>(stream));
}
