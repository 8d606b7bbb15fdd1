// 3x3, stride-1, SAME convolution forward for Hopper (sm_90a), NHWC in and out.
//
// Replaces the TPU kernel fcdgan_tpu/ops/pallas/conv3x3.py::_conv3x3_pallas_fwd
// (its body `_kernel`): a haloed H-strip, im2col in VMEM and one K = 9*C_in
// matmul with f32 accumulation, no bias. Same function here, same gate:
// C_in <= 64, C_out <= 128, H, W >= 8 (checked by the Python wrapper, which
// also picks the variant and packs the weights; ops/conv3x3.py).
//
// Layouts. x is (N, H, W, C_in) contiguous, which is the memory of a
// channels_last NCHW tensor; y is (N, H, W, C_out) in x's type. Products are
// summed in f32 and rounded once at the store. Two kernels, one per type:
//
//   bf16  conv3x3_wgmma_kernel  implicit GEMM on the tensor cores (below)
//   f32   conv3x3_fma_kernel    CUDA-core FMAs, for the f32 parity paths,
//                               which need full f32 products (TF32 wgmma keeps
//                               about three digits)
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s), at the
// serving shapes of one chunk (patch 220, batch 10 stacked to 20), bf16:
//   inc conv1   20x220x220, 3 -> 64:   3.3 GFLOP, 130 MB -> bytes, 39 us
//   inc conv2   20x220x220, 64 -> 64:  71 GFLOP,  248 MB -> about even,
//                                                  74 us bytes, 72 us operations
//   down1 conv1 20x110x110, 64 -> 128: 36 GFLOP,   93 MB -> operations, 36 us
// (bytes: input read once plus output written once). The training shapes
// (N 10-50, 200-220 px, 64 -> 64) sit on the same ridge. Only the tensor
// cores come near it: the f32 CUDA-core peak is 67 TFLOP/s.
//
// The bf16 design. GEMM with M = output pixels, N = C_out, K = 9 taps x C_in.
// - Output tile: 8 rows x 8 columns of one image = 64 pixels, one m64 wgmma
//   operand whose 8-row groups are the tile's output rows. All of C_out in
//   one block (N tile 64 or 128, weights zero-padded), f32 accumulators in
//   registers, one wgmma.m64nNk16 chain of 9 taps x 4 k16 steps per tile.
// - Persistent blocks: the grid is the SM count (times the blocks that fit
//   on an SM) and each block walks the output tiles t = blockIdx.x,
//   + gridDim.x, ... Two consumer warpgroups take alternate tiles, so one's
//   epilogue (registers -> bf16, masked 4-byte stores along C_out) overlaps
//   the other's wgmma chain. The weights (at most 9 x 128 x 64 bf16 =
//   147 KB) are copied into shared memory once per block (cp.async.bulk) and
//   stay resident while activation tiles stream through 4 stages of 13 KB
//   (147 + 53 KB of the 227 KB): a ring of 2 stages per consumer warpgroup,
//   so that each ring's loads are waited on by one warpgroup in order.
// - Activations, C_in % 8 == 0: one TMA load per tile of the haloed box
//   (64 channels, 10 columns, 10 rows, 1 image) at (0, x0-1, y0-1, n) into
//   a 128-byte-swizzled stage: each pixel is one 128-byte row, the K-major
//   layout wgmma reads. TMA's zero fill of out-of-bounds coordinates is the
//   SAME padding (no halo logic) and also pads the channels past C_in to 64
//   (the matching weight rows are zero). Each tap's A operand is the box
//   seen from a shifted start address (see the kernel's note), so an input
//   byte crosses L2 -> SM 100/64 = 1.6 times per tile instead of 9 times
//   with one box per tap. That per-tap design, tried first, ran at the L2
//   rate: 0.228 ms at inc conv2, 1.4x F.conv2d (H100; PERF.md).
//   Tiles 8 pixels on a side waste under 5 % of the work at W, H = 100-220.
// - Activations, C_in % 8 != 0 (the 3-band inc.conv1, K = 27): TMA cannot
//   describe a 6-byte pixel stride, so the producer warpgroup copies the
//   haloed box into shared memory with ordinary loads, then builds each
//   pixel's flat im2col row k = tap*C_in + ci from it into the same swizzled
//   layout, 64 columns of K per stage, zero past 9*C_in (27 -> one block).
//   Every K block is 4 k16 steps deep, so the wgmma chain has no branch (a
//   branch there makes ptxas serialise the wgmmas). The alternative, the
//   input zero-padded to 8 channels so that TMA takes it, measured 1.14x
//   the gather's time with the pad included (H100; PERF.md).
// - One producer warpgroup (one thread issues TMA; all 128 gather),
//   synchronised with the consumers by full/empty mbarriers per stage.
// - No split-K and no atomics: every output is one fixed-order sum, so the
//   same inputs give bitwise the same output.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

// ---------------------------------------------------------------- f32 FMA --

constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kCiChunk = 8;    // input channels staged per pass
constexpr int kCoTile = 64;    // output channels per block
constexpr int kThreads = 256;
constexpr int kPx = 8;         // pixels per thread: 8 consecutive columns of one row
constexpr int kCo = 8;         // output channels per thread: cg, cg+8, ..., cg+56

// Each block stages a haloed 18x18 input tile, 8 input channels at a time,
// and the matching 9x8x64 weight slice in shared memory (zero-filled at the
// image border and past C_in); every thread accumulates an 8-pixel x
// 8-channel f32 register tile with FMAs on the CUDA cores.
__global__ void __launch_bounds__(kThreads)
conv3x3_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, int H, int W, int C_in, int C_out,
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

  const float* xn = x + (size_t)n * H * W * C_in;
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
        v = xn[((size_t)gy * W + gx) * C_in + c0 + ci];
      xs[ci][hy][hx] = v;
    }
    // the nine taps' weight rows of these input channels
    for (int i = tid; i < 9 * kCiChunk * kCoTile; i += kThreads) {
      const int co = i % kCoTile;
      const int ci = (i / kCoTile) % kCiChunk;
      const int tap = i / (kCoTile * kCiChunk);
      float v = 0.f;
      if (c0 + ci < C_in && co0 + co < C_out)
        v = w[((size_t)tap * C_in + c0 + ci) * C_out + co0 + co];
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
      float* out = y + (((size_t)n * H + oy) * W + ox) * C_out + co0;
#pragma unroll
      for (int j = 0; j < kCo; ++j) {
        const int co = cg + 8 * j;
        if (co0 + co < C_out) out[co] = acc[p][j];
      }
    }
  }
}

// -------------------------------------------------------------- bf16 wgmma --

constexpr int kTH = 8;                       // output tile: 8 rows x 8 columns,
constexpr int kTW = 8;                       // one m64 wgmma operand (a row per 8-row group)
constexpr int kBoxH = kTH + 2;
constexpr int kBoxW = kTW + 2;
constexpr int kBoxPix = kBoxH * kBoxW;       // 100 input pixels feed one tile
constexpr int kRowBytes = 128;               // 64 bf16 of K: one swizzle row
// a stage holds a tile's haloed input box (TMA) or one im2col K block (gather)
constexpr int kTmaStageBytes = (kBoxPix * kRowBytes + 1023) / 1024 * 1024;  // 13 KB
constexpr int kGatherStageBytes = kTH * kTW * kRowBytes;                     // 8 KB
constexpr int kStages = 4;                   // two rings of 2, one per consumer warpgroup
constexpr int kConsumers = 256;              // two warpgroups, alternate tiles
constexpr int kWgThreads = kConsumers + 128; // and one producer warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// contiguous global -> shared copy, completion counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address, LBO 1 (unused when K fits the swizzle row), `sbo`
// bytes between 8-row groups, layout type 1 (B128), base offset 0. The
// swizzle phase of a row follows its shared-memory address (bits 7-9), as
// TMA wrote it, so a start off the 1024-byte pattern boundary and an SBO
// that is not a multiple of 1024 read the rows right (held against the plain
// version on the card; a base offset of (addr >> 7) & 7 reads them wrong).
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (uint64_t{1} << 62);
}

#define FCD_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FCD_D16(i) FCD_D4(i), FCD_D4(i + 4), FCD_D4(i + 8), FCD_D4(i + 12)

template <int NT> struct Wgmma;

template <> struct Wgmma<64> {  // d += A(64 x 16) B(16 x 64)
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : FCD_D16(0), FCD_D16(16)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<128> {  // d += A(64 x 16) B(16 x 128)
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : FCD_D16(0), FCD_D16(16), FCD_D16(32), FCD_D16(48)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef FCD_D16
#undef FCD_D4

// Half of the im2col row of pixel q = p / 2 (row q / 8, column q % 8) of
// the tile for K columns kb*64 .. kb*64 + 63: 16-byte groups j = 4*(p % 2)
// .. +3, read from the tile's haloed input `halo` ([10][10][C_in]) at the
// offsets `koff` (k = tap*C_in + ci -> (dy*10 + dx)*C_in + ci, or -1 past
// 9*C_in) and written at their 128-byte-swizzle positions j ^ (q % 8).
__device__ __forceinline__ void gather_row(uint8_t* stage, int p, const uint16_t* halo,
                                           const int* koff, int C_in, int kb) {
  const int q = p / 2;
  const uint16_t* base = halo + ((q / kTW) * kBoxW + q % kTW) * C_in;
  uint8_t* row = stage + q * kRowBytes;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int j = 4 * (p % 2) + jj;
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int o0 = koff[kb * 64 + j * 8 + e];
      const int o1 = koff[kb * 64 + j * 8 + e + 1];
      const uint32_t v0 = o0 < 0 ? 0u : base[o0];
      const uint32_t v1 = o1 < 0 ? 0u : base[o1];
      packed[e / 2] = v0 | (v1 << 16);
    }
    *reinterpret_cast<uint4*>(row + ((j ^ (q & 7)) * 16)) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

__device__ __forceinline__ void producer_sync() {  // the producer warpgroup only
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// Bytes of dynamic shared memory past the weights and stages that the gather
// needs (its offset table and haloed input box); 0 with TMA.
__host__ __device__ __forceinline__ int gather_extra_bytes(bool gather, int n_kb, int C_in) {
  return gather ? n_kb * 64 * 4 + (kBoxPix * C_in * 2 + 15) / 16 * 16 : 0;
}

// The stage and barrier phase of load l of the block's i-th tile. Tile i
// goes to ring i % 2, the two stages of the consumer warpgroup that takes it,
// as that ring's load j = (i / 2) * loads + l. A parity wait is defined only
// for a barrier's current phase or the one before it; with one ring per
// warpgroup, the previous use of a stage is a load the waiting warpgroup has
// itself consumed, so every wait names one of those two phases. (A ring shared
// by both warpgroups breaks this once a tile takes 4 or more loads.) Mirrored
// by the ring model of tests/test_torch_conv3x3.py.
struct Slot {
  int stage;
  uint32_t parity;
};

__device__ __forceinline__ Slot ring_slot(int i, int l, int loads) {
  const int j = (i / 2) * loads + l;
  return {2 * (i % 2) + j % 2, static_cast<uint32_t>((j / 2) & 1)};
}

// Persistent blocks. Threads 256-383: the producer warpgroup, which fills the
// stages for the block's tiles t_i = blockIdx.x + i * gridDim.x in order;
// threads 0-255: two consumer warpgroups, warpgroup w taking the tiles of
// odd or even i, so that one's epilogue overlaps the other's wgmma chain.
// Load l of tile i uses ring_slot(i, l, loads).
//
// TMA: one stage per tile holds the haloed box (64 channels, 10 columns,
// 10 rows) at (0, x0-1, y0-1, n), 128-byte swizzled. Tap (dy, dx) of output
// row r, column c is box row (r+dy)*10 + c + dx, so each tap's A operand is
// the same box seen from a shifted start address: 8 rows of 128 B per output
// row, SBO = 10 rows = 1280 B between output rows (see desc_b128 on the
// swizzle phase). 9 taps x 4 k16 steps chain on one stage; every input byte
// crosses L2 -> SM 100/64 = 1.6 times, not 9.
//
// Gather: `n_kb` stages per tile, each one 64-wide block of the flat im2col
// K (zero past 9*C_in), built by the producer threads from the haloed input
// box that they first copy into shared memory with ordinary loads.
//
// Every K block is 4 k16 steps deep whatever C_in: the K past C_in (TMA's
// zero fill) or past 9*C_in (the gather's zeros) meets zero weight rows, and
// the wgmma chain stays free of branches, which would serialise it. The
// weight image `wimg` is the kernel's shared-memory layout, packed by the
// wrapper: n_kb blocks (9 taps, or the im2col blocks) of NT rows (output
// channels) x 64 bf16 of K, each row 128-byte swizzled.
template <int NT, bool kGather>
__global__ void __launch_bounds__(kWgThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tmap,
                     const uint16_t* __restrict__ x, const uint8_t* __restrict__ wimg,
                     __nv_bfloat16* __restrict__ y, int N, int H, int W, int C_in, int C_out,
                     int n_kb) {
  constexpr int kStageBytes = kGather ? kGatherStageBytes : kTmaStageBytes;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms (8 rows x 128 B) must start on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t wblock = NT * kRowBytes;
  uint8_t* ws = smem;
  uint8_t* stages = ws + n_kb * wblock;
  int* koff = reinterpret_cast<int*>(stages + kStages * kStageBytes);  // gather only
  uint16_t* halo = reinterpret_cast<uint16_t*>(koff + n_kb * 64);      // gather only
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kStages * kStageBytes +
                                               gather_extra_bytes(kGather, n_kb, C_in));
  uint64_t* empty = full + kStages;
  uint64_t* wbar = empty + kStages;

  const int tid = threadIdx.x;
  // the warpgroup index, made visibly warp-uniform for the compiler
  const int wg = __shfl_sync(0xffffffff, tid / 128, 0);
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles_img = tiles_x * ((H + kTH - 1) / kTH);
  const int n_tiles = N * tiles_img;
  const int loads = kGather ? n_kb : 1;  // stages per tile

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kGather ? 128 : 1);
      mbar_init(&empty[s], 4);  // lane 0 of each warp of the consuming warpgroup
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers / 128) {
    // ---------------------------------------------------------- producer
    const int p = tid - kConsumers;
    if (p == 0) {
      mbar_expect_tx(wbar, n_kb * wblock);
      for (int b = 0; b < n_kb; ++b) bulk_load(ws + b * wblock, wimg + b * wblock, wblock, wbar);
    }
    if (!kGather && p != 0) return;
    if constexpr (kGather) {
      for (int k = p; k < n_kb * 64; k += 128) {
        const int tap = k / C_in;
        koff[k] = k < 9 * C_in ? ((tap / 3) * kBoxW + tap % 3) * C_in + k - tap * C_in : -1;
      }
    }
    for (int i = 0, t = blockIdx.x; t < n_tiles; ++i, t += gridDim.x) {
      const int n = t / tiles_img;
      const int r = t - n * tiles_img;
      const int y0 = (r / tiles_x) * kTH;
      const int x0 = (r % tiles_x) * kTW;
      if constexpr (kGather) {
        producer_sync();  // the previous tile's rows are built: the box is free
        for (int e = p; e < kBoxPix * C_in; e += 128) {
          const int px = e / C_in;
          const int yy = y0 + px / kBoxW - 1;
          const int xx = x0 + px % kBoxW - 1;
          halo[e] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                        ? x[(((size_t)n * H + yy) * W + xx) * C_in + e - px * C_in]
                        : uint16_t{0};
        }
        producer_sync();
      }
      for (int l = 0; l < loads; ++l) {
        const Slot slot = ring_slot(i, l, loads);
        mbar_wait(&empty[slot.stage], slot.parity ^ 1);
        uint8_t* st = stages + slot.stage * kStageBytes;
        if constexpr (kGather) {
          gather_row(st, p, halo, koff, C_in, l);
          // generic-proxy stores -> visible to wgmma's async proxy
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_arrive(&full[slot.stage]);
        } else {
          mbar_expect_tx(&full[slot.stage], kBoxPix * kRowBytes);
          tma_load_4d(st, &tmap, &full[slot.stage], 0, x0 - 1, y0 - 1, n);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const bool pairs = (C_out % 2) == 0;
    const uint32_t w0 = smem_u32(ws);
    float d[NT / 2];
    mbar_wait(wbar, 0);
    for (int i = wg; (int)blockIdx.x + i * (int)gridDim.x < n_tiles; i += 2) {
      const int t = (int)blockIdx.x + i * (int)gridDim.x;
#pragma unroll
      for (int v = 0; v < NT / 2; ++v) d[v] = 0.f;
      for (int l = 0; l < loads; ++l) {
        const Slot slot = ring_slot(i, l, loads);
        mbar_wait(&full[slot.stage], slot.parity);
        const uint32_t st = smem_u32(stages + slot.stage * kStageBytes);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        if constexpr (kGather) {
#pragma unroll
          for (int s = 0; s < 4; ++s)
            Wgmma<NT>::mma(d, desc_b128(st + 32 * s, 1024),
                           desc_b128(w0 + l * wblock + 32 * s, 1024));
        } else {
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const uint32_t a0 = st + ((tap / 3) * kBoxW + tap % 3) * kRowBytes;
#pragma unroll
            for (int s = 0; s < 4; ++s)
              Wgmma<NT>::mma(d, desc_b128(a0 + 32 * s, kBoxW * kRowBytes),
                             desc_b128(w0 + tap * wblock + 32 * s, 1024));
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        if (lane == 0) mbar_arrive(&empty[slot.stage]);
      }
      // epilogue: accumulator fragment of m64nNk16, per 8-column block j
      // d[4j + 2h + c] = (row 16*warp + lane/4 + 8h, column 8j + 2*(lane%4) + c)
      const int n = t / tiles_img;
      const int r = t - n * tiles_img;
      const int y0 = (r / tiles_x) * kTH;
      const int x0 = (r % tiles_x) * kTW;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = warp * 16 + lane / 4 + 8 * h;
        const int oy = y0 + m / kTW;
        const int ox = x0 + m % kTW;
        if (oy >= H || ox >= W) continue;
        __nv_bfloat16* out = y + (((size_t)n * H + oy) * W + ox) * C_out;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          const int co = 8 * j + 2 * (lane % 4);
          const float v0 = d[4 * j + 2 * h];
          const float v1 = d[4 * j + 2 * h + 1];
          if (pairs && co + 1 < C_out) {
            *reinterpret_cast<__nv_bfloat162*>(out + co) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (co < C_out) out[co] = __float2bfloat16_rn(v0);
            if (co + 1 < C_out) out[co + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

// -------------------------------------------------------------------- host --

constexpr int kErrNoEncode = 1001;     // cuTensorMapEncodeTiled not found
constexpr int kErrBadPlan = 1002;      // arguments the kernel does not take
constexpr int kErrEncodeBase = 2000;   // + the CUresult of the encode

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; it is looked up through the
// runtime's entry-point query, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

size_t wgmma_smem_bytes(int nt, bool gather, int n_kb, int C_in) {
  return 1024 /* alignment slack */ + (size_t)n_kb * nt * kRowBytes +
         (size_t)kStages * (gather ? kGatherStageBytes : kTmaStageBytes) +
         gather_extra_bytes(gather, n_kb, C_in) + (2 * kStages + 1) * sizeof(uint64_t);
}

template <int NT, bool kGather>
int launch_wgmma(const CUtensorMap& tmap, const void* x, const void* wimg, void* y, int N,
                 int H, int W, int C_in, int C_out, int n_kb, cudaStream_t stream) {
  auto kernel = conv3x3_wgmma_kernel<NT, kGather>;
  const int smem = static_cast<int>(wgmma_smem_bytes(NT, kGather, n_kb, C_in));
  // Host queries, made once per instantiation and device: the shared-memory
  // limit set so far, the SM count, and the resident blocks at the last size
  // asked for (as many as fit: more than one hides the gather's load
  // latency; the TMA variants' shared memory allows one).
  static std::mutex mu;
  static int dev_seen = -1, smem_set = 0, sms = 0, smem_seen = -1, per_sm = 0;
  int dev = 0, slots_per_sm = 0, grid_sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    std::lock_guard<std::mutex> lock(mu);
    if (dev != dev_seen) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      dev_seen = dev;
      smem_set = 0;
      smem_seen = -1;
    }
    if (smem > smem_set) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = smem;
    }
    if (smem != smem_seen) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWgThreads, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_seen = smem;
    }
    slots_per_sm = per_sm > 0 ? per_sm : 1;
    grid_sms = sms;
  }
  const long long slots = (long long)grid_sms * slots_per_sm;
  const long long tiles =
      (long long)N * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      tmap, static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(wimg),
      static_cast<__nv_bfloat16*>(y), N, H, W, C_in, C_out, n_kb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Each returns 0 or the launch's cudaError_t
// (or one of the kErr* codes above).
extern "C" int fcd_conv3x3_f32(const void* x, const void* w, void* y, int N, int H, int W,
                               int C_in, int C_out, void* stream) {
  const int co_tiles = (C_out + kCoTile - 1) / kCoTile;
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, N * co_tiles);
  conv3x3_fma_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), H, W,
      C_in, C_out, co_tiles);
  return static_cast<int>(cudaGetLastError());
}

// bf16 x (N, H, W, C_in), the packed weight image of ops/conv3x3.py
// (wgmma_plan, pack_wgmma_weight), y (N, H, W, C_out). `nt` is the N tile
// (64 or 128), `gather` 1 for the im2col loader (C_in % 8 != 0), 0 for TMA.
extern "C" int fcd_conv3x3_wgmma(const void* x, const void* wimg, void* y, int N, int H, int W,
                                 int C_in, int C_out, int nt, int gather, int n_kb,
                                 void* stream) {
  if ((nt != 64 && nt != 128) || C_out > nt || n_kb < 1 || n_kb > 9) return kErrBadPlan;
  CUtensorMap tmap;
  memset(&tmap, 0, sizeof(tmap));
  if (!gather) {
    if (C_in % 8 != 0 || n_kb != 9) return kErrBadPlan;
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return kErrNoEncode;
    // (C, W, H, N), innermost first; the box is a tile's haloed 10x10 pixels
    // x 64 channels, channels past C_in and pixels outside the image read as
    // zero
    const cuuint64_t dims[4] = {(cuuint64_t)C_in, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t strides[3] = {(cuuint64_t)C_in * 2, (cuuint64_t)W * C_in * 2,
                                   (cuuint64_t)H * W * C_in * 2};
    const cuuint32_t box[4] = {64, kBoxW, kBoxH, 1};
    const cuuint32_t estrides[4] = {1, 1, 1, 1};
    CUresult res = encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                          strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return kErrEncodeBase + static_cast<int>(res);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt == 64)
    return gather ? launch_wgmma<64, true>(tmap, x, wimg, y, N, H, W, C_in, C_out, n_kb, s)
                  : launch_wgmma<64, false>(tmap, x, wimg, y, N, H, W, C_in, C_out, n_kb, s);
  return gather ? launch_wgmma<128, true>(tmap, x, wimg, y, N, H, W, C_in, C_out, n_kb, s)
                : launch_wgmma<128, false>(tmap, x, wimg, y, N, H, W, C_in, C_out, n_kb, s);
}
