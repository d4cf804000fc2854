// Fused warp pass 1 for Hopper (sm_90a): uint8 BGR frames -> k-strided
// decimation -> BGR->RGB -> x * (1/255) - pad in bf16 -> per source row y the
// product (3B, ws) @ W1[y] (ws, wo) with float32 accumulation -> the pass-1
// intermediate (hs, 3, B, wo) in bf16.
//
// Replaces tti/kernels/warp_p1.py::_p1_kernel (warp_pass1_decimated), and
// with it the stride-k byte select that tools/probe_warp_p1.py probed: here
// that select is an ordinary load.
//
// Arithmetic, step by step as the TPU kernel: the byte converts to bf16
// exactly; times bf16(1/255), rounded to bf16; minus bf16(pad), rounded to
// bf16; products accumulate in float32 on the tensor cores; the sum rounds
// once to bf16. (The unfused chain divides by 255 instead, which differs in
// bf16: bf16(1/255) is 129/32768, 0.39% above 1/255.)
//
// What bounds it: bytes. At the headline shape (B 128, 1080x1920, k 3, hs
// 360, ws = wo = 640) the kept rows are 128*360*5760 B = 265 MB (a 9-byte
// stride touches every 32-byte sector of a kept row, so the whole row is
// read; the two skipped rows are not), W1 is 360*640*640*2 B = 295 MB and the
// output 360*3*128*640*2 B = 177 MB: 737 MB, 0.22 ms at 3.35 TB/s, against
// 2*384*640*640*360 = 113 GFLOP, 0.11 ms at 989 TFLOP/s dense bf16.
//
// Design: one block per (source row y, 32 frames). The three channels of a
// pixel come from the same three bytes, so a block takes all three channels
// of its frames: 96 rows of the product.
//   Phase 1 builds the whole bf16 operand of those rows, (96, ws), in shared
//   memory, once: it walks the source columns 32 at a time; 16-byte cp.async
//   loads, neighbouring threads on neighbouring words, bring each frame's
//   byte span of the kept row into a ring, two spans ahead, while the
//   current span is selected, flipped and taken through the three rounded
//   steps.
//   Phase 2 walks the output columns 128 at a time and, under them, W1[y] 64
//   rows at a time: each (64, 128) tile of W1[y] arrives by cp.async, three
//   tiles ahead, while eight warps multiply the current one: ldmatrix
//   fragments, mma.sync m16n8k16 bf16 with float32 accumulators (half the
//   shared-memory traffic of wmma fragments, which was the limit); one
//   barrier per tile.
// So the frames' bytes are read and converted once, W1[y] is read once per
// block, and the four blocks of a row y (neighbours in launch order) share
// it in L2. The operand is 124 KB at ws = 640: one block per SM. When it
// does not fit (ws above 832), or the batch is 16 or less, the block
// takes 16 frames instead. W1
// is treated as dense: using its two-tap band is left for later, as are
// wgmma and TMA.
//
// The TPU kernel's hs % 8 rule and its 128-column block were Mosaic's tiling
// and are not carried over: every ragged edge (frames, source columns,
// output columns, a frame buffer or weights that are not 16-byte aligned) is
// masked or takes the byte-wise path here.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;        // output columns per tile
constexpr int kDepth = 32;        // source columns per step of phase 1
constexpr int kWDepth = 64;       // rows of W1[y] per step of phase 2
constexpr int kStages = 4;        // W1 tiles in flight or in use
constexpr int kRawStages = 3;     // byte spans in flight or in use
constexpr int kLdB = kCols + 8;   // padded leading dimension of the W1 tile (elements)
constexpr int kWTile = kWDepth * kLdB;          // elements of one W1 tile
constexpr int kMaxSmem = 227 * 1024;

// A block of kFrames frames has 3 * kFrames rows, channel-major then frame.
// The eight warps tile (rows x 128 columns) as kWarpsM x kWarpsN, 48 rows
// and kFragsN fragments of 16 columns each.
template <int kFrames>
struct Tiling {
  static constexpr int kRows = 3 * kFrames;
  static constexpr int kWarpsM = kRows / 48;
  static constexpr int kWarpsN = kWarps / kWarpsM;
  static constexpr int kFragsN = kCols / (16 * kWarpsN);
  static_assert(kRows % 48 == 0 && kWarps % kWarpsM == 0 && kFragsN >= 1, "warp tiling");
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four 8x8 bf16 matrices from shared memory, one row address per lane, in
// the register layout mma.sync wants; .trans for an operand stored (k, n).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, float32) += a (16 x 16, bf16) * b (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Bytes of one frame's span per step, with room for the 16-byte alignment
// slack on both sides.
__host__ __device__ inline int raw_stride(int k) {
  return 16 * ((3 * k * (kDepth - 1) + 3 + 30) / 16);
}

// Leading dimension of the operand: ws rounded up to whole steps, plus 8
// elements so that the rows of a fragment fall on different banks.
__host__ __device__ inline int operand_ld(int ws) { return round_up(ws, kWDepth) + 8; }

// Shared memory after the operand: the W1 tiles' ring, whose last two
// stages are free during phase 1 and hold the byte spans then (the region
// is as large as the larger of the two).
template <int kFrames>
__host__ __device__ inline int ring_bytes(int k) {
  const int spans = kRawStages * kFrames * raw_stride(k);
  const int late = (kStages - 2) * kWTile * 2;
  return 2 * kWTile * 2 + (spans > late ? spans : late);
}

template <int kFrames>
__host__ __device__ inline size_t smem_bytes(int k, int ws) {
  return static_cast<size_t>(Tiling<kFrames>::kRows) * operand_ld(ws) * 2 + ring_bytes<kFrames>(k);
}

template <int kFrames>
__global__ void __launch_bounds__(kThreads, 1)
warp_p1_kernel(const uint8_t* __restrict__ frames, long long total_bytes,
               const __nv_bfloat16* __restrict__ w1, __nv_bfloat16* __restrict__ out,
               int B, int H, int W, int k, int off, int ws, int wo, float pad_value,
               int bgr_flip, int vec_frames, int vec_w1) {
  using T = Tiling<kFrames>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = operand_ld(ws);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ws = As + T::kRows * lda;
  uint8_t* spans = reinterpret_cast<uint8_t*>(Ws + 2 * kWTile);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const int b0 = blockIdx.x * kFrames;
  const int y = blockIdx.y;
  const int raw_ld = raw_stride(k);
  const long long row_bytes = 3LL * W;
  const long long src_row = off + static_cast<long long>(k) * y;
  const float inv255 = round_bf16(1.0f / 255.0f);
  const float pad = round_bf16(pad_value);
  const __nv_bfloat16* w1y = w1 + static_cast<long long>(y) * ws * wo;
  const int steps1 = round_up(ws, kWDepth) / kDepth;  // phase 1, to the operand's full width
  const int steps = (ws + kWDepth - 1) / kWDepth;     // phase 2, per tile of output columns
  const int tiles = (wo + kCols - 1) / kCols;
  const int total = tiles * steps;

  // Byte offset of frame b's kept row.
  auto row_base = [&](int b) { return (static_cast<long long>(b) * H + src_row) * row_bytes; };

  // Fetch the W1[y] tile of step t (output columns tile t / steps, rows of
  // step t % steps) into its buffer, zero past either edge. Aligned words go
  // by cp.async; the rest is loaded and stored directly. Past the last step
  // it only closes an empty group, so that the groups stay one per step.
  auto fetch_w = [&](int t) {
    __nv_bfloat16* dst0 = Ws + (t % kStages) * kWTile;
    const int n0 = (t / steps) * kCols, x0 = (t % steps) * kWDepth;
    for (int idx = tid; t < total && idx < kWDepth * (kCols / 8); idx += kThreads) {
      const int r = idx / (kCols / 8), c8 = idx % (kCols / 8);
      const int x = x0 + r, n = n0 + 8 * c8;
      __nv_bfloat16* dst = dst0 + r * kLdB + 8 * c8;
      const __nv_bfloat16* src = w1y + static_cast<long long>(x) * wo + n;
      if (x < ws && vec_w1 && n + 8 <= wo) {
        __pipeline_memcpy_async(dst, src, 16);
      } else {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        __nv_bfloat16* vh = reinterpret_cast<__nv_bfloat16*>(&v);
        for (int j = 0; x < ws && j < 8 && n + j < wo; ++j) vh[j] = src[j];
        *reinterpret_cast<uint4*>(dst) = v;
      }
    }
    __pipeline_commit();
  };

  // Fetch, for step s, each frame's span of the kept row as whole 16-byte
  // words: kThreads / kFrames threads per frame, on neighbouring words.
  constexpr int kPerFrame = kThreads / kFrames;
  const int fetch_b = b0 + tid / kPerFrame;
  const long long fetch_base = row_base(fetch_b);
  auto fetch_raw = [&](int s) {
    uint8_t* dst0 = spans + ((s % kRawStages) * kFrames + tid / kPerFrame) * raw_ld;
    const int nx = min(kDepth, ws - s * kDepth);
    const long long g0 = fetch_base + 3LL * (off + static_cast<long long>(k) * s * kDepth);
    const int words = (3 * k * (nx - 1) + 3 + 30) / 16;
    if (fetch_b < B && nx > 0) {
      for (int i = tid % kPerFrame; i < words; i += kPerFrame) {
        const long long ga = (g0 & ~15LL) + 16LL * i;
        if (vec_frames && ga + 16 <= total_bytes) {
          __pipeline_memcpy_async(dst0 + 16 * i, frames + ga, 16);
        } else {
          uint4 v;
          uint8_t* vb = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
          for (int j = 0; j < 16; ++j) vb[j] = (ga + j < total_bytes) ? frames[ga + j] : 0;
          *reinterpret_cast<uint4*>(dst0 + 16 * i) = v;
        }
      }
    }
    __pipeline_commit();
  };

  // Phase 1: the operand. One warp per frame, one lane per source column;
  // rows of frames past B and columns past ws are zero, so they add nothing
  // to the product.
  fetch_w(0);
  fetch_w(1);
  fetch_raw(0);
  fetch_raw(1);
  for (int s = 0; s < steps1; ++s) {
    // This step's bytes have landed (all groups but the newest are
    // complete), and every warp has finished selecting from the buffer that
    // the span two steps ahead goes to.
    __pipeline_wait_prior(1);
    __syncthreads();
    fetch_raw(s + 2);
    const int x = s * kDepth + lane;
    const uint8_t* raw = spans + (s % kRawStages) * kFrames * raw_ld;
    const long long beg = 3LL * (off + static_cast<long long>(k) * s * kDepth);
#pragma unroll
    for (int bb = warp; bb < kFrames; bb += kWarps) {
      const int b = b0 + bb;
      float v[3] = {0.f, 0.f, 0.f};
      if (b < B && x < ws) {
        const int shift = static_cast<int>((row_base(b) + beg) & 15);
        const uint8_t* p = raw + bb * raw_ld + shift + 3 * k * lane;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float u = static_cast<float>(p[bgr_flip ? 2 - c : c]);
          v[c] = round_bf16(round_bf16(u * inv255) - pad);
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) As[(c * kFrames + bb) * lda + x] = __float2bfloat16_rn(v[c]);
    }
  }

  // Phase 2: the product, one W1 tile per step, the tiles of the next three
  // steps in flight. The barrier closes phase 1: the operand is complete and
  // the span buffers are free for the ring's last stages.
  __syncthreads();
  fetch_w(2);
  // Each warp holds 3 x (2 * kFragsN) accumulators of 16 rows x 8 columns.
  constexpr int kTilesN = 2 * T::kFragsN;
  constexpr int kWidth = 8 * kTilesN;  // output columns per warp
  float acc[3][kTilesN][4];
  const bool pairs = wo % 2 == 0;
  // ldmatrix row addresses of this lane: the operand's tile is 16 rows x 16
  // columns (lanes 0-15 the rows at column 0, lanes 16-31 at column 8); a W1
  // tile 16 rows (k) x 16 columns (n), read transposed, the same way.
  const __nv_bfloat16* a_lane = As + (48 * wm + (lane & 15)) * lda + 8 * (lane >> 4);
  const int w_lane = (lane & 15) * kLdB + kWidth * wn + 8 * (lane >> 4);
  for (int t = 0; t < total; ++t) {
    const int tile = t / steps, s = t % steps;
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < kTilesN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    // This tile has landed (all groups but the newest two are complete);
    // every warp is past the product of the last step, whose buffer is free.
    __pipeline_wait_prior(2);
    __syncthreads();
    fetch_w(t + 3);
    const __nv_bfloat16* Wt = Ws + (t % kStages) * kWTile + w_lane;
#pragma unroll
    for (int kk = 0; kk < kWDepth; kk += 16) {
      uint32_t a[3][4], bw[T::kFragsN][4];
#pragma unroll
      for (int i = 0; i < 3; ++i) ldmatrix_x4(a[i], a_lane + 16 * i * lda + s * kWDepth + kk);
#pragma unroll
      for (int j = 0; j < T::kFragsN; ++j) ldmatrix_x4_trans(bw[j], Wt + kk * kLdB + 16 * j);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < kTilesN; ++j)
          mma_bf16(acc[i][j], a[i], bw[j / 2][2 * (j % 2)], bw[j / 2][2 * (j % 2) + 1]);
    }
    if (s + 1 < steps) continue;

    // Epilogue of this tile: straight from the accumulators to
    // out[y, c, b, n] as bf16 pairs. An accumulator holds rows lane / 4 and
    // lane / 4 + 8, columns 2 * (lane % 4) and the next; the pair is one
    // 4-byte store when wo is even (then every pair is aligned).
    const int n_first = tile * kCols + kWidth * wn + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int m = 48 * wm + 16 * i;
      const int c = m / kFrames;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = b0 + m % kFrames + (lane >> 2) + 8 * h;
        if (b >= B) continue;
        __nv_bfloat16* row = out + ((static_cast<long long>(y) * 3 + c) * B + b) * wo;
#pragma unroll
        for (int j = 0; j < kTilesN; ++j) {
          const int n = n_first + 8 * j;
          const __nv_bfloat162 v = __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          if (pairs && n + 1 < wo) {
            *reinterpret_cast<__nv_bfloat162*>(row + n) = v;
          } else {
            if (n < wo) row[n] = v.x;
            if (n + 1 < wo) row[n + 1] = v.y;
          }
        }
      }
    }
  }
}

template <int kFrames>
int launch(const void* frames, long long total_bytes, const void* w1, void* out, int B, int H,
           int W, int k, int off, int hs, int ws, int wo, float pad_value, int bgr_flip,
           int vec_frames, int vec_w1, void* stream) {
  const size_t smem = smem_bytes<kFrames>(k, ws);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(warp_p1_kernel<kFrames>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((B + kFrames - 1) / kFrames, hs);
  warp_p1_kernel<kFrames><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), total_bytes, static_cast<const __nv_bfloat16*>(w1),
      static_cast<__nv_bfloat16*>(out), B, H, W, k, off, ws, wo, pad_value, bgr_flip, vec_frames,
      vec_w1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// frames (B, H, W, 3) u8 of total_bytes bytes; w1 (hs, ws, wo) bf16; out
// (hs, 3, B, wo) bf16. vec_frames / vec_w1: the buffer is 16-byte aligned
// (and, for w1, wo is a multiple of 8), so 16-byte loads are allowed.
// Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue (1)
// when the operand of even 16 frames does not fit in shared memory.
extern "C" int tti_warp_pass1_decimated(const void* frames, long long total_bytes, const void* w1,
                                        void* out, int B, int H, int W, int k, int off, int hs,
                                        int ws, int wo, float pad_value, int bgr_flip,
                                        int vec_frames, int vec_w1, void* stream) {
  if (B > 16 && smem_bytes<32>(k, ws) <= kMaxSmem)
    return launch<32>(frames, total_bytes, w1, out, B, H, W, k, off, hs, ws, wo, pad_value,
                      bgr_flip, vec_frames, vec_w1, stream);
  if (smem_bytes<16>(k, ws) <= kMaxSmem)
    return launch<16>(frames, total_bytes, w1, out, B, H, W, k, off, hs, ws, wo, pad_value,
                      bgr_flip, vec_frames, vec_w1, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
