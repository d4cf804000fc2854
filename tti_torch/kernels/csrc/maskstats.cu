// Mask-prototype statistics for Hopper (sm_90a): per detection, the logits
// protos[b, y, x, :] . coefs[b, d, :] inside the detection's box, reduced to
// moments and per-column statistics without materialising any mask.
//
// Replaces the Pallas kernels in tti/kernels/maskstats.py:
//   mask_stats_soft   <- _stats2s_kernel  (instance_mask_stats_soft_pallas2
//                        and _batched); contract instance_mask_stats_soft_xla
//   mask_stats_binary <- _stats2_kernel and _stats_kernel
//                        (instance_mask_stats_pallas2/_pallas and their
//                        _batched forms); contract instance_mask_stats_xla,
//                        any number of detections D.
//
// What bounds it: bytes. Each cell costs nm fused multiply-adds per
// detection whose box covers it, against nm * 2 bytes of bf16 protos read;
// the card's memory rate is the limit when every frame's protos are read
// once. Design: one thread block per (frame, detection); each thread owns
// proto columns and walks that column's rows in order, only inside the box,
// so a detection reads just its box and carries the column's bottom row,
// p(bottom) and p(row below) as plain registers. The TPU kernel's cross-tile
// carries existed only because Mosaic runs grid steps in order; nothing here
// crosses blocks. Moments are reduced in a fixed order (warp shuffles, then
// shared memory, no atomics), and the binary moments are exact integers, so
// every run gives the same bits. Overlapping boxes re-read protos from L2.
//
// Validity is an explicit test, never zeroed coefficients: sigmoid(0) = 0.5
// passes the soft path's >= 0.5 occupancy test. Rows past the grid are never
// read: a box reaching y2 == Hm stops at row Hm - 1, whose p_below stays 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One cell's dot product, summed in channel order. vec: 16-byte loads (the
// wrapper sets it when nm * sizeof(T) is a multiple of 16 and the base is
// 16-byte aligned); both branches add in the same order.
__device__ __forceinline__ float cell_dot(const __nv_bfloat16* __restrict__ cell,
                                          const float* coef, int nm, bool vec) {
  float acc = 0.f;
  if (vec) {
    const uint4* p = reinterpret_cast<const uint4*>(cell);
    for (int i = 0; i < nm / 8; ++i) {
      uint4 u = __ldg(p + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __bfloat1622float2(h[j]);
        acc = fmaf(f.x, coef[8 * i + 2 * j], acc);
        acc = fmaf(f.y, coef[8 * i + 2 * j + 1], acc);
      }
    }
    return acc;
  }
  for (int c = 0; c < nm; ++c) acc = fmaf(__bfloat162float(cell[c]), coef[c], acc);
  return acc;
}

__device__ __forceinline__ float cell_dot(const float* __restrict__ cell,
                                          const float* coef, int nm, bool vec) {
  float acc = 0.f;
  if (vec) {
    const float4* p = reinterpret_cast<const float4*>(cell);
    for (int i = 0; i < nm / 4; ++i) {
      float4 v = __ldg(p + i);
      acc = fmaf(v.x, coef[4 * i], acc);
      acc = fmaf(v.y, coef[4 * i + 1], acc);
      acc = fmaf(v.z, coef[4 * i + 2], acc);
      acc = fmaf(v.w, coef[4 * i + 3], acc);
    }
    return acc;
  }
  for (int c = 0; c < nm; ++c) acc = fmaf(cell[c], coef[c], acc);
  return acc;
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Fixed-order block sum; the result is valid in thread 0.
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* scratch) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  V total = V(0);
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// SOFT = false: binary statistics (logits > 0). Outputs m (B, D, 3) =
// m00, m10, m01; col_any and bottom (B, D, Wm).
// SOFT = true: p = sigmoid(logits); occupancy p >= 0.5 feeds the binary
// fields; m (B, D, 6) adds m00s, m10s, m01s; col_p and bottom_sub (B, D, Wm).
template <typename T, bool SOFT>
__global__ void __launch_bounds__(kThreads)
mask_stats_kernel(const T* __restrict__ protos, const float* __restrict__ coefs,
                  const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                  int D, int Hm, int Wm, int nm, int bf16_logits, int vec,
                  float* __restrict__ m_out, float* __restrict__ col_any,
                  float* __restrict__ bottom, float* __restrict__ col_p,
                  float* __restrict__ bottom_sub) {
  extern __shared__ float coef[];  // nm coefficients
  __shared__ unsigned long long scratch_u[kWarps];
  __shared__ float scratch_f[kWarps];

  const int d = blockIdx.x, b = blockIdx.y;
  const long long bd = (long long)b * D + d;
  const bool ok = valid[bd] != 0;
  const float x1 = boxes[bd * 4 + 0], y1 = boxes[bd * 4 + 1];
  const float x2 = boxes[bd * 4 + 2], y2 = boxes[bd * 4 + 3];

  for (int c = threadIdx.x; c < nm; c += blockDim.x) {
    const float v = coefs[bd * nm + c];
    coef[c] = bf16_logits ? round_bf16(v) : v;
  }
  __syncthreads();

  // Integer row range of the box; the float test per row stays the rule
  // (it also rejects NaN boxes).
  const int ylo = y1 > 0.f ? (int)fminf(ceilf(y1), (float)Hm) : 0;
  const int yhi = y2 < (float)Hm ? (int)fmaxf(ceilf(y2), 0.f) : Hm;

  unsigned long long a00 = 0, a10 = 0, a01 = 0;  // exact binary moments
  float s00 = 0.f, s10 = 0.f, s01 = 0.f;          // probability moments
  const T* frame = protos + (long long)b * Hm * Wm * nm;
  const long long col0 = bd * Wm;

  for (int x = threadIdx.x; x < Wm; x += blockDim.x) {
    const float xf = (float)x;
    float any = 0.f, bot = -1.f, cp = 0.f, p_b = 0.f, p_below = 0.f;
    if (ok && xf >= x1 && xf < x2) {
      for (int y = ylo; y < yhi; ++y) {
        const float yf = (float)y;
        if (!(yf >= y1 && yf < y2)) continue;
        float logit = cell_dot(frame + ((long long)y * Wm + x) * nm, coef, nm, vec != 0);
        if (bf16_logits) logit = round_bf16(logit);
        bool occ;
        if (SOFT) {
          const float p = 1.f / (1.f + expf(-logit));
          occ = p >= 0.5f;
          if (occ) {
            p_b = p;
            p_below = 0.f;
          } else if (bot >= 0.f && yf == bot + 1.f) {
            p_below = p;
          }
          cp = fmaxf(cp, p);
          s00 += p;
          s10 += p * xf;
          s01 += p * yf;
        } else {
          occ = logit > 0.f;
        }
        if (occ) {
          any = 1.f;
          bot = yf;
          a00 += 1;
          a10 += (unsigned long long)x;
          a01 += (unsigned long long)y;
        }
      }
    }
    col_any[col0 + x] = any;
    bottom[col0 + x] = bot;
    if (SOFT) {
      col_p[col0 + x] = cp;
      const float frac = fminf(fmaxf((p_b - 0.5f) / fmaxf(p_b - p_below, 1e-6f), 0.f), 1.f);
      bottom_sub[col0 + x] = bot >= 0.f ? bot + frac : -1.f;
    }
  }

  const unsigned long long t00 = block_sum(a00, scratch_u);
  const unsigned long long t10 = block_sum(a10, scratch_u);
  const unsigned long long t01 = block_sum(a01, scratch_u);
  constexpr int kMoments = SOFT ? 6 : 3;
  float* m = m_out + bd * kMoments;
  if (threadIdx.x == 0) {
    m[0] = (float)t00;
    m[1] = (float)t10;
    m[2] = (float)t01;
  }
  if (SOFT) {
    const float u00 = block_sum(s00, scratch_f);
    const float u10 = block_sum(s10, scratch_f);
    const float u01 = block_sum(s01, scratch_f);
    if (threadIdx.x == 0) {
      m[3] = u00;
      m[4] = u10;
      m[5] = u01;
    }
  }
}

template <bool SOFT>
int launch(const void* protos, int protos_bf16, const float* coefs, const float* boxes,
           const uint8_t* valid, int B, int D, int Hm, int Wm, int nm, int bf16_logits,
           int vec, float* m, float* col_any, float* bottom, float* col_p,
           float* bottom_sub, void* stream) {
  if (B <= 0 || D <= 0) return (int)cudaSuccess;
  const dim3 grid(D, B);
  const size_t smem = (size_t)nm * sizeof(float);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (protos_bf16) {
    mask_stats_kernel<__nv_bfloat16, SOFT><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(protos), coefs, boxes, valid, D, Hm, Wm, nm,
        bf16_logits, vec, m, col_any, bottom, col_p, bottom_sub);
  } else {
    mask_stats_kernel<float, SOFT><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(protos), coefs, boxes, valid, D, Hm, Wm, nm,
        bf16_logits, vec, m, col_any, bottom, col_p, bottom_sub);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tti_mask_stats_soft(const void* protos, int protos_bf16, const float* coefs,
                                   const float* boxes, const uint8_t* valid, int B, int D,
                                   int Hm, int Wm, int nm, int bf16_logits, int vec,
                                   float* m, float* col_any, float* bottom, float* col_p,
                                   float* bottom_sub, void* stream) {
  return launch<true>(protos, protos_bf16, coefs, boxes, valid, B, D, Hm, Wm, nm,
                      bf16_logits, vec, m, col_any, bottom, col_p, bottom_sub, stream);
}

extern "C" int tti_mask_stats_binary(const void* protos, int protos_bf16, const float* coefs,
                                     const float* boxes, const uint8_t* valid, int B, int D,
                                     int Hm, int Wm, int nm, int bf16_logits, int vec,
                                     float* m, float* col_any, float* bottom, void* stream) {
  return launch<false>(protos, protos_bf16, coefs, boxes, valid, B, D, Hm, Wm, nm,
                       bf16_logits, vec, m, col_any, bottom, nullptr, nullptr, stream);
}
