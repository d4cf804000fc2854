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
// detection whose box covers it, against nm * 2 bytes of bf16 protos read,
// and every detection, valid or not, has 2 or 4 rows of Wm floats written.
// The card's memory rate is the limit when every frame's protos are read
// once.
//
// Design:
//
// - Work is split by cells. The unit is (frame, detection, strip): kStrip
//   columns of one valid detection's box over all of the box's rows. A strip
//   belongs to one block; its rows are cut into chunks of kChunk grid rows
//   (chunk c is rows [c kChunk, (c + 1) kChunk) inside the box; 4 rows in
//   the soft kernel, 2 in the binary one), dealt to the block's warps in
//   turn. A lane owns a column, so a warp reads whole contiguous row
//   segments. A box over the whole grid is Wm / kStrip blocks of kWarps
//   warps, not one block's walk.
// - Loads are kept in flight. With nm = 32 bf16 protos (the fast path) a
//   thread starts the 4 x 16-byte loads of a chunk's kChunk cells before it
//   uses any, and asks for its next chunk as soon as the dot products of
//   this one are done, so the rest of the chunk's work (sigmoid, carries,
//   moments) hides the loads; a strip's first loads go out before the
//   barrier that publishes its coefficients. Other nm and float32 protos
//   take the general path, a cell at a time.
// - The carries are combined in order after the parallel part. Per column a
//   chunk yields its bottom row, p there, p of the row under it inside the
//   chunk, p of its first row (to shared memory) and the column's max p. A
//   warp's chunks ascend, so a later occupied chunk replaces its state; warp
//   0 then takes the state with the lowest bottom over the warps. p_below is
//   the in-chunk value unless the bottom is a chunk's last row: then it is
//   the next chunk's first-row p, or 0 past the box or the grid.
// - Moments: exact integers (binary) and floats summed in a fixed order:
//   thread over its rows, warp by shuffles, the block's warps in order to a
//   per-strip partial in scratch, and a second small kernel adds a
//   detection's strips in order and writes m for every detection. No float
//   atomics: two launches on the same input give the same bits.
// - Invalid detections, and the columns of a valid one that no strip covers,
//   cost a fill: 16-byte stores of 0 and -1, a warp per output row. The grid
//   is (blocks per frame, B); each block lists the frame's strips itself
//   (valid flags and boxes, a warp scan), fills its share of the frame's
//   rows, and takes strips i = blockIdx.x, + gridDim.x, ... Nothing is read
//   back to the host. A frame's blocks are neighbours in the grid, so
//   overlapping boxes (stitches inside the fabric) re-read protos from L2.
//
// Validity is an explicit test, never zeroed coefficients: sigmoid(0) = 0.5
// passes the soft path's >= 0.5 occupancy test. The cells of a box are the
// integers x1 <= x < x2, y1 <= y < y2, computed once per box (cell_range);
// a NaN bound reads empty. Rows past the grid are never read: a box
// reaching y2 == Hm stops at row Hm - 1, whose p_below stays 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 32;  // columns of a strip: one per lane
// Grid rows of a chunk (the cells a thread has in flight), and the blocks of
// an SM the registers are held to. The soft kernel's frames are large and
// its strips long: more bytes in flight per thread. The binary kernel's work
// is small and its time is latency: more blocks in flight per SM.
// (The TTI_MS_* macros exist for `chip_smoke.py --ablate`, which builds
// variants to time what each part of the design costs or buys; a build
// without them is the kernel as shipped, and a variant that leaves a part
// out computes wrong results on purpose.)
#ifndef TTI_MS_SOFT_CHUNK
#define TTI_MS_SOFT_CHUNK 4
#define TTI_MS_SOFT_BLOCKS 2
#define TTI_MS_BINARY_CHUNK 2
#define TTI_MS_BINARY_BLOCKS 4
#endif
template <bool SOFT> struct Tuning {
  static constexpr int kChunk = SOFT ? TTI_MS_SOFT_CHUNK : TTI_MS_BINARY_CHUNK;
  static constexpr int kBlocksPerSM = SOFT ? TTI_MS_SOFT_BLOCKS : TTI_MS_BINARY_BLOCKS;
};
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;

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

// The integers i of [0, n) with lo <= i < hi, as [ilo, ihi). A NaN bound
// gives none.
__device__ __forceinline__ void cell_range(float lo, float hi, int n, int& ilo, int& ihi) {
  ilo = ihi = 0;
  if (!(lo == lo) || !(hi == hi)) return;
  ilo = lo > 0.f ? (int)fminf(ceilf(lo), (float)n) : 0;
  ihi = hi < (float)n ? (int)fmaxf(ceilf(hi), 0.f) : n;
  if (ihi < ilo) ihi = ilo;
}

// A detection's cells and strips; all zero when it is invalid or empty.
struct Box {
  int x0, x1, y0, y1, s0, s1;
};

__device__ __forceinline__ Box load_box(const float* __restrict__ boxes,
                                        const uint8_t* __restrict__ valid, long long bd,
                                        int Hm, int Wm) {
  Box r = {0, 0, 0, 0, 0, 0};
  const float* q = boxes + bd * 4;
  const float bx1 = q[0], by1 = q[1], bx2 = q[2], by2 = q[3];  // beside the flag: one trip
  if (valid[bd] == 0) return r;
  int x0, x1, y0, y1;
  cell_range(bx1, bx2, Wm, x0, x1);
  cell_range(by1, by2, Hm, y0, y1);
  if (x1 <= x0 || y1 <= y0) return r;
  r.x0 = x0, r.x1 = x1, r.y0 = y0, r.y1 = y1;
  r.s0 = x0 / kStrip;
  r.s1 = (x1 - 1) / kStrip + 1;
  return r;
}

// Shared-memory floats for the first-row p of a strip's chunks (soft only).
template <bool SOFT>
__host__ __device__ constexpr int first_p_floats(int Hm) {
  return SOFT ? (Hm / Tuning<true>::kChunk + 2) * kStrip : 0;
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Fast path (nm = 32 bf16): the 64 bytes of each cell of one column in rows
// [r0, r1), at most kChunk of them, as 4 x 16-byte loads, all started before
// any is used. Rows past r1 repeat the last one and are not used.
template <int kChunk>
__device__ __forceinline__ void load_chunk(uint4 (&buf)[kChunk][4],
                                           const __nv_bfloat16* __restrict__ column,
                                           long long row_stride, int r0, int r1) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const uint4* q =
        reinterpret_cast<const uint4*>(column + (long long)min(r0 + j, r1 - 1) * row_stride);
#pragma unroll
    for (int i = 0; i < 4; ++i) buf[j][i] = __ldg(q + i);
  }
}
template <int kChunk>
__device__ __forceinline__ void load_chunk(uint4 (&)[kChunk][4], const float*, long long, int,
                                           int) {}  // float32 protos take the general path

// One output row of Wm floats set to `value`, by one warp, except the columns
// [c0, c1) (multiples of kStrip, or Wm), which a strip's block writes.
__device__ __forceinline__ void fill_row(float* __restrict__ row, int Wm, int c0, int c1,
                                         float value, int lane) {
  if ((Wm & 3) == 0) {
    const float4 v = make_float4(value, value, value, value);
    for (int q = lane; 4 * q < Wm; q += 32)
      if (4 * q < c0 || 4 * q >= c1) reinterpret_cast<float4*>(row)[q] = v;
  } else {
    for (int x = lane; x < Wm; x += 32)
      if (x < c0 || x >= c1) row[x] = value;
  }
}

// SOFT = false: binary statistics (logits > 0): col_any and bottom (B, D, Wm).
// SOFT = true: p = sigmoid(logits); occupancy p >= 0.5 feeds the binary
// fields; col_p and bottom_sub (B, D, Wm) are added. Moments go to scratch,
// a partial per (frame, detection, strip): part_u 3 integers, part_f (SOFT)
// 3 floats. FAST: bf16 protos, nm == 32, 16-byte aligned.
template <typename T, bool SOFT, bool FAST>
__global__ void __launch_bounds__(kThreads, Tuning<SOFT>::kBlocksPerSM)
stats_strips(const T* __restrict__ protos, const float* __restrict__ coefs,
             const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
             int D, int Hm, int Wm, int nm, int bf16_logits, int vec, int nstrips,
             float* __restrict__ col_any, float* __restrict__ bottom,
             float* __restrict__ col_p, float* __restrict__ bottom_sub,
             u64* __restrict__ part_u, float* __restrict__ part_f) {
  extern __shared__ __align__(16) float smem[];
  float* coef = smem;                                     // nm, padded to 4
  float* first_p = coef + ((nm + 3) & ~3);                // SOFT: chunks x kStrip
  int* start = reinterpret_cast<int*>(first_p + first_p_floats<SOFT>(Hm));
  int* strip0 = start + D + 1;                            // D
  __shared__ float w_bot[kWarps][kStrip], w_pb[kWarps][kStrip];
  __shared__ float w_pbelow[kWarps][kStrip], w_cp[kWarps][kStrip];
  __shared__ u64 w_u[kWarps][3];
  __shared__ float w_f[kWarps][3];

  constexpr int kChunk = Tuning<SOFT>::kChunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, S = gridDim.x;
  const long long bd0 = (long long)b * D;

  // The frame's strips: start[d] is the index of detection d's first strip
  // (an exclusive scan of the strip counts), strip0[d] its first strip.
  for (int d = tid; d < D; d += kThreads) {
    const Box bx = load_box(boxes, valid, bd0 + d, Hm, Wm);
    strip0[d] = bx.s0;
    start[d + 1] = bx.s1 - bx.s0;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < D; base += 32) {
      const int i = base + lane;
      int v = i < D ? start[i + 1] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(kFull, v, off);
        if (lane >= off) v += up;
      }
      if (i < D) start[i + 1] = carry + v;
      carry += __shfl_sync(kFull, v, 31);
    }
    if (lane == 0) start[0] = 0;
  }
  __syncthreads();
  const int n_items = start[D];

  // Fill: this block's share of the frame's output rows, a warp per row.
#ifndef TTI_MS_WITHOUT_FILL
  for (int d = blockIdx.x * kWarps + warp; d < D; d += S * kWarps) {
    const int c0 = strip0[d] * kStrip;
    const int c1 = min((strip0[d] + start[d + 1] - start[d]) * kStrip, Wm);
    const long long row = (bd0 + d) * Wm;
    fill_row(col_any + row, Wm, c0, c1, 0.f, lane);
    fill_row(bottom + row, Wm, c0, c1, -1.f, lane);
    if (SOFT) {
      fill_row(col_p + row, Wm, c0, c1, 0.f, lane);
      fill_row(bottom_sub + row, Wm, c0, c1, -1.f, lane);
    }
  }
#endif
#ifdef TTI_MS_WITHOUT_STRIPS
  return;
#endif

  const T* frame = protos + (long long)b * Hm * Wm * nm;
  for (int item = blockIdx.x; item < n_items; item += S) {
    // The detection whose strips hold this one: the last d with start[d] <= item.
    int d = 0, hi = D;
    while (hi - d > 1) {
      const int mid = (d + hi) >> 1;
      if (start[mid] <= item) d = mid; else hi = mid;
    }
    const int strip = strip0[d] + item - start[d];
    const long long bd = bd0 + d;
    const Box bx = load_box(boxes, valid, bd, Hm, Wm);

    const int x = strip * kStrip + lane;
    const bool active = x >= bx.x0 && x < bx.x1;
    const float xf = (float)x;
    const int c_first = bx.y0 / kChunk, c_last = (bx.y1 - 1) / kChunk;
    const T* column = frame + (long long)x * nm;
    const long long row_stride = (long long)Wm * nm;

    // Fast path: this warp's first chunk is asked for before the barrier
    // that publishes the coefficients, so the two trips to memory overlap.
    int c = c_first + warp;
    uint4 buf[kChunk][4];
#ifndef TTI_MS_WITHOUT_PREFETCH
    if (FAST && active && c <= c_last)
      load_chunk(buf, column, row_stride, max(c * kChunk, bx.y0), min((c + 1) * kChunk, bx.y1));
#endif

    __syncthreads();  // the last strip's readers of shared memory are done
    for (int k = tid; k < nm; k += kThreads) {
      const float v = coefs[bd * nm + k];
      coef[k] = bf16_logits ? round_bf16(v) : v;
    }
    __syncthreads();

    float bot = -1.f, p_b = 0.f, p_below = 0.f, cp = 0.f;
    u64 a00 = 0, a10 = 0, a01 = 0;          // exact binary moments
    float s00 = 0.f, s10 = 0.f, s01 = 0.f;  // probability moments

    for (; c <= c_last; c += kWarps) {
      const int r0 = max(c * kChunk, bx.y0), r1 = min((c + 1) * kChunk, bx.y1);
      float c_bot = -1.f, c_pb = 0.f, c_pbelow = 0.f, c_first_p = 0.f;
      if (active) {
        float logit[kChunk];
        if (FAST) {
          // The dot products in channel order, then the next chunk's loads,
          // which the rest of this chunk's work hides.
#ifdef TTI_MS_WITHOUT_PREFETCH
          load_chunk(buf, column, row_stride, r0, r1);
#endif
          const float4* c4 = reinterpret_cast<const float4*>(coef);
#pragma unroll
          for (int j = 0; j < kChunk; ++j) logit[j] = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 ca = c4[2 * i], cb = c4[2 * i + 1];
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
              const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&buf[j][i]);
              const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
              const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
              float acc = logit[j];
              acc = fmaf(f0.x, ca.x, acc);
              acc = fmaf(f0.y, ca.y, acc);
              acc = fmaf(f1.x, ca.z, acc);
              acc = fmaf(f1.y, ca.w, acc);
              acc = fmaf(f2.x, cb.x, acc);
              acc = fmaf(f2.y, cb.y, acc);
              acc = fmaf(f3.x, cb.z, acc);
              acc = fmaf(f3.y, cb.w, acc);
              logit[j] = acc;
            }
          }
#ifndef TTI_MS_WITHOUT_PREFETCH
          const int cn = c + kWarps;
          if (cn <= c_last)
            load_chunk(buf, column, row_stride, cn * kChunk, min((cn + 1) * kChunk, bx.y1));
#endif
        } else {
#pragma unroll
          for (int j = 0; j < kChunk; ++j)
            logit[j] = r0 + j < r1
                ? cell_dot(column + (long long)(r0 + j) * row_stride, coef, nm, vec != 0)
                : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int yy = r0 + j;
          if (yy >= r1) break;
          const float yf = (float)yy;
          const float lg = bf16_logits ? round_bf16(logit[j]) : logit[j];
          bool occ;
          if (SOFT) {
            const float p = 1.f / (1.f + expf(-lg));
            occ = p >= 0.5f;
            if (j == 0) c_first_p = p;
            if (occ) {
              c_pb = p;
              c_pbelow = 0.f;
            } else if (c_bot >= 0.f && yf == c_bot + 1.f) {
              c_pbelow = p;
            }
            cp = fmaxf(cp, p);
            s00 += p;
            s10 += p * xf;
            s01 += p * yf;
          } else {
            occ = lg > 0.f;
          }
          if (occ) {
            c_bot = yf;
            a00 += 1;
            a10 += (u64)x;
            a01 += (u64)yy;
          }
        }
      }
      if (SOFT) first_p[(c - c_first) * kStrip + lane] = c_first_p;
      if (c_bot >= 0.f) {  // this warp's chunks ascend: a lower one replaces
        bot = c_bot;
        p_b = c_pb;
        p_below = c_pbelow;
      }
    }

    w_bot[warp][lane] = bot;
    if (SOFT) {
      w_pb[warp][lane] = p_b;
      w_pbelow[warp][lane] = p_below;
      w_cp[warp][lane] = cp;
    }
    a00 = warp_sum(a00), a10 = warp_sum(a10), a01 = warp_sum(a01);
    if (SOFT) s00 = warp_sum(s00), s10 = warp_sum(s10), s01 = warp_sum(s01);
    if (lane == 0) {
      w_u[warp][0] = a00, w_u[warp][1] = a10, w_u[warp][2] = a01;
      if (SOFT) w_f[warp][0] = s00, w_f[warp][1] = s10, w_f[warp][2] = s01;
    }
    __syncthreads();

    if (warp == 0) {
      // The column's state over the warps, lowest bottom first.
      bot = -1.f, p_b = 0.f, p_below = 0.f, cp = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wb = w_bot[w][lane];
        if (wb > bot) {
          bot = wb;
          if (SOFT) p_b = w_pb[w][lane], p_below = w_pbelow[w][lane];
        }
        if (SOFT) cp = fmaxf(cp, w_cp[w][lane]);
      }
      if (SOFT && bot >= 0.f) {
        // A bottom on its chunk's last row has its p_below in the next
        // chunk's first row, if the box has one.
        const int under = (int)bot + 1;
        if (under % kChunk == 0 && under < bx.y1)
          p_below = first_p[(under / kChunk - c_first) * kStrip + lane];
      }
      if (x < Wm) {
        const long long col = bd * Wm + x;
        col_any[col] = bot >= 0.f ? 1.f : 0.f;
        bottom[col] = bot;
        if (SOFT) {
          col_p[col] = cp;
          const float frac =
              fminf(fmaxf((p_b - 0.5f) / fmaxf(p_b - p_below, 1e-6f), 0.f), 1.f);
          bottom_sub[col] = bot >= 0.f ? bot + frac : -1.f;
        }
      }
      if (lane < 3) {
        const long long slot = (bd * nstrips + strip) * 3 + lane;
        u64 t = 0;
        for (int w = 0; w < kWarps; ++w) t += w_u[w][lane];
        part_u[slot] = t;
        if (SOFT) {
          float f = 0.f;
          for (int w = 0; w < kWarps; ++w) f += w_f[w][lane];
          part_f[slot] = f;
        }
      }
    }
  }
}

// m (B, D, 3 or 6) for every detection: its strips' partials added in order
// (none for an invalid or empty one).
template <bool SOFT>
__global__ void __launch_bounds__(kThreads)
stats_moments(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
              long long n, int Hm, int Wm, int nstrips, const u64* __restrict__ part_u,
              const float* __restrict__ part_f, float* __restrict__ m_out) {
  const long long bd = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (bd >= n) return;
  const Box bx = load_box(boxes, valid, bd, Hm, Wm);
  u64 t0 = 0, t1 = 0, t2 = 0;
  float f0 = 0.f, f1 = 0.f, f2 = 0.f;
  for (int s = bx.s0; s < bx.s1; ++s) {
    const long long slot = (bd * nstrips + s) * 3;
    t0 += part_u[slot], t1 += part_u[slot + 1], t2 += part_u[slot + 2];
    if (SOFT) f0 += part_f[slot], f1 += part_f[slot + 1], f2 += part_f[slot + 2];
  }
  float* m = m_out + bd * (SOFT ? 6 : 3);
  m[0] = (float)t0, m[1] = (float)t1, m[2] = (float)t2;
  if (SOFT) m[3] = f0, m[4] = f1, m[5] = f2;
}

template <typename T, bool SOFT, bool FAST>
cudaError_t launch_strips(const void* protos, const float* coefs, const float* boxes,
                          const uint8_t* valid, int B, int D, int Hm, int Wm, int nm,
                          int bf16_logits, int vec, int blocks_per_frame, int nstrips,
                          float* col_any, float* bottom, float* col_p, float* bottom_sub,
                          u64* part_u, float* part_f, cudaStream_t s) {
  const size_t smem = sizeof(float) * (((nm + 3) & ~3) + first_p_floats<SOFT>(Hm))
                      + sizeof(int) * (2 * (size_t)D + 1);
  auto kernel = stats_strips<T, SOFT, FAST>;
  if (smem > 48 * 1024) {
    if (smem > 200 * 1024) return cudaErrorInvalidValue;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(blocks_per_frame, B), kThreads, smem, s>>>(
      static_cast<const T*>(protos), coefs, boxes, valid, D, Hm, Wm, nm, bf16_logits, vec,
      nstrips, col_any, bottom, col_p, bottom_sub, part_u, part_f);
  return cudaGetLastError();
}

// Two launches on the stream: the strips, then the moments. part_u
// (B, D, nstrips, 3) 8-byte integers and part_f (the same, floats; SOFT) are
// scratch the caller allocates; they need no initial value.
template <bool SOFT>
int launch(const void* protos, int protos_bf16, const float* coefs, const float* boxes,
           const uint8_t* valid, int B, int D, int Hm, int Wm, int nm, int bf16_logits,
           int vec, int blocks_per_frame, float* m, float* col_any, float* bottom,
           float* col_p, float* bottom_sub, void* part_u, float* part_f, void* stream) {
  if (B <= 0 || D <= 0) return (int)cudaSuccess;
  if (blocks_per_frame <= 0 || Hm <= 0 || Wm <= 0 || nm <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int nstrips = (Wm + kStrip - 1) / kStrip;
  u64* pu = static_cast<u64*>(part_u);
  const bool fast = protos_bf16 && nm == 32 && vec;
  cudaError_t err;
  if (fast)
    err = launch_strips<__nv_bfloat16, SOFT, true>(
        protos, coefs, boxes, valid, B, D, Hm, Wm, nm, bf16_logits, vec, blocks_per_frame,
        nstrips, col_any, bottom, col_p, bottom_sub, pu, part_f, s);
  else if (protos_bf16)
    err = launch_strips<__nv_bfloat16, SOFT, false>(
        protos, coefs, boxes, valid, B, D, Hm, Wm, nm, bf16_logits, vec, blocks_per_frame,
        nstrips, col_any, bottom, col_p, bottom_sub, pu, part_f, s);
  else
    err = launch_strips<float, SOFT, false>(
        protos, coefs, boxes, valid, B, D, Hm, Wm, nm, bf16_logits, vec, blocks_per_frame,
        nstrips, col_any, bottom, col_p, bottom_sub, pu, part_f, s);
  if (err != cudaSuccess) return (int)err;
#ifdef TTI_MS_WITHOUT_MOMENTS
  return (int)cudaSuccess;
#endif
  const long long n = (long long)B * D;
  stats_moments<SOFT><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      boxes, valid, n, Hm, Wm, nstrips, pu, part_f, m);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernels' tiling, for the wrapper's scratch size and the chunk-boundary
// checks: columns of a strip, grid rows of a chunk (soft, binary).
extern "C" int tti_mask_stats_strip_cols() { return kStrip; }
extern "C" int tti_mask_stats_chunk_rows(int soft) {
  return soft ? Tuning<true>::kChunk : Tuning<false>::kChunk;
}

extern "C" int tti_mask_stats_soft(const void* protos, int protos_bf16, const float* coefs,
                                   const float* boxes, const uint8_t* valid, int B, int D,
                                   int Hm, int Wm, int nm, int bf16_logits, int vec,
                                   int blocks_per_frame, float* m, float* col_any,
                                   float* bottom, float* col_p, float* bottom_sub,
                                   void* part_u, float* part_f, void* stream) {
  return launch<true>(protos, protos_bf16, coefs, boxes, valid, B, D, Hm, Wm, nm, bf16_logits,
                      vec, blocks_per_frame, m, col_any, bottom, col_p, bottom_sub, part_u,
                      part_f, stream);
}

extern "C" int tti_mask_stats_binary(const void* protos, int protos_bf16, const float* coefs,
                                     const float* boxes, const uint8_t* valid, int B, int D,
                                     int Hm, int Wm, int nm, int bf16_logits, int vec,
                                     int blocks_per_frame, float* m, float* col_any,
                                     float* bottom, void* part_u, void* stream) {
  return launch<false>(protos, protos_bf16, coefs, boxes, valid, B, D, Hm, Wm, nm, bf16_logits,
                       vec, blocks_per_frame, m, col_any, bottom, nullptr, nullptr, part_u,
                       nullptr, stream);
}
