// Kernel D: the greedy NMS keep-set of score-sorted candidates, on the card.
//
// Replaces the reference's device while_loop (tti/postprocess/nms.py,
// _greedy_suppress): keep_i = ok_i && no j < i with keep_j && overlaps(i, j),
// the unique fixed point of the reference's sweep. The port used to sweep on
// the host's schedule and read the device after every block of sweeps; this
// kernel does the whole suppression in one launch and reads nothing back.
//
// Design: a cluster of C blocks per frame (C from the wrapper, a function of
// B and K: 1 when the frames alone fill the card, up to 8 when B is small),
// 512 threads each.
//   stage   every block of the cluster copies the frame's boxes (16-byte
//           loads), their areas and classes to its shared memory; the
//           leader (rank 0) also the validity, read 4 candidates per 32-bit
//           load and packed into words of 32 by four ballots.
//   pass 1  the overlap bitmask, row i word w: bit l says candidate
//           j = 32 w + l (j < i) outranks i and overlaps it. The triangle is
//           cut into 32 x 32 tiles (row block r, word w <= r), dealt to the
//           cluster's warps in turn: lane l holds box i = 32 r + l in
//           registers and builds its row's word against the 32 boxes j,
//           read as shared-memory broadcasts; no warp-wide operation in the
//           loop, so the unrolled pairs overlap. The rows go to the leader's
//           shared memory through distributed shared memory
//           (map_shared_rank) when they fit (K up to about 1250), else to a
//           scratch buffer the wrapper allocates; then cluster.sync(). Row
//           stride is odd in words, so the 32 rows a warp touches fall in 32
//           banks.
//   pass 2  one warp of the leader decides 32 ranks per step. For word w,
//           lane l is candidate i = 32 w + l: it ORs row_i[v] & kept[v] over
//           the earlier words v < w (final; all but the last one loaded and
//           combined during word w - 1, off the chain), and one ballot gives
//           the word's candidates blocked from outside it. Inside the word,
//           candidate l can only be blocked by a kept j in [32 w, i): a
//           second ballot finds the lanes whose in-word row meets the word's
//           candidates at all, and a bit loop over just those (at most 32,
//           each a shuffle of that lane's row and an AND with the keep word,
//           in rank order) clears the blocked ones. K / 32 dependent steps
//           (8 at K = 256) against K in the first design, which voted once
//           per rank.
//
// Not done: starting pass 2's word w as soon as rows 32 w .. 32 w + 31 are
// written (a flag per 32-row group). Across a cluster every group would need
// a remote arrival with cluster-scope release from every block, and pass 2
// at K = 256 is a few hundred cycles, less than the barrier it would hide.
//
// What bounds it: neither bytes nor operations. The inputs are 22 bytes per
// candidate (0.7 MB at batch 128, K = 256) and pass 1 is K^2 / 2 IoUs,
// spread over the card's SMs at any B by the cluster; the floor is the
// launch itself (a cluster launch's fixed cost) and pass 2's chain of K / 32
// warp steps, each two ballots and a bit loop of integer operations.
//
// Numerics: overlaps(i, j) gives the boolean the plain version computes
// (tti_torch/kernels/nms.py, box_iou_matrix and suppression_matrix): the
// same operation order for area, lt, rb, wh, inter and union, max(union,
// 1e-9f), the IEEE quotient, then (same_class ? iou : 0) > threshold. The
// arithmetic is written with the _rn intrinsics, which nvcc never contracts
// into an FMA (a + b - x * y would otherwise become one rounding short), and
// max/min propagate NaN (PTX max.NaN / min.NaN) as torch.maximum/minimum/
// clamp do; the sign of a zero they return may differ, which no comparison
// below can see. The quotient itself is not formed where that is exact: in
// a frame whose coordinates are all finite and within 2^60 ("tame": every
// area, intersection and union is then finite), RN(inter / u) > thr is
// decided as inter > mid * u in double, mid being the rounding boundary
// above thr (Threshold), a product that is exact; a frame with a NaN, an
// infinity or a huge coordinate takes the IEEE division, skipped only for
// another class (0 > thr) and for inter == 0 with thr >= 0 (0 / u is 0 or
// NaN). Pass 1's row loop is then free of branches in tame frames, so a
// warp's rows overlap.

#include <cooperative_groups.h>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // 227 KB, with the dynamic shared-memory opt-in
constexpr int kMaxK = 8192;       // the staged candidates fit in shared memory
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr uint32_t kFull = 0xffffffffu;

__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(nmax(__fsub_rn(b.z, b.x), 0.f), nmax(__fsub_rn(b.w, b.y), 0.f));
}

// The threshold as pass 1 tests it: iou > thr, where iou = RN(inter / u),
// holds for finite inter >= 0 and finite u > 0 exactly when inter > mid * u,
// or inter == mid * u and that tie rounds above thr; mid is the rounding
// boundary above thr (exact in double, and mid * u too: 25 + 24 bits).
// With mid in [2^-60, 8] most pairs are decided in float first:
// d = RN(inter - mid_f * u) (one FMA; mid_f = float(mid), within 2^-24 of
// it) is within 2^-24 (mid u + |d|) of inter - mid * u, so where |d| exceeds
// eps * u = 2^-22 mid_f u its sign is the exact answer's; only pairs inside
// that margin (an IoU within about 2.4e-7 of the threshold, relatively) take
// the double test.
struct Threshold {
  float thr;
  double mid;  // -inf for thr < 0 (every quotient is above), +inf for NaN or +inf
  int tie_up;
  bool zero_gt;  // 0 > thr: another class's pair
  bool fast;  // mid in [2^-60, 8]: the float test first
  float mid_f, eps;
};

// Frames whose coordinates are all finite and within 2^60 have finite
// areas, intersections and unions (at most 2^123): "tame", tested without
// the division.
constexpr float kTame = 1.152921504606846976e18f;  // 2^60

__device__ __forceinline__ bool above_exact(float inter, float u, const Threshold& t) {
  const double a = (double)inter, p = t.mid * (double)u;
  return a > p || (a == p && t.tie_up);
}

__device__ __forceinline__ bool above_tame(float inter, float u, const Threshold& t) {
  if (t.fast) {
    const float d = __fmaf_rn(-t.mid_f, u, inter);
    if (fabsf(d) > __fmul_rn(t.eps, u)) return d > 0.f;
  }
  return above_exact(inter, u, t);
}

__device__ __forceinline__ bool hit_tame(float4 bi, float ai, int32_t ci, float4 bj, float aj,
                                         int32_t cj, const Threshold& t, bool aware) {
  const float w = nmax(__fsub_rn(nmin(bi.z, bj.z), nmax(bi.x, bj.x)), 0.f);
  const float h = nmax(__fsub_rn(nmin(bi.w, bj.w), nmax(bi.y, bj.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float u = nmax(__fsub_rn(__fadd_rn(ai, aj), inter), 1e-9f);
  const bool above = above_tame(inter, u, t);
  return aware && ci != cj ? t.zero_gt : above;
}

// Any frame: the IEEE division, skipped where the answer is known (another
// class; inter == 0 with thr >= 0, where 0 / u is 0 or NaN).
__device__ __forceinline__ bool hit_any(float4 bi, float ai, int32_t ci, float4 bj, float aj,
                                        int32_t cj, const Threshold& t, bool aware) {
  if (aware && ci != cj) return t.zero_gt;
  const float w = nmax(__fsub_rn(nmin(bi.z, bj.z), nmax(bi.x, bj.x)), 0.f);
  const float h = nmax(__fsub_rn(nmin(bi.w, bj.w), nmax(bi.y, bj.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  if (inter == 0.f && t.thr >= 0.f) return false;
  const float uni = __fsub_rn(__fadd_rn(ai, aj), inter);
  return __fdiv_rn(inter, nmax(uni, 1e-9f)) > t.thr;
}

// One 32 x 32 tile of pass 1: lane l builds the word w of row i = 32 r + l
// (its box in registers) against boxes j = 32 w .. 32 w + cols - 1, read
// as shared-memory broadcasts. No warp-wide operation inside the loop, so
// the unrolled pairs' chains overlap. kWhole: a whole tile of a tame frame
// with the float test (Threshold::fast), unrolled with constant shifts and
// no branch; off the diagonal (w < r) every j < i.
template <bool kTamed, bool kWhole, bool kDiag>
__device__ __forceinline__ uint32_t tile_word(const float4* sbox, const float2* sac, int r,
                                              int w, int rows, int cols, int lane,
                                              const Threshold& t, bool aware) {
  const bool live = lane < rows;
  const int i = 32 * r + lane;
  const float4 bi = live ? sbox[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float2 aci = live ? sac[i] : make_float2(0.f, 0.f);
  const int32_t ci = __float_as_int(aci.y);
  const float4* bj = sbox + 32 * w;
  const float2* acj = sac + 32 * w;
  uint32_t word = 0;
  if constexpr (kWhole) {
    // The float test, without a branch: the pairs inside its margin are
    // collected in `close` and decided after the loop by the exact test.
    uint32_t close = 0;
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const float4 b = bj[jj];
      const float2 ac = acj[jj];
      const float w = nmax(__fsub_rn(nmin(bi.z, b.z), nmax(bi.x, b.x)), 0.f);
      const float h = nmax(__fsub_rn(nmin(bi.w, b.w), nmax(bi.y, b.y)), 0.f);
      const float inter = __fmul_rn(w, h);
      const float u = nmax(__fsub_rn(__fadd_rn(aci.x, ac.x), inter), 1e-9f);
      const float d = __fmaf_rn(-t.mid_f, u, inter), m = __fmul_rn(t.eps, u);
      const bool same = !aware || ci == __float_as_int(ac.y);
      const bool in = !kDiag || jj < lane;
      word |= (uint32_t)(in && (same ? d > m : t.zero_gt)) << jj;
      close |= (uint32_t)(in && same && fabsf(d) <= m) << jj;
    }
    while (close) {  // rare: an IoU within about 2.4e-7 of the threshold
      const int jj = __ffs(close) - 1;
      close &= close - 1;
      const float4 b = bj[jj];
      const float w = nmax(__fsub_rn(nmin(bi.z, b.z), nmax(bi.x, b.x)), 0.f);
      const float h = nmax(__fsub_rn(nmin(bi.w, b.w), nmax(bi.y, b.y)), 0.f);
      const float inter = __fmul_rn(w, h);
      const float u = nmax(__fsub_rn(__fadd_rn(aci.x, acj[jj].x), inter), 1e-9f);
      if (above_exact(inter, u, t)) word |= 1u << jj;
    }
  } else {
#pragma unroll 8
    for (int jj = 0; jj < cols; ++jj) {
      const int j = 32 * w + jj;
      bool hit;
      if constexpr (kTamed) {  // no branch
        hit = (j < i) & hit_tame(bi, aci.x, ci, bj[jj], acj[jj].x, __float_as_int(acj[jj].y),
                                 t, aware);
      } else {
        hit = j < i && hit_any(bi, aci.x, ci, bj[jj], acj[jj].x, __float_as_int(acj[jj].y), t,
                               aware);
      }
      word |= (uint32_t)hit << jj;
    }
  }
  return live ? word : 0u;
}

// Pass 2 (one warp): word w's 32 ranks per step. `pre` holds, for word w's
// lanes, the OR of row_i[v] & kept[v] over v < w - 1, loaded and combined
// during word w - 1 (off the chain); the chain is the last word's AND, two
// ballots and the bit loop.
__device__ __forceinline__ void decide(const uint32_t* rows, const uint32_t* okw,
                                       uint32_t* keptw, int k, int nw, int rs, int lane) {
  uint32_t prev = 0, pre = 0;  // kept word w - 1; see above
  for (int w = 0; w < nw; ++w) {
    const int i = 32 * w + lane;
    const uint32_t* row = rows + (size_t)i * rs;
    const uint32_t valid = okw[w];
    const uint32_t inword = i < k ? row[w] : 0u;  // bits j in [32 w, i)
    const uint32_t last = i < k && w > 0 ? row[w - 1] : 0u;
    const uint32_t cand = valid & ~__ballot_sync(kFull, (pre | (last & prev)) != 0u);
    uint32_t todo = __ballot_sync(kFull, (inword & cand) != 0u) & cand;
    // Word w + 1's lanes against the words final now (v < w).
    uint32_t next = 0;
    if (i + 32 < k) {
      const uint32_t* row2 = row + (size_t)32 * rs;
      if (w > 0) next = row2[w - 1] & prev;
#pragma unroll 4
      for (int v = 0; v < w - 1; ++v) next |= row2[v] & keptw[v];
    }
    uint32_t kept = cand;
    while (todo) {  // warp-uniform: ranks in order, each row's earlier bits final
      const int l = __ffs(todo) - 1;
      todo &= todo - 1;
      if (__shfl_sync(kFull, inword, l) & kept) kept &= ~(1u << l);
    }
    if (lane == 0) keptw[w] = kept;
    prev = kept;
    pre = next;
    __syncwarp();
  }
}

// Bits 0..7 of x to bits 0, 4, ..., 28.
__device__ __forceinline__ uint32_t spread8(uint32_t x) {
  x &= 0xffu;
  x = (x | (x << 12)) & 0x000f000fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// Shared memory: per candidate its box (16 B) and its area and class (8 B,
// one load); the validity and the kept words; then the rows, odd stride,
// when they fit.
__host__ __device__ __forceinline__ int words_per_row(int k) { return (k + 31) / 32; }
__host__ __device__ __forceinline__ int row_stride(int k) { return words_per_row(k) | 1; }
__host__ __device__ __forceinline__ long long stage_bytes(int k) {
  return 24LL * k + 8LL * words_per_row(k);
}
__host__ __device__ __forceinline__ bool mask_in_smem(int k) {
  return stage_bytes(k) + 4LL * k * row_stride(k) <= kMaxSmem;
}
long long smem_bytes(int k) {
  return stage_bytes(k) + (mask_in_smem(k) ? 4LL * k * row_stride(k) : 0);
}

__global__ void __launch_bounds__(kThreads)
greedy_keep_kernel(const float* __restrict__ boxes, const int32_t* __restrict__ classes,
                   const uint8_t* __restrict__ ok, uint8_t* __restrict__ keep,
                   uint32_t* __restrict__ scratch, int k, Threshold t, int class_aware, int cl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = words_per_row(k), rs = row_stride(k);
  float4* sbox = reinterpret_cast<float4*>(smem);
  float2* sac = reinterpret_cast<float2*>(sbox + k);  // area, class (its bits)
  uint32_t* okw = reinterpret_cast<uint32_t*>(sac + k);
  uint32_t* keptw = okw + nw;
  const int frame = blockIdx.x / cl, rank = blockIdx.x % cl;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Validity (the leader): lane l reads candidates c0 + 4 l .. + 3 as one
  // word, issued before the boxes' loads so that the two overlap.
  const uint8_t* okp = ok + (size_t)frame * k;
  const bool okvec = (reinterpret_cast<uintptr_t>(okp) & 3u) == 0;
  auto ok_word = [&](int c0) {
    const int j = c0 + 4 * lane;
    if (okvec && j + 3 < k) return *reinterpret_cast<const uint32_t*>(okp + j);
    uint32_t v = 0;
    for (int s = 0; s < 4; ++s) v |= (j + s < k ? (uint32_t)okp[j + s] : 0u) << (8 * s);
    return v;
  };
  const uint32_t v0 = rank == 0 && 128 * warp < k ? ok_word(128 * warp) : 0u;

  // Stage: boxes as float4 where the tensor is 16-byte aligned (every
  // frame's boxes are then, 16 K bytes apart).
  const float* bx = boxes + (size_t)frame * k * 4;
  const bool vec = (reinterpret_cast<uintptr_t>(boxes) & 15u) == 0;
  const int32_t* cx = classes + (size_t)frame * k;
  bool wild = false;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const float4 b = vec ? reinterpret_cast<const float4*>(bx)[i]
                         : make_float4(bx[4 * i], bx[4 * i + 1], bx[4 * i + 2], bx[4 * i + 3]);
    sbox[i] = b;
    sac[i] = make_float2(box_area(b), __int_as_float(cx[i]));
    wild |= !(fabsf(b.x) <= kTame && fabsf(b.y) <= kTame && fabsf(b.z) <= kTame &&
              fabsf(b.w) <= kTame);
  }
  if (rank == 0) {
    // Ballot s gathers byte s of every lane, and word q of the 128
    // candidates takes bit 4 m + s from lane 8 q + m of ballot s.
    for (int c0 = 128 * warp; c0 < k; c0 += 128 * kWarps) {
      const uint32_t v = c0 == 128 * warp ? v0 : ok_word(c0);
      uint32_t by[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) by[s] = __ballot_sync(kFull, (v >> (8 * s)) & 0xffu);
      if (lane < 4 && c0 / 32 + lane < nw) {
        uint32_t word = 0;
#pragma unroll
        for (int s = 0; s < 4; ++s) word |= spread8(by[s] >> (8 * lane)) << s;
        okw[c0 / 32 + lane] = word;
      }
    }
  }
  // Every block stages every box, so the blocks of a cluster agree.
  const bool tame = !__syncthreads_or(wild);
  cg::cluster_group cluster = cg::this_cluster();
  // Every block of the cluster has started before any writes into the
  // leader's shared memory.
  if (cl > 1) cluster.sync();

  // The rows: the leader's shared memory (this block's own, or the
  // leader's through distributed shared memory) or the frame's scratch.
  uint32_t* lrows = reinterpret_cast<uint32_t*>(keptw + nw);
  uint32_t* grows = scratch + (size_t)frame * k * rs;
  uint32_t* dst = !mask_in_smem(k) ? grows : rank != 0 ? cluster.map_shared_rank(lrows, 0)
                                                       : lrows;

  // Pass 1: tile t = r (r + 1) / 2 + w, w <= r, to warp t of the cluster.
  const bool aware = class_aware != 0;
  const int tiles = nw * (nw + 1) / 2;
  for (int tile = rank * kWarps + warp; tile < tiles; tile += cl * kWarps) {
    int r = (int)((sqrtf(8.f * tile + 1.f) - 1.f) * 0.5f);
    while (r * (r + 1) / 2 > tile) --r;
    while ((r + 1) * (r + 2) / 2 <= tile) ++r;
    const int w = tile - r * (r + 1) / 2;
    const int rows = min(32, k - 32 * r), cols = min(32, k - 32 * w);
    uint32_t word;
    if (!tame) {
      word = tile_word<false, false, false>(sbox, sac, r, w, rows, cols, lane, t, aware);
    } else if (rows < 32 || cols < 32 || !t.fast) {
      word = tile_word<true, false, false>(sbox, sac, r, w, rows, cols, lane, t, aware);
    } else if (w == r) {
      word = tile_word<true, true, true>(sbox, sac, r, w, rows, cols, lane, t, aware);
    } else {
      word = tile_word<true, true, false>(sbox, sac, r, w, rows, cols, lane, t, aware);
    }
    if (lane < rows) dst[(size_t)(32 * r + lane) * rs + w] = word;
  }
  if (cl > 1) cluster.sync(); else __syncthreads();
  if (rank != 0) return;

  // Pass 2: one warp of the leader, the rows read through a pointer of
  // their own memory space.
  if (warp == 0) {
    if (mask_in_smem(k)) decide(lrows, okw, keptw, k, nw, rs, lane);
    else decide(grows, okw, keptw, k, nw, rs, lane);
  }
  __syncthreads();

  uint8_t* out = keep + (size_t)frame * k;
  for (int i = threadIdx.x; i < k; i += kThreads) out[i] = (keptw[i >> 5] >> (i & 31)) & 1u;
}

__global__ void empty_kernel(int) {}

// Both kernels opted in to smem bytes of dynamic shared memory on the
// current device (once per device and size).
int opt_in(long long smem) {
  static long long opted[64] = {};  // per device: the largest size opted in so far
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && smem <= opted[dev]) return 0;
  err = cudaFuncSetAttribute(greedy_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) opted[dev] = smem;
  return 0;
}

// A launch of `kernel` on b * cl blocks in clusters of cl, with smem bytes.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int b, int cl, long long smem, cudaStream_t stream, Args... args) {
  int err = opt_in(smem);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(b * cl));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

Threshold threshold(float thr) {
  Threshold t{thr, 0.0, 0, 0.f > thr, false, 0.f, 0.f};
  uint32_t bits;
  std::memcpy(&bits, &thr, 4);
  bits &= 0x7fffffffu;  // -0 as +0
  if (thr != thr || bits >= 0x7f800000u) {
    t.mid = HUGE_VAL;  // NaN or +inf: no quotient is above it
  } else if (thr < 0.f) {
    t.mid = -HUGE_VAL;  // every quotient (>= 0) is above it
  } else {
    float next;  // the float after thr (2^128 after the largest)
    const uint32_t up = bits + 1;
    std::memcpy(&next, &up, 4);
    const double hi = up == 0x7f800000u ? 0x1p128 : (double)next;
    t.mid = ((double)thr + hi) * 0.5;  // 25 bits: exact
    t.tie_up = bits & 1u;  // a tie rounds to the even neighbour: next when thr is odd
    t.fast = t.mid >= 0x1p-60 && t.mid <= 8.0;
    t.mid_f = (float)t.mid;
    t.eps = t.mid_f * 0x1p-22f;
  }
  return t;
}

bool bad_shape(int b, int k, int cl) {
  return k < 1 || k > kMaxK || b < 1 || cl < 1 || cl > kMaxCluster || (cl & (cl - 1)) != 0 ||
         (long long)b * cl > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// The largest K one launch takes.
int tti_greedy_keep_max_k() { return kMaxK; }

// 32-bit words of scratch the launch needs per frame: 0 when the rows fit in
// shared memory.
int tti_greedy_keep_scratch_words(int k) {
  return mask_in_smem(k) ? 0 : k * row_stride(k);
}

// boxes (B, K, 4) f32 xyxy, classes (B, K) int32, ok (B, K) bool (one byte
// each), keep (B, K) bool out; scratch as tti_greedy_keep_scratch_words(K)
// times B words, or null when that is 0; cluster: blocks per frame, a power
// of two up to 8. Returns the launch's cudaError
// (cudaErrorInvalidValue for a shape or cluster outside those ranges).
int tti_greedy_keep(const void* boxes, const void* classes, const void* ok, void* keep,
                    void* scratch, int b, int k, float iou_thresh, int class_aware, int cluster,
                    void* stream) {
  if (bad_shape(b, k, cluster)) return (int)cudaErrorInvalidValue;
  return launch(greedy_keep_kernel, b, cluster, smem_bytes(k), (cudaStream_t)stream,
                (const float*)boxes, (const int32_t*)classes, (const uint8_t*)ok,
                (uint8_t*)keep, (uint32_t*)scratch, k, threshold(iou_thresh), class_aware,
                cluster);
}

// An empty kernel on the same grid, clusters, block and shared memory as
// tti_greedy_keep(B, K, cluster): the launch's fixed cost.
int tti_greedy_keep_empty(int b, int k, int cluster, void* stream) {
  if (bad_shape(b, k, cluster)) return (int)cudaErrorInvalidValue;
  return launch(empty_kernel, b, cluster, smem_bytes(k), (cudaStream_t)stream, 0);
}

}  // extern "C"
