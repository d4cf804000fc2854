// Kernel D: the greedy NMS keep-set of score-sorted candidates, on the card.
//
// Replaces the reference's device while_loop (tti/postprocess/nms.py,
// _greedy_suppress): keep_i = ok_i && no j < i with keep_j && overlaps(i, j),
// the unique fixed point of the reference's sweep. The port used to sweep on
// the host's schedule and read the device after every block of sweeps; this
// kernel does the whole suppression in one launch and reads nothing back.
//
// Design, one block per frame:
//   stage   the frame's boxes (with their areas), classes and validity go to
//           shared memory once, validity as 32-bit words (one ballot each).
//   pass 1  the overlap bitmask, row i word w: bit l says candidate
//           j = 32 w + l (j < i) outranks i and overlaps it. The rows go to
//           the 16 warps in turn; lane l computes overlaps(i, j) from shared
//           memory and __ballot_sync packs the 32 answers. Only words
//           holding some j < i are written (pass 2 reads no other). The
//           rows live in shared memory when they fit (K up to about 1250;
//           8 KB per frame at the default K = 256), else in a scratch buffer
//           the wrapper allocates.
//   pass 2  one warp walks the rows in rank order. Lane l keeps words l,
//           l + 32, ... of the keep bitmask and of the validity in
//           registers; per row it ANDs its words of the row (read one row
//           ahead) with them, one __any_sync decides candidate i, and the
//           lane that owns i's word sets its bit.
//
// What bounds it: neither bytes nor operations. The inputs are 22 bytes per
// candidate (0.7 MB at batch 128, K = 256) and pass 1 is K^2 / 2 IoUs; the
// floor is pass 2's K dependent row checks (a shared-memory load, an AND, a
// warp vote and a predicated OR each), in parallel over the frames.
//
// Numerics: overlaps(i, j) is bit for bit what the plain version computes
// (tti_torch/kernels/nms.py, box_iou_matrix and suppression_matrix): the
// same operation order for area, lt, rb, wh, inter and union, max(union,
// 1e-9f), an IEEE division, then (same_class ? iou : 0) > threshold. The
// arithmetic is written with the _rn intrinsics, which nvcc never contracts
// into an FMA (a + b - x * y would otherwise become one rounding short),
// and max/min propagate NaN as torch.maximum/minimum/clamp do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB, with the dynamic shared-memory opt-in
constexpr int kMaxK = 8192;       // the staged candidates fit in shared memory

__device__ __forceinline__ float tmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float tmin(float a, float b) { return (a < b || a != a) ? a : b; }

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(tmax(__fsub_rn(b.z, b.x), 0.f), tmax(__fsub_rn(b.w, b.y), 0.f));
}

__device__ __forceinline__ bool overlaps(float4 bi, float ai, float4 bj, float aj, bool same,
                                         float thr) {
  const float w = tmax(__fsub_rn(tmin(bi.z, bj.z), tmax(bi.x, bj.x)), 0.f);
  const float h = tmax(__fsub_rn(tmin(bi.w, bj.w), tmax(bi.y, bj.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(ai, aj), inter);
  const float iou = __fdiv_rn(inter, tmax(uni, 1e-9f));
  return (same ? iou : 0.f) > thr;
}

// Shared memory: boxes (16 B), areas, classes (4 B each) per candidate; the
// validity and the result as words; then the rows when they fit.
__host__ __device__ __forceinline__ int words_per_row(int k) { return (k + 31) / 32; }
__host__ __device__ __forceinline__ long long stage_bytes(int k) {
  return 24LL * k + 8LL * words_per_row(k);
}
__host__ __device__ __forceinline__ bool mask_in_smem(int k) {
  return stage_bytes(k) + 4LL * k * words_per_row(k) <= kMaxSmem;
}

template <int M>  // keep words per lane in pass 2: K <= 1024 * M
__global__ void __launch_bounds__(kThreads)
greedy_keep_kernel(const float* __restrict__ boxes, const int32_t* __restrict__ classes,
                   const uint8_t* __restrict__ ok, uint8_t* __restrict__ keep,
                   uint32_t* __restrict__ scratch, int k, float thr, int class_aware) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = words_per_row(k);
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + k);
  int32_t* scls = reinterpret_cast<int32_t*>(sarea + k);
  uint32_t* okw = reinterpret_cast<uint32_t*>(scls + k);
  uint32_t* keptw = okw + nw;
  const int frame = blockIdx.x;
  uint32_t* mask = mask_in_smem(k) ? keptw + nw : scratch + (size_t)frame * k * nw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;

  const float* bx = boxes + (size_t)frame * k * 4;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float4 b = make_float4(bx[4 * i], bx[4 * i + 1], bx[4 * i + 2], bx[4 * i + 3]);
    sbox[i] = b;
    sarea[i] = box_area(b);
    scls[i] = classes[(size_t)frame * k + i];
  }
  for (int w = warp; w < nw; w += warps) {
    const int j = 32 * w + lane;
    const uint32_t word = __ballot_sync(0xffffffffu, j < k && ok[(size_t)frame * k + j]);
    if (lane == 0) okw[w] = word;
  }
  __syncthreads();

  // Pass 1: rows in turn over the warps (row 0 has no j < i); the words of
  // row i that hold some j < i.
  for (int i = warp + 1; i < k; i += warps) {
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    const int32_t ci = scls[i];
    uint32_t* row = mask + (size_t)i * nw;
    for (int w = 0; 32 * w < i; ++w) {
      const int j = 32 * w + lane;
      const bool hit = j < i && overlaps(bi, ai, sbox[j], sarea[j],
                                         !class_aware || ci == scls[j], thr);
      const uint32_t word = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) row[w] = word;
    }
  }
  __syncthreads();

  // Pass 2: one warp, rows in rank order; lane l owns words l + 32 m of the
  // keep and validity bitmasks, and row i + 1 is read while row i is
  // decided (the reads do not depend on the decisions).
  if (warp == 0) {
    uint32_t kept[M], valid[M], cur[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int w = lane + 32 * m;
      kept[m] = 0u;
      valid[m] = w < nw ? okw[w] : 0u;
      cur[m] = 0u;  // row 0 holds no j < 0
    }
    for (int i = 0; i < k; ++i) {
      uint32_t next[M];
      const uint32_t* row = mask + (size_t)(i + 1) * nw;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int w = lane + 32 * m;
        next[m] = i + 1 < k && 32 * w < i + 1 ? row[w] : 0u;
      }
      bool blocked = false;
#pragma unroll
      for (int m = 0; m < M; ++m) blocked |= (cur[m] & kept[m]) != 0u;
      blocked = __any_sync(0xffffffffu, blocked);
      const uint32_t bit = blocked ? 0u : 1u << (i & 31);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (lane + 32 * m == (i >> 5)) kept[m] |= bit & valid[m];
        cur[m] = next[m];
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int w = lane + 32 * m;
      if (w < nw) keptw[w] = kept[m];
    }
  }
  __syncthreads();

  uint8_t* out = keep + (size_t)frame * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) out[i] = (keptw[i >> 5] >> (i & 31)) & 1u;
}

template <int M>
int launch(const void* boxes, const void* classes, const void* ok, void* keep, void* scratch,
           int b, int k, float thr, int class_aware, cudaStream_t stream) {
  const long long smem = stage_bytes(k) + (mask_in_smem(k) ? 4LL * k * words_per_row(k) : 0);
  cudaError_t err = cudaFuncSetAttribute(greedy_keep_kernel<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  greedy_keep_kernel<M><<<b, kThreads, (size_t)smem, stream>>>(
      (const float*)boxes, (const int32_t*)classes, (const uint8_t*)ok, (uint8_t*)keep,
      (uint32_t*)scratch, k, thr, class_aware);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest K one launch takes.
int tti_greedy_keep_max_k() { return kMaxK; }

// 32-bit words of scratch the launch needs per frame: 0 when the rows fit in
// shared memory.
int tti_greedy_keep_scratch_words(int k) {
  return mask_in_smem(k) ? 0 : k * words_per_row(k);
}

// boxes (B, K, 4) f32 xyxy, classes (B, K) int32, ok (B, K) bool (one byte
// each), keep (B, K) bool out; scratch as tti_greedy_keep_scratch_words(K)
// times B words, or null when that is 0. Returns the launch's cudaError
// (cudaErrorInvalidValue for K outside 1..tti_greedy_keep_max_k()).
int tti_greedy_keep(const void* boxes, const void* classes, const void* ok, void* keep,
                    void* scratch, int b, int k, float iou_thresh, int class_aware,
                    void* stream) {
  if (k < 1 || k > kMaxK || b < 1) return (int)cudaErrorInvalidValue;
  const int m = (words_per_row(k) + 31) / 32;  // 1..8 at kMaxK
  const cudaStream_t s = (cudaStream_t)stream;
  if (m <= 1) return launch<1>(boxes, classes, ok, keep, scratch, b, k, iou_thresh, class_aware, s);
  if (m <= 2) return launch<2>(boxes, classes, ok, keep, scratch, b, k, iou_thresh, class_aware, s);
  if (m <= 4) return launch<4>(boxes, classes, ok, keep, scratch, b, k, iou_thresh, class_aware, s);
  return launch<8>(boxes, classes, ok, keep, scratch, b, k, iou_thresh, class_aware, s);
}

}  // extern "C"
