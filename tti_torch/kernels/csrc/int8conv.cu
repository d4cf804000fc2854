// Kernels E and F: the int8 (W8A8) convolution of the YOLOv8 Conv block and
// its per-sample activation scale, for Hopper (sm_90a).
//
// Kernel E replaces no pallas_call: tti's Conv(qmode="int8"|"int8s")
// (tti/model/layers.py:83-116) quantizes its input, convolves int8 x int8 ->
// int32 with XLA's conv_general_dilated and dequantizes. PyTorch has no int8
// convolution on CUDA, so E does all of it in one launch:
//   A = the NHWC input, quantized as it is loaded: clamp(rint(x / s), -127,
//       127), s = the sample's scale (kernel F, TTI_QUANT=int8) or the
//       block's calibrated scale (TTI_QUANT=int8s);
//   B = the int8 weights, (co, Kp) with K = (kh, kw, ci) ordered as the
//       flax kernel and zero-padded to Kp, a multiple of 32, at load;
//   an implicit GEMM, M = B * Ho * Wo output pixels, N = co, K = kh*kw*ci,
//       int32 accumulation on the tensor cores;
//   y = float(acc) * (xscale[b] * wscale[c]) + bias[c] in float32, rounded
//       to the output dtype, then SiLU, written channels_last.
// Kernel F is tti's quantize_act_per_sample scale (tti/model/layers.py:26-38):
// per sample, max |x| over (H, W, C), then max(absmax, 1e-12) / 127.
//
// Numerics, bit for bit those of the plain version (tti_torch/kernels/
// int8conv.py): the quotient x / s is an IEEE division (__fdiv_rn; nvcc
// without --use_fast_math), rounding is half to even (as jnp.round and
// np.rint; done by a float add, see quantize()); the integer product is
// exact; int32 -> float32 rounds to nearest (|acc| reaches 2304 * 127^2 >
// 2^24, so it can round: the plain version convolves in float64 and converts
// the same way); (xscale * wscale) is formed first, as tti forms it, and the
// epilogue is written with __fmul_rn / __fadd_rn, which nvcc never contracts
// into an FMA (one rounding where the reference has two). SiLU is tti's
// formula, x * sigmoid(x), in float32 on the rounded output: an IEEE
// reciprocal of 1 + expf(-x), then a product (the plain version's
// silu_plain; PyTorch's F.silu divides instead, which rounds otherwise in
// about one value in four and flips the next block's codes); expf is the
// CUDA math library's, which PyTorch's sigmoid also calls, so the two agree
// unless the toolkits' expf differ (chip_smoke.py prints the largest
// difference in ulps and holds it to 1). Zero padding, the
// s2d stem's pre-pad and the K padding are zeros, which quantize to 0, as in
// tti. F's max is order-independent: bit-equal.
//
// Strided inputs: both kernels take the input's four strides (elements), so
// a C2f bottleneck's channel slice of cv1's output is read in place, never
// copied. F's absmax covers the slice only.
//
// What bounds E on this card. Bytes first: the layers are narrow (co 16-256,
// K 48-2304) and wide in M, far below the card's ~600 int8 operations per
// byte (the stem: 1536 integer operations per output pixel against 4.2 MB
// read and 5.6 MB written per frame). Then float work, about as much as the
// bytes at deploy batch 128: every input element is an IEEE division, a
// clamp and a rounding (5.2e9 of them per step), every output element a
// dequantize, a bf16 rounding, expf, an IEEE reciprocal, a product and a
// rounding (4.3e9), with a MUFU op each for expf and the reciprocal and
// quarter-rate conversions (int32 -> float32, float32 -> bf16). E comes
// near its bound only if the loads, the quantization, the product and the
// epilogue overlap and the float work keeps the SMs' issue slots busy. The
// design, part by part:
//
// - Persistent, warp-specialised blocks: a producer warpgroup and NC = 1 to
//   3 consumer warpgroups (the planner's choice: the most that keep the
//   widest tile and channel group). The wrapper's planner (int8conv.py, plan_conv)
//   cuts the output into tiles of tm rows x 64 columns (fewer where a
//   float32 window would not fit) of one sample and one group of bn output
//   channels; the grid is as many blocks as are resident at once
//   (multiProcessorCount x occupancy, read here), and each block walks the
//   tiles blockIdx.x, + gridDim.x, ..., crossing samples (the tile's sample
//   picks its scale). The producer keeps up to `stages` input windows
//   loading into a ring in shared memory (mbarriers full / empty per stage);
//   consumer c takes every NC-th tile and owns the stages c mod NC (the depth
//   is a multiple of NC, see consume()). While one consumer quantizes a
//   window, the others run their products, epilogues and stores, so loads,
//   float work and tensor-core work of different tiles overlap.
// - Asynchronous copies. TMA (cp.async.bulk.tensor.4d over (C, W, H, B),
//   box (cbox, wc, wr, 1), tensor map encoded per call on the host through
//   cudaGetDriverEntryPoint, passed as a __grid_constant__ parameter) loads a
//   window wherever a tensor map can describe the input: channels contiguous
//   and a multiple of 16, a 16-byte-aligned base and byte strides that are
//   multiples of 16, C2f channel slices included. Its out-of-bounds zero
//   fill is the convolution's zero padding (codes 0, as in tti). Layouts TMA
//   refuses (the s2d stem's 24-byte pixels, the plain stem, other strides)
//   take the ring route of the same kernel: the producer's 128 threads issue
//   cp.async copies of 16, 8 or 4 bytes (zero-filled outside the frame;
//   plain loads for one bf16 element) and arrive on the stage's mbarrier
//   through cp.async.mbarrier.arrive.noinc. Both routes give the stem a
//   window, so each element is quantized once per tile and not once per
//   tap; its 12 (or 3) channels are padded to 16 zero codes and its packed
//   weights are scattered into the same per-tap layout as they are loaded.
// - Quantize once per element per tile: a tile of tm x 64 outputs re-reads a
//   halo of ((tm-1)s+k)/(tm s) rows, 1.1-2x of the input for the large
//   layers (the first design's 8 x 16 tiles: about 2.3x for a 3x3). A block that keeps
//   one group of co (the P4/P5 3x3 blocks of 128-256 channels) quantizes its
//   windows once per group.
// - Float work without per-element branches: the IEEE division and
//   reciprocal have branch-free fast forms whose rare possible misroundings are detected and
//   redone exactly (quantize_fast, silu_fast); SiLU runs in the store loop,
//   8 values per thread at a time, and its on/off switch is never tested
//   inside an unrolled loop.
// - The product: wgmma.mma_async m64nNk32 s32.s8.s8 with both operands in
//   shared memory (SS), N = bn (n16, n32, n64; two n64 for bn 128). The
//   codes of a window are stored as 16-channel planes, pixel-major, 16 bytes
//   per pixel, so one output row of 64 pixels is one m64 tile whose A
//   operand, for tap (dy, dx) and planes (j, j+1), is a descriptor at
//   window pixel (oy + dy, dx): core-matrix rows 16 bytes apart, the next
//   8 rows 128 bytes on (SBO), the next 16 channels one plane on (LBO). With
//   stride s the window's columns are split by their remainder mod s as they
//   are quantized, so each tap's 64 rows are contiguous again. SS and not RS
//   (A from registers): RS would need each thread to gather its A fragments
//   from the window for every tap, the very per-tap work the codes window
//   exists to avoid, and would tie the consumer's registers up during the
//   product; SS issues a tap's product as one instruction per N group and
//   leaves the warps free. The accumulators stay in registers; the next
//   row's product is issued as soon as a row is staged, and runs under its
//   stores.
// - Weights resident in shared memory for the whole persistent block: the
//   planner picks the widest group of output channels whose weights fit
//   beside a window, and a block keeps one group. They are never re-read
//   from L2 per K step. Layout: per 16-byte K chunk (tap, plane), bn rows of
//   16 bytes (core matrices of 128 contiguous bytes); a tap with an odd
//   number of planes gets a zero chunk, so every k32 step lies in one tap.
// - Epilogue through shared memory: the arithmetic and its order as the first design's
//   (dequant, bf16 rounding, SiLU), each output row staged in shared memory
//   (rows padded by 16 bytes: bank-free fragment stores) and written with
//   16-byte coalesced stores, one row's co channels contiguous.
//
// F: a grid of (S, B) blocks, each a max over 1/S of one sample, with
// 16-byte loads where possible; the last block of a sample to finish (an
// atomic ticket after a fence) combines the S partial maxima and writes the
// scale. The tickets are zeroed on the stream before the launch. One launch,
// no host synchronisation.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

constexpr int kFThreads = 256;  // F

// Storage types: bf16 travels as its 16-bit pattern.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

template <typename S, int V>
struct alignas(sizeof(S) * V) Vec {
  S v[V];
};

template <typename S, int V>
__device__ __forceinline__ Vec<S, V> load_vec(const S* p) {
  return *reinterpret_cast<const Vec<S, V>*>(p);
}

// The code of x / s as the low byte of a 32-bit word: IEEE quotient, clamp
// to +-127 (clamping before rounding is the same: 127.5 and above round to
// 128, then clamp to 127), then round half to even by adding 1.5 * 2^23,
// whose float32 ulp is 1: the sum's bits are 0x4B400000 + q, so its low
// byte is q in two's complement. All full-rate float operations.
__device__ __forceinline__ uint32_t quantize(float x, float s) {
  const float t = fminf(fmaxf(__fdiv_rn(x, s), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(t, 12582912.0f));
}

// Four codes' low bytes packed into one word, element 0 in the low byte.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// SiLU as tti computes it: y times the IEEE reciprocal of 1 + expf(-y).
__device__ __forceinline__ float silu(float y) {
  return __fmul_rn(y, __frcp_rn(__fadd_rn(1.0f, expf(-y))));
}

// Branch-free forms of the quantizer's IEEE division and SiLU's IEEE
// reciprocal, each with a test of whether its rounding could differ from
// the exact one's. A caller computes a batch
// of values this way (16 codes, or 8 bf16 outputs), collecting the tests in
// a bit mask, and redoes the flagged values with quantize() / silu(), so the
// results are the exact ones bit for bit. A branch per value in the hot loop
// would cut it into one block per value and serialise their dependent chains
// (the IEEE division and reciprocal have slow-path branches of their own),
// and redoing a whole batch would cost a warp the exact path whenever any of
// its threads asks. The tests fire for about 1 value in 10^4 to 10^3 (bf16
// inputs take few distinct values; a few of them sit near a rounding
// boundary). The quotient is refined once: q0 = n * r (r = 1/d within 1
// ulp), e = n - d * q0 exactly (an FMA), q1 = q0 + e * r, which lies within
// 0.5 ulp (plus 2^-23 of e) of n / d, so within 1 ulp of the IEEE quotient,
// as long as e is exact: the ranges below keep every value of it, and any
// value that matters, well inside the normal range; the reciprocal the same
// way with n = 1. tests/test_torch_int8_plan.py holds a numpy model of both
// forms to that on 10^7 values.
// - quantize_fast: only the nearest integer of the clamped quotient is kept,
//   so the codes agree unless q1 is within 1 ulp (< 2^-16 for |q| <= 127) of
//   a half-integer; the test fires within 2^-15. |q0| >= 1024, an infinity
//   or a NaN keeps q0: the clamp then gives +-127 (a NaN -127) either way.
//   For scales within [2^-60, 2^60] (F's floor is 2^-47); others take
//   quantize() throughout.
__device__ __forceinline__ uint32_t quantize_fast(float x, float s, float rcp, uint32_t& redo,
                                                  int i) {
  const float q0 = __fmul_rn(x, rcp);
  const float q1 = __fmaf_rn(__fmaf_rn(-s, q0, x), rcp, q0);
  const float t = fminf(fmaxf(fabsf(q0) < 1024.0f ? q1 : q0, -127.0f), 127.0f);
  const float w = __fadd_rn(t, 12582912.0f);
  const bool near = fabsf(__fsub_rn(t, __fsub_rn(w, 12582912.0f))) > 0.499969482421875f;
  redo |= static_cast<uint32_t>(near) << i;  // within 2^-15 of x.5
  return __float_as_uint(w);
}

// - silu_fast: r1 = r + r * (1 - d * r), refined once from rcp.approx,
//   lies within 1 ulp of the IEEE reciprocal, so the exact products of y
//   with the two lie within 2 ulps of each other, and the float32 products
//   within 3 patterns. Rounding to bf16 rounds the float32 pattern to a
//   multiple of 2^16, ties to even, so the two round alike unless a
//   midpoint (low 16 bits 0x8000) lies within 3 patterns of the product;
//   the test fires within 4. It also fires outside 2^-40 <= |y| (or y = 0)
//   and d < 2^40 (y > -27.7). bf16 outputs only: a float32 output is the
//   product itself and takes silu().
__device__ __forceinline__ float rcp_approx(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
}

__device__ __forceinline__ float silu_fast(float y, uint32_t& redo, int i) {
  const float d = __fadd_rn(1.0f, expf(-y));
  const float r = rcp_approx(d);
  const float r1 = __fmaf_rn(__fmaf_rn(-d, r, 1.0f), r, r);
  const float p = __fmul_rn(y, r1);
  const bool near = ((__float_as_uint(p) & 0xFFFFu) - 0x7FFCu) <= 8u || !(d < 0x1p40f)
                    || (fabsf(y) < 0x1p-40f && y != 0.0f);
  redo |= static_cast<uint32_t>(near) << i;
  return p;
}

// SiLU of one 16-byte chunk of staged outputs: 8 bf16 values (the fast
// form, the flagged values redone exactly) or 4 float32 values (exact).
__device__ __forceinline__ uint4 silu_chunk(uint4 v, uint16_t) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float y[8], q[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    y[2 * i] = __uint_as_float(w[i] << 16);
    y[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
  uint32_t redo = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = silu_fast(y[i], redo, i);
  if (redo) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (redo >> i & 1) q[i] = silu(y[i]);
  }
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(q[2 * i])))
           | (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(q[2 * i + 1])))
              << 16);
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ uint4 silu_chunk(uint4 v, float) {
  return make_uint4(__float_as_uint(silu(__uint_as_float(v.x))),
                    __float_as_uint(silu(__uint_as_float(v.y))),
                    __float_as_uint(silu(__uint_as_float(v.z))),
                    __float_as_uint(silu(__uint_as_float(v.w))));
}

struct ConvArgs {
  const void* x;
  long long sN, sC, sH, sW;  // input strides, elements (NCHW indexing)
  int B, C, H, W;
  const int8_t* w;            // (co, kp)
  int kp, co, k, stride, pad;
  const float* wscale;        // (co,)
  const float* bias;          // (co,)
  const float* xscale;        // (B,) per sample, or (1,)
  int per_sample;
  void* out;                  // (B, Ho, Wo, co) contiguous
  int Ho, Wo, act;
};

// ---------------------------------------------------------------------------
// Kernel E
// ---------------------------------------------------------------------------

constexpr int kProducers = 128;                   // the producer warpgroup
// Threads of a block with NC consumer warpgroups (1 to 3, the planner's).
template <int NC>
constexpr int threads_e() {
  return 128 * NC + kProducers;
}
constexpr int kTileCols = 64;                     // rows of a wgmma m64 product
constexpr int kRouteTma = 0;                      // else the cp.async ring

// One call's plan, field for field the planner's (int8conv.py, GEO_FIELDS).
struct Geo {
  int route, vbytes, tm, stages, bn, groups, cbox, nbox;
  int planes, planes2, cr, wr, wc, wcp, part, cols, tiles_x, tiles_y, items;
  int region_bytes, raw_bytes, plane_bytes, codes_bytes;
  int off_codes, off_w, off_wsb, off_stage, off_bar, smem, stage_pitch, nch, ksteps, tx_bytes;
  int grid, consumers;
};
constexpr int kGeoFields = 35;
static_assert(sizeof(Geo) == kGeoFields * sizeof(int), "Geo mirrors the planner's fields");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// N bytes global -> shared; none read (zeros written) when !in.
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst), "l"(src), "n"(N),
               "r"(in ? N : 0)
               : "memory");
}

// Generic-proxy writes to shared memory (the codes, the weights) made
// visible to the tensor cores' reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A consumer warpgroup's own barrier (ids 1 to NC; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

// wgmma shared-memory descriptor, no swizzle: start, LBO (the next 16 bytes
// of K), SBO (the next 8 rows), all in units of 16 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
          "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
};
// The accumulators, tied to their last writer: the compiler must not read
// them before wgmma.wait_group nor move writes past wgmma.fence.
template <int R>
__device__ __forceinline__ void fence_acc(int (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

// One k32 step of a bn-wide product: one wgmma, or two n64 halves for 128.
template <int BN>
__device__ __forceinline__ void mma_step(int (&acc)[BN / 2], uint64_t da, uint32_t b_addr,
                                         int accumulate) {
  if constexpr (BN <= 64) {
    Wgmma<BN>::mma(acc, da, smem_desc(b_addr, BN * 16, 128), accumulate);
  } else {
#pragma unroll
    for (int h = 0; h < BN / 64; ++h)
      Wgmma<64>::mma(*reinterpret_cast<int(*)[32]>(&acc[32 * h]), da,
                     smem_desc(b_addr + h * 64 * 16, BN * 16, 128), accumulate);
  }
}

__device__ __forceinline__ void tile_of(const Geo& g, int item, int& b, int& ty, int& tx) {
  int t = item / g.groups;
  tx = t % g.tiles_x;
  t /= g.tiles_x;
  ty = t % g.tiles_y;
  b = t / g.tiles_y;
}

// The block's group of weights into shared memory: chunk q = tap * planes2
// + j holds channels 16j..16j+15 of that tap for the bn rows, 16 bytes per
// row (zeros past C and in an odd tap's last chunk); then wscale and bias.
template <int BN>
__device__ void load_weights(const ConvArgs& a, const Geo& g, int n0, int8_t* wsm, float* wsb) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (a.C % 16 == 0 && (reinterpret_cast<uintptr_t>(a.w) & 15) == 0) {
    for (int u = tid; u < g.nch * BN; u += nthreads) {
      const int q = u / BN, n = u % BN;
      const int tap = q / g.planes2, j = q - tap * g.planes2;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (j < g.planes)
        v = *reinterpret_cast<const uint4*>(a.w + static_cast<long long>(n0 + n) * a.kp
                                            + tap * a.C + 16 * j);
      *reinterpret_cast<uint4*>(wsm + (q * BN + n) * 16) = v;
    }
  } else {
    for (int u = tid; u < g.nch * BN * 16; u += nthreads) {
      const int byte = u % 16, n = (u / 16) % BN, q = u / (16 * BN);
      const int tap = q / g.planes2, c = 16 * (q - tap * g.planes2) + byte;
      wsm[(q * BN + n) * 16 + byte] =
          c < a.C ? a.w[static_cast<long long>(n0 + n) * a.kp + tap * a.C + c] : int8_t(0);
    }
  }
  for (int i = tid; i < BN; i += nthreads) {
    wsb[i] = a.wscale[n0 + i];
    wsb[BN + i] = a.bias[n0 + i];
  }
}

// The ring route's copies of one window: unit u = (window pixel, chunk of
// V bytes), producer thread pt takes units pt, pt + kProducers, ..., its
// pixel and chunk stepped on without divisions; zeros outside the frame. V
// = 2: one bf16 element by a plain load.
template <int V>
__device__ __forceinline__ void ring_copy(const ConvArgs& a, const Geo& g, unsigned char* raw,
                                          int b, int iy0, int ix0, int pt, int es) {
  const int epc = V > es ? V / es : 1;  // elements per copy
  const int cpp = a.C / epc;            // copies per pixel
  const int npix = g.wr * g.wc, dp = kProducers / cpp, dc = kProducers - dp * cpp;
  const char* x = static_cast<const char*>(a.x);
  int pix = pt / cpp, cc = pt - pix * cpp;
  int wy = pix / g.wc, wx = pix - wy * g.wc;
  while (pix < npix) {
    const int iy = iy0 + wy, ix = ix0 + wx;
    const bool in = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
    const long long off =
        in ? b * a.sN + iy * a.sH + ix * a.sW + static_cast<long long>(cc) * epc * a.sC : 0;
    const char* src = x + off * es;
    unsigned char* dst = raw + (pix * g.cr + cc * epc) * es;
    if constexpr (V >= 4) {
      cp_async<V>(smem_u32(dst), src, in);
    } else {
      *reinterpret_cast<uint16_t*>(dst) = in ? *reinterpret_cast<const uint16_t*>(src) : 0;
    }
    int step = dp;
    cc += dc;
    if (cc >= cpp) {
      cc -= cpp;
      ++step;
    }
    pix += step;
    for (wx += step; wx >= g.wc; wx -= g.wc) ++wy;
  }
}

// The producer warpgroup: one window per tile into the ring, in the block's
// tile order. TMA: thread 0 issues the boxes; ring: the 128 threads' copies,
// each thread's tracked by the stage's full barrier.
template <typename S>
__device__ void produce(const CUtensorMap& tmap, const ConvArgs& a, const Geo& g,
                        unsigned char* smem, int pt) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.off_bar);
  uint64_t* empty = full + g.stages;
  const bool tma = g.route == kRouteTma;
  if (tma && pt != 0) return;
  constexpr int es = sizeof(S);
  int li = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x, ++li) {
    const int stage = li % g.stages, lap = li / g.stages;
    if (lap > 0) mbar_wait(smem_u32(&empty[stage]), (lap - 1) & 1);
    int b, ty, tx;
    tile_of(g, item, b, ty, tx);
    const int iy0 = ty * g.tm * a.stride - a.pad, ix0 = tx * g.cols * a.stride - a.pad;
    unsigned char* raw = smem + stage * g.raw_bytes;
    const uint32_t bar = smem_u32(&full[stage]);
    if (tma) {
      mbar_expect_tx(bar, g.tx_bytes);
      for (int r = 0; r < g.nbox; ++r)
        tma_load_4d(smem_u32(raw + r * g.region_bytes), &tmap, r * g.cbox, ix0, iy0, b, bar);
      continue;
    }
    if (g.vbytes == 16) {
      ring_copy<16>(a, g, raw, b, iy0, ix0, pt, es);
    } else if (g.vbytes == 8) {
      ring_copy<8>(a, g, raw, b, iy0, ix0, pt, es);
    } else if (g.vbytes == 4) {
      ring_copy<4>(a, g, raw, b, iy0, ix0, pt, es);
    } else {
      ring_copy<2>(a, g, raw, b, iy0, ix0, pt, es);
    }
    if (g.vbytes >= 4)
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
    else
      mbar_arrive(bar);
  }
  if (!tma) asm volatile("cp.async.wait_all;" ::: "memory");
}

// 16 values of one pixel's 16-channel plane -> 16 codes; channels from
// `lim` on (past C: the ring's padding) are 0. `rcp` = 1/s; `fast` when s
// is in quantize_fast's range (else every code takes the IEEE division).
template <typename S>
__device__ __forceinline__ uint4 quantize16(const S* p, float s, float rcp, bool fast, int lim) {
  float v[16];
  if constexpr (sizeof(S) == 2) {
    const uint4 r0 = reinterpret_cast<const uint4*>(p)[0];
    const uint4 r1 = reinterpret_cast<const uint4*>(p)[1];
    const uint32_t w[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  }
  uint32_t q[16];
  uint32_t redo = fast ? 0u : 0xFFFFu;
#pragma unroll
  for (int i = 0; i < 16; ++i) q[i] = quantize_fast(v[i], s, rcp, redo, i);
  if (redo) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (redo >> i & 1) q[i] = quantize(v[i], s);
  }
  if (lim < 16) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i >= lim) q[i] = 0;
  }
  return make_uint4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                    pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
}

// A window (raw, in its TMA boxes or the ring's pixel layout) -> its codes:
// plane j at j * plane_bytes, window pixel (y, x) at position y * wcp + (x %
// s) * part + x / s, 16 bytes each. One (pixel, plane) unit per thread,
// consecutive threads on consecutive 32-byte reads.
template <typename S>
__device__ void quantize_window(const ConvArgs& a, const Geo& g, const unsigned char* raw,
                                unsigned char* codes, float s, int t) {
  const int npix = g.wr * g.wc, jpb = g.cbox / 16;
  const int dp = 128 / jpb, dj = 128 - dp * jpb;
  const float rcp = __frcp_rn(s);
  const bool fast = fabsf(s) >= 0x1p-60f && fabsf(s) <= 0x1p60f;
  for (int r = 0; r < g.nbox; ++r) {
    const S* box = reinterpret_cast<const S*>(raw + r * g.region_bytes);
    int pix = t / jpb, jj = t - (t / jpb) * jpb;
    for (; pix < npix; pix += dp, jj += dj) {
      if (jj >= jpb) {
        jj -= jpb;
        if (++pix >= npix) break;
      }
      const int j = r * jpb + jj;
      int pos = pix;
      if (a.stride != 1) {
        const int wy = pix / g.wc, wx = pix - wy * g.wc;
        pos = wy * g.wcp + (wx % a.stride) * g.part + wx / a.stride;
      }
      *reinterpret_cast<uint4*>(codes + j * g.plane_bytes + pos * 16) =
          quantize16<S>(box + pix * g.cbox + jj * 16, s, rcp, fast, a.C - 16 * j);
    }
  }
}

// The products of output row r of the tile: every tap and plane pair, one
// k32 step each, accumulated in registers; issued and committed, not waited
// for (mma_wait), so the caller's stores of the row before run under them.
template <int BN>
__device__ __forceinline__ void mma_issue(int (&acc)[BN / 2], const ConvArgs& a, const Geo& g,
                                          uint32_t codes, uint32_t wsm, int r) {
  int jp = 0, dx = 0, dy = 0;
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  for (int kk = 0; kk < g.ksteps; ++kk) {
    const int col = (dx % a.stride) * g.part + dx / a.stride;
    const uint32_t a_addr =
        codes + jp * g.plane_bytes + ((r * a.stride + dy) * g.wcp + col) * 16;
    // A tap's last step with an odd plane count: its second chunk's weights
    // are zero, so A reads the first plane again.
    const uint64_t da = smem_desc(a_addr, jp + 1 < g.planes ? g.plane_bytes : 0, 128);
    mma_step<BN>(acc, da, wsm + kk * 32 * BN, kk > 0);
    jp += 2;
    if (jp == g.planes2) {
      jp = 0;
      if (++dx == a.k) {
        dx = 0;
        ++dy;
      }
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  fence_acc(acc);
}

template <int BN>
__device__ __forceinline__ void mma_wait(int (&acc)[BN / 2]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);
}

// Row r's accumulators -> dequantized values rounded to the output type, in
// the warpgroup's staging rows (row m = output column ox0 + m); SiLU follows
// in the store loop. Thread (warp w, lane l) holds rows 16w + l/4 (+ 8) and
// columns 8j + 2(l%4) (+ 1).
template <typename S, int BN>
__device__ __forceinline__ void stage_row(const int (&acc)[BN / 2], const float* wsb, float xs,
                                          unsigned char* staging, int pitch, int t, int valid) {
  const int warp = t >> 5, lane = t & 31;
  if (16 * warp >= valid) return;  // the warp's 16 rows are past the frame
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float2 ws = *reinterpret_cast<const float2*>(wsb + col);
    const float2 bs = *reinterpret_cast<const float2*>(wsb + BN + col);
    const float m0 = __fmul_rn(xs, ws.x), m1 = __fmul_rn(xs, ws.y);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + (lane >> 2) + 8 * h;
      const float y0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), m0), bs.x);
      const float y1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), m1), bs.y);
      S* dst = reinterpret_cast<S*>(staging + row * pitch) + col;
      if constexpr (sizeof(S) == 4) {
        *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
      } else {
        *reinterpret_cast<uint32_t*>(dst) =
            static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(y0)))
            | (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(y1))) << 16);
      }
    }
  }
}

// A consumer warpgroup: every NC-th tile of the block's walk. The ring's
// depth is a multiple of NC (the planner's), so consumer c owns the stages
// s = c mod NC and waits on each one's phases in
// turn: an mbarrier's parity cannot tell a phase from the one two laps on,
// which a consumer sharing a stage with another could reach first.
template <typename S, int BN, int NC>
__device__ void consume(const ConvArgs& a, const Geo& g, unsigned char* smem, int wg, int t,
                        int n0) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.off_bar);
  uint64_t* empty = full + g.stages;
  unsigned char* codes = smem + g.off_codes + wg * g.codes_bytes;
  unsigned char* staging =
      smem + g.off_stage + wg * ((kTileCols * g.stage_pitch + 127) / 128 * 128);
  const float* wsb = reinterpret_cast<const float*>(smem + g.off_wsb);
  const uint32_t codes_u32 = smem_u32(codes), wsm_u32 = smem_u32(smem + g.off_w);
  constexpr int es = sizeof(S);
  constexpr int cpr = BN * es / 16;  // 16-byte chunks per staged row
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int li = wg;
  for (int item = blockIdx.x + wg * gridDim.x; item < g.items;
       item += NC * gridDim.x, li += NC) {
    const int stage = li % g.stages;
    mbar_wait(smem_u32(&full[stage]), (li / g.stages) & 1);
    int b, ty, tx;
    tile_of(g, item, b, ty, tx);
    const float xs = a.xscale[a.per_sample ? b : 0];
    quantize_window<S>(a, g, smem + stage * g.raw_bytes, codes, xs, t);
    fence_proxy_async();
    wg_sync(wg);
    if (t == 0) mbar_arrive(smem_u32(&empty[stage]));
    const int oy0 = ty * g.tm, ox0 = tx * g.cols;
    const int rows = min(g.tm, a.Ho - oy0), valid = min(g.cols, a.Wo - ox0);
    mma_issue<BN>(acc, a, g, codes_u32, wsm_u32, 0);
    for (int r = 0; r < rows; ++r) {
      mma_wait<BN>(acc);
      stage_row<S, BN>(acc, wsb, xs, staging, g.stage_pitch, t, valid);
      wg_sync(wg);
      if (r + 1 < rows) mma_issue<BN>(acc, a, g, codes_u32, wsm_u32, r + 1);
      char* out = static_cast<char*>(a.out)
                  + ((((static_cast<long long>(b) * a.Ho + oy0 + r) * a.Wo + ox0) * a.co + n0)
                     * es);
      for (int q = t; q < valid * cpr; q += 128) {
        const int m = q / cpr, cc = q % cpr;
        uint4 v = *reinterpret_cast<const uint4*>(staging + m * g.stage_pitch + cc * 16);
        if (a.act) v = silu_chunk(v, S());
        *reinterpret_cast<uint4*>(out + static_cast<long long>(m) * a.co * es + cc * 16) = v;
      }
      wg_sync(wg);
    }
  }
}

template <typename S, int BN, int NC>
__global__ void __launch_bounds__(threads_e<NC>(), 1)
    int8_conv_kernel(const __grid_constant__ CUtensorMap tmap, const ConvArgs a, const Geo g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % g.groups) * BN;  // gridDim.x is a multiple of groups
  load_weights<BN>(a, g, n0, reinterpret_cast<int8_t*>(smem + g.off_w),
                   reinterpret_cast<float*>(smem + g.off_wsb));
  fence_proxy_async();
  if (tid == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + g.off_bar);
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(smem_u32(&bars[s]), g.route == kRouteTma ? 1 : kProducers);  // full
      mbar_init(smem_u32(&bars[g.stages + s]), 1);                    // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = tid >> 5;
  if (warp >= 4 * NC) {
    produce<S>(tmap, a, g, smem, tid - 128 * NC);
  } else {
    consume<S, BN, NC>(a, g, smem, warp >> 2, tid & 127, n0);
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links only cudart).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kErrTensorMap = 100000;  // + the CUresult of a refused tensor map

// Blocks of one variant resident per SM at this shared-memory size (cached).
template <typename S, int BN, int NC>
int resident_blocks(int smem) {
  static int sizes[64], counts[64], n = 0;
  for (int i = 0; i < n; ++i)
    if (sizes[i] == smem) return counts[i];
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, int8_conv_kernel<S, BN, NC>,
                                                    threads_e<NC>(), smem) != cudaSuccess)
    return 0;
  if (n < 64) {
    sizes[n] = smem;
    counts[n] = occ;
    ++n;
  }
  return occ;
}

template <typename S, int BN, int NC>
int launch_conv(const CUtensorMap& map, const ConvArgs& a, const Geo& g, cudaStream_t stream) {
  const int smem = g.smem + 128;  // + the kernel's alignment slack
  static int opted = 0;           // the dynamic shared-memory size this variant may use
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_conv_kernel<S, BN, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  static int sms[16] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidDevice);
  const int occ = resident_blocks<S, BN, NC>(smem);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int grid = std::min(g.grid, sms[dev] * occ);
  grid = std::max(g.groups, grid - grid % g.groups);
  int8_conv_kernel<S, BN, NC><<<grid, threads_e<NC>(), smem, stream>>>(map, a, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int NC>
int launch_conv_bn(const CUtensorMap& map, const ConvArgs& a, const Geo& g,
                   cudaStream_t stream) {
  if (g.bn == 128) return launch_conv<S, 128, NC>(map, a, g, stream);
  if (g.bn == 64) return launch_conv<S, 64, NC>(map, a, g, stream);
  if (g.bn == 32) return launch_conv<S, 32, NC>(map, a, g, stream);
  if (g.bn == 16) return launch_conv<S, 16, NC>(map, a, g, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename S>
int launch_conv_nc(const CUtensorMap& map, const ConvArgs& a, const Geo& g,
                   cudaStream_t stream) {
  if (g.consumers == 3) return launch_conv_bn<S, 3>(map, a, g, stream);
  if (g.consumers == 2) return launch_conv_bn<S, 2>(map, a, g, stream);
  if (g.consumers == 1) return launch_conv_bn<S, 1>(map, a, g, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// Kernel F
// ---------------------------------------------------------------------------

__device__ __forceinline__ float block_max(float m) {
  __shared__ float warp_max[kFThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kFThreads / 32 ? warp_max[threadIdx.x] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
  }
  return m;
}

// Pixels evenly strided (sH == W * sW): thread (chunk cc, pixel p) with cc
// fixed per thread when the chunks of a pixel divide the block; otherwise
// every element is decomposed on its own.
template <typename S, int V>
__global__ void __launch_bounds__(kFThreads) act_absmax_kernel(
    const void* xp, long long sN, long long sC, long long sH, long long sW, int C, int H, int W,
    int splits, int fast, float* scale, float* partial, unsigned* ticket) {
  const int b = blockIdx.y, s = blockIdx.x;
  const S* x = static_cast<const S*>(xp) + b * sN;
  float m = 0.0f;
  if (fast) {
    const int cpp = C / V;  // chunks per pixel; divides kFThreads
    const int P = H * W;
    const int per = (P + splits - 1) / splits;
    const int lo = s * per, hi = min(P, lo + per);
    const int cc = threadIdx.x % cpp, step = kFThreads / cpp;
    for (int p = lo + threadIdx.x / cpp; p < hi; p += step) {
      const S* q = x + p * sW + cc * V * sC;
      Vec<S, V> v;
      if constexpr (V == 1) {
        v.v[0] = *q;
      } else {
        v = load_vec<S, V>(q);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) m = fmaxf(m, fabsf(to_f32(v.v[i])));
    }
  } else {
    const int total = C * H * W;
    const int per = (total + splits - 1) / splits;
    const int lo = s * per, hi = min(total, lo + per);
    for (int i = lo + threadIdx.x; i < hi; i += kFThreads) {
      const int c = i % C, p = i / C;
      const int y = p / W, xx = p - (p / W) * W;
      m = fmaxf(m, fabsf(to_f32(x[y * sH + xx * sW + c * sC])));
    }
  }
  m = block_max(m);
  if (threadIdx.x == 0) {
    partial[b * splits + s] = m;
    __threadfence();
    if (atomicAdd(&ticket[b], 1u) == static_cast<unsigned>(splits - 1)) {
      __threadfence();
      const volatile float* part = partial + b * splits;
      float top = 0.0f;
      for (int i = 0; i < splits; ++i) top = fmaxf(top, part[i]);
      scale[b] = __fdiv_rn(fmaxf(top, 1e-12f), 127.0f);
    }
  }
}

template <typename S>
int launch_absmax(const void* x, long long sN, long long sC, long long sH, long long sW, int B,
                  int C, int H, int W, int vec, int splits, int fast, float* scale,
                  float* partial, unsigned* ticket, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned) * B, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, B);
  if (vec == 8)
    act_absmax_kernel<S, 8><<<grid, kFThreads, 0, stream>>>(x, sN, sC, sH, sW, C, H, W, splits,
                                                            fast, scale, partial, ticket);
  else if (vec == 4)
    act_absmax_kernel<S, 4><<<grid, kFThreads, 0, stream>>>(x, sN, sC, sH, sW, C, H, W, splits,
                                                            fast, scale, partial, ticket);
  else if (vec == 1)
    act_absmax_kernel<S, 1><<<grid, kFThreads, 0, stream>>>(x, sN, sC, sH, sW, C, H, W, splits,
                                                            fast, scale, partial, ticket);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel E. dtype 0: float32, 1: bfloat16 (input and output). geo: the
// planner's kGeoFields ints (int8conv.py, GEO_FIELDS). Returns a cudaError,
// or kErrTensorMap + the CUresult when the driver refuses the tensor map.
int tti_int8_conv2d(const void* x, long long sN, long long sC, long long sH, long long sW,
                    int B, int C, int H, int W, const void* w, int kp, int co, int k, int stride,
                    int pad, const void* wscale, const void* bias, const void* xscale,
                    int per_sample, void* out, int Ho, int Wo, int act, int dtype, const int* geo,
                    void* stream) {
  Geo g;
  memcpy(&g, geo, sizeof g);
  if (B < 1 || C < 1 || co < 1 || kp < k * k * C || g.bn < 16 || co % g.bn != 0
      || g.groups != co / g.bn || g.items < 1 || g.grid < g.groups || g.stages < 1
      || g.consumers < 1 || g.stages % g.consumers != 0
      || g.smem + 128 > 227 * 1024 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a{x, sN, sC, sH, sW, B, C, H, W, static_cast<const int8_t*>(w), kp, co, k, stride,
             pad, static_cast<const float*>(wscale), static_cast<const float*>(bias),
             static_cast<const float*>(xscale), per_sample, out, Ho, Wo, act};
  CUtensorMap map;
  memset(&map, 0, sizeof map);
  if (g.route == kRouteTma) {
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t es = dtype ? 2 : 4;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sW) * es,
                                   static_cast<cuuint64_t>(sH) * es,
                                   static_cast<cuuint64_t>(sN) * es};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(g.cbox), static_cast<cuuint32_t>(g.wc),
                               static_cast<cuuint32_t>(g.wr), 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = encode(
        &map, dtype ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
        const_cast<void*>(x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kErrTensorMap + static_cast<int>(r);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_conv_nc<uint16_t>(map, a, g, s) : launch_conv_nc<float>(map, a, g, s);
}

// Kernel F. scratch: B * splits floats of partial maxima, then B tickets.
int tti_act_scale_per_sample(const void* x, long long sN, long long sC, long long sH,
                             long long sW, int B, int C, int H, int W, int dtype, int vec,
                             int splits, int fast, void* scale, void* scratch, void* stream) {
  if (B < 1 || splits < 1 || C % vec != 0) return static_cast<int>(cudaErrorInvalidValue);
  float* partial = static_cast<float*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(partial + static_cast<long long>(B) * splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(scale);
  if (dtype == 0)
    return launch_absmax<float>(x, sN, sC, sH, sW, B, C, H, W, vec, splits, fast, out, partial,
                                ticket, s);
  if (dtype == 1)
    return launch_absmax<uint16_t>(x, sN, sC, sH, sW, B, C, H, W, vec, splits, fast, out,
                                   partial, ticket, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
