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
//       int32 accumulation on the tensor cores (mma.sync m16n8k32 s8);
//   y = float(acc) * (xscale[b] * wscale[c]) + bias[c] in float32, rounded
//       to the output dtype, then SiLU, written channels_last.
// Kernel F is tti's quantize_act_per_sample scale (tti/model/layers.py:26-38):
// per sample, max |x| over (H, W, C), then max(absmax, 1e-12) / 127.
//
// Numerics, bit for bit those of the plain version (tti_torch/kernels/
// int8conv.py): the quotient x / s is an IEEE division (__fdiv_rn; nvcc
// without --use_fast_math), rounding is half to even (as jnp.round and
// np.rint; done by a float add, see quantize()); the integer product is exact; int32 -> float32
// rounds to nearest (|acc| reaches 2304 * 127^2 > 2^24, so it can round: the
// plain version convolves in float64 and converts the same way);
// (xscale * wscale) is formed first, as tti forms it, and the epilogue is
// written with __fmul_rn / __fadd_rn, which nvcc never contracts into an FMA
// (one rounding where the reference has two). SiLU is PyTorch's own formula,
// x / (1 + expf(-x)) in float32 on the rounded output, with an IEEE division;
// expf is the CUDA math library's, which PyTorch's kernel also calls, so the
// two agree unless the toolkits' expf differ (chip_smoke.py prints the
// largest difference in ulps and holds it to 1). Zero padding, the s2d stem's
// pre-pad and the K padding are zeros, which quantize to 0, as in tti. F's
// max is order-independent: bit-equal.
//
// Strided inputs: both kernels take the input's four strides (elements), so
// a C2f bottleneck's channel slice of cv1's output is read in place, never
// copied. F's absmax covers the slice only.
//
// What bounds E on this card: bytes, by the count of its own inputs and
// outputs. The layers are narrow (co 16-256, K 48-2304) and wide in M: at
// deploy batch 128 the stem reads 4.2 MB and writes 5.6 MB per frame for
// 2 * 48 * 16 = 1536 integer operations per output pixel, far below the
// card's ~600 int8 operations per byte. In fact the quantization is the
// work: each code is an IEEE division and a rounding, and an implicit GEMM
// that quantizes as it loads does that once per tap (9 times per element of
// a 3x3 input). Two routes, both 4 warps, 128 output pixels per block and
// mma.sync m16n8k32 over K steps of 32, the weights staged in shared
// memory two steps deep:
//   halo (ci a multiple of 16, 16-byte loads: every block but the stems):
//     the block's output tile is 8 rows x 16 columns of one frame; its
//     input window ((8-1)*s + k rows by (16-1)*s + k columns, all ci
//     channels) is loaded and quantized once into shared memory, and every
//     tap and every group of 64 output channels reads its fragments from
//     there (each K step's two 16-channel halves lie in one tap). The
//     window's pixel stride is padded so that the 8 fragment rows of a
//     lane group fall in distinct banks (stride 1: ci = 16 mod 32; stride
//     2: ci = 8 mod 16). Windows up to about 80 KB: two blocks per SM.
//   direct (any ci, strides and alignment: the plain stem ci 3, the s2d
//     stem ci 12): one block per 128 consecutive output pixels x BN output
//     channels (BN = 64, or co when co < 64); the next K step's input values
//     are loaded into registers under the current step's products, then
//     quantized into a shared tile whose rows are 48 bytes apart (bank-free
//     fragment reads). Loads are 16 bytes wide where the channels and
//     alignment allow, else 8 or 4, else one element with any strides.
// wgmma, TMA, a persistent schedule, and codes written once by the
// producing block's epilogue (with F's absmax folded in there) are later
// work.
//
// F: a grid of (S, B) blocks, each a max over 1/S of one sample, with
// 16-byte loads where possible; the last block of a sample to finish (an
// atomic ticket after a fence) combines the S partial maxima and writes the
// scale. The tickets are zeroed on the stream before the launch. One launch,
// no host synchronisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // E: 4 warps
constexpr int kBM = 128;        // E: output pixels per block, 32 per warp
constexpr int kBK = 32;         // E: K per step (one m16n8k32)
constexpr int kRowBytes = 48;   // E: shared row stride (32 bytes of K + 16 of padding)
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

template <typename S, int V>
__device__ __forceinline__ Vec<S, V> zero_vec() {
  Vec<S, V> z;
#pragma unroll
  for (int i = 0; i < V; ++i) z.v[i] = S(0);
  return z;
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

// V int8 values packed little-endian in the low V bytes.
template <int V>
struct Pack;
template <>
struct Pack<8> { using type = uint2; };
template <>
struct Pack<4> { using type = uint32_t; };
template <>
struct Pack<1> { using type = uint32_t; };

// Four codes' low bytes packed into one word, element 0 in the low byte.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

template <typename S, int V>
__device__ __forceinline__ typename Pack<V>::type quantize_vec(const Vec<S, V>& raw, float s) {
  uint32_t q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) q[i] = quantize(to_f32(raw.v[i]), s);
  typename Pack<V>::type out;
  if constexpr (V == 8) {
    out = make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
  } else if constexpr (V == 4) {
    out = pack4(q[0], q[1], q[2], q[3]);
  } else {
    out = q[0];
  }
  return out;
}

template <int V>
__device__ __forceinline__ void store_pack(int8_t* dst, typename Pack<V>::type p) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(dst) = p;
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(dst) = p;
  } else {
    *dst = static_cast<int8_t>(p & 0xFFu);
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The epilogue's value: dequantize, bias, round to the output type, SiLU.
__device__ __forceinline__ float dequant(int acc, float xs, float ws, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(xs, ws)), bias);
}

__device__ __forceinline__ float silu(float y) {
  return __fdiv_rn(y, __fadd_rn(1.0f, expf(-y)));
}

__device__ __forceinline__ void store_pair(float* out, long long idx, float y0, float y1,
                                           int act) {
  if (act) {
    y0 = silu(y0);
    y1 = silu(y1);
  }
  *reinterpret_cast<float2*>(out + idx) = make_float2(y0, y1);
}

__device__ __forceinline__ void store_pair(uint16_t* out, long long idx, float y0, float y1,
                                           int act) {
  __nv_bfloat16 b0 = __float2bfloat16_rn(y0), b1 = __float2bfloat16_rn(y1);
  if (act) {
    b0 = __float2bfloat16_rn(silu(__bfloat162float(b0)));
    b1 = __float2bfloat16_rn(silu(__bfloat162float(b1)));
  }
  const uint32_t bits = static_cast<uint32_t>(__bfloat16_as_ushort(b0))
                        | (static_cast<uint32_t>(__bfloat16_as_ushort(b1)) << 16);
  *reinterpret_cast<uint32_t*>(out + idx) = bits;
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

template <typename S, int V, int BN>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(const ConvArgs a) {
  constexpr int kCpr = kBK / V;                   // input chunks per row and K step
  constexpr int kAPer = kBM * kCpr / kThreads;    // chunks per thread
  constexpr int kBChunks = BN * kBK / 16;         // 16-byte weight chunks per K step
  constexpr int kNt = BN / 8;                     // n8 tiles per warp
  static_assert(kBM * kCpr % kThreads == 0, "A chunks");

  __shared__ __align__(16) int8_t sA[2][kBM * kRowBytes];
  __shared__ __align__(16) int8_t sB[2][BN * kRowBytes];
  __shared__ long long row_base[kBM];  // n * sN, or -1 past M
  __shared__ int row_y[kBM], row_x[kBM];
  __shared__ float row_scale[kBM];

  const int tid = threadIdx.x;
  const long long M = static_cast<long long>(a.B) * a.Ho * a.Wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;
  const int K = a.k * a.k * a.C;
  const S* x = static_cast<const S*>(a.x);

  for (int r = tid; r < kBM; r += kThreads) {
    const long long m = m0 + r;
    if (m < M) {
      const int hw = a.Ho * a.Wo;
      const int n = static_cast<int>(m / hw);
      const int rem = static_cast<int>(m - static_cast<long long>(n) * hw);
      const int oy = rem / a.Wo, ox = rem - (rem / a.Wo) * a.Wo;
      row_base[r] = n * a.sN;
      row_y[r] = oy * a.stride - a.pad;
      row_x[r] = ox * a.stride - a.pad;
      row_scale[r] = a.xscale[a.per_sample ? n : 0];
    } else {
      row_base[r] = -1;
      row_y[r] = row_x[r] = 0;
      row_scale[r] = 1.0f;
    }
  }
  __syncthreads();

  Vec<S, V> raw[kAPer];
  uint4 braw = make_uint4(0, 0, 0, 0);

  // A thread's chunks share one K position (kCpr divides the block), so the
  // tap and channel of a K step are worked out once per thread.
  static_assert(kThreads % kCpr == 0, "one K position per thread");
  const int cc = tid % kCpr;
  auto load_a = [&](int kt) {
    const int kk = kt * kBK + cc * V;
    const int tap = kk / a.C;
    const int c = kk - tap * a.C;
    const int dy = tap / a.k, dx = tap - (tap / a.k) * a.k;
    const long long koff = dy * a.sH + dx * a.sW + c * a.sC;
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      const int r = tid / kCpr + j * (kThreads / kCpr);
      raw[j] = zero_vec<S, V>();
      const long long base = row_base[r];
      if (kk < K && base >= 0) {
        const int iy = row_y[r] + dy, ix = row_x[r] + dx;
        if (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W) {
          const S* p = x + base + row_y[r] * a.sH + row_x[r] * a.sW + koff;
          if constexpr (V == 1) {
            raw[j].v[0] = *p;
          } else {
            raw[j] = load_vec<S, V>(p);  // sC == 1 (checked by the wrapper)
          }
        }
      }
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      const int r = tid / kCpr + j * (kThreads / kCpr);
      store_pack<V>(&sA[buf][r * kRowBytes + cc * V], quantize_vec<S, V>(raw[j], row_scale[r]));
    }
  };
  auto load_b = [&](int kt) {
    if (tid < kBChunks) {
      const int r = tid >> 1, h = tid & 1;
      braw = *reinterpret_cast<const uint4*>(a.w + static_cast<long long>(n0 + r) * a.kp
                                             + kt * kBK + h * 16);
    }
  };
  auto store_b = [&](int buf) {
    if (tid < kBChunks) {
      const int r = tid >> 1, h = tid & 1;
      *reinterpret_cast<uint4*>(&sB[buf][r * kRowBytes + h * 16]) = braw;
    }
  };

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  int acc[2][kNt][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  const int n_steps = a.kp / kBK;
  load_a(0);
  load_b(0);
  store_a(0);
  store_b(0);
  __syncthreads();
  for (int kt = 0; kt < n_steps; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < n_steps;
    if (more) {  // the next step's loads are in flight under this step's products
      load_a(kt + 1);
      load_b(kt + 1);
    }
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int8_t* p = &sA[cur][(warp * 32 + mt * 16 + g) * kRowBytes + t * 4];
      af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
      af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRowBytes);
      af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRowBytes + 16);
    }
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int8_t* p = &sB[cur][(nt * 8 + g) * kRowBytes + t * 4];
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], af[mt], b0, b1);
    }
    if (more) {
      store_a(cur ^ 1);
      store_b(cur ^ 1);
    }
    __syncthreads();
  }

  S* out = static_cast<S*>(a.out);
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    const int col = n0 + nt * 8 + 2 * t;
    const float ws0 = a.wscale[col], ws1 = a.wscale[col + 1];
    const float b0 = a.bias[col], b1 = a.bias[col + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 32 + mt * 16 + g + 8 * half;
        if (row_base[r] < 0) continue;
        const float xs = row_scale[r];
        const float y0 = dequant(acc[mt][nt][2 * half], xs, ws0, b0);
        const float y1 = dequant(acc[mt][nt][2 * half + 1], xs, ws1, b1);
        store_pair(out, (m0 + r) * a.co + col, y0, y1, a.act);
      }
    }
  }
}

template <typename S, int V, int BN>
int launch_conv(const ConvArgs& a, cudaStream_t stream) {
  const long long M = static_cast<long long>(a.B) * a.Ho * a.Wo;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), a.co / BN);
  int8_conv_kernel<S, V, BN><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int V>
int launch_conv_bn(const ConvArgs& a, int bn, cudaStream_t stream) {
  if (bn == 64) return launch_conv<S, V, 64>(a, stream);
  if (bn == 32) return launch_conv<S, V, 32>(a, stream);
  if (bn == 16) return launch_conv<S, V, 16>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename S>
int launch_conv_vec(const ConvArgs& a, int vec, int bn, cudaStream_t stream) {
  if (vec == 8) return launch_conv_bn<S, 8>(a, bn, stream);
  if (vec == 4) return launch_conv_bn<S, 4>(a, bn, stream);
  if (vec == 1) return launch_conv_bn<S, 1>(a, bn, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// Kernel E, the halo route (ci a multiple of 16): the block's input window
// is quantized once into shared memory and every tap reads it there.
// ---------------------------------------------------------------------------

constexpr int kTileH = 8, kTileW = 16;  // output pixels per block: 8 rows of 16 (= kBM)
static_assert(kTileH * kTileW == kBM, "one block row per output pixel");

// Bytes of shared memory a halo block needs: the window of (kTileH - 1) * s
// + k rows by (kTileW - 1) * s + k columns at ``cp`` bytes per pixel, then
// the two weight buffers.
__host__ __device__ __forceinline__ int halo_bytes(int k, int stride, int cp) {
  const int hh = (kTileH - 1) * stride + k, hw = (kTileW - 1) * stride + k;
  return (hh * hw * cp + 15) / 16 * 16;
}

template <typename S, int V, int BN>
__global__ void __launch_bounds__(kThreads) int8_conv_halo_kernel(const ConvArgs a, int cp,
                                                                   int tiles_w) {
  constexpr int kNt = BN / 8;
  constexpr int kBChunks = BN * kBK / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = a.stride, k = a.k, C = a.C;
  const int hh = (kTileH - 1) * s + k, hw = (kTileW - 1) * s + k;
  int8_t* halo = reinterpret_cast<int8_t*>(smem);
  int8_t* sB = halo + halo_bytes(k, s, cp);  // [2][BN * kRowBytes]

  const int tid = threadIdx.x, n = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * kTileH, ox0 = (blockIdx.x % tiles_w) * kTileW;
  const int iy0 = oy0 * s - a.pad, ix0 = ox0 * s - a.pad;
  const float scale = a.xscale[a.per_sample ? n : 0];
  const S* x = static_cast<const S*>(a.x) + n * a.sN;

  // The window, quantized once: V channels per load, zeros outside the
  // frame (padding quantizes to 0).
  const int cpv = C / V, chunks = hh * hw * cpv;
  for (int i = tid; i < chunks; i += kThreads) {
    const int p = i / cpv, cc = i - p * cpv;
    const int hy = p / hw, hx = p - hy * hw;
    const int iy = iy0 + hy, ix = ix0 + hx;
    Vec<S, V> raw = zero_vec<S, V>();
    if (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
      raw = load_vec<S, V>(x + iy * a.sH + ix * a.sW + cc * V);
    store_pack<V>(halo + p * cp + cc * V, quantize_vec<S, V>(raw, scale));
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // Row r = warp * 32 + mt * 16 + g (+ 8) is output pixel (r / 16, r % 16)
  // of the tile: (warp * 2 + mt, g) and (warp * 2 + mt, g + 8).
  int row_off[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row_off[mt][h] = ((warp * 2 + mt) * s * hw + (g + 8 * h) * s) * cp + t * 4;

  const int K = k * k * C, n_steps = a.kp / kBK;
  uint4 braw = make_uint4(0, 0, 0, 0);
  S* out = static_cast<S*>(a.out);
  for (int n0 = 0; n0 < a.co; n0 += BN) {
    auto load_b = [&](int kt) {
      if (tid < kBChunks) {
        const int r = tid >> 1, h = tid & 1;
        braw = *reinterpret_cast<const uint4*>(a.w + static_cast<long long>(n0 + r) * a.kp
                                               + kt * kBK + h * 16);
      }
    };
    auto store_b = [&](int buf) {
      if (tid < kBChunks) {
        const int r = tid >> 1, h = tid & 1;
        *reinterpret_cast<uint4*>(sB + buf * BN * kRowBytes + r * kRowBytes + h * 16) = braw;
      }
    };
    int acc[2][kNt][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
    load_b(0);
    store_b(0);
    __syncthreads();  // the window and the first weights are in
    for (int kt = 0; kt < n_steps; ++kt) {
      const int cur = kt & 1;
      const bool more = kt + 1 < n_steps;
      if (more) load_b(kt + 1);
      // The step's two 16-channel halves, each inside one tap (16 | C).
      int koff[2];
      bool kin[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = kt * kBK + 16 * h;
        const int tap = kk / C, c = kk - tap * C, dy = tap / k, dx = tap - (tap / k) * k;
        kin[h] = kk < K;
        koff[h] = (dy * hw + dx) * cp + c;
      }
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            af[mt][2 * h + r] = kin[h] ? *reinterpret_cast<const uint32_t*>(
                                             halo + row_off[mt][r] + koff[h])
                                       : 0u;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int8_t* p = sB + cur * BN * kRowBytes + (nt * 8 + g) * kRowBytes + t * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], af[mt], b0, b1);
      }
      if (more) store_b(cur ^ 1);
      __syncthreads();
    }
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int col = n0 + nt * 8 + 2 * t;
      const float ws0 = a.wscale[col], ws1 = a.wscale[col + 1];
      const float b0 = a.bias[col], b1 = a.bias[col + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int oy = oy0 + warp * 2 + mt, ox = ox0 + g + 8 * h;
          if (oy >= a.Ho || ox >= a.Wo) continue;
          const long long m = (static_cast<long long>(n) * a.Ho + oy) * a.Wo + ox;
          store_pair(out, m * a.co + col, dequant(acc[mt][nt][2 * h], scale, ws0, b0),
                     dequant(acc[mt][nt][2 * h + 1], scale, ws1, b1), a.act);
        }
      }
    }
  }
}

template <typename S, int V, int BN>
int launch_halo(const ConvArgs& a, int cp, cudaStream_t stream) {
  const int tiles_w = (a.Wo + kTileW - 1) / kTileW, tiles_h = (a.Ho + kTileH - 1) / kTileH;
  const int smem = halo_bytes(a.k, a.stride, cp) + 2 * BN * kRowBytes;
  static int opted = 0;  // the dynamic shared-memory size this variant may use
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(int8_conv_halo_kernel<S, V, BN>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  const dim3 grid(tiles_w * tiles_h, a.B);
  int8_conv_halo_kernel<S, V, BN><<<grid, kThreads, smem, stream>>>(a, cp, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int V>
int launch_halo_bn(const ConvArgs& a, int bn, int cp, cudaStream_t stream) {
  if (bn == 64) return launch_halo<S, V, 64>(a, cp, stream);
  if (bn == 32) return launch_halo<S, V, 32>(a, cp, stream);
  if (bn == 16) return launch_halo<S, V, 16>(a, cp, stream);
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

// Kernel E. dtype 0: float32, 1: bfloat16 (input and output). vec: input
// elements per load (8, 4 or 1). bn: output channels per block (64, 32, 16;
// divides co). halo_cp: 0 for the direct route; else the halo route, with
// halo_cp bytes per pixel of the quantized window (C a multiple of 16, the
// channels contiguous, 16-byte loads).
int tti_int8_conv2d(const void* x, long long sN, long long sC, long long sH, long long sW,
                    int B, int C, int H, int W, const void* w, int kp, int co, int k, int stride,
                    int pad, const void* wscale, const void* bias, const void* xscale,
                    int per_sample, void* out, int Ho, int Wo, int act, int dtype, int vec,
                    int bn, int halo_cp, void* stream) {
  if (B < 1 || C < 1 || co < 1 || kp % kBK != 0 || kp < k * k * C || co % bn != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a{x, sN, sC, sH, sW, B, C, H, W, static_cast<const int8_t*>(w), kp, co, k, stride,
             pad, static_cast<const float*>(wscale), static_cast<const float*>(bias),
             static_cast<const float*>(xscale), per_sample, out, Ho, Wo, act};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (halo_cp) {
    if (C % 16 != 0 || halo_cp < C || halo_cp % 8 != 0 || sC != 1 || B > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0 && vec == 4) return launch_halo_bn<float, 4>(a, bn, halo_cp, s);
    if (dtype == 1 && vec == 8) return launch_halo_bn<uint16_t, 8>(a, bn, halo_cp, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return launch_conv_vec<float>(a, vec, bn, s);
  if (dtype == 1) return launch_conv_vec<uint16_t>(a, vec, bn, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
