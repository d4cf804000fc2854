// Kernel G: the epilogue of the port's float convolutions, the bias and SiLU
// in one pass over the convolution's output.
//
// Replaces no pallas_call. tti's float Conv block, its Segment's exit 1x1
// convs and its proto head's deconv (tti/model/layers.py, tti/model/yolo.py)
// leave the bias add and SiLU to XLA, which fuses them into the convolution.
// The port's convolutions are cuDNN's, through F.conv2d / F.conv_transpose2d,
// which run the convolution without its bias and then add it with
// output.add_(bias.reshape(1, C, 1, 1)); F.silu followed. On a channels_last
// output that broadcast add takes PyTorch's generic, non-vectorised
// elementwise kernel, and each of the two passes reads and writes every
// activation.
//
// What it computes, for y (N, C, H, W) and bias (C,), both of y's dtype
// (bf16 or float32):
//   out = silu(round(y + bias)), or round(y + bias) without the activation,
// in that route's arithmetic: the sum in float, rounded to y's dtype (add_),
// then x / (1 + expf(-x)) in float (F.silu's functor), rounded again. expf is
// the CUDA math library's accurate one and the quotient IEEE's, as PyTorch's
// own kernels are built (no fast math), so the bits are that route's.
//
// What bounds it on this card: bytes. Each activation is read once and
// written once (2 + 2 bytes in bf16): at the deploy step's batch 128, 37.9 M
// activations a frame in 76 layers are 19.4 GB, 5.8 ms at 3.35 TB/s. The
// float work, an expf and an IEEE division per element (a MUFU ex2 and a
// MUFU rcp), has to hide under the loads: about 25 instructions an element,
// 200 a 16-byte vector, against the 2.5 cycles an SM has for each vector at
// the card's bandwidth (320 lane-instructions).
//
// Design: one grid-stride pass over the flat tensor in 16-byte vectors (8
// bf16 or 4 float32), 256 threads a block, as many blocks as the SMs hold at
// once (one wave over the card; the wrapper asks tti_bias_act_blocks_per_sm),
// two vectors in flight per thread and iteration. Element i's channel is (i / inner) % C: inner = 1 for
// a channels_last output, H * W for an NCHW-contiguous one. A thread tracks
// its vector's channel, and its offset in the channel's plane, by adding the
// loop's fixed step, so the loop divides nothing. Each block copies the C
// biases to shared memory once. Routes (the wrapper picks one from the
// layout, C, the element count and the addresses; conv_epilogue.py, plan):
//   kChannels  channels_last, C a multiple of the vector: a vector holds
//              consecutive channels from a multiple of the vector; their
//              biases are one 16-byte shared-memory read;
//   kWrapped   channels_last, C not a multiple of the vector (the class exit
//              conv, C = 2), the count a multiple: a bias per element, the
//              channel wrapping at C;
//   kPlane     NCHW-contiguous, H * W a multiple of the vector: a vector lies
//              in one channel's plane, one bias;
//   kScalar    anything else (a ragged count, an odd plane, an unaligned
//              address): element by element, the same walk with a vector of 1.
// The kernel synchronises with nothing, allocates nothing and reads nothing
// back: the wrapper allocates the output, so a CUDA graph can capture it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 0, kWrapped = 1, kPlane = 2, kScalar = 3;
constexpr int kMaxBiasBytes = 48 * 1024;  // the biases' shared copy, without an opt-in

struct Bf16 {
  using Bits = uint16_t;
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float widen(uint16_t b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  static __device__ __forceinline__ uint16_t round(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

struct F32 {
  using Bits = uint32_t;
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float widen(uint32_t b) { return __uint_as_float(b); }
  static __device__ __forceinline__ uint32_t round(float x) { return __float_as_uint(x); }
};

// add_ then F.silu, element by element, as PyTorch's two functors compute.
template <class D, bool ACT>
__device__ __forceinline__ typename D::Bits epilogue(typename D::Bits y, typename D::Bits b) {
  typename D::Bits r = D::round(D::widen(y) + D::widen(b));
  if (ACT) {
    const float x = D::widen(r);
    r = D::round(x / (1.0f + expf(-x)));
  }
  return r;
}

// Where a vector starts: its offset in its channel's plane and its channel.
// Moving by the loop's step of e elements adds (e % inner, (e / inner) % C),
// with a carry from the offset into the channel.
struct Pos {
  long long o;
  int c;
};

struct Step {
  long long o;
  int c;
};

__device__ __forceinline__ Pos locate(long long e, long long inner, int c) {
  return {e % inner, static_cast<int>((e / inner) % c)};
}

__device__ __forceinline__ void advance(Pos& p, Step s, long long inner, int c) {
  p.o += s.o;
  p.c += s.c;
  if (p.o >= inner) {
    p.o -= inner;
    ++p.c;
  }
  if (p.c >= c) p.c -= c;  // p.c < 2c: (c - 1) + (c - 1) + 1
}

template <class D, int ROUTE, bool ACT>
__device__ __forceinline__ void apply(const typename D::Bits* __restrict__ y,
                                      typename D::Bits* __restrict__ out,
                                      const typename D::Bits* bias, long long v, Pos p, int c) {
  using Bits = typename D::Bits;
  if constexpr (ROUTE == kScalar) {
    out[v] = epilogue<D, ACT>(y[v], bias[p.c]);
  } else {
    union Pack {
      uint4 u;
      Bits e[D::kVec];
    };
    Pack in, res;
    in.u = reinterpret_cast<const uint4*>(y)[v];
    if constexpr (ROUTE == kChannels) {
      Pack b;
      b.u = *reinterpret_cast<const uint4*>(bias + p.c);
#pragma unroll
      for (int j = 0; j < D::kVec; ++j) res.e[j] = epilogue<D, ACT>(in.e[j], b.e[j]);
    } else if constexpr (ROUTE == kWrapped) {
      int cj = p.c;
#pragma unroll
      for (int j = 0; j < D::kVec; ++j) {
        res.e[j] = epilogue<D, ACT>(in.e[j], bias[cj]);
        cj = cj + 1 == c ? 0 : cj + 1;
      }
    } else {  // kPlane
      const Bits b = bias[p.c];
#pragma unroll
      for (int j = 0; j < D::kVec; ++j) res.e[j] = epilogue<D, ACT>(in.e[j], b);
    }
    reinterpret_cast<uint4*>(out)[v] = res.u;
  }
}

template <class D, int ROUTE, bool ACT>
__global__ void __launch_bounds__(kThreads)
    bias_act_pointwise(const typename D::Bits* __restrict__ y,
                       const typename D::Bits* __restrict__ bias,
                       typename D::Bits* __restrict__ out, long long units, long long inner,
                       int c) {
  using Bits = typename D::Bits;
  constexpr int kVec = ROUTE == kScalar ? 1 : D::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  Bits* sb = reinterpret_cast<Bits*>(smem);
  for (int i = threadIdx.x; i < c; i += kThreads) sb[i] = bias[i];
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= units) return;
  // Two vectors an iteration, v and v + stride; each moves 2 * stride.
  const long long e2 = 2 * stride * kVec;
  const Step step = {e2 % inner, static_cast<int>((e2 / inner) % c)};
  Pos p0 = locate(v * kVec, inner, c);
  Pos p1 = locate((v + stride) * kVec, inner, c);
  for (; v + stride < units; v += 2 * stride) {
    apply<D, ROUTE, ACT>(y, out, sb, v, p0, c);
    apply<D, ROUTE, ACT>(y, out, sb, v + stride, p1, c);
    advance(p0, step, inner, c);
    advance(p1, step, inner, c);
  }
  if (v < units) apply<D, ROUTE, ACT>(y, out, sb, v, p0, c);
}

size_t smem_bytes(int c, int esize) { return (static_cast<size_t>(c) * esize + 15) / 16 * 16; }

template <class D, int ROUTE, bool ACT>
int route_call(bool occupancy, const void* y, const void* bias, void* out, long long units,
               long long inner, int c, int blocks, cudaStream_t stream) {
  using Bits = typename D::Bits;
  const size_t smem = smem_bytes(c, sizeof(Bits));
  if (occupancy) {  // blocks per SM at this shared memory: returned, or a negative error
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, bias_act_pointwise<D, ROUTE, ACT>, kThreads, smem);
    return err == cudaSuccess ? n : -static_cast<int>(err);
  }
  bias_act_pointwise<D, ROUTE, ACT><<<blocks, kThreads, smem, stream>>>(
      static_cast<const Bits*>(y), static_cast<const Bits*>(bias), static_cast<Bits*>(out),
      units, inner, c);
  return static_cast<int>(cudaGetLastError());
}

template <class D, int ROUTE>
int act_call(bool occupancy, const void* y, const void* bias, void* out, long long units,
             long long inner, int c, int act, int blocks, cudaStream_t stream) {
  return act ? route_call<D, ROUTE, true>(occupancy, y, bias, out, units, inner, c, blocks, stream)
             : route_call<D, ROUTE, false>(occupancy, y, bias, out, units, inner, c, blocks,
                                           stream);
}

template <class D>
int dtype_call(bool occupancy, const void* y, const void* bias, void* out, long long units,
               long long inner, int c, int route, int act, int blocks, cudaStream_t stream) {
  switch (route) {
    case kChannels:
      return act_call<D, kChannels>(occupancy, y, bias, out, units, inner, c, act, blocks, stream);
    case kWrapped:
      return act_call<D, kWrapped>(occupancy, y, bias, out, units, inner, c, act, blocks, stream);
    case kPlane:
      return act_call<D, kPlane>(occupancy, y, bias, out, units, inner, c, act, blocks, stream);
    default:
      return act_call<D, kScalar>(occupancy, y, bias, out, units, inner, c, act, blocks, stream);
  }
}

// One instantiation per dtype, route and activation; occupancy: the blocks
// an SM holds instead of a launch.
int call(bool occupancy, const void* y, const void* bias, void* out, long long units,
         long long inner, int c, int dtype, int route, int act, int blocks, void* stream) {
  const int esize = dtype == 1 ? 2 : 4;
  if (c < 1 || c > kMaxBiasBytes / esize || (dtype != 0 && dtype != 1) || route < kChannels ||
      route > kScalar || (!occupancy && (units < 1 || inner < 1 || blocks < 1)))
    return occupancy ? -static_cast<int>(cudaErrorInvalidValue)
                     : static_cast<int>(cudaErrorInvalidValue);
  return dtype == 1 ? dtype_call<Bf16>(occupancy, y, bias, out, units, inner, c, route, act,
                                       blocks, static_cast<cudaStream_t>(stream))
                    : dtype_call<F32>(occupancy, y, bias, out, units, inner, c, route, act,
                                      blocks, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// The most channels one launch takes: the biases' shared copy fits the
// default 48 KB of dynamic shared memory.
int tti_bias_act_max_channels(int esize) { return kMaxBiasBytes / esize; }

// Blocks of the (dtype, route, act) kernel that one SM holds with C biases
// in shared memory; a negative cudaError if the query fails.
int tti_bias_act_blocks_per_sm(int c, int dtype, int route, int act) {
  return call(true, nullptr, nullptr, nullptr, 0, 0, c, dtype, route, act, 0, nullptr);
}

// y, out: the N * C * H * W elements of one dense layout (channels_last:
// inner = 1; NCHW: inner = H * W); bias: C elements of y's dtype (dtype 0
// float32, 1 bf16); route: kChannels 0, kWrapped 1, kPlane 2, kScalar 3.
// units: 16-byte vectors of the flat tensor on the vector routes, elements
// on kScalar. blocks: the grid (the wrapper's one wave over the card).
// Returns the launch's cudaError (cudaErrorInvalidValue for arguments
// outside these ranges).
int tti_bias_act(const void* y, const void* bias, void* out, long long units, long long inner,
                 int c, int dtype, int route, int act, int blocks, void* stream) {
  return call(false, y, bias, out, units, inner, c, dtype, route, act, blocks, stream);
}

}  // extern "C"
