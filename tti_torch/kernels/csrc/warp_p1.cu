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
// bf16: bf16(1/255) is 129/32768, 0.39% above 1/255.) The byte becomes a
// float by bits (2^23 + u, less 2^23), so each value costs two multiplies
// or subtracts and two bf16 roundings, no conversion instruction.
//
// What bounds it: bytes. At the headline shape (B 128, 1080x1920, k 3, hs
// 360, ws = wo = 640) the kept rows are 128*360*5760 B = 265 MB (a 9-byte
// stride touches every 32-byte sector of a kept row, so the whole row is
// read; the two skipped rows are not) and the output 360*3*128*640*2 B =
// 177 MB. W1 is 295 MB dense, but a bilinear pass has at most two non-zero
// taps per (y, o): 0.3% of W1 is non-zero, and each 64-column tile of
// W1[y] has its non-zeros in a band of at most 72 source rows (65 on
// average) of the 640. Counting what these inputs need (the kept rows, the
// output, W1's non-zeros) the bound is about 443 MB, 0.132 ms at 3.35 TB/s;
// the product that remains is a few GFLOP.
//
// The first design (0b702ac) read all of W1 and ran the product on it, one
// block per (y, 32 frames) and one block per SM, its byte phase and its
// product phase in turn. This design:
//
// - Skips W1's zeros exactly. The caller passes a table `window` (hs, wo, 2)
//   int32, for each (y, o) the first source column with a non-zero weight
//   and one past the last ([0, 0) for a dead column), computed from the
//   weights themselves (kernels/warp_p1.py, pass1_window). A work item's k
//   range is the union of its 64 columns' windows; it is cut into chunks of
//   at most kc columns (80 at the headline, one chunk per item there). Rows
//   of W1 outside the union are zero in those columns, so leaving them out
//   changes no float32 sum (the weights are non-negative: no -0 where +0
//   was). The table is independent of the tiling: the kernel derives each
//   item's range from it.
// - The product is transposed: M = 64 output columns o, N = 3F rows (c, f)
//   of F frames, K = the source columns x. wgmma takes 64 rows, and the
//   output columns give them at every batch; N is 3F rounded up to 8 (F =
//   2, 8 or 16 frames by batch, fewer for a very wide k), so batch 1
//   computes 8 rows for its 3 and not the first design's 48. A (W1[y] rows
//   x0.., 64 columns) arrives by TMA with 128-byte swizzle, M-major
//   (wgmma's transposed A); B (the converted frames) is written K-major in
//   8x8 core matrices. wgmma m64nNk16 bf16, float32 accumulators in
//   registers.
// - Overlaps the byte fetch with the product: persistent, warp-specialised
//   blocks of four pipelines, each a producer warp and a consumer
//   warpgroup with its own ring of stages in shared memory (full / empty
//   mbarriers; two stages of 22 KB at the headline). A stage holds one
//   chunk: the W1 box by TMA and each frame's byte span of the kept row by
//   cp.async.bulk (one lane per frame, spans widened to 16 bytes). The
//   consumer converts the spans into B, runs the product, and at the
//   item's last chunk writes the output through shared memory with 16-byte
//   coalesced stores. While one consumer converts or stores, the others'
//   products run and the producers' copies are in flight. More consumers
//   per SM went faster while each item still fit one chunk: on the
//   headline inputs (an H100 at 700 W) four pipelines of 16 frames ran
//   0.197 ms, two of 32 frames 0.218, three of 16 0.237, five of 16 (which
//   fit only with 64-column chunks, two per item) 0.221, and an mma.sync
//   product in wgmma's place 0.199. PERF.md keeps those variants' table.
// - Work item = (y, group of F frames, 64 output columns), walked y-major
//   with the columns fastest: the blocks resident at once cover a few rows
//   y, so the groups of one y read W1[y]'s boxes from L2, and neighbouring
//   items read neighbouring spans of the same kept rows.
//
// The TPU kernel's hs % 8 rule and its 128-column block were Mosaic's tiling
// and are not carried over: every ragged edge (frames past B, columns past
// wo, rows past ws) is masked, zero-filled by TMA or left out of the
// stores, and frames that do not start or end on 16 bytes take their end
// bytes by plain loads. W1 must be 16-byte aligned with wo a multiple of 8
// (what TMA can describe; the pipeline refuses another wo when it is
// built), and k at most 283 (plan()); the wrapper raises on anything else.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kM = 64;          // output columns per work item (wgmma M)
constexpr int kPipes = 4;       // producer warp + consumer warpgroup pairs per block
constexpr int kMaxFrames = 16;  // frames per work item at the largest batches
constexpr int kMaxStages = 4;   // the deepest ring
constexpr int kThreads = 128 * kPipes + 32 * kPipes;
constexpr int kStagePitch = kM + 8;    // epilogue staging row, elements (bank spread)
constexpr int kMaxSmem = 227 * 1024;

// One launch's plan, chosen by the host (plan()).
struct Plan {
  int F, groups, mtiles, units;   // frames per item, groups of frames, column tiles, items
  int kc, pitch, stages;          // source columns per chunk, span bytes per frame, ring depth
  int stage_bytes, w_bytes;       // a stage (1024-aligned), its W1 box
  int b_bytes, pipe_bytes, smem;  // B / staging, one pipeline's region, the block's total
};

struct Args {
  const uint8_t* frames;
  long long total;  // the frames' bytes
  const int* window;
  __nv_bfloat16* out;
  int B, H, W, k, off, ws, wo, bgr_flip;
  float pad_value;
};

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

// W1 box (64 columns o0.., kc rows x0.., row y) -> shared, 128-byte swizzled.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from a 16-byte aligned global address -> shared.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Generic-proxy writes to shared memory (B) made visible to the tensor
// cores' reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A consumer warpgroup's own barrier (ids 1, 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

// wgmma shared-memory descriptor: start, LBO, SBO (bytes, in units of 16)
// and the layout (0: no swizzle, 1: 128-byte swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// D (64 x N, float32) += A (64 x 16, bf16, M-major: imm-trans-a 1) * B (16 x N,
// bf16, K-major); D = A * B when acc is 0.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<24> {
  static __device__ __forceinline__ void mma(float (&d)[12], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
        "}, %12, %13, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(float (&d)[24], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(acc));
  }
};

// The accumulators, tied to their last writer: the compiler must not read
// them before wgmma.wait_group nor move writes past wgmma.fence.
template <int R>
__device__ __forceinline__ void fence_acc(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The three rounded steps of one byte u, as bf16 bits: u is exact in
// float32 (2^23 + u, less 2^23), then times bf16(1/255) rounded to bf16,
// less bf16(pad) rounded to bf16.
__device__ __forceinline__ uint32_t convert_byte(uint32_t u, float inv255, float pad) {
  const float x = __uint_as_float(0x4B000000u | u) - 8388608.0f;
  const float scaled = __bfloat162float(__float2bfloat16_rn(x * inv255));
  return __bfloat16_as_ushort(__float2bfloat16_rn(scaled - pad));
}

// A stage's header, written by the producer before its arrive.
struct Header {
  int x0, nx, flags;  // first source column, columns (0: a dead item), 1 first | 2 last
};

__device__ __forceinline__ void unit_of(const Plan& p, int u, int& y, int& g, int& m) {
  const int per_y = p.groups * p.mtiles;
  y = u / per_y;
  const int r = u - y * per_y;
  g = r / p.mtiles;
  m = r - g * p.mtiles;
}

// Byte offset of frame b's kept row for source row y.
__device__ __forceinline__ long long row_base(const Args& a, int b, int y) {
  return (static_cast<long long>(b) * a.H + a.off + static_cast<long long>(a.k) * y) * 3LL * a.W;
}

// The producer warp of pipeline `pipe`: every item of the pipeline's walk,
// chunk by chunk, into the ring. Lane 0 posts the bytes and issues the W1
// box; lane f issues frame f's span.
__device__ void produce(const CUtensorMap& wmap, const Args& a, const Plan& p,
                        unsigned char* region, int q, int nq, int lane) {
  uint64_t* full = reinterpret_cast<uint64_t*>(region + p.stages * p.stage_bytes + p.b_bytes);
  uint64_t* empty = full + p.stages;
  Header* hdr = reinterpret_cast<Header*>(empty + p.stages);
  int t = 0;
  for (int u = q; u < p.units; u += nq) {
    int y, g, m;
    unit_of(p, u, y, g, m);
    const int o0 = m * kM;
    // The union of the 64 columns' windows, clamped to [0, ws).
    int lo = 0x7FFFFFFF, hi = 0;
    for (int o = o0 + lane; o < min(o0 + kM, a.wo); o += 32) {
      const int2 w =
          *reinterpret_cast<const int2*>(a.window + 2 * (static_cast<long long>(y) * a.wo + o));
      const int l = max(w.x, 0), h = min(w.y, a.ws);
      if (l < h) {
        lo = min(lo, l);
        hi = max(hi, h);
      }
    }
    lo = __reduce_min_sync(0xFFFFFFFFu, lo);
    hi = __reduce_max_sync(0xFFFFFFFFu, hi);
    const int chunks = lo < hi ? (hi - lo + p.kc - 1) / p.kc : 0;
    const int b = g * p.F + lane;
    for (int c = 0; c < max(chunks, 1); ++c, ++t) {
      const int s = t % p.stages, lap = t / p.stages;
      if (lap > 0) mbar_wait(smem_u32(&empty[s]), (lap - 1) & 1);
      const int x0 = chunks ? lo + c * p.kc : 0;
      const int nx = chunks ? min(p.kc, hi - x0) : 0;
      unsigned char* stage = region + s * p.stage_bytes;
      const uint32_t bar = smem_u32(&full[s]);
      // This lane's span: the bytes of columns x0 .. x0 + nx - 1 of frame b,
      // placed in the stage from the 16-byte boundary below its first byte.
      // The 16-byte aligned part that lies inside the frames goes by
      // cp.async.bulk; what is left at either end (at most 15 bytes, only
      // where the frames do not start or end on 16 bytes) by plain loads,
      // before the stage is posted.
      uint32_t bytes = 0;
      const uint8_t* src = nullptr;
      unsigned char* dst = nullptr;
      if (nx > 0 && lane < p.F && b < a.B) {
        const uintptr_t base = reinterpret_cast<uintptr_t>(a.frames);
        const uintptr_t beg =
            base + row_base(a, b, y) + 3ULL * (a.off + static_cast<unsigned long long>(a.k) * x0);
        const uintptr_t end = beg + 3ULL * a.k * (nx - 1) + 3;
        const uintptr_t beg16 = beg & ~uintptr_t{15}, end16 = (end + 15) & ~uintptr_t{15};
        const uintptr_t first16 = (base + 15) & ~uintptr_t{15};
        const uintptr_t last16 = (base + a.total) & ~uintptr_t{15};
        const uintptr_t lo = beg16 > first16 ? beg16 : first16;
        const uintptr_t hi = end16 < last16 ? end16 : last16;
        unsigned char* span = stage + p.w_bytes + lane * p.pitch;  // byte q at span[q - beg16]
        const bool bulk = lo < hi;
        const uintptr_t head = bulk ? lo : end, tail = bulk ? hi : end;
        for (uintptr_t q = beg; q < head; ++q) span[q - beg16] = a.frames[q - base];
        for (uintptr_t q = tail; q < end; ++q) span[q - beg16] = a.frames[q - base];
        // Those writes before any later bulk copy into the same bytes.
        if (beg < head || tail < end) fence_proxy_async();
        if (bulk) {
          bytes = static_cast<uint32_t>(hi - lo);
          src = reinterpret_cast<const uint8_t*>(lo);
          dst = span + (lo - beg16);
        }
      }
      __syncwarp();  // the plain loads land before lane 0 posts the stage
      const uint32_t total = __reduce_add_sync(0xFFFFFFFFu, bytes) + (nx > 0 ? p.w_bytes : 0);
      if (lane == 0) {
        hdr[s] = Header{x0, nx, (c == 0 ? 1 : 0) | (c + 1 >= chunks ? 2 : 0)};
        if (total > 0) {
          mbar_expect_tx(bar, total);
          tma_load_3d(smem_u32(stage), &wmap, o0, x0, y, bar);
        } else {
          mbar_arrive(bar);
        }
      }
      __syncwarp();
      if (bytes > 0) bulk_load(smem_u32(dst), src, bytes, bar);
    }
  }
}

// One consumer warpgroup (thread t of 128): every item of its pipeline's
// walk. N = the product's rows, 3F rounded up to 8.
template <int N>
__device__ void consume(const Args& a, const Plan& p, unsigned char* region, int q, int nq,
                        int wg, int t) {
  uint64_t* full = reinterpret_cast<uint64_t*>(region + p.stages * p.stage_bytes + p.b_bytes);
  const Header* hdr = reinterpret_cast<const Header*>(full + 2 * p.stages);
  uint64_t* empty = full + p.stages;
  unsigned char* bop = region + p.stages * p.stage_bytes;  // B, and the epilogue's staging
  const uint32_t bop_u32 = smem_u32(bop);
  const int F = p.F;
  const int warp = t >> 5, lane = t & 31;
  const float inv255 = __bfloat162float(__float2bfloat16_rn(1.0f / 255.0f));
  const float pad = __bfloat162float(__float2bfloat16_rn(a.pad_value));
  float acc[N / 2];
  int tt = 0;
  for (int u = q; u < p.units; u += nq) {
    int y, g, m;
    unit_of(p, u, y, g, m);
    bool last = false;
    while (!last) {
      const int s = tt % p.stages;
      mbar_wait(smem_u32(&full[s]), (tt / p.stages) & 1);
      const Header h = hdr[s];
      last = (h.flags & 2) != 0;
      if (h.flags & 1) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      }
      const unsigned char* stage = region + s * p.stage_bytes;
      const int nk = round_up(h.nx, 16);
      if (h.nx > 0) {
        // B: task (frame f, 8 source columns j) -> three 16-byte rows of
        // core matrices, one per channel. Frames past B convert whatever
        // the span buffer holds: those rows feed only columns that are not
        // stored.
        const long long col = 3LL * (a.off + static_cast<long long>(a.k) * h.x0);
        for (int task = t; task < F * (nk / 8); task += 128) {
          const int f = task % F, j = task / F;
          const int shift = static_cast<int>(
              (reinterpret_cast<uintptr_t>(a.frames) + row_base(a, g * F + f, y) + col) & 15);
          const unsigned char* px = stage + p.w_bytes + f * p.pitch + shift + 24 * a.k * j;
          uint32_t v[3][4];
#pragma unroll
          for (int i = 0; i < 8; i += 2) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const int ch = a.bgr_flip ? 2 - c : c;
              const uint32_t lo16 = convert_byte(px[3 * a.k * i + ch], inv255, pad);
              const uint32_t hi16 = convert_byte(px[3 * a.k * (i + 1) + ch], inv255, pad);
              v[c][i / 2] = lo16 | (hi16 << 16);
            }
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int n = c * F + f;
            *reinterpret_cast<uint4*>(bop + j * (N * 16) + (n >> 3) * 128 + (n & 7) * 16) =
                make_uint4(v[c][0], v[c][1], v[c][2], v[c][3]);
          }
        }
        fence_proxy_async();
        wg_sync(wg);
        const uint32_t w_u32 = smem_u32(stage);
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        for (int kk = 0; kk < nk / 16; ++kk) {
          // A: 16 rows of the swizzled box, 8-row groups 1024 bytes apart.
          // The box is one 64-column atom wide, so the atom stride is never
          // used: both offsets are 1024, whichever one the layout reads.
          const uint64_t da = smem_desc(w_u32 + kk * 16 * 128, 1024, 1024, 1);
          // B: two k-groups of 8, N * 16 bytes apart; 8-row groups 128 apart.
          const uint64_t db = smem_desc(bop_u32 + 2 * kk * N * 16, N * 16, 128, 0);
          Wgmma<N>::mma(acc, da, db, 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(acc);
      }
      // Every warp is past its product and its reads of the stage.
      wg_sync(wg);
      if (t == 0) mbar_arrive(smem_u32(&empty[s]));
      ++tt;
    }

    // Epilogue: accumulator (row o, column n) -> staging[n][o] in bf16, then
    // each row n = (c, f) of 64 columns to out[y, c, g F + f, o0 ..] in
    // 16-byte stores. Accumulator i of a thread: n-group i / 4, row
    // 16 warp + lane / 4 (+ 8 for i % 4 >= 2), column 2 (lane % 4) (+ 1 odd).
    __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(bop);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int o = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int n = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      stg[n * kStagePitch + o] = __float2bfloat16_rn(acc[i]);
    }
    wg_sync(wg);
    const int o0 = m * kM;
    for (int task = t; task < 3 * F * (kM / 8); task += 128) {
      const int n = task / (kM / 8), j = task % (kM / 8);
      const int c = n / F, b = g * F + n % F, o = o0 + 8 * j;
      if (b < a.B && o < a.wo) {
        const uint4 v = *reinterpret_cast<const uint4*>(stg + n * kStagePitch + 8 * j);
        *reinterpret_cast<uint4*>(a.out + ((static_cast<long long>(y) * 3 + c) * a.B + b) * a.wo
                                  + o) = v;
      }
    }
    wg_sync(wg);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    warp_p1_kernel(const __grid_constant__ CUtensorMap wmap, const Args a, const Plan p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x;
  // B starts zero: rows past 3F are never written and must add nothing.
  for (int pipe = 0; pipe < kPipes; ++pipe) {
    uint4* bop = reinterpret_cast<uint4*>(smem + pipe * p.pipe_bytes + p.stages * p.stage_bytes);
    for (int i = tid; i < p.b_bytes / 16; i += kThreads) bop[i] = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int pipe = 0; pipe < kPipes; ++pipe) {
      uint64_t* bars = reinterpret_cast<uint64_t*>(smem + pipe * p.pipe_bytes
                                                   + p.stages * p.stage_bytes + p.b_bytes);
      for (int s = 0; s < 2 * p.stages; ++s) mbar_init(smem_u32(&bars[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = tid >> 5;
  const int nq = kPipes * gridDim.x;
  if (warp >= 4 * kPipes) {
    const int pipe = warp - 4 * kPipes;
    produce(wmap, a, p, smem + pipe * p.pipe_bytes, kPipes * blockIdx.x + pipe, nq, tid & 31);
  } else {
    const int pipe = warp >> 2;
    consume<N>(a, p, smem + pipe * p.pipe_bytes, kPipes * blockIdx.x + pipe, nq, pipe,
               tid & 127);
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (the library links only cudart).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

constexpr int kErrTensorMap = 100000;  // + the CUresult of a refused tensor map

// The frames per item for this batch, and the chunk width and ring depth
// that fit: the widest chunk first (one chunk per item at the headline),
// then the deepest ring, two stages at least. A decimation too wide for
// that takes fewer frames per item, so whether a k fits does not depend on
// the batch: every k up to 283 fits with 2 frames, 16 columns and two
// stages (MAX_K in kernels/warp_p1.py).
bool plan(int B, int k, int hs, int wo, Plan& p) {
  for (p.F = B <= 2 ? 2 : B <= 8 ? 8 : kMaxFrames;; p.F = p.F > 8 ? 8 : 2) {
    const int N = round_up(3 * p.F, 8);
    p.groups = (B + p.F - 1) / p.F;
    p.mtiles = (wo + kM - 1) / kM;
    const long long units = static_cast<long long>(hs) * p.groups * p.mtiles;
    if (units > 0x7FFFFFFF) return false;
    p.units = static_cast<int>(units);
    for (int kc = 80; kc >= 16; kc -= 16) {
      for (int stages = kMaxStages; stages >= 2; --stages) {
        p.kc = kc;
        p.stages = stages;
        p.pitch = round_up(3 * k * (kc - 1) + 33, 16);
        p.w_bytes = kc * 128;
        p.stage_bytes = round_up(p.w_bytes + p.F * p.pitch, 1024);
        const int staging = N * kStagePitch * 2;
        p.b_bytes = round_up(kc * N * 2 > staging ? kc * N * 2 : staging, 16);
        const int tail = 2 * stages * 8 + stages * static_cast<int>(sizeof(Header));
        p.pipe_bytes = round_up(stages * p.stage_bytes + p.b_bytes + tail, 1024);
        p.smem = kPipes * p.pipe_bytes + 1024;  // + the alignment slack
        if (p.smem <= kMaxSmem) return true;
      }
    }
    if (p.F == 2) return false;
  }
}

template <int N>
int launch(const CUtensorMap& map, const Args& a, const Plan& p, cudaStream_t stream) {
  static int opted = 0;  // the dynamic shared-memory size this variant may use
  if (p.smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        warp_p1_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = p.smem;
  }
  int dev = 0, sms = 0, occ = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, warp_p1_kernel<N>, kThreads,
                                                       p.smem) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int want = (p.units + kPipes - 1) / kPipes;
  const int grid = want < sms * occ ? want : sms * occ;
  warp_p1_kernel<N><<<grid, kThreads, p.smem, stream>>>(map, a, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// frames (B, H, W, 3) u8 of total_bytes bytes; w1 (hs, ws, wo) bf16,
// 16-byte aligned, wo a multiple of 8; window (hs, wo, 2) int32 covering
// every non-zero of w1 (not checked here); out (hs, 3, B, wo) bf16.
// Returns cudaGetLastError() of the launch, cudaErrorInvalidValue (1) for
// what the kernel does not take or when no plan fits in shared memory, or
// kErrTensorMap + the CUresult of a refused tensor map.
extern "C" int tti_warp_pass1_decimated(const void* frames, long long total_bytes, const void* w1,
                                        const void* window, void* out, int B, int H, int W, int k,
                                        int off, int hs, int ws, int wo, float pad_value,
                                        int bgr_flip, void* stream) {
  if (B < 1 || hs < 1 || ws < 1 || wo < 8 || wo % 8 != 0
      || reinterpret_cast<uintptr_t>(w1) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  if (!plan(B, k, hs, wo, p)) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  memset(&map, 0, sizeof map);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(wo), static_cast<cuuint64_t>(ws),
                              static_cast<cuuint64_t>(hs)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(wo) * 2,
                                 static_cast<cuuint64_t>(ws) * wo * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kM), static_cast<cuuint32_t>(p.kc), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w1), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kErrTensorMap + static_cast<int>(r);
  const Args a{static_cast<const uint8_t*>(frames), total_bytes, static_cast<const int*>(window),
               static_cast<__nv_bfloat16*>(out), B, H, W, k, off, ws, wo, bgr_flip, pad_value};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (round_up(3 * p.F, 8)) {
    case 8: return launch<8>(map, a, p, s);
    case 24: return launch<24>(map, a, p, s);
    case 48: return launch<48>(map, a, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
