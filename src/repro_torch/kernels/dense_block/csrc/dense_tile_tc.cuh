// The stack forward's wide layers on the tensor cores, for Hopper (sm_90a):
// z = a[:, k_off:k_off + K] @ W + b, y = act(z), in split-precision TF32
// (3xTF32) on wgmma, with fp32 accumulation.
//
// Replaces, on stack.py's _kernel_forward path for M >= 128 and U >= 128
// (stack.py::_fwd_kernel, the reference's Pallas forward): the register
// tile of dense_tile_rt.cuh, fp32 FMAs outside the tensor cores, which read
// 9.3% of 495 TFLOP/s at fig3's and Fig. 4's layers: ~46 TFLOP/s, ~69% of
// the card's 67 TFLOP/s SIMT fp32 peak, the ceiling of that design.
//
// What bounds it: 3xTF32 is three TF32 products for each fp32 product, so
// its ceiling is 495 / 3 = 165 TFLOP/s of fp32 work, 2.5x the SIMT peak
// (a stack_fwd_roofline of at most 33.3% against 495). Each operand is
// split hi + lo; hi.hi + hi.lo + lo.hi is accumulated (lo.lo, below 2^-21
// of each product, is dropped), and the tensor core's sums are added into
// fp32 registers on the CUDA cores every half stage (they round toward
// zero): the products stay fp32-accurate, where single-pass TF32 (2^-11)
// would miss the 1e-4 bar against the fp32 reference and the judge's
// limits.
//
// The operand arrangement. tf32 wgmma reads B only K-major from shared
// memory, and A K-major from shared memory or from registers. W_i is
// stored (K, N), N contiguous, K-major in neither role; the layer's input
// (M, K) row-major is K-major. So the kernel computes the transposed
// product z^T = W^T . input^T:
//   B = the input tile [128 rows][32 k] per stage, loaded by TMA with the
//       128-byte swizzle wgmma reads (raw fp32: the tensor core drops the
//       low 13 bits, so hi is x truncated); three converter warps write
//       lo = rna(x - trunc(x)) once a stage into a second buffer of the
//       same layout.
//   A = the W tile, loaded by TMA as four [32 k][32 n] swizzled boxes, read
//       into registers in wgmma's A-fragment layout and split there, hi =
//       rna(w), lo = rna(w - hi). A warp's loads are conflict-free: row r
//       of a warp's 16 A rows (the fragment's groupID g and g + 8) is the
//       feature (g & 3) + 4 (2 (warp & 1) + (r >= 8)) + 16 (g >> 2) of its
//       box, so the 32 lanes of a load hit 8 distinct 16-byte chunks
//       (after the swizzle) x 4 words.
// The accumulator is then z^T: a thread holds features (its A rows) by
// batch rows (wgmma's N). The epilogue adds the bias, stages z through
// shared memory as [row][feature] and writes z, y = act(z) and a second
// copy of y row-major, the layouts the backward and the next layer read,
// 16 bytes at a time where a destination allows it. Every layer reads its
// input row-major: densenet's padded copy of the stream, mlp's and d2rl's
// ping-pong buffers (d2rl's [h | x] slabs), so the transposed copies and
// init launches of the register tile's path are not needed.
//
// The crossover with the register tile (stack.py's plan_fwd and
// plan_fwd_stack, from the card sweep at M = 256): this tile wins every
// layer but a thin first one (K = d0 = 3 or 4: a fixed cost a block, ~11
// us against ~6) from U = 256 up, solo and at 5 members, and ties at U =
// 128. A stack keeps one tile: this one from U = 128 with U a multiple of
// 4, unless its first layer is thin and its other layers hold under 2.5e7
// multiply-adds over all members (at M = 256 the 2- and 3-layer stacks of
// U = 128, the 2-layer ones of U = 256 solo), which keeps the register
// tile.
//
// A block: 384 threads. Warp 0 is the producer (one lane issues the TMA
// loads into a ring of kStages stages, 48 KB each: W 16 KB, x 16 KB, lo 16
// KB); warps 1-3 convert; warps 4-11 are two consumer warpgroups, each 64
// features x 128 rows (m64n128k8, 64 accumulators a thread) of the block's
// 128 x 128 tile, sharing its B. Barriers a stage: `full` (TMA bytes),
// `conv` (the 96 converters), `empty` (one arrival a consumer warpgroup
// when its wgmmas of the stage are done). TMA zero-fills outside the
// tensors, so a ragged M or N and a K that is not a multiple of 32 (K = 3
// or 4 at a pendulum's first layer: one zero-filled step) need no masks in
// the main loop.
//
// A split of K across gridDim.y writes its partial tile to a workspace in
// the threads' register order; the tile's last block (an integer atomic
// counts them) sums the partials in split order and runs the epilogue, and
// resets its counter to 0: results are bitwise the same from call to call.
// A member launch (gridDim.z = E) gives block z member z's operands (the
// TMA maps' third coordinate; a W shared by the members at coordinate 0)
// and its own partials and counters: member e is bitwise a solo launch of
// the same plan on its operands.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_tile.cuh"

namespace dense_tile_tc {

constexpr int kBM = 128;             // batch rows a block (wgmma's N)
constexpr int kBN = 128;             // features a block (2 x wgmma's M)
constexpr int kBK = 32;              // K a stage: one 128-byte row of fp32
constexpr int kStages = 4;
constexpr int kThreads = 384;
constexpr int kConverters = 96;      // warps 1-3
constexpr int kConsumers = 256;      // warps 4-11
constexpr int kBox = 32;             // a W box: 32 features (128 bytes)
constexpr int kWBytes = kBK * kBN * 4;
constexpr int kXBytes = kBM * kBK * 4;
constexpr int kStageBytes = kWBytes + 2 * kXBytes;
constexpr int kEpiLd = kBN + 4;      // the epilogue's staging row stride
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 128;
static_assert(2 * kBM * kEpiLd * 4 <= kStages * kStageBytes,
              "the epilogue's staging (z and y) fits in the ring");

struct Args {
  const float* bias;
  float* z; long long ldz;             // pre-activation, or null
  float* y; long long ldy;             // act(z), or null
  float* y2; long long ldy2;           // a second copy of act(z), or null
  float* ws;                           // (splits, tiles, kBM * kBN), or null
  int* counters;                       // one per tile, all zero
  int m, n, k, k_off, act, splits, chunks_per_split;
  int w_member;                        // 1: W's map has a member axis
  bool vz, vy, vy2;                    // 16-byte stores of z, y, y2
};

// a member launch's strides in elements (0: shared by every member)
struct Strides {
  long long bias, z, y, y2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::
               "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::
               "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// a 3-D TMA tile load into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::
      "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(c2), "r"(smem_u32(bar)) : "memory");
}

// generic-proxy writes to shared memory, ordered before the async proxy's
// (wgmma's) reads that follow a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// x rounded to TF32 (10 mantissa bits), ties away from zero: cvt.rna's
// rounding on the integer pipe (the bits with half an ulp added, the low
// 13 cleared; a carry moves into the exponent as it should)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the wgmma descriptor of a K-major tile with the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator accesses across the fences
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128, fp32) = a (64 x 8 tf32, registers) . b (8 x 128 tf32,
// K-major in shared memory at `desc`), + d unless `add` is 0
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
}

// the feature (within its 32-wide W box) of A row `row` (0..15) of warp
// `warp` of a consumer warpgroup: see the note above
__device__ __forceinline__ int box_feature(int warp, int row) {
  const int g = row & 7;
  return (g & 3) + 4 * (2 * (warp & 1) + (row >> 3)) + 16 * (g >> 2);
}

// one row's four values at `gn` .. `gn + 3` (masked at n) into dst
__device__ __forceinline__ void store4(float* dst, bool vec, int gn, int n,
                                       const float4& v) {
  if (vec && gn + 3 < n) {
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gn + j < n) dst[j] = e[j];
  }
}

__device__ __forceinline__ void tc_body(const CUtensorMap* xmap,
                                        const CUtensorMap* wmap, Args p,
                                        int member) {
  // the ring from the first 1024-byte boundary (the 128-byte swizzle's
  // period), offset by pointer arithmetic on the shared array: the
  // compiler keeps every access below a shared-memory one
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + kStages * kStageBytes);
  uint64_t* full = bars;
  uint64_t* conv = bars + kStages;
  uint64_t* empty = bars + 2 * kStages;
  int* s_last = reinterpret_cast<int*>(bars + 3 * kStages);
  auto w_of = [&](int s) { return base + s * kStageBytes; };
  auto x_of = [&](int s) { return base + s * kStageBytes + kWBytes; };
  auto lo_of = [&](int s) {
    return base + s * kStageBytes + kWBytes + kXBytes;
  };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ct = tid - 128;                 // a consumer's index, 0 .. 255
  const int m_tiles = (p.m + kBM - 1) / kBM;
  const int tile = blockIdx.x;
  const int m0 = (tile % m_tiles) * kBM, n0 = (tile / m_tiles) * kBN;
  const int split = blockIdx.y;
  const int chunks = (p.k + kBK - 1) / kBK;
  const int c_begin = split * p.chunks_per_split;
  const int steps = min(chunks, c_begin + p.chunks_per_split) - c_begin;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&conv[s], kConverters);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (warp == 0) {                                    // the producer
    if (lane == 0) {
      const int wc = member * p.w_member;
      for (int it = 0; it < steps; ++it) {
        const int s = it % kStages, ph = (it / kStages) & 1;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], kWBytes + kXBytes);
        const int kk = (c_begin + it) * kBK;
#pragma unroll
        for (int b = 0; b < kBN / kBox; ++b)
          tma_load(w_of(s) + b * kBK * kBox * 4, wmap, n0 + b * kBox, kk, wc,
                   &full[s]);
        tma_load(x_of(s), xmap, p.k_off + kk, m0, member, &full[s]);
      }
    }
    return;
  }
  if (warp < 4) {                                     // the converters
    const int cv = tid - 32;
    for (int it = 0; it < steps; ++it) {
      const int s = it % kStages, ph = (it / kStages) & 1;
      mbar_wait(&full[s], ph);
      const float4* xs = reinterpret_cast<const float4*>(x_of(s));
      float4* lo = reinterpret_cast<float4*>(lo_of(s));
      for (int i = cv; i < kXBytes / 16; i += kConverters) {
        const float4 v = xs[i];
        auto low = [](float x) {
          const float t = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
          return __uint_as_float(to_tf32(x - t));
        };
        lo[i] = make_float4(low(v.x), low(v.y), low(v.z), low(v.w));
      }
      fence_proxy_async();
      mbar_arrive(&conv[s]);
    }
    return;
  }

  // the consumers: warpgroup wg owns the block's features [64 wg, 64 wg +
  // 64), its warp wl A rows 16 wl .. 16 wl + 15 of them
  const int wg = ct / 128, wl = (ct / 32) % 4;
  const int g = lane / 4, q = lane % 4;
  const int box = 2 * wg + wl / 2;
  const int f0 = box_feature(wl, g), f1 = box_feature(wl, g + 8);
  // acc: the sum over K, in fp32 on the CUDA cores (rounded to nearest);
  // part: half a stage's products, which the tensor core sums rounding
  // toward zero at each k8 step, a bias that shrinks every sum (on the
  // card, max error over max|z| at K = 2048: 1.6e-5 when the tensor core
  // summed all of K, 3.2e-7 when it summed a stage's 12 products, 2.0e-7
  // as here; the register tile 6.8e-7). The 2^-11-small terms go first,
  // into a part that starts at 0, and the two large ones last.
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int s = it % kStages, ph = (it / kStages) & 1;
    mbar_wait(&full[s], ph);
    mbar_wait(&conv[s], ph);
    const float* wb = reinterpret_cast<const float*>(w_of(s)) +
                      box * kBK * kBox;
    const uint64_t d_hi = smem_desc(x_of(s)), d_lo = smem_desc(lo_of(s));
    // two halves of the stage's four k8 steps, each its A fragments
    // loaded, split and multiplied (the registers of a half are reused
    // once its wgmmas are done)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // fragment register r: A row g (r even) or g + 8, k column q or
          // q + 4 (r >= 2)
          const int krow = 8 * (2 * half + kh) + q + 4 * (r >> 1);
          const int f = (r & 1) ? f1 : f0;
          const float w =
              wb[krow * kBox + (((f >> 2) ^ (krow & 7)) << 2) + (f & 3)];
          a_hi[kh][r] = to_tf32(w);
          a_lo[kh][r] = to_tf32(w - __uint_as_float(a_hi[kh][r]));
        }
      }
      pin(part);
      wgmma_fence();
      // +32 bytes a k8 step inside the 128-byte swizzled rows
      const uint64_t k0 = 4 * half, k1 = 4 * half + 2;
      wgmma_tf32(part, a_lo[0], d_hi + k0, 0);
      wgmma_tf32(part, a_hi[0], d_lo + k0, 1);
      wgmma_tf32(part, a_lo[1], d_hi + k1, 1);
      wgmma_tf32(part, a_hi[1], d_lo + k1, 1);
      wgmma_tf32(part, a_hi[0], d_hi + k0, 1);
      wgmma_tf32(part, a_hi[1], d_hi + k1, 1);
      wgmma_commit();
      wgmma_wait0();
      pin(part);
      if (half == 1 && ct % 128 == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
  }

  // ---- epilogue (consumers only: named barrier 1 of 256 threads) -------
  const int tiles = gridDim.x;
  if (p.splits > 1) {
    float4* mine = reinterpret_cast<float4*>(p.ws) +
                   (static_cast<long long>(split) * tiles + tile) * 16 *
                       kConsumers + ct;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mine[j * kConsumers] =
          make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                      acc[4 * j + 3]);
    __threadfence();                          // partials visible device-wide
    named_sync(1, kConsumers);
    if (ct == 0) *s_last = atomicAdd(&p.counters[tile], 1) == p.splits - 1;
    named_sync(1, kConsumers);
    if (!*s_last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int sp = 0; sp < p.splits; ++sp) {
      const float4* src = reinterpret_cast<const float4*>(p.ws) +
                          (static_cast<long long>(sp) * tiles + tile) * 16 *
                              kConsumers + ct;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float4 v = __ldcg(src + j * kConsumers);
        acc[4 * j] += v.x; acc[4 * j + 1] += v.y;
        acc[4 * j + 2] += v.z; acc[4 * j + 3] += v.w;
      }
    }
    if (ct == 0) p.counters[tile] = 0;        // leave the counters reusable
  }

  // z^T fragment -> z and y = act(z) tiles [row][feature] in shared
  // memory, over the ring once the other warpgroup's wgmmas have read it;
  // the activation in registers, 64 independent values a thread
  named_sync(1, kConsumers);
  float* zt = reinterpret_cast<float*>(base);
  float* yt = zt + kBM * kEpiLd;
  const int fl0 = box * kBox + f0, fl1 = box * kBox + f1;
  const float b0 = n0 + fl0 < p.n ? p.bias[n0 + fl0] : 0.f;
  const float b1 = n0 + fl1 < p.n ? p.bias[n0 + fl1] : 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[4 * j] += b0; acc[4 * j + 1] += b0;
    acc[4 * j + 2] += b1; acc[4 * j + 3] += b1;
  }
  auto stage = [&](float* t) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int r = 8 * j + 2 * q;
      t[r * kEpiLd + fl0] = acc[4 * j];
      t[(r + 1) * kEpiLd + fl0] = acc[4 * j + 1];
      t[r * kEpiLd + fl1] = acc[4 * j + 2];
      t[(r + 1) * kEpiLd + fl1] = acc[4 * j + 3];
    }
  };
  stage(zt);
  const int act = p.act;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = dense_tile::apply_act(acc[i], act);
  stage(yt);
  named_sync(1, kConsumers);
  float* const z = p.z;
  float* const y = p.y;
  float* const y2 = p.y2;
#pragma unroll 4
  for (int j = 0; j < kBM * kBN / 4 / kConsumers; ++j) {
    const int i = ct + j * kConsumers;
    const int r = i / (kBN / 4), c = 4 * (i % (kBN / 4));
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= p.m || gn >= p.n) continue;
    const float4 zv = *reinterpret_cast<const float4*>(&zt[r * kEpiLd + c]);
    const float4 yv = *reinterpret_cast<const float4*>(&yt[r * kEpiLd + c]);
    if (z != nullptr) store4(z + gm * p.ldz + gn, p.vz, gn, p.n, zv);
    if (y != nullptr) store4(y + gm * p.ldy + gn, p.vy, gn, p.n, yv);
    if (y2 != nullptr) store4(y2 + gm * p.ldy2 + gn, p.vy2, gn, p.n, yv);
  }
}

// One kernel name for solo launches and one for member launches, so a
// profile tells them apart.
__global__ void __launch_bounds__(kThreads, 1)
fwd_tc_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap, const Args p) {
  tc_body(&xmap, &wmap, p, 0);
}

__global__ void __launch_bounds__(kThreads, 1)
fwd_tc_members(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap, const Args p,
               const Strides s) {
  const long long e = blockIdx.z;
  Args q = p;
  q.bias += e * s.bias;
  if (q.z != nullptr) q.z += e * s.z;
  if (q.y != nullptr) q.y += e * s.y;
  if (q.y2 != nullptr) q.y2 += e * s.y2;
  if (q.ws != nullptr)
    q.ws += e * q.splits * static_cast<long long>(gridDim.x) * kBM * kBN;
  if (q.counters != nullptr) q.counters += e * gridDim.x;
  tc_body(&xmap, &wmap, q, static_cast<int>(e));
}

// cuTensorMapEncodeTiled, found through the runtime (no link to
// libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f,
                                         12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// a 3-D fp32 map (cols, rows, members) with the 128-byte swizzle; strides
// in elements; false where cuTensorMapEncodeTiled refuses it
inline bool encode(CUtensorMap* map, const float* ptr, long long cols,
                   long long rows, long long members, long long ld,
                   long long member_stride, int box_cols, int box_rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(members)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(ld) * 4,
      static_cast<cuuint64_t>(member_stride > 0 ? member_stride
                                                : ld * rows) * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<float*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned(const void* p, long long ld, long long member_stride) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (ld & 3) == 0 &&
         (member_stride & 3) == 0;
}

// z/y/y2 (rows m, n columns) = the layer over a[:, k_off:k_off + k] (rows
// of lda, a_cols = k_off + k columns readable) and w (k, n; rows of ldw);
// `members` = 0 for a solo launch, else one launch for that many, sa/sw
// the member strides of a (every member its own) and w (0: W shared), es
// the epilogue's.
inline int launch(const float* a, long long lda, int a_cols,
                  const float* w, long long ldw, Args p, int members,
                  long long sa, long long sw, const Strides& es,
                  cudaStream_t stream) {
  const int chunks = (p.k + kBK - 1) / kBK;
  if (p.m <= 0 || p.n <= 0 || (p.n & 3) != 0 || p.k <= 0 || p.k_off < 0 ||
      a_cols != p.k_off + p.k || lda < a_cols || ldw < p.n ||
      !aligned(a, lda, sa) || !aligned(w, ldw, sw) || p.bias == nullptr ||
      (p.y == nullptr && p.y2 == nullptr) || p.act < dense_tile::kIdentity ||
      p.act > dense_tile::kSwish || p.splits < 1 ||
      p.chunks_per_split < 1 || (p.splits - 1) * p.chunks_per_split >= chunks ||
      p.splits * p.chunks_per_split < chunks ||
      (p.splits > 1 && (p.ws == nullptr || p.counters == nullptr)) ||
      members < 0 || (members > 0 && sa <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = members > 0 ? members : 1;
  p.w_member = members > 0 && sw != 0 ? 1 : 0;
  CUtensorMap xmap, wmap;
  if (!encode(&xmap, a, a_cols, p.m, e, lda, sa, kBK, kBM) ||
      !encode(&wmap, w, p.n, p.k, p.w_member ? e : 1, ldw, sw, kBox, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((p.m + kBM - 1) / kBM) * ((p.n + kBN - 1) / kBN);
  const dim3 grid(tiles, p.splits, e);
  if (members > 0) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        fwd_tc_members, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    fwd_tc_members<<<grid, kThreads, kSmemBytes, stream>>>(xmap, wmap, p,
                                                            es);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    fwd_tc_kernel<<<grid, kThreads, kSmemBytes, stream>>>(xmap, wmap, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dense_tile_tc
