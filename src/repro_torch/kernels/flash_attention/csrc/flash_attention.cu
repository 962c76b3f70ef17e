// Forward flash attention (causal, sliding window, tanh soft-cap, grouped
// KV heads), for Hopper (sm_90a), on the tensor cores in split-precision
// TF32.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::_kernel
// (launched by flash_attention), and the K/V head repeat of ops.gqa_flash.
// The TPU kernel runs a (BH, q blocks, kv blocks) grid whose kv axis is
// sequential, carrying the online-softmax statistics (m, l) and the output
// accumulator in VMEM scratch from one kv step to the next; masks come from
// program ids, the scores are fp32 whatever the input type.
//
// Bound on the H100: B=2, S=2048, H=16, hd=64, causal is 17.2 GFLOP of
// Q.K^T and P.V counted over the causal half, against 25 MB of traffic:
// bound by operations. In fp32 outside the tensor cores that is 256.5 us at
// 67 TFLOP/s, which the first, SIMT version of this kernel reached at 17%
// (launch/csrc/flash_first.cu: its loops issued two shared-memory loads an
// FMA). TF32 on the tensor cores runs 495 TFLOP/s, but keeps 10 mantissa
// bits and misses the 1e-4 agreement with the fp32 reference, so each fp32
// operand is split as fused_dense.cu splits it: hi = x rounded to TF32 (to
// nearest, ties away), lo = x - hi (exact in fp32; the MMA truncates it),
// and lo*hi + hi*lo + hi*hi go into one fp32 accumulator ("3xTF32"): 3 x
// 17.2 GFLOP at 495 TFLOP/s = 104.3 us. mma.sync (this kernel's route; wgmma
// would want K/V in its own shared layouts and 64-row warpgroups) measured
// 322-328 TFLOP/s of TF32 on this card (launch/bwd_sweep.py mma_peak_rows),
// a ceiling of ~159 us. A bfloat16 K or V value is exact in TF32, so bf16
// inputs take two products a pair (the lo of q*scale or of P with the hi of
// K or V, and hi*hi). What the design does about each: the tensor cores
// take the products off the SIMT pipe; the split holds the fp32 bar with 3
// products (2 for bf16); toward the mma.sync ceiling, independent products
// issue back to back and the operands cost little on the way (one shared
// load two operands, P in registers, a copy a pointer add). What stands
// between the kernel and that ceiling (the per-tile barrier and copy, the
// softmax between the two products) is measured in PERF.md.
//
// Design. A block of FLASH_WARPS warps owns a (batch, head, 16*FLASH_WARPS
// query rows) tile, each warp 16 rows: one m16 row block of
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. The block loops over
// FLASH_BKV-key tiles itself (the TPU kernel's sequential kv grid becomes
// that loop). K and V tiles stream through a ring of 2 stages in shared
// memory (3 measured no faster: one tile's copy hides behind the other's
// compute), filled by cp.async (16-byte copies where the rows' address
// and stride allow, each thread always the same 16-byte column of its rows;
// 4-byte ones or plain loads elsewhere; the copy's source size zero-fills
// the ragged Skv and head dim), one barrier a key tile;
// bf16 tiles are copied as bf16 and widened where the fragment is loaded.
// q * scale is loaded once into the warp's A fragments, split into hi and
// lo (up to hd 64; at 128 into shared memory, split where read: held in
// registers it spilled). The scores stay in the accumulator fragments:
// soft-cap, the masks (only on tiles that cross the causal diagonal, the
// window edge or Skv), the row max and sum over a quad's 4 lanes by 2
// shuffles, the correction exp(m_old - m_new) on the output fragments (e^x
// by expf or __expf, a build constant: PERF.md measures both). P
// never leaves registers: the C fragment holds (g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1), and the sum over keys does not care about their
// order, so A's k slot t takes key 2t and slot t + 4 key 2t + 1, and V's B
// fragment is read in the same order. The same freedom over the head dim
// gives each lane neighbouring operands: in Q.K^T slots t and t + 4 are dims
// 2t and 2t + 1 (one 8-byte shared load a K fragment, 4 bytes in bf16), and
// each pair of P.V output tiles interleaves its 16 dims (one load gives a
// lane both tiles' V value of a key). Shared rows are padded (hd + 4
// floats, hd + 8 bf16) so that these loads hit distinct banks. The split's
// products are issued tile by tile (every lo*hi, then hi*lo, then hi*hi),
// so consecutive MMAs never wait on each other. The warps, the key tile
// and the exp form are fixed at build time by -D flags (flash_attention.py:
// build_defines), the pick of the card sweep; the heaviest causal query
// tiles launch first.
//
// Semantics, as the TPU kernel's: q is scaled before the product (the
// reference scales the scores). Masks are built from positions; masked keys
// score the TPU kernel's finite -1e30, so a row that has seen only masked
// keys holds them at weight 1 until a valid key's correction
// exp(-1e30 - m) wipes them. Hence key tiles that are wholly masked for
// every row of a warp are skipped exactly, with one exception: a row with
// no valid key at all (Sq > Skv with a window) keeps weight 1 on every key,
// i.e. the mean of v, in the TPU kernel and in ref.attention_ref; a warp
// (and a block) holding such a row visits every key tile. Keys past Skv
// score -inf and weigh exactly 0. GQA: the kv head of query head h is
// h / (H / KV), read in place through strides; nothing is repeated or
// transposed, and the output is written straight into the caller's layout.
// No atomics: two calls are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(FLASH_WARPS) || !defined(FLASH_BKV) || !defined(FLASH_FAST_EXP)
#error "build with the plan's -D flags (flash_attention.py: build_defines)"
#endif

namespace {

constexpr int kWarps = FLASH_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int BQ = 16 * kWarps;            // query rows of a block
constexpr int BKV = FLASH_BKV;             // keys of a tile
constexpr int kStages = 2;                 // the K/V ring's
constexpr int NT = BKV / 8;                // n8 score tiles of a key tile
constexpr float kNegInf = -1e30f;          // the TPU kernel's NEG_INF
static_assert(BKV % 8 == 0, "key tile of whole n8 tiles");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides over (batch, head, position); the head dim is contiguous
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int batch, heads, kv_heads, sq, skv, d, causal, window;
  float softcap, scale;
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
// e^x of the softmax: expf (within 2 ulp), or with FLASH_FAST_EXP __expf
// (ex2.approx of x * log2 e: 2 + 1.17 |x| ulp)
__device__ __forceinline__ float softmax_exp(float x) {
#if FLASH_FAST_EXP
  return __expf(x);
#else
  return expf(x);
#endif
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// an fp32 value's TF32 parts, as the MMA reads them (the top 19 bits of each
// register): hi = x rounded to TF32, to nearest with ties away from zero
// (half an ulp added, the low 13 bits left for the MMA to drop), and
// lo = x - hi, exact in fp32, which the MMA truncates
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// Two neighbouring K or V elements (8 bytes of fp32, 4 of bf16, one shared
// load) as MMA operands: fp32 splits into hi and lo; bf16 is exact in TF32
// (hi only: its lo is 0 and never multiplied)
__device__ __forceinline__ void pair_parts(const float* p, uint32_t (&hi)[2],
                                           uint32_t (&lo)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  split(x.x, hi[0], lo[0]);
  split(x.y, hi[1], lo[1]);
}
__device__ __forceinline__ void pair_parts(const __nv_bfloat16* p,
                                           uint32_t (&hi)[2], uint32_t (&)[2]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  hi[0] = w << 16;                          // the lower address's element
  hi[1] = w & 0xffff0000u;
}

// d += a @ b on one m16n8k8 tile (not volatile: the compiler may interleave
// independent products)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[n0 + n] += a @ b[n] for N tiles in split precision: every tile's
// lo*hi, then (both sides split: fp32 K or V) every hi*lo, then every
// hi*hi, so consecutive MMAs never wait on each other
template <bool kBothSplit, int N, int NA>
__device__ __forceinline__ void mma_3x(float (&acc)[NA][4], int n0,
                                       const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4],
                                       const uint32_t (&bh)[N][2],
                                       const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n0 + n], al, bh[n]);
  if constexpr (kBothSplit) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(acc[n0 + n], ah, bl[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n0 + n], ah, bh[n]);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (0..16) bytes from src; the rest of 16 is zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's newest groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// one element into shared memory, zero where !in: a 4-byte cp.async for
// float, a plain load and store for bfloat16 (cp.async copies 4 bytes at
// least, and a bf16 element need not be 4-byte aligned)
__device__ __forceinline__ void copy_elem(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, bool in) {
  *dst = in ? *src : __float2bfloat16(0.f);
}

__device__ __forceinline__ bool vec_ok(const void* p, long long ld,
                                       int elem_bytes) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
         (ld * elem_bytes) % 16 == 0;
}

// The key range [lo, hi] that holds a valid key for some row of
// [first, last]: [lo of the first row, hi of the last]. The last row is the
// first to lose every key; if it has none, the whole range (see the header).
__device__ __forceinline__ void key_range(const Args& p, int first, int last,
                                          int& lo, int& hi) {
  hi = p.causal ? min(last, p.skv - 1) : p.skv - 1;
  lo = p.window > 0 ? max(0, first - p.window + 1) : 0;
  if (p.window > 0 && last - p.window + 1 > hi) {
    lo = 0;
    hi = p.skv - 1;
  }
}

// Shared layout, in elements of T: the ring's stages, each K then V, BKV
// rows of LD (hd padded to DMAX, plus 16 bytes: K's (key g, dims 2t, 2t + 1)
// fragment loads fall on banks 4g + 2t, V's (key 2t, dims 2g, 2g + 1) on
// 8t + 2g); after the ring, at DMAX 128, q * scale as fp32 rows of
// DMAX + 4.
template <typename T, int DMAX>
struct Ring {
  static constexpr int kMaxBytes = 232448;
  static constexpr int EV = 16 / sizeof(T);   // elements of 16 bytes
  static constexpr int LD = DMAX + EV;
  static constexpr int STAGE = 2 * BKV * LD;
  static constexpr bool kQHeld = DMAX <= 64;  // q's fragments in registers
  static constexpr int LDQ = DMAX + 4;
  static constexpr int kQBytes =
      kQHeld ? 0 : BQ * LDQ * static_cast<int>(sizeof(float));
  static constexpr int kStageBytes = STAGE * static_cast<int>(sizeof(T));
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kBytes = kRingBytes + kQBytes;
  static_assert(kBytes <= kMaxBytes, "the block's shared memory fits");
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const __grid_constant__ Args p) {
  using R = Ring<T, DMAX>;
  constexpr int LD = R::LD, EV = R::EV, NS = kStages;
  constexpr int KD = DMAX / 8;              // k8 steps over the head dim
  constexpr int NV = KD < 8 ? KD : 8;       // output tiles a P.V pass
  constexpr bool kSplitKV = sizeof(T) == 4; // fp32 K, V: three products
  constexpr bool kQHeld = R::kQHeld;        // else q in shared memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);
  float* const qs = reinterpret_cast<float*>(smem_raw + R::kRingBytes);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;     // the MMA fragments' row, col
  const int bh_n = p.batch * p.heads;
  const int bh = blockIdx.x % bh_n;
  const int q_tiles = (p.sq + BQ - 1) / BQ;
  const int q0 = (q_tiles - 1 - blockIdx.x / bh_n) * BQ;  // heaviest first
  const int b = bh / p.heads, h = bh % p.heads;
  const int hk = h / (p.heads / p.kv_heads);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  // the key tiles of the block, and of this warp (a warp with no rows
  // inside Sq computes nothing but copies its share)
  int lo, hi;
  key_range(p, q0, min(q0 + BQ, p.sq) - 1, lo, hi);
  const int t_lo = lo / BKV, t_hi = hi / BKV;
  const int wq0 = q0 + warp * 16;
  const bool w_rows = wq0 < p.sq;
  int w_lo = 0, w_hi = -1;
  if (w_rows) {
    key_range(p, wq0, min(wq0 + 16, p.sq) - 1, lo, hi);
    w_lo = lo / BKV;
    w_hi = hi / BKV;
  }
  const int r0 = wq0 + g, r1 = r0 + 8;      // this thread's two query rows

  // q * scale as A fragments of each k8 step over the head dim. The sum
  // over the head dim does not care about its order, so A's k slot t takes
  // dim 2t and slot t + 4 dim 2t + 1 (K's B fragment the same), and each
  // lane's two dims of a row are neighbours: a0..a3 are (r0, 2t), (r1, 2t),
  // (r0, 2t + 1), (r1, 2t + 1). Split into hi and lo in registers; at DMAX
  // 128 the warp's 16 rows in shared memory, split where read (the loop's
  // first barrier orders the stores before the reads).
  uint32_t qa[kQHeld ? KD : 1][4][2];
  float* const qw = qs + (warp * 16 + g) * R::LDQ + 2 * t;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i & 1 ? r1 : r0, c = kk * 8 + 2 * t + (i >> 1);
      const float x =
          r < p.sq && c < p.d ? to_f(q[r * p.q_ss + c]) * p.scale : 0.f;
      if constexpr (kQHeld)
        split(x, qa[kk][i][0], qa[kk][i][1]);
      else
        qw[(i & 1) * 8 * R::LDQ + kk * 8 + (i >> 1)] = x;
    }

  const bool vec = vec_ok(k, p.k_ss, sizeof(T)) &&
                   vec_ok(v, p.v_ss, sizeof(T));
  // the 16-byte copies: this thread's column chunk c of rows cr, cr + kStep,
  // ... of each tile, and the bytes of it inside the head dim
  constexpr int kChunks = DMAX / EV;        // 16-byte chunks a row
  constexpr int kStep = kThreads / kChunks; // rows a pass
  constexpr int kPasses = (BKV + kStep - 1) / kStep;
  static_assert(kThreads % kChunks == 0, "whole rows a pass");
  const int c16 = (tid % kChunks) * EV, cr = tid / kChunks;
  const int cbytes = sizeof(T) * max(0, min(EV, p.d - c16));
  const T* const kc = k + cr * p.k_ss + c16;
  const T* const vc = v + cr * p.v_ss + c16;
  int next = t_lo;                          // the next key tile to copy
  // key tile `next` into ring stage `slot`; every call commits one group
  // (empty past the block's last tile)
  auto copy_next = [&](int slot) {
    if (next <= t_hi) {
      const int kv0 = next * BKV;
      T* ks = ring + slot * R::STAGE;
      T* vs = ks + BKV * LD;
      if (vec) {
        const T* kt = kc + kv0 * p.k_ss;
        const T* vt = vc + kv0 * p.v_ss;
        ks += cr * LD + c16;
        vs += cr * LD + c16;
#pragma unroll
        for (int i = 0; i < kPasses; ++i) {
          if (kPasses * kStep > BKV && cr + i * kStep >= BKV) break;
          const int bytes = kv0 + cr + i * kStep < p.skv ? cbytes : 0;
          cp_async16(ks + i * kStep * LD, bytes ? kt + i * kStep * p.k_ss : k,
                     bytes);
          cp_async16(vs + i * kStep * LD, bytes ? vt + i * kStep * p.v_ss : v,
                     bytes);
        }
      } else {
#pragma unroll 4
        for (int e = tid; e < BKV * DMAX; e += kThreads) {
          const int r = e / DMAX, c = e % DMAX;
          const int kj = kv0 + r;
          const bool in = kj < p.skv && c < p.d;
          copy_elem(ks + r * LD + c, in ? k + kj * p.k_ss + c : k, in);
          copy_elem(vs + r * LD + c, in ? v + kj * p.v_ss + c : v, in);
        }
      }
      ++next;
    }
    cp_async_commit();
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  // s = (q * scale) K^T over the keys of the K tile at ks
  auto scores = [&](float (&s)[NT][4], const T* ks) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (kQHeld) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = qa[kk][i][0];
          al[i] = qa[kk][i][1];
        }
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {       // rows r0, r1: dims 2t, 2t + 1
          const float2 x = *reinterpret_cast<const float2*>(
              qw + r * 8 * R::LDQ + kk * 8);
          split(x.x, ah[r], al[r]);
          split(x.y, ah[r + 2], al[r + 2]);
        }
      }
      uint32_t bh[NT][2], bl[NT][2];        // (dims 2t, 2t + 1; key g)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        pair_parts(ks + (j * 8 + g) * LD + kk * 8 + 2 * t, bh[j], bl[j]);
      mma_3x<kSplitKV>(s, 0, ah, al, bh, bl);
    }
  };

  // soft-cap, mask and online softmax of the scores s of the keys from kv0,
  // then acc += P V over the V tile at vs
  auto consume = [&](float (&s)[NT][4], int kv0, const T* vs) {
    // s[j][i] is row r0 (i < 2) or r1, key kv0 + 8j + 2t + (i & 1)
    if (p.softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[j][i] = p.softcap * tanhf(s[j][i] / p.softcap);
    }
    const bool full = kv0 + BKV <= p.skv &&
                      (!p.causal || kv0 + BKV - 1 <= wq0) &&
                      (p.window == 0 || wq0 + 15 - kv0 < p.window);
    if (!full) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = i < 2 ? r0 : r1;
          const int kpos = kv0 + 8 * j + 2 * t + (i & 1);
          bool ok = true;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && qpos - kpos < p.window;
          s[j][i] = kpos >= p.skv ? -__int_as_float(0x7f800000)   // -inf
                                  : (ok ? s[j][i] : kNegInf);
        }
    }

    // online softmax: the row max over the quad's 4 lanes, the correction
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = softmax_exp(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int j = 0; j < KD; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = softmax_exp(s[j][i] - mx[i >> 1]);
        l[i >> 1] += s[j][i];
      }

    // acc += P V, P from the score fragments: A's k slot t is key 2t,
    // slot t + 4 key 2t + 1; V's B fragment read in that order. Output
    // tiles 2m and 2m + 1 interleave dims 16m.. : slot n of tile 2m + e is
    // dim 16m + 2n + e, so one shared load gives a lane both tiles' value
    // of a key (dims 16m + 2g, 16m + 2g + 1)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ph[4], pl[4];
      split(s[j][0], ph[0], pl[0]);             // (r0, key 2t)
      split(s[j][2], ph[1], pl[1]);             // (r1, key 2t)
      split(s[j][1], ph[2], pl[2]);             // (r0, key 2t + 1)
      split(s[j][3], ph[3], pl[3]);             // (r1, key 2t + 1)
      const T* vp = vs + (j * 8 + 2 * t) * LD + 2 * g;
#pragma unroll
      for (int n0 = 0; n0 < KD; n0 += NV) {     // NV output tiles at once
        uint32_t bh[NV][2], bl[NV][2], h2[2], l2[2];
#pragma unroll
        for (int m = 0; m < NV / 2; ++m)
#pragma unroll
          for (int kr = 0; kr < 2; ++kr) {      // keys 2t, 2t + 1
            pair_parts(vp + kr * LD + (n0 / 2 + m) * 16, h2, l2);
            bh[2 * m][kr] = h2[0];
            bl[2 * m][kr] = l2[0];
            bh[2 * m + 1][kr] = h2[1];
            bl[2 * m + 1][kr] = l2[1];
          }
        mma_3x<kSplitKV>(acc, n0, ph, pl, bh, bl);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) copy_next(s);
  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int it = tile - t_lo;
    cp_async_wait<NS - 2>();
    // tile `it` has landed for every thread, and every thread is done with
    // tile it - 1, whose stage the copy below refills
    __syncthreads();
    copy_next((it + NS - 1) % NS);
    if (tile < w_lo || tile > w_hi) continue;   // wholly masked for the warp
    const T* ks = ring + (it % NS) * R::STAGE;
    float s[NT][4];
    scores(s, ks);
    consume(s, tile * BKV, ks + BKV * LD);
  }
  cp_async_wait<0>();                       // only empty groups are left
  if (!w_rows) return;

  // l: the quad's partial sums; acc[n][i] is row r0 (i < 2) or r1, slot
  // 2t + (i & 1) of output tile n: dim 16 (n / 2) + 4t + 2 (i & 1) + n % 2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i < 2 ? r0 : r1;
      const int c = 16 * (n / 2) + 4 * t + 2 * (i & 1) + n % 2;
      if (r < p.sq && c < p.d)
        o[r * p.o_ss + c] = from_f<T>(acc[n][i] / l[i >> 1]);
    }
}

template <typename T, int DMAX>
int launch(const Args& p, cudaStream_t stream) {
  using R = Ring<T, DMAX>;
  auto* kernel = flash_kernel<T, DMAX>;
  // once per configuration (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks =
      static_cast<long long>(p.batch) * p.heads * ((p.sq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, R::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Args& p, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 32>(p, stream);
  if (p.d <= 64) return launch<T, 64>(p, stream);
  return launch<T, 128>(p, stream);
}

}  // namespace

// strides: 12 element strides, (batch, head, position) of q, k, v, o.
// Returns the CUDA error of the launch (0 on success). dtype 0: float32,
// 1: bfloat16.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int batch,
                                   int heads, int kv_heads, int sq, int skv,
                                   int d, int causal, int window,
                                   float softcap, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      sq <= 0 || skv <= 0 || d <= 0 || d > 128 || window < 0 ||
      softcap < 0.f)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  long long* s[12] = {&p.q_sb, &p.q_sh, &p.q_ss, &p.k_sb, &p.k_sh, &p.k_ss,
                      &p.v_sb, &p.v_sh, &p.v_ss, &p.o_sb, &p.o_sh, &p.o_ss};
  for (int i = 0; i < 12; ++i) *s[i] = strides[i];
  p.batch = batch;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.sq = sq;
  p.skv = skv;
  p.d = d;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(p, st);
    case 1: return launch_d<__nv_bfloat16>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
