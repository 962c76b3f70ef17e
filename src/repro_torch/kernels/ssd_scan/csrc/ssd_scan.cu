// Mamba2 SSD intra-chunk dual form with the carried state and the D skip,
// for Hopper (sm_90a), on the tensor cores in split-precision TF32:
//
//   y[t] = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x[s]
//          + exp(cum_t) (C_t . state^T) + D x[t]
//
// for one chunk of length Q of every (cell g, head h).
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py::_kernel (launched by
// ssd_chunk_dual). The TPU kernel holds a whole (g, h) cell in VMEM: the
// (Q, Q) scores C B^T, the decays exp(cum_t - cum_s) masked to -inf above
// the diagonal before the exp, and the (Q, P) x, about 0.7 MB at Q = 256;
// every head's grid step recomputes C B^T, which VMEM made cheap.
//
// Bound on the H100: G=16 cells, H=16, Q=256, N=P=64 is 1.69 GFLOP over
// the causal half of each cell with C B^T counted once a cell (25.2 us in
// fp32 outside the tensor cores, at 67 TFLOP/s), against 40.4 MB of
// traffic (12.1 us at 3.35 TB/s). TF32 on the tensor cores runs 495
// TFLOP/s but keeps 10 mantissa bits, short of the 1e-4 agreement with the
// fp32 reference, so each fp32 operand is split as fused_dense.cu and
// flash_attention.cu split it: hi = x rounded to TF32 (to nearest, ties
// away), lo = x - hi (exact in fp32; the MMA truncates it), and lo*hi +
// hi*lo + hi*hi go into one fp32 accumulator ("3xTF32", 10.2 us at 495
// TFLOP/s: bound by bytes). A bfloat16 operand is exact in TF32 and takes
// no lo: C B^T of bf16 c and b is 1 product, M x with bf16 x 2, C state^T
// with bf16 c 2. mma.sync (this kernel's route) measured 322-328 TFLOP/s
// of TF32 on this card (launch/bwd_sweep.py mma_peak_rows).
//
// Design. A block owns (cell g, a 64-row tile of t, a group of SSD_HG
// heads); SSD_WARPS warps: 4 row groups of 16 rows (one m16 row block of
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32), with 8 warps each
// row group's P split between two warps. It walks the SSD_BS-wide s-tiles
// up to the diagonal (tiles above it are never visited). For each s-tile
// it forms S = C_t B_s^T once, in the accumulator fragments of each warp's
// 16 rows (C B^T does not depend on the head: the group shares it, and
// SSD_HG = 1 is the first kernel's recompute per head), then for each head
// of the group builds M_h = S o exp(cum_t - cum_s) o dt_s in registers and
// adds M_h x_{s,h} to that head's output accumulator, held in registers
// across the s-tiles. M never leaves registers: S's C fragment holds
// (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), and a sum over s does
// not care about its order, so A's k slot t takes s = 2t and slot t + 4
// s = 2t + 1, and x's B fragment is read in the same order; C and B share
// the same freedom over N (slots t and t + 4 are dims 2t and 2t + 1: one
// shared load gives both). Output tiles 2m and 2m + 1 interleave their 16
// columns (slot n of tile 2m + e is column 16m + 2n + e), so one shared
// load gives a lane both tiles' x (or state) value. On tiles the diagonal
// crosses the mask is applied before the exp (an entry with s > t is
// exactly 0, and no exp of a possibly large positive difference is ever
// kept), M x skips the n8 tiles of s past a warp's last row, and D x_t is
// added from the x tile already in shared memory. Last, the carried state:
// one more K=N product of the same fragments, C_t state^T for each head,
// scaled by exp(cum_t) per row. Every product's split is issued tile by
// tile (every lo*hi, then hi*lo, then hi*hi), so consecutive MMAs do not
// wait on each other, and unconditionally: N and P are padded (k8 steps of
// zeros, P to the kernel's width 32, 64 or 128) rather than branched
// around, and S is formed whole on the diagonal (a branch an MMA cost more
// than the products it saved).
//
// Copies: C_t once, then per item (an s-tile of one head, or one head's
// state) B_s (with the group's first head), x_{s,h}, cum_s and dt_s (or the
// (P, N) state) through a 2-stage ring of cp.async copies, one barrier an
// item (a third stage measured slower: its registers cost a block an SM); 16-byte copies where a view's base and strides allow,
// else 8 or 4 (bf16 element loads below that), as the launcher picks for
// each operand, each thread one chunk column of its rows; the copy's source
// size zero-fills ragged rows and columns. Shared rows are padded (16 bytes
// past a multiple of 32 elements) so the fragment loads hit distinct banks.
// What bounds the design is shared memory a block (the C tile and the
// ring): 32-wide s-tiles hold a block to 52.7 KB at N=P=64, fp32, so 3
// blocks an SM fit where 64-wide ones (88 KB) fit 2. The heaviest causal
// t-tiles launch first. SSD_HG, SSD_WARPS, SSD_BS and the exp form
// (SSD_FAST_EXP: __expf, else expf) are build constants (ssd_scan.py:
// build_defines), the pick of the card sweep (launch/bwd_sweep.py --only
// ssd). A head count that is not a multiple of SSD_HG leaves the last
// group's extra heads idle. No atomics: two calls are bitwise equal.
//
// All operands are read through element strides (unit stride along N and
// P), so ops.ssd_chunked_kernel hands over views of the (B, S, H, P)
// sequence and the (B, nc, Q, H) decays, and the output is written straight
// into (B, S, H, P): nothing is transposed. c and b are float32 or bfloat16
// (one type), x and y float32 or bfloat16, cum, dt, the state and D float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(SSD_HG) || !defined(SSD_WARPS) || !defined(SSD_BS) || \
    !defined(SSD_FAST_EXP)
#error "build with the plan's -D flags (ssd_scan.py: build_defines)"
#endif

namespace {

constexpr int HG = SSD_HG;                 // heads a block
constexpr int kWarps = SSD_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int WP = kWarps / 4;             // warps sharing a row group's P
constexpr int BT = 64;                     // rows of a t-tile
constexpr int BS = SSD_BS;                 // columns of an s-tile
constexpr int NJ = BS / 8;                 // n8 tiles of an s-tile
constexpr int kStages = 2;                 // the ring's (3 lost: registers)
constexpr int kMaxSmem = 232448;           // bytes a block may hold (H100)
static_assert(kWarps == 4 || kWarps == 8, "4 row groups, P whole or halved");
static_assert(HG >= 1 && HG <= 8, "heads a block");
static_assert(BS == 32 || BS == 64, "s-tiles of 32 or 64 columns");

struct Args {
  const void* c;
  const void* b;
  const void* x;
  const float* cum;
  const float* dt;
  const float* state;
  const float* dskip;
  void* y;
  // element strides: c, b over (g, t); x, y over (g, h, t); cum, dt over
  // (g, h, t); state over (g, h, p)
  long long c_sg, c_st, b_sg, b_st;
  long long x_sg, x_sh, x_st, y_sg, y_sh, y_st;
  long long cum_sg, cum_sh, cum_st, dt_sg, dt_sh, dt_st;
  long long st_sg, st_sh, st_sp;
  int cells, heads, q, n, p;
  int cw_c, cw_b, cw_x, cw_st;             // copy bytes: 16, 8, 4 (2: loads)
};

// Shared layout (bytes): the C tile, BT rows of ldc elements of TC; then
// the ring's stages, each B_s (BS x ldc, TC), x (BS x ldx, TX), cum_s and
// dt_s (BS floats each), or in their place the state (pmax rows x lds
// floats); x and the state span the kernel's whole P width pmax (32, 64 or
// 128), zero past P. Rows are padded 16 bytes past a multiple of 32
// elements (4 floats): a lane's pair loads fall on distinct banks.
struct Layout {
  int ldc, ldx, lds;                       // row pitches, in elements
  int x_off, cum_off;                      // bytes into a stage
  int c_bytes, stage, total;
};

__host__ __device__ inline Layout layout(int n, int pmax, int sc, int sx) {
  Layout l;
  const int n32 = (n + 31) / 32 * 32;
  l.ldc = n32 + 16 / sc;
  l.ldx = pmax + 16 / sx;
  l.lds = n32 + 4;
  l.c_bytes = BT * l.ldc * sc;
  l.x_off = BS * l.ldc * sc;
  l.cum_off = l.x_off + BS * l.ldx * sx;
  const int work = l.cum_off + 2 * BS * 4, st = pmax * l.lds * 4;
  l.stage = work > st ? work : st;
  l.total = l.c_bytes + kStages * l.stage;
  return l;
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// e^x of the decays: expf (within 2 ulp), or with SSD_FAST_EXP __expf
// (ex2.approx of x * log2 e: 2 + 1.17 |x| ulp)
__device__ __forceinline__ float decay_exp(float x) {
#if SSD_FAST_EXP
  return __expf(x);
#else
  return expf(x);
#endif
}

// an fp32 value's TF32 parts, as the MMA reads them (the top 19 bits of each
// register): hi = x rounded to TF32, to nearest with ties away from zero
// (half an ulp added, the low 13 bits left for the MMA to drop), and
// lo = x - hi, exact in fp32, which the MMA truncates
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// Two neighbouring elements (8 bytes of fp32, 4 of bf16, one shared load)
// as MMA operands: fp32 splits into hi and lo; bf16 is exact in TF32 (hi
// only: its lo is 0 and never multiplied)
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
// lo*hi (A split), then every hi*lo (B split), then every hi*hi, so
// consecutive MMAs never wait on each other. An operand that is not split
// (bf16) has no lo, and its product is not issued. Unconditional: the
// products issue back to back (padding is computed, not branched around).
template <bool kASplit, bool kBSplit, int N, int NA>
__device__ __forceinline__ void mma_split(float (&acc)[NA][4], int n0,
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[N][2],
                                          const uint32_t (&bl)[N][2]) {
  if constexpr (kASplit) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(acc[n0 + n], al, bh[n]);
  }
  if constexpr (kBSplit) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(acc[n0 + n], ah, bl[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n0 + n], ah, bh[n]);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (0..kBytes) bytes from src; the rest of kBytes is
// zeroed
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::
               "r"(smem_addr(dst)), "l"(src), "n"(kBytes), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [0, rows) of a tile into shared rows of `ld` elements: row r from
// src + r * src_ld, elements [0, width) of it, zero past `valid` elements
// and for rows from `valid_rows` on. cw: bytes a copy (16, 8 or 4 by
// cp.async; 2, bf16 element loads), which the view's base and strides
// allow (the launcher's pick); width is a multiple of 16 bytes. Where a
// row's copies divide the block's threads, each thread keeps one column
// of every (kThreads / copies)-th row: no division a copy.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          long long src_ld, int rows,
                                          int valid_rows, int width,
                                          int valid, int cw, int tid) {
  constexpr int E = static_cast<int>(sizeof(T));
  const int ce = cw / E;                    // elements a copy
  const int per_row = width / ce;
  auto one = [&](int r, int col) {
    const int in = r < valid_rows ? max(0, min(ce, valid - col)) : 0;
    T* d = dst + r * ld + col;
    const T* s = in ? src + r * src_ld + col : src;
    switch (cw) {
      case 16: cp_async<16>(d, s, in * E); break;
      case 8: cp_async<8>(d, s, in * E); break;
      case 4: cp_async<4>(d, s, in * E); break;
      default: *d = in ? *s : from_f<T>(0.f); break;
    }
  };
  if (kThreads % per_row == 0) {
    const int step = kThreads / per_row, col = (tid % per_row) * ce;
    for (int r = tid / per_row; r < rows; r += step) one(r, col);
  } else {
    for (int e = tid; e < rows * per_row; e += kThreads) {
      const int r = e / per_row;
      one(r, (e - r * per_row) * ce);
    }
  }
}

template <typename TC, typename TX, int PMAX>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const __grid_constant__ Args p) {
  constexpr int NPW = PMAX / 8 / WP;        // n8 output tiles a warp
  constexpr int NPP = NPW / 2;              // interleaved tile pairs a warp
  constexpr int NV = NPW < 4 ? NPW : 4;     // output tiles a pass of M x
  constexpr bool kCSplit = sizeof(TC) == 4; // fp32 c, b: split
  constexpr bool kXSplit = sizeof(TX) == 4; // fp32 x: split
  static_assert(NPW % 2 == 0 && NPW % NV == 0, "whole tile pairs a warp");
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(p.n, PMAX, sizeof(TC), sizeof(TX));
  const TC* const cs = reinterpret_cast<const TC*>(smem);
  unsigned char* const ring = smem + L.c_bytes;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;   // the MMA fragments' row, col
  const int rw = warp % 4;                  // row group: rows 16 rw ..
  const int mbase = (warp / 4) * NPP;       // this warp's first tile pair

  // (t-tile, cell, head group) of the block: heaviest t-tiles first
  const int groups = (p.heads + HG - 1) / HG;
  const int t_tiles = (p.q + BT - 1) / BT;
  const int per_tile = p.cells * groups;
  const int tt = t_tiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int g = rest / groups, h0 = (rest % groups) * HG;
  const int hg_n = min(HG, p.heads - h0);   // heads of this group
  const int t0 = tt * BT;
  const int n_s = (min(t0 + BT, p.q) + BS - 1) / BS;  // s-tiles up to t's
  const int n8 = (p.n + 7) / 8 * 8, nk = n8 / 8;

  const TC* c = static_cast<const TC*>(p.c) + g * p.c_sg;
  const TC* b = static_cast<const TC*>(p.b) + g * p.b_sg;
  const TX* x = static_cast<const TX*>(p.x) + g * p.x_sg;
  const float* cum = p.cum + g * p.cum_sg;
  const float* dt = p.dt + g * p.dt_sg;
  const float* state = p.state + g * p.st_sg;

  const int rl0 = 16 * rw + g8, rl1 = rl0 + 8;   // this thread's tile rows
  const bool w_rows = t0 + 16 * rw < p.q;        // the warp has a row < Q

  // cum_t of this thread's two rows, for each head of the group
  float ct[HG][2];
#pragma unroll
  for (int hi = 0; hi < HG; ++hi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + (r ? rl1 : rl0);
      ct[hi][r] = hi < hg_n && t < p.q
                      ? cum[(h0 + hi) * p.cum_sh + t * p.cum_st] : 0.f;
    }

  // item k: (s-tile k / HG, head k % HG) for k < n_s HG, then head
  // k - n_s HG's state; every call commits one group (empty past the last
  // item or for a head past H)
  const int n_items = (n_s + 1) * HG;
  auto copy_item = [&](int k) {
    if (k < n_items) {
      unsigned char* st = ring + (k % kStages) * L.stage;
      if (k < n_s * HG) {
        const int hi = k % HG, s0 = (k / HG) * BS, h = h0 + hi;
        if (hi < hg_n) {
          if (hi == 0)
            copy_rows<TC>(reinterpret_cast<TC*>(st), L.ldc, b + s0 * p.b_st,
                          p.b_st, BS, p.q - s0, n8, p.n, p.cw_b, tid);
          copy_rows<TX>(reinterpret_cast<TX*>(st + L.x_off), L.ldx,
                        x + h * p.x_sh + s0 * p.x_st, p.x_st, BS, p.q - s0,
                        PMAX, p.p, p.cw_x, tid);
          float* cd = reinterpret_cast<float*>(st + L.cum_off);
          for (int e = tid; e < 2 * BS; e += kThreads) {
            const int s = s0 + e % BS;
            const float* src = e < BS ? cum + h * p.cum_sh + s * p.cum_st
                                      : dt + h * p.dt_sh + s * p.dt_st;
            cp_async<4>(cd + e, s < p.q ? src : cum, s < p.q ? 4 : 0);
          }
        }
      } else {
        const int h = h0 + k - n_s * HG;
        if (h < p.heads)
          copy_rows<float>(reinterpret_cast<float*>(st), L.lds,
                           state + h * p.st_sh, p.st_sp, PMAX, p.p, n8, p.n,
                           p.cw_st, tid);
      }
    }
    cp_async_commit();
  };
  // item k has landed for every thread, every thread is done with item
  // k - 1, whose stage the next copy refills
  auto advance = [&](int k) {
    cp_async_wait_all();
    __syncthreads();
    copy_item(k + 1);
  };

  // A fragments of C_t for the k8 step kk over N (dims 2t, 2t + 1 in slots
  // t, t + 4), split into hi and lo, or (bf16) hi
  auto c_frag = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t h2[2], l2[2] = {0u, 0u};
      pair_parts(cs + (r ? rl1 : rl0) * L.ldc + kk * 8 + 2 * t4, h2, l2);
      ah[r] = h2[0];
      ah[r + 2] = h2[1];
      al[r] = l2[0];
      al[r + 2] = l2[1];
    }
  };

  float acc[HG][NPW][4];
#pragma unroll
  for (int hi = 0; hi < HG; ++hi)
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[hi][n][i] = 0.f;

  copy_rows<TC>(const_cast<TC*>(cs), L.ldc, c + t0 * p.c_st, p.c_st, BT,
                p.q - t0, n8, p.n, p.cw_c, tid);
  copy_item(0);                             // one group: C_t and item 0

  int k = 0;
  for (int si = 0; si < n_s; ++si) {
    const int s0 = si * BS;
    const int dl = s0 - t0;                 // s - t of the tiles' first rows
    const bool diag = dl >= 0;              // a tile the diagonal crosses
    // n8 tiles of s that hold an s <= t for a row of this warp (M x skips
    // the rest; S is formed whole: branching around its products costs more)
    const int j_end = diag ? max(0, min(NJ, (16 * rw + 16 - dl) / 8)) : NJ;
    // this warp's rows are s-rows of this tile: D x_t is added from it
    const bool own_x = diag && 16 * rw >= dl && 16 * rw < dl + BS;
    float S[NJ][4];                         // C_t B_s^T, this warp's rows
#pragma unroll
    for (int hi = 0; hi < HG; ++hi, ++k) {
      advance(k);
      if (hi >= hg_n || !w_rows) continue;
      const unsigned char* st = ring + (k % kStages) * L.stage;
      if (hi == 0) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) S[j][i] = 0.f;
        const TC* bs = reinterpret_cast<const TC*>(st);
        for (int kk = 0; kk < nk; ++kk) {
          uint32_t ah[4], al[4], bh[NJ][2], bl[NJ][2];
          c_frag(kk, ah, al);
#pragma unroll
          for (int j = 0; j < NJ; ++j)      // (dims 2t, 2t + 1; s = 8j + g)
            pair_parts(bs + (8 * j + g8) * L.ldc + kk * 8 + 2 * t4, bh[j],
                       bl[j]);
          mma_split<kCSplit, kCSplit>(S, 0, ah, al, bh, bl);
        }
      }
      const TX* xs = reinterpret_cast<const TX*>(st + L.x_off);
      const float* cum_s = reinterpret_cast<const float*>(st + L.cum_off);
      const float* dt_s = cum_s + BS;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j >= j_end) break;
        // M = S o exp(cum_t - cum_s) o dt_s for (row, s = 8j + 2t + e);
        // on the diagonal, exactly 0 where s > t or t >= Q
        const float2 cs2 = *reinterpret_cast<const float2*>(cum_s + 8 * j +
                                                            2 * t4);
        const float2 ds2 = *reinterpret_cast<const float2*>(dt_s + 8 * j +
                                                            2 * t4);
        float m[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rl = i < 2 ? rl0 : rl1, sl = 8 * j + 2 * t4 + (i & 1);
          const float v = S[j][i] *
                          decay_exp(ct[hi][i >> 1] - (i & 1 ? cs2.y : cs2.x)) *
                          (i & 1 ? ds2.y : ds2.x);
          m[i] = !diag || (dl + sl <= rl && t0 + rl < p.q) ? v : 0.f;
        }
        // A: slot t is s = 2t, slot t + 4 s = 2t + 1, rows r0 and r1
        uint32_t ah[4], al[4];
        split(m[0], ah[0], al[0]);
        split(m[2], ah[1], al[1]);
        split(m[1], ah[2], al[2]);
        split(m[3], ah[3], al[3]);
        const TX* xp = xs + (8 * j + 2 * t4) * L.ldx + 2 * g8;
#pragma unroll
        for (int n0 = 0; n0 < NPW; n0 += NV) {
          uint32_t bh[NV][2], bl[NV][2], h2[2], l2[2];
#pragma unroll
          for (int mm = 0; mm < NV / 2; ++mm)
#pragma unroll
            for (int kr = 0; kr < 2; ++kr) {  // s = 2t, 2t + 1
              pair_parts(xp + kr * L.ldx + (mbase + n0 / 2 + mm) * 16, h2,
                         l2);
              bh[2 * mm][kr] = h2[0];
              bl[2 * mm][kr] = l2[0];
              bh[2 * mm + 1][kr] = h2[1];
              bl[2 * mm + 1][kr] = l2[1];
            }
          mma_split<true, kXSplit>(acc[hi], n0, ah, al, bh, bl);
        }
      }
      if (own_x) {                          // D x_t, x_t from this tile
        const float d_h = p.dskip[h0 + hi];
#pragma unroll
        for (int n = 0; n < NPW; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = 16 * (mbase + n / 2) + 4 * t4 + 2 * (i & 1) +
                            n % 2;
            acc[hi][n][i] += d_h * to_f(xs[((i < 2 ? rl0 : rl1) - dl) *
                                               L.ldx + col]);
          }
      }
    }
  }

  // the carried state: acc += exp(cum_t) (C_t state^T), one head an item
  const float* sts = reinterpret_cast<const float*>(ring);
#pragma unroll
  for (int hi = 0; hi < HG; ++hi, ++k) {
    advance(k);
    if (hi >= hg_n || !w_rows) continue;
    const float* sp = sts + (k % kStages) * (L.stage / 4);
    float tmp[NPW][4];
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) tmp[n][i] = 0.f;
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t ah[4], al[4];
      c_frag(kk, ah, al);
#pragma unroll
      for (int n0 = 0; n0 < NPW; n0 += NV) {
        uint32_t bh[NV][2], bl[NV][2];
#pragma unroll
        for (int n = 0; n < NV; ++n) {        // state row 16m + 2g + e
          const int row = 16 * (mbase + (n0 + n) / 2) + 2 * g8 + (n & 1);
          pair_parts(sp + row * L.lds + kk * 8 + 2 * t4, bh[n], bl[n]);
        }
        mma_split<kCSplit, true>(tmp, n0, ah, al, bh, bl);
      }
    }
    const float e0 = decay_exp(ct[hi][0]), e1 = decay_exp(ct[hi][1]);
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[hi][n][i] += (i < 2 ? e0 : e1) * tmp[n][i];
  }
  cp_async_wait_all();                      // only empty groups are left
  if (!w_rows) return;

  // acc[hi][n][i] is row r0 (i < 2) or r1, column 16 (n / 2) + 4t +
  // 2 (i & 1) + n % 2 of the warp's tiles: a lane holds 4 neighbouring
  // columns 16m + 4t .. + 3 of each row
#pragma unroll
  for (int hi = 0; hi < HG; ++hi) {
    if (hi >= hg_n) break;
    TX* y = static_cast<TX*>(p.y) + g * p.y_sg + (h0 + hi) * p.y_sh;
    const bool vec = (reinterpret_cast<uintptr_t>(y) %
                      (4 * sizeof(TX))) == 0 &&
                     (p.y_st * static_cast<long long>(sizeof(TX))) %
                             (4 * sizeof(TX)) == 0;
#pragma unroll
    for (int mm = 0; mm < NPP; ++mm) {
      const int col = 16 * (mbase + mm) + 4 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = t0 + (r ? rl1 : rl0);
        if (t >= p.q || col >= p.p) continue;
        const float v[4] = {acc[hi][2 * mm][2 * r], acc[hi][2 * mm + 1][2 * r],
                            acc[hi][2 * mm][2 * r + 1],
                            acc[hi][2 * mm + 1][2 * r + 1]};
        TX* out = y + t * p.y_st + col;
        if (vec && col + 3 < p.p) {
          if constexpr (sizeof(TX) == 4) {
            *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
          } else {
            __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
            __nv_bfloat162 hi2 = __floats2bfloat162_rn(v[2], v[3]);
            uint2 w;
            w.x = *reinterpret_cast<uint32_t*>(&lo);
            w.y = *reinterpret_cast<uint32_t*>(&hi2);
            *reinterpret_cast<uint2*>(out) = w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < p.p) out[e] = from_f<TX>(v[e]);
        }
      }
    }
  }
}

// the largest copy (16, 8 or 4 bytes; 2: bf16 element loads) that every
// row of a view with this base and these element strides allows
int copy_bytes(const void* base, int elem, const long long* strides,
               int count) {
  for (int w = 16; w >= 4; w /= 2) {
    bool ok = reinterpret_cast<uintptr_t>(base) % w == 0;
    for (int i = 0; i < count; ++i) ok = ok && (strides[i] * elem) % w == 0;
    if (ok) return w;
  }
  return elem;
}

template <typename TC, typename TX, int PMAX>
int launch(Args p, cudaStream_t stream) {
  auto* kernel = ssd_kernel<TC, TX, PMAX>;
  // once per configuration (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Layout l = layout(p.n, PMAX, sizeof(TC), sizeof(TX));
  if (l.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long c_str[2] = {p.c_sg, p.c_st}, b_str[2] = {p.b_sg, p.b_st};
  const long long x_str[3] = {p.x_sg, p.x_sh, p.x_st};
  const long long s_str[3] = {p.st_sg, p.st_sh, p.st_sp};
  p.cw_c = copy_bytes(p.c, sizeof(TC), c_str, 2);
  p.cw_b = copy_bytes(p.b, sizeof(TC), b_str, 2);
  p.cw_x = copy_bytes(p.x, sizeof(TX), x_str, 3);
  p.cw_st = copy_bytes(p.state, 4, s_str, 3);
  const long long blocks = static_cast<long long>(p.cells) *
                           ((p.heads + HG - 1) / HG) * ((p.q + BT - 1) / BT);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, l.total, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TC, typename TX>
int launch_p(const Args& p, cudaStream_t stream) {
  if (p.p <= 32) return launch<TC, TX, 32>(p, stream);
  if (p.p <= 64) return launch<TC, TX, 64>(p, stream);
  return launch<TC, TX, 128>(p, stream);
}

template <typename TC, typename TX>
cudaError_t attrs_p(int p, cudaFuncAttributes* a) {
  if (p <= 32) return cudaFuncGetAttributes(a, ssd_kernel<TC, TX, 32>);
  if (p <= 64) return cudaFuncGetAttributes(a, ssd_kernel<TC, TX, 64>);
  return cudaFuncGetAttributes(a, ssd_kernel<TC, TX, 128>);
}

}  // namespace

// strides: 19 element strides in the order of Args (c_sg .. st_sp).
// Returns the CUDA error of the launch (0 on success). cb_dtype and x_dtype
// 0: float32, 1: bfloat16.
extern "C" int ssd_chunk_fwd(int cb_dtype, int x_dtype, const void* c,
                             const void* b, const void* x, const float* cum,
                             const float* dt, const float* state,
                             const float* dskip, void* y,
                             const long long* strides, int cells, int heads,
                             int q, int n, int p, void* stream) {
  if (cells <= 0 || heads <= 0 || q <= 0 || n <= 0 || p <= 0 || p > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.c = c;
  a.b = b;
  a.x = x;
  a.cum = cum;
  a.dt = dt;
  a.state = state;
  a.dskip = dskip;
  a.y = y;
  long long* s[19] = {&a.c_sg,   &a.c_st,   &a.b_sg,   &a.b_st,  &a.x_sg,
                      &a.x_sh,   &a.x_st,   &a.y_sg,   &a.y_sh,  &a.y_st,
                      &a.cum_sg, &a.cum_sh, &a.cum_st, &a.dt_sg, &a.dt_sh,
                      &a.dt_st,  &a.st_sg,  &a.st_sh,  &a.st_sp};
  for (int i = 0; i < 19; ++i) *s[i] = strides[i];
  a.cells = cells;
  a.heads = heads;
  a.q = q;
  a.n = n;
  a.p = p;
  auto st = static_cast<cudaStream_t>(stream);
  switch (cb_dtype < 0 || cb_dtype > 1 || x_dtype < 0 || x_dtype > 1
              ? -1 : 2 * cb_dtype + x_dtype) {
    case 0: return launch_p<float, float>(a, st);
    case 1: return launch_p<float, __nv_bfloat16>(a, st);
    case 2: return launch_p<__nv_bfloat16, float>(a, st);
    case 3: return launch_p<__nv_bfloat16, __nv_bfloat16>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The compiled kernel's registers a thread and local (spilled) bytes a
// thread for these dtypes at this P (the sweep's spill check). Returns the
// CUDA error (0 on success).
extern "C" int ssd_kernel_attrs(int cb_dtype, int x_dtype, int p, int* regs,
                                int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t err;
  switch (cb_dtype < 0 || cb_dtype > 1 || x_dtype < 0 || x_dtype > 1
              ? -1 : 2 * cb_dtype + x_dtype) {
    case 0: err = attrs_p<float, float>(p, &a); break;
    case 1: err = attrs_p<float, __nv_bfloat16>(p, &a); break;
    case 2: err = attrs_p<__nv_bfloat16, float>(p, &a); break;
    case 3: err = attrs_p<__nv_bfloat16, __nv_bfloat16>(p, &a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
