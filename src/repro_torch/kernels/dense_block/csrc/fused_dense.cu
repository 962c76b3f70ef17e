// The fused dense layer out = act(sum_seg A_seg @ W[rows_seg] + b), for
// Hopper (sm_90a), on the tensor cores in split-precision TF32.
//
// Replaces: src/repro/kernels/dense_block/dense_block.py::_kernel (launched
// by fused_dense), and with it the per-part loop of ops.dense_concat_matmul.
// The TPU kernel is a (bm, bn, bk) grid with an fp32 VMEM accumulator carried
// across the sequential K axis, bias and activation on the last K step, and
// callers pad M, K and N to the blocks; dense_concat_matmul makes one
// pallas_call per part and sums the parts' products (each rounded to the
// input dtype) outside. Here ONE launch takes the A operand as any number of
// column segments (up to kMaxSegs), each with its own pointer and row stride,
// in the row order of W: the DenseNet concat [x | y_0 | ... ] never exists,
// and the parts are summed in the fp32 accumulator and rounded once, as
// ref.dense_concat_matmul_ref does. Ragged M, K (per segment) and N edges are
// masked, so nothing is padded. Inputs are float32 or bfloat16 (A, W and b
// of one type); the output has the input type.
//
// Bound on the H100: the paper's Ant DenseNet layer 3 (M=256, K=4207,
// N=2048) is 4.41 GFLOP: 66 us of fp32 FMAs outside the tensor cores, which
// a SIMT tile reaches at a third to a half of (its shared-memory loads set
// the pace). The tensor cores do TF32 at 495 TFLOP/s, but TF32 keeps 10
// mantissa bits and misses the 1e-4 agreement with the fp32 reference. So
// each fp32 operand is split where its fragment is loaded from shared
// memory: hi = x rounded to TF32 (to nearest, ties away, as
// cvt.rna.tf32.f32), lo = x - hi (exact in fp32; the MMA truncates it to
// TF32, 2^-21 of x), and three products lo*hi, hi*lo, hi*hi go into the one
// fp32 accumulator; lo*lo (2^-22 of the product) is dropped ("3xTF32", as
// CUTLASS's OpMultiplyAddFastF32; three integer or fp32 operations an
// operand). Bound: 3 x 4.41 GFLOP at 495 TFLOP/s = 26.7 us. A bfloat16
// value is exact in TF32: one product.
//
// Design. A block of 8 warps (2 along M x 4 along N) owns a 64x64 output
// tile, each warp a 32x16 block of m16n8k8 MMAs
// (mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32); a 128x128 tile of
// 16 warps is kept for the card sweep, where it lost at every shape
// (dense_block.py's plan and PERF.md). A wants its
// fragment along K and the parts are row-major (M, k_i), so they are staged
// as they are; W is row-major (K, N) and the B fragment is read from it by
// scalar loads (k = lane % 4 (+4), n = lane / 4). wgmma would need B along
// K too: a transpose of W per call. K walks in chunks of BK = 32 that never
// straddle a segment, through a ring of kStages = 4 shared stages filled by
// cp.async (16-byte copies where a segment's address and row stride allow,
// 4-byte ones elsewhere, such as the [111 | ...] part; the copy's source
// size zero-fills the ragged edges); while one stage computes, three are in
// flight. Shared rows are padded (A by 4 floats, B by 8) so that every
// fragment load of a warp hits 32 distinct banks. When the output has too
// few tiles to fill the 132 SMs, the chunks are split across gridDim.y, the
// splits write fp32 partials to a workspace, and the last block of a tile to
// finish (an integer atomic counter picks it) sums them in fixed split
// order, so results are bitwise the same from run to run. Bias and
// activation (identity, relu, tanh, swish/silu, gelu with the tanh
// approximation of jax.nn.gelu) run in that epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSegs = 128;
constexpr int BK = 32;            // K of a chunk, one ring stage
constexpr int kStages = 4;

enum Act { kIdentity = 0, kRelu = 1, kTanh = 2, kSwish = 3, kGelu = 4 };

struct Args {
  const void* a[kMaxSegs];   // segment s: (m, k[s]) with row stride lda[s]
  int lda[kMaxSegs];
  int k[kMaxSegs];
  int nseg;
  const void* w;             // (sum k, n), row stride ldw
  long long ldw;
  const void* b;             // (n,) or null
  void* out;                 // (m, n), row stride ldo
  long long ldo;
  float* ws;                 // (splits, m, n) partials when splits > 1
  int* counters;             // one per output tile, zero, left zero
  int m, n, act, splits, chunks_per_split;
};

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
  return __float2bfloat16(v);              // round to nearest even
}

__device__ __forceinline__ float apply_act(float z, int act) {
  switch (act) {
    case kRelu: return fmaxf(z, 0.f);
    case kTanh: return tanhf(z);
    case kSwish: return z / (1.f + expf(-z));       // z * sigmoid(z)
    case kGelu: {
      const float c = 0.7978845608028654f;          // sqrt(2 / pi)
      return 0.5f * z * (1.f + tanhf(c * (z + 0.044715f * z * z * z)));
    }
    default: return z;
  }
}

// an operand's TF32 parts, as the MMA reads them (the top 19 bits of each
// register): fp32 splits into hi = x rounded to TF32, to nearest with ties
// away from zero (cvt.rna.tf32.f32's rounding: half an ulp added, the low
// 13 bits left for the MMA to drop), and lo = x - hi, exact in fp32, which
// the MMA truncates to TF32; bf16 is exact in TF32 (hi only)
__device__ __forceinline__ void tf32_parts(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}
__device__ __forceinline__ void tf32_parts(__nv_bfloat16 x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(__bfloat162float(x));
  lo = 0u;                                  // unused: one product
}

// d += a @ b on one m16n8k8 tile
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (0..16) bytes from src; the rest of 16 is zeroed.
// Through L1 (.ca): the L2-only form (.cg) fed the stages more slowly on
// the card
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
                                          const __nv_bfloat16* src,
                                          bool in) {
  *dst = in ? *src : __float2bfloat16(0.f);
}

__device__ __forceinline__ bool vec_ok(const void* p, long long ld,
                                       int elem_bytes) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
         (ld * elem_bytes) % 16 == 0;
}

// The shape of one tile configuration, in elements of T: a BM x BN block
// tile over WARPS_M x WARPS_N warps.
template <typename T, int BM, int BN, int WARPS_M, int WARPS_N>
struct Tile {
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's
  static constexpr int MT = WM / 16, NT = WN / 8;  // m16 x n8 MMA tiles
  static constexpr int EV = 16 / sizeof(T);        // elements of 16 bytes
  // A rows of BK + 4 floats: the fragment's (row g, k t) loads fall on
  // banks 4g + t; B rows of BN + 8: (k t, column g) on banks 8t + g
  static constexpr int LDA = BK + EV;
  static constexpr int LDB = BN + 8;
  static constexpr int A_STAGE = BM * LDA, B_STAGE = BK * LDB;
  static constexpr int kSmemBytes =
      kStages * (A_STAGE + B_STAGE) * static_cast<int>(sizeof(T));
  static_assert(MT >= 1 && NT >= 1, "a warp holds whole MMA tiles");
  static_assert((LDA * sizeof(T)) % 16 == 0 && (LDB * sizeof(T)) % 16 == 0,
                "16-byte aligned shared rows");
  static_assert(BM * BK % (EV * kThreads) == 0 &&
                    BK * BN % (EV * kThreads) == 0,
                "a stage's copies split evenly over the threads");
};

template <typename T, int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
    fused_dense_kernel(const __grid_constant__ Args p) {
  using TL = Tile<T, BM, BN, WARPS_M, WARPS_N>;
  constexpr int kThreads = TL::kThreads;
  constexpr int MT = TL::MT, NT = TL::NT, EV = TL::EV;
  constexpr int LDA = TL::LDA, LDB = TL::LDB;
  constexpr bool kSplit = sizeof(T) == 4;   // fp32: three products
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const a_ring = reinterpret_cast<T*>(smem_raw);
  T* const b_ring = a_ring + kStages * TL::A_STAGE;
  __shared__ int s_last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;     // the MMA fragments' row, col
  const int wm0 = (warp / WARPS_N) * TL::WM;
  const int wn0 = (warp % WARPS_N) * TL::WN;
  const int tiles_n = (p.n + BN - 1) / BN;
  const int tile = blockIdx.x;
  const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
  const int split = blockIdx.y;
  const T* const w = static_cast<const T*>(p.w);
  const bool vw = vec_ok(w, p.ldw, sizeof(T));

  // the chunks [c, c_end) of this split; the copy cursor: chunk c lies in
  // segment seg, whose first chunk is c_base and first row of W w_row
  int c = split * p.chunks_per_split;
  int total = 0;
  for (int s = 0; s < p.nseg; ++s) total += (p.k[s] + BK - 1) / BK;
  const int c_end = min(total, c + p.chunks_per_split);
  const int n_chunks = max(0, c_end - c);
  int seg = 0, c_base = 0, w_row = 0;

  // the next chunk of the split into ring stage `slot`; every call commits
  // one group (empty past the split's end)
  auto copy_next = [&](int slot) {
    if (c < c_end) {
      int nc = (p.k[seg] + BK - 1) / BK;
      while (c >= c_base + nc) {            // uniform across the block
        c_base += nc;
        w_row += p.k[seg];
        ++seg;
        nc = (p.k[seg] + BK - 1) / BK;
      }
      const int kseg = p.k[seg], k0 = (c - c_base) * BK;
      const T* a = static_cast<const T*>(p.a[seg]);
      const long long lda = p.lda[seg];
      T* as = a_ring + slot * TL::A_STAGE;
      T* bs = b_ring + slot * TL::B_STAGE;
      if (vec_ok(a, lda, sizeof(T))) {
#pragma unroll
        for (int j = 0; j < BM * BK / EV / kThreads; ++j) {
          const int e = tid + j * kThreads;
          const int r = e / (BK / EV), kk = (e % (BK / EV)) * EV;
          const int gm = m0 + r, gk = k0 + kk;
          const int left = gm < p.m ? kseg - gk : 0;
          const int bytes = left > 0 ? sizeof(T) * min(EV, left) : 0;
          cp_async16(as + r * LDA + kk, bytes ? a + gm * lda + gk : a, bytes);
        }
      } else {
#pragma unroll 4
        for (int j = 0; j < BM * BK / kThreads; ++j) {
          const int e = tid + j * kThreads;
          const int r = e / BK, kk = e % BK;
          const int gm = m0 + r, gk = k0 + kk;
          const bool in = gm < p.m && gk < kseg;
          copy_elem(as + r * LDA + kk, in ? a + gm * lda + gk : a, in);
        }
      }
      const T* wc = w + static_cast<long long>(w_row + k0) * p.ldw;
      if (vw) {
#pragma unroll
        for (int j = 0; j < BK * BN / EV / kThreads; ++j) {
          const int e = tid + j * kThreads;
          const int r = e / (BN / EV), nn = (e % (BN / EV)) * EV;
          const int gn = n0 + nn;
          const int left = k0 + r < kseg ? p.n - gn : 0;
          const int bytes = left > 0 ? sizeof(T) * min(EV, left) : 0;
          cp_async16(bs + r * LDB + nn, bytes ? wc + r * p.ldw + gn : w,
                     bytes);
        }
      } else {
#pragma unroll 4
        for (int j = 0; j < BK * BN / kThreads; ++j) {
          const int e = tid + j * kThreads;
          const int r = e / BN, nn = e % BN;
          const int gn = n0 + nn;
          const bool in = k0 + r < kseg && gn < p.n;
          copy_elem(bs + r * LDB + nn, in ? wc + r * p.ldw + gn : w, in);
        }
      }
      ++c;
    }
    cp_async_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) copy_next(s);
  for (int it = 0; it < n_chunks; ++it) {
    cp_async_wait<kStages - 2>();
    // chunk `it` has landed for every thread, and every thread is done
    // with chunk it - 1, whose stage the copy below refills
    __syncthreads();
    copy_next((it + kStages - 1) % kStages);
    const T* as = a_ring + (it % kStages) * TL::A_STAGE + (wm0 + g) * LDA + t;
    const T* bs = b_ring + (it % kStages) * TL::B_STAGE + t * LDB + wn0 + g;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const T* ap = as + i * 16 * LDA + ks * 8;
        tf32_parts(ap[0], ah[i][0], al[i][0]);             // (g, t)
        tf32_parts(ap[8 * LDA], ah[i][1], al[i][1]);       // (g + 8, t)
        tf32_parts(ap[4], ah[i][2], al[i][2]);             // (g, t + 4)
        tf32_parts(ap[8 * LDA + 4], ah[i][3], al[i][3]);   // (g+8, t+4)
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* bp = bs + ks * 8 * LDB + j * 8;
        tf32_parts(bp[0], bh[j][0], bl[j][0]);             // (k t, n g)
        tf32_parts(bp[4 * LDB], bh[j][1], bl[j][1]);       // (k t+4, n g)
      }
      if constexpr (kSplit) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
    }
  }
  cp_async_wait<0>();                       // only empty groups are left

  // acc[i][j][q] holds row m0 + wm0 + i*16 + g (+8 for q >= 2), column
  // n0 + wn0 + j*8 + 2t (+1 for odd q)
  auto for_each = [&](auto&& fn) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int gm = m0 + wm0 + i * 16 + g + (q >= 2 ? 8 : 0);
          const int gn = n0 + wn0 + j * 8 + 2 * t + (q & 1);
          if (gm < p.m && gn < p.n) fn(gm, gn, acc[i][j][q]);
        }
  };
  const T* bias = static_cast<const T*>(p.b);
  T* out = static_cast<T*>(p.out);
  auto epilogue = [&](int gm, int gn, float z) {
    if (bias != nullptr) z += to_f(bias[gn]);
    out[gm * p.ldo + gn] = from_f<T>(apply_act(z, p.act));
  };

  if (p.splits == 1) {
    for_each([&](int gm, int gn, float& v) { epilogue(gm, gn, v); });
    return;
  }

  const long long plane = static_cast<long long>(p.m) * p.n;
  float* part = p.ws + split * plane;
  for_each([&](int gm, int gn, float& v) {
    part[static_cast<long long>(gm) * p.n + gn] = v;
  });
  __threadfence();                          // partials visible device-wide
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&p.counters[tile], 1) == p.splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for_each([&](int gm, int gn, float&) {
    const long long off = static_cast<long long>(gm) * p.n + gn;
    float z = 0.f;
    for (int s = 0; s < p.splits; ++s) z += __ldcg(p.ws + s * plane + off);
    epilogue(gm, gn, z);
  });
  if (tid == 0) p.counters[tile] = 0;       // leave the counters reusable
}

template <typename T, int BM, int BN, int WARPS_M, int WARPS_N>
int launch(const Args& p, cudaStream_t stream) {
  using TL = Tile<T, BM, BN, WARPS_M, WARPS_N>;
  auto* kernel = fused_dense_kernel<T, BM, BN, WARPS_M, WARPS_N>;
  // once per configuration (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = ((p.m + BM - 1) / BM) * ((p.n + BN - 1) / BN);
  kernel<<<dim3(tiles, p.splits), TL::kThreads, TL::kSmemBytes, stream>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

// tile configurations by id (BM, BN, warps along M and N), mirrored by
// dense_block.py's TILES: the plan's 64x64 tile and, for the card sweep,
// the 128x128 one, which lost at every shape swept (PERF.md)
template <typename T>
int launch_config(int config, const Args& p, cudaStream_t stream) {
  switch (config) {
    case 0: return launch<T, 64, 64, 2, 4>(p, stream);
    case 1: return launch<T, 128, 128, 4, 4>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// BK and kMaxSegs are mirrored by dense_block.py (BK, MAX_PARTS), the
// configs by its TILES. Returns the CUDA error of the launch (0 on
// success). dtype 0: float32, 1: bfloat16. seg_ptr, seg_ld and seg_k are
// host arrays of nseg entries.
extern "C" int fused_dense_fwd(int config, int dtype, int nseg,
                               const long long* seg_ptr, const int* seg_ld,
                               const int* seg_k, const void* w,
                               long long ldw, const void* b, void* out,
                               long long ldo, float* ws, int* counters,
                               int m, int n, int act, int splits,
                               int chunks_per_split, void* stream) {
  if (nseg < 1 || nseg > kMaxSegs || m <= 0 || n <= 0 || splits < 1 ||
      chunks_per_split < 1 || act < kIdentity || act > kGelu ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  for (int s = 0; s < nseg; ++s) {
    if (seg_k[s] < 0) return static_cast<int>(cudaErrorInvalidValue);
    p.a[s] = reinterpret_cast<const void*>(seg_ptr[s]);
    p.lda[s] = seg_ld[s];
    p.k[s] = seg_k[s];
  }
  p.nseg = nseg;
  p.w = w;
  p.ldw = ldw;
  p.b = b;
  p.out = out;
  p.ldo = ldo;
  p.ws = ws;
  p.counters = counters;
  p.m = m;
  p.n = n;
  p.act = act;
  p.splits = splits;
  p.chunks_per_split = chunks_per_split;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_config<float>(config, p, st);
    case 1: return launch_config<__nv_bfloat16>(config, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
