// The fp32 tile product shared by the dense-stack forward and backward
// kernels (dense_stack_fwd.cu, dense_stack_bwd.cu), for Hopper (sm_90a).
//
//   out[:, :n] (+)= act(A @ W + b)        A (m, K1 + K2), W (K1 + K2, n)
//
// A is given as two column segments [A1 | A2] in the logical row order of
// W (so d2rl's [h | x] input never exists as one tensor), each either
// row-major (TA = false: A[r][k] at a[r * lda + k]) or stored transposed
// (TA = true: at a[k * lda + r], the dW product's stream^T). W is row-major
// (TW = false: W[k][c] at w[k * ldw + c]) or stored transposed (TW = true:
// at w[c * ldw + k], the dx product's W^T). The epilogue adds the bias (if
// any), optionally stores the pre-activation to `zout` (the backward's
// saved z), applies the activation, and either overwrites `out` or adds to
// it (the backward's gradient-stream accumulation).
//
// Blocks tile the output over (rows, columns) and may split the reduction
// across gridDim.y; split partials go to a workspace and the last block of
// a tile to finish (counted with an integer atomic) sums them in fixed
// split order, so the result is the same whatever order blocks ran in.
// Loads map neighbouring threads to neighbouring addresses for each of the
// four layouts; shared tiles are padded by one column against conflicts.
//
// Member launches (a fleet's E members in one launch): blockIdx.z is the
// member, every operand sits at its member's offset (a stride in elements,
// 0 for an operand all members share), and the split partials and tile
// counters are the member's own set. A member's blocks run exactly a solo
// launch's arithmetic, so member e is bitwise the solo launch on its
// operands. The member kernels are kernels of their own, taking the
// strides as one more argument; the solo kernels keep their arguments and
// code, so they compile as before.
#pragma once

#include <cuda_runtime.h>

namespace dense_tile {

constexpr int kThreads = 256;

enum Act { kIdentity = 0, kRelu = 1, kTanh = 2, kSwish = 3 };

__device__ __forceinline__ float apply_act(float z, int act) {
  switch (act) {
    case kRelu: return fmaxf(z, 0.f);
    case kTanh: return tanhf(z);
    case kSwish: return z / (1.f + expf(-z));   // z * sigmoid(z)
    default: return z;
  }
}

// Programmatic dependent launch (Hopper): a kernel that `launch_pdl`
// launches may start while the kernel before it on the stream finishes its
// last blocks, so its launch and block scheduling overlap that tail. It
// waits at pdl_wait() until the kernel before it has completed and its
// writes are visible, before touching memory; pdl_trigger() lets the next
// kernel launch once every block of this one has passed it, here after
// the main loop: a block of the next kernel resident and waiting beside a
// computing one slows it (PERF.md). Both are no-ops in a kernel
// launched plainly (<<<>>>), as the backward's are.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename... Params, typename... Args>
int launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block,
               cudaStream_t stream, const Args&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  cudaGetLastError();                       // returned here, not kept
  return static_cast<int>(err);
}

// dst_t (cols, rows) of row stride ldt = src (rows, cols)^T, through a
// 32 x 33 shared tile so reads and writes are all whole rows; with COPY,
// src is also copied into dst (rows, cols) of row stride ldd. The
// backward's W^T (dense_stack_bwd.cu, COPY = false) and the forward's x
// into the stream and stream^T (dense_stack_fwd.cu, COPY = true).
constexpr int kTrTile = 32, kTrRowGroups = 8;

template <bool COPY>
__device__ __forceinline__ void transpose_run(const float* src,
                                              long long lds, float* dst_t,
                                              long long ldt, float* dst,
                                              long long ldd, int rows,
                                              int cols) {
  __shared__ float tile[kTrTile][kTrTile + 1];
  const int tx = threadIdx.x % kTrTile, ty = threadIdx.x / kTrTile;
  const int r0 = blockIdx.y * kTrTile, c0 = blockIdx.x * kTrTile;
#pragma unroll
  for (int j = 0; j < kTrTile / kTrRowGroups; ++j) {
    const int r = r0 + ty + j * kTrRowGroups, c = c0 + tx;
    if (r < rows && c < cols) {
      const float v = src[r * lds + c];
      if constexpr (COPY) dst[r * ldd + c] = v;
      tile[ty + j * kTrRowGroups][tx] = v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTrTile / kTrRowGroups; ++j) {
    const int c = c0 + ty + j * kTrRowGroups, r = r0 + tx;
    if (c < cols && r < rows)
      dst_t[c * ldt + r] = tile[tx][ty + j * kTrRowGroups];
  }
}

template <bool COPY>
__global__ void __launch_bounds__(kTrTile * kTrRowGroups)
transpose_kernel(const float* src, long long lds, float* dst_t,
                 long long ldt, float* dst, long long ldd, int rows,
                 int cols) {
  transpose_run<COPY>(src, lds, dst_t, ldt, dst, ldd, rows, cols);
}

// member blockIdx.z; ss, st, sd: the member strides of src, dst_t, dst
template <bool COPY>
__global__ void __launch_bounds__(kTrTile * kTrRowGroups)
transpose_members(const float* src, long long lds, float* dst_t,
                  long long ldt, float* dst, long long ldd, int rows,
                  int cols, long long ss, long long st, long long sd) {
  const long long e = blockIdx.z;
  transpose_run<COPY>(src + e * ss, lds, dst_t + e * st, ldt,
                      COPY ? dst + e * sd : dst, ldd, rows, cols);
}

// Launches transpose_kernel (COPY when `dst` is given); returns the CUDA
// error (0 on success). With `members` > 0, one launch of
// transpose_members for that many members, `ss`, `st`, `sd` the member
// strides of src, dst_t and dst.
inline int launch_transpose(const float* src, long long lds, float* dst_t,
                            long long ldt, float* dst, long long ldd,
                            int rows, int cols, cudaStream_t stream,
                            int members = 0, long long ss = 0,
                            long long st = 0, long long sd = 0) {
  if (rows <= 0 || cols <= 0 || lds < cols || ldt < rows ||
      (dst != nullptr && ldd < cols) || members < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cols + kTrTile - 1) / kTrTile,
                  (rows + kTrTile - 1) / kTrTile, members > 0 ? members : 1);
  const int threads = kTrTile * kTrRowGroups;
  if (members > 0 && dst != nullptr)
    transpose_members<true><<<grid, threads, 0, stream>>>(
        src, lds, dst_t, ldt, dst, ldd, rows, cols, ss, st, sd);
  else if (members > 0)
    transpose_members<false><<<grid, threads, 0, stream>>>(
        src, lds, dst_t, ldt, dst, ldd, rows, cols, ss, st, sd);
  else if (dst != nullptr)
    transpose_kernel<true><<<grid, threads, 0, stream>>>(
        src, lds, dst_t, ldt, dst, ldd, rows, cols);
  else
    transpose_kernel<false><<<grid, threads, 0, stream>>>(
        src, lds, dst_t, ldt, dst, ldd, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

struct TileArgs {
  const float* a1; long long lda1; int k1;   // A segment 1 (logical k 0..k1)
  const float* a2; long long lda2; int k2;   // A segment 2 (k2 may be 0)
  const float* w; long long ldw;             // (k1 + k2, n), layout TW
  const float* b;                            // (n,) or null
  float* out; long long ldo;                 // output block, row stride ldo
  float* zout; long long ldz;                // pre-activation copy, or null
  float* ws;                                 // (splits, m, n) partials
  int* counters;                             // one per output tile, zeroed
  int m, n, act, accumulate, splits, chunks_per_split;
};

// a member launch's strides in elements (0: shared by every member)
struct TileStrides {
  long long a1, a2, w, b, out, z;
};

// the arguments of member blockIdx.z: its operands, and its own set of
// split partials and of tile counters (gridDim.x of them)
__device__ __forceinline__ TileArgs at_member(TileArgs p,
                                              const TileStrides& s) {
  const long long e = blockIdx.z;
  p.a1 += e * s.a1;
  if (p.a2 != nullptr) p.a2 += e * s.a2;
  p.w += e * s.w;
  if (p.b != nullptr) p.b += e * s.b;
  p.out += e * s.out;
  if (p.zout != nullptr) p.zout += e * s.z;
  if (p.ws != nullptr)
    p.ws += e * p.splits * static_cast<long long>(p.m) * p.n;
  if (p.counters != nullptr) p.counters += e * gridDim.x;
  return p;
}

template <int BM, int BN, int BK, int TM, int TN, bool TA, bool TW>
__device__ __forceinline__ void tile_run(const TileArgs& p) {
  pdl_wait();
  constexpr int TX = BN / TN;               // threads along the columns
  constexpr int TY = BM / TM;               // threads along the rows
  static_assert(TX * TY == kThreads, "one output micro-tile per thread");
  constexpr int A_LOADS = BM * BK / kThreads;
  constexpr int W_LOADS = BK * BN / kThreads;
  static_assert(A_LOADS * kThreads == BM * BK, "A tile splits evenly");
  static_assert(W_LOADS * kThreads == BK * BN, "W tile splits evenly");

  __shared__ float As[BK][BM + 1];          // transposed; +1 avoids conflicts
  __shared__ float Ws[BK][BN + 1];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int tiles_n = (p.n + BN - 1) / BN;
  const int tile = blockIdx.x;
  const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
  const int split = blockIdx.y;
  const int k_total = p.k1 + p.k2;
  const int k_begin = split * p.chunks_per_split * BK;
  const int k_end = min(k_total, k_begin + p.chunks_per_split * BK);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float a_reg[A_LOADS], w_reg[W_LOADS];

  // element e of a tile -> (row r, depth c): neighbouring threads walk the
  // stored array's contiguous dimension
  auto a_pos = [](int e, int& r, int& c) {
    if (TA) { r = e % BM; c = e / BM; } else { r = e / BK; c = e % BK; }
  };
  auto w_pos = [](int e, int& r, int& c) {
    if (TW) { r = e % BK; c = e / BK; } else { r = e / BN; c = e % BN; }
  };
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < A_LOADS; ++j) {
      int r, c;
      a_pos(tid + j * kThreads, r, c);
      const int gm = m0 + r, gk = k0 + c;
      float v = 0.f;
      if (gm < p.m && gk < k_end) {
        if (TA) {
          v = gk < p.k1 ? p.a1[gk * p.lda1 + gm]
                        : p.a2[(gk - p.k1) * p.lda2 + gm];
        } else {
          v = gk < p.k1 ? p.a1[gm * p.lda1 + gk]
                        : p.a2[gm * p.lda2 + (gk - p.k1)];
        }
      }
      a_reg[j] = v;
    }
#pragma unroll
    for (int j = 0; j < W_LOADS; ++j) {
      int r, c;
      w_pos(tid + j * kThreads, r, c);
      const int gk = k0 + r, gn = n0 + c;
      float v = 0.f;
      if (gk < k_end && gn < p.n)
        v = TW ? p.w[gn * p.ldw + gk] : p.w[gk * p.ldw + gn];
      w_reg[j] = v;
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int j = 0; j < A_LOADS; ++j) {
      int r, c;
      a_pos(tid + j * kThreads, r, c);
      As[c][r] = a_reg[j];
    }
#pragma unroll
    for (int j = 0; j < W_LOADS; ++j) {
      int r, c;
      w_pos(tid + j * kThreads, r, c);
      Ws[r][c] = w_reg[j];
    }
  };

  if (k_begin < k_end) load_tile(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                        // last tile's reads are done
    store_tile();
    __syncthreads();
    if (k0 + BK < k_end) load_tile(k0 + BK);   // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = Ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }
  pdl_trigger();

  auto epilogue = [&](int gm, int gn, float z) {
    if (p.b != nullptr) z += p.b[gn];
    if (p.zout != nullptr) p.zout[gm * p.ldz + gn] = z;
    float v = apply_act(z, p.act);
    float* o = p.out + gm * p.ldo + gn;
    *o = p.accumulate ? *o + v : v;
  };

  if (p.splits == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty + i * TY;
      if (gm >= p.m) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx + j * TX;
        if (gn < p.n) epilogue(gm, gn, acc[i][j]);
      }
    }
    return;
  }

  const long long plane = static_cast<long long>(p.m) * p.n;
  float* part = p.ws + split * plane;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= p.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < p.n) part[static_cast<long long>(gm) * p.n + gn] = acc[i][j];
    }
  }
  __threadfence();                          // partials visible device-wide
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&p.counters[tile], 1) == p.splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= p.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn >= p.n) continue;
      const long long off = static_cast<long long>(gm) * p.n + gn;
      float z = 0.f;
      for (int s = 0; s < p.splits; ++s) z += __ldcg(p.ws + s * plane + off);
      epilogue(gm, gn, z);
    }
  }
  if (tid == 0) p.counters[tile] = 0;       // leave the counters reusable
}

template <int BM, int BN, int BK, int TM, int TN, bool TA, bool TW>
__global__ void __launch_bounds__(kThreads) tile_kernel(const TileArgs p) {
  tile_run<BM, BN, BK, TM, TN, TA, TW>(p);
}

template <int BM, int BN, int BK, int TM, int TN, bool TA, bool TW>
__global__ void __launch_bounds__(kThreads)
tile_members(const TileArgs p, const TileStrides s) {
  tile_run<BM, BN, BK, TM, TN, TA, TW>(at_member(p, s));
}

// with `s`, one launch of tile_members for `members` members
template <int BM, int BN, int BK, int TM, int TN, bool TA, bool TW>
int launch(const TileArgs& p, cudaStream_t stream, bool pdl,
           const TileStrides* s = nullptr, int members = 0) {
  const int tiles = ((p.m + BM - 1) / BM) * ((p.n + BN - 1) / BN);
  if (s != nullptr) {
    const dim3 grid(tiles, p.splits, members);
    if (pdl)
      return launch_pdl(tile_members<BM, BN, BK, TM, TN, TA, TW>, grid,
                        dim3(kThreads), stream, p, *s);
    tile_members<BM, BN, BK, TM, TN, TA, TW>
        <<<grid, kThreads, 0, stream>>>(p, *s);
    return static_cast<int>(cudaGetLastError());
  }
  if (pdl)
    return launch_pdl(tile_kernel<BM, BN, BK, TM, TN, TA, TW>,
                      dim3(tiles, p.splits), dim3(kThreads), stream, p);
  tile_kernel<BM, BN, BK, TM, TN, TA, TW>
      <<<dim3(tiles, p.splits), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

inline bool args_ok(const TileArgs& p) {
  return p.m > 0 && p.n > 0 && p.k1 > 0 && p.k2 >= 0 && p.splits >= 1 &&
         p.chunks_per_split >= 1 && p.act >= kIdentity && p.act <= kSwish &&
         (p.splits == 1 || (p.ws != nullptr && p.counters != nullptr));
}

// Tile configurations, indexed by `config` (mirrored by stack.py's
// _CONFIGS): (BM, BN, BK) = (16, 64, 32), (32, 64, 32), (64, 64, 16). The
// backward's products; the forward launches config 2 itself
// (dense_stack_fwd.cu), as a programmatic dependent launch.
template <bool TA, bool TW>
int launch_config(int config, const TileArgs& p, cudaStream_t stream,
                  const TileStrides* s = nullptr, int members = 0) {
  if (!args_ok(p) || (s != nullptr && members < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (config) {
    case 0: return launch<16, 64, 32, 1, 4, TA, TW>(p, stream, false, s,
                                                    members);
    case 1: return launch<32, 64, 32, 2, 4, TA, TW>(p, stream, false, s,
                                                    members);
    case 2: return launch<64, 64, 16, 4, 4, TA, TW>(p, stream, false, s,
                                                    members);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace dense_tile
