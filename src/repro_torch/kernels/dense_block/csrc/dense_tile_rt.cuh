// The register-tiled fp32 tile product of the dense stack's wide products
// (dense_stack_bwd.cu, dense_stack_fwd.cu), for Hopper (sm_90a):
//
//   out (m, n) (+)= A^T @ B   A stored (K, m): a[k * lda + r]; B stored
//                             (K, n): b[k * ldb + c]; both run along the
//                             output's rows and columns, K is the reduction.
//
//   dW_i = inp_i^T @ gz     A = the forward's stream, B = gz, K = the batch
//   dx_i = gz @ W_i^T       A = gz^T, B = W_i^T, K = U (dense_stack_bwd.cu
//                           writes both transposes first)
//   z_i  = stream @ W_i     A = stream^T, B = W_i, K = d0 + i * U (the
//                           forward keeps a transposed copy of the stream)
//
// What bounds it: fp32 FMAs outside the tensor cores (the 1e-4 / 1e-3
// agreement with the fp32 reference rules out plain TF32; split-precision
// 3xTF32 would keep it, ROADMAP.md B). The product of
// dense_tile.cuh reads two scalar shared-memory words for every two FMAs
// (4x4 outputs a thread, one column of each operand per step), so the
// shared-memory pipe, not the FMA units, sets its pace (~20% of peak).
// Here 256 threads own a 128x128 (or 128x64) output tile and each thread
// an 8x8 (8x4) block: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
// tx*4 + {0..3} (and 64 + tx*4 + {0..3}). One K step reads those as four
// (three) float4 words and does 64 (32) FMAs: 16 FMAs per shared load.
// A warp's float4 reads are one contiguous 256-byte run of B and two
// broadcast words of A: no bank conflicts.
//
// Tiles of K (BK = 8) stream through a ring of kStages = 4 shared buffers
// filled by cp.async, with one __syncthreads per K step: while tile s
// computes, tiles s + 1 .. s + 3 are in flight. dx streams W_i^T from
// device memory, and with two buffers a lone block's FMAs for one tile
// took less time than the next tile's load. Row kk of a tile is a
// contiguous run of row k0 + kk of A or B, so the copies are plain row
// copies: 16 bytes at a time where the operand's address is 16-byte
// aligned and its row stride a multiple of 4 floats (the wrapper checks,
// and so does launch_config), single floats elsewhere, such as the stream
// in dW of the actor, whose row stride is 259 + 2 * 2048 = 4355. (Copying dx's operands in their stored
// layout, contiguous along K, and transposing them on the way into shared
// memory held an SM to about a third of its FMA rate on the card: a warp's
// copy then touches a 32-byte piece of each of several rows.)
//
// The epilogue is the caller's: `tile_body` hands it each thread's 4x4
// blocks of the result (rows gm0 .. gm0 + 3 with gm0 a multiple of 4,
// columns gn .. gn + 3), and it masks the ragged edge. The backward's
// (`StoreEpi`) writes `out` = the product, or the product + `c`, an addend
// that is `out` itself where the product adds into densenet's gradient
// stream, and the incoming gradient or the stream where the wrapper saves
// a copy, 16 bytes at a time where `out` and `c` allow it; the forward's
// adds the bias and applies the activation (dense_stack_fwd.cu). A split
// of K across gridDim.y writes partials to a workspace; the tile's last
// block to finish (an integer atomic counts them) sums the partials in
// fixed split order, runs the epilogue and resets its counter to 0, so
// results are bitwise the same from run to run and the counters can be
// reused. That sum loops over the splits outside and the thread's outputs
// inside, so a thread has all its loads of one split in flight at once.
//
// Member launches (dense_tile.cuh's note): blockIdx.z is the member, each
// operand at its member stride (0: shared), and each member has its own
// split partials and tile counters; the member kernels take the strides
// as one more argument, the solo kernels are unchanged, and member e is
// bitwise the solo launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dense_tile_rt {

constexpr int kThreads = 256;
constexpr int kBK = 8;
constexpr int kStages = 4;    // K tiles in the shared ring
constexpr int kPad = 4;       // keeps rows 16-byte aligned

struct Args {
  const float* a; long long lda;   // (K, m)
  const float* b; long long ldb;   // (K, n)
  float* out; long long ldo;
  const float* c; long long ldc;   // addend (may be out itself), or null
  float* ws;                       // (splits, m, ws_stride(n)), or null
  int* counters;                   // one per output tile, all zero
  int m, n, k, splits, chunks_per_split;
};

// row stride of the split workspace: n rounded up to 4 floats, so every
// partial row is 16-byte aligned (the workspace comes from the allocator)
__host__ __device__ __forceinline__ int ws_stride(int n) {
  return (n + 3) & ~3;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p,
                                                   long long ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (ld & 3) == 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (0..16) bytes from src; the rest of 16 is zeroed
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// cp.async of one float, or a zero when bytes == 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
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

// rows [k0, k0 + kBK) x columns [x0, x0 + X) of a (K, xs) array into
// dst[kBK][X + kPad], zero outside the array and past k_end
template <int X, bool VEC>
__device__ __forceinline__ void copy_rows(float (*dst)[X + kPad],
                                          const float* src, long long ld,
                                          int k0, int k_end, int x0, int xs,
                                          int tid) {
  if constexpr (VEC) {
    constexpr int N = X * kBK / 4;                    // float4s
#pragma unroll
    for (int j = 0; j < (N + kThreads - 1) / kThreads; ++j) {
      const int e = tid + j * kThreads;
      const int kk = e / (X / 4), x = (e % (X / 4)) * 4;
      const int gk = k0 + kk, gx = x0 + x;
      const bool in = gk < k_end && gx < xs;
      if (e < N)
        cp_async16(&dst[kk][x], in ? src + gk * ld + gx : src,
                   in ? 4 * min(4, xs - gx) : 0);
    }
  } else {
    constexpr int N = X * kBK;                        // floats
    static_assert(N % kThreads == 0, "tiles split evenly over the threads");
#pragma unroll
    for (int j = 0; j < N / kThreads; ++j) {
      const int e = tid + j * kThreads;
      const int kk = e / X, x = e % X;
      const int gk = k0 + kk, gx = x0 + x;
      const bool in = gk < k_end && gx < xs;
      cp_async4(&dst[kk][x], in ? src + gk * ld + gx : src, in ? 4 : 0);
    }
  }
}

// a member launch's strides in elements (0: shared by every member)
struct Strides {
  long long a, b, out, c;
};

// 16-byte copies of a (`vec` bit 0) or b (bit 1) need every member's rows
// aligned: their member strides multiples of 4 floats
inline bool strides_ok(const Strides& s, int vec) {
  return (!(vec & 1) || (s.a & 3) == 0) && (!(vec & 2) || (s.b & 3) == 0);
}

// the arguments of member blockIdx.z: its operands, its own split partials
// and its own tile counters (gridDim.x of them)
__device__ __forceinline__ Args at_member(Args p, const Strides& s) {
  const long long e = blockIdx.z;
  p.a += e * s.a;
  p.b += e * s.b;
  if (p.out != nullptr) p.out += e * s.out;
  if (p.c != nullptr) p.c += e * s.c;
  if (p.ws != nullptr)
    p.ws += e * p.splits * static_cast<long long>(p.m) * ws_stride(p.n);
  if (p.counters != nullptr) p.counters += e * gridDim.x;
  return p;
}

// every Args check of a launch; `vec` bit 0 (1): 16-byte copies of a, bit 1
// (2) of b
inline bool args_ok(const Args& p, int vec) {
  return p.m > 0 && p.n > 0 && p.k > 0 && p.splits >= 1 &&
         p.chunks_per_split >= 1 && vec >= 0 && vec <= 3 &&
         (p.splits == 1 || (p.ws != nullptr && p.counters != nullptr)) &&
         (!(vec & 1) || aligned16(p.a, p.lda)) &&
         (!(vec & 2) || aligned16(p.b, p.ldb));
}

// The backward's epilogue: out[gm, gn..gn+3] = v (+ c[gm, gn..gn+3]) for the
// rows of a 4x4 block, masked at the ragged edge.
struct StoreEpi {
  float* out; long long ldo;
  const float* c; long long ldc;
  int m, n;
  bool vec;

  __device__ explicit StoreEpi(const Args& p)
      : out(p.out), ldo(p.ldo), c(p.c), ldc(p.ldc), m(p.m), n(p.n),
        vec(aligned16(p.out, p.ldo) &&
            (p.c == nullptr || aligned16(p.c, p.ldc))) {}

  __device__ __forceinline__ void operator()(int gm0, int gn,
                                             const float (&v)[4][4]) const {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gm = gm0 + r;
      if (gm >= m) break;
      float* o = out + gm * ldo + gn;
      const float* add = c == nullptr ? nullptr : c + gm * ldc + gn;
      if (vec && gn + 3 < n) {
        float4 q = make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
        if (add != nullptr) {
          const float4 a = *reinterpret_cast<const float4*>(add);
          q.x += a.x; q.y += a.y; q.z += a.z; q.w += a.w;
        }
        *reinterpret_cast<float4*>(o) = q;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < n) o[j] = add != nullptr ? add[j] + v[r][j] : v[r][j];
      }
    }
  }
};

template <int BM, int BN, bool VA, bool VB, class Epi>
__device__ __forceinline__ void tile_body(const Args& p, const Epi& epi) {
  constexpr int MS = BM / 64, NS = BN / 64;   // 4-wide strips a thread owns
  static_assert(BM == 128 && (BN == 128 || BN == 64), "tile shapes");
  constexpr int TM = 4 * MS, TN = 4 * NS;

  __shared__ __align__(16) float As[kStages][kBK][BM + kPad];
  __shared__ __align__(16) float Bs[kStages][kBK][BN + kPad];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int tiles_n = (p.n + BN - 1) / BN;
  const int tile = blockIdx.x;
  const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
  const int split = blockIdx.y;
  const int k_begin = split * p.chunks_per_split * kBK;
  const int k_end = min(p.k, k_begin + p.chunks_per_split * kBK);
  const int steps = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // tile t goes to buffer t % kStages; every step commits one group of
  // copies (empty past the last tile), so at step s the groups of tiles
  // s + 1 .. s + kStages - 2 may still be in flight
  auto copy_tile = [&](int t) {
    if (t < steps) {
      const int k0 = k_begin + t * kBK, buf = t % kStages;
      copy_rows<BM, VA>(As[buf], p.a, p.lda, k0, k_end, m0, p.m, tid);
      copy_rows<BN, VB>(Bs[buf], p.b, p.ldb, k0, k_end, n0, p.n, tid);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) copy_tile(t);
  for (int s = 0; s < steps; ++s) {
    const int cur = s % kStages;
    cp_async_wait<kStages - 2>();
    // tile s is in buffer `cur` for every thread, and every thread is done
    // with step s - 1, whose buffer the copy below refills
    __syncthreads();
    copy_tile(s + kStages - 1);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int t = 0; t < MS; ++t) {
        const float4 v =
            *reinterpret_cast<const float4*>(&As[cur][kk][t * 64 + ty * 4]);
        av[4 * t] = v.x; av[4 * t + 1] = v.y;
        av[4 * t + 2] = v.z; av[4 * t + 3] = v.w;
      }
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const float4 v =
            *reinterpret_cast<const float4*>(&Bs[cur][kk][t * 64 + tx * 4]);
        bv[4 * t] = v.x; bv[4 * t + 1] = v.y;
        bv[4 * t + 2] = v.z; bv[4 * t + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  cp_async_wait<0>();                       // only empty groups are left

  // ---- epilogue ---------------------------------------------------------
  // accumulator row i is output row row_of(i); strip t of the columns
  // starts at col_of(t)
  auto row_of = [&](int i) { return m0 + (i / 4) * 64 + ty * 4 + i % 4; };
  auto col_of = [&](int t) { return n0 + t * 64 + tx * 4; };
  auto emit_all = [&]() {
#pragma unroll
    for (int sm = 0; sm < MS; ++sm) {
      const int gm0 = row_of(4 * sm);
      if (gm0 >= p.m) continue;
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const int gn = col_of(t);
        if (gn >= p.n) continue;
        float v[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) v[r][j] = acc[4 * sm + r][4 * t + j];
        epi(gm0, gn, v);
      }
    }
  };
  if (p.splits == 1) {
    emit_all();
    return;
  }

  const int ldws = ws_stride(p.n);
  const long long plane = static_cast<long long>(p.m) * ldws;
  float* part = p.ws + split * plane;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row_of(i);
    if (gm >= p.m) continue;
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      const int gn = col_of(t);
      if (gn >= p.n) continue;
      float* o = part + static_cast<long long>(gm) * ldws + gn;
      if (gn + 3 < p.n) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * t], acc[i][4 * t + 1], acc[i][4 * t + 2],
                        acc[i][4 * t + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < p.n) o[j] = acc[i][4 * t + j];
      }
    }
  }
  __threadfence();                          // partials visible device-wide
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&p.counters[tile], 1) == p.splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: acc = the partials summed in split order; each split's
  // loads are independent of each other, so they are in flight together
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float* src = p.ws + s * plane;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = row_of(i);
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const int gn = col_of(t);
        if (gm >= p.m || gn >= p.n) continue;
        const float* q = src + static_cast<long long>(gm) * ldws + gn;
        if (gn + 3 < p.n) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(q));
          acc[i][4 * t] += v.x; acc[i][4 * t + 1] += v.y;
          acc[i][4 * t + 2] += v.z; acc[i][4 * t + 3] += v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gn + j < p.n) acc[i][4 * t + j] += __ldcg(q + j);
        }
      }
    }
  }
  emit_all();
  if (tid == 0) p.counters[tile] = 0;       // leave the counters reusable
}

// One kernel name per product, so a profile tells them apart. dW copies
// each operand 16 bytes at a time where that operand allows it (VA, VB);
// dx's operands are the wrapper's own padded transposes, always aligned.
// 128x64 tiles hold fewer accumulators, and three blocks share an SM.
template <int BM, int BN, bool VA, bool VB>
__global__ void __launch_bounds__(kThreads, BN == 128 ? 2 : 3)
dw_tile_kernel(const Args p) {
  tile_body<BM, BN, VA, VB>(p, StoreEpi(p));
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, BN == 128 ? 2 : 3)
dx_tile_kernel(const Args p) {
  tile_body<BM, BN, true, true>(p, StoreEpi(p));
}

// the member kernels: member blockIdx.z
template <int BM, int BN, bool VA, bool VB>
__global__ void __launch_bounds__(kThreads, BN == 128 ? 2 : 3)
dw_tile_members(const Args p, const Strides s) {
  const Args q = at_member(p, s);
  tile_body<BM, BN, VA, VB>(q, StoreEpi(q));
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, BN == 128 ? 2 : 3)
dx_tile_members(const Args p, const Strides s) {
  const Args q = at_member(p, s);
  tile_body<BM, BN, true, true>(q, StoreEpi(q));
}

template <int BM, int BN>
int launch_members(bool dx, int vec, const Args& p, const Strides& s,
                   int members, cudaStream_t stream) {
  const dim3 grid(((p.m + BM - 1) / BM) * ((p.n + BN - 1) / BN), p.splits,
                  members);
  if (dx)
    dx_tile_members<BM, BN><<<grid, kThreads, 0, stream>>>(p, s);
  else if (vec == 3)
    dw_tile_members<BM, BN, true, true><<<grid, kThreads, 0, stream>>>(p, s);
  else if (vec == 2)
    dw_tile_members<BM, BN, false, true><<<grid, kThreads, 0, stream>>>(p,
                                                                        s);
  else if (vec == 1)
    dw_tile_members<BM, BN, true, false><<<grid, kThreads, 0, stream>>>(p,
                                                                        s);
  else
    dw_tile_members<BM, BN, false, false><<<grid, kThreads, 0, stream>>>(
        p, s);
  return static_cast<int>(cudaGetLastError());
}

// with `s`, one member launch for `members` members
template <int BM, int BN>
int launch(bool dx, int vec, const Args& p, cudaStream_t stream,
           const Strides* s = nullptr, int members = 0) {
  if (s != nullptr)
    return launch_members<BM, BN>(dx, vec, p, *s, members, stream);
  const dim3 grid(((p.m + BM - 1) / BM) * ((p.n + BN - 1) / BN), p.splits);
  if (dx)
    dx_tile_kernel<BM, BN><<<grid, kThreads, 0, stream>>>(p);
  else if (vec == 3)
    dw_tile_kernel<BM, BN, true, true><<<grid, kThreads, 0, stream>>>(p);
  else if (vec == 2)
    dw_tile_kernel<BM, BN, false, true><<<grid, kThreads, 0, stream>>>(p);
  else if (vec == 1)
    dw_tile_kernel<BM, BN, true, false><<<grid, kThreads, 0, stream>>>(p);
  else
    dw_tile_kernel<BM, BN, false, false><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Tile shapes, indexed by `config` (mirrored by stack.py's _RT_CONFIGS):
// 3 = 128x128, 4 = 128x64 (BK = 8). Ids 0-2 are dense_tile.cuh's. `vec`:
// bit 0 for 16-byte copies of a, bit 1 of b; dx takes only 3. With `s`,
// one member launch for `members` members.
inline int launch_config(int config, bool dx, int vec, const Args& p,
                         cudaStream_t stream, const Strides* s = nullptr,
                         int members = 0) {
  if (!args_ok(p, vec) || (dx && vec != 3) ||
      (s != nullptr && (members < 1 || !strides_ok(*s, vec))))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (config) {
    case 3: return launch<128, 128>(dx, vec, p, stream, s, members);
    case 4: return launch<128, 64>(dx, vec, p, stream, s, members);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace dense_tile_rt
