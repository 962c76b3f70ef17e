// The fused dense layer out = act(sum_seg A_seg @ W[rows_seg] + b), for
// Hopper (sm_90a).
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
// of one type), converted to fp32 on load; the output has the input type.
//
// Blocks tile the output 64 x 64 (256 threads, a 4 x 4 micro-tile each) and
// walk K in chunks of 16 that never straddle a segment. The sequential K
// grid of the TPU becomes a loop inside the block; when the output has too
// few tiles to fill the 132 SMs, the chunks are split across gridDim.y, the
// splits write fp32 partials to a workspace, and the last block of a tile
// to finish (an integer atomic counter picks it) sums them in fixed split
// order, so the result does not depend on the order blocks ran in. Bias and
// activation (identity, relu, tanh, swish/silu, gelu with the tanh
// approximation of jax.nn.gelu) run in that epilogue.
//
// Bound on the H100: the paper's Ant DenseNet layer 3 (M=256, K=4207,
// N=2048) is 4.4 GFLOP, 66 us of fp32 operations outside the tensor cores
// against 39 MB of traffic (12 us): bound by operations. This first version
// is plain fp32 FMAs from shared-memory tiles, no cp.async/TMA pipeline and
// no wgmma (TF32 would miss the 1e-4 agreement with the fp32 reference).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegs = 128;
constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;

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
  int* counters;             // one per output tile, zeroed
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_dense_kernel(const __grid_constant__ Args p) {
  constexpr int TX = BN / TN, TY = BM / TM;
  constexpr int A_LOADS = BM * BK / kThreads;
  constexpr int W_LOADS = BK * BN / kThreads;
  static_assert(TX * TY == kThreads, "one micro-tile per thread");
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
  const int c_end = (split + 1) * p.chunks_per_split;
  const T* w = static_cast<const T*>(p.w);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // chunk c of this split lies in segment seg, whose first chunk is c_base
  // and whose first row of W is w_row (uniform across the block)
  int c = split * p.chunks_per_split;
  int seg = 0, c_base = 0, w_row = 0;
  while (c < c_end && seg < p.nseg) {
    const int kseg = p.k[seg];
    const int nc = (kseg + BK - 1) / BK;
    if (c >= c_base + nc) {
      c_base += nc;
      w_row += kseg;
      ++seg;
      continue;
    }
    const T* a = static_cast<const T*>(p.a[seg]);
    const long long lda = p.lda[seg];
    const int k0 = (c - c_base) * BK;
    __syncthreads();                        // the last chunk's reads are done
#pragma unroll
    for (int j = 0; j < A_LOADS; ++j) {
      const int e = tid + j * kThreads;
      const int r = e / BK, cc = e % BK;    // neighbours walk along k
      const int gm = m0 + r, gk = k0 + cc;
      As[cc][r] = gm < p.m && gk < kseg ? to_f(a[gm * lda + gk]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < W_LOADS; ++j) {
      const int e = tid + j * kThreads;
      const int r = e / BN, cc = e % BN;    // neighbours walk along n
      const int gk = k0 + r, gn = n0 + cc;
      Ws[r][cc] = gk < kseg && gn < p.n
                      ? to_f(w[static_cast<long long>(w_row + gk) * p.ldw + gn])
                      : 0.f;
    }
    __syncthreads();
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
    ++c;
  }

  const T* bias = static_cast<const T*>(p.b);
  T* out = static_cast<T*>(p.out);
  auto epilogue = [&](int gm, int gn, float z) {
    if (bias != nullptr) z += to_f(bias[gn]);
    out[gm * p.ldo + gn] = from_f<T>(apply_act(z, p.act));
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

template <typename T>
int launch(const Args& p, cudaStream_t stream) {
  const int tiles = ((p.m + BM - 1) / BM) * ((p.n + BN - 1) / BN);
  fused_dense_kernel<T><<<dim3(tiles, p.splits), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// BM, BN, BK and kMaxSegs are mirrored by dense_block.py (TILE, MAX_PARTS).
// Returns the CUDA error of the launch (0 on success). dtype 0: float32,
// 1: bfloat16. seg_ptr, seg_ld and seg_k are host arrays of nseg entries.
extern "C" int fused_dense_fwd(int dtype, int nseg, const long long* seg_ptr,
                               const int* seg_ld, const int* seg_k,
                               const void* w, long long ldw, const void* b,
                               void* out, long long ldo, float* ws,
                               int* counters, int m, int n, int act,
                               int splits, int chunks_per_split,
                               void* stream) {
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
    case 0: return launch<float>(p, st);
    case 1: return launch<__nv_bfloat16>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
