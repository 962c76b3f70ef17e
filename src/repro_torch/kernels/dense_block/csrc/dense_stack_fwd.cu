// One layer of the fused MLP-DenseNet stack forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dense_block/stack.py::_fwd_kernel (launched by
// _pallas_forward). The TPU kernel keeps a whole row tile of the concat
// stream and every layer's weights in VMEM and runs all L layers in one
// program. On Hopper the weights do not fit in shared memory (the paper's
// large actor holds 21 MB of fp32 weights), so the stack becomes one launch
// of this kernel per layer, and the Python wrapper (stack.py) lays the
// layers out so the concat never exists:
//
//   densenet  layer i reads the stream prefix [x|y0|..|y_{i-1}] of the one
//             output buffer and writes y_i into its column slot: the buffer
//             IS the output, nothing is copied after the fact;
//   mlp       layer i reads h_{i-1} from one ping-pong buffer and writes the
//             other (its output slot would overlap its own input, and blocks
//             run in parallel, so the TPU's in-place rewrite is not safe);
//   d2rl      as mlp, with the input given as two segments [h | x] in the
//             logical weight-row order (rows 0..U-1 multiply h, the rest x).
//
// Each launch computes out[:, slot] = act(A @ W + b) in fp32 for A the
// (M, K1 + K2) input segments. Blocks tile the output over (rows, columns);
// a serving slot has only 1-32 rows, so the parallelism comes from the
// columns and from a split of K across gridDim.y. Split partials go to a
// workspace; the last block of a tile to finish (counted with an atomic)
// sums them in fixed split order, so the result does not depend on the
// order in which blocks ran. Bias and activation are fused in the epilogue.
//
// Bound on the H100: at serving slots (M <= 32) the weight bytes from HBM
// (the large actor: 21 MB, ~6.3 us at 3.35 TB/s); at M = 256 the fp32
// operations (2.7 GFLOP, ~40 us at 67 TFLOP/s outside the tensor cores).
// This first version uses plain fp32 FMAs from shared-memory tiles with a
// register prefetch of the next tile; wgmma/TMA and TF32/bf16 are later
// work (TF32 would miss the 1e-4 agreement with the fp32 reference).

#include <cuda_runtime.h>

namespace {

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

struct LayerArgs {
  const float* a1; long long lda1; int k1;   // input segment 1 (logical rows 0..k1)
  const float* a2; long long lda2; int k2;   // input segment 2 (k2 may be 0)
  const float* w;                            // (k1 + k2, n) row-major
  const float* b;                            // (n,)
  float* out; long long ldo;                 // output slot, row stride ldo
  float* ws;                                 // (splits, m, n) partials
  int* counters;                             // one per output tile, zeroed
  int m, n, act, splits, chunks_per_split;
};

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
dense_layer_kernel(const LayerArgs p) {
  constexpr int TX = BN / TN;               // threads along the columns
  constexpr int TY = BM / TM;               // threads along the rows
  static_assert(TX * TY == kThreads, "one output micro-tile per thread");
  constexpr int A_LOADS = BM * BK / kThreads;
  constexpr int W_LOADS = BK * BN / kThreads;
  static_assert(A_LOADS * kThreads == BM * BK, "A tile splits evenly");
  static_assert(W_LOADS * kThreads == BK * BN, "W tile splits evenly");

  __shared__ float As[BK][BM + 1];          // transposed; +1 avoids conflicts
  __shared__ float Ws[BK][BN];
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

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < A_LOADS; ++j) {
      const int e = tid + j * kThreads;
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      float v = 0.f;
      if (gm < p.m && gk < k_end) {
        v = gk < p.k1 ? p.a1[gm * p.lda1 + gk]
                      : p.a2[gm * p.lda2 + (gk - p.k1)];
      }
      a_reg[j] = v;
    }
#pragma unroll
    for (int j = 0; j < W_LOADS; ++j) {
      const int e = tid + j * kThreads;
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      w_reg[j] = (gk < k_end && gn < p.n)
                     ? p.w[static_cast<long long>(gk) * p.n + gn] : 0.f;
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int j = 0; j < A_LOADS; ++j) {
      const int e = tid + j * kThreads;
      As[e % BK][e / BK] = a_reg[j];
    }
#pragma unroll
    for (int j = 0; j < W_LOADS; ++j) {
      const int e = tid + j * kThreads;
      Ws[e / BN][e % BN] = w_reg[j];
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

  if (p.splits == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty + i * TY;
      if (gm >= p.m) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx + j * TX;
        if (gn < p.n) p.out[gm * p.ldo + gn] = apply_act(acc[i][j] + p.b[gn], p.act);
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
      p.out[gm * p.ldo + gn] = apply_act(z + p.b[gn], p.act);
    }
  }
  if (tid == 0) p.counters[tile] = 0;       // leave the counters reusable
}

template <int BM, int BN, int BK, int TM, int TN>
int launch(const LayerArgs& p, cudaStream_t stream) {
  const int tiles = ((p.m + BM - 1) / BM) * ((p.n + BN - 1) / BN);
  dense_layer_kernel<BM, BN, BK, TM, TN>
      <<<dim3(tiles, p.splits), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tile configurations, indexed by `config` (mirrored by stack.py's
// _CONFIGS): (BM, BN, BK) = (16, 64, 32), (32, 64, 32), (64, 64, 16).
// Returns the CUDA error of the launch (0 on success).
extern "C" int dense_layer_fwd(int config, const float* a1, long long lda1,
                               int k1, const float* a2, long long lda2, int k2,
                               const float* w, const float* b, float* out,
                               long long ldo, float* ws, int* counters, int m,
                               int n, int act, int splits,
                               int chunks_per_split, void* stream) {
  if (m <= 0 || n <= 0 || k1 <= 0 || k2 < 0 || splits < 1 ||
      chunks_per_split < 1 || act < kIdentity || act > kSwish ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const LayerArgs p{a1, lda1, k1, a2, lda2, k2, w, b, out, ldo, ws, counters,
                    m, n, act, splits, chunks_per_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0: return launch<16, 64, 32, 1, 4>(p, st);
    case 1: return launch<32, 64, 32, 2, 4>(p, st);
    case 2: return launch<64, 64, 16, 4, 4>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
