// The fused MLP-DenseNet stack backward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dense_block/stack.py::_bwd_kernel (launched by
// _pallas_backward). The TPU kernel recomputes the stream and the
// pre-activations of a batch tile in VMEM, then sweeps the layers in
// reverse and accumulates every dW_i/db_i in place across batch tiles,
// which is safe there only because the TPU runs the batch grid in order.
// Blocks on the card run in no order, so the sweep is rebuilt from three
// kernels that the Python wrapper (stack.py) launches per layer, in reverse
// layer order on one stream:
//
//   (a) act_grad  gz = g[:, slot_i] * act'(z_i) into scratch, and
//                 db_i = sum over rows of gz. The forward stored z_i (its
//                 pre-activation) into an (M, L*U) side buffer, so nothing
//                 is recomputed (recompute would add about half again the
//                 backward's operations). A block owns 32 columns; 8 row
//                 groups each sum a strided share of the rows and the 8
//                 partials are added in fixed order: no atomics.
//   (b) dW_i = inp_i^T @ gz, with the tile product of dense_tile.cuh with
//                 A stored transposed: each block owns a dW tile and loops
//                 over the batch rows itself. Only where the tiles are too
//                 few to fill the card is the batch split, and the split
//                 partials are summed by the tile's last block in fixed
//                 order.
//   (c) g_in (+)= gz @ W_i^T, the tile product with W stored transposed;
//                 a block owns an (M-tile x k-tile) of g_in and reduces over
//                 U, split like the forward's K where the tiles are few.
//                 densenet adds into the gradient stream's prefix [:, :k],
//                 which holds layer i-1's slot, so layer i finishes before
//                 i-1 starts: plain launch order on one stream gives that.
//                 d2rl runs (c) twice, on the [h | x] row segments of W.
//   act           h_{i-1} = act(z_{i-1}) for mlp/d2rl, whose ping-pong
//                 forward buffers no longer hold the hidden layers.
//
// No floating-point atomics anywhere, so the backward is bitwise the same
// from run to run. Kernels for dW/db are skipped where autograd does not
// ask for them (the actor loss differentiates the critics' input only).
//
// Bound on the H100 at the main path (M = 256): the critic stack's dW and
// dx products are 6.46 GFLOP, ~96 us at 67 TFLOP/s (fp32 outside the
// tensor cores); their bytes (~60 MB) take ~18 us at 3.35 TB/s, so the
// operations bound it. This first version uses plain fp32 FMAs from shared
// tiles like the forward; wgmma/TMA pipelines are later work.

#include "dense_tile.cuh"

namespace {

using dense_tile::apply_act;

__device__ __forceinline__ float act_grad(float z, int act) {
  switch (act) {
    case dense_tile::kRelu: return z > 0.f ? 1.f : 0.f;
    case dense_tile::kTanh: {
      const float t = tanhf(z);
      return 1.f - t * t;
    }
    case dense_tile::kSwish: {
      const float s = 1.f / (1.f + expf(-z));
      return s * (1.f + z * (1.f - s));
    }
    default: return 1.f;
  }
}

constexpr int kCols = 32, kRowGroups = 8;

__global__ void __launch_bounds__(kCols * kRowGroups)
act_grad_kernel(const float* g, long long ldg, const float* z, long long ldz,
                float* gz, float* db, int m, int n, int act) {
  __shared__ float part[kRowGroups][kCols + 1];
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  const int col = blockIdx.x * kCols + tx;
  float acc = 0.f;
  if (col < n) {
    for (int r = ty; r < m; r += kRowGroups) {
      const float d = g[r * ldg + col] * act_grad(z[r * ldz + col], act);
      gz[static_cast<long long>(r) * n + col] = d;
      acc += d;
    }
  }
  part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < n && db != nullptr) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kRowGroups; ++j) s += part[j][tx];
    db[col] = s;
  }
}

__global__ void act_kernel(const float* z, long long ldz, float* out, int m,
                           int n, int act) {
  const long long total = static_cast<long long>(m) * n;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = e / n, c = e % n;
    out[e] = apply_act(z[r * ldz + c], act);
  }
}

}  // namespace

// (a): gz (m, n) contiguous; db (n,) or null.
extern "C" int dense_bwd_act_grad(const float* g, long long ldg,
                                  const float* z, long long ldz, float* gz,
                                  float* db, int m, int n, int act,
                                  void* stream) {
  if (m <= 0 || n <= 0 || act < dense_tile::kIdentity ||
      act > dense_tile::kSwish)
    return static_cast<int>(cudaErrorInvalidValue);
  act_grad_kernel<<<(n + kCols - 1) / kCols, kCols * kRowGroups, 0,
                    static_cast<cudaStream_t>(stream)>>>(g, ldg, z, ldz, gz,
                                                         db, m, n, act);
  return static_cast<int>(cudaGetLastError());
}

// out (m, n) contiguous = act(z[:, :n]).
extern "C" int dense_bwd_act(const float* z, long long ldz, float* out,
                             int m, int n, int act, void* stream) {
  if (m <= 0 || n <= 0 || act < dense_tile::kIdentity ||
      act > dense_tile::kSwish)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(m) * n;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  act_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      z, ldz, out, m, n, act);
  return static_cast<int>(cudaGetLastError());
}

// (b) and (c): the tile product out (+)= A @ W with the layouts of
// dense_tile.cuh; `ta` = 1 for (b) (A stored transposed), `tw` = 1 for (c)
// (W stored transposed). No bias, identity activation.
extern "C" int dense_bwd_gemm(int config, int ta, int tw, const float* a1,
                              long long lda1, int k1, const float* a2,
                              long long lda2, int k2, const float* w,
                              long long ldw, float* out, long long ldo,
                              int accumulate, float* ws, int* counters,
                              int m, int n, int splits, int chunks_per_split,
                              void* stream) {
  const dense_tile::TileArgs p{a1, lda1, k1, a2, lda2, k2, w, ldw, nullptr,
                               out, ldo, nullptr, 0, ws, counters, m, n,
                               dense_tile::kIdentity, accumulate, splits,
                               chunks_per_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ta && !tw) return dense_tile::launch_config<true, false>(config, p, st);
  if (!ta && tw) return dense_tile::launch_config<false, true>(config, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
