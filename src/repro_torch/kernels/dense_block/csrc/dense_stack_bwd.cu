// The fused MLP-DenseNet stack backward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dense_block/stack.py::_bwd_kernel (launched by
// _pallas_backward). The TPU kernel recomputes the stream and the
// pre-activations of a batch tile in VMEM, then sweeps the layers in
// reverse and accumulates every dW_i/db_i in place across batch tiles,
// which is safe there only because the TPU runs the batch grid in order.
// Blocks on the card run in no order, so the sweep is rebuilt from three
// kernels that the Python wrapper (stack.py) launches per layer, in reverse
// layer order:
//
//   (a) act_grad  gz = g[:, slot_i] * act'(z_i) into scratch, its
//                 transpose gz^T when dx needs it (below), and db_i = sum
//                 over rows of gz. The forward stored z_i (its
//                 pre-activation) into an (M, L*U) side buffer, so nothing
//                 is recomputed (recompute would add about half again the
//                 backward's operations). A 2-D grid of 32-column x 8 row
//                 blocks fills the card at M = 256 (64 x 8 = 512 blocks at
//                 U = 2048, where one block per 32 columns gave only 64);
//                 each block writes its column sums, and a second, tiny
//                 pass adds the 8 rows of sums in order. No float atomics.
//   (b) dW_i = inp_i^T @ gz: each block owns a dW tile and loops over the
//                 batch rows itself. dW needs only gz, so the wrapper runs
//                 it, and db's second pass, on a side stream beside the
//                 chain act_grad_i -> (c)_i -> act_grad_{i-1}.
//   (c) g_in (+)= gz @ W_i^T: a block owns an (M-tile x k-tile) of g_in
//                 and reduces over U, split in K (its output is small).
//                 It reads gz^T (from (a)) and W_i^T (dense_tile.cuh's
//                 transpose_kernel,
//                 every layer's up front on the side stream), so both
//                 operands run along the output like dW's. densenet adds
//                 into the gradient stream's prefix [:, :k], which holds
//                 layer i-1's slot, so layer i finishes before i-1 starts:
//                 plain launch order on one stream gives that. The top
//                 layer's (c) writes the prefix as g's prefix + its
//                 product and the bottom one writes dx as the stream's
//                 prefix + its product (an addend in the epilogue), so the
//                 stream is never copied. d2rl runs (c) twice, on the
//                 [h | x] row segments of W.
//   act           h_{i-1} = act(z_{i-1}) for mlp/d2rl, whose ping-pong
//                 forward buffers no longer hold the hidden layers.
//
// No floating-point atomics anywhere, so the backward is bitwise the same
// from run to run. Kernels for dW/db are skipped where autograd does not
// ask for them (the actor loss differentiates the critics' input only).
//
// Bound on the H100 at the main path (M = 256): the critic stack's dW and
// dx products are 6.46 GFLOP, ~96 us at 67 TFLOP/s (fp32 outside the
// tensor cores; TF32 would miss the 1e-3 agreement with the fp32
// reference); their bytes (~60 MB) take ~18 us at 3.35 TB/s, so the
// operations bound it, and what bounds a product on the card is how many
// FMAs it issues for each shared-memory load and copy. Products of at
// least 128 rows, 128 columns and 128 of reduction (every product of the
// actor and critic stacks) run the register-tiled tile of
// dense_tile_rt.cuh: 8x8 outputs a thread, float4 shared reads, 16 FMAs
// per shared load, a ring of cp.async K tiles, one barrier per K step.
// The narrow OFENet stacks (U = 64) and small shapes keep dense_tile.cuh's
// tiles (4x4 outputs a thread, 2 FMAs per shared load), which the forward
// shares.
//
// Split products take their tile counters from one zeroed buffer that the
// wrapper keeps per (device, stream): every kernel here leaves the
// counters it used at 0, so no launch fills them first.

#include "dense_tile.cuh"
#include "dense_tile_rt.cuh"

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

constexpr int kCols = 32, kRowGroups = 8, kRows = 32, kRowBlocks = 8;

// The grid is (column blocks of kCols) x kRowBlocks; block y owns rows
// [y * rows, (y + 1) * rows) (rows a multiple of kRows) and thread (ty, tx)
// takes rows ty, ty + 8, .. of each kRows-row chunk. With gzt, each chunk
// of gz is also written transposed, (n, m) of row stride ldgt, through
// shared memory so both the reads and the writes are whole rows. With
// db_part, block y writes its column sums to row y of db_part (kRowBlocks,
// n); db_sum_kernel adds the rows in order. No block waits on another.
__global__ void __launch_bounds__(kCols * kRowGroups)
act_grad_kernel(const float* g, long long ldg, const float* z, long long ldz,
                float* gz, float* gzt, long long ldgt, float* db_part, int m,
                int n, int rows, int act) {
  __shared__ float tile[kRows][kCols + 1];
  __shared__ float part[kRowGroups][kCols + 1];
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  const int c0 = blockIdx.x * kCols, col = c0 + tx;
  const int y = blockIdx.y, r_end = min(m, (y + 1) * rows);
  float acc = 0.f;
  for (int r0 = y * rows; r0 < r_end; r0 += kRows) {
    float d[kRows / kRowGroups];            // all loads in flight at once
#pragma unroll
    for (int j = 0; j < kRows / kRowGroups; ++j) {
      const int r = r0 + ty + j * kRowGroups;
      d[j] = r < m && col < n
                 ? g[r * ldg + col] * act_grad(z[r * ldz + col], act)
                 : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kRows / kRowGroups; ++j) {
      const int r = r0 + ty + j * kRowGroups;
      if (r < m && col < n) gz[static_cast<long long>(r) * n + col] = d[j];
      acc += d[j];
    }
    if (gzt != nullptr) {                   // gzt[c][r] = tile[r][c]
#pragma unroll
      for (int j = 0; j < kRows / kRowGroups; ++j)
        tile[ty + j * kRowGroups][tx] = d[j];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kCols / kRowGroups; ++j) {
        const int c = c0 + ty + j * kRowGroups, r = r0 + tx;
        if (c < n && r < m) gzt[c * ldgt + r] = tile[tx][ty + j * kRowGroups];
      }
      __syncthreads();                      // tile free for the next chunk
    }
  }
  if (db_part == nullptr) return;
  part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < n) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kRowGroups; ++j) s += part[j][tx];
    db_part[static_cast<long long>(y) * n + col] = s;
  }
}

// db[c] = sum of db_part[0..kRowBlocks)[c], in row order
__global__ void db_sum_kernel(const float* db_part, float* db, int n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  float s = 0.f;
#pragma unroll
  for (int y = 0; y < kRowBlocks; ++y) s += db_part[y * n + c];
  db[c] = s;
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

// (a): gz (m, n) contiguous; gzt (n, m) of row stride ldgt, or null;
// db_part (8, n) of per-row-block column sums, or null.
extern "C" int dense_bwd_act_grad(const float* g, long long ldg,
                                  const float* z, long long ldz, float* gz,
                                  float* gzt, long long ldgt, float* db_part,
                                  int m, int n, int act, void* stream) {
  if (m <= 0 || n <= 0 || act < dense_tile::kIdentity ||
      act > dense_tile::kSwish || (gzt != nullptr && ldgt < m))
    return static_cast<int>(cudaErrorInvalidValue);
  // rows per block: m over kRowBlocks blocks, in whole chunks
  const int chunks = (m + kRows - 1) / kRows;
  const int rows = (chunks + kRowBlocks - 1) / kRowBlocks * kRows;
  act_grad_kernel<<<dim3((n + kCols - 1) / kCols, kRowBlocks),
                    kCols * kRowGroups, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      g, ldg, z, ldz, gz, gzt, ldgt, db_part, m, n, rows, act);
  return static_cast<int>(cudaGetLastError());
}

// (a), second pass: db (n,) from db_part (8, n).
extern "C" int dense_bwd_db(const float* db_part, float* db, int n,
                            void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  db_sum_kernel<<<(n + 255) / 256, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(db_part, db, n);
  return static_cast<int>(cudaGetLastError());
}

// dst (cols, rows) of row stride ldd = src (rows, cols)^T: dx's W_i^T.
extern "C" int dense_bwd_transpose(const float* src, long long lds,
                                   float* dst, long long ldd, int rows,
                                   int cols, void* stream) {
  return dense_tile::launch_transpose(src, lds, dst, ldd, nullptr, 0, rows,
                                      cols,
                                      static_cast<cudaStream_t>(stream));
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

// (b) and (c) at shapes below the register-tiled tile (configs 0-2): the
// tile product out (+)= A @ W with the layouts of dense_tile.cuh; `ta` = 1 for (b) (A stored transposed), `tw` = 1 for (c)
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

// (b) and (c) with the register-tiled tile of dense_tile_rt.cuh (configs
// 3 = 128x128, 4 = 128x64): out (m, n) = a^T @ b (+ c) over k rows of a
// (k, m) and b (k, n); c is an addend of row stride ldc (out itself to add
// in place) or null. `dx` only names the kernel (0 for (b), 1 for (c),
// whose a and b are gz^T and W_i^T, padded: vec is 3); `vec` bit 0 (1) for
// the 16-byte copies of a (at 16 bytes, lda a multiple of 4), bit 1 (2) of
// b; ws (splits, m, n rounded up to 4).
extern "C" int dense_bwd_gemm_rt(int config, int dx, int vec, const float* a,
                                 long long lda, const float* b,
                                 long long ldb, float* out, long long ldo,
                                 const float* c, long long ldc, float* ws,
                                 int* counters, int m, int n, int k,
                                 int splits, int chunks_per_split,
                                 void* stream) {
  const dense_tile_rt::Args p{a, lda, b, ldb, out, ldo, c, ldc, ws,
                              counters, m, n, k, splits, chunks_per_split};
  return dense_tile_rt::launch_config(config, dx != 0, vec, p,
                                      static_cast<cudaStream_t>(stream));
}
