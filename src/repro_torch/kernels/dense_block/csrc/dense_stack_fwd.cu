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
// (M, K1 + K2) input segments, with the tile product of dense_tile.cuh.
// Blocks tile the output over (rows, columns); a serving slot has only 1-32
// rows, so the parallelism comes from the columns and from a split of K
// across gridDim.y. Split partials go to a workspace; the last block of a
// tile to finish (counted with an atomic) sums them in fixed split order,
// so the result does not depend on the order in which blocks ran. Bias and
// activation are fused in the epilogue. When autograd will need it, the
// epilogue also stores the pre-activation z into the backward's (M, L*U)
// side buffer (`zout`), so the backward recomputes nothing.
//
// Bound on the H100: at serving slots (M <= 32) the weight bytes from HBM
// (the large actor: 21 MB, ~6.3 us at 3.35 TB/s); at M = 256 the fp32
// operations (2.7 GFLOP, ~40 us at 67 TFLOP/s outside the tensor cores).
// This first version uses plain fp32 FMAs from shared-memory tiles with a
// register prefetch of the next tile; wgmma/TMA and TF32/bf16 are later
// work (TF32 would miss the 1e-4 agreement with the fp32 reference).

#include "dense_tile.cuh"

// Returns the CUDA error of the launch (0 on success). `zout` (row stride
// `ldz`) receives the pre-activation, or is null.
extern "C" int dense_layer_fwd(int config, const float* a1, long long lda1,
                               int k1, const float* a2, long long lda2, int k2,
                               const float* w, const float* b, float* out,
                               long long ldo, float* zout, long long ldz,
                               float* ws, int* counters, int m, int n,
                               int act, int splits, int chunks_per_split,
                               void* stream) {
  if (b == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dense_tile::TileArgs p{a1, lda1, k1, a2, lda2, k2, w, n, b, out,
                               ldo, zout, ldz, ws, counters, m, n, act,
                               0, splits, chunks_per_split};
  return dense_tile::launch_config<false, false>(
      config, p, static_cast<cudaStream_t>(stream));
}
