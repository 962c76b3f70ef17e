// The rate of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 on this
// card, for the card sweep (launch/bwd_sweep.py): every warp issues
// `iters` rounds of 16 independent MMAs on register operands, no memory
// traffic, so the time is the tensor cores' own for the legacy (pre-wgmma)
// MMA that fused_dense.cu's 3xTF32 runs on. Sm_90a.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 16;       // independent accumulators a warp

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void peak_kernel(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.0f + 1e-3f * threadIdx.x + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  float acc[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) mma_tf32(acc[c], a, b);
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
    s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;   // keeps the MMAs
}

}  // namespace

// `blocks` blocks of `warps` warps, each warp 16 * iters MMAs (2048 FLOP
// each); out: blocks * warps * 32 floats. Returns the CUDA error of the
// launch (0 on success).
extern "C" int tf32_mma_peak(float* out, int blocks, int warps, int iters,
                             void* stream) {
  if (out == nullptr || blocks < 1 || warps < 1 || warps > 32 || iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  peak_kernel<<<blocks, 32 * warps, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return static_cast<int>(cudaGetLastError());
}
