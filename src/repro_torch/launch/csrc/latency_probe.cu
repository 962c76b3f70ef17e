// The two latencies that bound the sum-tree kernels (replay_tree.cu), for
// the floor chip_smoke.py reports beside their bytes bound: the time of an
// empty kernel (a launch and nothing else), and the latency of one
// dependent global load, from a pointer chase of one thread over a chain
// of 128-byte lines (each load's address is the previous load's value, so
// no two overlap). Loads are `ld.global.cg` (L2, not L1), as a tree
// kernel's first touch of a line is. Run over a buffer in L2 it reads the
// L2 latency; over the same buffer right after the L2 was flushed, the
// device memory's. Sm_90a.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

__global__ void chase_kernel(const int* __restrict__ next, int steps,
                             int start, int* out) {
  int p = start;
  for (int s = 0; s < steps; ++s) p = __ldcg(next + p);
  *out = p;                                 // keeps the chain
}

}  // namespace

// One launch of an empty kernel of one thread. Returns the CUDA error of
// the launch (0 on success).
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// `steps` dependent loads p = next[p] from p = start by one thread; the
// last p goes to *out.
extern "C" int chase_launch(const int* next, int steps, int start, int* out,
                            void* stream) {
  if (next == nullptr || out == nullptr || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, steps,
                                                              start, out);
  return static_cast<int>(cudaGetLastError());
}
