// The port's first sum-tree kernels, kept as the card sweep's control for
// replay_tree.cu (launch/bwd_sweep.py times both side by side): the
// sample, a thread a target, one dependent load a level (as the TPU kernel
// walks it); the write, one block of 1,024 threads, keep-last by an
// atomicMax owner per leaf in a global scratch (three barriered global
// rounds), then one barriered level at a time. Same layout and results as
// replay_tree.cu (bitwise ref.tree_sample_ref / tree_set_ref); an index
// outside the leaves is skipped and counted. Sm_90a.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void sample_kernel(const float* __restrict__ tree, int depth,
                              int capacity, const float* __restrict__ targets,
                              int b, int* __restrict__ leaf_out,
                              float* __restrict__ pri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int half = 1 << (depth - 1);
  float t = targets[i];
  int node = 1;
  for (int l = 0; l < depth - 1; ++l) {
    const int left = 2 * node;
    const float lmass = __ldg(tree + left);
    if (t >= lmass) {
      t = t - lmass;
      node = left + 1;
    } else {
      node = left;
    }
  }
  int leaf = node - half;
  leaf = leaf < 0 ? 0 : (leaf > capacity - 1 ? capacity - 1 : leaf);
  leaf_out[i] = leaf;
  pri_out[i] = tree[leaf + half];
}

__global__ void __launch_bounds__(kThreads)
owner_set_kernel(float* tree, int depth, const int* __restrict__ idx,
                 const float* __restrict__ val, int n, int* owner,
                 int* skipped) {
  const int half = 1 << (depth - 1);
  auto valid = [&](int i) { return idx[i] >= 0 && idx[i] < half; };
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (valid(i))
      owner[idx[i]] = -1;
    else
      atomicAdd(skipped, 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads)
    if (valid(i)) atomicMax(owner + idx[i], i);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads)
    if (valid(i) && owner[idx[i]] == i) tree[half + idx[i]] = val[i];
  __syncthreads();
  for (int shift = 1; shift < depth; ++shift) {   // levels depth-2 .. 0
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (!valid(i)) continue;
      const int node = (half + idx[i]) >> shift;
      tree[node] = tree[2 * node] + tree[2 * node + 1];
    }
    __syncthreads();
  }
}

}  // namespace

// leaf (b,) int32 and priority (b,) float32 of each target, a thread a
// target. Returns the CUDA error of the launch (0 on success).
extern "C" int first_sample(const float* tree, int depth, int capacity,
                            const float* targets, int b, int* leaf,
                            float* pri, void* stream) {
  if (depth < 2 || depth > 30 || capacity < 1 ||
      capacity > (1 << (depth - 1)) || b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  sample_kernel<<<(b + 127) / 128, 128, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      tree, depth, capacity, targets, b, leaf, pri);
  return static_cast<int>(cudaGetLastError());
}

// tree_set of replay_tree.cu, keep-last through `owner`: int32 scratch of
// half entries (any contents). Returns the CUDA error of the launch (0 on
// success).
extern "C" int first_set(float* tree, int depth, const int* idx,
                         const float* val, int n, int* owner, int* skipped,
                         void* stream) {
  if (depth < 2 || depth > 30 || n < 1 || owner == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  owner_set_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tree, depth, idx, val, n, owner, skipped);
  return static_cast<int>(cudaGetLastError());
}
