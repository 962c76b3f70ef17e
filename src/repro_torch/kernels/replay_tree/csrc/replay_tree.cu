// The device sum-tree of the prioritized replay, for Hopper (sm_90a): the
// batched proportional sample and the batched leaf write.
//
// Layout (as the reference's): a flat float32 array of 2^depth nodes, root
// at 1, leaves at half = 2^(depth-1) .. 2^depth - 1; a parent holds
// left + right. At the replay's 100,000 rows: depth 18, 1 MB, which stays
// in the 50 MB L2 between the calls of a training step.
//
// tree_sample replaces src/repro/kernels/replay_tree/replay_tree.py::
// _sample_kernel (launched by tree_sample). One thread per target walks
// the depth-1 levels from the root: go right (and subtract the left mass)
// when target >= left mass, the reference's comparison and fp32
// subtraction, so the leaf is the reference's bit for bit. The leaf is
// clamped to [0, capacity) as ref.tree_sample_ref does, and its priority is
// read in the same pass. Bound: latency, not bytes or operations: 17
// dependent loads per target (the bytes bound of 256 targets is a few
// nanoseconds). The TPU's padding of the batch to a multiple of 128 is not
// needed: the grid covers B exactly.
//
// tree_set replaces replay_tree.py::_set_kernel (tree_set) and
// _set_onehot_kernel (tree_set_onehot), with the latter's keep-last rule
// for duplicate indices. The one-hot matmul of the TPU kernel exists only
// because Mosaic has no scatter; here the leaf write is a scatter: every
// entry i records itself in an int32 owner slot of its leaf with
// atomicMax (an integer atomic: its outcome, the largest i, does not depend
// on the order), and only the owner writes the leaf. Then the ancestors are
// recomputed one level at a time as left + right, exactly as
// ref.tree_set_ref and _set_kernel do, so for unique indices the tree is
// bitwise the reference's. Entries sharing a parent write the same sum; a
// barrier between levels orders the levels. One block of 1024 threads
// loops over the entries (n <= 10,000 on the main path), so __syncthreads
// is the level barrier. Bound: latency of 18 dependent levels. An entry
// whose index lies outside the leaves is not written: it adds one to a
// device counter the caller reads off the hot path (raising here would
// cost a host sync per write).

#include <cuda_runtime.h>

namespace {

constexpr int kSampleThreads = 128;
constexpr int kSetThreads = 1024;

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

__global__ void __launch_bounds__(kSetThreads)
set_kernel(float* tree, int depth, const int* __restrict__ idx,
           const float* __restrict__ val, int n, int* owner, int* skipped) {
  const int half = 1 << (depth - 1);
  // an index outside [0, half) would write outside the tree: counted, skipped
  auto valid = [&](int i) { return idx[i] >= 0 && idx[i] < half; };
  for (int i = threadIdx.x; i < n; i += kSetThreads) {
    if (valid(i))
      owner[idx[i]] = -1;
    else
      atomicAdd(skipped, 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kSetThreads)
    if (valid(i)) atomicMax(owner + idx[i], i);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kSetThreads)
    if (valid(i) && owner[idx[i]] == i) tree[half + idx[i]] = val[i];
  __syncthreads();
  for (int shift = 1; shift < depth; ++shift) {   // levels depth-2 .. 0
    for (int i = threadIdx.x; i < n; i += kSetThreads) {
      if (!valid(i)) continue;
      const int node = (half + idx[i]) >> shift;
      tree[node] = tree[2 * node] + tree[2 * node + 1];
    }
    __syncthreads();
  }
}

}  // namespace

// leaf (b,) int32 and priority (b,) float32 of each target. Returns the
// CUDA error of the launch (0 on success).
extern "C" int tree_sample(const float* tree, int depth, int capacity,
                           const float* targets, int b, int* leaf,
                           float* pri, void* stream) {
  if (depth < 2 || depth > 30 || capacity < 1 ||
      capacity > (1 << (depth - 1)) || b < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  sample_kernel<<<(b + kSampleThreads - 1) / kSampleThreads, kSampleThreads,
                  0, static_cast<cudaStream_t>(stream)>>>(
      tree, depth, capacity, targets, b, leaf, pri);
  return static_cast<int>(cudaGetLastError());
}

// tree[half + idx[i]] = val[i] (the last i wins for a repeated index), then
// the ancestors' sums, in place. `owner` is int32 scratch of half entries
// (any contents). Entries whose index lies outside [0, half) are skipped,
// and each adds one to the int32 `*skipped` (checking them on the host
// would cost a device sync per write).
extern "C" int tree_set(float* tree, int depth, const int* idx,
                        const float* val, int n, int* owner, int* skipped,
                        void* stream) {
  if (depth < 2 || depth > 30 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  set_kernel<<<1, kSetThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tree, depth, idx, val, n, owner, skipped);
  return static_cast<int>(cudaGetLastError());
}
