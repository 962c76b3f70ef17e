// The device sum-tree of the prioritized replay, for Hopper (sm_90a): the
// batched proportional sample and the batched leaf write.
//
// Layout (as the reference's): a flat float32 array of 2^depth nodes, root
// at 1, leaves at half = 2^(depth-1) .. 2^depth - 1; a parent holds
// left + right. At the replay's 100,000 rows: depth 18, 1 MB.
//
// Both kernels move a few hundred bytes to a few hundred kilobytes a call,
// so neither bytes nor operations bound them: the count of dependent
// memory rounds does (one L2 or HBM latency each, PERF.md), with the
// launch and each round's barriers and instructions. The TPU kernels they
// replace walk the tree one level per step (one dependent gather per
// level). The sample takes K levels a round; the write still takes a level
// a barrier: on the training path it finds the tree in L2, where a design
// of K levels a round lost (PERF.md §6).
//
// tree_sample replaces src/repro/kernels/replay_tree/replay_tree.py::
// _sample_kernel (launched by tree_sample). A group of G lanes serves one
// target. Below a node x, its descendants k levels down are the contiguous
// run [x 2^k, x 2^k + 2^k), so the group loads the whole K-level subtree
// under its current node (2 + 4 + ... + 2^K nodes, in heap order across
// the lanes) in one round of independent loads, then descends those K
// levels from registers: each level shuffles the left child's mass from
// the lane that holds it, and makes the reference's `t >= lmass`
// comparison and fp32 subtraction, so leaf and target are the reference's
// bit for bit. Each block first stages the top SAMPLE_TOP levels in shared
// memory with one coalesced load (beside the targets' load). Depth 18 at
// K = 5 and 8 staged levels: 3 dependent rounds (a level a round, as the
// TPU kernel walks it: 17, and one more for the priority). The last round
// holds the leaf itself, so its priority comes with it; only a leaf
// clamped to capacity - 1 (a target at or past the total) reads it again.
//
// tree_set replaces replay_tree.py::_set_kernel (tree_set) and
// _set_onehot_kernel (tree_set_onehot), with the latter's keep-last rule
// for a repeated index. One block of 1024 threads; a pass takes 1024
// entries in order, one a thread (a larger batch runs pass after pass, so
// a later write still wins). Entries meet in a shared hash of their
// leaves, where atomicMax keeps the last position (an integer atomic: its
// outcome does not depend on the order), so no global scratch and none of
// its round trips. The winners write their leaves, then recompute their
// ancestors a level at a time as fl(left + right) from the tree's own
// nodes, exactly as ref.tree_set_ref does (also on a tree whose inner
// nodes are not the sums of their children); winners sharing a parent
// write the same sum, and a barrier between levels orders them. Depth 18:
// 17 barriered levels a pass, each one dependent L2 round trip. Tried on
// the card and lost on the training path, where the tree is in L2
// (PERF.md §6): K levels a round recomputed from the aligned blocks of
// 2^K nodes above the touched ones (4 rounds at K = 5; faster only with
// the L2 flushed). An entry whose index lies outside the leaves is not
// written: it adds one to a device counter the caller reads off the hot
// path (raising here would cost a host sync per write).
//
// Both kernels take a leading member axis (a vmapped experiment fleet):
// E trees of 2^depth nodes one after another, and each member's targets,
// indices, values and outputs at member x their count. The sample puts
// the member on blockIdx.y, so every block stays within one tree (its top
// levels are staged in shared memory); the write runs one block a member.
// At E = 1 the launch is the solo one.
//
// Each launch shape is fixed at build time by -D flags: ops.py passes the
// card sweep's picks, and launch/bwd_sweep.py builds its candidates from
// this source the same way. SAMPLE_K levels a round, SAMPLE_LANES lanes a
// target, SAMPLE_TOP levels staged (0: none); TREE_PDL 1: both kernels
// launch with programmatic dependent launch (each then starts while the
// kernel before it on the stream finishes, and waits at
// griddepcontrol.wait before reading memory).

#include <cuda_runtime.h>

#if !defined(SAMPLE_K) || !defined(SAMPLE_LANES) || !defined(SAMPLE_TOP) || \
    !defined(TREE_PDL)
#error "build with the launch shape's -D flags (ops.py: build_defines)"
#endif

namespace {

constexpr int kSampleK = SAMPLE_K, kSampleLanes = SAMPLE_LANES;
constexpr int kTop = SAMPLE_TOP;
constexpr bool kPdl = TREE_PDL != 0;

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, dim3 block, int smem,
           cudaStream_t stream, const Args&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = kPdl ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  cudaGetLastError();                       // returned here, not kept
  return static_cast<int>(err);
}

// lanes [base, base + G) of this warp, the group of this lane
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if (G == 32) return 0xffffffffu;
  return ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
}

// ---------------------------------------------------------------- sample

constexpr int kSampleThreads = 256;
static_assert(kSampleK >= 1 && kSampleK <= 6, "SAMPLE_K in 1 .. 6");
static_assert(kSampleLanes >= 1 && kSampleLanes <= 32 &&
                  (kSampleLanes & (kSampleLanes - 1)) == 0,
              "SAMPLE_LANES a power of two up to 32");
static_assert(kTop >= 0 && kTop <= 13, "SAMPLE_TOP in 0 .. 13 (32 KB)");

// the value of subtree slot j (heap index j + 2): lane j % G, register j / G
template <int G, int L>
__device__ __forceinline__ float pick(const float (&v)[L], int j,
                                      unsigned gmask) {
  const int slot = j / G;
  float mine = v[0];
#pragma unroll
  for (int q = 1; q < L; ++q)
    if (slot == q) mine = v[q];
  return __shfl_sync(gmask, mine, j % G, G);
}

__global__ void __launch_bounds__(kSampleThreads)
tree_sample_kernel(const float* __restrict__ tree, int depth, int capacity,
                   const float* __restrict__ targets, int b,
                   int* __restrict__ leaf_out, float* __restrict__ pri_out) {
  constexpr int K = kSampleK, G = kSampleLanes;
  constexpr int kLoads = ((2 << K) - 2 + G - 1) / G;   // subtree nodes/G
  extern __shared__ float stage[];
  pdl_trigger();
  pdl_wait();
  const size_t member = blockIdx.y;          // this block's tree
  tree += member << depth;
  targets += member * b;
  leaf_out += member * b;
  pri_out += member * b;
  const int staged = kTop < depth ? kTop : depth;  // levels 0 .. staged-1
  if (staged > 0)
    for (int i = threadIdx.x; i < (1 << staged); i += kSampleThreads)
      stage[i] = __ldg(tree + i);
  const int lane = threadIdx.x & (G - 1);
  const long long target = (static_cast<long long>(blockIdx.x) *
                            kSampleThreads + threadIdx.x) / G;
  const int i = static_cast<int>(target);
  float t = target < b ? __ldg(targets + i) : 0.f;
  if (staged > 0) __syncthreads();
  if (target >= b) return;                  // the whole group
  const unsigned gmask = group_mask<G>();
  const int half = 1 << (depth - 1);
  int node = 1, level = 0;
  float pri = 0.f;
  for (; level < staged - 1; ++level) {     // children of node are staged
    const float lmass = stage[2 * node];
    if (t >= lmass) {
      t = t - lmass;
      node = 2 * node + 1;
    } else {
      node = 2 * node;
    }
  }
  if (level == depth - 1) pri = stage[node];
  while (level < depth - 1) {
    const int k = min(K, depth - 1 - level);
    float v[kLoads];                          // subtree heap 2 .. 2^(k+1)-1
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int h = 2 + lane + j * G;
      v[j] = 0.f;
      if (h < (2 << k)) {
        const int lev = 31 - __clz(h);
        v[j] = __ldg(tree + (node << lev) + h - (1 << lev));
      }
    }
    int h = 1;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s < k) {
        const float lmass = pick<G>(v, 2 * h - 2, gmask);
        if (t >= lmass) {
          t = t - lmass;
          h = 2 * h + 1;
        } else {
          h = 2 * h;
        }
      }
    }
    node = (node << k) + h - (1 << k);
    level += k;
    if (level == depth - 1) pri = pick<G>(v, h - 2, gmask);
  }
  int leaf = node - half;
  if (leaf < 0 || leaf > capacity - 1) {    // clamped: read it again
    leaf = leaf < 0 ? 0 : capacity - 1;
    pri = __ldg(tree + half + leaf);
  }
  if (lane == 0) {
    leaf_out[i] = leaf;
    pri_out[i] = pri;
  }
}

// ------------------------------------------------------------------ set

constexpr int kSetThreads = 1024;           // entries a pass, one a thread
constexpr int kHashBits = 11;
constexpr int kHash = 1 << kHashBits;       // twice the entries of a pass

__global__ void __launch_bounds__(kSetThreads)
tree_set_kernel(float* tree, int depth, const int* __restrict__ idx,
                const float* __restrict__ val, int n, int* skipped) {
  __shared__ int hkey[kHash], hpos[kHash];  // leaf, its last position
  pdl_trigger();
  pdl_wait();
  const size_t member = blockIdx.x;          // one block a tree
  tree += member << depth;
  idx += member * n;
  val += member * n;
  const int tid = threadIdx.x, half = 1 << (depth - 1);
  for (int i = tid; i < kHash; i += kSetThreads) hkey[i] = hpos[i] = -1;
  for (int base = 0; base < n; base += kSetThreads) {
    const int i = base + tid;
    int leaf = i < n ? idx[i] : -1;
    if (i < n && (leaf < 0 || leaf >= half)) {
      atomicAdd(skipped, 1);
      leaf = -1;
    }
    __syncthreads();                        // the hash is clear
    int slot = -1;
    if (leaf >= 0) {                        // open addressing
      for (slot = static_cast<int>((static_cast<unsigned>(leaf) *
                                    0x9E3779B1u) >> (32 - kHashBits));;
           slot = (slot + 1) & (kHash - 1)) {
        const int k = atomicCAS(hkey + slot, -1, leaf);
        if (k == -1 || k == leaf) break;
      }
      atomicMax(hpos + slot, tid);
    }
    __syncthreads();
    if (leaf >= 0 && hpos[slot] != tid) leaf = -1;   // only the last goes on
    if (leaf >= 0) tree[half + leaf] = val[i];
    __syncthreads();
    if (leaf >= 0) hkey[slot] = hpos[slot] = -1;     // one winner a slot
    for (int shift = 1; shift < depth; ++shift) {   // levels depth-2 .. 0
      if (leaf >= 0) {
        const int node = (half + leaf) >> shift;
        tree[node] = tree[2 * node] + tree[2 * node + 1];
      }
      __syncthreads();
    }
  }
}

}  // namespace

// leaf (members, b) int32 and priority (members, b) float32 of each
// member's targets (members, b) in its tree (members trees of 2^depth nodes,
// one after another). Returns the CUDA error of the launch (0 on success).
extern "C" int tree_sample_members(const float* tree, int depth,
                                   int capacity, const float* targets, int b,
                                   int members, int* leaf, float* pri,
                                   void* stream) {
  if (depth < 2 || depth > 30 || capacity < 1 ||
      capacity > (1 << (depth - 1)) || b < 0 || members < 0 ||
      members > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || members == 0) return 0;
  const long long threads = static_cast<long long>(b) * kSampleLanes;
  const int blocks =
      static_cast<int>((threads + kSampleThreads - 1) / kSampleThreads);
  const int staged = kTop < depth ? kTop : depth;
  return launch(tree_sample_kernel, dim3(blocks, members),
                dim3(kSampleThreads), staged > 0 ? 4 << staged : 0,
                static_cast<cudaStream_t>(stream), tree, depth, capacity,
                targets, b, leaf, pri);
}

// The solo sample: one tree, leaf (b,) and priority (b,).
extern "C" int tree_sample(const float* tree, int depth, int capacity,
                           const float* targets, int b, int* leaf,
                           float* pri, void* stream) {
  return tree_sample_members(tree, depth, capacity, targets, b, 1, leaf, pri,
                             stream);
}

// In each of `members` trees, tree[half + idx[i]] = val[i] over that
// member's n entries (the last i wins for a repeated index), then the
// ancestors' sums, in place. Entries whose index lies outside [0, half)
// are skipped, and each adds one to the int32 `*skipped` (checking them on
// the host would cost a device sync per write). Returns the CUDA error of
// the launch (0 on success).
extern "C" int tree_set_members(float* tree, int depth, const int* idx,
                                const float* val, int n, int members,
                                int* skipped, void* stream) {
  if (depth < 2 || depth > 30 || n < 0 || members < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || members == 0) return 0;
  return launch(tree_set_kernel, dim3(members), dim3(kSetThreads), 0,
                static_cast<cudaStream_t>(stream), tree, depth, idx, val, n,
                skipped);
}

// The solo write: one tree.
extern "C" int tree_set(float* tree, int depth, const int* idx,
                        const float* val, int n, int* skipped,
                        void* stream) {
  return tree_set_members(tree, depth, idx, val, n, 1, skipped, stream);
}
