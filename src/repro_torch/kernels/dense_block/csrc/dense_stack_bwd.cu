// The fused MLP-DenseNet stack backward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dense_block/stack.py::_bwd_kernel (launched by
// _pallas_backward). The TPU kernel recomputes the stream and the
// pre-activations of a batch tile in VMEM, then sweeps the layers in
// reverse and accumulates every dW_i/db_i in place across batch tiles,
// which is safe there only because the TPU runs the batch grid in order.
// Blocks on the card run in no order. Two designs:
//
// A narrow densenet stack (U < 128 whose shared memory fits, stack.py's
// whole_bwd_smem: the OFENet stacks phi_s and phi_sa, at any M) runs
// whole in ONE launch, whole_bwd_kernel, the shape of the TPU kernel's
// sweep. Latency binds these stacks, not work (phi_sa: 0.09 GFLOP, ~1.4
// us at 67 TFLOP/s; about 20 per-layer launches took ~97 us). Its blocks
// take tickets in launch order (an integer counter):
//   sweeps    a block owns R rows (4, 8 or 16) and keeps, in shared
//             memory, their gradient stream (g's rows, then every
//             product's prefix added in place) and gz_i. For i = L-1 ..
//             lowest: gz_i = slot_i * act'(z_i); where a dW_i or db_i is
//             asked, gz_i goes to a scratch (layers, M, U rounded up) and
//             the layer's ready counter is raised; then, where layer i's
//             input gradient is needed, prefix [0, k_i) += gz_i @ W_i^T
//             with every W_i streamed, top layer first, through one
//             cp.async ring of 32-row stages (the weights do not depend on
//             the activations, so the next layer's rows are in flight while
//             a layer finishes). A thread owns one W row of a stage and a
//             group of 8 float4 columns (gz's matching columns held in
//             registers for the layer): its R dot products meet over the 8
//             lanes of the group by a fixed butterfly of shuffles (a
//             reduce-scatter: 4, 7 or 14 shuffles for 32-128 FMAs). The
//             sweep writes dx from the prefix where asked.
//   reductions dW_i and db_i sum over every row, across blocks: a tile
//             is 32 rows of dW_i (a layer's first tile also db_i), a task
//             block each. A task waits for layer i's ready count to reach
//             the number of sweeps (an acquire load, then a barrier), sums
//             every batch row in row order, the stream tile and gz_i
//             through a cp.async ring (gz through L2: it was written in this
//             launch), and writes dW_i and db_i. A task waits only for
//             sweeps, whose tickets came first and whose blocks are
//             running, so the waits end whatever the card runs at once; the
//             top layers' tasks overlap the sweeps' lower layers (counters
//             on one line, which spinning tasks and the sweeps' counts then
//             shared, lost time: each has a line of its own).
// Every sum runs in a fixed order and no float atomic is used, so a call is
// bitwise the same from run to run; the last block to finish puts the
// counters back to 0 (one zeroed buffer per stream, reusable across CUDA
// graph replays, as the split counters below). It writes only what is
// asked: dx, and dW_i and db_i of the layers from the lowest one asked.
//
// Every other stack (U >= 128, mlp and d2rl) runs three kernels that the
// Python wrapper (stack.py) launches per layer, in reverse layer order:
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
// actor and critic stacks at the paper's widths), and a wide stack's thin
// ones, whose only side under 128 is the layer's input width (the first
// layer's dW and dx where 32 <= d0 < 128: the presets' OFENet features;
// the tile masks the ragged edge), run the register-tiled tile of
// dense_tile_rt.cuh: 8x8 outputs a thread, float4 shared reads, 16 FMAs
// per shared load, a ring of cp.async K tiles, one barrier per K step.
// Smaller products (a narrow mlp or d2rl stack, a densenet stack the
// whole-stack kernel does not take, a batch under 128, a first layer
// under 32 wide such as fig3's observations, small shapes) keep
// dense_tile.cuh's tiles (4x4 outputs a thread, 2 FMAs per shared load),
// which the forward shares and which ran those faster.
//
// Split products take their tile counters from one zeroed buffer that the
// wrapper keeps per (device, stream): every kernel here leaves the
// counters it used at 0, so no launch fills them first.
//
// A fleet's E members run each launch once for all of them: the `_members`
// entry points take the solo arguments, the member count and each
// operand's member stride in elements (0: shared by every member) and put
// the member on gridDim.z; a member has its own split partials and tile
// counters (E sets), sums its splits in the solo order and resets its
// counters, so member e is bitwise the solo launch on its operands and the
// counters stay reusable across graph replays. The member kernels are
// kernels of their own that take the strides as more arguments; the solo
// kernels keep their arguments and code.

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
__device__ __forceinline__ void act_grad_run(
    const float* g, long long ldg, const float* z, long long ldz, float* gz,
    float* gzt, long long ldgt, float* db_part, int m, int n, int rows,
    int act) {
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

__global__ void __launch_bounds__(kCols * kRowGroups)
act_grad_kernel(const float* g, long long ldg, const float* z, long long ldz,
                float* gz, float* gzt, long long ldgt, float* db_part, int m,
                int n, int rows, int act) {
  act_grad_run(g, ldg, z, ldz, gz, gzt, ldgt, db_part, m, n, rows, act);
}

// member blockIdx.z; sg .. sdb: the member strides of g, z, gz, gzt, db_part
__global__ void __launch_bounds__(kCols * kRowGroups)
act_grad_members(const float* g, long long ldg, const float* z,
                 long long ldz, float* gz, float* gzt, long long ldgt,
                 float* db_part, int m, int n, int rows, int act,
                 long long sg, long long sz, long long sgz, long long sgzt,
                 long long sdb) {
  const long long e = blockIdx.z;
  act_grad_run(g + e * sg, ldg, z + e * sz, ldz, gz + e * sgz,
               gzt == nullptr ? gzt : gzt + e * sgzt, ldgt,
               db_part == nullptr ? db_part : db_part + e * sdb, m, n, rows,
               act);
}

// db[c] = sum of db_part[0..kRowBlocks)[c], in row order
__device__ __forceinline__ void db_sum_run(const float* db_part, float* db,
                                           int n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  float s = 0.f;
#pragma unroll
  for (int y = 0; y < kRowBlocks; ++y) s += db_part[y * n + c];
  db[c] = s;
}

__global__ void db_sum_kernel(const float* db_part, float* db, int n) {
  db_sum_run(db_part, db, n);
}

__global__ void db_sum_members(const float* db_part, float* db, int n,
                               long long sp, long long sdb) {
  db_sum_run(db_part + blockIdx.z * sp, db + blockIdx.z * sdb, n);
}

__device__ __forceinline__ void act_run(const float* z, long long ldz,
                                        float* out, int m, int n, int act) {
  const long long total = static_cast<long long>(m) * n;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = e / n, c = e % n;
    out[e] = apply_act(z[r * ldz + c], act);
  }
}

__global__ void act_kernel(const float* z, long long ldz, float* out, int m,
                           int n, int act) {
  act_run(z, ldz, out, m, n, act);
}

__global__ void act_members(const float* z, long long ldz, float* out, int m,
                            int n, int act, long long sz, long long so) {
  act_run(z + blockIdx.z * sz, ldz, out + blockIdx.z * so, m, n, act);
}

// The entry points' bodies: `members` = 0 for a solo launch, else the
// member count of one member launch, with each operand's member stride.

int act_grad(const float* g, long long ldg, const float* z, long long ldz,
             float* gz, float* gzt, long long ldgt, float* db_part, int m,
             int n, int act, int members, long long sg, long long sz,
             long long sgz, long long sgzt, long long sdb, void* stream) {
  if (m <= 0 || n <= 0 || act < dense_tile::kIdentity ||
      act > dense_tile::kSwish || (gzt != nullptr && ldgt < m))
    return static_cast<int>(cudaErrorInvalidValue);
  // rows per block: m over kRowBlocks blocks, in whole chunks
  const int chunks = (m + kRows - 1) / kRows;
  const int rows = (chunks + kRowBlocks - 1) / kRowBlocks * kRows;
  const int cols = (n + kCols - 1) / kCols;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (members > 0)
    act_grad_members<<<dim3(cols, kRowBlocks, members), kCols * kRowGroups,
                       0, st>>>(g, ldg, z, ldz, gz, gzt, ldgt, db_part, m,
                                n, rows, act, sg, sz, sgz, sgzt, sdb);
  else
    act_grad_kernel<<<dim3(cols, kRowBlocks), kCols * kRowGroups, 0, st>>>(
        g, ldg, z, ldz, gz, gzt, ldgt, db_part, m, n, rows, act);
  return static_cast<int>(cudaGetLastError());
}

int db_sum(const float* db_part, float* db, int n, int members, long long sp,
           long long sdb, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (members > 0)
    db_sum_members<<<dim3((n + 255) / 256, 1, members), 256, 0, st>>>(
        db_part, db, n, sp, sdb);
  else
    db_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(db_part, db, n);
  return static_cast<int>(cudaGetLastError());
}

int act_out(const float* z, long long ldz, float* out, int m, int n, int act,
            int members, long long sz, long long so, void* stream) {
  if (m <= 0 || n <= 0 || act < dense_tile::kIdentity ||
      act > dense_tile::kSwish)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(m) * n;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (members > 0)
    act_members<<<dim3(blocks, 1, members), 256, 0, st>>>(z, ldz, out, m, n,
                                                          act, sz, so);
  else
    act_kernel<<<blocks, 256, 0, st>>>(z, ldz, out, m, n, act);
  return static_cast<int>(cudaGetLastError());
}

int bwd_gemm(int config, int ta, int tw, const float* a1, long long lda1,
             int k1, const float* a2, long long lda2, int k2, const float* w,
             long long ldw, float* out, long long ldo, int accumulate,
             float* ws, int* counters, int m, int n, int splits,
             int chunks_per_split, int members,
             const dense_tile::TileStrides& s, void* stream) {
  const dense_tile::TileArgs p{a1, lda1, k1, a2, lda2, k2, w, ldw, nullptr,
                               out, ldo, nullptr, 0, ws, counters, m, n,
                               dense_tile::kIdentity, accumulate, splits,
                               chunks_per_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dense_tile::TileStrides* ms = members > 0 ? &s : nullptr;
  if (ta && !tw)
    return dense_tile::launch_config<true, false>(config, p, st, ms,
                                                  members);
  if (!ta && tw)
    return dense_tile::launch_config<false, true>(config, p, st, ms,
                                                  members);
  return static_cast<int>(cudaErrorInvalidValue);
}

int bwd_gemm_rt(int config, int dx, int vec, const float* a, long long lda,
                const float* b, long long ldb, float* out, long long ldo,
                const float* c, long long ldc, float* ws, int* counters,
                int m, int n, int k, int splits, int chunks_per_split,
                int members, const dense_tile_rt::Strides& s,
                void* stream) {
  const dense_tile_rt::Args p{a, lda, b, ldb, out, ldo, c, ldc, ws,
                              counters, m, n, k, splits, chunks_per_split};
  return dense_tile_rt::launch_config(config, dx != 0, vec, p,
                                      static_cast<cudaStream_t>(stream),
                                      members > 0 ? &s : nullptr, members);
}

// ---- a narrow densenet stack (U < 128) whole, in one launch ----------------

namespace whole {

using dense_tile_rt::cp_async16;
using dense_tile_rt::cp_async4;
using dense_tile_rt::cp_async_commit;
using dense_tile_rt::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kChunk = 32;        // W rows of a sweep ring stage
constexpr int kStages = 6;        // sweep ring stages: five in flight (12
                                  // measured no faster: launch/bwd_sweep)
constexpr int kMaxLayers = 16;    // stack.py's _WHOLE_MAX_LAYERS
constexpr int kTileK = 32;        // dW rows of a reduction task
constexpr int kTileM = 32;        // batch rows of a reduction ring stage
constexpr int kDwStages = 4;      // reduction ring stages
constexpr int kMaxSmem = 232448;  // 227 KB, a block's dynamic shared memory

struct Args {
  const float* w[kMaxLayers];            // layer i: (d0 + i*u, u), dense
  float* dw[kMaxLayers];                 // (d0 + i*u, u) dense, or null
  float* db[kMaxLayers];                 // (u,), or null
  const float* stream; long long lds;    // (m, d0 + layers*u): the forward's
  const float* zs; long long ldz;        // (m, layers*u)
  const float* g; long long ldg;         // (m, d0 + layers*u)
  float* dx; long long lddx;             // (m, d0), or null
  float* gz;                             // (layers, m, uc) scratch, or null
  int* counters;                         // counters_of(layers) a member,
                                         // all zero
  int m, d0, u, layers, lowest, act, sweeps, tasks;
};

// a member launch's strides in elements (0: shared, or a solo launch)
struct Strides {
  long long stream, zs, g, dx, gz;
  long long w[kMaxLayers], dw[kMaxLayers], db[kMaxLayers];
};

// A member's counters, each read while others are written, a 128-byte
// line apart: the ticket (0), the blocks done (1), layer i's ready count
// (kLine * (i + 1)).
constexpr int kLine = 32;
__host__ __device__ inline int counters_of(int layers) {
  return kLine * (layers + 1);
}
__device__ __forceinline__ int* ready_of(int* ctr, int i) {
  return ctr + kLine * (i + 1);
}

// reduction tiles of layer i: its dW's row tiles, or one for db alone;
// each is a task
__host__ __device__ inline int tiles_of(const Args& p, int i) {
  const int k = p.d0 + i * p.u;
  if (p.dw[i] != nullptr) return (k + kTileK - 1) / kTileK;
  return p.db[i] != nullptr ? 1 : 0;
}

// bytes of dynamic shared memory at R rows a sweep block and UC columns (U
// rounded up to 64 or 128): the sweep's gradient stream, gz and W ring, or
// a reduction task's ring, whichever is larger (stack.py's whole_bwd_smem)
__host__ __device__ inline int smem_bytes(int rows, int uc, int width) {
  const int sweep = rows * ((width + 3) & ~3) + rows * uc +
                    kStages * kChunk * (uc + 4);
  const int reduce = kDwStages * kTileM * (kTileK + uc);
  return 4 * (sweep > reduce ? sweep : reduce);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One step of a reduce-scatter over the 8 lanes of a column group: lanes
// with bit O set keep the upper half of the N sums, the others the lower
// half, each added to its partner's (lane ^ O) copy of the same half.
template <int N, int O>
__device__ __forceinline__ void rs_step(float* s, int lane) {
  constexpr int H = N / 2;
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = up ? s[j] : s[j + H];
    const float keep = up ? s[j + H] : s[j];
    s[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// The sweep of rows [tile * R, tile * R + R): the gradient stream g in
// shared memory, then for i = L-1 .. lowest: gz_i = slot_i * act'(z_i)
// (to the scratch for the reduction tasks, ready[i] counted), and, where
// layer i's input gradient is needed, slot prefix [0, k_i) += gz_i @ W_i^T
// with W_i streamed through the ring. Thread (warp w, lane l) owns W row
// kk = 4w + l/8 of each ring stage and the columns cg*4 + 32h of column
// group cg = l % 8 (a float4 each, h < UC/32): its R partial dot products
// meet over the 8 lanes of the group in a fixed butterfly.
template <int R, int UC, bool VW>
__device__ __forceinline__ void sweep(const Args& p, const Strides& s,
                                      long long mem, int tile, int* ctr) {
  constexpr int NH = UC / 32;
  constexpr int LDW = UC + 4;                 // 16-byte ring rows, and
                                              // conflict-free float4 reads
  constexpr int STAGE = kChunk * LDW;
  extern __shared__ __align__(16) float smem[];
  const int width = p.d0 + p.layers * p.u;
  const int ldgs = (width + 3) & ~3;
  float* const gs = smem;                     // gs[r * ldgs + k]
  float* const gzs = gs + R * ldgs;           // gzs[r * UC + c]
  float* const ring = gzs + R * UC;           // ring[slot][kk * LDW + c]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kk = 4 * warp + lane / 8, cg = lane % 8;
  const int row0 = tile * R, rows = min(R, p.m - row0);
  const float* const zs = p.zs + mem * s.zs;
  const float* const g = p.g + mem * s.g;
  float* const gzb = p.gz == nullptr ? nullptr : p.gz + mem * s.gz;
  // the lowest layer whose input gradient is needed (lowest is 0 with dx)
  const int dlow = p.dx != nullptr ? 0 : p.lowest + 1;

  // every W_i the products read, top layer first, in chunks of kChunk rows
  // that never straddle a layer: layer cl from row ck into stage cs; every
  // call commits one group (empty at the end)
  int cl = p.layers - 1, ck = 0, cs = 0;
  auto copy_next = [&]() {
    if (cl >= dlow) {
      const int k_l = p.d0 + cl * p.u;
      const int kb = min(kChunk, k_l - ck);
      const float* w0 = p.w[cl] + mem * s.w[cl];
      const float* w = w0 + static_cast<long long>(ck) * p.u;
      float* dst = ring + cs * STAGE;
      if constexpr (VW) {
#pragma unroll
        for (int j = 0; j < kChunk * UC / 4 / kThreads; ++j) {
          const int e = tid + j * kThreads;
          const int r = e / (UC / 4), col = (e % (UC / 4)) * 4;
          const bool in = r < kb && col < p.u;
          cp_async16(dst + r * LDW + col, in ? w + r * p.u + col : w0,
                     in ? 16 : 0);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kChunk * UC / kThreads; ++j) {
          const int e = tid + j * kThreads;
          const int r = e / UC, col = e % UC;
          const bool in = r < kb && col < p.u;
          cp_async4(dst + r * LDW + col, in ? w + r * p.u + col : w0,
                    in ? 4 : 0);
        }
      }
      ck += kChunk;
      if (ck >= k_l) {
        ck = 0;
        --cl;
      }
    }
    cp_async_commit();
    cs = cs + 1 == kStages ? 0 : cs + 1;
  };
  // g's rows (zeros past the last row) by 4-byte copies, all in flight at
  // once, joining the first ring stage's group: the first layer waits for
  // that group (its chunk loop's first wait, or the one below)
  for (int e = tid; e < R * width; e += kThreads) {
    const int r = e / width, k = e % width;
    cp_async4(gs + r * ldgs + k,
              r < rows ? g + static_cast<long long>(row0 + r) * p.ldg + k
                       : g,
              r < rows ? 4 : 0);
  }
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) copy_next();
  cp_async_wait<kStages - 2>();               // g (and chunk 0) landed

  // the thread's elements e = tid + j * kThreads of a layer's (R, UC) gz
  // and the pre-activations they need, loaded a layer ahead (in flight
  // while the layer above runs its product)
  constexpr int NZ = R * UC / kThreads;
  float zpre[NZ];
  auto load_z = [&](int i) {
#pragma unroll
    for (int j = 0; j < NZ; ++j) {
      const int e = tid + j * kThreads, r = e / UC, c = e % UC;
      zpre[j] = r < rows && c < p.u
                    ? zs[static_cast<long long>(row0 + r) * p.ldz +
                         i * p.u + c]
                    : 0.f;
    }
  };
  load_z(p.layers - 1);

  int slot = 0;                               // the ring stage computed next
  for (int i = p.layers - 1; i >= p.lowest; --i) {
    const int k_i = p.d0 + i * p.u;
    // gs holds layer i's slot (g's, plus every product above), and every
    // thread is done with the gz of the layer above
    __syncthreads();
    float* const gzl = gzb != nullptr && (p.dw[i] != nullptr ||
                                          p.db[i] != nullptr)
                           ? gzb + static_cast<long long>(i) * p.m * UC
                           : nullptr;
#pragma unroll
    for (int j = 0; j < NZ; ++j) {
      const int e = tid + j * kThreads, r = e / UC, c = e % UC;
      float v = 0.f;
      if (r < rows && c < p.u)
        v = gs[r * ldgs + k_i + c] * act_grad(zpre[j], p.act);
      gzs[e] = v;
      if (gzl != nullptr && r < rows)
        gzl[static_cast<long long>(row0 + r) * UC + c] = v;
    }
    if (i > p.lowest) load_z(i - 1);
    __syncthreads();
    // every thread's gz stores precede the barrier; thread 0's fence makes
    // them visible device-wide before the count (as a grid barrier does)
    if (gzl != nullptr && tid == 0) {
      __threadfence();
      atomicAdd(ready_of(ctr, i), 1);
    }
    if (i < dlow) continue;
    float4 gv[R][NH];                         // the thread's gz columns
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int h = 0; h < NH; ++h)
        gv[r][h] = *reinterpret_cast<const float4*>(gzs + r * UC + cg * 4 +
                                                    32 * h);
    for (int k0 = 0; k0 < k_i; k0 += kChunk) {
      cp_async_wait<kStages - 2>();
      // this chunk has landed for every thread, and every thread is done
      // with the last one, whose stage the copy below refills
      __syncthreads();
      copy_next();
      const float* wr = ring + slot * STAGE + kk * LDW + cg * 4;
      slot = slot + 1 == kStages ? 0 : slot + 1;
      float4 wv[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h)
        wv[h] = *reinterpret_cast<const float4*>(wr + 32 * h);
      float sum[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a = 0.f;
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          a = fmaf(gv[r][h].x, wv[h].x, a);
          a = fmaf(gv[r][h].y, wv[h].y, a);
          a = fmaf(gv[r][h].z, wv[h].z, a);
          a = fmaf(gv[r][h].w, wv[h].w, a);
        }
        sum[r] = a;
      }
      // lane cg ends with rows [cg * R/8, (cg + 1) * R/8) (R >= 8), or
      // with row cg / 2 (R = 4: its pair holds the same sum)
      rs_step<R, 4>(sum, lane);
      rs_step<R / 2, 2>(sum, lane);
      if constexpr (R >= 8) {
        rs_step<R / 4, 1>(sum, lane);
      } else {
        sum[0] += __shfl_xor_sync(0xffffffffu, sum[0], 1);
      }
      const int k = k0 + kk;
      if (k < k_i) {
        if constexpr (R >= 8) {
#pragma unroll
          for (int v = 0; v < R / 8; ++v)
            gs[(cg * (R / 8) + v) * ldgs + k] += sum[v];
        } else if ((cg & 1) == 0) {
          gs[(cg >> 1) * ldgs + k] += sum[0];
        }
      }
    }
  }
  cp_async_wait<0>();                         // only empty groups are left
  __syncthreads();
  if (p.dx == nullptr) return;
  float* const dx = p.dx + mem * s.dx;
  for (int e = tid; e < rows * p.d0; e += kThreads) {
    const int r = e / p.d0, k = e % p.d0;
    dx[static_cast<long long>(row0 + r) * p.lddx + k] = gs[r * ldgs + k];
  }
}

// Reduction task `task`: tile t of layer i: dW_i's rows [k0, k0 + kTileK) =
// stream[:, k0..]^T @ gz_i over every batch row, and, for the layer's first
// tile, db_i = the column sums of gz_i, once every sweep block has written
// gz_i (ready[i]). The batch rows stream through a ring of kTileM rows of
// the stream tile and of gz_i. The two halves of the block take the two
// halves of each stage's rows; in a half, thread
// (tk, tc) = (t / 16, t % 16) owns dW rows k0 + 4tk .. + 3 and columns
// tc*4 + 64h .. + 3 (16 FMAs for two float4 shared loads a batch row; a
// thread whose rows are all past k_i does none). Each half sums its rows
// in order, and the halves meet once, in fixed order.
template <int UC>
__device__ __forceinline__ void reduce(const Args& p, const Strides& s,
                                       long long mem, int task, int* ctr) {
  constexpr int NH = UC / 64;
  constexpr int GZ = kTileM * kTileK;         // the gz tile's offset
  constexpr int STAGE = GZ + kTileM * UC;
  constexpr int HALF = kThreads / 2, HM = kTileM / 2;
  constexpr int PER = 4 * NH * 4 + NH * 4;    // a thread's sums: dW, db
  static_assert(HALF == 16 * kTileK / 4, "a half covers the tile");
  extern __shared__ __align__(16) float smem[];
  // tasks run top layer first, a layer's tiles in order
  int i = p.layers - 1, t = task;
  for (; i > p.lowest; --i) {
    const int n = tiles_of(p, i);
    if (t < n) break;
    t -= n;
  }
  const int tid = threadIdx.x, half = tid / HALF;
  const int tk = (tid % HALF) / 16, tc = tid % 16;
  const int k_i = p.d0 + i * p.u, k0 = t * kTileK;
  float* const dw = p.dw[i] == nullptr ? nullptr : p.dw[i] + mem * s.dw[i];
  float* const db =
      p.db[i] == nullptr || t != 0 ? nullptr : p.db[i] + mem * s.db[i];
  const float* const stream = p.stream + mem * s.stream;
  const float* const gzl =
      p.gz + mem * s.gz + static_cast<long long>(i) * p.m * UC;
  const int steps = (p.m + kTileM - 1) / kTileM;   // the batch's stages
  const bool rows_in = dw != nullptr && k0 + 4 * tk < k_i;

  if (tid == 0) {
    while (load_acquire(ready_of(ctr, i)) < p.sweeps) __nanosleep(100);
    __threadfence();
  }
  __syncthreads();

  auto copy_stage = [&](int st) {
    if (st < steps) {
      float* dst = smem + (st % kDwStages) * STAGE;
      const int m0 = st * kTileM;
      if (dw != nullptr) {
#pragma unroll
        for (int j = 0; j < kTileM * kTileK / kThreads; ++j) {
          const int e = tid + j * kThreads;
          const int r = e / kTileK, c = e % kTileK;
          const bool in = m0 + r < p.m && k0 + c < k_i;
          cp_async4(dst + e,
                    in ? stream + static_cast<long long>(m0 + r) * p.lds +
                             k0 + c
                       : stream,
                    in ? 4 : 0);
        }
      }
      // gz: written in this launch, so through L2 (cp.async.cg)
#pragma unroll
      for (int j = 0; j < kTileM * UC / 4 / kThreads; ++j) {
        const int e = tid + j * kThreads;
        const int r = e / (UC / 4), c = (e % (UC / 4)) * 4;
        const bool in = m0 + r < p.m;
        cp_async16(dst + GZ + r * UC + c,
                   in ? gzl + static_cast<long long>(m0 + r) * UC + c : gzl,
                   in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kDwStages - 1; ++st) copy_stage(st);

  float acc[4][NH][4], sums[NH][4];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][h][j] = 0.f;
      sums[h][j] = 0.f;
    }
  const bool sum_db = db != nullptr && tk == 0;
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<kDwStages - 2>();
    // this stage has landed for every thread, and every thread is done
    // with the last one, whose buffer the copy below refills
    __syncthreads();
    copy_stage(st + kDwStages - 1);
    const float* sb = smem + (st % kDwStages) * STAGE + half * HM * kTileK;
    const float* gb = smem + (st % kDwStages) * STAGE + GZ + half * HM * UC;
    if (rows_in) {
#pragma unroll 4
      for (int r = 0; r < HM; ++r) {          // rows past m are zeros
        float4 b[NH];
#pragma unroll
        for (int h = 0; h < NH; ++h)
          b[h] = *reinterpret_cast<const float4*>(gb + r * UC + tc * 4 +
                                                  64 * h);
        const float4 a4 =
            *reinterpret_cast<const float4*>(sb + r * kTileK + 4 * tk);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            acc[a][h][0] = fmaf(av[a], b[h].x, acc[a][h][0]);
            acc[a][h][1] = fmaf(av[a], b[h].y, acc[a][h][1]);
            acc[a][h][2] = fmaf(av[a], b[h].z, acc[a][h][2]);
            acc[a][h][3] = fmaf(av[a], b[h].w, acc[a][h][3]);
          }
      }
    }
    if (sum_db) {
#pragma unroll 4
      for (int r = 0; r < HM; ++r)
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float4 b = *reinterpret_cast<const float4*>(
              gb + r * UC + tc * 4 + 64 * h);
          sums[h][0] += b.x;
          sums[h][1] += b.y;
          sums[h][2] += b.z;
          sums[h][3] += b.w;
        }
    }
  }
  cp_async_wait<0>();                         // only empty groups are left
  __syncthreads();                            // the ring is free
  // half 1 hands its sums to half 0 through shared memory; half 0 adds
  // them to its own (half 0 + half 1, one fixed order)
  float* const xfer = smem + (tid % HALF) * PER;
  if (half == 1) {
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int a = 0; a < 4; ++a) xfer[(a * NH + h) * 4 + j] = acc[a][h][j];
        xfer[16 * NH + h * 4 + j] = sums[h][j];
      }
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][h][j] += xfer[(a * NH + h) * 4 + j];
        sums[h][j] += xfer[16 * NH + h * 4 + j];
      }
  }
  // out(a, c): the tile's row 4tk + a (a = 4: db), column c
  auto store = [&](auto&& out) {
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc * 4 + 64 * h + j;
#pragma unroll
        for (int a = 0; a < 4; ++a) out(a, c, acc[a][h][j]);
        out(4, c, sums[h][j]);
      }
  };
  auto emit = [&](int a, int c, float v) {    // into dW and db
    if (c >= p.u) return;
    if (a < 4) {
      const int k = k0 + 4 * tk + a;
      if (dw != nullptr && k < k_i)
        dw[static_cast<long long>(k) * p.u + c] = v;
    } else if (sum_db) {
      db[c] = v;
    }
  };
  if (half == 0) store(emit);
}

// Blocks take tickets in launch order from the member's counter 0: the
// first `sweeps` are sweeps, the rest reduction tasks, top layer first. A
// task waits only for sweeps, and a sweep's ticket was taken by a block
// already running, so the waits always end, whatever blocks the card runs
// at once. The last block to finish (counter 1) puts the member's ticket,
// ready and done counters back to 0 for the next launch. The ticket passes
// through the first word of the dynamic shared memory (no static shared
// memory: the launch may then take all 227 KB).
template <int R, int UC, bool VW>
__global__ void __launch_bounds__(kThreads)
whole_bwd_kernel(const __grid_constant__ Args p,
                 const __grid_constant__ Strides s) {
  extern __shared__ __align__(16) float smem[];
  int* const s_ticket = reinterpret_cast<int*>(smem);
  // a programmatic dependent launch: it may start while the kernel before
  // it finishes, and waits here for that kernel's writes (g, zs, the
  // stream, the counters' reset) before touching memory
  dense_tile::pdl_wait();
  const long long mem = blockIdx.z;
  int* const ctr = p.counters + mem * counters_of(p.layers);
  if (threadIdx.x == 0) *s_ticket = atomicAdd(ctr, 1);
  __syncthreads();
  const int ticket = *s_ticket;
  __syncthreads();                          // read before smem is reused
  if (ticket < p.sweeps)
    sweep<R, UC, VW>(p, s, mem, ticket, ctr);
  else
    reduce<UC>(p, s, mem, ticket - p.sweeps, ctr);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ctr + 1, 1) == p.sweeps + p.tasks - 1) {
      ctr[0] = 0;
      for (int i = 0; i < p.layers; ++i) *ready_of(ctr, i) = 0;
      ctr[1] = 0;
    }
  }
}

template <int R, int UC, bool VW>
int launch(const Args& p, const Strides& s, int members, int smem,
           cudaStream_t stream) {
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      whole_bwd_kernel<R, UC, VW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.sweeps + p.tasks, 1, members);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, whole_bwd_kernel<R, UC, VW>, p, s);
  cudaGetLastError();                       // returned here, not kept
  return static_cast<int>(err);
}

template <int R, int UC>
int launch_vw(bool vw, const Args& p, const Strides& s, int members,
              int smem, cudaStream_t stream) {
  return vw ? launch<R, UC, true>(p, s, members, smem, stream)
            : launch<R, UC, false>(p, s, members, smem, stream);
}

}  // namespace whole

// 16-byte copies of every member's rows: the address and row stride, and
// the member stride a multiple of 4 floats
bool member_aligned(const void* p, long long ld, long long s) {
  return dense_tile_rt::aligned16(p, ld) && (s & 3) == 0;
}

int stack_bwd_whole(int rows, int vec_w, int layers, const long long* w_ptrs,
                    const long long* dw_ptrs, const long long* db_ptrs,
                    const float* stream_out, long long lds, const float* zs,
                    long long ldz, const float* g, long long ldg, float* dx,
                    long long lddx, float* gz, int* counters, int m,
                    int d0, int u, int lowest, int act,
                    int members, const whole::Strides& s, void* stream) {
  if (m <= 0 || d0 <= 0 || u <= 0 || u >= 128 || layers < 1 ||
      layers > whole::kMaxLayers || lowest < 0 || lowest >= layers ||
      (dx != nullptr && lowest != 0) || stream_out == nullptr ||
      zs == nullptr || g == nullptr || counters == nullptr || members < 1 ||
      lds < d0 + layers * u || ldz < layers * u || ldg < d0 + layers * u ||
      (dx != nullptr && lddx < d0) || act < dense_tile::kIdentity ||
      act > dense_tile::kSwish || (vec_w && (u & 3) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int uc = u <= 64 ? 64 : 128;
  if (rows * uc > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = whole::smem_bytes(rows, uc, d0 + layers * u);
  if (smem > whole::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  whole::Args p{};
  for (int i = 0; i < layers; ++i) {
    p.w[i] = reinterpret_cast<const float*>(w_ptrs[i]);
    p.dw[i] = reinterpret_cast<float*>(dw_ptrs[i]);
    p.db[i] = reinterpret_cast<float*>(db_ptrs[i]);
    if (p.w[i] == nullptr ||
        (i < lowest && (p.dw[i] != nullptr || p.db[i] != nullptr)) ||
        (vec_w && !member_aligned(p.w[i], u, s.w[i])))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.stream = stream_out;
  p.lds = lds;
  p.zs = zs;
  p.ldz = ldz;
  p.g = g;
  p.ldg = ldg;
  p.dx = dx;
  p.lddx = lddx;
  p.gz = gz;
  p.counters = counters;
  p.m = m;
  p.d0 = d0;
  p.u = u;
  p.layers = layers;
  p.lowest = lowest;
  p.act = act;
  p.sweeps = (m + rows - 1) / rows;
  p.tasks = 0;
  for (int i = lowest; i < layers; ++i) p.tasks += whole::tiles_of(p, i);
  // gz (layers, m, uc) of 16-byte rows for the reduction tasks' copies
  if (p.tasks > 0 && (gz == nullptr || !member_aligned(gz, 0, s.gz)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v = vec_w != 0;
  if (uc == 64) {
    switch (rows) {
      case 4: return whole::launch_vw<4, 64>(v, p, s, members, smem, st);
      case 8: return whole::launch_vw<8, 64>(v, p, s, members, smem, st);
      case 16: return whole::launch_vw<16, 64>(v, p, s, members, smem, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (rows) {
    case 4: return whole::launch_vw<4, 128>(v, p, s, members, smem, st);
    case 8: return whole::launch_vw<8, 128>(v, p, s, members, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// (a): gz (m, n) contiguous; gzt (n, m) of row stride ldgt, or null;
// db_part (8, n) of per-row-block column sums, or null.
extern "C" int dense_bwd_act_grad(const float* g, long long ldg,
                                  const float* z, long long ldz, float* gz,
                                  float* gzt, long long ldgt, float* db_part,
                                  int m, int n, int act, void* stream) {
  return act_grad(g, ldg, z, ldz, gz, gzt, ldgt, db_part, m, n, act, 0, 0,
                  0, 0, 0, 0, stream);
}

// (a) for `members` members in one launch; sg .. sdb: the member strides
// of g, z, gz, gzt and db_part.
extern "C" int dense_bwd_act_grad_members(
    const float* g, long long ldg, const float* z, long long ldz, float* gz,
    float* gzt, long long ldgt, float* db_part, int m, int n, int act,
    int members, long long sg, long long sz, long long sgz, long long sgzt,
    long long sdb, void* stream) {
  if (members < 1) return static_cast<int>(cudaErrorInvalidValue);
  return act_grad(g, ldg, z, ldz, gz, gzt, ldgt, db_part, m, n, act, members,
                  sg, sz, sgz, sgzt, sdb, stream);
}

// (a), second pass: db (n,) from db_part (8, n).
extern "C" int dense_bwd_db(const float* db_part, float* db, int n,
                            void* stream) {
  return db_sum(db_part, db, n, 0, 0, 0, stream);
}

// dense_bwd_db for `members` members; sp, sdb: the member strides of
// db_part and db.
extern "C" int dense_bwd_db_members(const float* db_part, float* db, int n,
                                    int members, long long sp, long long sdb,
                                    void* stream) {
  if (members < 1) return static_cast<int>(cudaErrorInvalidValue);
  return db_sum(db_part, db, n, members, sp, sdb, stream);
}

// dst (cols, rows) of row stride ldd = src (rows, cols)^T: dx's W_i^T.
extern "C" int dense_bwd_transpose(const float* src, long long lds,
                                   float* dst, long long ldd, int rows,
                                   int cols, void* stream) {
  return dense_tile::launch_transpose(src, lds, dst, ldd, nullptr, 0, rows,
                                      cols,
                                      static_cast<cudaStream_t>(stream));
}

// dense_bwd_transpose for `members` members; ss, sd: the member strides of
// src and dst.
extern "C" int dense_bwd_transpose_members(const float* src, long long lds,
                                           float* dst, long long ldd,
                                           int rows, int cols, int members,
                                           long long ss, long long sd,
                                           void* stream) {
  if (members < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dense_tile::launch_transpose(src, lds, dst, ldd, nullptr, 0, rows,
                                      cols,
                                      static_cast<cudaStream_t>(stream),
                                      members, ss, sd, 0);
}

// out (m, n) contiguous = act(z[:, :n]).
extern "C" int dense_bwd_act(const float* z, long long ldz, float* out,
                             int m, int n, int act, void* stream) {
  return act_out(z, ldz, out, m, n, act, 0, 0, 0, stream);
}

// dense_bwd_act for `members` members; sz, so: the member strides of z and
// out.
extern "C" int dense_bwd_act_members(const float* z, long long ldz,
                                     float* out, int m, int n, int act,
                                     int members, long long sz, long long so,
                                     void* stream) {
  if (members < 1) return static_cast<int>(cudaErrorInvalidValue);
  return act_out(z, ldz, out, m, n, act, members, sz, so, stream);
}

// (b) and (c) at shapes below the register-tiled tile (configs 0-2): the
// tile product out (+)= A @ W with the layouts of dense_tile.cuh; `ta` = 1
// for (b) (A stored transposed), `tw` = 1 for (c) (W stored transposed).
// No bias, identity activation.
extern "C" int dense_bwd_gemm(int config, int ta, int tw, const float* a1,
                              long long lda1, int k1, const float* a2,
                              long long lda2, int k2, const float* w,
                              long long ldw, float* out, long long ldo,
                              int accumulate, float* ws, int* counters,
                              int m, int n, int splits, int chunks_per_split,
                              void* stream) {
  return bwd_gemm(config, ta, tw, a1, lda1, k1, a2, lda2, k2, w, ldw, out,
                  ldo, accumulate, ws, counters, m, n, splits,
                  chunks_per_split, 0, {}, stream);
}

// dense_bwd_gemm for `members` members in one launch; sa1, sa2, sw, so:
// the member strides of a1, a2, w and out. ws: (members, splits, m, n);
// counters: members x tiles.
extern "C" int dense_bwd_gemm_members(
    int config, int ta, int tw, const float* a1, long long lda1, int k1,
    const float* a2, long long lda2, int k2, const float* w, long long ldw,
    float* out, long long ldo, int accumulate, float* ws, int* counters,
    int m, int n, int splits, int chunks_per_split, int members,
    long long sa1, long long sa2, long long sw, long long so, void* stream) {
  if (members < 1) return static_cast<int>(cudaErrorInvalidValue);
  return bwd_gemm(config, ta, tw, a1, lda1, k1, a2, lda2, k2, w, ldw, out,
                  ldo, accumulate, ws, counters, m, n, splits,
                  chunks_per_split, members, {sa1, sa2, sw, 0, so, 0},
                  stream);
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
  return bwd_gemm_rt(config, dx, vec, a, lda, b, ldb, out, ldo, c, ldc, ws,
                     counters, m, n, k, splits, chunks_per_split, 0, {},
                     stream);
}

// dense_bwd_gemm_rt for `members` members in one launch; sa, sb, so, sc:
// the member strides of a, b (multiples of 4 where `vec` asks 16-byte
// copies), out and c. ws: (members, splits, m, n rounded up to 4);
// counters: members x tiles.
extern "C" int dense_bwd_gemm_rt_members(
    int config, int dx, int vec, const float* a, long long lda,
    const float* b, long long ldb, float* out, long long ldo, const float* c,
    long long ldc, float* ws, int* counters, int m, int n, int k, int splits,
    int chunks_per_split, int members, long long sa, long long sb,
    long long so, long long sc, void* stream) {
  if (members < 1) return static_cast<int>(cudaErrorInvalidValue);
  return bwd_gemm_rt(config, dx, vec, a, lda, b, ldb, out, ldo, c, ldc, ws,
                     counters, m, n, k, splits, chunks_per_split, members,
                     {sa, sb, so, sc}, stream);
}

// The whole narrow densenet stack backward (U < 128, up to 16 layers) in
// one launch, `rows` (4, 8 or 16; 4 or 8 past U = 64) rows a sweep block:
// from the forward's output `stream_out` (m, d0 + layers*u), its
// pre-activations zs (m, layers*u) and the gradient g of the output,
// dx (m, d0) when dx is given (then lowest = 0), and for each layer i >=
// lowest dW_i (dw_ptrs[i]: (d0 + i*u, u) dense) and db_i (db_ptrs[i]: (u,))
// where given (0 elsewhere); w_ptrs, dw_ptrs, db_ptrs: host arrays of
// `layers` device pointers. gz: (layers, m, uc) scratch (uc: u rounded up
// to 64 or 128), 16-byte aligned, needed where any dW or db is asked; each
// reduction tile (32 rows of a dW_i, or db_i alone) is one task; counters:
// 32 * (layers + 1) ints (whole::counters_of), zero, left zero. `vec_w`: every w_i takes 16-byte
// copies (16-byte aligned, u a multiple of 4).
extern "C" int dense_bwd_whole(int rows, int vec_w, int layers,
                               const long long* w_ptrs,
                               const long long* dw_ptrs,
                               const long long* db_ptrs,
                               const float* stream_out, long long lds,
                               const float* zs, long long ldz,
                               const float* g, long long ldg, float* dx,
                               long long lddx, float* gz, int* counters,
                               int m, int d0, int u, int lowest, int act,
                               void* stream) {
  return stack_bwd_whole(rows, vec_w, layers, w_ptrs, dw_ptrs, db_ptrs,
                         stream_out, lds, zs, ldz, g, ldg, dx, lddx, gz,
                         counters, m, d0, u, lowest, act, 1,
                         whole::Strides{}, stream);
}

// dense_bwd_whole for `members` members in one launch; sst, sz, sg, sdx,
// sgz: the member strides of stream_out, zs, g, dx and gz (a multiple of
// 4); w_strides, dw_strides, db_strides: host arrays of each layer's member
// strides (w_i's a multiple of 4 with vec_w). counters: members x
// whole::counters_of(layers).
extern "C" int dense_bwd_whole_members(
    int rows, int vec_w, int layers, const long long* w_ptrs,
    const long long* dw_ptrs, const long long* db_ptrs,
    const float* stream_out, long long lds, const float* zs, long long ldz,
    const float* g, long long ldg, float* dx, long long lddx, float* gz,
    int* counters, int m, int d0, int u, int lowest, int act, int members,
    long long sst, long long sz, long long sg, long long sdx, long long sgz,
    const long long* w_strides, const long long* dw_strides,
    const long long* db_strides, void* stream) {
  if (members < 1 || layers < 1 || layers > whole::kMaxLayers ||
      w_strides == nullptr || dw_strides == nullptr || db_strides == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  whole::Strides s{};
  s.stream = sst;
  s.zs = sz;
  s.g = sg;
  s.dx = sdx;
  s.gz = sgz;
  for (int i = 0; i < layers; ++i) {
    s.w[i] = w_strides[i];
    s.dw[i] = dw_strides[i];
    s.db[i] = db_strides[i];
  }
  return stack_bwd_whole(rows, vec_w, layers, w_ptrs, dw_ptrs, db_ptrs,
                         stream_out, lds, zs, ldz, g, ldg, dx, lddx, gz,
                         counters, m, d0, u, lowest, act, members, s,
                         stream);
}
