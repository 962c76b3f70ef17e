// The fused MLP-DenseNet stack forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dense_block/stack.py::_fwd_kernel (launched by
// _pallas_forward). The TPU kernel keeps a whole row tile of the concat
// stream and every layer's weights in VMEM and runs all L layers in one
// program. On Hopper that holds for the narrow OFENet stacks (U = 64: 0.1-
// 0.4 MB of weights), whose whole stack runs in one launch (whole_stack_
// kernel, below), but not for the wide ones (the paper's large actor holds
// 21 MB of fp32 weights), whose stack becomes one launch per layer; the
// Python wrapper (stack.py) lays the layers out so the concat never exists:
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
// Each launch computes out[:, slot] = act(A @ W + b) in fp32, and, when
// autograd will need it, stores the pre-activation z into the backward's
// (M, L*U) side buffer (`zout`), so the backward recomputes nothing. Four
// kernels, by the rows M and the width U of the call (stack.py's plan_fwd
// picks):
//
//   M <= 32 (serving slots, the actor pool's collect): stream_kernel. Each
//     weight meets at most 32 rows, <= 16 FLOP per byte against the card's
//     fp32 ridge of 20, so the weight bytes bound it (the large actor:
//     21 MB, ~6.3 us at 3.35 TB/s). A block owns a strip of 128 output
//     columns and a range of K; A's rows of that range sit in shared
//     memory, transposed (4-byte cp.async copies, all in flight at once),
//     read as broadcasts. W's rows of the strip, one
//     512-byte coalesced run each, stream through a ring of shared stages
//     of 8 rows filled by cp.async (a 16-byte copy a thread): four stages,
//     16 KB, in flight per block while one computes, two blocks an SM.
//     Warps split each stage's rows (and, past 8 rows of M, the rows of
//     M); their sums meet in shared memory in fixed order. A K split
//     sums in the strip's last block, 16 float4 loads a thread in flight.
//   M >= 128 with U >= 128 (the actor and critic stacks at the batch of
//     256, every connectivity): the register tile of dense_tile_rt.cuh
//     (128x64 tiles, 8x4 outputs a thread, 16 FMAs per shared load, a
//     cp.async ring). It computes A^T @ B with both operands stored along
//     K, and W already is; the layer's input is not, so the wrapper keeps
//     it transposed (rows padded to 4 floats) and one init launch a call
//     writes x^T, and each layer's epilogue writes y_i^T (one 16-byte
//     store per 4 rows) where the next layer reads it:
//       densenet: `stream^T`; dense_tile.cuh's transpose_kernel also
//         writes x into the stream, and every layer y_i into its slot;
//       mlp: two ping-pong slots of h^T after x^T (xt_kernel writes x^T);
//         the layers below the last write only h_i^T (their row-major
//         output would be read by nobody: the backward recomputes h from
//         zs), the last one only the row-major feature;
//       d2rl: two slabs [h^T | x^T] of U + d0 rows, x^T written into both
//         by the one init (xt_kernel<true>): the input [h_{i-1} | x] of
//         layer i > 0 is then ONE operand of consecutive rows in W's row
//         order, so K stays one reduction and the tile needs no second
//         segment; layer 0 reads slab 0's x^T (K = d0: 3-4 at pendulum,
//         one zero-padded K step), layer i slab i % 2 whole, and writes
//         h_i^T into the other slab's first U rows.
//     The fp32 operations bound it (the actor: 2.7 GFLOP, ~40 us at 67
//     TFLOP/s; fig3's U=2048 mlp critic 2.15 GFLOP, ~32 us).
//   M > 32, densenet with U < 128 (the OFENet stacks phi_s and phi_sa at
//     the batch of 256: 0.01-0.05 GFLOP, 0.1-0.4 MB of weights): the whole
//     stack in ONE launch, whole_stack_kernel. Latency binds it, not work:
//     one launch a layer put 16-32 blocks on the 132 SMs for ~15 us a
//     layer. A block owns R rows (4, 8 or 16) and sweeps the L layers. It
//     keeps its rows of the stream [x | y_0 | ..] in shared memory,
//     transposed (read as float4 broadcasts), and streams every layer's W,
//     layer after layer, through one cp.async ring of 32-row stages (the
//     weights do not depend on the activations, so the next layer's rows
//     are in flight while a layer finishes). A thread owns one column and
//     a K group of each stage's rows; the K groups' sums meet in shared
//     memory in fixed order, then z + b, act, and y_i go to shared memory
//     (for the next layer), the output's column slot and zs. One barrier
//     between layers; no split, no atomics, no counters: bitwise the same
//     from call to call. What bounds it: each block streams every weight
//     from L2 (phi_sa: 364 KB), at an SM's share of the L2 rate.
//   otherwise (mlp and d2rl past 32 rows with U or M under 128; a
//     densenet stack too wide for whole_stack_kernel's shared memory and
//     narrower than 128): the tile product of dense_tile.cuh with a
//     register prefetch.
//
// The streaming kernel, the whole-stack kernel and dense_tile.cuh's are
// programmatic dependent launches (dense_tile.cuh's launch_pdl; the whole-
// stack kernel's own copy of it passes its dynamic shared memory): each
// may start as the kernel before it finishes its last blocks, and waits
// for its results before it touches memory, so a launch overlaps its
// predecessor's tail. The register tile is launched plainly: its grids of
// two blocks an SM leave a slot free, and blocks launched early into those
// slots spread the next grid unevenly over the SMs (PERF.md).
//
// Every per-layer kernel splits K across gridDim.y where the output alone
// would not fill the card. Split partials go to a workspace; the last
// block of a tile to finish (counted with an integer atomic) sums them in
// fixed split order and runs the epilogue, so the result does not depend
// on the order in which blocks ran, and resets its counter to 0, so the
// wrapper's counters (one zeroed buffer per device and stream) need no
// fill per launch. Plain
// TF32 or bf16 through the tensor cores would miss the 1e-4 agreement with
// the fp32 reference; split-precision TF32 (3xTF32, fused_dense.cu) would
// not, and is the route past this SIMT design (ROADMAP.md B).
//
// A fleet's E members (rl/sweep.py: a vmapped superstep) run each of these
// kernels in ONE launch: the `_members` entry points take the solo
// arguments, the member count and each operand's member stride in elements
// (0 for an operand every member shares, such as a weight a fleet does not
// batch), and launch the solo grid with gridDim.z = E. Member e's blocks
// offset their operands by e times the strides, own the e-th set of split
// partials and tile counters, and run the solo launch's arithmetic:
// member e is bitwise the solo launch on its operands. The member kernels
// are kernels of their own that take the strides as one more argument;
// the solo kernels keep their arguments and code.

#include "dense_tile.cuh"
#include "dense_tile_rt.cuh"

namespace {

using dense_tile::apply_act;
using dense_tile::launch_pdl;
using dense_tile::pdl_trigger;
using dense_tile::pdl_wait;
using dense_tile_rt::aligned16;

// ---- M >= 128: the register tile's epilogue --------------------------------

// z = v + bias (to `z` if given); y = act(z) into the stream's column slot
// (or mlp/d2rl's output; null for their layers below the last, which
// only the next layer reads, from y^T) and, if given, y^T into rows [gn,
// gn + 4) of stream^T (columns gm0 .. gm0 + 3: one float4 a column); 16
// bytes at a time where a destination allows it, masked at the ragged
// edge.
struct FwdEpi {
  const float* bias;
  float* z; long long ldz;
  float* y; long long ldy;
  float* yt; long long ldt;
  int m, n, act;
  bool vz, vy, vt;

  __device__ __forceinline__ void rows(float* dst, long long ld, bool vec,
                                       int gm0, int gn,
                                       const float (&v)[4][4]) const {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gm = gm0 + r;
      if (gm >= m) break;
      float* o = dst + gm * ld + gn;
      if (vec && gn + 3 < n) {
        *reinterpret_cast<float4*>(o) =
            make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < n) o[j] = v[r][j];
      }
    }
  }

  __device__ __forceinline__ void operator()(int gm0, int gn,
                                             float (&v)[4][4]) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float b = gn + j < n ? bias[gn + j] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r][j] += b;
    }
    if (z != nullptr) rows(z, ldz, vz, gm0, gn, v);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[r][j] = apply_act(v[r][j], act);
    if (y != nullptr) rows(y, ldy, vy, gm0, gn, v);
    if (yt == nullptr) return;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (gn + j >= n) break;
      float* t = yt + (gn + j) * ldt + gm0;
      if (vt && gm0 + 3 < m) {
        *reinterpret_cast<float4*>(t) =
            make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (gm0 + r < m) t[r] = v[r][j];
      }
    }
  }
};

// A = stream^T (the wrapper's own, padded: always 16-byte copies), B = W_i
// (16-byte copies where VB); 128x64 tiles only: the forward's outputs at
// the batch of 256 are small, and 128x128 tiles lost at each wide product
// of launch/bwd_sweep.py
constexpr int kRtM = 128, kRtN = 64;

template <bool VB>
__global__ void __launch_bounds__(dense_tile_rt::kThreads, 3)
fwd_tile_kernel(const dense_tile_rt::Args p, const FwdEpi epi) {
  dense_tile_rt::tile_body<kRtM, kRtN, true, VB>(p, epi);
}

// the epilogue's member strides in elements
struct EpiStrides {
  long long bias, z, y, yt;
};

// member blockIdx.z: its operands (s), its epilogue's (es)
template <bool VB>
__global__ void __launch_bounds__(dense_tile_rt::kThreads, 3)
fwd_tile_members(const dense_tile_rt::Args p, const FwdEpi epi,
                 const dense_tile_rt::Strides s, const EpiStrides es) {
  const long long e = blockIdx.z;
  FwdEpi q = epi;
  q.bias += e * es.bias;
  if (q.z != nullptr) q.z += e * es.z;
  if (q.y != nullptr) q.y += e * es.y;
  if (q.yt != nullptr) q.yt += e * es.yt;
  dense_tile_rt::tile_body<kRtM, kRtN, true, VB>(
      dense_tile_rt::at_member(p, s), q);
}

// ---- M <= 32: the weight-streaming kernel ---------------------------------

namespace streaming {

using dense_tile_rt::cp_async16;
using dense_tile_rt::cp_async4;
using dense_tile_rt::cp_async_commit;
using dense_tile_rt::cp_async_wait;

constexpr int kThreads = 256, kWarps = 8;
constexpr int kCols = 128;     // a block's strip: a float4 for each lane
constexpr int kRows = 8;       // W rows of a ring stage: a 16-byte copy a thread
constexpr int kStages = 5;     // ring stages: four in flight while one computes
constexpr int kMaxK = 192;     // K rows of A a block holds (stack.py's
                               // _STREAM_MAX_K)

struct Args {
  const float* a1; long long lda1; int k1;   // A segment 1 (logical k 0..k1)
  const float* a2; long long lda2; int k2;   // A segment 2 (k2 may be 0)
  const float* w; long long ldw;             // (k1 + k2, n) row-major
  const float* b;                            // (n,)
  float* out; long long ldo;
  float* zout; long long ldz;                // pre-activation, or null
  float* acopy; long long ldac;              // A (segment 1) copied here by
                                             // the blocks of strip 0, or
                                             // null: densenet's layer 0
                                             // writes x into the stream
  float* ws;                                 // (splits, m, n rounded up to
                                             // 4), or null
  int* counters;                             // one per strip, all zero
  int m, n, act, splits, rows_per_split;
};

// a member launch's strides in elements (0: shared by every member)
struct Strides {
  long long a1, a2, w, b, out, z, acopy;
};

// the arguments of member blockIdx.z: its operands, its own split partials
// (rows of n rounded up to 4) and its own strip counters
__device__ __forceinline__ Args at_member(Args p, const Strides& s) {
  const long long e = blockIdx.z;
  p.a1 += e * s.a1;
  if (p.a2 != nullptr) p.a2 += e * s.a2;
  p.w += e * s.w;
  p.b += e * s.b;
  p.out += e * s.out;
  if (p.zout != nullptr) p.zout += e * s.z;
  if (p.acopy != nullptr) p.acopy += e * s.acopy;
  if (p.ws != nullptr)
    p.ws += e * p.splits * static_cast<long long>(p.m) * ((p.n + 3) & ~3);
  if (p.counters != nullptr) p.counters += e * gridDim.x;
  return p;
}

// ROWS: M rounded up to a power of two (1..32). A warp owns MR rows (up to
// 8) of one of RG row groups and, in each ring stage, the stage's rows kg,
// kg + KG, .. for its K part kg of KG = 8 / RG. VW: W takes 16-byte copies
// (n and ldw multiples of 4, w 16-byte aligned).
template <int ROWS, bool VW>
__device__ __forceinline__ void stream_run(const Args& p) {
  constexpr int MR = ROWS < 8 ? ROWS : 8;
  constexpr int RG = ROWS / MR, KG = kWarps / RG;
  constexpr int LDA = ROWS < 4 ? ROWS : ROWS + 4;   // 16-byte rows of As
  constexpr int STAGE = kRows * kCols;
  static_assert(STAGE == 4 * kThreads, "a stage is one float4 a thread");
  static_assert(ROWS * kCols <= kStages * STAGE, "red fits in the ring");
  __shared__ __align__(16) float As[kMaxK * LDA];    // As[k][r] = A[r][k]
  __shared__ __align__(16) float Ws[kStages * STAGE];
  float* red = Ws;                          // the block's sum, after the ring
  __shared__ int s_last;

  pdl_wait();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = warp % RG, kg = warp / RG;
  const int strip = blockIdx.x, split = blockIdx.y;
  const int n0 = strip * kCols;
  const int k_total = p.k1 + p.k2;
  const int k_begin = split * p.rows_per_split;
  const int kb = min(k_total, k_begin + p.rows_per_split) - k_begin;
  const int steps = (kb + kRows - 1) / kRows;

  // stage t: rows [t * kRows, (t + 1) * kRows) of the block's K range into
  // ring buffer t % kStages, zero past kb and n; every call commits a group
  auto copy_stage = [&](int t) {
    if (t < steps) {
      float* dst = Ws + (t % kStages) * STAGE + tid * 4;
      const int k = t * kRows + tid / 32, gc = n0 + (tid % 32) * 4;
      const float* src = p.w + (k_begin + k) * p.ldw + gc;
      if constexpr (VW) {
        const bool in = k < kb && gc < p.n;
        cp_async16(dst, in ? src : p.w, in ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = k < kb && gc + j < p.n;
          cp_async4(dst + j, in ? src + j : p.w, in ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
  // A's rows of the range, transposed, zero past m: 4-byte copies, all in
  // flight at once, that join the first stage's group
  for (int e = tid; e < ROWS * kb; e += kThreads) {
    const int r = e / kb, k = e % kb, gk = k_begin + k;
    const float* src = p.w;
    if (r < p.m)
      src = gk < p.k1 ? p.a1 + r * p.lda1 + gk
                      : p.a2 + r * p.lda2 + gk - p.k1;
    cp_async4(&As[k * LDA + r], src, r < p.m ? 4 : 0);
  }
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) copy_stage(t);

  const int r0 = g * MR;
  const bool active = r0 < p.m && n0 + lane * 4 < p.n;
  float acc[MR][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();
    // stage t has landed for every thread (and As, at t = 0), and every
    // thread is done with stage t - 1, whose buffer the copy below refills
    __syncthreads();
    copy_stage(t + kStages - 1);
    if (!active) continue;
    const float* wt = Ws + (t % kStages) * STAGE + lane * 4;
#pragma unroll
    for (int j = 0; j < kRows / KG; ++j) {
      const int kk = kg + j * KG, k = t * kRows + kk;
      if (k >= kb) break;
      const float4 w = *reinterpret_cast<const float4*>(wt + kk * kCols);
      float a[MR];
      if constexpr (MR >= 4) {
#pragma unroll
        for (int q = 0; q < MR / 4; ++q) {
          const float4 v =
              *reinterpret_cast<const float4*>(&As[k * LDA + r0 + 4 * q]);
          a[4 * q] = v.x; a[4 * q + 1] = v.y;
          a[4 * q + 2] = v.z; a[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < MR; ++r) a[r] = As[k * LDA + r0 + r];
      }
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        acc[r][0] = fmaf(a[r], w.x, acc[r][0]);
        acc[r][1] = fmaf(a[r], w.y, acc[r][1]);
        acc[r][2] = fmaf(a[r], w.z, acc[r][2]);
        acc[r][3] = fmaf(a[r], w.w, acc[r][3]);
      }
    }
  }
  cp_async_wait<0>();                       // only empty groups are left
  pdl_trigger();
  if (p.acopy != nullptr && strip == 0) {   // segment 1 of A, from As
    for (int e = tid; e < p.m * kb; e += kThreads) {
      const int r = e / kb, k = e % kb, gk = k_begin + k;
      if (gk < p.k1) p.acopy[r * p.ldac + gk] = As[k * LDA + r];
    }
  }
  __syncthreads();                          // the ring is free for `red`

  // the K parts meet in `red` in fixed order: part 0 stores, 1.. add
  for (int j = 0; j < KG; ++j) {
    if (kg == j) {
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        float4* q =
            reinterpret_cast<float4*>(&red[(r0 + r) * kCols + lane * 4]);
        const float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2],
                                     acc[r][3]);
        if (j == 0) {
          *q = v;
        } else {
          const float4 o = *q;
          *q = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
        }
      }
    }
    __syncthreads();
  }

  // out[r, gn] = act(z + b) (z to zout)
  auto emit = [&](int r, int gn, float z) {
    z += p.b[gn];
    if (p.zout != nullptr) p.zout[r * p.ldz + gn] = z;
    p.out[r * p.ldo + gn] = apply_act(z, p.act);
  };
  if (p.splits == 1) {
    for (int e = tid; e < ROWS * kCols; e += kThreads) {
      const int r = e / kCols, gn = n0 + e % kCols;
      if (r < p.m && gn < p.n) emit(r, gn, red[e]);
    }
    return;
  }
  // split: the block's sum to the workspace, 16 bytes at a time (rows of
  // n rounded up to 4 floats), and the strip's last block adds them up
  constexpr int E4 = ROWS * kCols / 4;      // float4s of the strip
  constexpr int PER = (E4 + kThreads - 1) / kThreads;
  const int ldws = (p.n + 3) & ~3;
  const long long plane = static_cast<long long>(p.m) * ldws;
  auto pos = [&](int q, int& r, int& gn) {  // the thread's q-th float4
    const int e = tid + q * kThreads;
    r = e < E4 ? e / (kCols / 4) : ROWS;
    gn = n0 + (e % (kCols / 4)) * 4;
    return r < p.m && gn < p.n;
  };
  float4* part = reinterpret_cast<float4*>(p.ws + split * plane);
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    int r, gn;
    if (pos(q, r, gn))
      part[(r * ldws + gn) / 4] = *reinterpret_cast<const float4*>(
          &red[r * kCols + gn - n0]);
  }
  __threadfence();                          // partials visible device-wide
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&p.counters[strip], 1) == p.splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: the partials summed in split order, SB splits' loads
  // in flight at once (16 float4s a thread)
  constexpr int SB = 16 / PER;
  float4 sum[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) sum[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  auto add = [](float4& a, const float4& b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  };
  auto load = [&](int s, int q) {
    int r, gn;
    if (!pos(q, r, gn)) return make_float4(0.f, 0.f, 0.f, 0.f);
    return __ldcg(reinterpret_cast<const float4*>(p.ws + s * plane) +
                  (r * ldws + gn) / 4);
  };
  int s = 0;
  for (; s + SB <= p.splits; s += SB) {
    float4 v[SB][PER];
#pragma unroll
    for (int u = 0; u < SB; ++u)
#pragma unroll
      for (int q = 0; q < PER; ++q) v[u][q] = load(s + u, q);
#pragma unroll
    for (int u = 0; u < SB; ++u)
#pragma unroll
      for (int q = 0; q < PER; ++q) add(sum[q], v[u][q]);
  }
  for (; s < p.splits; ++s)
#pragma unroll
    for (int q = 0; q < PER; ++q) add(sum[q], load(s, q));
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    int r, gn;
    if (!pos(q, r, gn)) continue;
    const float v[4] = {sum[q].x, sum[q].y, sum[q].z, sum[q].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gn + j < p.n) emit(r, gn + j, v[j]);
  }
  if (tid == 0) p.counters[strip] = 0;      // leave the counters reusable
}

template <int ROWS, bool VW>
__global__ void __launch_bounds__(kThreads, 2) stream_kernel(const Args p) {
  stream_run<ROWS, VW>(p);
}

template <int ROWS, bool VW>
__global__ void __launch_bounds__(kThreads, 2)
stream_members(const Args p, const Strides s) {
  stream_run<ROWS, VW>(at_member(p, s));
}

// with `s`, one launch of stream_members for `members` members
template <int ROWS>
int launch(bool vec_w, const Args& p, cudaStream_t stream,
           const Strides* s = nullptr, int members = 0) {
  if (s != nullptr) {
    const dim3 grid((p.n + kCols - 1) / kCols, p.splits, members);
    if (vec_w)
      return launch_pdl(stream_members<ROWS, true>, grid, dim3(kThreads),
                        stream, p, *s);
    return launch_pdl(stream_members<ROWS, false>, grid, dim3(kThreads),
                      stream, p, *s);
  }
  const dim3 grid((p.n + kCols - 1) / kCols, p.splits);
  if (vec_w)
    return launch_pdl(stream_kernel<ROWS, true>, grid, dim3(kThreads),
                      stream, p);
  return launch_pdl(stream_kernel<ROWS, false>, grid, dim3(kThreads), stream,
                    p);
}

}  // namespace streaming

// ---- M > 32, narrow densenet (U < 128): the whole stack in one launch -----

namespace whole {

using dense_tile_rt::cp_async16;
using dense_tile_rt::cp_async4;
using dense_tile_rt::cp_async_commit;
using dense_tile_rt::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kChunk = 32;        // W rows of a ring stage
constexpr int kStages = 6;        // ring stages: five in flight, one computing
constexpr int kMaxLayers = 16;    // stack.py's _WHOLE_MAX_LAYERS
constexpr int kMaxSmem = 232448;  // 227 KB, a block's dynamic shared memory

struct Args {
  const float* x; long long ldx;             // (m, d0)
  const float* w[kMaxLayers];                // layer i: (d0 + i*u, u), dense
  const float* b[kMaxLayers];                // (u,)
  float* out; long long ldo;                 // (m, d0 + layers*u): the stream
  float* zs; long long ldz;                  // (m, layers*u), or null
  int m, d0, u, layers, act;
};

// a member launch's strides in elements (0: shared by every member)
struct Strides {
  long long x, out, zs;
  long long w[kMaxLayers], b[kMaxLayers];
};

// bytes of dynamic shared memory at R rows a block and UC columns a ring
// row: the stream's rows transposed (the last layer's output is read by no
// layer: not kept), the ring, the K groups' sums (stack.py's whole_smem)
__host__ __device__ inline int smem_bytes(int rows, int uc, int d0, int u,
                                          int layers) {
  return 4 * ((d0 + (layers - 1) * u) * rows + kStages * kChunk * uc +
              kThreads * rows);
}

// R rows a block (a multiple of 4); UC: U rounded up to 64 or 128, one
// column a thread, kThreads / UC K groups; VW: W takes 16-byte copies; MB:
// member blockIdx.z of a member launch, its operands at the strides `s`
// (not read in a solo launch, whose offsets are 0 and fold away).
template <int R, int UC, bool VW, bool MB>
__device__ __forceinline__ void whole_run(const Args& p, const Strides* s) {
  const long long mem = MB ? static_cast<long long>(blockIdx.z) : 0;
  const float* const x = p.x + (MB ? mem * s->x : 0);
  float* const out = p.out + (MB ? mem * s->out : 0);
  float* const zs =
      MB && p.zs != nullptr ? p.zs + mem * s->zs : p.zs;
  constexpr int KG = kThreads / UC;
  constexpr int STAGE = kChunk * UC;
  static_assert(R % 4 == 0 && STAGE % (4 * kThreads) == 0, "float4 tiles");
  extern __shared__ __align__(16) float smem[];
  const int width = p.d0 + (p.layers - 1) * p.u;
  float* const S = smem;                    // S[k * R + r] = stream[row0+r][k]
  float* const ring = S + width * R;        // ring[slot][kk * UC + c]
  float* const red = ring + kStages * STAGE;  // red[(kg * R + r) * UC + c]

  pdl_wait();
  const int tid = threadIdx.x, c = tid % UC, kg = tid / UC;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, p.m - row0);

  // the rows of every layer's W, layer after layer, in chunks of kChunk
  // rows that never straddle a layer: the copy cursor is layer cl from row
  // ck, into ring stage cs; every call commits one group (empty at the end)
  int cl = 0, ck = 0, cs = 0;
  auto copy_next = [&]() {
    if (cl < p.layers) {
      const int k_l = p.d0 + cl * p.u;
      const int kb = min(kChunk, k_l - ck);
      const float* w = p.w[cl] + (MB ? mem * s->w[cl] : 0) +
                       static_cast<long long>(ck) * p.u;
      float* dst = ring + cs * STAGE;
      if constexpr (VW) {
#pragma unroll
        for (int j = 0; j < STAGE / 4 / kThreads; ++j) {
          const int e = tid + j * kThreads;
          const int kk = e / (UC / 4), col = (e % (UC / 4)) * 4;
          const bool in = kk < kb && col < p.u;
          cp_async16(dst + kk * UC + col, in ? w + kk * p.u + col : x,
                     in ? 16 : 0);
        }
      } else {
#pragma unroll
        for (int j = 0; j < STAGE / kThreads; ++j) {
          const int e = tid + j * kThreads;
          const int kk = e / UC, col = e % UC;
          const bool in = kk < kb && col < p.u;
          cp_async4(dst + kk * UC + col, in ? w + kk * p.u + col : x,
                    in ? 4 : 0);
        }
      }
      ck += kChunk;
      if (ck >= k_l) {
        ck = 0;
        ++cl;
      }
    }
    cp_async_commit();
    cs = cs + 1 == kStages ? 0 : cs + 1;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) copy_next();

  // x: into the stream tile (zero past the last row) and the output's
  // first columns, while the first chunks are in flight
  for (int e = tid; e < R * p.d0; e += kThreads) {
    const int r = e / p.d0, k = e % p.d0;
    float v = 0.f;
    if (r < rows) {
      v = x[(row0 + r) * p.ldx + k];
      out[(row0 + r) * p.ldo + k] = v;
    }
    S[k * R + r] = v;
  }

  int slot = 0;                             // the ring stage computed next
  for (int i = 0; i < p.layers; ++i) {
    const int k_i = p.d0 + i * p.u;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 < k_i; k0 += kChunk) {
      cp_async_wait<kStages - 2>();
      // this chunk has landed for every thread, every thread is done with
      // the last one (whose stage the copy below refills), and at a layer's
      // first chunk the stream tile holds the layer before's output
      __syncthreads();
      copy_next();
      const float* wt = ring + slot * STAGE + c;
      const float* st = S + k0 * R;
      slot = slot + 1 == kStages ? 0 : slot + 1;
      // rows kk = kg + j * KG of the chunk: all loads first, then the FMAs
      // (a whole chunk unrolled; a layer's last, partial one row by row)
      auto row = [&](int kk, float wv) {
        const float4* a = reinterpret_cast<const float4*>(st + kk * R);
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
          const float4 v = a[q];            // a broadcast: one k a warp
          acc[4 * q] = fmaf(v.x, wv, acc[4 * q]);
          acc[4 * q + 1] = fmaf(v.y, wv, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, wv, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, wv, acc[4 * q + 3]);
        }
      };
      const int kb = min(kChunk, k_i - k0);
      if (kb == kChunk) {
        float wv[kChunk / KG];
#pragma unroll
        for (int j = 0; j < kChunk / KG; ++j) wv[j] = wt[(kg + j * KG) * UC];
#pragma unroll
        for (int j = 0; j < kChunk / KG; ++j) row(kg + j * KG, wv[j]);
      } else {
        for (int kk = kg; kk < kb; kk += KG) row(kk, wt[kk * UC]);
      }
    }
    if (i + 1 == p.layers) pdl_trigger();
    // the K groups' sums meet in fixed order; z = sum + b, y = act(z) into
    // the stream tile (layers below the last), the output and zs
#pragma unroll
    for (int r = 0; r < R; ++r) red[(kg * R + r) * UC + c] = acc[r];
    __syncthreads();
    const float* bias = p.b[i] + (MB ? mem * s->b[i] : 0);
    for (int e = tid; e < R * UC; e += kThreads) {
      const int r = e / UC, cc = e % UC;
      if (cc >= p.u) continue;
      float z = red[r * UC + cc];
#pragma unroll
      for (int q = 1; q < KG; ++q) z += red[(q * R + r) * UC + cc];
      z += bias[cc];
      const float y = apply_act(z, p.act);
      if (i + 1 < p.layers) S[(k_i + cc) * R + r] = y;
      if (r < rows) {
        if (zs != nullptr) zs[(row0 + r) * p.ldz + i * p.u + cc] = z;
        out[(row0 + r) * p.ldo + k_i + cc] = y;
      }
    }
    // no barrier here: the next layer's first chunk begins with one, and
    // `red` is written next after it
  }
  cp_async_wait<0>();                       // only empty groups are left
}

template <int R, int UC, bool VW>
__global__ void __launch_bounds__(kThreads)
whole_stack_kernel(const __grid_constant__ Args p) {
  whole_run<R, UC, VW, false>(p, nullptr);
}

template <int R, int UC, bool VW>
__global__ void __launch_bounds__(kThreads)
whole_stack_members(const __grid_constant__ Args p,
                    const __grid_constant__ Strides s) {
  whole_run<R, UC, VW, true>(p, &s);
}

// a programmatic dependent launch, as dense_tile.cuh's launch_pdl, with
// dynamic shared memory; `args` the kernel's
template <typename... Params, typename... A>
int launch_smem(void (*kernel)(Params...), dim3 grid, int smem,
                cudaStream_t stream, const A&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  cudaGetLastError();                       // returned here, not kept
  return static_cast<int>(err);
}

// with `s`, one launch of whole_stack_members for `members` members
template <int R, int UC, bool VW>
int launch(const Args& p, int smem, cudaStream_t stream,
           const Strides* s = nullptr, int members = 0) {
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      whole_stack_kernel<R, UC, VW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (s == nullptr)
    return launch_smem(whole_stack_kernel<R, UC, VW>,
                       dim3((p.m + R - 1) / R), smem, stream, p);
  static const cudaError_t attr_m = cudaFuncSetAttribute(
      whole_stack_members<R, UC, VW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr_m != cudaSuccess) return static_cast<int>(attr_m);
  return launch_smem(whole_stack_members<R, UC, VW>,
                     dim3((p.m + R - 1) / R, 1, members), smem, stream, p,
                     *s);
}

template <int R>
int launch_rows(bool vw, int uc, const Args& p, int smem,
                cudaStream_t stream, const Strides* s, int members) {
  if (uc == 64)
    return vw ? launch<R, 64, true>(p, smem, stream, s, members)
              : launch<R, 64, false>(p, smem, stream, s, members);
  return vw ? launch<R, 128, true>(p, smem, stream, s, members)
            : launch<R, 128, false>(p, smem, stream, s, members);
}

}  // namespace whole

}  // namespace

namespace {

// The entry points' bodies: `members` = 0 for a solo launch, else the
// member count of one member launch, each operand's member stride in
// elements beside it (16-byte copies need it a multiple of 4).

bool member_aligned(const void* p, long long ld, long long s) {
  return aligned16(p, ld) && (s & 3) == 0;
}

int layer_fwd(int config, const float* a1, long long lda1, int k1,
              const float* a2, long long lda2, int k2, const float* w,
              const float* b, float* out, long long ldo, float* zout,
              long long ldz, float* ws, int* counters, int m, int n, int act,
              int splits, int chunks_per_split, int members,
              const dense_tile::TileStrides& s, void* stream) {
  const dense_tile::TileArgs p{a1, lda1, k1, a2, lda2, k2, w, n, b, out,
                               ldo, zout, ldz, ws, counters, m, n, act,
                               0, splits, chunks_per_split};
  if (config != 2 || b == nullptr || !dense_tile::args_ok(p))
    return static_cast<int>(cudaErrorInvalidValue);
  return dense_tile::launch<64, 64, 16, 4, 4, false, false>(
      p, static_cast<cudaStream_t>(stream), /*pdl=*/true,
      members > 0 ? &s : nullptr, members);
}

int layer_fwd_rt(int config, int vec_w, const float* at, long long ldat,
                 const float* w, long long ldw, const float* b, float* y,
                 long long ldy, float* zout, long long ldz, float* yt,
                 long long ldt, float* ws, int* counters, int m, int n, int k,
                 int act, int splits, int chunks_per_split, int members,
                 const dense_tile_rt::Strides& s, const EpiStrides& es,
                 void* stream) {
  const dense_tile_rt::Args p{at, ldat, w, ldw, nullptr, 0, nullptr, 0,
                              ws, counters, m, n, k, splits,
                              chunks_per_split};
  const int vec = 1 | (vec_w ? 2 : 0);
  if (config != 4 || !dense_tile_rt::args_ok(p, vec) ||
      !dense_tile_rt::strides_ok(s, vec) || b == nullptr ||
      (y == nullptr && yt == nullptr) ||
      act < dense_tile::kIdentity || act > dense_tile::kSwish ||
      (yt != nullptr && !member_aligned(yt, ldt, es.yt)))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdEpi epi{b, zout, ldz, y, ldy, yt, ldt, m, n, act,
                   zout != nullptr && member_aligned(zout, ldz, es.z),
                   y != nullptr && member_aligned(y, ldy, es.y),
                   yt != nullptr};
  const dim3 grid(((m + kRtM - 1) / kRtM) * ((n + kRtN - 1) / kRtN), splits,
                  members > 0 ? members : 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = dense_tile_rt::kThreads;
  if (members > 0 && vec_w != 0)
    fwd_tile_members<true><<<grid, threads, 0, st>>>(p, epi, s, es);
  else if (members > 0)
    fwd_tile_members<false><<<grid, threads, 0, st>>>(p, epi, s, es);
  else if (vec_w != 0)
    fwd_tile_kernel<true><<<grid, threads, 0, st>>>(p, epi);
  else
    fwd_tile_kernel<false><<<grid, threads, 0, st>>>(p, epi);
  return static_cast<int>(cudaGetLastError());
}

int layer_fwd_stream(int vec_w, const float* a1, long long lda1, int k1,
                     const float* a2, long long lda2, int k2, const float* w,
                     long long ldw, const float* b, float* out, long long ldo,
                     float* zout, long long ldz, float* acopy, long long ldac,
                     float* ws, int* counters, int m, int n, int act,
                     int splits, int rows_per_split, int members,
                     const streaming::Strides& s, void* stream) {
  const int k = k1 + k2;
  if (m <= 0 || m > 32 || n <= 0 || k1 <= 0 || k2 < 0 || b == nullptr ||
      splits < 1 || rows_per_split < 1 ||
      rows_per_split > streaming::kMaxK ||
      (splits - 1) * rows_per_split >= k || splits * rows_per_split < k ||
      act < dense_tile::kIdentity || act > dense_tile::kSwish ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      (vec_w && ((n & 3) != 0 || !member_aligned(w, ldw, s.w))))
    return static_cast<int>(cudaErrorInvalidValue);
  const streaming::Args p{a1, lda1, k1, a2, lda2, k2, w, ldw, b, out, ldo,
                          zout, ldz, acopy, ldac, ws, counters, m, n, act,
                          splits, rows_per_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v = vec_w != 0;
  const streaming::Strides* ms = members > 0 ? &s : nullptr;
  if (m <= 1) return streaming::launch<1>(v, p, st, ms, members);
  if (m <= 2) return streaming::launch<2>(v, p, st, ms, members);
  if (m <= 4) return streaming::launch<4>(v, p, st, ms, members);
  if (m <= 8) return streaming::launch<8>(v, p, st, ms, members);
  if (m <= 16) return streaming::launch<16>(v, p, st, ms, members);
  return streaming::launch<32>(v, p, st, ms, members);
}

int stack_fwd_whole(int rows, int vec_w, const float* x, long long ldx,
                    int layers, const long long* w_ptrs,
                    const long long* b_ptrs, int d0, int u, float* out,
                    long long ldo, float* zs, long long ldz, int m, int act,
                    int members, const whole::Strides& s, void* stream) {
  if (m <= 0 || d0 <= 0 || u <= 0 || u > 128 || layers < 1 ||
      layers > whole::kMaxLayers || x == nullptr || out == nullptr ||
      ldx < d0 || ldo < d0 + layers * u ||
      (zs != nullptr && ldz < layers * u) || act < dense_tile::kIdentity ||
      act > dense_tile::kSwish || (vec_w && (u & 3) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int uc = u <= 64 ? 64 : 128;
  const int smem = whole::smem_bytes(rows, uc, d0, u, layers);
  if (smem > whole::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  whole::Args p{};
  p.x = x;
  p.ldx = ldx;
  for (int i = 0; i < layers; ++i) {
    p.w[i] = reinterpret_cast<const float*>(w_ptrs[i]);
    p.b[i] = reinterpret_cast<const float*>(b_ptrs[i]);
    if (p.w[i] == nullptr || p.b[i] == nullptr ||
        (vec_w && !member_aligned(p.w[i], u, s.w[i])))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.out = out;
  p.ldo = ldo;
  p.zs = zs;
  p.ldz = ldz;
  p.m = m;
  p.d0 = d0;
  p.u = u;
  p.layers = layers;
  p.act = act;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v = vec_w != 0;
  const whole::Strides* ms = members > 0 ? &s : nullptr;
  switch (rows) {
    case 4: return whole::launch_rows<4>(v, uc, p, smem, st, ms, members);
    case 8: return whole::launch_rows<8>(v, uc, p, smem, st, ms, members);
    case 16: return whole::launch_rows<16>(v, uc, p, smem, st, ms, members);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dense_tile.cuh's tile, config 2 (64x64; the forward plans it only past
// 32 rows): out[:, :n] = act([a1 | a2] @ w + b). Returns the CUDA error of
// the launch (0 on success). `zout` (row stride `ldz`) receives the
// pre-activation, or is null.
extern "C" int dense_layer_fwd(int config, const float* a1, long long lda1,
                               int k1, const float* a2, long long lda2, int k2,
                               const float* w, const float* b, float* out,
                               long long ldo, float* zout, long long ldz,
                               float* ws, int* counters, int m, int n,
                               int act, int splits, int chunks_per_split,
                               void* stream) {
  return layer_fwd(config, a1, lda1, k1, a2, lda2, k2, w, b, out, ldo, zout,
                   ldz, ws, counters, m, n, act, splits, chunks_per_split, 0,
                   {}, stream);
}

// dense_layer_fwd for `members` members in one launch; sa1 .. sz: the
// member strides of a1, a2, w, b, out, zout. ws: (members, splits, m, n);
// counters: members x tiles.
extern "C" int dense_layer_fwd_members(
    int config, const float* a1, long long lda1, int k1, const float* a2,
    long long lda2, int k2, const float* w, const float* b, float* out,
    long long ldo, float* zout, long long ldz, float* ws, int* counters,
    int m, int n, int act, int splits, int chunks_per_split, int members,
    long long sa1, long long sa2, long long sw, long long sb, long long so,
    long long sz, void* stream) {
  if (members < 1) return static_cast<int>(cudaErrorInvalidValue);
  return layer_fwd(config, a1, lda1, k1, a2, lda2, k2, w, b, out, ldo, zout,
                   ldz, ws, counters, m, n, act, splits, chunks_per_split,
                   members, {sa1, sa2, sw, sb, so, sz}, stream);
}

// The register tile (config 4, 128x64): y (m, n) = act(at^T @ w + b) over
// k rows of at (k, m; 16-byte aligned rows) and w (k, n); zout receives z
// or is null; yt (n rows of stride ldt, 16-byte aligned rows) receives y^T
// or is null. `vec_w`: w takes 16-byte copies. ws: (splits, m, n rounded
// up to 4).
extern "C" int dense_layer_fwd_rt(int config, int vec_w, const float* at,
                                  long long ldat, const float* w,
                                  long long ldw, const float* b, float* y,
                                  long long ldy, float* zout, long long ldz,
                                  float* yt, long long ldt, float* ws,
                                  int* counters, int m, int n, int k,
                                  int act, int splits, int chunks_per_split,
                                  void* stream) {
  return layer_fwd_rt(config, vec_w, at, ldat, w, ldw, b, y, ldy, zout, ldz,
                      yt, ldt, ws, counters, m, n, k, act, splits,
                      chunks_per_split, 0, {}, {}, stream);
}

// dense_layer_fwd_rt for `members` members in one launch; sat .. syt: the
// member strides of at, w, b, y, zout, yt (at's and yt's multiples of 4).
// ws: (members, splits, m, n rounded up to 4); counters: members x tiles.
extern "C" int dense_layer_fwd_rt_members(
    int config, int vec_w, const float* at, long long ldat, const float* w,
    long long ldw, const float* b, float* y, long long ldy, float* zout,
    long long ldz, float* yt, long long ldt, float* ws, int* counters, int m,
    int n, int k, int act, int splits, int chunks_per_split, int members,
    long long sat, long long sw, long long sb, long long sy, long long sz,
    long long syt, void* stream) {
  if (members < 1) return static_cast<int>(cudaErrorInvalidValue);
  return layer_fwd_rt(config, vec_w, at, ldat, w, ldw, b, y, ldy, zout, ldz,
                      yt, ldt, ws, counters, m, n, k, act, splits,
                      chunks_per_split, members, {sat, sw, 0, 0},
                      {sb, sz, sy, syt}, stream);
}

// The weight-streaming kernel (config 5), m <= 32: out[:, :n] = act([a1 |
// a2] @ w + b), K split in parts of rows_per_split <= 192 rows; `vec_w`:
// w takes 16-byte copies (w 16-byte aligned, n and ldw multiples of 4).
// acopy (row stride ldac) receives a1's k1 columns, or is null. ws:
// (splits, m, n rounded up to 4); counters: one per 128-column strip.
extern "C" int dense_layer_fwd_stream(int vec_w, const float* a1,
                                      long long lda1, int k1,
                                      const float* a2, long long lda2,
                                      int k2, const float* w, long long ldw,
                                      const float* b, float* out,
                                      long long ldo, float* zout,
                                      long long ldz, float* acopy,
                                      long long ldac, float* ws,
                                      int* counters, int m, int n, int act,
                                      int splits, int rows_per_split,
                                      void* stream) {
  return layer_fwd_stream(vec_w, a1, lda1, k1, a2, lda2, k2, w, ldw, b, out,
                          ldo, zout, ldz, acopy, ldac, ws, counters, m, n,
                          act, splits, rows_per_split, 0, {}, stream);
}

// dense_layer_fwd_stream for `members` members in one launch; sa1 .. sac:
// the member strides of a1, a2, w (a multiple of 4 with vec_w), b, out,
// zout, acopy. ws: (members, splits, m, n rounded up to 4); counters:
// members x strips.
extern "C" int dense_layer_fwd_stream_members(
    int vec_w, const float* a1, long long lda1, int k1, const float* a2,
    long long lda2, int k2, const float* w, long long ldw, const float* b,
    float* out, long long ldo, float* zout, long long ldz, float* acopy,
    long long ldac, float* ws, int* counters, int m, int n, int act,
    int splits, int rows_per_split, int members, long long sa1,
    long long sa2, long long sw, long long sb, long long so, long long sz,
    long long sac, void* stream) {
  if (members < 1) return static_cast<int>(cudaErrorInvalidValue);
  return layer_fwd_stream(vec_w, a1, lda1, k1, a2, lda2, k2, w, ldw, b, out,
                          ldo, zout, ldz, acopy, ldac, ws, counters, m, n,
                          act, splits, rows_per_split, members,
                          {sa1, sa2, sw, sb, so, sz, sac}, stream);
}

// dst_t (cols, rows) = src^T before the register tile's first layer, and:
// densenet, dst (rows, cols) = src (x into the stream and stream^T); mlp,
// dst null (x^T alone); d2rl, dst null and a second copy of x^T `dup`
// elements past dst_t (one in each ping-pong buffer), else dup = 0.
extern "C" int dense_fwd_stream_init(const float* src, long long lds,
                                     float* dst, long long ldd, float* dst_t,
                                     long long ldt, long long dup, int rows,
                                     int cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dst == nullptr)
    return dense_tile::launch_xt(src, lds, dst_t, ldt, dup, rows, cols, st);
  if (dup != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dense_tile::launch_transpose(src, lds, dst_t, ldt, dst, ldd, rows,
                                      cols, st);
}

// dense_fwd_stream_init for `members` members in one launch; ss, sd, st:
// the member strides of src, dst and dst_t.
extern "C" int dense_fwd_stream_init_members(
    const float* src, long long lds, float* dst, long long ldd, float* dst_t,
    long long ldt, long long dup, int rows, int cols, int members,
    long long ss, long long sd, long long st, void* stream) {
  if (members < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dst == nullptr)
    return dense_tile::launch_xt(src, lds, dst_t, ldt, dup, rows, cols, s,
                                 members, ss, st);
  if (dup != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dense_tile::launch_transpose(src, lds, dst_t, ldt, dst, ldd, rows,
                                      cols, s, members, ss, st, sd);
}

// The whole narrow densenet stack (U <= 128, up to 16 layers) in one
// launch of `rows` (4, 8 or 16) rows a block: out (m, d0 + layers*u) =
// [x | y_0 | ...], y_i = act(z_i), z_i = out[:, :d0 + i*u] @ w_i + b_i, z_i
// into zs[:, i*u:(i+1)*u] when zs is given. w_ptrs, b_ptrs: host arrays of
// `layers` device pointers, each w_i dense (d0 + i*u, u); `vec_w`: every w_i
// takes 16-byte copies (16-byte aligned, u a multiple of 4).
extern "C" int dense_stack_fwd_whole(int rows, int vec_w, const float* x,
                                     long long ldx, int layers,
                                     const long long* w_ptrs,
                                     const long long* b_ptrs, int d0, int u,
                                     float* out, long long ldo, float* zs,
                                     long long ldz, int m, int act,
                                     void* stream) {
  return stack_fwd_whole(rows, vec_w, x, ldx, layers, w_ptrs, b_ptrs, d0, u,
                         out, ldo, zs, ldz, m, act, 0, whole::Strides{},
                         stream);
}

// dense_stack_fwd_whole for `members` members in one launch; sx, so, sz:
// the member strides of x, out and zs; w_strides, b_strides: host arrays
// of each layer's member strides (w_i's a multiple of 4 with vec_w).
extern "C" int dense_stack_fwd_whole_members(
    int rows, int vec_w, const float* x, long long ldx, int layers,
    const long long* w_ptrs, const long long* b_ptrs, int d0, int u,
    float* out, long long ldo, float* zs, long long ldz, int m, int act,
    int members, long long sx, const long long* w_strides,
    const long long* b_strides, long long so, long long sz, void* stream) {
  if (members < 1 || layers < 1 || layers > whole::kMaxLayers ||
      w_strides == nullptr || b_strides == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  whole::Strides s{};
  s.x = sx;
  s.out = so;
  s.zs = sz;
  for (int i = 0; i < layers; ++i) {
    s.w[i] = w_strides[i];
    s.b[i] = b_strides[i];
  }
  return stack_fwd_whole(rows, vec_w, x, ldx, layers, w_ptrs, b_ptrs, d0, u,
                         out, ldo, zs, ldz, m, act, members, s, stream);
}
