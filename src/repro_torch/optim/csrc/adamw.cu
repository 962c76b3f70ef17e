// AdamW of the port (repro_torch.optim.adamw), for Hopper (sm_90a): one
// pass over every leaf of an adamw_update call, and over every member of a
// fleet (a vmapped call's stacked (E, ...) leaves), in one launch.
//
// It replaces no TPU kernel: the reference's AdamW (src/repro/optim/
// adamw.py) is plain jnp. On the card the port issued it as about a dozen
// torch._foreach_* passes over the leaves, and under torch.func.vmap (a
// fleet) as about ten elementwise launches a leaf; each pass read and
// wrote whole leaves again. This kernel reads p, g, mu and nu once and
// writes p', mu' and nu' once: 28 bytes an element, the least the update
// can move, so HBM bandwidth bounds it.
//
// Arithmetic: adamw_update_ref's float32 operations in its order, each
// rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn, so
// nvcc cannot contract two of them to an FMA):
//   g  = g * scale                         (global-norm clipping, if on)
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * (g * g)
//   s  = lr * (m' / bc1) / (sqrt(v' / bc2) + eps)
//   s  = s + (lr * wd) * p                 (weight decay, if on)
//   p' = p - s
// with the bias corrections of _step_terms, from each member's int32 step
// count on the card:
//   c   = float(count + 1)                 (count' = count + 1 written)
//   bc1 = 1 - powf(b1, c),  bc2 = 1 - powf(b2, c)
// as torch.pow(b1, c) computes them (powf of the float-cast base; the
// card tests hold them bitwise over counts up to 2^24 and past it). So
// an update reads nothing the host computed per step, syncs with nothing,
// and a captured graph replays with an advancing count. The clip scale and
// a scheduled lr are device scalars, one a member, the caller computed
// (nothing of the port sets either); a constant lr, b1, 1 - b1, b2, 1 - b2,
// eps and lr * wd are the host's doubles cast to float, as PyTorch casts a
// Python scalar. The result is bitwise the foreach and the per-leaf
// versions.
//
// Work split: a leaf's member is cut into chunks of kChunk elements; the
// leaves' (leaf, member, chunk) triples are numbered through, and blocks
// take chunks in a grid-stride loop over a grid of a few blocks an SM,
// sized so each block takes the same number of chunks (within one). The
// table of leaves (pointers, elements a member, chunks a member, first
// chunk) is the kernel's by-value parameter, as PyTorch's multi-tensor
// apply passes its table, so a captured launch keeps it; a call with more
// than kMaxLeaves leaves takes a launch per kMaxLeaves. A chunk whose
// seven pointers are 16-byte aligned moves float4s (a whole chunk kUnroll
// of them a thread, all loads issued before the math), with a scalar tail;
// any other chunk moves floats. Loads are evict-first (__ldcs): nothing
// is read twice.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// the launch shape: the best of a card sweep over threads (128-512), float4s
// a thread a chunk (1-4) and blocks an SM (2-8), and evict-first stores,
// which lost (PERF.md, section 6); 8 blocks of 256 threads an SM took 7-9% off
// 4 at the benchmark's call sets
constexpr int kThreads = 256;
constexpr int kUnroll = 2;
constexpr int kChunk = kThreads * 4 * kUnroll;   // elements
constexpr int kMaxLeaves = 40;                   // 72 bytes each
constexpr int kBlocksPerSm = 8;

struct Leaf {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  float* po;
  float* mo;
  float* vo;
  long long n;       // elements a member
  int chunks;        // chunks a member
  int first;         // the leaf's first chunk in the launch
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int leaves;
  int chunks;        // all leaves' and members'
};

struct Terms {
  const int* count;    // a member each: the state's step count
  int* count_out;      // a member each: count + 1 (the first launch's)
  const float* lr;     // a member each, or null: lr_host
  const float* scale;  // a member each, or null: no clipping
  float lr_host;
  float b1, omb1, b2, omb2, eps;
  float lrwd_host;     // lr * wd, used with lr_host
  float wd;            // used with a device lr
  int decay;           // weight decay on
  int clip;            // scale given
};

struct Member {
  float scale, bc1, bc2, lr, lrwd;
};

__device__ __forceinline__ void update(const Terms& t, const Member& e,
                                       float p, float g, float m, float v,
                                       float& po, float& mo, float& vo) {
  if (t.clip) g = __fmul_rn(g, e.scale);
  m = __fadd_rn(__fmul_rn(m, t.b1), __fmul_rn(g, t.omb1));
  v = __fadd_rn(__fmul_rn(v, t.b2), __fmul_rn(__fmul_rn(g, g), t.omb2));
  float s = __fdiv_rn(__fmul_rn(__fdiv_rn(m, e.bc1), e.lr),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, e.bc2)), t.eps));
  if (t.decay) s = __fadd_rn(s, __fmul_rn(p, e.lrwd));
  po = __fsub_rn(p, s);
  mo = m;
  vo = v;
}

__device__ __forceinline__ void update4(const Terms& t, const Member& e,
                                        float4 p, float4 g, float4 m,
                                        float4 v, float4& po, float4& mo,
                                        float4& vo) {
  update(t, e, p.x, g.x, m.x, v.x, po.x, mo.x, vo.x);
  update(t, e, p.y, g.y, m.y, v.y, po.y, mo.y, vo.y);
  update(t, e, p.z, g.z, m.z, v.z, po.z, mo.z, vo.z);
  update(t, e, p.w, g.w, m.w, v.w, po.w, mo.w, vo.w);
}

__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const Table table, const Terms terms, int members) {
  if (blockIdx.x == 0 && terms.count_out != nullptr) {
    for (int e = threadIdx.x; e < members; e += kThreads)
      terms.count_out[e] = terms.count[e] + 1;
  }
  for (int c = blockIdx.x; c < table.chunks; c += gridDim.x) {
    // the leaf: the last whose first chunk is at or before c (a leaf of
    // no elements shares its first chunk with the next one)
    int lo = 0, hi = table.leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table.leaf[mid].first <= c) lo = mid; else hi = mid - 1;
    }
    const Leaf& L = table.leaf[lo];
    const int k = c - L.first;
    const int e = k / L.chunks;
    const long long at = static_cast<long long>(k - e * L.chunks) * kChunk;
    const long long base = e * L.n + at;
    const int len = static_cast<int>(L.n - at < kChunk ? L.n - at : kChunk);

    Member mem;
    mem.scale = terms.clip ? terms.scale[e] : 1.0f;
    const float step = static_cast<float>(terms.count[e] + 1);
    mem.bc1 = __fsub_rn(1.0f, powf(terms.b1, step));
    mem.bc2 = __fsub_rn(1.0f, powf(terms.b2, step));
    if (terms.lr != nullptr) {
      mem.lr = terms.lr[e];
      mem.lrwd = __fmul_rn(mem.lr, terms.wd);
    } else {
      mem.lr = terms.lr_host;
      mem.lrwd = terms.lrwd_host;
    }
    const float* p = L.p + base;
    const float* g = L.g + base;
    const float* m = L.m + base;
    const float* v = L.v + base;
    float* po = L.po + base;
    float* mo = L.mo + base;
    float* vo = L.vo + base;
    const uintptr_t bits =
        reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v) |
        reinterpret_cast<uintptr_t>(po) | reinterpret_cast<uintptr_t>(mo) |
        reinterpret_cast<uintptr_t>(vo);
    const bool vec = (bits & 15) == 0;
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* m4 = reinterpret_cast<const float4*>(m);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    float4* po4 = reinterpret_cast<float4*>(po);
    float4* mo4 = reinterpret_cast<float4*>(mo);
    float4* vo4 = reinterpret_cast<float4*>(vo);

    if (vec && len == kChunk) {
      float4 rp[kUnroll], rg[kUnroll], rm[kUnroll], rv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = threadIdx.x + u * kThreads;
        rp[u] = __ldcs(p4 + i);
        rg[u] = __ldcs(g4 + i);
        rm[u] = __ldcs(m4 + i);
        rv[u] = __ldcs(v4 + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = threadIdx.x + u * kThreads;
        float4 a, b, d;
        update4(terms, mem, rp[u], rg[u], rm[u], rv[u], a, b, d);
        po4[i] = a;
        mo4[i] = b;
        vo4[i] = d;
      }
      continue;
    }
    int done = 0;
    if (vec) {
      const int nv = len >> 2;
      for (int i = threadIdx.x; i < nv; i += kThreads) {
        float4 a, b, d;
        update4(terms, mem, __ldcs(p4 + i), __ldcs(g4 + i), __ldcs(m4 + i),
                __ldcs(v4 + i), a, b, d);
        po4[i] = a;
        mo4[i] = b;
        vo4[i] = d;
      }
      done = nv << 2;
    }
    for (int i = done + threadIdx.x; i < len; i += kThreads) {
      update(terms, mem, __ldcs(p + i), __ldcs(g + i), __ldcs(m + i),
             __ldcs(v + i), po[i], mo[i], vo[i]);
    }
  }
}

}  // namespace

// One AdamW step over `n_leaves` leaves of `members` members each. `leaves`
// holds 8 int64 a leaf: the addresses of p, g, mu, nu (read) and p', mu',
// nu' (written; none aliases an input) and the leaf's elements a member;
// member e of a leaf starts at element e * n. `count` holds each member's
// int32 step count and `count_out` gets count + 1; the optional `lr_dev`
// and `scale` hold a float a member. All on the card. Launches on
// `stream`, once per kMaxLeaves leaves (once for none), a grid of at most
// kBlocksPerSm blocks for each of `sms` SMs. Returns the number of
// launches, or the CUDA error of the first that failed, negated.
extern "C" int adamw_step(const long long* leaves, int n_leaves, int members,
                          const int* count, int* count_out,
                          const float* lr_dev, const float* scale, float lr,
                          float b1, float omb1, float b2, float omb2,
                          float eps, float lrwd, float wd, int decay, int sms,
                          void* stream) {
  if (n_leaves < 0 || members < 1 || sms < 1 || count == nullptr ||
      count_out == nullptr)
    return -static_cast<int>(cudaErrorInvalidValue);
  Terms terms;
  terms.count = count;
  terms.count_out = count_out;
  terms.lr = lr_dev;
  terms.scale = scale;
  terms.lr_host = lr;
  terms.b1 = b1;
  terms.omb1 = omb1;
  terms.b2 = b2;
  terms.omb2 = omb2;
  terms.eps = eps;
  terms.lrwd_host = lrwd;
  terms.wd = wd;
  terms.decay = decay != 0;
  terms.clip = scale != nullptr;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  int launches = 0;
  for (int start = 0; start == 0 || start < n_leaves; start += kMaxLeaves) {
    Table table;
    table.leaves = n_leaves - start < kMaxLeaves ? n_leaves - start
                                                 : kMaxLeaves;
    long long total = 0;
    for (int i = 0; i < table.leaves; ++i) {
      const long long* a = leaves + 8 * static_cast<long long>(start + i);
      Leaf& L = table.leaf[i];
      L.p = reinterpret_cast<const float*>(a[0]);
      L.g = reinterpret_cast<const float*>(a[1]);
      L.m = reinterpret_cast<const float*>(a[2]);
      L.v = reinterpret_cast<const float*>(a[3]);
      L.po = reinterpret_cast<float*>(a[4]);
      L.mo = reinterpret_cast<float*>(a[5]);
      L.vo = reinterpret_cast<float*>(a[6]);
      L.n = a[7];
      if (L.n < 0) return -static_cast<int>(cudaErrorInvalidValue);
      const long long chunks = (L.n + kChunk - 1) / kChunk;
      L.chunks = static_cast<int>(chunks);
      L.first = static_cast<int>(total);
      total += chunks * members;
      if (total > 0x7fffffffLL)
        return -static_cast<int>(cudaErrorInvalidValue);
    }
    table.chunks = static_cast<int>(total);
    // as few blocks as take the chunks in the same number of rounds
    const long long rounds = (total + cap - 1) / cap;
    const int grid =
        total == 0 ? 1 : static_cast<int>((total + rounds - 1) / rounds);
    adamw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        table, terms, members);
    terms.count_out = nullptr;         // written once, by the first launch
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return -static_cast<int>(err);
    ++launches;
  }
  return launches;
}
