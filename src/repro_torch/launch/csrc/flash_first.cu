// The port's first flash attention kernel, kept as the card sweep's control
// for kernels/flash_attention/csrc/flash_attention.cu (launch/bwd_sweep.py
// --only flash times both side by side): a block of 8 warps a (batch, head,
// 64-row query tile), 64-key tiles staged in shared memory as fp32 by
// synchronous loads behind two barriers a tile, scores and P.V as plain
// fp32 FMAs from shared memory (no tensor cores), one key per lane. Same
// function, arguments and results as flash_attention.cu's entry (within
// the fp32 rounding of the sums): causal, window, softcap, GQA through
// strides, masked keys at -1e30, keys past Skv at -inf, rows with no valid
// key the mean of v. Sm_90a.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int BQ = 64, BKV = 64;
constexpr int kRows = BQ / kWarps;         // query rows per warp
constexpr float kNegInf = -1e30f;          // the TPU kernel's NEG_INF

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides over (batch, head, position); the head dim is contiguous
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int heads, kv_heads, sq, skv, d, causal, window;
  float softcap, scale;
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DMAX>
constexpr int smem_floats() {
  return BQ * (DMAX + 1) + BKV * (DMAX + 1) + BKV * DMAX + BQ * BKV;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Args p) {
  constexpr int LD = DMAX + 1;             // +1: lanes on distinct banks
  constexpr int JD = DMAX / 32;            // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][LD], scaled q
  float* Ks = Qs + BQ * LD;                // [BKV][LD]
  float* Vs = Ks + BKV * LD;               // [BKV][DMAX]
  float* Ps = Vs + BKV * DMAX;             // [BQ][BKV], this tile's weights

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int hk = h / (p.heads / p.kv_heads);
  const int q0 = blockIdx.y * BQ;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int e = tid; e < BQ * DMAX; e += kThreads) {
    const int r = e / DMAX, c = e % DMAX;
    const int qi = q0 + r;
    Qs[r * LD + c] =
        qi < p.sq && c < p.d ? to_f(q[qi * p.q_ss + c]) * p.scale : 0.f;
  }

  // The key tiles that hold a valid key for some row of this query tile:
  // [lo of the first row, hi of the last]. The last row is the first to
  // lose every key; if it has none, visit all tiles (see the header).
  const int q_last = min(q0 + BQ, p.sq) - 1;
  const int hi = p.causal ? min(q_last, p.skv - 1) : p.skv - 1;
  int kv_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  int kv_hi = hi;
  if (p.window > 0 && q_last - p.window + 1 > hi) {
    kv_lo = 0;
    kv_hi = p.skv - 1;
  }

  float m_i[kRows], l_i[kRows], acc[kRows][JD];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;
  }

  for (int t = kv_lo / BKV; t <= kv_hi / BKV; ++t) {
    const int kv0 = t * BKV;
    __syncthreads();                       // Qs stored / last tile read
    for (int e = tid; e < BKV * DMAX; e += kThreads) {
      const int r = e / DMAX, c = e % DMAX;
      const int kj = kv0 + r;
      const bool in = kj < p.skv && c < p.d;
      Ks[r * LD + c] = in ? to_f(k[kj * p.k_ss + c]) : 0.f;
      Vs[r * DMAX + c] = in ? to_f(v[kj * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp * kRows + i;
      const int qpos = q0 + r;
      float s[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        float dot = 0.f;
#pragma unroll 8
        for (int e = 0; e < DMAX; ++e)
          dot = fmaf(Qs[r * LD + e], Ks[c * LD + e], dot);
        if (p.softcap > 0.f) dot = p.softcap * tanhf(dot / p.softcap);
        const int kpos = kv0 + c;
        bool ok = true;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && qpos - kpos < p.window;
        s[j] = kpos >= p.skv ? -__int_as_float(0x7f800000)      // -inf
                             : (ok ? dot : kNegInf);
      }
      const float m_new = fmaxf(m_i[i], warp_max(fmaxf(s[0], s[1])));
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      Ps[r * BKV + lane] = p0;
      Ps[r * BKV + lane + 32] = p1;
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * corr + warp_sum(p0 + p1);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < JD; ++j) acc[i][j] *= corr;
    }
    __syncwarp();                          // this warp's Ps rows are stored

    for (int c = 0; c < BKV; ++c) {
      float vv[JD];
#pragma unroll
      for (int j = 0; j < JD; ++j) vv[j] = Vs[c * DMAX + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float pr = Ps[(warp * kRows + i) * BKV + c];
#pragma unroll
        for (int j = 0; j < JD; ++j) acc[i][j] = fmaf(pr, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + warp * kRows + i;
    if (qi >= p.sq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int c = lane + 32 * j;
      if (c < p.d) o[qi * p.o_ss + c] = from_f<T>(acc[i][j] / l);
    }
  }
}

template <typename T, int DMAX>
int launch(const Args& p, int batch, cudaStream_t stream) {
  const int bytes = smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * p.heads, (p.sq + BQ - 1) / BQ);
  flash_kernel<T, DMAX><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Args& p, int batch, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 32>(p, batch, stream);
  if (p.d <= 64) return launch<T, 64>(p, batch, stream);
  return launch<T, 128>(p, batch, stream);
}

}  // namespace

// strides: 12 element strides, (batch, head, position) of q, k, v, o.
// Returns the CUDA error of the launch (0 on success). dtype 0: float32,
// 1: bfloat16.
extern "C" int flash_first_fwd(int dtype, const void* q, const void* k,
                               const void* v, void* o,
                               const long long* strides, int batch,
                               int heads, int kv_heads, int sq, int skv,
                               int d, int causal, int window, float softcap,
                               float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      sq <= 0 || skv <= 0 || d <= 0 || d > 128 || window < 0 ||
      softcap < 0.f)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  long long* s[12] = {&p.q_sb, &p.q_sh, &p.q_ss, &p.k_sb, &p.k_sh, &p.k_ss,
                      &p.v_sb, &p.v_sh, &p.v_ss, &p.o_sb, &p.o_sh, &p.o_ss};
  for (int i = 0; i < 12; ++i) *s[i] = strides[i];
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.sq = sq;
  p.skv = skv;
  p.d = d;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(p, batch, st);
    case 1: return launch_d<__nv_bfloat16>(p, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
