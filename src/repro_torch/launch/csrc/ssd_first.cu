// The port's first SSD chunk kernel, kept as the card sweep's control for
// kernels/ssd_scan/csrc/ssd_scan.cu (launch/bwd_sweep.py --only ssd times
// both side by side): a block of 256 threads a (cell, head, 64-row t-tile),
// 64-wide s-tiles of B, x, cum and dt staged in shared memory by scalar
// loads behind two barriers a tile, C_t . B_s recomputed for every head,
// M written to shared memory and read back for M @ x, every product plain
// fp32 FMAs from shared memory (no tensor cores). Same function, arguments
// and results as ssd_scan.cu's entry (within the fp32 rounding of the
// sums):
//
//   y[t] = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x[s]
//          + exp(cum_t) (C_t . state^T) + D x[t]
//
// masked above the diagonal before the exp, operands read through element
// strides. Sm_90a.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int BT = 64, BS = 64;            // rows of t and of s per tile
constexpr int TY = 16, TX = 16;            // thread grid over a tile
constexpr int kMaxSmem = 232448;           // bytes a block may hold (H100)

struct Args {
  const void* c;
  const void* b;
  const void* x;
  const float* cum;
  const float* dt;
  const float* state;
  const float* dskip;
  void* y;
  // element strides: c, b over (g, t); x, y over (g, h, t); cum, dt over
  // (g, h, t); state over (g, h, p)
  long long c_sg, c_st, b_sg, b_st;
  long long x_sg, x_sh, x_st, y_sg, y_sh, y_st;
  long long cum_sg, cum_sh, cum_st, dt_sg, dt_sh, dt_st;
  long long st_sg, st_sh, st_sp;
  int heads, q, n, p;
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

// Shared-memory floats for N and PMAX: Cs [BT][N+1], Bs [max(BS, PMAX)]
// [N+1] (the B tile, later the state), Xs [BS][PMAX], Ms [BT][BS+1], and
// cum_t [BT], cum_s [BS], dt_s [BS].
__host__ __device__ constexpr int smem_floats(int n, int pmax) {
  return BT * (n + 1) + (BS > pmax ? BS : pmax) * (n + 1) + BS * pmax +
         BT * (BS + 1) + BT + 2 * BS;
}

template <typename TC, typename TX_, int PMAX>
__global__ void __launch_bounds__(kThreads) ssd_kernel(const Args p) {
  constexpr int JP = PMAX / TX;            // output columns per thread
  constexpr int IT = BT / TY;              // output rows per thread
  constexpr int JS = BS / TX;              // s columns per thread
  const int ld = p.n + 1;                  // +1: threads on distinct banks
  extern __shared__ float smem[];
  float* Cs = smem;
  float* Bs = Cs + BT * ld;
  float* Xs = Bs + (BS > PMAX ? BS : PMAX) * ld;
  float* Ms = Xs + BS * PMAX;
  float* cum_t = Ms + BT * (BS + 1);
  float* cum_s = cum_t + BT;
  float* dt_s = cum_s + BS;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int g = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int t0 = blockIdx.y * BT;
  const TC* c = static_cast<const TC*>(p.c) + g * p.c_sg;
  const TC* b = static_cast<const TC*>(p.b) + g * p.b_sg;
  const TX_* x = static_cast<const TX_*>(p.x) + g * p.x_sg + h * p.x_sh;
  TX_* y = static_cast<TX_*>(p.y) + g * p.y_sg + h * p.y_sh;
  const float* cum = p.cum + g * p.cum_sg + h * p.cum_sh;
  const float* dt = p.dt + g * p.dt_sg + h * p.dt_sh;
  const float* state = p.state + g * p.st_sg + h * p.st_sh;

  for (int e = tid; e < BT * p.n; e += kThreads) {
    const int r = e / p.n, k = e % p.n;
    const int t = t0 + r;
    Cs[r * ld + k] = t < p.q ? to_f(c[t * p.c_st + k]) : 0.f;
  }
  for (int r = tid; r < BT; r += kThreads)
    cum_t[r] = t0 + r < p.q ? cum[(t0 + r) * p.cum_st] : 0.f;

  float acc[IT][JP];
#pragma unroll
  for (int i = 0; i < IT; ++i)
#pragma unroll
    for (int j = 0; j < JP; ++j) acc[i][j] = 0.f;

  const int s_end = min(t0 + BT, p.q);     // s <= t < s_end
  for (int s0 = 0; s0 < s_end; s0 += BS) {
    __syncthreads();                       // Cs stored / last tile read
    for (int e = tid; e < BS * p.n; e += kThreads) {
      const int r = e / p.n, k = e % p.n;
      const int s = s0 + r;
      Bs[r * ld + k] = s < p.q ? to_f(b[s * p.b_st + k]) : 0.f;
    }
    for (int e = tid; e < BS * PMAX; e += kThreads) {
      const int r = e / PMAX, col = e % PMAX;
      const int s = s0 + r;
      Xs[e] = s < p.q && col < p.p ? to_f(x[s * p.x_st + col]) : 0.f;
    }
    for (int r = tid; r < BS; r += kThreads) {
      const int s = s0 + r;
      cum_s[r] = s < p.q ? cum[s * p.cum_st] : 0.f;
      dt_s[r] = s < p.q ? dt[s * p.dt_st] : 0.f;
    }
    __syncthreads();

    // M[t, s] for s <= t < Q; exactly 0 elsewhere, with no exp taken
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int tl = ty + i * TY;
      const int t = t0 + tl;
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        const int sl = tx + j * TX;
        const int s = s0 + sl;
        float m = 0.f;
        if (s <= t && t < p.q) {
          float dot = 0.f;
          for (int k = 0; k < p.n; ++k)
            dot = fmaf(Cs[tl * ld + k], Bs[sl * ld + k], dot);
          m = dot * expf(cum_t[tl] - cum_s[sl]) * dt_s[sl];
        }
        Ms[tl * (BS + 1) + sl] = m;
      }
    }
    __syncthreads();

    for (int sl = 0; sl < BS; ++sl) {
      float xv[JP];
#pragma unroll
      for (int j = 0; j < JP; ++j) xv[j] = Xs[sl * PMAX + tx + j * TX];
#pragma unroll
      for (int i = 0; i < IT; ++i) {
        const float m = Ms[(ty + i * TY) * (BS + 1) + sl];
#pragma unroll
        for (int j = 0; j < JP; ++j) acc[i][j] = fmaf(m, xv[j], acc[i][j]);
      }
    }
  }

  // the carried state: acc += exp(cum_t) * C_t . state^T (state in Bs)
  __syncthreads();
  for (int e = tid; e < PMAX * p.n; e += kThreads) {
    const int r = e / p.n, k = e % p.n;
    Bs[r * ld + k] = r < p.p ? state[r * p.st_sp + k] : 0.f;
  }
  __syncthreads();
  const float d_h = p.dskip[h];
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int tl = ty + i * TY;
    const int t = t0 + tl;
    const float decay = expf(cum_t[tl]);
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      const int col = tx + j * TX;
      float dot = 0.f;
      for (int k = 0; k < p.n; ++k)
        dot = fmaf(Cs[tl * ld + k], Bs[col * ld + k], dot);
      if (t < p.q && col < p.p) {
        const float xt = to_f(x[t * p.x_st + col]);
        y[t * p.y_st + col] = from_f<TX_>(acc[i][j] + decay * dot + d_h * xt);
      }
    }
  }
}

template <typename TC, typename TX_, int PMAX>
int launch(const Args& p, int cells, cudaStream_t stream) {
  const int bytes = smem_floats(p.n, PMAX) * static_cast<int>(sizeof(float));
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<TC, TX_, PMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cells * p.heads, (p.q + BT - 1) / BT);
  ssd_kernel<TC, TX_, PMAX><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TC, typename TX_>
int launch_p(const Args& p, int cells, cudaStream_t stream) {
  if (p.p <= 64) return launch<TC, TX_, 64>(p, cells, stream);
  return launch<TC, TX_, 128>(p, cells, stream);
}

}  // namespace

// strides: 19 element strides in the order of Args (c_sg .. st_sp).
// Returns the CUDA error of the launch (0 on success). cb_dtype and x_dtype
// 0: float32, 1: bfloat16.
extern "C" int ssd_first_fwd(int cb_dtype, int x_dtype, const void* c,
                             const void* b, const void* x, const float* cum,
                             const float* dt, const float* state,
                             const float* dskip, void* y,
                             const long long* strides, int cells, int heads,
                             int q, int n, int p, void* stream) {
  if (cells <= 0 || heads <= 0 || q <= 0 || n <= 0 || p <= 0 || p > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.c = c;
  a.b = b;
  a.x = x;
  a.cum = cum;
  a.dt = dt;
  a.state = state;
  a.dskip = dskip;
  a.y = y;
  long long* s[19] = {&a.c_sg,   &a.c_st,   &a.b_sg,   &a.b_st,  &a.x_sg,
                      &a.x_sh,   &a.x_st,   &a.y_sg,   &a.y_sh,  &a.y_st,
                      &a.cum_sg, &a.cum_sh, &a.cum_st, &a.dt_sg, &a.dt_sh,
                      &a.dt_st,  &a.st_sg,  &a.st_sh,  &a.st_sp};
  for (int i = 0; i < 19; ++i) *s[i] = strides[i];
  a.heads = heads;
  a.q = q;
  a.n = n;
  a.p = p;
  auto st = static_cast<cudaStream_t>(stream);
  const int code = 2 * cb_dtype + x_dtype;
  switch (cb_dtype < 0 || cb_dtype > 1 || x_dtype < 0 || x_dtype > 1
              ? -1 : code) {
    case 0: return launch_p<float, float>(a, cells, st);
    case 1: return launch_p<float, __nv_bfloat16>(a, cells, st);
    case 2: return launch_p<__nv_bfloat16, float>(a, cells, st);
    case 3: return launch_p<__nv_bfloat16, __nv_bfloat16>(a, cells, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
