// Chunked gated linear-attention scan (RWKV6 / GLA) for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/linear_scan/kernel.py::
// linear_scan_kernel (body _scan_kernel).  Per (batch, head) the recurrence
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t
// with o_t = q_t S_t (GLA) or o_t = q_t (S_{t-1} + diag(u) k_t^T v_t)
// (RWKV6) in its chunked form: inside a chunk of C rows, lb is the
// inclusive prefix sum of log w (lbq = lb - log w for RWKV6), the factors
// q exp(min(lbq - mid, 80)) and k exp(min(mid - lb, 80)) around the
// mid-chunk normalizer mid = lb[C/2] give the [C, C] score block A,
// masked to the inclusive (GLA) or strict (RWKV6) lower triangle;
//     o     = A v (+ (q.u.k) v for RWKV6) + (q exp(lbq)) S0
//     S_new = exp(lb[C-1]) S0 + (k exp(lb[C-1] - lb))^T v
// with everything in fp32 and o rounded once to v's dtype at the end.
// Exact in fp32 for C <= 21 at the RWKV6 decay clip (log w >= -e^2); the
// wrapper takes C <= 16 (SAFE_CHUNK).
//
// What bounds it on the H100: at the RWKV6-7B forward's shape (B=2,
// S=2048, 64 heads of 64) q/k/v/o in bf16 and w in fp32 are 201 MB against
// about 4 GFLOP of chunked products, so the bytes bound it (about 60 us at
// 3.35 TB/s).  Each block streams its rows once, keeps the carry and the
// chunk tiles in shared memory, and writes o once; the next chunk's q, k,
// w and v are loaded into registers while this chunk computes.  It is the
// simple, correct form: plain fp32 FMAs, accurate logf/expf (five
// transcendentals per (row, Dk) element, recomputed by each column slice),
// six barriers per chunk, no mma/wgmma and no TMA.  Making it fast is
// later work.
//
// The TPU kernel's sequential chunk grid axis and its VMEM carry become a
// loop over chunks inside the block.  The carry's column slices are
// independent (S[:, e] depends only on v[:, e]), so the grid is
// (Dv / ES column slices, H, B): each block owns ES columns of one
// (batch, head) and recomputes the cheap [C, C] score block for them.
// Every reduction runs in a fixed order inside one block, so a row's
// result never depends on B or on the other rows of the batch.
//
// Reads q, k, v, w as [B, S, H, D] through their strides (the last dim
// contiguous; no moveaxis, no padding in memory: rows past S act as w = 1,
// q = k = v = 0, and Dk pads to 16/32/64 the same way).  u is [H, Dk],
// read per head.  Writes o contiguous [B, S, H, Dv].
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): linear_scan_launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int CMAX = 16;      // the largest chunk (SAFE_CHUNK)
constexpr int ES = 32;        // carry columns (of Dv) per block
constexpr int THREADS = 128;
constexpr float EXP_CLAMP = 80.f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  void* o;
  int B, S, H, Dk, Dv, C, rwkv;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, wb, ws, wh;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int DKP>
__global__ void __launch_bounds__(THREADS)
linear_scan_kernel(const Params p) {
  constexpr int LD = DKP + 1;                  // [C][DKP] tile stride
  constexpr int NQ = CMAX * DKP / THREADS;     // q/k/w elements per thread
  constexpr int NV = CMAX * ES / THREADS;      // v elements per thread
  static_assert(CMAX * DKP % THREADS == 0 && CMAX * ES % THREADS == 0,
                "tiles must split evenly over the threads");
  static_assert(DKP + CMAX <= THREADS, "bonus threads follow the prefix's");

  __shared__ float sq[CMAX][LD];    // q
  __shared__ float sk[CMAX][LD];    // k
  __shared__ float slw[CMAX][LD];   // log w
  __shared__ float slb[CMAX][LD];   // lb: inclusive prefix sum of log w
  __shared__ float sqt[CMAX][LD];   // q exp(min(lbq - mid, 80))
  __shared__ float skt[CMAX][LD];   // k exp(min(mid - lb, 80))
  __shared__ float sqi[CMAX][LD];   // q exp(lbq): reads the carry
  __shared__ float ske[CMAX][LD];   // k exp(lb[C-1] - lb): feeds the carry
  __shared__ float sv[CMAX][ES];    // this block's v columns
  __shared__ float sA[CMAX][CMAX + 1];
  __shared__ float sS[DKP][ES];     // the carry's column slice (fp32)
  __shared__ float su[DKP];
  __shared__ float sdc[DKP];        // exp(lb[C-1]): the chunk's decay
  __shared__ float sbonus[CMAX];

  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * ES;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = p.C;
  const int rwkv = p.rwkv;
  const T* q = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* k = static_cast<const T*>(p.k) + b * p.kb + h * p.kh;
  const T* v = static_cast<const T*>(p.v) + b * p.vb + h * p.vh;
  const float* w = p.w + b * p.wb + h * p.wh;
  T* o = static_cast<T*>(p.o);

  for (int i = tid; i < DKP * ES; i += THREADS) sS[i / ES][i % ES] = 0.f;
  if (tid < DKP) su[tid] = (rwkv && tid < p.Dk) ? p.u[h * p.Dk + tid] : 0.f;

  // registers holding the next chunk (rows past S: w = 1, q = k = v = 0)
  float rq[NQ], rk[NQ], rw[NQ], rv[NV];
  auto load = [&](int n) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int idx = tid + i * THREADS;
      const int t = idx / DKP, d = idx % DKP;
      const int row = n * C + t;
      const bool in = t < C && row < p.S && d < p.Dk;
      rq[i] = in ? to_f(q[row * p.qs + d]) : 0.f;
      rk[i] = in ? to_f(k[row * p.ks + d]) : 0.f;
      rw[i] = in ? w[row * p.ws + d] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = tid + i * THREADS;
      const int t = idx / ES, e = idx % ES;
      const int row = n * C + t;
      const bool in = t < C && row < p.S && e0 + e < p.Dv;
      rv[i] = in ? to_f(v[row * p.vs + e0 + e]) : 0.f;
    }
  };

  const int n_chunks = (p.S + C - 1) / C;
  load(0);
  for (int n = 0; n < n_chunks; ++n) {
    // (a) stage the chunk, then start loading the next one
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int idx = tid + i * THREADS;
      const int t = idx / DKP, d = idx % DKP;
      sq[t][d] = rq[i];
      sk[t][d] = rk[i];
      slw[t][d] = logf(rw[i]);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = tid + i * THREADS;
      sv[idx / ES][idx % ES] = rv[i];
    }
    __syncthreads();
    if (n + 1 < n_chunks) load(n + 1);

    // (b) the prefix sum of log w per column; the RWKV6 bonus q.u.k per row
    if (tid < DKP) {
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        run += slw[t][tid];
        slb[t][tid] = run;
      }
    } else if (rwkv && tid < DKP + C) {
      const int t = tid - DKP;
      float acc = 0.f;
      for (int d = 0; d < DKP; ++d) acc += sq[t][d] * su[d] * sk[t][d];
      sbonus[t] = acc;
    }
    __syncthreads();

    // (c) the factored operands
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int idx = tid + i * THREADS;
      const int t = idx / DKP, d = idx % DKP;
      if (t < C) {
        const float lb = slb[t][d];
        const float lbq = rwkv ? lb - slw[t][d] : lb;
        const float mid = slb[C / 2][d];
        const float lbc = slb[C - 1][d];
        sqt[t][d] = sq[t][d] * expf(fminf(lbq - mid, EXP_CLAMP));
        skt[t][d] = sk[t][d] * expf(fminf(mid - lb, EXP_CLAMP));
        sqi[t][d] = sq[t][d] * expf(lbq);
        ske[t][d] = sk[t][d] * expf(lbc - lb);
        if (t == 0) sdc[d] = expf(lbc);
      }
    }
    __syncthreads();

    // (d) the score block: masked entries are never formed, so a factor
    // that saturated above the diagonal cannot meet v (inf * 0 is NaN)
    for (int idx = tid; idx < CMAX * CMAX; idx += THREADS) {
      const int t = idx / CMAX, j = idx % CMAX;
      if (t < C && j < C) {
        float acc = 0.f;
        if (rwkv ? j < t : j <= t) {
          for (int d = 0; d < DKP; ++d) acc += sqt[t][d] * skt[j][d];
        }
        sA[t][j] = acc;
      }
    }
    __syncthreads();

    // (e) this chunk's output: intra (+ bonus) + inter
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = tid + i * THREADS;
      const int t = idx / ES, e = idx % ES;
      const int row = n * C + t;
      if (t < C && row < p.S && e0 + e < p.Dv) {
        float intra = 0.f;
        for (int j = 0; j < C; ++j) intra += sA[t][j] * sv[j][e];
        if (rwkv) intra += sbonus[t] * sv[t][e];
        float inter = 0.f;
        for (int d = 0; d < DKP; ++d) inter += sqi[t][d] * sS[d][e];
        store(o + ((long long)(b * p.S + row) * p.H + h) * p.Dv + e0 + e,
              intra + inter);
      }
    }
    __syncthreads();

    // (f) the carry: each thread owns its (d, e) entries
    for (int idx = tid; idx < DKP * ES; idx += THREADS) {
      const int d = idx / ES, e = idx % ES;
      float s = sdc[d] * sS[d][e];
      for (int t = 0; t < C; ++t) s += ske[t][d] * sv[t][e];
      sS[d][e] = s;
    }
    __syncthreads();
  }
}

template <typename T, int DKP>
static int launch_dk(const Params& p, cudaStream_t st) {
  dim3 grid((p.Dv + ES - 1) / ES, p.H, p.B);
  linear_scan_kernel<T, DKP><<<grid, THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_t(const Params& p, cudaStream_t st) {
  if (p.Dk <= 16) return launch_dk<T, 16>(p, st);
  if (p.Dk <= 32) return launch_dk<T, 32>(p, st);
  return launch_dk<T, 64>(p, st);
}

// strides: q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, w_b, w_s, w_h in
// elements (the last dim contiguous); w and u are fp32, u contiguous
// [H, Dk] (ignored when rwkv is 0); o is written contiguous [B, S, H, Dv]
extern "C" int linear_scan_launch(const void* q, const void* k,
                                  const void* v, const void* w,
                                  const void* u, void* o, int dtype, int B,
                                  int S, int H, int Dk, int Dv, int C,
                                  int rwkv, const long long* strides,
                                  void* stream) {
  if (Dk < 1 || Dk > 64 || Dv < 1 || C < 1 || C > CMAX || S < 1 || B < 1
      || B > 65535 || H < 1 || H > 65535 || (rwkv && u == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.o = o;
  p.B = B; p.S = S; p.H = H; p.Dk = Dk; p.Dv = Dv; p.C = C; p.rwkv = rwkv;
  p.qb = strides[0]; p.qs = strides[1]; p.qh = strides[2];
  p.kb = strides[3]; p.ks = strides[4]; p.kh = strides[5];
  p.vb = strides[6]; p.vs = strides[7]; p.vh = strides[8];
  p.wb = strides[9]; p.ws = strides[10]; p.wh = strides[11];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) return launch_t<__nv_bfloat16>(p, st);
  if (dtype == DT_F32) return launch_t<float>(p, st);
  return (int)cudaErrorInvalidValue;
}
