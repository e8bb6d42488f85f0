// The backward of the chunked gated linear-attention scan (RWKV6 / GLA) for
// NVIDIA Hopper (sm_90a), with the carried-state variant's gradients.
//
// Pairs with the forward (linear_scan.cu, which replaces the TPU kernel
// src/repro/kernels/linear_scan/kernel.py:70 linear_scan_kernel).  The TPU
// path has no backward kernel: the reference differentiates its sequential
// oracle (src/repro/kernels/linear_scan/ops.py::linear_scan_vjp).  This is
// the gradient of the forward's chunked form, in its arithmetic (the chunk
// C <= 16, rows past S as w = 1 and q = k = v = 0, the mid-chunk
// normalizer, the clamp of 80, the strict (RWKV6) or inclusive (GLA)
// triangle), all in fp32; its plain version is ref.py::linear_scan_bwd_ref.
//
// The work is fork-join, like the forward's:
//  (a) carry_kernel, forward half: per (batch, head, 32 value columns) a
//      serial pass over the chunks that recomputes the chunk-start carries
//          S_{n+1} = exp(lbc) S_n + (k exp(lbc - lb))^T v
//      from S_0 = init (or 0), writing S_n into an fp32 workspace
//      [B, H, N, Dk, Dv];
//  (b) carry_kernel, reverse half (the same launch, blockIdx.z >= B): a
//      serial pass from the end carrying the carry's gradient
//          dS_n = exp(lbc) dS_{n+1} + (q exp(lbq))^T do
//      from dS_N = the final carry's cotangent (or 0), writing dS_{n+1}
//      into a second workspace at n, and dS_0 out when the forward took an
//      initial carry;
//  (c) chunk_kernel, the fork: one block per (chunk, head, batch) takes
//      its rows, S_n and dS_{n+1} and writes its rows' dq, dk, dv and dw,
//      and its share of du;
//  (d) du_kernel, the join: du's per-chunk partials summed per (head,
//      key column) in (batch, chunk) order.
// Per chunk, with qt = q exp(min(lbq - mid, 80)), kt = k exp(min(mid - lb,
// 80)) and the triangle's mask:
//     A  = mask(qt kt^T),  dA = mask(do v^T),  dbon_t = do_t . v_t
//     dv = A^T do + bonus do + (k exp(lbc - lb)) dS_{n+1}
//     dq = (dA kt) exp(min(lbq - mid, 80)) + (do S_n^T) exp(lbq) + dbon u k
//     dk = (dA^T qt) exp(min(mid - lb, 80)) + (v dS_{n+1}^T) exp(lbc - lb)
//          + dbon u q
// and dlog w_s from every term through the exponent it carries, none
// cancelling another (see ref.py): the triangle's pairs (t, j) for j < s <
// t (GLA: j < s <= t), the carry read for t > s (t >= s), the carry written
// for j < s, the chunk's decay for every s; dw = dlog w / w.  Masked score
// entries are never formed or multiplied.
//
// Deterministic: no atomics; every sum runs in a fixed order inside one
// thread, and a row's results depend on its own (batch, head) alone; du is
// the one sum over batch and time, taken in (batch, chunk) order.
//
// What bounds it on the H100: at the RWKV6-7B train shape (B = 2, S =
// 2048, 64 heads of 64, bf16) the function moves q, k, v, do in and dq,
// dk, dv out (bf16) and w in, dw out (fp32), 369 MB, against ~13 GFLOP:
// bytes-bound (110 us at 3.35 TB/s).  This design adds the two fp32
// workspaces, 268 MB each, written once and read back.  It is a simple
// first kernel: plain fp32 FMAs, no tensor cores, no TMA.  (a) and (b) are
// serial chains of N chunks per (batch, head, 32 value columns), 512
// blocks at the train shape, one wave at 4 blocks an SM: each thread keeps
// 16 carry entries in registers and reads its key columns 16 bytes at a
// time (a warp-wide broadcast).  (c) reads its shared-memory tiles 16 bytes
// at a time too, each thread holding 4 outputs (2 blocks an SM by shared
// memory).
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): linear_scan_bwd_launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int CMAX = 16;      // the largest chunk (SAFE_CHUNK)
constexpr float EXP_CLAMP = 80.f;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // the output's cotangent, in v's dtype
  const float* w;
  const float* u;      // [H, Dk] (RWKV6) or null
  const float* s0;     // the initial carry [B, H, Dk, Dv] or null (zeros)
  const float* dsf;    // the final carry's cotangent or null (zeros)
  float* st;           // workspace: S_n at n      [B, H, N, Dk, Dv]
  float* dst;          // workspace: dS_{n+1} at n [B, H, N, Dk, Dv]
  float* dup;          // du's partials [B, H, N, Dk] (RWKV6)
  void* dq;
  void* dk;
  void* dv;
  float* dw;
  float* du;           // [H, Dk] (RWKV6)
  float* ds0;          // [B, H, Dk, Dv] or null
  int B, S, H, Dk, Dv, C, N, rwkv;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, wb, ws, wh, ob, os, oh;
};

template <int DT> struct Elem;
template <> struct Elem<DT_F32> { using T = float; };
template <> struct Elem<DT_BF16> { using T = __nv_bfloat16; };

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void stf(float* p, float x) { *p = x; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// (a), (b): the chunk-start carries and their gradients
// ---------------------------------------------------------------------------

constexpr int ES = 32;             // carry columns (of Dv) per block
constexpr int CARRY_THREADS = 128;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Each thread holds ND = DKP / 4 entries of the carry (key columns d0 ..
// d0 + ND - 1 of one value column) in registers for the whole pass; per
// chunk row it reads its value column's entry and its key columns' (a
// warp-wide broadcast, 16 bytes at a time) from shared memory.
template <int DT, int DKP>
__global__ void __launch_bounds__(CARRY_THREADS, 4)
scan_bwd_carry_kernel(const BwdParams p) {
  using T = typename Elem<DT>::T;
  constexpr int LDX = DKP + 4;                     // 16-byte rows
  constexpr int ND = DKP * ES / CARRY_THREADS;     // carry entries a thread
  constexpr int NQ = CMAX * DKP / CARRY_THREADS;   // x / w elements a thread
  constexpr int NV = CMAX * ES / CARRY_THREADS;    // y elements a thread
  static_assert(CMAX * DKP % CARRY_THREADS == 0 && ND % 4 == 0
                && CMAX * ES % CARRY_THREADS == 0, "tiles split evenly");

  __shared__ __align__(16) float sx[CMAX][LDX];   // k (forward) or q, scaled
  __shared__ float slw[CMAX][DKP + 1];            // log w, then the exponent
  __shared__ float sy[CMAX][ES];    // v (forward) or do (reverse) columns
  __shared__ __align__(16) float sdc[DKP];        // exp(lbc)

  const int tid = threadIdx.x;
  const bool rev = blockIdx.z >= (unsigned)p.B;
  const int b = rev ? blockIdx.z - p.B : blockIdx.z;
  const int h = blockIdx.y, e0 = blockIdx.x * ES;
  const int C = p.C, N = p.N;
  const T* x = static_cast<const T*>(rev ? p.q : p.k)
               + b * (rev ? p.qb : p.kb) + h * (rev ? p.qh : p.kh);
  const long long xs = rev ? p.qs : p.ks;
  const T* y = static_cast<const T*>(rev ? p.dout : p.v)
               + b * (rev ? p.ob : p.vb) + h * (rev ? p.oh : p.vh);
  const long long ys = rev ? p.os : p.vs;
  const float* w = p.w + b * p.wb + h * p.wh;
  const long long sbase = ((long long)b * p.H + h) * p.Dk * p.Dv;
  const long long plane = (long long)p.Dk * p.Dv;
  float* ws = (rev ? p.dst : p.st) + ((long long)b * p.H + h) * N * plane;
  const float* init = rev ? p.dsf : p.s0;

  // this thread's entries: key columns d0 + i of value column e
  const int e = tid % ES, d0 = ND * (tid / ES);
  const bool ein = e0 + e < p.Dv;
  float s[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const int d = d0 + i;
    s[i] = (init && ein && d < p.Dk)
               ? init[sbase + (long long)d * p.Dv + e0 + e] : 0.f;
  }
  auto store = [&](float* dst) {
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      if (ein && d0 + i < p.Dk) dst[(long long)(d0 + i) * p.Dv + e0 + e] = s[i];
    }
  };

  // registers holding the next chunk (rows past S: w = 1, x = y = 0)
  float rx[NQ], rw[NQ], ry[NV];
  auto load = [&](int n) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int idx = tid + i * CARRY_THREADS;
      const int t = idx / DKP, d = idx % DKP;
      const long long row = (long long)n * C + t;
      const bool in = t < C && row < p.S && d < p.Dk;
      rx[i] = in ? ldf(x + row * xs + d) : 0.f;
      rw[i] = in ? w[row * p.ws + d] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = tid + i * CARRY_THREADS;
      const int t = idx / ES, c = idx % ES;
      const long long row = (long long)n * C + t;
      const bool in = t < C && row < p.S && e0 + c < p.Dv;
      ry[i] = in ? ldf(y + row * ys + e0 + c) : 0.f;
    }
  };

  load(rev ? N - 1 : 0);
  for (int i = 0; i < N; ++i) {
    const int n = rev ? N - 1 - i : i;
    // the carry entering chunk n (forward) or the gradient of the one
    // leaving it (reverse)
    store(ws + (long long)n * plane);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int idx = tid + j * CARRY_THREADS;
      const int t = idx / DKP, d = idx % DKP;
      sx[t][d] = rx[j];
      slw[t][d] = logf(rw[j]);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int idx = tid + j * CARRY_THREADS;
      sy[idx / ES][idx % ES] = ry[j];
    }
    __syncthreads();
    if (i + 1 < N) load(rev ? n - 1 : n + 1);

    // per key column: the prefix sums of log w and the factor on x
    if (tid < DKP) {
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = slw[t][tid];
        run += lw;                                  // lb_t
        slw[t][tid] = rev ? (p.rwkv ? run - lw : run) : run;
      }
      for (int t = 0; t < C; ++t)
        sx[t][tid] *= expf(rev ? slw[t][tid] : run - slw[t][tid]);
      sdc[tid] = expf(run);
    }
    __syncthreads();

    // the carry: decay, then the chunk's rows in order
#pragma unroll
    for (int i4 = 0; i4 < ND / 4; ++i4) {
      const float4 dc = ld4(&sdc[d0 + 4 * i4]);
      s[4 * i4] *= dc.x;
      s[4 * i4 + 1] *= dc.y;
      s[4 * i4 + 2] *= dc.z;
      s[4 * i4 + 3] *= dc.w;
    }
    for (int t = 0; t < C; ++t) {
      const float yv = sy[t][e];
#pragma unroll
      for (int i4 = 0; i4 < ND / 4; ++i4) {
        const float4 xv = ld4(&sx[t][d0 + 4 * i4]);
        s[4 * i4] += xv.x * yv;
        s[4 * i4 + 1] += xv.y * yv;
        s[4 * i4 + 2] += xv.z * yv;
        s[4 * i4 + 3] += xv.w * yv;
      }
    }
    __syncthreads();   // every thread has read this chunk's rows
  }
  if (rev && p.ds0) store(p.ds0 + sbase);
}

// ---------------------------------------------------------------------------
// (c): every chunk's gradients from its own rows and carries
// ---------------------------------------------------------------------------

constexpr int ET = 64;             // value columns per tile
constexpr int CHUNK_THREADS = 256;
static_assert(CMAX * CMAX == CHUNK_THREADS, "one score entry a thread");
static_assert(CMAX * ET / 4 == CHUNK_THREADS, "4 dv columns a thread");

template <int DKP>
struct ChunkSmem {
  static constexpr int LD = DKP + 4;     // 16-byte rows
  static constexpr int LE = ET + 4;
  float q[CMAX][LD], k[CMAX][LD], w[CMAX][LD];
  float fq[CMAX][LD];      // exp(min(lbq - mid, 80))
  float fk[CMAX][LD];      // exp(min(mid - lb, 80))
  float eq[CMAX][LD];      // exp(lbq)
  float ek[CMAX][LD];      // exp(lbc - lb)
  float qt[CMAX][LD];      // q fq
  float kt[CMAX][LD];      // k fk
  float ke[CMAX][LD];      // k ek: the carry written
  float gq[CMAX][LD];      // do S_n^T, then (q exp(lbq)) (do S_n^T)
  float gk[CMAX][LD];      // v dS_{n+1}^T, then (k exp(lbc - lb)) (...)
  float v[CMAX][LE], o[CMAX][LE];                  // this tile's
  float sn[DKP][LE], ds1[DKP][LE];                 // this tile's
  float a[CMAX][CMAX + 1];     // masked A
  float da[CMAX][CMAX + 1];    // masked dA
  float bon[CMAX], dbon[CMAX];
  float mid[DKP], lbc[DKP];    // lb at the normalizer's row and the last
  float gdc[DKP];          // exp(lbc) sum_e dS_{n+1} S_n
};

template <int DT, int DKP>
__global__ void __launch_bounds__(CHUNK_THREADS, 2)
scan_bwd_chunk_kernel(const BwdParams p) {
  using T = typename Elem<DT>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<DKP>& sm = *reinterpret_cast<ChunkSmem<DKP>*>(smem_raw);
  constexpr int RP = CHUNK_THREADS / DKP;   // rows a pass over [CMAX][DKP]
  constexpr int NR = CMAX / RP;             // its entries a thread

  const int tid = threadIdx.x;
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C = p.C;
  const bool rwkv = p.rwkv;
  const long long row0 = (long long)n * C;
  const T* q = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* k = static_cast<const T*>(p.k) + b * p.kb + h * p.kh;
  const T* v = static_cast<const T*>(p.v) + b * p.vb + h * p.vh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.ob + h * p.oh;
  const float* w = p.w + b * p.wb + h * p.wh;
  const long long plane = (long long)p.Dk * p.Dv;
  const long long wsb = ((long long)b * p.H + h) * p.N * plane;
  const float* snp = p.st + wsb + n * plane;           // S_n
  const float* ds1p = p.dst + wsb + n * plane;         // dS_{n+1}

  // rows of q, k, w (past the chunk or S: 0, 0, 1) and log w
  for (int idx = tid; idx < CMAX * DKP; idx += CHUNK_THREADS) {
    const int t = idx / DKP, d = idx % DKP;
    const long long row = row0 + t;
    const bool in = t < C && row < p.S && d < p.Dk;
    const float wv = in ? w[row * p.ws + d] : 1.f;
    sm.q[t][d] = in ? ldf(q + row * p.qs + d) : 0.f;
    sm.k[t][d] = in ? ldf(k + row * p.ks + d) : 0.f;
    sm.w[t][d] = wv;
    sm.eq[t][d] = logf(wv);                           // log w, for now
  }
  __syncthreads();
  // per key column: the prefix sums of log w; per row: the bonus q.u.k
  if (tid < DKP) {
    const int d = tid;
    float run = 0.f;
    for (int t = 0; t < C; ++t) {
      run += sm.eq[t][d];
      sm.ek[t][d] = run;                              // lb, for now
      if (t == C / 2) sm.mid[d] = run;
    }
    sm.lbc[d] = run;
    sm.gdc[d] = expf(run);                            // dC, for now
  } else if (tid < DKP + CMAX) {
    const int t = tid - DKP;
    float acc = 0.f;
    if (rwkv && t < C) {
      for (int d = 0; d < p.Dk; ++d)
        acc += sm.q[t][d] * p.u[h * p.Dk + d] * sm.k[t][d];
    }
    sm.bon[t] = acc;
  }
  __syncthreads();
  // the four factors and the three scaled rows, an entry a thread
  for (int idx = tid; idx < CMAX * DKP; idx += CHUNK_THREADS) {
    const int t = idx / DKP, d = idx % DKP;
    float fq = 0.f, fk = 0.f, eq = 0.f, ek = 0.f;
    if (t < C) {
      const float lb = sm.ek[t][d], mid = sm.mid[d];
      const float lbq = rwkv ? lb - sm.eq[t][d] : lb;
      fq = expf(fminf(lbq - mid, EXP_CLAMP));
      fk = expf(fminf(mid - lb, EXP_CLAMP));
      eq = expf(lbq);
      ek = expf(sm.lbc[d] - lb);
    }
    sm.fq[t][d] = fq;
    sm.fk[t][d] = fk;
    sm.eq[t][d] = eq;
    sm.ek[t][d] = ek;
    sm.qt[t][d] = sm.q[t][d] * fq;
    sm.kt[t][d] = sm.k[t][d] * fk;
    sm.ke[t][d] = sm.k[t][d] * ek;
  }
  __syncthreads();
  // A = mask(qt kt^T): one entry a thread, masked entries never formed
  const int st = tid / CMAX, sj = tid % CMAX;   // this thread's score entry
  {
    float acc = 0.f;
    if (st < C && (rwkv ? sj < st : sj <= st)) {
#pragma unroll 4
      for (int d = 0; d < DKP; d += 4) {
        const float4 a4 = ld4(&sm.qt[st][d]), b4 = ld4(&sm.kt[sj][d]);
        acc += a4.x * b4.x;
        acc += a4.y * b4.y;
        acc += a4.z * b4.z;
        acc += a4.w * b4.w;
      }
    }
    sm.a[st][sj] = acc;
  }

  // over the value tiles, each thread owning the same sums in every tile
  const int gc = tid % DKP, gr = tid / DKP;     // do S_n^T, v dS^T entries
  const int vt = tid / (ET / 4), ve = 4 * (tid % (ET / 4));   // dv's
  float gq[NR] = {}, gk[NR] = {};
  float da = 0.f, dcs = 0.f;
  for (int e0 = 0; e0 < p.Dv; e0 += ET) {
    __syncthreads();   // A is written; the previous tile is read
    for (int idx = tid; idx < CMAX * ET; idx += CHUNK_THREADS) {
      const int t = idx / ET, e = idx % ET;
      const long long row = row0 + t;
      const bool in = t < C && row < p.S && e0 + e < p.Dv;
      sm.v[t][e] = in ? ldf(v + row * p.vs + e0 + e) : 0.f;
      sm.o[t][e] = in ? ldf(dout + row * p.os + e0 + e) : 0.f;
    }
    for (int idx = tid; idx < DKP * ET; idx += CHUNK_THREADS) {
      const int d = idx / ET, e = idx % ET;
      const bool in = d < p.Dk && e0 + e < p.Dv;
      const long long off = (long long)d * p.Dv + e0 + e;
      sm.sn[d][e] = in ? snp[off] : 0.f;
      sm.ds1[d][e] = in ? ds1p[off] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int e = 0; e < ET; e += 4) {   // do v^T, unmasked (diagonal do.v)
      const float4 a4 = ld4(&sm.o[st][e]), b4 = ld4(&sm.v[sj][e]);
      da += a4.x * b4.x;
      da += a4.y * b4.y;
      da += a4.z * b4.z;
      da += a4.w * b4.w;
    }
#pragma unroll 2
    for (int e = 0; e < ET; e += 4) {   // do S_n^T and v dS_{n+1}^T
      const float4 s4 = ld4(&sm.sn[gc][e]), d4 = ld4(&sm.ds1[gc][e]);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int t = gr + RP * r;
        const float4 o4 = ld4(&sm.o[t][e]), v4 = ld4(&sm.v[t][e]);
        gq[r] += o4.x * s4.x;
        gq[r] += o4.y * s4.y;
        gq[r] += o4.z * s4.z;
        gq[r] += o4.w * s4.w;
        gk[r] += v4.x * d4.x;
        gk[r] += v4.y * d4.y;
        gk[r] += v4.z * d4.z;
        gk[r] += v4.w * d4.w;
      }
    }
    if (tid < DKP) {
      for (int e = 0; e < ET; e += 4) {
        const float4 s4 = ld4(&sm.sn[tid][e]), d4 = ld4(&sm.ds1[tid][e]);
        dcs += d4.x * s4.x;
        dcs += d4.y * s4.y;
        dcs += d4.z * s4.z;
        dcs += d4.w * s4.w;
      }
    }
    {   // dv = A^T do + bonus do + kE dS_{n+1}: 4 columns of one row
      float acc[4] = {};
      for (int j = 0; j < CMAX; ++j) {
        const float aj = sm.a[j][vt];
        const float4 o4 = ld4(&sm.o[j][ve]);
        acc[0] += aj * o4.x;
        acc[1] += aj * o4.y;
        acc[2] += aj * o4.z;
        acc[3] += aj * o4.w;
      }
      if (rwkv) {
        const float bt = sm.bon[vt];
        const float4 o4 = ld4(&sm.o[vt][ve]);
        acc[0] += bt * o4.x;
        acc[1] += bt * o4.y;
        acc[2] += bt * o4.z;
        acc[3] += bt * o4.w;
      }
#pragma unroll 4
      for (int d = 0; d < DKP; ++d) {
        const float kd = sm.ke[vt][d];
        const float4 d4 = ld4(&sm.ds1[d][ve]);
        acc[0] += kd * d4.x;
        acc[1] += kd * d4.y;
        acc[2] += kd * d4.z;
        acc[3] += kd * d4.w;
      }
      const long long row = row0 + vt;
      if (vt < C && row < p.S) {
        T* dst = static_cast<T*>(p.dv)
                 + ((b * (long long)p.S + row) * p.H + h) * p.Dv + e0 + ve;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (e0 + ve + c < p.Dv) stf(dst + c, acc[c]);
      }
    }
  }
  __syncthreads();
  sm.da[st][sj] = (st < C && (rwkv ? sj < st : sj <= st)) ? da : 0.f;
  if (st == sj) sm.dbon[st] = st < C ? da : 0.f;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    sm.gq[gr + RP * r][gc] = gq[r];
    sm.gk[gr + RP * r][gc] = gk[r];
  }
  if (tid < DKP) sm.gdc[tid] *= dcs;
  __syncthreads();

  // dq, dk; the carry terms of dlog w in place of do S_n^T, v dS_{n+1}^T
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int t = gr + RP * r, d = gc;
    const long long row = row0 + t;
    float dqt = 0.f, dkt = 0.f;
    if (t < C) {   // over the triangle, unrolled so the loads overlap
      const int jend = rwkv ? t : t + 1, ibeg = rwkv ? t + 1 : t;
#pragma unroll
      for (int j = 0; j < CMAX; ++j)
        if (j < jend) dqt += sm.da[t][j] * sm.kt[j][d];
#pragma unroll
      for (int i = 0; i < CMAX; ++i)
        if (i >= ibeg && i < C) dkt += sm.da[i][t] * sm.qt[i][d];
    }
    const float gqv = sm.gq[t][d], gkv = sm.gk[t][d];
    float dqv = dqt * sm.fq[t][d] + gqv * sm.eq[t][d];
    float dkv = dkt * sm.fk[t][d] + gkv * sm.ek[t][d];
    sm.gq[t][d] = (sm.q[t][d] * sm.eq[t][d]) * gqv;
    sm.gk[t][d] = sm.ke[t][d] * gkv;
    if (rwkv) {
      const float g = sm.dbon[t] * (d < p.Dk ? p.u[h * p.Dk + d] : 0.f);
      dqv += g * sm.k[t][d];
      dkv += g * sm.q[t][d];
    }
    if (t < C && row < p.S && d < p.Dk) {
      const long long off = ((b * (long long)p.S + row) * p.H + h) * p.Dk + d;
      stf(static_cast<T*>(p.dq) + off, dqv);
      stf(static_cast<T*>(p.dk) + off, dkv);
    }
  }
  __syncthreads();

  // per key column: du's partial and dlog w
  if (tid < DKP) {
    const int d = tid;
    if (rwkv && d < p.Dk) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t)
        acc += sm.dbon[t] * sm.q[t][d] * sm.k[t][d];
      p.dup[(((long long)b * p.H + h) * p.N + n) * p.Dk + d] = acc;
    }
    float kt[CMAX], x[CMAX];
#pragma unroll
    for (int j = 0; j < CMAX; ++j) {
      kt[j] = sm.kt[j][d];
      x[j] = 0.f;
    }
    // the triangle's pairs: (t, j) reaches s in (j, t) (GLA (j, t])
#pragma unroll
    for (int t = 1; t < CMAX; ++t) {
      if (t < C) {
        const float qt = sm.qt[t][d];
        float run = 0.f;
#pragma unroll
        for (int s = 1; s <= t; ++s) {
          if (s < t || !rwkv) {
            run += sm.da[t][s - 1] * qt * kt[s - 1];
            x[s] += run;
          }
        }
      }
    }
    // the carry read: t > s (GLA t >= s)
    float rq = 0.f;
#pragma unroll
    for (int s = CMAX - 1; s >= 0; --s) {
      if (s < C) {
        if (!rwkv) rq += sm.gq[s][d];
        x[s] += rq;
        if (rwkv) rq += sm.gq[s][d];
      }
    }
    // the carry written (j < s) and the chunk's decay (every s)
    float pk = 0.f;
    const float gdc = sm.gdc[d];
#pragma unroll
    for (int s = 0; s < CMAX; ++s) {
      const long long row = row0 + s;
      if (s < C) {
        const float dlw = x[s] + pk + gdc;
        pk += sm.gk[s][d];
        if (row < p.S && d < p.Dk)
          p.dw[((b * (long long)p.S + row) * p.H + h) * p.Dk + d] =
              dlw / sm.w[s][d];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (d): du, the partials in (batch, chunk) order
// ---------------------------------------------------------------------------

__global__ void scan_bwd_du_kernel(const BwdParams p) {
  const int h = blockIdx.x, d = threadIdx.x;
  if (d >= p.Dk) return;
  float acc = 0.f;
  for (int b = 0; b < p.B; ++b) {
    const float* part = p.dup + ((long long)b * p.H + h) * p.N * p.Dk + d;
    for (int n = 0; n < p.N; ++n) acc += part[(long long)n * p.Dk];
  }
  p.du[h * p.Dk + d] = acc;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int DT, int DKP>
static int launch_typed(const BwdParams& p, cudaStream_t st) {
  static bool configured = false;   // the attribute is per function
  const int smem = (int)sizeof(ChunkSmem<DKP>);
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        scan_bwd_chunk_kernel<DT, DKP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 carry((p.Dv + ES - 1) / ES, p.H, 2 * p.B);
  scan_bwd_carry_kernel<DT, DKP><<<carry, CARRY_THREADS, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 chunks(p.N, p.H, p.B);
  scan_bwd_chunk_kernel<DT, DKP><<<chunks, CHUNK_THREADS, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (p.rwkv) scan_bwd_du_kernel<<<p.H, 64, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <int DT>
static int launch_dk(const BwdParams& p, cudaStream_t st) {
  if (p.Dk <= 16) return launch_typed<DT, 16>(p, st);
  if (p.Dk <= 32) return launch_typed<DT, 32>(p, st);
  return launch_typed<DT, 64>(p, st);
}

// strides: q_b, q_s, q_h, k_*, v_*, w_*, do_* in elements (the last dim
// contiguous); w, u, s0, dsf fp32, u contiguous [H, Dk] (ignored when rwkv
// is 0), s0 / dsf contiguous [B, H, Dk, Dv] or null; st, dst fp32
// [B, H, N, Dk, Dv] and dup fp32 [B, H, N, Dk] scratch (N = ceil(S / C)); dq, dk, dv written contiguous [B, S, H, D] in the inputs' dtype, dw
// fp32 contiguous [B, S, H, Dk], du fp32 [H, Dk] (rwkv), ds0 fp32
// [B, H, Dk, Dv] when not null
extern "C" int linear_scan_bwd_launch(
    const void* q, const void* k, const void* v, const void* w,
    const void* u, const void* dout, const void* s0, const void* dsf,
    void* st, void* dst, void* dup, void* dq, void* dk, void* dv, void* dw,
    void* du, void* ds0, int dtype, int B, int S, int H, int Dk, int Dv,
    int C, int rwkv, const long long* strides, void* stream) {
  if (Dk < 1 || Dk > 64 || Dv < 1 || C < 1 || C > CMAX || S < 1 || B < 1
      || 2LL * B > 65535 || H < 1 || H > 65535
      || (rwkv && (u == nullptr || dup == nullptr || du == nullptr)))
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.dsf = static_cast<const float*>(dsf);
  p.st = static_cast<float*>(st);
  p.dst = static_cast<float*>(dst);
  p.dup = static_cast<float*>(dup);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.dw = static_cast<float*>(dw);
  p.du = static_cast<float*>(du);
  p.ds0 = static_cast<float*>(ds0);
  p.B = B; p.S = S; p.H = H; p.Dk = Dk; p.Dv = Dv; p.C = C;
  p.N = (S + C - 1) / C; p.rwkv = rwkv;
  p.qb = strides[0]; p.qs = strides[1]; p.qh = strides[2];
  p.kb = strides[3]; p.ks = strides[4]; p.kh = strides[5];
  p.vb = strides[6]; p.vs = strides[7]; p.vh = strides[8];
  p.wb = strides[9]; p.ws = strides[10]; p.wh = strides[11];
  p.ob = strides[12]; p.os = strides[13]; p.oh = strides[14];
  cudaStream_t stm = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) return launch_dk<DT_BF16>(p, stm);
  if (dtype == DT_F32) return launch_dk<DT_F32>(p, stm);
  return (int)cudaErrorInvalidValue;
}
