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
// triangle); its plain version is ref.py::linear_scan_bwd_ref.
//
// The work is fork-join, like the forward's:
//  (a) the forward chain: per (batch, head, value tile) a serial pass over
//      the chunks that recomputes the chunk-start carries
//          S_{n+1} = exp(lbc) S_n + (k exp(lbc - lb))^T v
//      from S_0 = init (or 0);
//  (b) the reverse chain (the same launch, blockIdx.z >= B): a serial pass
//      from the end carrying the carry's gradient
//          dS_n = exp(lbc) dS_{n+1} + (q exp(lbq))^T do
//      from dS_N = the final carry's cotangent (or 0), and dS_0 out when
//      the forward took an initial carry;
//  (c) the fork: every chunk's dq, dk, dv, dw and its share of du from its
//      own rows, S_n and dS_{n+1};
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
// entries are never multiplied.
//
// Deterministic: no atomics; every sum runs in a fixed order, and a row's
// results depend on its own (batch, head) alone; du is the one sum over
// batch and time, taken in (batch, chunk) order.
//
// What bounds it on the H100: at the RWKV6-7B train shape (B = 2, S =
// 2048, 64 heads of 64, bf16) the function moves q, k, v, do in and dq,
// dk, dv out (bf16) and w in, dw out (fp32), 369 MB, against ~14 GFLOP of
// chunk products: bytes-bound (110 us at 3.35 TB/s).  In fp32 FMAs the
// products alone would take 0.21 ms (67 TFLOP/s), and a workspace of every
// chunk's carry and its gradient (2 x 268 MB, written and read) 0.32 ms.
//
// bf16 design (q/k/v bf16; w, u, the carries fp32):
//  * Tensor cores: every product is mma.sync m16n8k16 (bf16 operands, fp32
//    accumulators); a chunk's 16 rows are the m16 tile.  The carries stay
//    fp32 in accumulator registers and are rounded to bf16 only as an
//    operand; dlog w's pair sums and exp(lbc) sum_e dS_{n+1} S_n stay fp32,
//    from fp32 carries and fp32 factors.
//  * The chains on the tensor cores: a carry is [Dk = 64 rows] x [64 value
//    columns], each of four warps holding 16 rows (8 m16n8 accumulators).
//    A chunk's step scales the accumulators by 2^lbc and adds x^T y as one
//    k16 mma per 8 columns (x = k 2^(lbc - lb) and y = v forward; x = q
//    2^lbq and y = do reverse), read from the row-major tiles by
//    ldmatrix.trans.  Both kernels step through carry_prep and carry_step,
//    so a recomputed carry has the chain's bits.
//  * Checkpoints: the chain kernel stores the carry only every G chunks
//    (kernel.py::plan_bwd; G = 4): S_{gG} and dS_{min(gG + G, N)} for group
//    g, two fp32 workspaces [B, H, ceil(N / G), Dk, Dv] (2 x 67 MB at the
//    train shape, from 2 x 268).  The chain's step stays one chunk, so a
//    split of the sequence on any chunk boundary meets the same steps.
//  * scan_bwd_chain_bf16_kernel, one block per (value tile, head, batch x
//    direction), 4 prep warps and 4 serial warps: per batch of 4 chunks
//    each prep warp lands one chunk's rows by 16-byte cp.async (read in
//    place through the strides; 3 batches in flight: loading, prepped,
//    stepping) and computes its operands in place (lg2 / ex2 per element,
//    each lane owning two key columns of all 16 rows); the serial warps
//    step through the 4 chunks and store the checkpoints.  256 blocks at
//    the train shape, 2 an SM (104 KB of shared memory).
//  * scan_bwd_chunk_bf16_kernel, one block of 4 warps per (chunk, head,
//    batch): its rows and those of the other chunks of its group by
//    cp.async; one warp per neighbour chunk preps its chain operands, one
//    warp the chunk's prefix sums and bonus; then the checkpoints into
//    registers, S_n stepped forward from S_{gG} and dS_{n+1} back from the
//    group's end (at most G - 1 steps each, the two chains interleaved),
//    exp(lbc) sum_e dS_{n+1} S_n from the fp32 accumulators, and both
//    carries staged as bf16 operands in the neighbours' space.  Then dA =
//    do v^T (every warp, from the same fragments), do S_n^T and v
//    dS_{n+1}^T (each warp its 16 key columns), dv = A^T do + kE dS_{n+1}
//    (each warp 16 value columns); dA kt, and dA^T qt with dA^T
//    transposed in registers (movmatrix); the elementwise epilogue and
//    dlog w's scans by key column (fp32), two threads a column.  53 KB of
//    shared memory and 128 registers: 4 blocks an SM.  Dv past 64 takes
//    an instantiation that loops over value tiles (WIDE), reloading and
//    prepping the neighbours per tile.
//  What bounds it: latency, not bytes.  A block waits for its rows and
//    checkpoints (71 KB, mostly L2 hits), then runs short phases between
//    barriers (the neighbours' prep, the chains, the products, the fp32
//    epilogue and scans); 16 warps an SM hide part of it.  A build with
//    -DSCAN_BWD_PHASES records clock64 at the phase boundaries
//    (chip_smoke.py --scan-bwd-phases).
// Every sum runs in a fixed order inside one block, so a row's result
// never depends on B or on the other rows of the batch.
//
// fp32 design (q/k/v fp32): plain FMAs in full fp32 (the tolerance of
// 1e-4 admits no bf16 or TF32 operand), every chunk's carries in the
// workspaces (G = 1): carry_kernel, per (batch, head, 32 value columns)
// each thread 16 carry entries in registers; chunk_kernel, one block per
// (chunk, head, batch) over fp32 shared-memory tiles.
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
  float* st;           // workspace: S_{gG} at g        [B, H, NG, Dk, Dv]
  float* dst;          // workspace: dS_{min(gG+G, N)} [B, H, NG, Dk, Dv]
  float* dup;          // du's partials [B, H, N, Dk] (RWKV6)
  void* dq;
  void* dk;
  void* dv;
  float* dw;
  float* du;           // [H, Dk] (RWKV6)
  float* ds0;          // [B, H, Dk, Dv] or null
  int B, S, H, Dk, Dv, C, N, rwkv;
  int G, NG;           // checkpoint interval (fp32: 1) and groups
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, wb, ws, wh, ob, os, oh;
};

// the FMA kernels' element type (fp32 only: bf16 takes the tensor cores)
template <int DT> struct Elem;
template <> struct Elem<DT_F32> { using T = float; };

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ void stf(float* p, float x) { *p = x; }

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
// bf16: tensor cores (mma.sync m16n8k16), checkpointed carries
// ---------------------------------------------------------------------------

constexpr int TC_D = 64;           // Dk padded to 64; value columns a tile
constexpr int LDB = 72;            // bf16 row stride of a [16][64] tile: 144 B,
                                   // eight ldmatrix rows on distinct banks
constexpr int LDE = 72;            // fp32 row stride of the epilogue's tiles
constexpr int MAX_GROUP = 4;       // the checkpoint interval G at most
constexpr float CLAMP2 = EXP_CLAMP * 1.4426950408889634f;   // 80 / ln 2

// One chunk's rows as read, [16][64] each (rows past the chunk or S zero,
// key columns past Dk zero with w = 1).  carry_prep turns x into the
// chain's operand and w's row 0 into the chunk's decay, in place.
struct RawChunk {
  __nv_bfloat16 x[CMAX * LDB];   // k (forward) or q (reverse)
  __nv_bfloat16 y[CMAX * LDB];   // v (forward) or do (reverse): a value tile
  float w[CMAX * TC_D];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 16 bytes global -> shared, asynchronously; bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// four 8x8 bf16 matrices from shared memory, plain or transposed
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4],
                                      const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a) : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4],
                                       const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a) : "memory");
}
// this lane's row address for ldsm4 / ldsm4t of the 16 x 16 block at (r0,
// c0) of a [.][LDB] tile M.  ldsm4 gives the A fragment of M (rows m, cols
// k), whose (0, 2) / (1, 3) are B fragments of M^T (8 rows each);
// ldsm4t gives B fragments of M (k rows, n cols): (0, 1) for columns c0 ..
// c0 + 7, (2, 3) for c0 + 8 .., and (0, 2, 1, 3) is the A fragment of M^T.
__device__ __forceinline__ const __nv_bfloat16* frag(
    const __nv_bfloat16* m, int r0, int c0, int lane) {
  return m + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDB + c0
         + 8 * (lane >> 4);
}

// d += a b: m16n8k16, bf16 operands, fp32 accumulate.  Fragments (g = lane
// / 4, c = lane % 4): a = A[g][2c..], A[g+8][2c..], A[g][2c+8..],
// A[g+8][2c+8..]; b = B[2c..][g], B[2c+8..][g]; d = D[g][2c], D[g][2c+1],
// D[g+8][2c], D[g+8][2c+1].
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the A fragment of a 16 x 16 block held as two m16n8 accumulators
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// Rows [0, 16) of a bf16 matrix (row stride rs elements) into a [16][LDB]
// tile: rows from `rows` on and columns from `cols` on zero.  fast: 16-byte
// cp.async (the caller checked alignment and that 64 columns exist); else
// element loads.
__device__ __forceinline__ void load_bf16(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int rows, int cols,
                                          bool fast, int tid, int nthr) {
  if (fast) {
    for (int i = tid; i < CMAX * 8; i += nthr) {
      const int t = i >> 3, j = i & 7;
      const bool in = t < rows;
      cp_async16(dst + t * LDB + 8 * j, in ? src + t * rs + 8 * j : src,
                 in ? 16 : 0);
    }
    return;
  }
  for (int i = tid; i < CMAX * TC_D; i += nthr) {
    const int t = i >> 6, d = i & 63;
    dst[t * LDB + d] = (t < rows && d < cols) ? src[t * rs + d]
                                              : __float2bfloat16(0.f);
  }
}
// the same for w ([16][64] fp32): past `rows` zero on the fast path (read
// as 1 by the prefix sums, which stop at the chunk's rows), past `cols` 1
__device__ __forceinline__ void load_w(float* dst, const float* src,
                                       long long rs, int rows, int cols,
                                       bool fast, int tid, int nthr) {
  if (fast) {
    for (int i = tid; i < CMAX * 16; i += nthr) {
      const int t = i >> 4, j = i & 15;
      const bool in = t < rows;
      cp_async16(dst + t * TC_D + 4 * j, in ? src + t * rs + 4 * j : src,
                 in ? 16 : 0);
    }
    return;
  }
  for (int i = tid; i < CMAX * TC_D; i += nthr) {
    const int t = i >> 6, d = i & 63;
    dst[t * TC_D + d] = (t < rows && d < cols) ? src[t * rs + d] : 1.f;
  }
}

// One chunk's chain operands, in place, by one warp (each lane owns key
// columns lane and lane + 32 of all 16 rows): x becomes k 2^(lbc - lb)
// (forward) or q 2^lbq (reverse) in bf16, w's row 0 becomes 2^lbc.  lb is
// the inclusive prefix sum of log2 w over the chunk's `valid` rows, lbc its
// value at row C - 1.
__device__ __forceinline__ void carry_prep(RawChunk& r, int lane, int C,
                                           int valid, bool rev, bool rwkv) {
  float lb[2][CMAX], run[2] = {0.f, 0.f}, lbc[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < CMAX; ++t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      run[i] += lg2(t < valid ? r.w[t * TC_D + lane + 32 * i] : 1.f);
      lb[i][t] = run[i];
      if (t == C - 1) lbc[i] = run[i];
    }
  }
#pragma unroll
  for (int t = 0; t < CMAX; ++t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float e = rev ? (rwkv ? (t ? lb[i][t - 1] : 0.f) : lb[i][t])
                          : lbc[i] - lb[i][t];
      __nv_bfloat16* x = r.x + t * LDB + lane + 32 * i;
      *x = __float2bfloat16(__bfloat162float(*x) * ex2(e));
    }
  }
  r.w[lane] = ex2(lbc[0]);
  r.w[lane + 32] = ex2(lbc[1]);
}

// One chunk's step of the carry rows d0 .. d0 + 15 that a warp holds (fp32
// accumulators over 64 value columns: s[nt] is rows g, g + 8, columns 8 nt
// + 2c, + 1): s = 2^lbc s + x^T y, one k16 mma per 8 columns.  The chain
// kernel and the chunk kernel's recompute both step through here.
__device__ __forceinline__ void carry_step(float (&s)[8][4],
                                           const RawChunk& r, int d0,
                                           int lane) {
  const int g = lane >> 2;
  uint32_t t4[4];
  ldsm4t(t4, frag(r.x, 0, d0, lane));
  const uint32_t a[4] = {t4[0], t4[2], t4[1], t4[3]};   // x^T: m d, k t
  const float dc0 = r.w[d0 + g], dc1 = r.w[d0 + g + 8];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    uint32_t b[4];
    ldsm4t(b, frag(r.y, 0, 16 * p, lane));               // y: k t, n e
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float (&acc)[4] = s[2 * p + hh];
      acc[0] *= dc0;
      acc[1] *= dc0;
      acc[2] *= dc1;
      acc[3] *= dc1;
      mma16816(acc, a, b[2 * hh], b[2 * hh + 1]);
    }
  }
}

// a warp's carry rows d0 .. d0 + 15, value columns e0 .., from or to an fp32
// [Dk][Dv] plane (entries past Dk or Dv: 0, or skipped); a null plane is 0
__device__ __forceinline__ void carry_load(float (&s)[8][4], const float* pl,
                                           int d0, int e0, int Dk, int Dv,
                                           int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int d = d0 + g + 8 * hh, e = e0 + 8 * nt + 2 * c;
      float2 x = make_float2(0.f, 0.f);
      if (pl && d < Dk) {
        const float* src = pl + (long long)d * Dv + e;
        if (!(Dv & 1) && e + 1 < Dv) {
          x = *reinterpret_cast<const float2*>(src);
        } else {
          if (e < Dv) x.x = src[0];
          if (e + 1 < Dv) x.y = src[1];
        }
      }
      s[nt][2 * hh] = x.x;
      s[nt][2 * hh + 1] = x.y;
    }
  }
}
__device__ __forceinline__ void carry_store(float* pl, const float (&s)[8][4],
                                            int d0, int e0, int Dk, int Dv,
                                            int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int d = d0 + g + 8 * hh, e = e0 + 8 * nt + 2 * c;
      if (d >= Dk) continue;
      float* dst = pl + (long long)d * Dv + e;
      if (!(Dv & 1) && e + 1 < Dv) {
        *reinterpret_cast<float2*>(dst) =
            make_float2(s[nt][2 * hh], s[nt][2 * hh + 1]);
      } else {
        if (e < Dv) dst[0] = s[nt][2 * hh];
        if (e + 1 < Dv) dst[1] = s[nt][2 * hh + 1];
      }
    }
  }
}

// ---- (a), (b): the chains, checkpointed every G chunks ---------------------

constexpr int CH_PREP = 4;         // prep warps = chunks a batch
constexpr int CH_SER = 4;          // serial warps: 16 carry rows each
constexpr int CH_BUF = 3;          // batches: stepping, prepped, loading
constexpr int CH_THREADS = 32 * (CH_PREP + CH_SER);

struct ChainSmem {
  RawChunk r[CH_BUF][CH_PREP];     // 104,448 bytes
};

__global__ void __launch_bounds__(CH_THREADS, 2)
scan_bwd_chain_bf16_kernel(const BwdParams p, const bool fast) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChainSmem& sm = *reinterpret_cast<ChainSmem*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool rev = blockIdx.z >= (unsigned)p.B;
  const int b = rev ? blockIdx.z - p.B : blockIdx.z;
  const int h = blockIdx.y, e0 = blockIdx.x * TC_D;
  const int C = p.C, N = p.N, G = p.G, NG = p.NG;
  // the chunks this half steps through, in order: forward 0 .. (NG - 1) G
  // - 1 (S_{(NG-1)G} is the last checkpoint); reverse N - 1 down to 0 when
  // dS_0 is asked for, else down to G (dS_G is group 0's checkpoint)
  const int NP = rev ? (p.ds0 ? N : N - min(G, N)) : (NG - 1) * G;
  const __nv_bfloat16* x =
      static_cast<const __nv_bfloat16*>(rev ? p.q : p.k)
      + b * (rev ? p.qb : p.kb) + h * (rev ? p.qh : p.kh);
  const long long xs = rev ? p.qs : p.ks;
  const __nv_bfloat16* y =
      static_cast<const __nv_bfloat16*>(rev ? p.dout : p.v)
      + b * (rev ? p.ob : p.vb) + h * (rev ? p.oh : p.vh) + e0;
  const long long ys = rev ? p.os : p.vs;
  const float* w = p.w + b * p.wb + h * p.wh;
  const long long plane = (long long)p.Dk * p.Dv;
  const long long sbase = ((long long)b * p.H + h) * plane;
  float* ws = (rev ? p.dst : p.st) + ((long long)b * p.H + h) * NG * plane;

  if (warp < CH_PREP) {
    // ------------------------------------------------------------- prep
    auto slot = [&](int i) -> RawChunk& {
      return sm.r[(i / CH_PREP) % CH_BUF][warp];
    };
    auto fill = [&](int i) {   // step i's rows, one commit group
      if (i < NP) {
        const int n = rev ? N - 1 - i : i;
        const long long row0 = (long long)n * C;
        const int valid = min(C, p.S - n * C);
        RawChunk& r = slot(i);
        load_bf16(r.x, x + row0 * xs, xs, valid, p.Dk, fast, lane, 32);
        load_bf16(r.y, y + row0 * ys, ys, valid, p.Dv - e0, fast, lane, 32);
        load_w(r.w, w + row0 * p.ws, p.ws, valid, p.Dk, fast, lane, 32);
      }
      cp_async_commit();
    };
    auto prep = [&](int i) {
      cp_async_wait<1>();
      __syncwarp();
      if (i < NP) {
        const int n = rev ? N - 1 - i : i;
        carry_prep(slot(i), lane, C, min(C, p.S - n * C), rev, p.rwkv);
      }
    };
    fill(warp);
    fill(CH_PREP + warp);
    prep(warp);
    __syncthreads();
    for (int k = 0; k < (NP + CH_PREP - 1) / CH_PREP; ++k) {
      fill(CH_PREP * (k + 2) + warp);
      prep(CH_PREP * (k + 1) + warp);
      __syncthreads();
    }
    cp_async_wait<0>();
    return;
  }

  // --------------------------------------------------------------- serial
  const int d0 = 16 * (warp - CH_PREP);
  float s[8][4];
  carry_load(s, rev ? (p.dsf ? p.dsf + sbase : nullptr)
                    : (p.s0 ? p.s0 + sbase : nullptr),
             d0, e0, p.Dk, p.Dv, lane);
  // before step i: the carry entering chunk n (forward) or the gradient of
  // the one leaving it (reverse); store it where it is a checkpoint
  auto checkpoint = [&](int i) {
    const int n = rev ? N - 1 - i : i;
    const bool at = rev ? (n >= 0 && (n == N - 1 || (n + 1) % G == 0))
                        : n % G == 0;
    if (at) carry_store(ws + (n / G) * plane, s, d0, e0, p.Dk, p.Dv, lane);
  };
  __syncthreads();
  for (int k = 0; k < (NP + CH_PREP - 1) / CH_PREP; ++k) {
#pragma unroll 1
    for (int j = 0; j < CH_PREP; ++j) {
      const int i = CH_PREP * k + j;
      if (i >= NP) break;
      checkpoint(i);
      carry_step(s, sm.r[k % CH_BUF][j], d0, lane);
    }
    __syncthreads();
  }
  checkpoint(NP);
  if (rev && p.ds0) carry_store(p.ds0 + sbase, s, d0, e0, p.Dk, p.Dv, lane);
}

// ---- (c): every chunk's gradients ------------------------------------------

constexpr int CK_THREADS = 128;    // 4 warps: 16 carry rows / key columns /
                                   // value columns each

// The 8x8 bf16 block a warp holds as fragments (thread (g, c): row g,
// columns 2c, 2c + 1), transposed in registers.
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(y) : "r"(x));
  return y;
}

struct ChunkTcSmem {
  // the group's other chunks (the carries' recompute); then S_n and
  // dS_{n+1} as bf16 operands ([d][e], TC_D x LDB each); after the value
  // tiles the epilogue's fp32 tiles: dA kt, dA^T qt, do S_n^T, v dS^T,
  // later qt, kt, q 2^lbq (do S_n^T), k 2^(lbc - lb) (v dS^T) ([16][LDE])
  alignas(16) unsigned char nb[(MAX_GROUP - 1) * sizeof(RawChunk)];
  __nv_bfloat16 q[CMAX * LDB], k[CMAX * LDB];
  __nv_bfloat16 v[CMAX * LDB], o[CMAX * LDB];   // the value tile's v, do
  float w[CMAX * TC_D];
  __nv_bfloat16 qt[CMAX * LDB], kt[CMAX * LDB], ke[CMAX * LDB];
  float lb[CMAX * TC_D];           // then the other half's pair sums
  float da[CMAX][CMAX + 1];        // masked dA
  float dbon[CMAX], bon[CMAX];
  float mid[TC_D], lbc[TC_D], gdc[TC_D], du[2][TC_D];
};
static_assert(4 * CMAX * LDE * sizeof(float)
              <= (MAX_GROUP - 1) * sizeof(RawChunk)
              && 2 * TC_D * LDB * sizeof(__nv_bfloat16)
              <= (MAX_GROUP - 1) * sizeof(RawChunk), "staging fits");

#ifdef SCAN_BWD_PHASES
// clock64 at the chunk kernel's phase boundaries, per block (a measurement
// build: chip_smoke.py --scan-bwd-phases); the last call's survive
constexpr long long PHASE_SLOTS = 10, PHASE_CAP = 1 << 20;
__device__ long long g_phases[PHASE_CAP];
#define PHASE(i)                                                          \
  do {                                                                    \
    const long long blk_ = blockIdx.x                                     \
        + (long long)gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);   \
    if (threadIdx.x == 0 && blk_ * PHASE_SLOTS + (i) < PHASE_CAP)         \
      g_phases[blk_ * PHASE_SLOTS + (i)] = clock64();                     \
  } while (0)
extern "C" int linear_scan_bwd_phases(void* dst, long long n) {
  return (int)cudaMemcpyFromSymbol(dst, g_phases,
                                   min(n, PHASE_CAP) * sizeof(long long));
}
#else
#define PHASE(i) do {} while (0)
#endif

// WIDE: Dv past one 64-column value tile (the tiles' sums carried across a
// loop); else one tile and no loop, so no sum outlives its phase
template <int WIDE>
__global__ void __launch_bounds__(CK_THREADS, WIDE ? 2 : 4)
scan_bwd_chunk_bf16_kernel(const BwdParams p, const bool fast) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkTcSmem& sm = *reinterpret_cast<ChunkTcSmem*>(smem_raw);
  RawChunk* nb = reinterpret_cast<RawChunk*>(sm.nb);
  __nv_bfloat16* sn = reinterpret_cast<__nv_bfloat16*>(sm.nb);   // S_n
  __nv_bfloat16* ds1 = sn + TC_D * LDB;                           // dS_{n+1}
  float* ep = reinterpret_cast<float*>(sm.nb);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C = p.C, N = p.N, G = p.G;
  const bool rwkv = p.rwkv;
  const int grp = n / G, g0 = grp * G, g1 = min(g0 + G, N);
  const int nf = n - g0, nn = g1 - g0 - 1;   // neighbours: nf before n
  const int valid = min(C, p.S - n * C);
  const int d0 = 16 * warp;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q)
                           + b * p.qb + h * p.qh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k)
                           + b * p.kb + h * p.kh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v)
                           + b * p.vb + h * p.vh;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout)
                              + b * p.ob + h * p.oh;
  const float* w = p.w + b * p.wb + h * p.wh;
  const long long plane = (long long)p.Dk * p.Dv;
  const long long ck = (((long long)b * p.H + h) * p.NG + grp) * plane;
  // neighbour j: chunk g0 + j (j < nf, the forward chain) or n + 1 + j - nf
  auto nb_chunk = [&](int j) { return j < nf ? g0 + j : n + 1 + j - nf; };
  PHASE(0);

  // the value tiles' sums, kept across tiles
  float dA[2][4] = {}, gq[2][4] = {}, gk[2][4] = {};
  float gdc[2] = {0.f, 0.f};
  uint32_t aT[4];   // mask(kt qt^T) with the bonus on its diagonal, as A
  for (int e0 = 0; WIDE ? e0 < p.Dv : e0 == 0; e0 += TC_D) {
    // -- rows: this chunk's (q, k, w once), the tile's, the neighbours'
    //    (their operands are prepped in place and their space reused, so
    //    a second value tile loads and preps them again) --
    {
      const long long r0 = (long long)n * C;
      if (e0 == 0) {
        load_bf16(sm.q, q + r0 * p.qs, p.qs, valid, p.Dk, fast, tid,
                  CK_THREADS);
        load_bf16(sm.k, k + r0 * p.ks, p.ks, valid, p.Dk, fast, tid,
                  CK_THREADS);
        load_w(sm.w, w + r0 * p.ws, p.ws, valid, p.Dk, fast, tid, CK_THREADS);
      }
      load_bf16(sm.v, v + r0 * p.vs + e0, p.vs, valid, p.Dv - e0, fast, tid,
                CK_THREADS);
      load_bf16(sm.o, dout + r0 * p.os + e0, p.os, valid, p.Dv - e0, fast,
                tid, CK_THREADS);
      for (int j = 0; j < nn; ++j) {
        const int m = nb_chunk(j);
        const bool fwd = j < nf;
        const long long rm = (long long)m * C;
        const int vm = min(C, p.S - m * C);
        load_bf16(nb[j].x, (fwd ? k : q) + rm * (fwd ? p.ks : p.qs),
                  fwd ? p.ks : p.qs, vm, p.Dk, fast, tid, CK_THREADS);
        load_w(nb[j].w, w + rm * p.ws, p.ws, vm, p.Dk, fast, tid, CK_THREADS);
        load_bf16(nb[j].y, (fwd ? v + rm * p.vs : dout + rm * p.os) + e0,
                  fwd ? p.vs : p.os, vm, p.Dv - e0, fast, tid, CK_THREADS);
      }
      cp_async_commit();
    }
    // the carries' checkpoints: S_{g0} and dS_{g1}
    float s[8][4], ds[8][4];
    carry_load(s, p.st + ck, d0, e0, p.Dk, p.Dv, lane);
    carry_load(ds, p.dst + ck, d0, e0, p.Dk, p.Dv, lane);
    cp_async_wait<0>();
    __syncthreads();
    PHASE(1);   // the rows have landed

    // -- the neighbours' chain operands (a warp each); this chunk's prefix
    //    sums, normalizer and bonus (warp 3, first tile) --
    if (warp < nn) {
      const int m = nb_chunk(warp);
      carry_prep(nb[warp], lane, C, min(C, p.S - m * C), warp >= nf, rwkv);
    } else if (warp == 3 && e0 == 0) {
      float part[CMAX], run[2] = {0.f, 0.f}, ud[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = lane + 32 * i;
        ud[i] = (rwkv && d < p.Dk) ? p.u[h * p.Dk + d] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < CMAX; ++t) {
        part[t] = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int d = lane + 32 * i;
          run[i] += lg2(t < valid ? sm.w[t * TC_D + d] : 1.f);
          sm.lb[t * TC_D + d] = run[i];
          if (t == C / 2) sm.mid[d] = run[i];
          if (t == C - 1) sm.lbc[d] = run[i];
          part[t] = fmaf(__bfloat162float(sm.q[t * LDB + d]) * ud[i],
                         __bfloat162float(sm.k[t * LDB + d]), part[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < CMAX; ++t) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part[t] += __shfl_xor_sync(0xffffffffu, part[t], o);
      }
      if (lane < CMAX) {
        float bt = 0.f;
#pragma unroll
        for (int t = 0; t < CMAX; ++t)
          if (t == lane) bt = part[t];
        sm.bon[lane] = bt;
      }
    }
    __syncthreads();
    PHASE(2);   // the operands of the chains are prepped
    if (e0 == 0) {
      // -- this chunk's bf16 operands qt, kt, k 2^(lbc - lb) --
#pragma unroll
      for (int i = 0; i < CMAX * TC_D / CK_THREADS; ++i) {
        const int idx = tid + CK_THREADS * i, t = idx >> 6, d = idx & 63;
        const float lb = sm.lb[t * TC_D + d];
        const float lbq = rwkv ? (t ? sm.lb[(t - 1) * TC_D + d] : 0.f) : lb;
        const float md = sm.mid[d];
        const float qf = __bfloat162float(sm.q[t * LDB + d]);
        const float kf = __bfloat162float(sm.k[t * LDB + d]);
        sm.qt[t * LDB + d] = __float2bfloat16(
            qf * ex2(fminf(lbq - md, CLAMP2)));
        sm.kt[t * LDB + d] = __float2bfloat16(
            kf * ex2(fminf(md - lb, CLAMP2)));
        sm.ke[t * LDB + d] = __float2bfloat16(kf * ex2(sm.lbc[d] - lb));
      }
    }
    // -- S_n forward from S_{g0}, dS_{n+1} back from dS_{g1} --
    for (int j = 0; j < nf || j < nn - nf; ++j) {   // the two chains overlap
      if (j < nf) carry_step(s, nb[j], d0, lane);
      if (j < nn - nf) carry_step(ds, nb[nn - 1 - j], d0, lane);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {              // sum_e dS_{n+1} S_n, fp32
      gdc[0] += ds[nt][0] * s[nt][0] + ds[nt][1] * s[nt][1];
      gdc[1] += ds[nt][2] * s[nt][2] + ds[nt][3] * s[nt][3];
    }
    __syncthreads();   // the neighbours are read: their space takes the
                       // carries as bf16 operands, [d][e]
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int at = (d0 + g + 8 * hh) * LDB + 8 * nt + 2 * c;
        *reinterpret_cast<uint32_t*>(sn + at) =
            pack_bf16(s[nt][2 * hh], s[nt][2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(ds1 + at) =
            pack_bf16(ds[nt][2 * hh], ds[nt][2 * hh + 1]);
      }
    }
    __syncthreads();
    PHASE(3);   // S_n and dS_{n+1} are stepped and staged

    if (e0 == 0) {
      // A^T = mask(kt qt^T) (m j, n t), the RWKV6 bonus on its diagonal;
      // masked entries selected away, never multiplied
      float at[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < TC_D / 16; ++ks) {
        uint32_t ka[4], qb[4];
        ldsm4(ka, frag(sm.kt, 0, 16 * ks, lane));
        ldsm4(qb, frag(sm.qt, 0, 16 * ks, lane));
        mma16816(at[0], ka, qb[0], qb[2]);
        mma16816(at[1], ka, qb[1], qb[3]);
      }
#pragma unroll
      for (int tb = 0; tb < 2; ++tb) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = g + 8 * (i >> 1), t = 8 * tb + 2 * c + (i & 1);
          const bool keep = t < C && j < C && (rwkv ? j < t : j <= t);
          float val = keep ? at[tb][i] : 0.f;
          if (rwkv && j == t && t < C) val = sm.bon[t];
          at[tb][i] = val;
        }
      }
      acc_to_a(aT, at);
    }

    // -- the tile's products: dA = do v^T (every warp), do S_n^T and v
    //    dS_{n+1}^T (this warp's key columns) --
#pragma unroll
    for (int ks = 0; ks < TC_D / 16; ++ks) {
      uint32_t of[4], vf[4], sf[4], df[4];
      ldsm4(of, frag(sm.o, 0, 16 * ks, lane));   // do: m t, k e
      ldsm4(vf, frag(sm.v, 0, 16 * ks, lane));   // v:  m t, k e
      ldsm4(sf, frag(sn, d0, 16 * ks, lane));    // S_n^T: k e, n d
      ldsm4(df, frag(ds1, d0, 16 * ks, lane));   // dS^T:  k e, n d
      mma16816(dA[0], of, vf[0], vf[2]);
      mma16816(dA[1], of, vf[1], vf[3]);
      mma16816(gq[0], of, sf[0], sf[2]);
      mma16816(gq[1], of, sf[1], sf[3]);
      mma16816(gk[0], vf, df[0], df[2]);
      mma16816(gk[1], vf, df[1], df[3]);
    }
    // dv = A^T do + (k 2^(lbc - lb)) dS_{n+1}: this warp's 16 value columns
    {
      float acc[2][4] = {};
      uint32_t bo[4];
      ldsm4t(bo, frag(sm.o, 0, 16 * warp, lane));
      mma16816(acc[0], aT, bo[0], bo[1]);
      mma16816(acc[1], aT, bo[2], bo[3]);
#pragma unroll
      for (int ks = 0; ks < TC_D / 16; ++ks) {
        uint32_t ka[4], bd[4];
        ldsm4(ka, frag(sm.ke, 0, 16 * ks, lane));
        ldsm4t(bd, frag(ds1, 16 * ks, 16 * warp, lane));
        mma16816(acc[0], ka, bd[0], bd[1]);
        mma16816(acc[1], ka, bd[2], bd[3]);
      }
      __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv);
#pragma unroll
      for (int nb2 = 0; nb2 < 2; ++nb2) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = g + 8 * hh, e = e0 + 16 * warp + 8 * nb2 + 2 * c;
          if (t >= valid || e >= p.Dv) continue;
          __nv_bfloat16* dst =
              dvp + ((b * (long long)p.S + (long long)n * C + t) * p.H + h)
                        * p.Dv + e;
          if (!(p.Dv & 1) && e + 1 < p.Dv) {
            *reinterpret_cast<uint32_t*>(dst) =
                pack_bf16(acc[nb2][2 * hh], acc[nb2][2 * hh + 1]);
          } else {
            dst[0] = __float2bfloat16(acc[nb2][2 * hh]);
            if (e + 1 < p.Dv) dst[1] = __float2bfloat16(acc[nb2][2 * hh + 1]);
          }
        }
      }
    }
    __syncthreads();   // the tile's rows and the staged carries are read
    PHASE(4);   // the tile's products, dv written
  }

  // -- dA kt and dA^T qt (this warp's key columns); dbon, the mask --
  {
    float mA[2][4];
#pragma unroll
    for (int jb = 0; jb < 2; ++jb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = g + 8 * (i >> 1), j = 8 * jb + 2 * c + (i & 1);
        mA[jb][i] = (rwkv ? j < t : j <= t) ? dA[jb][i] : 0.f;
        if (warp == 0) {
          sm.da[t][j] = mA[jb][i];
          if (j == t) sm.dbon[t] = dA[jb][i];
        }
      }
    }
    uint32_t pa[4], bk[4], bq[4];
    acc_to_a(pa, mA);
    // dA^T as an A operand (m j, k t): the 8x8 blocks transposed in place
    const uint32_t pat[4] = {transpose8(pa[0]), transpose8(pa[2]),
                             transpose8(pa[1]), transpose8(pa[3])};
    float q2[2][4] = {}, k2[2][4] = {};
    ldsm4t(bk, frag(sm.kt, 0, d0, lane));    // kt: k j, n d
    ldsm4t(bq, frag(sm.qt, 0, d0, lane));    // qt: k t, n d
    mma16816(q2[0], pa, bk[0], bk[1]);
    mma16816(q2[1], pa, bk[2], bk[3]);
    mma16816(k2[0], pat, bq[0], bq[1]);
    mma16816(k2[1], pat, bq[2], bq[3]);
    // the epilogue's fp32 tiles (the neighbours' space, free now)
    auto stage = [&](int f, const float (&x)[2][4]) {
#pragma unroll
      for (int dn = 0; dn < 2; ++dn) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          *reinterpret_cast<float2*>(
              ep + f * CMAX * LDE + (g + 8 * hh) * LDE + d0 + 8 * dn + 2 * c) =
              make_float2(x[dn][2 * hh], x[dn][2 * hh + 1]);
        }
      }
    };
    stage(0, q2);
    stage(1, k2);
    stage(2, gq);
    stage(3, gk);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      gdc[i] += __shfl_xor_sync(0xffffffffu, gdc[i], 1);
      gdc[i] += __shfl_xor_sync(0xffffffffu, gdc[i], 2);
      if (c == 0) sm.gdc[d0 + g + 8 * i] = gdc[i];
    }
  }
  __syncthreads();
  PHASE(5);   // dA kt and dA^T qt staged

  // -- by key column, two threads a column (rows 8 hf .. 8 hf + 7): dq, dk;
  //    the fp32 terms of dlog w in place of the products --
  const int d = tid & 63, hf = tid >> 6, r0 = 8 * hf;
  const long long orow = (b * (long long)p.S + (long long)n * C) * p.H + h;
  float* eq_ = ep;                      // dA kt, then qt
  float* ek_ = ep + CMAX * LDE;         // dA^T qt, then kt
  float* eg = ep + 2 * CMAX * LDE;      // do S_n^T, then q 2^lbq (...)
  float* eh = ep + 3 * CMAX * LDE;      // v dS^T, then k 2^(lbc-lb) (...)
  {
    const float md = sm.mid[d], lc = sm.lbc[d];
    const float ud = (rwkv && d < p.Dk) ? p.u[h * p.Dk + d] : 0.f;
    float dus = 0.f;
#pragma unroll
    for (int r = 0; r < CMAX / 2; ++r) {
      const int t = r0 + r, at = t * LDE + d;
      const float lb = sm.lb[t * TC_D + d];
      const float lbq = rwkv ? (t ? sm.lb[(t - 1) * TC_D + d] : 0.f) : lb;
      const float fq = ex2(fminf(lbq - md, CLAMP2));
      const float fk = ex2(fminf(md - lb, CLAMP2));
      const float eqv = ex2(lbq), ekv = ex2(lc - lb);
      const float qf = __bfloat162float(sm.q[t * LDB + d]);
      const float kf = __bfloat162float(sm.k[t * LDB + d]);
      const float gqv = eg[at], gkv = eh[at];
      float dqv = eq_[at] * fq + gqv * eqv;
      float dkv = ek_[at] * fk + gkv * ekv;
      if (rwkv) {
        const float gg = sm.dbon[t] * ud;
        dqv += gg * kf;
        dkv += gg * qf;
        dus += sm.dbon[t] * qf * kf;
      }
      if (t < valid && d < p.Dk) {
        const long long off = (orow + (long long)t * p.H) * p.Dk + d;
        static_cast<__nv_bfloat16*>(p.dq)[off] = __float2bfloat16(dqv);
        static_cast<__nv_bfloat16*>(p.dk)[off] = __float2bfloat16(dkv);
      }
      eq_[at] = qf * fq;
      ek_[at] = kf * fk;
      eg[at] = (qf * eqv) * gqv;
      eh[at] = (kf * ekv) * gkv;
    }
    sm.du[hf][d] = dus;
  }
  __syncthreads();
  PHASE(6);   // dq, dk written

  // -- dlog w_s.  The triangle's pairs (t, j) reach s in (j, t) (GLA (j,
  //    t]), the even rows t summed on one thread, the odd on the other;
  //    each thread hands the other its partial sums of the other's rows --
  float x[CMAX];
  {
    float kt[CMAX];
#pragma unroll
    for (int j = 0; j < CMAX; ++j) {
      kt[j] = ek_[j * LDE + d];
      x[j] = 0.f;
    }
#pragma unroll
    for (int t = 1; t < CMAX; ++t) {
      if ((t & 1) == hf && t < C) {
        const float qt = eq_[t * LDE + d];
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
#pragma unroll
    for (int s = 0; s < CMAX; ++s)
      if ((s >> 3) != hf) sm.lb[s * TC_D + d] = x[s];
  }
  __syncthreads();
  PHASE(7);   // the pair sums of dlog w
  float xr[CMAX / 2];   // this thread's rows (indices fixed at compile time)
#pragma unroll
  for (int r = 0; r < CMAX / 2; ++r)
    xr[r] = (hf ? x[CMAX / 2 + r] : x[r]) + sm.lb[(r0 + r) * TC_D + d];
  // the carry read, t > s (GLA t >= s): from the end, the upper rows'
  // total first; the carry written, j < s: the lower rows' total first
  float rq = 0.f, pk = 0.f;
#pragma unroll
  for (int s = CMAX - 1; s >= CMAX / 2; --s)
    if (!hf && s < C) rq += eg[s * LDE + d];
#pragma unroll
  for (int s = 0; s < CMAX / 2; ++s)
    if (hf && s < C) pk += eh[s * LDE + d];
#pragma unroll
  for (int r = CMAX / 2 - 1; r >= 0; --r) {
    const int s = r0 + r;
    if (s < C) {
      if (!rwkv) rq += eg[s * LDE + d];
      xr[r] += rq;
      if (rwkv) rq += eg[s * LDE + d];
    }
  }
  const float gd = ex2(sm.lbc[d]) * sm.gdc[d];   // the chunk's decay
#pragma unroll
  for (int r = 0; r < CMAX / 2; ++r) {
    const int s = r0 + r;
    if (s < C) {
      const float dlw = xr[r] + pk + gd;
      pk += eh[s * LDE + d];
      if (s < valid && d < p.Dk)
        p.dw[(orow + (long long)s * p.H) * p.Dk + d] =
            __fdividef(dlw, sm.w[s * TC_D + d]);
    }
  }
  if (!hf && rwkv && d < p.Dk)
    p.dup[(((long long)b * p.H + h) * p.N + n) * p.Dk + d] =
        sm.du[0][d] + sm.du[1][d];
  PHASE(8);   // dw written
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

static int launch_bf16(const BwdParams& p, cudaStream_t st) {
  static bool configured = false;   // the attributes are per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        scan_bwd_chain_bf16_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(ChainSmem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          scan_bwd_chunk_bf16_kernel<0>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)sizeof(ChunkTcSmem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          scan_bwd_chunk_bf16_kernel<1>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)sizeof(ChunkTcSmem));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  // 16-byte copies: Dk = 64, whole 64-column value tiles, aligned rows
  const bool fast =
      p.Dk == TC_D && p.Dv % TC_D == 0
      && ((reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k)
           | reinterpret_cast<uintptr_t>(p.v)
           | reinterpret_cast<uintptr_t>(p.dout)
           | reinterpret_cast<uintptr_t>(p.w)) & 15) == 0
      && (p.qb | p.qs | p.qh | p.kb | p.ks | p.kh | p.vb | p.vs | p.vh | p.ob
          | p.os | p.oh) % 8 == 0
      && (p.wb | p.ws | p.wh) % 4 == 0;
  dim3 chain((p.Dv + TC_D - 1) / TC_D, p.H, 2 * p.B);
  scan_bwd_chain_bf16_kernel<<<chain, CH_THREADS, sizeof(ChainSmem), st>>>(
      p, fast);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 chunks(p.N, p.H, p.B);
  if (p.Dv > TC_D)
    scan_bwd_chunk_bf16_kernel<1><<<chunks, CK_THREADS, sizeof(ChunkTcSmem),
                                    st>>>(p, fast);
  else
    scan_bwd_chunk_bf16_kernel<0><<<chunks, CK_THREADS, sizeof(ChunkTcSmem),
                                    st>>>(p, fast);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (p.rwkv) scan_bwd_du_kernel<<<p.H, 64, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// strides: q_b, q_s, q_h, k_*, v_*, w_*, do_* in elements (the last dim
// contiguous); w, u, s0, dsf fp32, u contiguous [H, Dk] (ignored when rwkv
// is 0), s0 / dsf contiguous [B, H, Dk, Dv] or null; `group` chunks
// between two checkpoints (bf16 1 .. MAX_GROUP, fp32 1); st, dst fp32
// [B, H, ceil(N / group), Dk, Dv] and dup fp32 [B, H, N, Dk] scratch (N =
// ceil(S / C)); dq, dk, dv written contiguous [B, S, H, D] in the inputs'
// dtype, dw fp32 contiguous [B, S, H, Dk], du fp32 [H, Dk] (rwkv), ds0
// fp32 [B, H, Dk, Dv] when not null
extern "C" int linear_scan_bwd_launch(
    const void* q, const void* k, const void* v, const void* w,
    const void* u, const void* dout, const void* s0, const void* dsf,
    void* st, void* dst, void* dup, void* dq, void* dk, void* dv, void* dw,
    void* du, void* ds0, int dtype, int B, int S, int H, int Dk, int Dv,
    int C, int rwkv, int group, const long long* strides, void* stream) {
  if (Dk < 1 || Dk > 64 || Dv < 1 || C < 1 || C > CMAX || S < 1 || B < 1
      || 2LL * B > 65535 || H < 1 || H > 65535
      || (rwkv && (u == nullptr || dup == nullptr || du == nullptr))
      || group < 1 || group > (dtype == DT_BF16 ? MAX_GROUP : 1))
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
  p.G = group; p.NG = (p.N + group - 1) / group;
  p.qb = strides[0]; p.qs = strides[1]; p.qh = strides[2];
  p.kb = strides[3]; p.ks = strides[4]; p.kh = strides[5];
  p.vb = strides[6]; p.vs = strides[7]; p.vh = strides[8];
  p.wb = strides[9]; p.ws = strides[10]; p.wh = strides[11];
  p.ob = strides[12]; p.os = strides[13]; p.oh = strides[14];
  cudaStream_t stm = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) return launch_bf16(p, stm);
  if (dtype == DT_F32) return launch_dk<DT_F32>(p, stm);
  return (int)cudaErrorInvalidValue;
}
