// Chunked gated linear-attention scan (RWKV6 / GLA) for NVIDIA Hopper
// (sm_90a), with an optional carried state.
//
// Replaces the TPU kernel src/repro/kernels/linear_scan/kernel.py:70
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
// Exact in fp32 for C <= 21 at the RWKV6 decay clip (log w >= -e^2); the
// wrapper takes C <= 16 (SAFE_CHUNK).  The carry S0 starts at zero or at
// the caller's state [B, H, Dk, Dv] (fp32), and the final carry can be
// written out (fp32): the stateful RWKV6 step (prefill, decode) is the
// same scan as the forward's, continued from a cache.
//
// What bounds it on the H100: at the RWKV6-7B forward's shape (B=2,
// S=2048, 64 heads of 64) q/k/v/o in bf16 and w in fp32 are 201 MB against
// about 4 GFLOP of chunked products, so the bytes bound it (60.1 us at
// 3.35 TB/s).  The work is a serial chain of 128 chunks per (batch, head),
// and only 128 (batch, head) pairs exist for 132 SMs, so the chain has to
// run at about 0.47 us a chunk.
//
// bf16 design (q/k/v bf16; w, u, the state fp32).  One block of 8 warps
// per (64 value columns, head, batch):
//  * The carry-independent work of a chunk runs off the serial path, in
//    four "prep" warps, each owning every fourth chunk and one stage of a
//    4-deep ring in shared memory.  A prep warp keeps its next chunk in
//    flight while it computes this one: 16-byte cp.async copies of the
//    rows, read in place through their strides, into a 2-slot ring of its
//    own (20 KB a warp; rows past the chunk or S zero-filled).  Each lane
//    owns key/value columns lane and lane + 32 of all 16 rows: log2 w
//    (lg2.approx) and the prefix sums run in registers (no barrier, no
//    shuffle), the four
//    factors with ex2.approx (the clamp of 80 carried over as 80 / ln 2):
//    each transcendental once per element per block, rounded to bf16 as
//    tensor-core operands; the score block A = qt kt^T is two m16n8k16
//    mma.sync chains over Dk; masked entries are selected away (never
//    multiplied, so a saturated factor cannot meet v) and the RWKV6 bonus
//    q.u.k (fp32, shuffled across the warp) is A's diagonal.  The stage
//    gets A, q 2^lbq, (k 2^(lbc - lb))^T, v^T and 2^lbc.
//  * Four "serial" warps each hold 16 value columns of the carry,
//    transposed (S^T, 16 x 64 fp32), in mma accumulator registers for the
//    whole sequence.  Per chunk: o^T = v^T A^T + S^T (q 2^lbq)^T (10 mma;
//    the accumulator layout of S^T is the A-operand layout, so the carry
//    is rounded to bf16 only here, in registers), then S^T = 2^lbc o S^T
//    + v^T (k 2^(lbc-lb)) (8 mma accumulating onto the scaled carry).
//    o is staged per warp through shared memory and written 16 bytes a
//    lane.  Named barriers pass each stage between its prep warp and the
//    serial warps (full / empty, 160 threads).
//  * Grid (ceil(Dv / 64), H, B): the forward's 128 (batch, head) pairs
//    fill 128 of the 132 SMs with one block each; a split of Dv would
//    repeat the prep work per slice.
// Every sum runs in a fixed order inside one block, so a row's result
// never depends on B or on the other rows of the batch.
//
// fp32 design (q/k/v fp32): plain FMAs in full fp32 (the tolerance of
// 1e-4 admits no bf16 or TF32 operand), accurate logf/expf, the carry's
// column slice in shared memory; grid (Dv / 32, H, B).
//
// Reads q, k, v, w as [B, S, H, D] through their strides (the last dim
// contiguous; no moveaxis, no padding in memory: rows past S act as w = 1,
// q = k = v = 0, and Dk pads to 64 (bf16) or 16/32/64 (fp32) the same
// way).  u is [H, Dk], read per head.  Writes o contiguous [B, S, H, Dv].
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): linear_scan_launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int CMAX = 16;      // the largest chunk (SAFE_CHUNK)
constexpr float EXP_CLAMP = 80.f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;   // initial carry [B, H, Dk, Dv] or null (zeros)
  float* s1;         // final carry [B, H, Dk, Dv] or null
  void* o;
  int B, S, H, Dk, Dv, C, rwkv;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, wb, ws, wh;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), warp-specialised
// ---------------------------------------------------------------------------

constexpr int TC_DK = 64;          // Dk padded to 64
constexpr int TC_DV = 64;          // value columns per block
constexpr int PREP_WARPS = 4;      // = ring stages
constexpr int SER_WARPS = 4;       // 16 value columns each
constexpr int RAW_SLOTS = 2;       // chunks in flight per prep warp
constexpr int TC_THREADS = 32 * (PREP_WARPS + SER_WARPS);
constexpr int BAR_N = 32 + 32 * SER_WARPS;   // one prep warp + serial warps
constexpr float CLAMP2 = EXP_CLAMP * 1.4426950408889634f;   // 80 / ln 2

// shared-memory row strides in bf16 elements, padded against bank
// conflicts (rows stay 4-byte aligned for 32-bit fragment loads)
constexpr int LDQ = 72;   // [16 rows][64]: qt, kt, qi
constexpr int LDT = 18;   // [64 rows][16]: (kE)^T, v^T
constexpr int LDA = 24;   // [16][16]: A
constexpr int LDO = 24;   // [16][16]: a serial warp's o staging (16 B rows)

// one chunk's rows as read: [16][64] each, rows past the chunk or S zero
struct RawSlot {
  __nv_bfloat16 q[CMAX * TC_DK], k[CMAX * TC_DK], v[CMAX * TC_DV];
  float w[CMAX * TC_DK];
};

struct Stage {
  __nv_bfloat16 qi[CMAX * LDQ];     // q 2^lbq                [t][d]
  __nv_bfloat16 ket[TC_DK * LDT];   // (k 2^(lbc - lb))^T     [d][t]
  __nv_bfloat16 vt[TC_DV * LDT];    // v^T                    [e][t]
  __nv_bfloat16 a[CMAX * LDA];      // masked score block     [t][j]
  float dc[TC_DK];                  // 2^lbc: the chunk's decay
};

struct TcSmem {
  RawSlot raw[PREP_WARPS][RAW_SLOTS];         // per prep warp
  Stage st[PREP_WARPS];
  __nv_bfloat16 qt[PREP_WARPS][CMAX * LDQ];   // per prep warp
  __nv_bfloat16 kt[PREP_WARPS][CMAX * LDQ];
  __nv_bfloat16 ob[SER_WARPS][CMAX * LDO];    // per serial warp
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
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void st32(__nv_bfloat16* p, uint32_t x) {
  *reinterpret_cast<uint32_t*>(p) = x;
}
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "n"(BAR_N) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "n"(BAR_N) : "memory");
}
// named barriers: stage s is full at 1 + s, empty at 1 + PREP_WARPS + s
__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
__device__ __forceinline__ int empty_bar(int s) { return 1 + PREP_WARPS + s; }

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

struct TcCtx {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* w;
  int e0, lane;
  bool fast;   // 16-byte copies: Dk = 64, whole 64-column v slices, aligned
};

// chunk n's rows into a raw slot: 16-byte cp.async on the fast layout
// (rows past the chunk or S zero-filled), else element by element (w = 1
// and q = k = v = 0 wherever a row, key or value column is out of range)
__device__ __forceinline__ void fill_raw(RawSlot& r, const Params& p,
                                         const TcCtx& x, int n) {
  if (n >= (p.S + p.C - 1) / p.C) return;
  const int lane = x.lane;
  if (x.fast) {
#pragma unroll
    for (int i = 0; i < CMAX * 8 / 32; ++i) {       // 8 pieces a bf16 row
      const int idx = lane + 32 * i, t = idx >> 3, j = idx & 7;
      const long long row = (long long)n * p.C + t;
      const bool in = t < p.C && row < p.S;
      const int nb = in ? 16 : 0;
      cp_async16(r.q + t * TC_DK + 8 * j, in ? x.q + row * p.qs + 8 * j : x.q,
                 nb);
      cp_async16(r.k + t * TC_DK + 8 * j, in ? x.k + row * p.ks + 8 * j : x.k,
                 nb);
      cp_async16(r.v + t * TC_DV + 8 * j,
                 in ? x.v + row * p.vs + x.e0 + 8 * j : x.v, nb);
    }
#pragma unroll
    for (int i = 0; i < CMAX * 16 / 32; ++i) {      // 16 pieces a w row
      const int idx = lane + 32 * i, t = idx >> 4, j = idx & 15;
      const long long row = (long long)n * p.C + t;
      const bool in = t < p.C && row < p.S;
      cp_async16(r.w + t * TC_DK + 4 * j, in ? x.w + row * p.ws + 4 * j : x.w,
                 in ? 16 : 0);
    }
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int t = 0; t < CMAX; ++t) {
    const long long row = (long long)n * p.C + t;
    const bool in = t < p.C && row < p.S;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int d = lane + 32 * i;
      const bool ind = in && d < p.Dk;
      const int e = x.e0 + d;
      r.q[t * TC_DK + d] = ind ? x.q[row * p.qs + d] : zero;
      r.k[t * TC_DK + d] = ind ? x.k[row * p.ks + d] : zero;
      r.w[t * TC_DK + d] = ind ? x.w[row * p.ws + d] : 1.f;
      r.v[t * TC_DV + d] = (in && e < p.Dv) ? x.v[row * p.vs + e] : zero;
    }
  }
}

// one chunk's carry-independent work, from its raw slot into stage `pw`
__device__ __forceinline__ void prep_chunk(const RawSlot& r, const Params& p,
                                           const TcCtx& x, TcSmem& sm,
                                           int pw, int n, const float (&u)[2]) {
  const int lane = x.lane, g = lane >> 2, c = lane & 3;
  const int C = p.C;
  const bool rwkv = p.rwkv;
  const int valid = min(C, p.S - n * C);   // rows of this chunk
  // lb: inclusive prefix sums of log2 w (rows past the chunk: w = 1)
  float lb[CMAX][2];
  float mid[2] = {0.f, 0.f}, lbc[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float run = 0.f;
#pragma unroll
    for (int t = 0; t < CMAX; ++t) {
      run += lg2(t < valid ? r.w[t * TC_DK + lane + 32 * i] : 1.f);
      lb[t][i] = run;
      if (t == C / 2) mid[i] = run;
      if (t == C - 1) lbc[i] = run;
    }
  }
  // the score block's factors (private scratch) and the bonus partials
  __nv_bfloat16* qt = sm.qt[pw];
  __nv_bfloat16* kt = sm.kt[pw];
  float bonus[CMAX];
  __syncwarp();   // this warp's previous score mma has read its scratch
#pragma unroll
  for (int t = 0; t < CMAX; ++t) {
    bonus[t] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int d = lane + 32 * i;
      const float lbq = rwkv ? (t ? lb[t - 1][i] : 0.f) : lb[t][i];
      const float qf = __bfloat162float(r.q[t * TC_DK + d]);
      const float kf = __bfloat162float(r.k[t * TC_DK + d]);
      qt[t * LDQ + d] = __float2bfloat16(qf * ex2(fminf(lbq - mid[i],
                                                        CLAMP2)));
      kt[t * LDQ + d] = __float2bfloat16(kf * ex2(fminf(mid[i] - lb[t][i],
                                                        CLAMP2)));
      bonus[t] = fmaf(qf * u[i], kf, bonus[t]);
    }
  }
  if (rwkv) {
#pragma unroll
    for (int t = 0; t < CMAX; ++t) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        bonus[t] += __shfl_xor_sync(0xffffffffu, bonus[t], o);
    }
  }
  __syncwarp();
  // A = qt kt^T: m16 (t) x n16 (j) x k64 (d)
  float acc[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < TC_DK / 16; ++ks) {
    uint32_t a[4];
    a[0] = ld32(qt + g * LDQ + 16 * ks + 2 * c);
    a[1] = ld32(qt + (g + 8) * LDQ + 16 * ks + 2 * c);
    a[2] = ld32(qt + g * LDQ + 16 * ks + 2 * c + 8);
    a[3] = ld32(qt + (g + 8) * LDQ + 16 * ks + 2 * c + 8);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const __nv_bfloat16* b = kt + (8 * nt + g) * LDQ + 16 * ks + 2 * c;
      mma16816(acc[nt], a, ld32(b), ld32(b + 8));
    }
  }
  // the mask, by selection (a masked product may be inf or NaN); the
  // RWKV6 bonus on the diagonal
  float bon[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (g == t) {
      bon[0] = bonus[t];
      bon[1] = bonus[t + 8];
    }
  }
  uint32_t apack[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float val[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int t = g + 8 * hh, j = 8 * nt + 2 * c + b;
        const bool keep = j < C && (rwkv ? j < t : j <= t);
        val[b] = keep ? acc[nt][2 * hh + b] : 0.f;
        if (rwkv && j == t && t < C) val[b] = bon[hh];
      }
      apack[nt][hh] = pack_bf16(val[0], val[1]);
    }
  }

  // the stage: wait until the serial warps have taken chunk n - 4 from it
  Stage& st = sm.st[pw];
  if (n >= PREP_WARPS) bar_sync(empty_bar(pw));
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      st32(st.a + (g + 8 * hh) * LDA + 8 * nt + 2 * c, apack[nt][hh]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int d = lane + 32 * i;
    st.dc[d] = ex2(lbc[i]);
#pragma unroll
    for (int t = 0; t < CMAX; t += 2) {
      float qi[2], ke[2], vv[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float lbq = rwkv ? ((t + b) ? lb[t + b - 1][i] : 0.f)
                               : lb[t + b][i];
        const float qf = __bfloat162float(r.q[(t + b) * TC_DK + d]);
        const float kf = __bfloat162float(r.k[(t + b) * TC_DK + d]);
        qi[b] = qf * ex2(lbq);
        ke[b] = kf * ex2(lbc[i] - lb[t + b][i]);
        vv[b] = __bfloat162float(r.v[(t + b) * TC_DV + d]);
      }
      st.qi[t * LDQ + d] = __float2bfloat16(qi[0]);
      st.qi[(t + 1) * LDQ + d] = __float2bfloat16(qi[1]);
      st32(st.ket + d * LDT + t, pack_bf16(ke[0], ke[1]));
      st32(st.vt + d * LDT + t, pack_bf16(vv[0], vv[1]));
    }
  }
  bar_arrive(full_bar(pw));
}

__global__ void __launch_bounds__(TC_THREADS, 1)
scan_bf16_kernel(const Params p, const bool fast) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TcSmem& sm = *reinterpret_cast<TcSmem*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int e0 = blockIdx.x * TC_DV;
  const int h = blockIdx.y, b = blockIdx.z;
  const int N = (p.S + p.C - 1) / p.C;

  if (warp < PREP_WARPS) {
    // -------------------------------------------------------------- prep
    TcCtx x;
    x.q = static_cast<const __nv_bfloat16*>(p.q) + b * p.qb + h * p.qh;
    x.k = static_cast<const __nv_bfloat16*>(p.k) + b * p.kb + h * p.kh;
    x.v = static_cast<const __nv_bfloat16*>(p.v) + b * p.vb + h * p.vh;
    x.w = p.w + b * p.wb + h * p.wh;
    x.e0 = e0;
    x.lane = lane;
    x.fast = fast;
    float u[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int d = lane + 32 * i;
      u[i] = (p.rwkv && d < p.Dk) ? p.u[h * p.Dk + d] : 0.f;
    }
    // this warp's chunks are warp, warp + 4, ...; RAW_SLOTS of them are
    // in flight (one commit group each, empty past the end)
    RawSlot* raw = sm.raw[warp];
#pragma unroll
    for (int j = 0; j < RAW_SLOTS; ++j) {
      fill_raw(raw[j], p, x, warp + PREP_WARPS * j);
      cp_async_commit();
    }
    for (int n = warp, j = 0; n < N; n += PREP_WARPS, ++j) {
      cp_async_wait<RAW_SLOTS - 1>();
      __syncwarp();
      RawSlot& r = raw[j % RAW_SLOTS];
      prep_chunk(r, p, x, sm, warp, n, u);
      __syncwarp();   // every lane is done with the slot
      fill_raw(r, p, x, n + PREP_WARPS * RAW_SLOTS);
      cp_async_commit();
    }
    cp_async_wait<0>();
    return;
  }

  // ---------------------------------------------------------------- serial
  const int sw = warp - PREP_WARPS;
  const int er = 16 * sw;               // this warp's value rows of S^T
  const long long sbase = ((long long)b * p.H + h) * p.Dk * p.Dv;
  // s[nd][.]: S^T[e][d] at e = er + g (+8), d = 8 nd + 2c (+1)
  float s[TC_DK / 8][4];
#pragma unroll
  for (int nd = 0; nd < TC_DK / 8; ++nd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = e0 + er + g + 8 * (i >> 1);
      const int d = 8 * nd + 2 * c + (i & 1);
      s[nd][i] = (p.s0 && e < p.Dv && d < p.Dk)
                     ? p.s0[sbase + (long long)d * p.Dv + e] : 0.f;
    }
  }
  __nv_bfloat16* ob = sm.ob[sw];
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);
  const bool vec = (p.Dv & 7) == 0;
  for (int n = 0; n < N; ++n) {
    const int ps = n % PREP_WARPS;
    const Stage& st = sm.st[ps];
    bar_sync(full_bar(ps));
    uint32_t va[4];                       // v^T: m16 (e) x k16 (t)
    va[0] = ld32(st.vt + (er + g) * LDT + 2 * c);
    va[1] = ld32(st.vt + (er + g + 8) * LDT + 2 * c);
    va[2] = ld32(st.vt + (er + g) * LDT + 2 * c + 8);
    va[3] = ld32(st.vt + (er + g + 8) * LDT + 2 * c + 8);
    uint32_t ab[2][2], qb[TC_DK / 16][2][2], kb[TC_DK / 8][2];
    float dc[TC_DK / 8][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const __nv_bfloat16* pa = st.a + (8 * nt + g) * LDA + 2 * c;
      ab[nt][0] = ld32(pa);
      ab[nt][1] = ld32(pa + 8);
#pragma unroll
      for (int ks = 0; ks < TC_DK / 16; ++ks) {
        const __nv_bfloat16* pq = st.qi + (8 * nt + g) * LDQ + 16 * ks + 2 * c;
        qb[ks][nt][0] = ld32(pq);
        qb[ks][nt][1] = ld32(pq + 8);
      }
    }
#pragma unroll
    for (int nd = 0; nd < TC_DK / 8; ++nd) {
      const __nv_bfloat16* pk = st.ket + (8 * nd + g) * LDT + 2 * c;
      kb[nd][0] = ld32(pk);
      kb[nd][1] = ld32(pk + 8);
      dc[nd][0] = st.dc[8 * nd + 2 * c];
      dc[nd][1] = st.dc[8 * nd + 2 * c + 1];
    }
    // the stage is in registers: hand it back (the last four have no
    // taker)
    if (n + PREP_WARPS < N) bar_arrive(empty_bar(ps));

    // o^T = v^T A^T + S^T qi^T: m16 (e) x n16 (t)
    float oc[2][4] = {};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) mma16816(oc[nt], va, ab[nt][0], ab[nt][1]);
#pragma unroll
    for (int ks = 0; ks < TC_DK / 16; ++ks) {
      uint32_t sa[4];   // the carry as the A operand, rounded to bf16
      sa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      sa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      sa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      sa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        mma16816(oc[nt], sa, qb[ks][nt][0], qb[ks][nt][1]);
    }
    // S^T = 2^lbc o S^T + v^T kE: m16 (e) x n64 (d) x k16 (t), in fp32
#pragma unroll
    for (int nd = 0; nd < TC_DK / 8; ++nd) {
      s[nd][0] *= dc[nd][0];
      s[nd][1] *= dc[nd][1];
      s[nd][2] *= dc[nd][0];
      s[nd][3] *= dc[nd][1];
      mma16816(s[nd], va, kb[nd][0], kb[nd][1]);
    }
    // o: stage [t][e] in this warp's buffer, then 16 bytes a lane
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 8 * nt + 2 * c + (i & 1), e = g + 8 * (i >> 1);
        ob[t * LDO + e] = __float2bfloat16(oc[nt][i]);
      }
    }
    __syncwarp();
    {
      const int t = lane >> 1, half = lane & 1;
      const long long row = (long long)n * p.C + t;
      const int e = e0 + er + 8 * half;
      if (t < p.C && row < p.S && e < p.Dv) {
        __nv_bfloat16* dst = o + ((b * (long long)p.S + row) * p.H + h)
                                     * p.Dv + e;
        const __nv_bfloat16* src = ob + t * LDO + 8 * half;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          for (int i = 0; i < 8 && e + i < p.Dv; ++i) dst[i] = src[i];
        }
      }
    }
  }
  if (p.s1) {
#pragma unroll
    for (int nd = 0; nd < TC_DK / 8; ++nd) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = e0 + er + g + 8 * (i >> 1);
        const int d = 8 * nd + 2 * c + (i & 1);
        if (e < p.Dv && d < p.Dk)
          p.s1[sbase + (long long)d * p.Dv + e] = s[nd][i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: plain FMAs
// ---------------------------------------------------------------------------

constexpr int ES = 32;        // carry columns (of Dv) per block
constexpr int THREADS = 128;

template <int DKP>
__global__ void __launch_bounds__(THREADS)
scan_f32_kernel(const Params p) {
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
  __shared__ float sS[DKP][ES];     // the carry's column slice
  __shared__ float su[DKP];
  __shared__ float sdc[DKP];        // exp(lb[C-1]): the chunk's decay
  __shared__ float sbonus[CMAX];

  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * ES;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = p.C;
  const int rwkv = p.rwkv;
  const float* q = static_cast<const float*>(p.q) + b * p.qb + h * p.qh;
  const float* k = static_cast<const float*>(p.k) + b * p.kb + h * p.kh;
  const float* v = static_cast<const float*>(p.v) + b * p.vb + h * p.vh;
  const float* w = p.w + b * p.wb + h * p.wh;
  float* o = static_cast<float*>(p.o);
  const long long sbase = ((long long)b * p.H + h) * p.Dk * p.Dv;

  for (int i = tid; i < DKP * ES; i += THREADS) {
    const int d = i / ES, e = e0 + i % ES;
    sS[d][i % ES] = (p.s0 && d < p.Dk && e < p.Dv)
                        ? p.s0[sbase + (long long)d * p.Dv + e] : 0.f;
  }
  if (tid < DKP) su[tid] = (rwkv && tid < p.Dk) ? p.u[h * p.Dk + tid] : 0.f;

  // registers holding the next chunk (rows past S: w = 1, q = k = v = 0)
  float rq[NQ], rk[NQ], rw[NQ], rv[NV];
  auto load = [&](int n) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int idx = tid + i * THREADS;
      const int t = idx / DKP, d = idx % DKP;
      const long long row = (long long)n * C + t;
      const bool in = t < C && row < p.S && d < p.Dk;
      rq[i] = in ? q[row * p.qs + d] : 0.f;
      rk[i] = in ? k[row * p.ks + d] : 0.f;
      rw[i] = in ? w[row * p.ws + d] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = tid + i * THREADS;
      const int t = idx / ES, e = idx % ES;
      const long long row = (long long)n * C + t;
      const bool in = t < C && row < p.S && e0 + e < p.Dv;
      rv[i] = in ? v[row * p.vs + e0 + e] : 0.f;
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
      const long long row = (long long)n * C + t;
      if (t < C && row < p.S && e0 + e < p.Dv) {
        float intra = 0.f;
        for (int j = 0; j < C; ++j) intra += sA[t][j] * sv[j][e];
        if (rwkv) intra += sbonus[t] * sv[t][e];
        float inter = 0.f;
        for (int d = 0; d < DKP; ++d) inter += sqi[t][d] * sS[d][e];
        o[((b * (long long)p.S + row) * p.H + h) * p.Dv + e0 + e] =
            intra + inter;
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
  if (p.s1) {
    for (int i = tid; i < DKP * ES; i += THREADS) {
      const int d = i / ES, e = e0 + i % ES;
      if (d < p.Dk && e < p.Dv)
        p.s1[sbase + (long long)d * p.Dv + e] = sS[d][i % ES];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int DKP>
static int launch_f32(const Params& p, cudaStream_t st) {
  dim3 grid((p.Dv + ES - 1) / ES, p.H, p.B);
  scan_f32_kernel<DKP><<<grid, THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

static int launch_bf16(const Params& p, cudaStream_t st) {
  static bool configured = false;   // the attribute is per function
  const int smem = (int)sizeof(TcSmem);
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        scan_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  // the fast layout: 16-byte aligned rows of whole 64-column tiles
  const bool fast =
      p.Dk == TC_DK && p.Dv % TC_DV == 0
      && ((reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k)
           | reinterpret_cast<uintptr_t>(p.v)
           | reinterpret_cast<uintptr_t>(p.w)) & 15) == 0
      && (p.qb | p.qs | p.qh | p.kb | p.ks | p.kh | p.vb | p.vs | p.vh) % 8
             == 0
      && (p.wb | p.ws | p.wh) % 4 == 0;
  dim3 grid((p.Dv + TC_DV - 1) / TC_DV, p.H, p.B);
  scan_bf16_kernel<<<grid, TC_THREADS, smem, st>>>(p, fast);
  return (int)cudaGetLastError();
}

// strides: q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, w_b, w_s, w_h in
// elements (the last dim contiguous); w and u are fp32, u contiguous
// [H, Dk] (ignored when rwkv is 0); s0 / s1, when not null, are fp32
// contiguous [B, H, Dk, Dv] (the carry in, the final carry out; they must
// not overlap); o is written contiguous [B, S, H, Dv]
extern "C" int linear_scan_launch(const void* q, const void* k,
                                  const void* v, const void* w,
                                  const void* u, const void* s0, void* s1,
                                  void* o, int dtype, int B, int S, int H,
                                  int Dk, int Dv, int C, int rwkv,
                                  const long long* strides, void* stream) {
  if (Dk < 1 || Dk > 64 || Dv < 1 || C < 1 || C > CMAX || S < 1 || B < 1
      || B > 65535 || H < 1 || H > 65535 || (rwkv && u == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.s1 = static_cast<float*>(s1);
  p.o = o;
  p.B = B; p.S = S; p.H = H; p.Dk = Dk; p.Dv = Dv; p.C = C; p.rwkv = rwkv;
  p.qb = strides[0]; p.qs = strides[1]; p.qh = strides[2];
  p.kb = strides[3]; p.ks = strides[4]; p.kh = strides[5];
  p.vb = strides[6]; p.vs = strides[7]; p.vh = strides[8];
  p.wb = strides[9]; p.ws = strides[10]; p.wh = strides[11];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) return launch_bf16(p, st);
  if (dtype == DT_F32) {
    if (Dk <= 16) return launch_f32<16>(p, st);
    if (Dk <= 32) return launch_f32<32>(p, st);
    return launch_f32<64>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}
