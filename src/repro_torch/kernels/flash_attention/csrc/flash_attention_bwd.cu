// The backward of online-softmax (flash) attention, for NVIDIA Hopper
// (sm_90a).
//
// The TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel has no backward kernel: the JAX package's
// flash_attention_vjp takes the VJP of attention_ref, which materialises
// the [Sq, Skv] scores.  This is the port's backward of the forward kernel
// (flash_attention.cu), which leaves each query row's natural log-sum-exp
// `lse` behind: with it a score block's probabilities are recomputed as
// P = exp(S / sqrt(D) - lse) without a second pass over the keys.
//
//   D_i  = sum_d dO_id O_id                      (delta_kernel, fp32)
//   dP   = dO V^T,  dS = P * (dP - D_i)
//   dV_j = sum_{h in group, i} P_ij dO_i          (dkdv_kernel)
//   dK_j = sum_{h in group, i} dS_ij Q_i / sqrt(D)
//   dQ_i = sum_j dS_ij K_j / sqrt(D)              (dq_kernel)
//
// Deterministic, with no atomics: every output element is summed by one
// thread in a fixed order.  dkdv_kernel runs one block per (64 keys, K/V
// head, batch) and walks the query heads of its group and their query
// tiles in order (GQA's sum over the group happens inside the block);
// dq_kernel runs one block per (64 query rows, query head, batch) and
// walks the key tiles in order.  Causal tiles wholly above the diagonal are
// skipped; a score that is masked (causal, a key past Skv, a query row past
// Sq) gives P = 0 and dS = 0.  Queries align to the end of the keys
// (q_offset = Skv - Sq); causal Sq > Skv is refused, as the forward
// refuses it.
//
// What bounds it on the H100: the recomputed products (S and dP in both
// kernels, then PdO, dSQ and dSK: 7 products of the forward's size against
// the forward's 2) at the training shape (B = 2, S = 2048, 16 / 2 heads of
// 128, causal: about 120 GFLOP) are tensor-core work, about 0.12 ms at
// 989 TFLOP/s.  This first version is simple and right, not fast: bf16
// runs mma.sync m16n8k16 (the fragments of the scan's route), four warps a
// block, each warp owning 16 rows (keys in dkdv_kernel, queries in
// dq_kernel) with its fp32 accumulators in registers; the operand tiles
// come by cp.async (the next query tile of dkdv_kernel, and the next key
// tile of dq_kernel, land while the current one computes), the B operands
// that run along the tile's rows by ldmatrix.trans.  P and dS are rounded
// to bf16 for their products, as the forward rounds P.  fp32 runs plain
// FMAs (no TF32).  TMA and wgmma are left to a later version.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): flash_attention_bwd_launch returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for arguments the kernels do not take.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int BK = 64;        // keys per block (dkdv) and per key tile (dq)
constexpr int BQ_KV = 32;     // query rows per step of dkdv_kernel
constexpr int BQ = 64;        // query rows per block of dq_kernel
constexpr int THREADS = 128;  // four warps
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q; const void* k; const void* v; const void* o;
  const void* g;           // dO
  const float* lse;        // [B, Hq, Sq], natural log
  float* delta;            // [B, Hq, Sq]
  void* dq; void* dk; void* dv;   // contiguous [B, S, H, D]
  int B, Sq, Skv, Hq, Hkv, D;
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, gb, gs, gh;
  int causal, q_offset;
  float scale;             // 1 / sqrt(D)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 2^x in one MUFU op (flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; with
// `valid` false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of one head (`base`, rows `stride` elements
// apart) into a [ROWS][LD] tile: 16-byte pieces, the pieces past D or past
// `rows` zero-filled.  The caller commits the group.
template <typename T, int ROWS, int DP, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* base,
                                          int64_t stride, int row0,
                                          int rows, int D) {
  constexpr int PER = 16 / sizeof(T);         // elements in a piece
  constexpr int PIECES = DP / PER;
  for (int i = threadIdx.x; i < ROWS * PIECES; i += THREADS) {
    const int r = i / PIECES, c = (i % PIECES) * PER;
    const bool ok = row0 + r < rows && c < D;
    cp_async16(dst + r * LD + c,
               ok ? base + (int64_t)(row0 + r) * stride + c : base, ok);
  }
}

// ---------------------------------------------------------------------------
// delta: D_i = sum_d dO_id O_id, one warp per (b, s, h) row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(Params p) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)p.B * p.Sq * p.Hq) return;
  const int h = row % p.Hq;
  const int s = (row / p.Hq) % p.Sq;
  const int b = row / ((int64_t)p.Hq * p.Sq);
  const T* o = static_cast<const T*>(p.o) + b * p.ob + s * p.os + h * p.oh;
  const T* g = static_cast<const T*>(p.g) + b * p.gb + s * p.gs + h * p.gh;
  float acc = 0.0f;
  for (int d = lane; d < p.D; d += 32) acc = fmaf(to_f(o[d]), to_f(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[((int64_t)b * p.Hq + h) * p.Sq + s] = acc;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Four 8x8 b16 matrices, transposed: thread (g, c) gets M[2c][g] and
// M[2c+1][g] of matrix i in r[i]; lanes 8i .. 8i+7 give matrix i's rows.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

// The A fragment of a 16-row block from `t` [rows][LD] at row r0, k step
// ks.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* t, int r0,
                                       int ks, int g, int c) {
  const __nv_bfloat16* p = t + (r0 + g) * LD + 16 * ks + 2 * c;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// acc[NT][4] += A[16 rows of `a` at r0][DP] * B^T, B = the first 8 NT rows
// of `b` ([rows][LD], the product's n index): S = Q K^T style, both
// operands K-major in shared memory.
template <int NT, int DP, int LD>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4],
                                         const __nv_bfloat16* a, int r0,
                                         const __nv_bfloat16* b, int g,
                                         int c) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    uint32_t fa[4];
    frag_a<LD>(fa, a, r0, ks, g, c);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* pb = b + (8 * nt + g) * LD + 16 * ks + 2 * c;
      mma16816(acc[nt], fa, ld32(pb), ld32(pb + 8));
    }
  }
}

// acc[DP/8][4] += X[16 x 8 KT] * T[8 KT rows of `t`][DP], X given as the
// accumulator-layout values x[KT][4] rounded to bf16 (the accumulator of
// an m16n8 block lines up with the A fragment pairwise), T's rows the
// contraction: its fragments by ldmatrix.trans.
template <int KT, int DP, int LD>
__device__ __forceinline__ void mma_acc_t(float (&acc)[DP / 8][4],
                                          const float (&x)[KT][4],
                                          const __nv_bfloat16* t, int lane) {
#pragma unroll
  for (int ks = 0; ks < KT / 2; ++ks) {
    uint32_t fa[4];
    fa[0] = pack_bf16(x[2 * ks][0], x[2 * ks][1]);
    fa[1] = pack_bf16(x[2 * ks][2], x[2 * ks][3]);
    fa[2] = pack_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]);
    fa[3] = pack_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3]);
    const int mat = lane >> 3;
    const int row = 16 * ks + (mat & 1) * 8 + (lane & 7);
#pragma unroll
    for (int dt = 0; dt < DP / 8; dt += 2) {
      uint32_t fb[4];
      ldsm_x4_t(fb, smem_u32(t + row * LD + 8 * dt + (mat >> 1) * 8));
      mma16816(acc[dt], fa, fb[0], fb[1]);
      mma16816(acc[dt + 1], fa, fb[2], fb[3]);
    }
  }
}

// Writes a warp's 16 x DP accumulator (times `scale`) as bf16 rows
// [r0 .. r0 + 16) of `out` (contiguous [B, S, H, D] at head `h`, batch
// `b`), the rows past `rows` and the columns past D dropped.
template <int DP>
__device__ __forceinline__ void store_acc_bf16(const float (&acc)[DP / 8][4],
                                               float scale,
                                               __nv_bfloat16* out, int b,
                                               int r0, int rows, int H,
                                               int h, int D, int g, int c) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + g + 8 * hh;
    if (row >= rows) continue;
    __nv_bfloat16* dst = out + (((int64_t)b * rows + row) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int col = 8 * dt + 2 * c;
      if (col < D)   // D % 8 == 0: col + 1 < D too
        *reinterpret_cast<uint32_t*>(dst + col) =
            pack_bf16(acc[dt][2 * hh] * scale, acc[dt][2 * hh + 1] * scale);
    }
  }
}

template <int DP>
struct KvSmem {
  static constexpr int LD = DP + 8;   // 16-byte rows, free of bank conflicts
  __nv_bfloat16 k[BK * LD], v[BK * LD];
  __nv_bfloat16 q[2][BQ_KV * LD], g[2][BQ_KV * LD];
  float lse2[2][BQ_KV], dl[2][BQ_KV];
};

// One block per (64 keys, K/V head, batch), heaviest key block first (a
// causal key block sees the query rows from its own position on).
template <int DP>
__global__ void __launch_bounds__(THREADS)
dkdv_bf16_kernel(Params p) {
  using S = KvSmem<DP>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const int kt = blockIdx.x / (p.Hkv * p.B);
  const int hk = blockIdx.x / p.B % p.Hkv;
  const int b = blockIdx.x % p.B;
  const int grp = p.Hq / p.Hkv;
  const int key0 = kt * BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  typedef __nv_bfloat16 T;

  const int qt0 = p.causal ? max(0, key0 - p.q_offset) / BQ_KV : 0;
  const int nq = (p.Sq + BQ_KV - 1) / BQ_KV - qt0;   // query tiles a head
  const int steps = grp * max(nq, 0);

  auto fetch = [&](int it, int buf) {   // step it's Q, dO, lse, delta
    const int h = hk * grp + it / nq;
    const int q0 = (qt0 + it % nq) * BQ_KV;
    load_rows<T, BQ_KV, DP, LD>(sm.q[buf], static_cast<const T*>(p.q)
                                + b * p.qb + h * p.qh, p.qs, q0, p.Sq, p.D);
    load_rows<T, BQ_KV, DP, LD>(sm.g[buf], static_cast<const T*>(p.g)
                                + b * p.gb + h * p.gh, p.gs, q0, p.Sq, p.D);
    if (tid < BQ_KV) {
      const int64_t i = ((int64_t)b * p.Hq + h) * p.Sq + q0 + tid;
      const bool ok = q0 + tid < p.Sq;
      sm.lse2[buf][tid] = ok ? p.lse[i] * LOG2E : 0.0f;
      sm.dl[buf][tid] = ok ? p.delta[i] : 0.0f;
    }
  };

  load_rows<T, BK, DP, LD>(sm.k, static_cast<const T*>(p.k) + b * p.kb
                           + hk * p.kh, p.ks, key0, p.Skv, p.D);
  load_rows<T, BK, DP, LD>(sm.v, static_cast<const T*>(p.v) + b * p.vb
                           + hk * p.vh, p.vs, key0, p.Skv, p.D);
  if (steps > 0) fetch(0, 0);
  cp_async_commit();

  float dk[DP / 8][4] = {}, dv[DP / 8][4] = {};
  const float scale2 = p.scale * LOG2E;
  const int kr = 16 * warp;                   // this warp's first key row
  for (int it = 0; it < steps; ++it) {
    const int buf = it % 2;
    if (it + 1 < steps) fetch(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // step it's tiles (and K, V) have landed
    __syncthreads();
    const int q0 = (qt0 + it % nq) * BQ_KV;
    // S^T = K Q^T and dP^T = V dO^T, 16 keys x 32 queries a warp
    float st[BQ_KV / 8][4] = {}, dpt[BQ_KV / 8][4] = {};
    mma_rows<BQ_KV / 8, DP, LD>(st, sm.k, kr, sm.q[buf], g, c);
    mma_rows<BQ_KV / 8, DP, LD>(dpt, sm.v, kr, sm.g[buf], g, c);
#pragma unroll
    for (int nt = 0; nt < BQ_KV / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = key0 + kr + g + 8 * (i / 2);
        const int qi = 8 * nt + 2 * c + (i % 2);   // query in the tile
        const int qpos = q0 + qi;
        const bool ok = key < p.Skv && qpos < p.Sq
                        && (!p.causal || key <= qpos + p.q_offset);
        const float pr = ok ? ex2(st[nt][i] * scale2 - sm.lse2[buf][qi])
                            : 0.0f;
        st[nt][i] = pr;
        dpt[nt][i] = pr * (dpt[nt][i] - sm.dl[buf][qi]);
      }
    // dV += P^T dO, dK += dS^T Q (the query tile's rows the contraction)
    mma_acc_t<BQ_KV / 8, DP, LD>(dv, st, sm.g[buf], lane);
    mma_acc_t<BQ_KV / 8, DP, LD>(dk, dpt, sm.q[buf], lane);
    __syncthreads();   // every warp is done with this buffer
  }
  cp_async_wait<0>();
  store_acc_bf16<DP>(dk, p.scale, static_cast<T*>(p.dk), b, key0 + kr,
                     p.Skv, p.Hkv, hk, p.D, g, c);
  store_acc_bf16<DP>(dv, 1.0f, static_cast<T*>(p.dv), b, key0 + kr, p.Skv,
                     p.Hkv, hk, p.D, g, c);
}

template <int DP>
struct QSmem {
  static constexpr int LD = DP + 8;
  __nv_bfloat16 q[BQ * LD], g[BQ * LD];
  __nv_bfloat16 k[2][BK * LD], v[2][BK * LD];
};

// One block per (64 query rows, query head, batch), heaviest query tile
// first.
template <int DP>
__global__ void __launch_bounds__(THREADS)
dq_bf16_kernel(Params p) {
  using S = QSmem<DP>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - blockIdx.x / (p.Hq * p.B);
  const int h = blockIdx.x / p.B % p.Hq;
  const int b = blockIdx.x % p.B;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  typedef __nv_bfloat16 T;

  const int last_q = min(q0 + BQ, p.Sq) - 1;
  const int kv_end = p.causal ? min(p.Skv, p.q_offset + last_q + 1) : p.Skv;
  const int n_kt = (kv_end + BK - 1) / BK;

  auto fetch = [&](int t, int buf) {
    load_rows<T, BK, DP, LD>(sm.k[buf], static_cast<const T*>(p.k)
                             + b * p.kb + hk * p.kh, p.ks, t * BK, p.Skv,
                             p.D);
    load_rows<T, BK, DP, LD>(sm.v[buf], static_cast<const T*>(p.v)
                             + b * p.vb + hk * p.vh, p.vs, t * BK, p.Skv,
                             p.D);
  };
  load_rows<T, BQ, DP, LD>(sm.q, static_cast<const T*>(p.q) + b * p.qb
                           + h * p.qh, p.qs, q0, p.Sq, p.D);
  load_rows<T, BQ, DP, LD>(sm.g, static_cast<const T*>(p.g) + b * p.gb
                           + h * p.gh, p.gs, q0, p.Sq, p.D);
  if (n_kt > 0) fetch(0, 0);
  cp_async_commit();

  const int qr = 16 * warp;   // this warp's first query row
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + qr + g + 8 * hh;
    const int64_t i = ((int64_t)b * p.Hq + h) * p.Sq + row;
    lse2[hh] = row < p.Sq ? p.lse[i] * LOG2E : 0.0f;
    dl[hh] = row < p.Sq ? p.delta[i] : 0.0f;
  }
  const float scale2 = p.scale * LOG2E;
  float dq[DP / 8][4] = {};
  for (int t = 0; t < n_kt; ++t) {
    const int buf = t % 2;
    if (t + 1 < n_kt) fetch(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[BK / 8][4] = {}, dp[BK / 8][4] = {};
    mma_rows<BK / 8, DP, LD>(s, sm.q, qr, sm.k[buf], g, c);
    mma_rows<BK / 8, DP, LD>(dp, sm.g, qr, sm.v[buf], g, c);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + qr + g + 8 * (i / 2);
        const int key = t * BK + 8 * nt + 2 * c + (i % 2);
        const bool ok = key < p.Skv && qpos < p.Sq
                        && (!p.causal || key <= qpos + p.q_offset);
        const float pr = ok ? ex2(s[nt][i] * scale2 - lse2[i / 2]) : 0.0f;
        s[nt][i] = pr * (dp[nt][i] - dl[i / 2]);   // dS
      }
    mma_acc_t<BK / 8, DP, LD>(dq, s, sm.k[buf], lane);   // dQ += dS K
    __syncthreads();
  }
  cp_async_wait<0>();
  store_acc_bf16<DP>(dq, p.scale, static_cast<T*>(p.dq), b, q0 + qr, p.Sq,
                     p.Hq, h, p.D, g, c);
}

// ---------------------------------------------------------------------------
// fp32: plain FMAs; a thread pair per row (keys in dkdv, queries in dq),
// each thread taking every other column
// ---------------------------------------------------------------------------

constexpr int F_LDS = 64 + 4;   // fp32 score tile stride

template <int DP>
struct F32Smem {
  static constexpr int LD = DP + 4;   // 16-byte rows
  static constexpr int TILE = 64 * LD;
  static constexpr int TOTAL = (4 * TILE + 2 * 64 * F_LDS + 128) * 4;
};

template <int DP>
__global__ void __launch_bounds__(THREADS)
dkdv_f32_kernel(Params p) {
  using S = F32Smem<DP>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + S::TILE;
  float* qs = vs + S::TILE;
  float* gs = qs + S::TILE;
  float* ps = gs + S::TILE;          // P^T [key][query]
  float* dss = ps + 64 * F_LDS;      // dS^T
  float* lse_s = dss + 64 * F_LDS;
  float* dl_s = lse_s + 64;
  const int kt = blockIdx.x / (p.Hkv * p.B);
  const int hk = blockIdx.x / p.B % p.Hkv;
  const int b = blockIdx.x % p.B;
  const int grp = p.Hq / p.Hkv;
  const int key0 = kt * 64;
  const int tid = threadIdx.x, r = tid >> 1, half = tid & 1;
  const int key = key0 + r;

  load_rows<float, 64, DP, LD>(ks, static_cast<const float*>(p.k)
                               + b * p.kb + hk * p.kh, p.ks, key0, p.Skv,
                               p.D);
  load_rows<float, 64, DP, LD>(vs, static_cast<const float*>(p.v)
                               + b * p.vb + hk * p.vh, p.vs, key0, p.Skv,
                               p.D);
  cp_async_commit();
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) dk[j] = dv[j] = 0.0f;
  const int qt0 = p.causal ? max(0, key0 - p.q_offset) / 64 : 0;
  const int n_qt = (p.Sq + 63) / 64;
  for (int gi = 0; gi < grp; ++gi) {
    const int h = hk * grp + gi;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * 64;
      load_rows<float, 64, DP, LD>(qs, static_cast<const float*>(p.q)
                                   + b * p.qb + h * p.qh, p.qs, q0, p.Sq,
                                   p.D);
      load_rows<float, 64, DP, LD>(gs, static_cast<const float*>(p.g)
                                   + b * p.gb + h * p.gh, p.gs, q0, p.Sq,
                                   p.D);
      cp_async_commit();
      if (tid < 64) {
        const int64_t i = ((int64_t)b * p.Hq + h) * p.Sq + q0 + tid;
        const bool ok = q0 + tid < p.Sq;
        lse_s[tid] = ok ? p.lse[i] : 0.0f;
        dl_s[tid] = ok ? p.delta[i] : 0.0f;
      }
      cp_async_wait<0>();
      __syncthreads();
      for (int j = 0; j < 32; ++j) {
        const int qi = half + 2 * j, qpos = q0 + qi;
        float s = 0.0f, dp = 0.0f;
#pragma unroll 8
        for (int d = 0; d < DP; ++d) {
          s = fmaf(ks[r * LD + d], qs[qi * LD + d], s);
          dp = fmaf(vs[r * LD + d], gs[qi * LD + d], dp);
        }
        const bool ok = key < p.Skv && qpos < p.Sq
                        && (!p.causal || key <= qpos + p.q_offset);
        const float pr = ok ? expf(s * p.scale - lse_s[qi]) : 0.0f;
        ps[r * F_LDS + qi] = pr;
        dss[r * F_LDS + qi] = pr * (dp - dl_s[qi]);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) {
        const int d = half + 2 * j;
        float a = dv[j], bk = dk[j];
        for (int qi = 0; qi < 64; ++qi) {
          a = fmaf(ps[r * F_LDS + qi], gs[qi * LD + d], a);
          bk = fmaf(dss[r * F_LDS + qi], qs[qi * LD + d], bk);
        }
        dv[j] = a;
        dk[j] = bk;
      }
      __syncthreads();
    }
  }
  cp_async_wait<0>();
  if (key < p.Skv) {
    float* odk = static_cast<float*>(p.dk)
                 + (((int64_t)b * p.Skv + key) * p.Hkv + hk) * p.D;
    float* odv = static_cast<float*>(p.dv)
                 + (((int64_t)b * p.Skv + key) * p.Hkv + hk) * p.D;
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) {
      const int d = half + 2 * j;
      if (d < p.D) {
        odk[d] = dk[j] * p.scale;
        odv[d] = dv[j];
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
dq_f32_kernel(Params p) {
  using S = F32Smem<DP>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* gs = qs + S::TILE;
  float* ks = gs + S::TILE;
  float* vs = ks + S::TILE;
  float* dss = vs + S::TILE;         // dS [query][key]
  const int n_qt = (p.Sq + 63) / 64;
  const int qt = n_qt - 1 - blockIdx.x / (p.Hq * p.B);
  const int h = blockIdx.x / p.B % p.Hq;
  const int b = blockIdx.x % p.B;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * 64;
  const int tid = threadIdx.x, r = tid >> 1, half = tid & 1;
  const int qpos = q0 + r;

  load_rows<float, 64, DP, LD>(qs, static_cast<const float*>(p.q)
                               + b * p.qb + h * p.qh, p.qs, q0, p.Sq, p.D);
  load_rows<float, 64, DP, LD>(gs, static_cast<const float*>(p.g)
                               + b * p.gb + h * p.gh, p.gs, q0, p.Sq, p.D);
  cp_async_commit();
  const int64_t li = ((int64_t)b * p.Hq + h) * p.Sq + qpos;
  const float lse = qpos < p.Sq ? p.lse[li] : 0.0f;
  const float dl = qpos < p.Sq ? p.delta[li] : 0.0f;
  float dq[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) dq[j] = 0.0f;
  const int last_q = min(q0 + 64, p.Sq) - 1;
  const int kv_end = p.causal ? min(p.Skv, p.q_offset + last_q + 1) : p.Skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += 64) {
    load_rows<float, 64, DP, LD>(ks, static_cast<const float*>(p.k)
                                 + b * p.kb + hk * p.kh, p.ks, kv0, p.Skv,
                                 p.D);
    load_rows<float, 64, DP, LD>(vs, static_cast<const float*>(p.v)
                                 + b * p.vb + hk * p.vh, p.vs, kv0, p.Skv,
                                 p.D);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int j = 0; j < 32; ++j) {
      const int kj = half + 2 * j, key = kv0 + kj;
      float s = 0.0f, dp = 0.0f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) {
        s = fmaf(qs[r * LD + d], ks[kj * LD + d], s);
        dp = fmaf(gs[r * LD + d], vs[kj * LD + d], dp);
      }
      const bool ok = key < p.Skv && qpos < p.Sq
                      && (!p.causal || key <= qpos + p.q_offset);
      const float pr = ok ? expf(s * p.scale - lse) : 0.0f;
      dss[r * F_LDS + kj] = pr * (dp - dl);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) {
      const int d = half + 2 * j;
      float a = dq[j];
      for (int kj = 0; kj < 64; ++kj)
        a = fmaf(dss[r * F_LDS + kj], ks[kj * LD + d], a);
      dq[j] = a;
    }
    __syncthreads();
  }
  if (qpos < p.Sq) {
    float* out = static_cast<float*>(p.dq)
                 + (((int64_t)b * p.Sq + qpos) * p.Hq + h) * p.D;
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) {
      const int d = half + 2 * j;
      if (d < p.D) out[d] = dq[j] * p.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename K>
static cudaError_t smem_attr(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int DP>
static int launch_bf16(const Params& p, cudaStream_t st) {
  const int kv_blocks = (p.Skv + BK - 1) / BK * p.Hkv * p.B;
  const int q_blocks = (p.Sq + BQ - 1) / BQ * p.Hq * p.B;
  cudaError_t err = smem_attr(dkdv_bf16_kernel<DP>, sizeof(KvSmem<DP>));
  if (err == cudaSuccess)
    err = smem_attr(dq_bf16_kernel<DP>, sizeof(QSmem<DP>));
  if (err != cudaSuccess) return (int)err;
  dkdv_bf16_kernel<DP><<<kv_blocks, THREADS, sizeof(KvSmem<DP>), st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_bf16_kernel<DP><<<q_blocks, THREADS, sizeof(QSmem<DP>), st>>>(p);
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_f32(const Params& p, cudaStream_t st) {
  const int kv_blocks = (p.Skv + 63) / 64 * p.Hkv * p.B;
  const int q_blocks = (p.Sq + 63) / 64 * p.Hq * p.B;
  constexpr int bytes = F32Smem<DP>::TOTAL;
  cudaError_t err = smem_attr(dkdv_f32_kernel<DP>, bytes);
  if (err == cudaSuccess) err = smem_attr(dq_f32_kernel<DP>, bytes);
  if (err != cudaSuccess) return (int)err;
  dkdv_f32_kernel<DP><<<kv_blocks, THREADS, bytes, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_f32_kernel<DP><<<q_blocks, THREADS, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

static bool aligned16(const void* a) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

// strides: the (b, s, h) strides in elements of q, k, v, o and dO, in that
// order (15 values; the head dim is contiguous).  lse is the forward's
// [B, Hq, Sq] natural log-sum-exp; delta is [B, Hq, Sq] fp32 scratch; dq,
// dk and dv are written contiguous [B, S, H, D] in the operands' dtype.
// scale is 1 / sqrt(D).  Rows must be 16-byte pieces: D and every stride a
// multiple of 8 (bf16) or 4 (fp32) elements, every base 16-byte aligned.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    const long long* strides, int causal, float scale, void* stream) {
  if (D < 1 || D > 128 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1
      || (causal && Sq > Skv) || B < 1 || (dtype != DT_BF16 && dtype != DT_F32))
    return (int)cudaErrorInvalidValue;
  const int per = dtype == DT_BF16 ? 8 : 4;   // elements in 16 bytes
  if (D % per != 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 15; ++i)
    if (strides[i] % per != 0) return (int)cudaErrorInvalidValue;
  const void* ptrs[10] = {q, k, v, o, g, lse, delta, dq, dk, dv};
  for (const void* ptr : ptrs)
    if (!aligned16(ptr)) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.g = g;
  p.lse = lse; p.delta = delta; p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.Hq = Hq; p.Hkv = Hkv; p.D = D;
  p.qb = strides[0]; p.qs = strides[1]; p.qh = strides[2];
  p.kb = strides[3]; p.ks = strides[4]; p.kh = strides[5];
  p.vb = strides[6]; p.vs = strides[7]; p.vh = strides[8];
  p.ob = strides[9]; p.os = strides[10]; p.oh = strides[11];
  p.gb = strides[12]; p.gs = strides[13]; p.gh = strides[14];
  p.causal = causal;
  p.q_offset = causal ? Skv - Sq : 0;
  p.scale = scale;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * Sq * Hq;
  if (rows > 0x7fffffffLL * 8) return (int)cudaErrorInvalidValue;
  const unsigned delta_blocks = (unsigned)((rows + 7) / 8);
  if (dtype == DT_BF16)
    delta_kernel<__nv_bfloat16><<<delta_blocks, 256, 0, st>>>(p);
  else
    delta_kernel<float><<<delta_blocks, 256, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int dp = D <= 64 ? 64 : 128;
  if (dtype == DT_BF16)
    return dp == 64 ? launch_bf16<64>(p, st) : launch_bf16<128>(p, st);
  return dp == 64 ? launch_f32<64>(p, st) : launch_f32<128>(p, st);
}
