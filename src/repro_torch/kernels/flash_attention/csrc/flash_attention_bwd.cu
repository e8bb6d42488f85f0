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
//   dV_j = sum_{h in group, i} P_ij dO_i          (dkdv_*_kernel)
//   dK_j = sum_{h in group, i} dS_ij Q_i / sqrt(D)
//   dQ_i = sum_j dS_ij K_j / sqrt(D)              (dq_*_kernel)
//
// Causal tiles wholly above the diagonal are skipped; a score that is
// masked (causal, a key past Skv, a query row past Sq) gives P = 0 and
// dS = 0.  Queries align to the end of the keys (q_offset = Skv - Sq);
// causal Sq > Skv is refused, as the forward refuses it.
//
// Deterministic: every output element is summed in one order that depends
// on the shapes alone, with no atomics and no waits between blocks.
//
// What bounds it on the H100: at the training shape (B = 2, S = 2048,
// 16 / 2 heads of 128, causal) the five products of a backward (S, dP, dV,
// dK, dQ) are 85.9 GFLOP, about 87 us at 989 TFLOP/s, against about 76 MB
// of operands and gradients (23 us at 3.35 TB/s): tensor-core work bounds
// it.  This design runs seven products (S and dP twice, 120 GFLOP): dQ
// gets a kernel of its own that recomputes them, so no partial dQ crosses
// blocks (no fp32 dQ scratch, no turn counters, no atomics).
//
// Routes, a function of (dtype, D) alone (flash_attention_bwd_tiles; the
// wrapper's kernel.plan_bwd):
//  * bf16: four launches.  delta_kernel; dq_bf16_kernel and
//    dkdv_bf16_kernel, both warp-specialised TMA + wgmma kernels in the
//    forward's machinery (tma_wgmma.cuh: 4-D tensor maps over [B, S, H, D]
//    read in place through strides, 128-byte swizzle, 64-column boxes of 64
//    rows, mbarrier full / empty rings fed by one producer warp,
//    setmaxnreg 40 / 232); then dkdv_sum_kernel, while dK/dV's partials
//    are still in L2.
//  * fp32: plain FMAs in full fp32 (no TF32): delta_kernel, dkdv_f32_kernel
//    (one block per 64 keys x K/V head, the whole group's heads in order),
//    dq_f32_kernel (one block per 64 query rows x head).
//
// bf16 dK/dV (dkdv_bf16_kernel).  A unit is (128 keys, HPU = 2 query heads
// of one K/V group, K/V head, batch): two consumer warpgroups of 64 keys
// each hold their keys' dK and dV in fp32 registers, K and V stay in
// shared memory, and the unit walks its heads and, for each, the 64-row
// query tiles from its diagonal on, Q and dO coming through a 3-stage
// ring (the producer warp also stages each tile's lse * log2 e and delta,
// +inf and 0 past Sq, so rows past Sq give P = 0).  A step is four
// products in a warpgroup's natural orientation, keys as the M rows:
//   S^T  = K Q^T, dP^T = V dO^T   SS m64n64k16, both operands K-major;
//   P^T  = 2^(S^T * scale log2 e - lse log2 e) (one ex2.approx a score),
//   dS^T = P^T * (dP^T - delta), both rounded to bf16 and re-laid from the
//          accumulator registers as A fragments, as the forward re-lays P;
//   dV  += P^T dO, dK += dS^T Q   RS m64nDk16, dO and Q MN-major (the
//          transpose bit), read from the same swizzled tiles as the SS
//          products' K-major B operands.
// A warpgroup's step is serial (its dK, dV, S^T and dP^T take 192 of its
// 232 registers, so the next step's products cannot be in flight beside
// this step's P^T and dS^T fragments), and the two warpgroups take turns
// to issue through named barriers (ping-pong): one's P and dS run while
// the other's products hold the tensor cores.
// The GQA sum over the group crosses units: each unit writes its fp32
// partial dK (times 1 / sqrt(D)) and dV into scratch [2][splits][B][Skv]
// [Hkv][D] (splits = ceil(group / HPU)), and dkdv_sum_kernel adds the
// splits in order 0, 1, ... and rounds to bf16: a fixed order, no waits.
//
// bf16 dQ (dq_bf16_kernel).  A unit is (128 query rows, query head,
// batch), as the forward's blocks: two consumer warpgroups of 64 rows, Q
// and dO loaded once, K and V tiles of 64 keys through a 3-stage ring.  A
// step: S = Q K^T and dP = dO V^T (SS m64n64k16), dS = P (dP - delta) in
// registers, rounded to bf16, then dQ += dS K (RS m64nDk16, K MN-major).
// As the forward, step t issues S_t, dP_t and the dQ product of tile t - 1
// together and computes dS_t while that product runs, and the two
// warpgroups take turns to issue (ping-pong).
// dQ stays in registers across the key tiles (summed in key order), is
// scaled by 1 / sqrt(D), rounded, laid over the warpgroup's Q rows in
// shared memory and written 16 bytes a thread.
//
// Units and order.  At the training shape the dK/dV kernel has
// ceil(2048 / 128) x ceil(8 / 2) x 2 x 2 = 16 x 4 x 2 x 2 = 256 units on
// the 132 SMs (one 128-key unit per K/V head alone would give 64, under
// half the card); causal key tile j (of 16) sees query tiles 2j .. 31, so
// its units run 2 x (32 - 2j) = 64 - 4j steps: 64, 60, .., 4, 8704 in all,
// 66 an SM.  Blocks are numbered longest first (key tile ascending, then
// split, K/V head, batch; with an odd group a tile's last split holds one
// head and may be shorter than the next tile's units), so the block
// scheduler hands the longest units out first and the short ones fill the
// tail.  The dQ kernel has
// ceil(2048 / 128) x 16 x 2 = 512 units, query tile i (of 16) walking
// 2 (i + 1) key tiles, numbered from the last query tile down.  Each step
// waits only on its own producer: no block waits on another.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): flash_attention_bwd_launch returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for arguments the kernels do not take;
// flash_attention_bwd_tiles gives each route's tiles, which kernel.plan_bwd
// must equal.

#include "tma_wgmma.cuh"   // mbarriers, TMA, wgmma, tensor maps
#include <float.h>
#include <math.h>
#include <stdint.h>

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int THREADS = 128;  // fp32 kernels: four warps
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q; const void* k; const void* v; const void* o;
  const void* g;           // dO
  const float* lse;        // [B, Hq, Sq], natural log
  float* delta;            // [B, Hq, Sq]
  float* dkv_acc;          // bf16: fp32 partials [2][splits][B][Skv][Hkv][D]
  void* dq; void* dk; void* dv;   // contiguous [B, S, H, D]
  int B, Sq, Skv, Hq, Hkv, D;
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, gb, gs, gh;
  int causal, q_offset;
  int splits;              // bf16: dK/dV units per K/V tile and head
  float scale;             // 1 / sqrt(D)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
// delta: D_i = sum_d dO_id O_id, one warp per (b, s, h) row, 16 bytes a
// lane (rows are whole 16-byte pieces); the row's coordinates in 32-bit
// arithmetic where the rows allow it (a 64-bit division is a long
// software sequence, and this kernel is bound by the time to its loads)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(Params p) {
  constexpr int PER = 16 / sizeof(T);   // elements in a 16-byte piece
  const int64_t rows = (int64_t)p.B * p.Sq * p.Hq;
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  int h, s, b;
  if (rows <= 0x7fffffff) {
    const int r = (int)row, bs = r / p.Hq;
    h = r - bs * p.Hq;
    b = bs / p.Sq;
    s = bs - b * p.Sq;
  } else {
    const int64_t bs = row / p.Hq;
    h = (int)(row - bs * p.Hq);
    b = (int)(bs / p.Sq);
    s = (int)(bs - (int64_t)b * p.Sq);
  }
  const T* o = static_cast<const T*>(p.o) + b * p.ob + s * p.os + h * p.oh;
  const T* g = static_cast<const T*>(p.g) + b * p.gb + s * p.gs + h * p.gh;
  float acc = 0.0f;
  for (int d = lane * PER; d < p.D; d += 32 * PER) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + d);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + d);
    const T* x = reinterpret_cast<const T*>(&ov);
    const T* y = reinterpret_cast<const T*>(&gv);
#pragma unroll
    for (int e = 0; e < PER; ++e) acc = fmaf(to_f(x[e]), to_f(y[e]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[((int64_t)b * p.Hq + h) * p.Sq + s] = acc;
}

// ---------------------------------------------------------------------------
// bf16: TMA rings + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int KV_KEYS = 128;  // keys per dK/dV unit (2 warpgroups x 64)
constexpr int KV_Q = 64;      // query rows per dK/dV step
constexpr int DQ_Q = 128;     // query rows per dQ unit (2 warpgroups x 64)
constexpr int DQ_KEYS = 64;   // keys per dQ step
constexpr int HPU = 2;        // query heads per dK/dV unit
constexpr int BOX = 64;       // head-dim columns (128 bytes) and rows per box
constexpr int BOXB = BOX * 128;   // 8 KB: one box
constexpr int STAGES = 3;     // ring depth of both kernels
constexpr int WG_THREADS = 384;   // 2 consumer warpgroups + producer warpgroup

__host__ __device__ constexpr int dkdv_smem(int dp) {
  // 1 KB alignment slack, K and V (128 rows), the ring (Q and dO, 64 rows,
  // per stage), each stage's lse * log2 e and delta, the barriers
  return 1024 + dp / BOX * 2 * BOXB * 2 + STAGES * dp / BOX * BOXB * 2
         + STAGES * 2 * KV_Q * 4 + 8 * (1 + 2 * STAGES);
}
__host__ __device__ constexpr int dq_smem(int dp) {
  // slack, Q and dO (128 rows), the ring (K and V, 64 rows), the barriers
  return 1024 + dp / BOX * 2 * BOXB * 2 + STAGES * dp / BOX * BOXB * 2
         + 8 * (1 + 2 * STAGES);
}

// Shared memory: K, V (DP/64 boxes of 128 keys: two 64-row boxes each, one
// after the other, which is one 128-row swizzled box), then STAGES ring
// slots of {Q: DP/64 boxes of 64 rows, dO: the same}, then per stage
// lse * log2 e [64] and delta [64], then the barriers.
//
// wgmma accumulator layout (m64nN, f32): thread t of a warpgroup holds
// d[4j + 2h + b] = D[16 (t / 32) + (t % 32) / 4 + 8h][8j + 2 (t % 4) + b];
// here the rows are keys and the columns queries.
template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
dkdv_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_g, Params p) {
  constexpr int NB = DP / BOX;          // boxes per row
  constexpr int KTILE = NB * 2 * BOXB;  // K or V, 128 rows
  constexpr int QTILE = NB * BOXB;      // Q or dO, 64 rows
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles must start on a 1024-byte boundary
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = smem;
  uint8_t* sv = smem + KTILE;
  uint8_t* ring = sv + KTILE;
  float* rows = reinterpret_cast<float*>(ring + STAGES * 2 * QTILE);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows + STAGES * 2 * KV_Q);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  // the unit: key tile (ascending: the longest first under causal), then
  // split of the group, K/V head, batch
  const int per_kt = p.splits * p.Hkv * p.B;
  const int kt = blockIdx.x / per_kt;
  const int split = blockIdx.x % per_kt / (p.Hkv * p.B);
  const int hk = blockIdx.x / p.B % p.Hkv;
  const int b = blockIdx.x % p.B;
  const int grp = p.Hq / p.Hkv;
  const int h0 = hk * grp + split * HPU;          // its first query head
  const int key0 = kt * KV_KEYS;
  const int qt0 = p.causal ? max(0, key0 - p.q_offset) / KV_Q : 0;
  const int nq = (p.Sq + KV_Q - 1) / KV_Q - qt0;  // query tiles a head
  const int steps = min(HPU, grp - split * HPU) * nq;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      // the producer's expect_tx arrival and its warp's 32 row writes
      mbar_init(&full[s], 1 + 32);
      mbar_init(&empty[s], 8);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer warp: lane 0 issues every TMA copy; the warp stages
    // each query tile's lse * log2 e and delta ----------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid < 256 + 32) {
      const int lane = tid % 32;
      if (lane == 0) {
        prefetch_map(&map_q);
        prefetch_map(&map_k);
        prefetch_map(&map_v);
        prefetch_map(&map_g);
        mbar_expect_tx(kv_full, 2 * KTILE);
#pragma unroll
        for (int c = 0; c < NB; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            tma_load_4d(sk + c * 2 * BOXB + r * BOXB, &map_k, kv_full,
                        c * BOX, hk, key0 + r * BOX, b);
            tma_load_4d(sv + c * 2 * BOXB + r * BOXB, &map_v, kv_full,
                        c * BOX, hk, key0 + r * BOX, b);
          }
      }
      for (int it = 0; it < steps; ++it) {
        const int st = it % STAGES;
        const int h = h0 + it / nq;
        const int q0 = (qt0 + it % nq) * KV_Q;
        mbar_wait(&empty[st], (it / STAGES % 2) ^ 1);
        if (lane == 0) {
          uint8_t* slot = ring + st * 2 * QTILE;
          mbar_expect_tx(&full[st], 2 * QTILE);
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            tma_load_4d(slot + c * BOXB, &map_q, &full[st], c * BOX, h, q0,
                        b);
            tma_load_4d(slot + QTILE + c * BOXB, &map_g, &full[st], c * BOX,
                        h, q0, b);
          }
        }
        float* r = rows + st * 2 * KV_Q;
#pragma unroll
        for (int i = lane; i < KV_Q; i += 32) {
          const int q = q0 + i;
          const int64_t li = ((int64_t)b * p.Hq + h) * p.Sq + q;
          r[i] = q < p.Sq ? p.lse[li] * LOG2E : INFINITY;
          r[KV_Q + i] = q < p.Sq ? p.delta[li] : 0.0f;
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int k0 = key0 + 64 * wg;                   // its first key
    const int key_r = k0 + 16 * warp + lane / 4;     // this thread's (+ 8)
    const int col = 2 * (lane % 4);   // its first column in each 8-group
    const float scale2 = p.scale * LOG2E;

    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.0f;
    float s[32], dp[32];   // S^T and dP^T; each step's first k step overwrites
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    uint32_t pa[16], da[16];   // P^T and dS^T as A fragments

    const uint32_t ka = smem_u32(sk) + wg * (64 * 128);   // its K rows
    const uint32_t va = smem_u32(sv) + wg * (64 * 128);   // its V rows
    // The two warpgroups take turns to issue (named barrier 1 + w is
    // warpgroup w's turn; warpgroup 0 first), so one's P and dS overlap
    // the other's products: S^T, dP^T of warpgroup 0, then of 1, then
    // dV, dK of 0, then of 1, and so on.
    if (wg == 1) turn_arrive(0);
    mbar_wait(kv_full, 0);
    for (int it = 0; it < steps; ++it) {
      const int st = it % STAGES;
      const int q0 = (qt0 + it % nq) * KV_Q;
      mbar_wait(&full[st], it / STAGES % 2);
      const uint32_t qb = smem_u32(ring + st * 2 * QTILE);
      const uint32_t gb = qb + QTILE;
      // K's and V's descriptors are rebuilt each step (a few integer ops):
      // hoisted out of the loop they would hold 32 registers throughout
      uint32_t kr = ka, vr = va;
      asm volatile("" : "+r"(kr), "+r"(vr));
      // S^T = K Q^T, dP^T = V dO^T: +32 B within a box per k step; K and V
      // boxes are 16 KB apart, Q and dO boxes 8 KB
      turn_sync(wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t oa = (kk / 4) * 2 * BOXB + (kk % 4) * 32;
        const uint32_t ob = (kk / 4) * BOXB + (kk % 4) * 32;
        wgmma_ss_n64(s, smem_desc(kr + oa, 16, 1024),
                     smem_desc(qb + ob, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t oa = (kk / 4) * 2 * BOXB + (kk % 4) * 32;
        const uint32_t ob = (kk / 4) * BOXB + (kk % 4) * 32;
        wgmma_ss_n64(dp, smem_desc(vr + oa, 16, 1024),
                     smem_desc(gb + ob, 16, 1024), kk > 0);
      }
      wgmma_commit();
      turn_arrive(1 - wg);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // P^T and dS^T in fp32, rounded pairwise to bf16 into the A fragments
      // (accumulator elements 2q, 2q + 1: key row q % 2, queries qi, qi + 1
      // of the tile); masking only where the step straddles this
      // warpgroup's diagonal (a loop of its own)
      const float* lr = rows + st * 2 * KV_Q;
      if (p.causal && k0 + 63 > q0 + p.q_offset) {
        // key row r sees the tile's queries from first + 8 r on
        const int first = key_r - q0 - p.q_offset;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int qi = 8 * (q / 2) + col;
          const int lo = first + 8 * (q % 2);
          const float2 l2 = *reinterpret_cast<const float2*>(lr + qi);
          const float2 dl = *reinterpret_cast<const float2*>(lr + KV_Q + qi);
          const float p0 = qi >= lo ? ex2(s[2 * q] * scale2 - l2.x) : 0.0f;
          const float p1 = qi + 1 >= lo ? ex2(s[2 * q + 1] * scale2 - l2.y)
                                        : 0.0f;
          pa[q] = pack_bf16(p0, p1);
          da[q] = pack_bf16(qi >= lo ? p0 * (dp[2 * q] - dl.x) : 0.0f,
                            qi + 1 >= lo ? p1 * (dp[2 * q + 1] - dl.y)
                                         : 0.0f);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int qi = 8 * (q / 2) + col;
          const float2 l2 = *reinterpret_cast<const float2*>(lr + qi);
          const float2 dl = *reinterpret_cast<const float2*>(lr + KV_Q + qi);
          const float p0 = ex2(s[2 * q] * scale2 - l2.x);
          const float p1 = ex2(s[2 * q + 1] * scale2 - l2.y);
          pa[q] = pack_bf16(p0, p1);
          da[q] = pack_bf16(p0 * (dp[2 * q] - dl.x),
                            p1 * (dp[2 * q + 1] - dl.y));
        }
      }
      // dV += P^T dO, dK += dS^T Q: +16 query rows (2 KB) per k step
      turn_sync(wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KV_Q / 16; ++kk)
        WgmmaRS<DP>::run(dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                         pa[4 * kk + 3],
                         smem_desc(gb + kk * 16 * 128, BOXB, 1024));
#pragma unroll
      for (int kk = 0; kk < KV_Q / 16; ++kk)
        WgmmaRS<DP>::run(dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                         da[4 * kk + 3],
                         smem_desc(qb + kk * 16 * 128, BOXB, 1024));
      wgmma_commit();
      // warpgroup 1's last turn gives none back: warpgroup 0's first came
      // from it
      if (wg == 0 || it + 1 < steps) turn_arrive(1 - wg);
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(da);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // this split's partial dK (times 1 / sqrt(D)) and dV, fp32; keys past
    // Skv and columns past D are not stored
    const int64_t part = (int64_t)p.splits * p.B * p.Skv * p.Hkv * p.D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_r + 8 * r;
      if (key >= p.Skv) continue;
      float* ok = p.dkv_acc
                  + ((((int64_t)split * p.B + b) * p.Skv + key) * p.Hkv + hk)
                  * p.D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = 8 * j + col;
        if (c >= p.D) continue;   // D % 8 == 0: c + 1 < D too
        *reinterpret_cast<float2*>(ok + c) =
            make_float2(dk[4 * j + 2 * r] * p.scale,
                        dk[4 * j + 2 * r + 1] * p.scale);
        *reinterpret_cast<float2*>(ok + part + c) =
            make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dK, dV = the sum of the splits' partials, in split order, rounded to
// bf16; 4 elements a thread.
__global__ void __launch_bounds__(256) dkdv_sum_kernel(Params p) {
  const int64_t n = (int64_t)p.B * p.Skv * p.Hkv * p.D;   // one gradient
  const int64_t part = (int64_t)p.splits * n;
  for (int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x; i < n / 2;
       i += (int64_t)gridDim.x * 256) {
    const int which = i >= n / 4;                 // 0: dK, 1: dV
    const int64_t e = (i - which * (n / 4)) * 4;
    const float* src = p.dkv_acc + which * part + e;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int sp = 1; sp < p.splits; ++sp) {
      const float4 x = *reinterpret_cast<const float4*>(src + sp * n);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(which ? p.dv : p.dk);
    *reinterpret_cast<uint2*>(dst + e) =
        make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
  }
}

// Shared memory: Q, dO (DP/64 boxes of 128 rows, two 64-row boxes each),
// then STAGES ring slots of {K: DP/64 boxes of 64 keys, V: the same}, then
// the barriers.  Accumulator rows are query rows, columns keys (S, dP) or
// head-dim columns (dQ).
template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
dq_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_g, Params p) {
  constexpr int NB = DP / BOX;
  constexpr int QTILE = NB * 2 * BOXB;   // Q or dO, 128 rows
  constexpr int KTILE = NB * BOXB;       // K or V, 64 rows
  constexpr int CHUNK = 2 * BOXB;        // one 128-row box
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;
  uint8_t* sg = smem + QTILE;
  uint8_t* ring = sg + QTILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * KTILE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  // the unit: the last query tile (the most keys under causal) first, the
  // query heads of one K/V group side by side
  const int n_qt = (p.Sq + DQ_Q - 1) / DQ_Q;
  const int hb = blockIdx.x % (p.Hq * p.B);
  const int qt = n_qt - 1 - blockIdx.x / (p.Hq * p.B);
  const int h = hb % p.Hq, b = hb / p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * DQ_Q;
  const int last_q = min(q0 + DQ_Q, p.Sq) - 1;
  const int kv_end = p.causal ? min(p.Skv, p.q_offset + last_q + 1) : p.Skv;
  const int n_tiles = (kv_end + DQ_KEYS - 1) / DQ_KEYS;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every TMA copy ---------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 256) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      prefetch_map(&map_g);
      mbar_expect_tx(q_full, 2 * QTILE);
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tma_load_4d(sq + c * CHUNK + r * BOXB, &map_q, q_full, c * BOX, h,
                      q0 + r * BOX, b);
          tma_load_4d(sg + c * CHUNK + r * BOXB, &map_g, q_full, c * BOX, h,
                      q0 + r * BOX, b);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        mbar_wait(&empty[st], (t / STAGES % 2) ^ 1);
        uint8_t* slot = ring + st * 2 * KTILE;
        mbar_expect_tx(&full[st], 2 * KTILE);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(slot + c * BOXB, &map_k, &full[st], c * BOX, hk,
                      t * DQ_KEYS, b);
          tma_load_4d(slot + KTILE + c * BOXB, &map_v, &full[st], c * BOX,
                      hk, t * DQ_KEYS, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int row0 = q0 + 64 * wg;                   // its first query row
    const int qrow = row0 + 16 * warp + lane / 4;    // this thread's (+ 8)
    const int col = 2 * (lane % 4);
    const float scale2 = p.scale * LOG2E;
    float lse2[2], dl[2];
    int lim[2];   // the last key row r sees
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + 8 * r;
      const int64_t li = ((int64_t)b * p.Hq + h) * p.Sq + row;
      lse2[r] = row < p.Sq ? p.lse[li] * LOG2E : INFINITY;
      dl[r] = row < p.Sq ? p.delta[li] : 0.0f;
      lim[r] = p.causal ? min(p.Skv - 1, row + p.q_offset) : p.Skv - 1;
    }

    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.0f;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    uint32_t pa[16];   // dS as the A fragment of dQ += dS K

    const uint32_t qa = smem_u32(sq) + wg * (64 * 128);   // its Q rows
    const uint32_t ga = smem_u32(sg) + wg * (64 * 128);   // its dO rows
    // S = Q K^T and dP = dO V^T from slot `slot`: +32 B within a box per
    // k step, Q's and dO's boxes 16 KB apart, K's and V's 8 KB
    auto issue_sdp = [&](int slot) {
      const uint32_t kb = smem_u32(ring + slot * 2 * KTILE);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t oa = (kk / 4) * CHUNK + (kk % 4) * 32;
        const uint32_t ob = (kk / 4) * BOXB + (kk % 4) * 32;
        wgmma_ss_n64(s, smem_desc(qa + oa, 16, 1024),
                     smem_desc(kb + ob, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t oa = (kk / 4) * CHUNK + (kk % 4) * 32;
        const uint32_t ob = (kk / 4) * BOXB + (kk % 4) * 32;
        wgmma_ss_n64(dp, smem_desc(ga + oa, 16, 1024),
                     smem_desc(kb + KTILE + ob, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // dQ += dS K from slot `slot`: +16 keys (2 KB) per k step
    auto issue_dq = [&](int slot) {
      const uint32_t kb = smem_u32(ring + slot * 2 * KTILE);
#pragma unroll
      for (int kk = 0; kk < DQ_KEYS / 16; ++kk)
        WgmmaRS<DP>::run(dq, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                         pa[4 * kk + 3],
                         smem_desc(kb + kk * 16 * 128, BOXB, 1024));
      wgmma_commit();
    };
    // dS = P (dP - delta) of key tile t into s, fp32; masking only where
    // the tile straddles this warpgroup's diagonal or Skv
    auto ds = [&](int t) {
      fence_regs(s);
      fence_regs(dp);
      const int kv0 = t * DQ_KEYS;
      if (kv0 + DQ_KEYS > p.Skv
          || (p.causal && kv0 + DQ_KEYS - 1 > row0 + p.q_offset)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = kv0 + 8 * (i / 4) + col + i % 2;
          const int r = (i / 2) % 2;
          s[i] = key <= lim[r]
                 ? ex2(s[i] * scale2 - lse2[r]) * (dp[i] - dl[r]) : 0.0f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i / 2) % 2;
          s[i] = ex2(s[i] * scale2 - lse2[r]) * (dp[i] - dl[r]);
        }
      }
    };
    // dS rounded to bf16 pairwise into the A fragment of the next dQ
    // product (once the previous one has read pa)
    auto pack = [&]() {
#pragma unroll
      for (int q = 0; q < 16; ++q) pa[q] = pack_bf16(s[2 * q], s[2 * q + 1]);
    };
    // the dQ product of the tile in `slot` has landed: its slot is free
    auto release = [&](int slot) {
      fence_regs(dq);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&empty[slot]);
    };

    // As the forward: step t issues S_t, dP_t and dQ += dS_{t-1} K_{t-1}
    // together, then computes dS_t while that dQ product and the other
    // warpgroup's products hold the tensor cores; named barrier 1 + w is
    // warpgroup w's turn to issue (warpgroup 0 first).  The first tile's
    // S, dP and the last tile's dQ product are issued outside the loop:
    // ptxas serializes every wgmma that sits in a branch.
    if (wg == 1) turn_arrive(0);
    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    turn_sync(wg);
    wgmma_fence();
    issue_sdp(0);
    turn_arrive(1 - wg);
    wgmma_wait<0>();
    ds(0);
    pack();
    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % STAGES, pst = (t - 1) % STAGES;
      mbar_wait(&full[st], t / STAGES % 2);
      turn_sync(wg);
      wgmma_fence();
      issue_sdp(st);
      issue_dq(pst);
      turn_arrive(1 - wg);
      wgmma_wait<1>();
      ds(t);
      wgmma_wait<0>();
      release(pst);
      pack();
    }
    // the last tile's dQ product (warpgroup 1 has had one turn fewer
    // given to it: warpgroup 0's first came from it)
    const int pst = (n_tiles - 1) % STAGES;
    turn_sync(wg);
    wgmma_fence();
    issue_dq(pst);
    if (wg == 0) turn_arrive(1);
    wgmma_wait<0>();
    release(pst);

    // dQ / sqrt(D), rounded to bf16 and laid over this warpgroup's Q rows
    // (its last S product has run) in the swizzled layout, then written
    // out 16 bytes a thread, whole rows per warp.  Rows past Sq are not
    // stored.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + lane / 4 + 8 * r;   // in the warpgroup
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const uint32_t h2 = pack_bf16(dq[4 * j + 2 * r] * p.scale,
                                      dq[4 * j + 2 * r + 1] * p.scale);
        const uint32_t addr = qa + (j / 8) * CHUNK + row * 128
                              + ((j % 8) ^ (row % 8)) * 16 + (lane % 4) * 4;
        asm volatile("st.shared.b32 [%0], %1;" :: "r"(addr), "r"(h2)
                     : "memory");
      }
    }
    asm volatile("bar.sync %0, 128;" :: "r"(3 + wg) : "memory");
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.dq);
#pragma unroll
    for (int k = 0; k < 64 * DP / 8 / 128; ++k) {
      const int i = k * 128 + tid % 128;
      const int row = i / (DP / 8), g = i % (DP / 8);   // g: 8 columns
      if (row0 + row >= p.Sq || 8 * g >= p.D) continue;   // D % 8 == 0
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(qa + (g / 8) * CHUNK + row * 128
                         + ((g % 8) ^ (row % 8)) * 16)
                   : "memory");
      *reinterpret_cast<uint4*>(
          out + (((int64_t)b * p.Sq + row0 + row) * p.Hq + h) * p.D
          + 8 * g) = v;
    }
  }
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
static int launch_bf16(Params p, const long long* s, cudaStream_t st) {
  // every map has 64-row boxes; a 128-row tile is two of them
  CUtensorMap mq, mk, mv, mg;
  if (!make_map(&mq, p.q, p.B, p.Sq, p.Hq, p.D, s[0], s[1], s[2], BOX)
      || !make_map(&mk, p.k, p.B, p.Skv, p.Hkv, p.D, s[3], s[4], s[5], BOX)
      || !make_map(&mv, p.v, p.B, p.Skv, p.Hkv, p.D, s[6], s[7], s[8], BOX)
      || !make_map(&mg, p.g, p.B, p.Sq, p.Hq, p.D, s[12], s[13], s[14], BOX))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = smem_attr(dkdv_bf16_kernel<DP>, dkdv_smem(DP));
    if (err == cudaSuccess) err = smem_attr(dq_bf16_kernel<DP>, dq_smem(DP));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  p.splits = (p.Hq / p.Hkv + HPU - 1) / HPU;
  const long long kv_units = (long long)(p.Skv + KV_KEYS - 1) / KV_KEYS
                             * p.splits * p.Hkv * p.B;
  const long long q_units = (long long)(p.Sq + DQ_Q - 1) / DQ_Q * p.Hq * p.B;
  if (kv_units > 0x7fffffffLL || q_units > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // dQ first, then dK/dV and the sum of its partials while they are still
  // in L2 (33.5 MB at the training shape, of 50 MB)
  dq_bf16_kernel<DP><<<(unsigned)q_units, WG_THREADS, dq_smem(DP), st>>>(
      mq, mk, mv, mg, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_bf16_kernel<DP><<<(unsigned)kv_units, WG_THREADS, dkdv_smem(DP), st>>>(
      mq, mk, mv, mg, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long quads = (long long)p.B * p.Skv * p.Hkv * p.D / 2;
  const long long sum_blocks = (quads + 255) / 256;
  dkdv_sum_kernel<<<(unsigned)(sum_blocks < 132 * 8 ? sum_blocks : 132 * 8),
                    256, 0, st>>>(p);
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

static int head_pad(int D) { return D <= 64 ? 64 : 128; }

// out = {block_kv, block_q, dq_block_q, dq_block_kv, heads, head_pad} of
// the route dtype takes at head dim D, as kernel.plan_bwd states them:
// keys per dK/dV unit, query rows per dK/dV step, query rows per dQ unit,
// keys per dQ step, query heads per dK/dV unit (0: the whole group), the
// head dim a tile holds; 0, or cudaErrorInvalidValue.
extern "C" int flash_attention_bwd_tiles(int dtype, int D, int* out) {
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16) {
    out[0] = KV_KEYS; out[1] = KV_Q; out[2] = DQ_Q; out[3] = DQ_KEYS;
    out[4] = HPU;
  } else if (dtype == DT_F32) {
    out[0] = 64; out[1] = 64; out[2] = 64; out[3] = 64; out[4] = 0;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  out[5] = head_pad(D);
  return 0;
}

// strides: the (b, s, h) strides in elements of q, k, v, o and dO, in that
// order (15 values; the head dim is contiguous).  lse is the forward's
// [B, Hq, Sq] natural log-sum-exp; delta is [B, Hq, Sq] fp32 scratch;
// dkv_acc (bf16 only; null for fp32) is fp32 scratch of 2 x splits x B x
// Skv x Hkv x D elements, splits = ceil((Hq / Hkv) / heads) of
// flash_attention_bwd_tiles; dq, dk and dv are written contiguous [B, S,
// H, D] in the operands' dtype.  scale is 1 / sqrt(D).  Rows must be
// 16-byte pieces: D and every stride a multiple of 8 (bf16) or 4 (fp32)
// elements, every base 16-byte aligned.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const float* lse, float* delta, float* dkv_acc, void* dq,
    void* dk, void* dv, int dtype, int B, int Sq, int Skv, int Hq, int Hkv,
    int D, const long long* strides, int causal, float scale, void* stream) {
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
  if (dtype == DT_BF16 && (dkv_acc == nullptr || !aligned16(dkv_acc)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.g = g;
  p.lse = lse; p.delta = delta; p.dkv_acc = dkv_acc;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.Hq = Hq; p.Hkv = Hkv; p.D = D;
  p.qb = strides[0]; p.qs = strides[1]; p.qh = strides[2];
  p.kb = strides[3]; p.ks = strides[4]; p.kh = strides[5];
  p.vb = strides[6]; p.vs = strides[7]; p.vh = strides[8];
  p.ob = strides[9]; p.os = strides[10]; p.oh = strides[11];
  p.gb = strides[12]; p.gs = strides[13]; p.gh = strides[14];
  p.causal = causal;
  p.q_offset = causal ? Skv - Sq : 0;
  p.splits = 1;
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
  if (dtype == DT_BF16)
    return head_pad(D) == 64 ? launch_bf16<64>(p, strides, st)
                             : launch_bf16<128>(p, strides, st);
  return head_pad(D) == 64 ? launch_f32<64>(p, st) : launch_f32<128>(p, st);
}
