// Online-softmax (flash) attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel (body _flash_kernel): causal or non-causal
// attention with an fp32 running max m, sum l and accumulator acc, GQA
// through q head -> K/V head hq / (Hq / Hkv), causal queries aligned to the
// end of the keys (q_offset = Skv - Sq), tiles wholly above the diagonal
// skipped, masked scores at finfo(float32).min, p rounded to v's dtype
// before the PV product, and l == 0 -> 1 at the end.  Reads the
// [B, S, H, D] layout in place through strides (no transposes, no K/V
// repeat) and writes o contiguous [B, Sq, Hq, D].
//
// What bounds it on the H100: at the forward's shape (B=2, S=2048, 16 query
// heads over 2 K/V heads, head dim 128) the causal products are 34 GFLOP
// against 38 MB of q/k/v/o, so tensor-core FLOPs bound it (989 TFLOP/s
// bf16, about 35 us); at the padded prefill's (B=4, S=512) the bytes
// (about 6 us).  The score matrix never leaves the SM.
//
// Routes, a function of (dtype, D, alignment) alone -- never of B, Sq or
// Skv, so a query row's arithmetic never depends on how many rows run:
//  * bf16 (D % 8 == 0, 16-byte aligned base and strides: TMA-addressable):
//    the warp-specialised TMA + wgmma kernel below, 128-key K/V tiles.
//    The wrapper (ops.py) copies a layout TMA cannot address (a misaligned
//    base or stride, D % 8 != 0: D zero-padded to a multiple of 8, which
//    changes no score) before it launches; this entry refuses one.
//  * fp32: plain FMAs in full fp32 (no TF32), 64-key K/V tiles, expf.
//
// bf16 design.  One block per (128 query rows, query head, batch): two
// consumer warpgroups of 64 rows each and one producer warpgroup whose
// single thread issues every TMA copy.  Q is loaded once; K and V tiles of
// 128 keys go through a 3-stage ring with full (per K and per V) and empty
// mbarriers, all 128-byte swizzled, the head dim cut into 64-column boxes
// (D = 24 reads one box, its columns past D zero-filled by TMA).
//  * Step t of a warpgroup issues S_t = Q K_t^T and O += P_{t-1} V_{t-1}
//    back to back, then runs tile t's softmax while its PV product and the
//    other warpgroup's two products hold the tensor cores; two named
//    barriers make the warpgroups take turns to issue (ping-pong), so one
//    warpgroup's softmax overlaps the other's products.  The first tile's
//    QK^T and the last tile's PV are issued outside the loop: ptxas
//    serializes every wgmma that sits in a branch.
//  * S = Q K^T is an SS wgmma m64n128k16 (Q and K both K-major).
//  * The softmax runs on the accumulator registers: a row's 32 values per
//    thread, its max and sum reduced across the row's 4 threads by
//    shuffles.  The scale is folded into a base-2 exponent (scores times
//    log2(e) / sqrt(D), one ex2.approx each, as ref.flash_attention_ref
//    does in bf16): accurate expf costs about ten instructions a score,
//    and the two warpgroups' softmaxes share each SM sub-partition's
//    issue slots.  Masking runs only on the tiles that straddle this
//    warpgroup's diagonal or Skv, in a loop of its own: folded into the
//    one loop as a select, its integer work ran on every tile.
//  * O += P V is an RS wgmma m64nDPk16: P is the S accumulator rounded to
//    bf16 and re-laid in registers as the A fragment (the m64nN f32
//    accumulator and the 16-bit A fragment line up pairwise: A register
//    q of k step kk holds accumulator elements 2q, 2q+1 of that step); V
//    [keys, D] is the MN-major B operand read in place (transpose bit).
//    O stays in registers for the whole K/V loop, is rescaled by alpha
//    there, and divided by l once at the end; then it is rounded to bf16,
//    laid over the warpgroup's own Q rows in shared memory (swizzled) and
//    written out 16 bytes a thread, whole rows per warp (the fragment
//    layout's own 4-byte stores cost several microseconds a call).
//  * Causal order: block x runs query tile n_qt - 1 - x / (Hq B), so the
//    longest query tiles (the last) start first, and the query heads of
//    one K/V group run side by side (their K/V tiles shared in L2).
//  * A row's K/V tiles are the same set in the same order whatever Sq is:
//    a tile wholly masked for a row (it lies past the row's diagonal but
//    not past its block's) gives p = 0 and alpha = 1, so m, l and acc stay
//    bitwise unchanged.  Rows past Sq compute on TMA's zero rows and are
//    not stored.
//
// The backward (flash_attention_bwd.cu) needs each query row's natural
// log-sum-exp of its scaled scores: given an `lse` pointer, both routes
// write it, fp32 [B, Hq, Sq], from the m and l they already hold (the bf16
// route's m is in base 2: lse = (m + log2 l) ln 2).  The forward, serving
// and prefill paths pass null, and then nothing else changes.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): flash_attention_launch returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take;
// flash_attention_tiles gives each route's tiles, which kernel.plan (and
// through it the plain version) must equal.

#include "tma_wgmma.cuh"   // mbarriers, TMA, wgmma, tensor maps
#include <float.h>
#include <math.h>
#include <stdint.h>

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr float NEG_INF = -FLT_MAX;   // finfo(float32).min, as the TPU kernel

// ---------------------------------------------------------------------------
// bf16: TMA ring + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int TQ = 128;       // query rows per block (2 warpgroups x 64)
constexpr int TKV = 128;      // keys per K/V tile (fixed: see above)
constexpr int BOX = 64;       // head-dim columns per TMA box (128 bytes)
constexpr int CHUNK = TQ * BOX * 2;   // 16 KB: 128 rows of one box
constexpr int STAGES = 3;     // K/V ring depth
constexpr int THREADS = 384;  // 2 consumer warpgroups + producer warpgroup
static_assert(TQ == TKV, "Q and K/V boxes share one shape");

__host__ __device__ constexpr int bf16_smem(int dp) {
  // 1 KB alignment slack, Q, the ring (K and V per stage), the barriers
  return 1024 + dp / BOX * CHUNK * (1 + 2 * STAGES) + 8 * (1 + 3 * STAGES);
}

struct Bf16Params {
  void* o;
  float* lse;   // [B, Hq, Sq] or null
  int B, Sq, Skv, Hq, Hkv, D;
  int causal, q_offset, n_qt;
  float scale;
};

// Shared memory: Q (DP/64 boxes of 128 rows), then STAGES ring slots of
// {K: DP/64 boxes of 128 keys, V: the same}, then the barriers.
//
// wgmma accumulator layout (m64nN, f32): thread t of a warpgroup holds
// d[4j + 2h + b] = D[16 (t / 32) + (t % 32) / 4 + 8h][8j + 2 (t % 4) + b].
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, Bf16Params p) {
  constexpr int NB = DP / BOX;          // boxes per row
  constexpr int TILE = NB * CHUNK;      // Q, K or V of one tile
  constexpr int STAGE = 2 * TILE;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles must start on a 1024-byte boundary
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem + TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int hb = blockIdx.x % (p.Hq * p.B);
  const int qt = p.n_qt - 1 - blockIdx.x / (p.Hq * p.B);   // heaviest first
  const int h = hb % p.Hq, b = hb / p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * TQ;
  const int last_q = min(q0 + TQ, p.Sq) - 1;
  const int kv_end = p.causal ? min(p.Skv, p.q_offset + last_q + 1) : p.Skv;
  const int n_tiles = (kv_end + TKV - 1) / TKV;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);   // the producer's expect_tx arrivals
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer warpgroup: one thread issues every TMA copy ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 256) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      mbar_expect_tx(q_full, TILE);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load_4d(smem + c * CHUNK, &map_q, q_full, c * BOX, h, q0, b);
      int st = 0, ph = 0;
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(&empty[st], ph ^ 1);
        uint8_t* slot = ring + st * STAGE;
        mbar_expect_tx(&k_full[st], TILE);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load_4d(slot + c * CHUNK, &map_k, &k_full[st], c * BOX, hk,
                      t * TKV, b);
        mbar_expect_tx(&v_full[st], TILE);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load_4d(slot + TILE + c * CHUNK, &map_v, &v_full[st], c * BOX,
                      hk, t * TKV, b);
        if (++st == STAGES) { st = 0; ph ^= 1; }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ------------------------
    // Step t issues S_t = Q K_t^T and O += P_{t-1} V_{t-1} together, then
    // runs tile t's softmax while the other warpgroup's products hold the
    // tensor cores: named barrier 1 + w is warpgroup w's turn to issue, so
    // the two warpgroups' products alternate (warpgroup 0 first).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int row0 = q0 + 64 * wg;                 // its first query row
    const int wg_first = p.q_offset + row0;        // and that row's position
    // the position of this thread's first row (its second is 8 later)
    const int qpos = wg_first + 16 * warp + lane / 4;
    const int col = 2 * (lane % 4);   // its first column in each 8-group

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
    float s[64];   // a tile's scores; each tile's first k step overwrites
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.0f;
    uint32_t pa[32];   // the previous tile's p: A fragment of its PV
#pragma unroll
    for (int i = 0; i < 32; ++i) pa[i] = 0u;

    const uint32_t qa = smem_u32(smem) + wg * (64 * 128);   // its Q rows
    // S = Q K^T (unscaled, fp32) from slot `slot`: +32 B within a box per
    // k step
    auto issue_qk = [&](int slot) {
      const uint32_t kb = smem_u32(ring + slot * STAGE);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * CHUNK + (kk % 4) * 32;
        wgmma_ss_n128(s, smem_desc(qa + off, 16, 1024),
                      smem_desc(kb + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V from slot `slot`: +16 keys (2 KB) per k step, the head
    // dim's 64-column boxes 16 KB apart
    auto issue_pv = [&](int slot) {
      const uint32_t vb = smem_u32(ring + slot * STAGE + TILE);
#pragma unroll
      for (int kk = 0; kk < TKV / 16; ++kk)
        WgmmaRS<DP>::run(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                         pa[4 * kk + 3],
                         smem_desc(vb + kk * 16 * 128, CHUNK, 1024));
      wgmma_commit();
    };
    // online softmax over tile t's scores, in fp32, base 2: s becomes p,
    // m and l move on, alpha rescales the previous tiles' o
    float alpha[2];
    auto softmax = [&](int t) {
      fence_regs(s);
      const int kv0 = t * TKV;
      if (kv0 + TKV > p.Skv || (p.causal && kv0 + TKV - 1 > wg_first)) {
        // the tile straddles this warpgroup's diagonal or Skv: row r sees
        // the keys up to lim[r].  A loop of its own, so that the fully
        // visible tiles run none of this
        int lim[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          lim[r] = p.causal ? min(p.Skv - 1, qpos + 8 * r) : p.Skv - 1;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = kv0 + 8 * (i / 4) + col + i % 2;
          s[i] = key <= lim[(i / 2) % 2] ? s[i] * p.scale : NEG_INF;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] *= p.scale;
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < 64; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        s[i] = ex2(s[i] - m[(i / 2) % 2]);
        sum[(i / 2) % 2] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = alpha[r] * l[r] + sum[r];
      }
    };
    // o *= alpha, and p rounded to bf16 pairwise into the A fragment of
    // the next PV product (once the previous one has read pa)
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i / 2) % 2];
#pragma unroll
      for (int q = 0; q < 32; ++q) pa[q] = pack_bf16(s[2 * q], s[2 * q + 1]);
    };
    // the PV product of the tile in `slot` has landed: its slot is free
    auto release = [&](int slot) {
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&empty[slot]);
    };

    if (wg == 1) turn_arrive(0);   // warpgroup 0 issues first
    mbar_wait(q_full, 0);
    // tile 0: its QK^T alone
    mbar_wait(&k_full[0], 0);
    turn_sync(wg);
    wgmma_fence();
    issue_qk(0);
    turn_arrive(1 - wg);
    wgmma_wait<0>();
    softmax(0);
    rescale_and_pack();
    // tiles 1 .. n-1: QK^T of tile t beside PV of tile t - 1
    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % STAGES, pst = (t - 1) % STAGES;
      mbar_wait(&k_full[st], t / STAGES % 2);
      mbar_wait(&v_full[pst], (t - 1) / STAGES % 2);
      turn_sync(wg);
      wgmma_fence();
      issue_qk(st);
      issue_pv(pst);
      turn_arrive(1 - wg);
      wgmma_wait<1>();
      softmax(t);
      wgmma_wait<0>();
      release(pst);
      rescale_and_pack();
    }
    // PV of the last tile (warpgroup 1 has had one turn fewer given to it:
    // warpgroup 0's first came from it)
    const int pst = (n_tiles - 1) % STAGES;
    mbar_wait(&v_full[pst], (n_tiles - 1) / STAGES % 2);
    turn_sync(wg);
    wgmma_fence();
    issue_pv(pst);
    if (wg == 0) turn_arrive(1);
    wgmma_wait<0>();
    release(pst);

    // o / l (l == 0 -> 1), rounded to bf16 and laid over this warpgroup's
    // Q rows (its last QK^T has run) in the swizzled layout, so that the
    // fragment writes are free of bank conflicts; then written out 16
    // bytes a thread, whole rows per warp.  Rows past Sq are not stored.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float denom = l[r] == 0.0f ? 1.0f : l[r];
      const int row = 16 * warp + lane / 4 + 8 * r;   // in the warpgroup
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const uint32_t h2 = pack_bf16(o[4 * j + 2 * r] / denom,
                                      o[4 * j + 2 * r + 1] / denom);
        const uint32_t addr = qa + (j / 8) * CHUNK + row * 128
                              + ((j % 8) ^ (row % 8)) * 16 + (lane % 4) * 4;
        asm volatile("st.shared.b32 [%0], %1;" :: "r"(addr), "r"(h2)
                     : "memory");
      }
    }
    if (p.lse != nullptr && lane % 4 == 0) {   // a row's 4 threads agree
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * warp + lane / 4 + 8 * r;
        if (row < p.Sq)
          p.lse[((int64_t)b * p.Hq + h) * p.Sq + row] =
              (m[r] + log2f(l[r])) * 0.6931471805599453f;
      }
    }
    asm volatile("bar.sync %0, 128;" :: "r"(3 + wg) : "memory");
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(p.o);
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
// fp32: plain FMAs, 64 query rows x 64-key tiles, 128 threads
// ---------------------------------------------------------------------------

constexpr int FBQ = 64;       // query rows per block
constexpr int FBKV = 64;      // keys per tile (fixed: see above)
constexpr int FTHREADS = 128;
constexpr int S_LD = FBKV + 4;   // fp32 score tile stride

struct F32Params {
  const float* q; const float* k; const float* v; float* o;
  float* lse;   // [B, Hq, Sq] or null
  int B, Sq, Skv, Hq, Hkv, D;
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh;   // strides, in elements
  int causal, q_offset, vec;
  float scale;
};

__host__ __device__ constexpr int align128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

template <int DP>
struct F32Smem {
  static constexpr int LD = DP + 8;   // q/k/v tile stride (16-byte rows)
  static constexpr int TILE = align128(FBQ * LD * 4);
  static constexpr int S_BYTES = align128(FBQ * S_LD * 4);
  static constexpr int TOTAL = 3 * TILE + S_BYTES;
};

// 16 bytes global -> shared without passing through registers; with
// `valid` false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows [row0, row0 + FBQ) of one head into a [FBQ][LD] tile; rows past
// `rows` and columns past D are zero.  With `vec` (16-byte aligned rows)
// the copy is asynchronous: the caller commits it as a group and waits.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          int64_t row_stride, int row0,
                                          int rows, int D, int vec) {
  constexpr int LD = F32Smem<DP>::LD;
  if (vec) {
    constexpr int PER_ROW = DP / 4;
    static_assert(FBQ * PER_ROW % FTHREADS == 0, "whole copies per thread");
#pragma unroll
    for (int it = 0; it < FBQ * PER_ROW / FTHREADS; ++it) {
      int i = it * FTHREADS + threadIdx.x;
      int r = i / PER_ROW, c = (i % PER_ROW) * 4;
      bool ok = row0 + r < rows && c < D;
      cp_async16(dst + r * LD + c,
                 ok ? base + (int64_t)(row0 + r) * row_stride + c : base,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < FBQ * DP; i += FTHREADS) {
      int r = i / DP, c = i % DP;
      float val = 0.0f;
      if (row0 + r < rows && c < D)
        val = base[(int64_t)(row0 + r) * row_stride + c];
      dst[r * LD + c] = val;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(FTHREADS) flash_f32_kernel(F32Params p) {
  using S = F32Smem<DP>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(128) unsigned char fsmem[];
  float* Qs = reinterpret_cast<float*>(fsmem);
  float* Ks = reinterpret_cast<float*>(fsmem + S::TILE);
  float* Vs = reinterpret_cast<float*>(fsmem + 2 * S::TILE);
  float* Ss = reinterpret_cast<float*>(fsmem + 3 * S::TILE);   // scores

  const int q0 = blockIdx.x * FBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const float* qbase = p.q + b * p.qb + h * p.qh;
  const float* kbase = p.k + b * p.kb + hk * p.kh;
  const float* vbase = p.v + b * p.vb + hk * p.vh;

  // thread -> (row, half): a row's softmax and accumulator belong to two
  // threads of one warp, each taking every other column
  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;
  const int qpos = p.q_offset + q0 + r;   // absolute query position

  float acc[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.0f;
  float m = NEG_INF, l = 0.0f;

  const int last_q = min(q0 + FBQ, p.Sq) - 1;
  const int kv_end = p.causal ? min(p.Skv, p.q_offset + last_q + 1) : p.Skv;
  const int n_tiles = (kv_end + FBKV - 1) / FBKV;

  // copy groups in commit order: {Q, K_0}, {V_0}, then per tile t
  // {K_t+1} once K_t is consumed and {V_t+1} once V_t is: the next K
  // lands during this tile's softmax and PV, the next V during the next
  // tile's QK^T
  load_tile<DP>(Qs, qbase, p.qs, q0, p.Sq, p.D, p.vec);
  load_tile<DP>(Ks, kbase, p.ks, 0, p.Skv, p.D, p.vec);
  cp_async_commit();
  load_tile<DP>(Vs, vbase, p.vs, 0, p.Skv, p.D, p.vec);
  cp_async_commit();

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * FBKV;
    cp_async_wait<1>();   // Q and K_t have landed (V_t may be in flight)
    __syncthreads();

    // S = Q K^T (unscaled, fp32)
    for (int j = 0; j < FBKV / 2; ++j) {
      int c = half + 2 * j;
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d)
        s = fmaf(Qs[r * LD + d], Ks[c * LD + d], s);
      Ss[r * S_LD + c] = s;
    }
    __syncthreads();   // every warp is done with K_t
    if (t + 1 < n_tiles)
      load_tile<DP>(Ks, kbase, p.ks, kv0 + FBKV, p.Skv, p.D, p.vec);
    cp_async_commit();   // {K_t+1}, empty on the last tile

    // online softmax over this tile's scores, in fp32
    float mx = NEG_INF;
    for (int j = 0; j < FBKV / 2; ++j) {
      int c = half + 2 * j;
      int kpos = kv0 + c;
      float s = Ss[r * S_LD + c] * p.scale;
      bool ok = kpos < p.Skv && (!p.causal || kpos <= qpos);
      s = ok ? s : NEG_INF;
      Ss[r * S_LD + c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.0f;
    for (int j = 0; j < FBKV / 2; ++j) {
      int c = half + 2 * j;
      float e = expf(Ss[r * S_LD + c] - m_new);
      sum += e;
      Ss[r * S_LD + c] = e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = alpha * l + sum;
    m = m_new;
    cp_async_wait<1>();   // V_t has landed (K_t+1 may be in flight)
    __syncthreads();

    // acc = alpha * acc + P V
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) {
      int c = half + 2 * j;
      float pv = 0.0f;
      for (int kk = 0; kk < FBKV; ++kk)
        pv = fmaf(Ss[r * S_LD + kk], Vs[kk * LD + c], pv);
      acc[j] = alpha * acc[j] + pv;
    }
    __syncthreads();   // every warp is done with V_t and the scores
    if (t + 1 < n_tiles)
      load_tile<DP>(Vs, vbase, p.vs, kv0 + FBKV, p.Skv, p.D, p.vec);
    cp_async_commit();   // {V_t+1}, empty on the last tile
  }
  cp_async_wait<0>();

  const int row = q0 + r;
  if (row < p.Sq) {
    if (p.lse != nullptr && half == 0)
      p.lse[((int64_t)b * p.Hq + h) * p.Sq + row] = m + logf(l);
    const float denom = l == 0.0f ? 1.0f : l;
    float* out = p.o + (((int64_t)b * p.Sq + row) * p.Hq + h) * p.D;
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) {
      int c = half + 2 * j;
      if (c < p.D) out[c] = acc[j] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------


template <int DP>
static int launch_bf16(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                       const long long* s, int causal, float scale,
                       cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, Sq, Hq, D, s[0], s[1], s[2], TQ)
      || !make_map(&mk, k, B, Skv, Hkv, D, s[3], s[4], s[5], TKV)
      || !make_map(&mv, v, B, Skv, Hkv, D, s[6], s[7], s[8], TKV))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = bf16_smem(DP);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  Bf16Params p;
  p.o = o;
  p.lse = lse;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.Hq = Hq; p.Hkv = Hkv; p.D = D;
  p.causal = causal;
  p.q_offset = causal ? Skv - Sq : 0;
  p.n_qt = (Sq + TQ - 1) / TQ;
  p.scale = scale;
  const long long blocks = (long long)p.n_qt * Hq * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bf16_kernel<DP><<<(unsigned)blocks, THREADS, smem, st>>>(mq, mk, mv,
                                                                  p);
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_f32(const F32Params& p, cudaStream_t st) {
  constexpr int bytes = F32Smem<DP>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + FBQ - 1) / FBQ, p.Hq, p.B);
  flash_f32_kernel<DP><<<grid, FTHREADS, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

static bool aligned16(const void* q, const void* k, const void* v) {
  return (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
          | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
}

// The head dim a tile holds (D zero-padded to it) in each route.
static int bf16_head_pad(int D) { return D <= 64 ? 64 : 128; }
static int f32_head_pad(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : 128; }

// out = {block_q, block_kv, head_pad, base2} of the route dtype takes at
// head dim D, as kernel.plan states them; 0, or cudaErrorInvalidValue.
extern "C" int flash_attention_tiles(int dtype, int D, int* out) {
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16) {
    out[0] = TQ; out[1] = TKV; out[2] = bf16_head_pad(D); out[3] = 1;
  } else if (dtype == DT_F32) {
    out[0] = FBQ; out[1] = FBKV; out[2] = f32_head_pad(D); out[3] = 0;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// strides: q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h in elements (the
// head dim is contiguous); o is written contiguous [B, Sq, Hq, D]; scores
// are scaled by `scale` (1 / sqrt of the true head dim: D may be padded,
// and the bf16 route folds log2 e in); lse, when not null, gets each
// row's natural log-sum-exp, fp32 [B, Hq, Sq].
// bf16 takes TMA-addressable layouts only: D % 8 == 0, 16-byte aligned
// bases and strides.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int dtype,
                                      int B, int Sq, int Skv, int Hq,
                                      int Hkv, int D,
                                      const long long* strides, int causal,
                                      float scale, void* stream) {
  if (D < 1 || D > 128 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1
      || (causal && Sq > Skv) || B < 1 || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) {
    bool tma = D % 8 == 0;
    for (int i = 0; i < 9; ++i)
      if (strides[i] % 8 != 0) tma = false;
    if (!aligned16(q, k, v)) tma = false;
    if (!tma) return (int)cudaErrorInvalidValue;
    if (bf16_head_pad(D) == 64)
      return launch_bf16<64>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D, strides,
                             causal, scale, st);
    return launch_bf16<128>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D, strides,
                            causal, scale, st);
  }
  if (dtype != DT_F32) return (int)cudaErrorInvalidValue;
  F32Params p;
  p.q = reinterpret_cast<const float*>(q);
  p.k = reinterpret_cast<const float*>(k);
  p.v = reinterpret_cast<const float*>(v);
  p.o = reinterpret_cast<float*>(o);
  p.lse = lse;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.Hq = Hq; p.Hkv = Hkv; p.D = D;
  p.qb = strides[0]; p.qs = strides[1]; p.qh = strides[2];
  p.kb = strides[3]; p.ks = strides[4]; p.kh = strides[5];
  p.vb = strides[6]; p.vs = strides[7]; p.vh = strides[8];
  p.causal = causal;
  p.q_offset = causal ? Skv - Sq : 0;
  p.scale = scale;
  int vec = D % 4 == 0 && aligned16(q, k, v);
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 4 != 0) vec = 0;
  p.vec = vec;
  switch (f32_head_pad(D)) {
    case 32: return launch_f32<32>(p, st);
    case 64: return launch_f32<64>(p, st);
    default: return launch_f32<128>(p, st);
  }
}
