// Online-softmax (flash) attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel (body _flash_kernel): causal or non-causal
// attention with an fp32 running max m, sum l and accumulator acc, GQA
// through q head -> K/V head hq / (Hq / Hkv), causal queries aligned to the
// end of the keys (q_offset = Skv - Sq), tiles wholly above the diagonal
// skipped, and l == 0 -> 1 at the end.
//
// What bounds it on the H100: at the forward's shape (B=2, S=2048, 16 query
// heads over 2 K/V heads, head dim 128) the causal products are 34 GFLOP
// against 38 MB of q/k/v/o, so it is bound by tensor-core FLOPs (989
// TFLOP/s bf16, about 35 us); at the padded prefill's (B=4, S=512) by the
// bytes (about 6 us).  The design never writes the score matrix to device memory: a
// block keeps its 64 query rows, one 64-key K/V tile, the fp32 scores and
// the rounded probabilities in shared memory and its accumulator in
// registers, so device traffic is q/k/v read and o written (K/V once per
// query tile and head: they stay in the 50 MB L2 between blocks).  The
// K/V tiles are copied with cp.async, one tile ahead: the next K lands
// while this tile's softmax and PV run, the next V while the next QK^T
// runs, so a block does not stall on each load's latency.  Otherwise it
// is the simple, correct form: WMMA (mma.sync) bf16 products with fp32
// accumulation, plain FMAs for fp32, four warps, no wgmma/TMA and one
// block per query head (not per K/V group).  Making it fast is later
// work.
//
// The TPU kernel's sequential kv grid axis and its VMEM scratch become a
// loop over K/V tiles inside the block.  The K/V tile is FIXED at 64 keys,
// so a query row's result depends only on its own keys and position, not
// on how many query rows run: a fully masked tile leaves m, l and acc
// bitwise unchanged (p = 0, alpha = 1), so the tiles another row of the
// same query tile adds change nothing.
//
// Reads the [B, S, H, D] layout in place through strides (no transposes,
// no K/V repeat); head dims up to 128, zero-padded in shared memory to the
// MMA depth (24 pads to 32).  Writes o contiguous [B, Sq, Hq, D].
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): flash_attention_launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

using namespace nvcuda;

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int BQ = 64;     // query rows per block
constexpr int BKV = 64;    // keys per tile (fixed: see above)
constexpr int THREADS = 128;
constexpr int S_LD = BKV + 4;   // fp32 score tile stride
constexpr int P_LD = BKV + 8;   // bf16 probability tile stride
constexpr float NEG_INF = -FLT_MAX;   // finfo(float32).min, as the TPU kernel

struct Params {
  const void* q; const void* k; const void* v; void* o;
  int B, Sq, Skv, Hq, Hkv, D;
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh;   // strides, in elements
  int causal, q_offset, vec;
  float scale;
};

__host__ __device__ constexpr int align128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

template <typename T, int DP>
struct Smem {
  static constexpr int LD = DP + 8;   // q/k/v tile stride (16-byte rows)
  static constexpr int TILE = align128(BQ * LD * (int)sizeof(T));
  static constexpr int S_BYTES = BQ * S_LD * 4;
  static constexpr int PV_BYTES = std::is_same<T, float>::value
      ? 0 : BQ * (DP + 4) * 4;
  // the fp32 scores and the PV product never live at once: one region
  static constexpr int SU = align128(S_BYTES > PV_BYTES ? S_BYTES : PV_BYTES);
  static constexpr int P_BYTES = std::is_same<T, float>::value
      ? 0 : align128(BQ * P_LD * 2);
  static constexpr int TOTAL = 3 * TILE + SU + P_BYTES;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

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

// rows [row0, row0 + BQ) of one head into a [BQ][LD] tile; rows past
// `rows` and columns past D are zero.  With `vec` (16-byte aligned rows)
// the copy is asynchronous: the caller commits it as a group and waits.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* base,
                                          int64_t row_stride, int row0,
                                          int rows, int D, int vec) {
  constexpr int LD = Smem<T, DP>::LD;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int PER_ROW = DP / V;
    static_assert(BQ * PER_ROW % THREADS == 0, "whole copies per thread");
#pragma unroll
    for (int it = 0; it < BQ * PER_ROW / THREADS; ++it) {
      int i = it * THREADS + threadIdx.x;
      int r = i / PER_ROW, c = (i % PER_ROW) * V;
      bool ok = row0 + r < rows && c < D;
      cp_async16(dst + r * LD + c,
                 ok ? base + (int64_t)(row0 + r) * row_stride + c : base,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < BQ * DP; i += THREADS) {
      int r = i / DP, c = i % DP;
      T val = from_f<T>(0.0f);
      if (row0 + r < rows && c < D)
        val = base[(int64_t)(row0 + r) * row_stride + c];
      dst[r * LD + c] = val;
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  using S = Smem<T, DP>;
  constexpr int LD = S::LD;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + S::TILE);
  T* Vs = reinterpret_cast<T*>(smem + 2 * S::TILE);
  float* Ss = reinterpret_cast<float*>(smem + 3 * S::TILE);   // scores
  float* PVs = Ss;                                            // P @ V
  __nv_bfloat16* Ps =
      reinterpret_cast<__nv_bfloat16*>(smem + 3 * S::TILE + S::SU);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const T* qbase = reinterpret_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kbase = reinterpret_cast<const T*>(p.k) + b * p.kb + hk * p.kh;
  const T* vbase = reinterpret_cast<const T*>(p.v) + b * p.vb + hk * p.vh;

  // thread -> (row, half): a row's softmax and accumulator belong to two
  // threads of one warp, each taking every other column
  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;
  const int warp = tid / 32;
  const int qpos = p.q_offset + q0 + r;   // absolute query position

  float acc[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.0f;
  float m = NEG_INF, l = 0.0f;

  const int last_q = min(q0 + BQ, p.Sq) - 1;
  const int kv_end = p.causal ? min(p.Skv, p.q_offset + last_q + 1) : p.Skv;
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  // copy groups in commit order: {Q, K_0}, {V_0}, then per tile t
  // {K_t+1} once K_t is consumed and {V_t+1} once V_t is: the next K
  // lands during this tile's softmax and PV, the next V during the next
  // tile's QK^T
  load_tile<T, DP>(Qs, qbase, p.qs, q0, p.Sq, p.D, p.vec);
  load_tile<T, DP>(Ks, kbase, p.ks, 0, p.Skv, p.D, p.vec);
  cp_async_commit();
  load_tile<T, DP>(Vs, vbase, p.vs, 0, p.Skv, p.D, p.vec);
  cp_async_commit();

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BKV;
    cp_async_wait<1>();   // Q and K_t have landed (V_t may be in flight)
    __syncthreads();

    // S = Q K^T (unscaled, fp32)
    if constexpr (BF16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BKV / 16];
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(sf[j], 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + (16 * warp) * LD + kk, LD);
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bk;
          wmma::load_matrix_sync(bk, Ks + (16 * j) * LD + kk, LD);
          wmma::mma_sync(sf[j], a, bk, sf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j)
        wmma::store_matrix_sync(Ss + (16 * warp) * S_LD + 16 * j, sf[j],
                                S_LD, wmma::mem_row_major);
    } else {
      for (int j = 0; j < BKV / 2; ++j) {
        int c = half + 2 * j;
        float s = 0.0f;
#pragma unroll 8
        for (int d = 0; d < DP; ++d)
          s = fmaf(to_f(Qs[r * LD + d]), to_f(Ks[c * LD + d]), s);
        Ss[r * S_LD + c] = s;
      }
    }
    __syncthreads();   // every warp is done with K_t
    if (t + 1 < n_tiles)
      load_tile<T, DP>(Ks, kbase, p.ks, kv0 + BKV, p.Skv, p.D, p.vec);
    cp_async_commit();   // {K_t+1}, empty on the last tile

    // online softmax over this tile's scores, in fp32
    float mx = NEG_INF;
    for (int j = 0; j < BKV / 2; ++j) {
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
    for (int j = 0; j < BKV / 2; ++j) {
      int c = half + 2 * j;
      float e = expf(Ss[r * S_LD + c] - m_new);
      sum += e;
      // p rounds to v's dtype before the PV product, as _flash_kernel does
      if constexpr (BF16) Ps[r * P_LD + c] = __float2bfloat16_rn(e);
      else Ss[r * S_LD + c] = e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = alpha * l + sum;
    m = m_new;
    cp_async_wait<1>();   // V_t has landed (K_t+1 may be in flight)
    __syncthreads();

    // acc = alpha * acc + P V
    if constexpr (BF16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[DP / 16];
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(of[j], 0.0f);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, Ps + (16 * warp) * P_LD + kk, P_LD);
#pragma unroll
        for (int j = 0; j < DP / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bv;
          wmma::load_matrix_sync(bv, Vs + kk * LD + 16 * j, LD);
          wmma::mma_sync(of[j], a, bv, of[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < DP / 16; ++j)
        wmma::store_matrix_sync(PVs + (16 * warp) * (DP + 4) + 16 * j, of[j],
                                DP + 4, wmma::mem_row_major);
      __syncwarp();   // each warp reads back only its own 16 rows
#pragma unroll
      for (int j = 0; j < DP / 2; ++j)
        acc[j] = alpha * acc[j] + PVs[r * (DP + 4) + half + 2 * j];
    } else {
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) {
        int c = half + 2 * j;
        float pv = 0.0f;
        for (int kk = 0; kk < BKV; ++kk)
          pv = fmaf(Ss[r * S_LD + kk], to_f(Vs[kk * LD + c]), pv);
        acc[j] = alpha * acc[j] + pv;
      }
    }
    __syncthreads();   // every warp is done with V_t, the scores and PV
    if (t + 1 < n_tiles)
      load_tile<T, DP>(Vs, vbase, p.vs, kv0 + BKV, p.Skv, p.D, p.vec);
    cp_async_commit();   // {V_t+1}, empty on the last tile
  }
  cp_async_wait<0>();

  const int row = q0 + r;
  if (row < p.Sq) {
    const float denom = l == 0.0f ? 1.0f : l;
    T* out = reinterpret_cast<T*>(p.o)
        + (((int64_t)b * p.Sq + row) * p.Hq + h) * p.D;
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) {
      int c = half + 2 * j;
      if (c < p.D) out[c] = from_f<T>(acc[j] / denom);
    }
  }
}

template <typename T, int DP>
static int launch_dp(const Params& p, cudaStream_t st) {
  constexpr int bytes = Smem<T, DP>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  flash_fwd_kernel<T, DP><<<grid, THREADS, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_t(const Params& p, cudaStream_t st) {
  if (p.D <= 32) return launch_dp<T, 32>(p, st);
  if (p.D <= 64) return launch_dp<T, 64>(p, st);
  return launch_dp<T, 128>(p, st);
}

// strides: q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h in elements (the
// head dim is contiguous); o is written contiguous [B, Sq, Hq, D]
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Sq, int Skv, int Hq,
                                      int Hkv, int D,
                                      const long long* strides, int causal,
                                      void* stream) {
  if (D < 1 || D > 128 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1
      || (causal && Sq > Skv) || B < 1 || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.Hq = Hq; p.Hkv = Hkv; p.D = D;
  p.qb = strides[0]; p.qs = strides[1]; p.qh = strides[2];
  p.kb = strides[3]; p.ks = strides[4]; p.kh = strides[5];
  p.vb = strides[6]; p.vs = strides[7]; p.vh = strides[8];
  p.causal = causal;
  p.q_offset = causal ? Skv - Sq : 0;
  p.scale = (float)(1.0 / sqrt((double)D));
  const int elt = dtype == DT_BF16 ? 2 : 4;
  const int vw = 16 / elt;
  int vec = D % vw == 0;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % vw != 0) vec = 0;
  if (reinterpret_cast<uintptr_t>(q) % 16 != 0
      || reinterpret_cast<uintptr_t>(k) % 16 != 0
      || reinterpret_cast<uintptr_t>(v) % 16 != 0)
    vec = 0;
  p.vec = vec;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) return launch_t<__nv_bfloat16>(p, st);
  if (dtype == DT_F32) return launch_t<float>(p, st);
  return (int)cudaErrorInvalidValue;
}
