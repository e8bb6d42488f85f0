// Blocked GEMM with a fused, open epilogue chain, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_matmul/kernel.py::
// fused_matmul_kernel (body _gemm_kernel): y = epilogue(x[m,k] @ w[k,n])
// with an fp32 accumulator, the epilogue applied to the output tile while
// it is still on chip, and the result cast to the output type.
//
// What bounds it on the H100: at decode (m <= 8 rows, one per serving
// slot) every weight byte is read once for a handful of rows, so the
// kernel is bound by the bytes of W over HBM bandwidth (3.35 TB/s); at
// prefill (m >= 512 prompt rows) it is bound by tensor-core FLOPs.  This
// first kernel is the simple, correct form: one block per 64x64 output
// tile, bf16 products on the tensor cores through WMMA (mma.sync) with an
// fp32 accumulator, fp32 products on plain FMAs.  It does not yet keep
// loads in flight (no cp.async/TMA pipeline, no wgmma): at decode the
// narrow outputs (n = 2048) give only 32 blocks for 132 SMs, so it reaches
// a fraction of the byte bound.  That is work for a later change.
//
// Design rules that the serving path relies on:
//  * The k-reduction order of one output element never depends on m: a
//    block walks k in fixed 32-wide (bf16) or 16-wide (fp32) steps from 0
//    to k, with no split-K and no atomics.  So a row's result is the same
//    bits whether 1 or 512 rows run, which is what makes a suffix prefill
//    equal a full prefill and continuous batching equal wave batching.
//  * The epilogue is a chain of up to MAX_STAGES stages (fn, operand
//    kind, head position, stage dtype).  Before each stage the running
//    value is rounded to the stage dtype (bf16 rounds to nearest even and
//    back), operands are rounded to the running dtype, and a bf16 stage's
//    result is rounded again: exactly what the unfused ops compute, so
//    fusing an epilogue never changes a bit.
//  * Ragged m, n and k are masked here, not padded by the caller.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): fused_matmul_launch returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

#define MAX_STAGES 8

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { KIND_NONE = 0, KIND_ROW = 1, KIND_FULL = 2 };
enum {
  FN_ADD = 0, FN_SUB, FN_MUL, FN_DIV, FN_MAXIMUM, FN_MINIMUM, FN_NEG, FN_EXP,
  FN_SQUARE, FN_TANH, FN_SIGMOID, FN_RELU, FN_GELU, FN_SILU
};

struct Epilogue {
  int n;
  int fn[MAX_STAGES];
  int kind[MAX_STAGES];
  int head[MAX_STAGES];
  int cast[MAX_STAGES];   // -1: keep the running dtype; else DT_*
  int opdt[MAX_STAGES];   // operand storage dtype (DT_*)
  const void* op[MAX_STAGES];
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_as_float(const void* p, int dt,
                                               int64_t i) {
  return dt == DT_BF16
      ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
      : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ float apply_fn(int fn, float a, float b) {
  switch (fn) {
    case FN_ADD: return a + b;
    case FN_SUB: return a - b;
    case FN_MUL: return a * b;
    case FN_DIV: return a / b;
    case FN_MAXIMUM: return fmaxf(a, b);
    case FN_MINIMUM: return fminf(a, b);
    case FN_NEG: return -a;
    case FN_EXP: return expf(a);
    case FN_SQUARE: return a * a;
    case FN_TANH: return tanhf(a);
    case FN_SIGMOID: return 1.0f / (1.0f + expf(-a));
    case FN_RELU: return fmaxf(a, 0.0f);
    case FN_GELU: {  // tanh approximation (jax.nn.gelu's default)
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * a * (1.0f + tanhf(c * (a + 0.044715f * a * a * a)));
    }
    case FN_SILU: return a / (1.0f + expf(-a));
  }
  return a;
}

// The chain for output element (r, c); `acc` is the fp32 accumulator.
__device__ __forceinline__ float run_epilogue(const Epilogue& e, float v,
                                              int64_t r, int64_t c,
                                              int64_t n) {
  bool bf16 = false;  // running dtype: the accumulator is fp32
  for (int s = 0; s < e.n; ++s) {
    if (e.cast[s] == DT_BF16) { bf16 = true; v = round_bf16(v); }
    else if (e.cast[s] == DT_F32) { bf16 = false; }
    float o = 0.0f;
    if (e.kind[s] != KIND_NONE) {
      int64_t i = e.kind[s] == KIND_ROW ? c : r * n + c;
      o = load_as_float(e.op[s], e.opdt[s], i);
      if (bf16) o = round_bf16(o);
    }
    v = e.head[s] == 0 ? apply_fn(e.fn[s], v, o) : apply_fn(e.fn[s], o, v);
    if (bf16) v = round_bf16(v);
  }
  return v;
}

__device__ __forceinline__ void store_out(void* y, int dt, int64_t i,
                                          float v) {
  if (dt == DT_BF16)
    reinterpret_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(y)[i] = v;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through WMMA, 64x64 tile, 4 warps of 32x32 each
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int A_LD = BK + 8;   // padded smem strides (multiples of 8 bf16)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;   // multiple of 4 floats

__global__ void __launch_bounds__(128)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w, void* __restrict__ y,
                 int m, int n, int k, int out_dt, int vec, Epilogue e) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int64_t row0 = (int64_t)blockIdx.y * BM;
  const int64_t col0 = (int64_t)blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int k0 = 0; k0 < k; k0 += BK) {
    if (vec) {
      // 16-byte loads: k and n are multiples of 8, so a vector is either
      // wholly inside the matrix or wholly outside it
      for (int v = tid; v < BM * BK / 8; v += 128) {
        int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
        int64_t gr = row0 + r, gc = k0 + c;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (gr < m && gc < k)
          val = *reinterpret_cast<const uint4*>(x + gr * k + gc);
        *reinterpret_cast<uint4*>(&As[r * A_LD + c]) = val;
      }
      for (int v = tid; v < BK * BN / 8; v += 128) {
        int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
        int64_t gr = k0 + r, gc = col0 + c;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (gr < k && gc < n)
          val = *reinterpret_cast<const uint4*>(w + gr * n + gc);
        *reinterpret_cast<uint4*>(&Bs[r * B_LD + c]) = val;
      }
    } else {
      for (int v = tid; v < BM * BK; v += 128) {
        int r = v / BK, c = v % BK;
        int64_t gr = row0 + r, gc = k0 + c;
        As[r * A_LD + c] = (gr < m && gc < k) ? x[gr * k + gc] : zero;
      }
      for (int v = tid; v < BK * BN; v += 128) {
        int r = v / BN, c = v % BN;
        int64_t gr = k0 + r, gc = col0 + c;
        Bs[r * B_LD + c] = (gr < k && gc < n) ? w[gr * n + gc] : zero;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm + 16 * i) * A_LD + kk], A_LD);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * B_LD + wn + 16 * j], B_LD);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm + 16 * i) * C_LD + wn + 16 * j],
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int v = tid; v < BM * BN; v += 128) {
    int r = v / BN, c = v % BN;
    int64_t gr = row0 + r, gc = col0 + c;
    if (gr < m && gc < n) {
      float val = run_epilogue(e, Cs[r * C_LD + c], gr, gc, n);
      store_out(y, out_dt, gr * n + gc, val);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: plain FMAs, 64x64 tile, 256 threads of 4x4 outputs each
// ---------------------------------------------------------------------------

constexpr int FBK = 16;

__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                void* __restrict__ y, int m, int n, int k, int out_dt,
                Epilogue e) {
  __shared__ float As[FBK][BM + 1];
  __shared__ float Bs[FBK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t row0 = (int64_t)blockIdx.y * BM;
  const int64_t col0 = (int64_t)blockIdx.x * BN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < k; k0 += FBK) {
    for (int v = threadIdx.x; v < BM * FBK; v += 256) {
      int r = v / FBK, c = v % FBK;
      int64_t gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < m && gc < k) ? x[gr * k + gc] : 0.0f;
    }
    for (int v = threadIdx.x; v < FBK * BN; v += 256) {
      int r = v / BN, c = v % BN;
      int64_t gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < k && gc < n) ? w[gr * n + gc] : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      int64_t gr = row0 + ty + 16 * i, gc = col0 + tx + 16 * j;
      if (gr < m && gc < n)
        store_out(y, out_dt, gr * n + gc,
                  run_epilogue(e, acc[i][j], gr, gc, n));
    }
}

// codes: 5 * MAX_STAGES ints laid out fn[], kind[], head[], cast[], opdt[]
extern "C" int fused_matmul_launch(const void* x, const void* w, void* y,
                                   int m, int n, int k, int in_dt,
                                   int out_dt, int n_stages,
                                   const int* codes,
                                   const void* const* operands,
                                   void* stream) {
  if (n_stages < 0 || n_stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
  Epilogue e;
  e.n = n_stages;
  for (int s = 0; s < MAX_STAGES; ++s) {
    e.fn[s] = codes[s];
    e.kind[s] = codes[MAX_STAGES + s];
    e.head[s] = codes[2 * MAX_STAGES + s];
    e.cast[s] = codes[3 * MAX_STAGES + s];
    e.opdt[s] = codes[4 * MAX_STAGES + s];
    e.op[s] = operands[s];
  }
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (in_dt == DT_BF16) {
    int vec = (k % 8 == 0) && (n % 8 == 0)
        && (reinterpret_cast<uintptr_t>(x) % 16 == 0)
        && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
    gemm_bf16_kernel<<<grid, 128, 0, st>>>(
        reinterpret_cast<const __nv_bfloat16*>(x),
        reinterpret_cast<const __nv_bfloat16*>(w), y, m, n, k, out_dt, vec,
        e);
  } else {
    gemm_f32_kernel<<<grid, 256, 0, st>>>(
        reinterpret_cast<const float*>(x), reinterpret_cast<const float*>(w),
        y, m, n, k, out_dt, e);
  }
  return (int)cudaGetLastError();
}
