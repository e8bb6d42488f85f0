// GEMM with a fused, open epilogue chain, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_matmul/kernel.py::
// fused_matmul_kernel (body _gemm_kernel): y = epilogue(x[m,k] @ w[k,n])
// with an fp32 accumulator, the epilogue applied to the output tile while
// it is still on chip, and the result cast to the output type.
//
// What bounds it on the H100, and what the bf16 design does about it:
//  * At decode (m = 4 rows, one per serving slot) every weight byte is read
//    once for a handful of rows: the bytes of W over HBM (3.35 TB/s) bound
//    it.  One producer thread keeps a ring of 4-6 TMA stages (144-192 KB
//    of x and W tiles) in flight on each SM; for the deep weights (k > 8192)
//    and the single-tile ones (n <= 64) the k range is also split between
//    the blocks of a thread-block cluster, so more SMs stream W.
//  * At m = 4096 the 2mnk tensor FLOPs bound it (989 TFLOP/s in bf16).
//    Only wgmma reaches that rate: two consumer warpgroups each own 64
//    rows of a 128 x BN tile (BN = 256 for the large weights: the widest
//    tile halves the L2-to-SM traffic per FLOP) and run m64nBNk16 wgmma
//    straight from the 128-byte-swizzled TMA tiles, one wgmma group in
//    flight.  x is the K-major A operand; w [k, n] is row-major, so it is
//    an MN-major B operand read in place (the descriptor's transpose bit),
//    never transposed in memory.  After the main loop the accumulator tile
//    is laid over the ring and the epilogue walks it 8 columns per thread
//    (coalesced 16-byte operand loads and stores, one dispatch per stage),
//    its [m, n] operands prefetched into L2 while the main loop runs.  The
//    epilogue does not overlap another tile's main loop: that needs
//    persistent blocks, which, with TMA multicast and fp8, is not done.
//
// Design rules that the serving path relies on:
//  * The k-reduction order of one output element never depends on m.  The
//    tile plan (BN, the split s, the ring depth) is a function of (n, k,
//    dtype) alone (kernel.py::plan): m decides only how many 128-row
//    blocks run, and every block runs the same instruction sequence.  A
//    split sums its fp32 partial tiles through distributed shared memory
//    in rank order 0, 1, ..., s-1 (no atomics, no global workspace): rank
//    r sums and finishes columns [r BN/s, (r+1) BN/s).  So a row's result
//    is the same bits whether 1 or 4096 rows run, and from run to run.
//    That is what makes a suffix prefill equal a full prefill and
//    continuous batching equal wave batching.
//  * The epilogue is a chain of up to MAX_STAGES stages (fn, operand
//    kind, head position, stage dtype).  Before each stage the running
//    value is rounded to the stage dtype (bf16 rounds to nearest even and
//    back), operands are rounded to the running dtype, and a bf16 stage's
//    result is rounded again: exactly what the unfused ops compute, so
//    fusing an epilogue never changes a bit.
//  * TMA needs 16-byte-aligned bases and row strides: the wrapper hands
//    the bf16 route x and w whose rows are padded with zeros to a multiple
//    of 8 elements where (n, k) need it (a zero k column adds nothing),
//    and an empty k as one 8-wide slice of zeros.
//    Rows past m and columns past k or n arrive as zeros from TMA's
//    out-of-bounds fill; outputs past m or n are masked here.
//  * fp32 products run on plain FMAs in full fp32 (64x64 tile, fixed
//    16-wide k steps), not on TF32 tensor cores.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): fused_matmul_launch returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for arguments the kernel does not take.

#include <cuda.h>   // CUtensorMap and its enums; the driver call is looked up
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// The 8 elements p[i .. i+7] (i a multiple of 8, p 16-byte aligned) as
// floats, in one 16-byte (bf16) or two (fp32) read-only loads.
__device__ __forceinline__ void load8(const void* p, int dt, int64_t i,
                                      float (&o)[8]) {
  if (dt == DT_BF16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(p) + i));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(h[u]);
      o[2 * u] = f.x;
      o[2 * u + 1] = f.y;
    }
  } else {
    const float4* f = reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(p) + i);
    const float4 lo = __ldg(f), hi = __ldg(f + 1);
    o[0] = lo.x; o[1] = lo.y; o[2] = lo.z; o[3] = lo.w;
    o[4] = hi.x; o[5] = hi.y; o[6] = hi.z; o[7] = hi.w;
  }
}

// x[u] = apply_fn(fn, a[u], b[u]) for 8 elements, with one dispatch on fn
// for all 8 (each case is apply_fn with a constant fn: the same
// arithmetic, element by element).
__device__ __forceinline__ void apply_fn8(int fn, float (&x)[8],
                                          const float (&a)[8],
                                          const float (&b)[8]) {
#define FN_CASE(F)                                       \
  case F:                                                \
    _Pragma("unroll") for (int u = 0; u < 8; ++u)        \
        x[u] = apply_fn(F, a[u], b[u]);                  \
    return;
  switch (fn) {
    FN_CASE(FN_ADD) FN_CASE(FN_SUB) FN_CASE(FN_MUL) FN_CASE(FN_DIV)
    FN_CASE(FN_MAXIMUM) FN_CASE(FN_MINIMUM) FN_CASE(FN_NEG) FN_CASE(FN_EXP)
    FN_CASE(FN_SQUARE) FN_CASE(FN_TANH) FN_CASE(FN_SIGMOID) FN_CASE(FN_RELU)
    FN_CASE(FN_GELU) FN_CASE(FN_SILU)
  }
#undef FN_CASE
#pragma unroll
  for (int u = 0; u < 8; ++u) x[u] = a[u];
}

// run_epilogue on the 8 elements (r, c .. c+7) at once: the operand loads
// of all 8 are in flight together and each stage dispatches once.
// Elements past n read no operand and are not stored by the caller.
__device__ __forceinline__ void run_epilogue8(const Epilogue& e,
                                              float (&v)[8], int64_t r,
                                              int64_t c, int64_t n) {
  bool bf16 = false;  // running dtype: the accumulator is fp32
  for (int s = 0; s < e.n; ++s) {
    const int cast = e.cast[s], kind = e.kind[s], opdt = e.opdt[s];
    if (cast == DT_BF16) {
      bf16 = true;
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = round_bf16(v[u]);
    } else if (cast == DT_F32) {
      bf16 = false;
    }
    float o[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) o[u] = 0.0f;
    if (kind != KIND_NONE) {
      const int64_t i = kind == KIND_ROW ? c : r * n + c;
      if (c + 8 <= n && i % 8 == 0
          && reinterpret_cast<uintptr_t>(e.op[s]) % 16 == 0) {
        load8(e.op[s], opdt, i, o);   // 8 aligned elements: vector loads
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (c + u < n) o[u] = load_as_float(e.op[s], opdt, i + u);
      }
      if (bf16) {
#pragma unroll
        for (int u = 0; u < 8; ++u) o[u] = round_bf16(o[u]);
      }
    }
    if (e.head[s] == 0) apply_fn8(e.fn[s], v, v, o);
    else apply_fn8(e.fn[s], v, o, v);
    if (bf16) {
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = round_bf16(v[u]);
    }
  }
}

// Store (r, c .. c+7): one 16-byte (bf16) or two (fp32) stores when the
// row's 8 columns lie inside n and n % 8 == 0 (so they are aligned), else
// element by element up to n.
__device__ __forceinline__ void store8(void* y, int dt, int64_t r, int64_t c,
                                       int n, const float (&v)[8]) {
  const int64_t i = r * n + c;
  if (n % 8 == 0 && c + 8 <= n) {
    if (dt == DT_BF16) {
      __nv_bfloat162 h[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        h[u] = __halves2bfloat162(__float2bfloat16_rn(v[2 * u]),
                                  __float2bfloat16_rn(v[2 * u + 1]));
      *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(y) + i) =
          *reinterpret_cast<const uint4*>(h);
    } else {
      float4* p = reinterpret_cast<float4*>(reinterpret_cast<float*>(y) + i);
      p[0] = make_float4(v[0], v[1], v[2], v[3]);
      p[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < 8; ++u)
    if (c + u < n) store_out(y, dt, i + u, v[u]);
}

// ---------------------------------------------------------------------------
// bf16: TMA ring + wgmma, warp-specialised, optional fixed-order cluster
// split-K
// ---------------------------------------------------------------------------

constexpr int BK = 64;                   // k tile: one 128-byte swizzle row
constexpr int CTA_M = 128;               // two consumer warpgroups x 64 rows
constexpr int A_TILE = CTA_M * BK * 2;   // 16 KB: x rows of one stage
constexpr int B_SUB = BK * 64 * 2;       // 8 KB: 64 k rows x 64 w columns
constexpr int THREADS = 384;             // 2 consumer warpgroups + producer
constexpr int SMEM_MAX = 232448;         // a block's dynamic shared memory

__host__ __device__ constexpr int stage_bytes(int bn) {
  return A_TILE + bn / 64 * B_SUB;
}
// The block's 128 x BN fp32 accumulator tile, row-major with rows of
// part_ld floats (8 past BN: the fragment's float2 writes are free of bank
// conflicts), laid over the ring once the main loop is done.
__host__ __device__ constexpr int part_ld(int bn) { return bn + 8; }
__host__ __device__ constexpr int part_bytes(int bn) {
  return CTA_M * part_ld(bn) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t b) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(b) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase with parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Four floats at shared address `addr` (16-byte aligned) of cluster rank
// `rank`.
__device__ __forceinline__ float4 ld_dsmem_f4(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote)
               : "memory");
  return v;
}

// The 256 consumer threads only (the producer warpgroup does not wait).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Ask L2 for the rows of every [m, n] epilogue operand under this block's
// output columns [c0, c0 + width): they are read after the main loop, and
// then hit L2 instead of waiting on device memory.  Rows whose start or
// length is not a multiple of 16 bytes are left to the epilogue's loads.
__device__ __forceinline__ void prefetch_operands(const Epilogue& e,
                                                  int row0, int m, int c0,
                                                  int width, int n) {
  const int cols = min(width, n - c0);
  if (cols <= 0) return;
  for (int s = 0; s < e.n; ++s) {
    if (e.kind[s] != KIND_FULL) continue;
    const int eb = e.opdt[s] == DT_BF16 ? 2 : 4;
    const uint32_t bytes = cols * eb;
    for (int r = row0; r < min(row0 + CTA_M, m); ++r) {
      const char* p = reinterpret_cast<const char*>(e.op[s])
          + ((int64_t)r * n + c0) * eb;
      if (bytes % 16 != 0 || reinterpret_cast<uintptr_t>(p) % 16 != 0)
        break;
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                   :: "l"(p), "r"(bytes) : "memory");
    }
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | static_cast<uint64_t>(lbo >> 4) << 16
       | static_cast<uint64_t>(sbo >> 4) << 32
       | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

#define F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
              "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A[64 x 16] (K-major) * B[16 x N] (MN-major: imm-trans-b = 1), fp32
// accumulate (the scale-d predicate is true).
template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}"
        : F8(0), F8(8), F8(16), F8(24)
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}"
        : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<256> {
  __device__ __forceinline__ static void run(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 1;\n}"
        : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56),
          F8(64), F8(72), F8(80), F8(88), F8(96), F8(104), F8(112), F8(120)
        : "l"(da), "l"(db), "r"(1));
  }
};

#undef F8

// One block: output rows [128 bx, +128), columns [BN by, +BN), k tiles
// [rank * tiles_per_split, +tiles_per_split) of its cluster's rank.
// Shared memory: `stages` ring slots of {x: 128 rows x 64 k, w: 64 k x BN
// as BN/64 sub-tiles of 64 columns}, each 128-byte swizzled by TMA, then
// the full/empty barriers.  After the main loop the ring holds the
// accumulators in fragment order (part_bytes) where the epilogue or a
// split reads them back.
//
// wgmma accumulator layout (m64nN, f32): thread t of a warpgroup holds
// d[4j + 2h + b] = D[16 (t / 32) + (t % 32) / 4 + 8h][8j + 2 (t % 4) + b].
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 void* __restrict__ y, int m, int n, int k_tiles,
                 int tiles_per_split, int split, int stages, int out_dt,
                 Epilogue e) {
  constexpr int NREG = BN / 2;
  constexpr int STAGE = stage_bytes(BN);
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles must start on a 1024-byte boundary
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* part = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * STAGE);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int rank = split > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int kt0 = rank * tiles_per_split;
  const int nk = max(0, min(k_tiles, kt0 + tiles_per_split) - kt0);
  const int row0 = blockIdx.x * CTA_M;
  const int col0 = blockIdx.y * BN;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);    // the producer's expect_tx arrival
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer warpgroup: one thread issues every TMA copy ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 256) {
      prefetch_map(&map_x);
      prefetch_map(&map_w);
      int st = 0, ph = 0;
      for (int i = 0; i < nk; ++i) {
        mbar_wait(&empty[st], ph ^ 1);
        uint8_t* slot = smem + st * STAGE;
        mbar_expect_tx(&full[st], STAGE);
        const int kc = (kt0 + i) * BK;
        tma_load_2d(slot, &map_x, &full[st], kc, row0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(slot + A_TILE + j * B_SUB, &map_w, &full[st],
                      col0 + 64 * j, kc);
        if (i == min(stages, nk) - 1)   // the ring is full: meanwhile
          prefetch_operands(e, row0, m, col0 + rank * (BN / split),
                            BN / split, n);
        if (++st == stages) { st = 0; ph ^= 1; }
      }
    }
    if (split > 1) {   // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
  } else {
    // ---- consumer warpgroups: wgmma over the ring, then the epilogue ---
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = (tid % 128) / 32, lane = tid % 32;
    float d[NREG];
#pragma unroll
    for (int i = 0; i < NREG; ++i) d[i] = 0.0f;

    const uint32_t base = smem_u32(smem);
    int st = 0, ph = 0, prev = -1;
    for (int i = 0; i < nk; ++i) {
      mbar_wait(&full[st], ph);
      const uint32_t a = base + st * STAGE + wg * (64 * BK * 2);
      const uint32_t b = base + st * STAGE + A_TILE;
      // A: K-major, 8-row groups 1024 B apart.  B: MN-major, 8-k-row
      // groups 1024 B apart, 64-column sub-tiles B_SUB apart.
      const uint64_t da = smem_desc(a, 16, 1024);
      const uint64_t db = smem_desc(b, B_SUB, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)   // +32 B of A, +16 rows of B
        Wgmma<BN>::run(d, da + 2 * kk, db + (16 * 128 >> 4) * kk);
      wgmma_commit();
      wgmma_wait<1>();   // the previous k tile's group has finished
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = st;
      if (++st == stages) { st = 0; ph ^= 1; }
    }
    wgmma_wait<0>();

    // Every TMA copy has landed and been read: lay the accumulator tile
    // over the ring, row-major.
    consumer_sync();
    const int rl = wg * 64 + warp * 16 + lane / 4;   // row in the tile
    const int cl = 2 * (lane % 4);                    // column in the tile
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            &part[(rl + 8 * h) * part_ld(BN) + cl + 8 * j]) =
            make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    if (split > 1) cluster_sync(); else consumer_sync();

    // The epilogue, 8 columns of one row per thread and step, so that a
    // warp's loads and stores cover whole rows.  With a split, rank r
    // takes columns [r BN/s, (r+1) BN/s) and sums them over all s tiles
    // in rank order 0, 1, ..., s-1.
    const int width = BN / split;
    const int c_lo = rank * width;
    const int chunks = width / 8;
    const uint32_t pbase = smem_u32(part);
#pragma unroll 1
    for (int p = tid; p < CTA_M * chunks; p += 256) {
      const int r = p / chunks, c = c_lo + 8 * (p % chunks);
      if (row0 + r >= m) break;   // rows only grow with p
      if (col0 + c >= n) continue;
      const uint32_t addr = pbase + (r * part_ld(BN) + c) * 4;
      float v[8];
      if (split == 1) {
        const float4* q = reinterpret_cast<const float4*>(
            &part[r * part_ld(BN) + c]);
        const float4 lo = q[0], hi = q[1];
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
      } else {
        float4 lo = ld_dsmem_f4(addr, 0), hi = ld_dsmem_f4(addr + 16, 0);
        for (int q = 1; q < split; ++q) {
          const float4 a = ld_dsmem_f4(addr, q);
          const float4 b = ld_dsmem_f4(addr + 16, q);
          lo.x += a.x; lo.y += a.y; lo.z += a.z; lo.w += a.w;
          hi.x += b.x; hi.y += b.y; hi.z += b.z; hi.w += b.w;
        }
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
      }
      run_epilogue8(e, v, row0 + r, col0 + c, n);
      store8(y, out_dt, row0 + r, col0 + c, n, v);
    }
    if (split > 1)
      cluster_sync();   // no rank leaves while another reads its tile
  }
}

// ---------------------------------------------------------------------------
// fp32: plain FMAs, 64x64 tile, 256 threads of 4x4 outputs each
// ---------------------------------------------------------------------------

constexpr int FBM = 64, FBN = 64, FBK = 16;

__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                void* __restrict__ y, int m, int n, int k, int out_dt,
                Epilogue e) {
  __shared__ float As[FBK][FBM + 1];
  __shared__ float Bs[FBK][FBN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t row0 = (int64_t)blockIdx.y * FBM;
  const int64_t col0 = (int64_t)blockIdx.x * FBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < k; k0 += FBK) {
    for (int v = threadIdx.x; v < FBM * FBK; v += 256) {
      int r = v / FBK, c = v % FBK;
      int64_t gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < m && gc < k) ? x[gr * k + gc] : 0.0f;
    }
    for (int v = threadIdx.x; v < FBK * FBN; v += 256) {
      int r = v / FBN, c = v % FBN;
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// link against libcuda).
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess
        && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-D bf16 tensor map over rows of `ld` elements: `inner` x `outer`
// elements, boxes of 64 (128 bytes, swizzled) x `box_outer`, out-of-bounds
// elements read as zero.
static bool make_map(CUtensorMap* map, const void* ptr, uint64_t inner,
                     uint64_t outer, uint64_t ld, uint32_t box_outer) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t dims[2] = {inner, outer};
  cuuint64_t strides[1] = {ld * 2};
  cuuint32_t box[2] = {64, box_outer};
  cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
static int launch_bf16(const void* x, const void* w, void* y, int m, int n,
                       int k, int ldx, int ldw, int split, int stages,
                       int out_dt, const Epilogue& e, cudaStream_t st) {
  const size_t ring = static_cast<size_t>(stages) * stage_bytes(BN);
  const size_t smem = 1024 + ring + 16 * stages;
  if (smem > SMEM_MAX || ring < part_bytes(BN) || (BN / 8) % split != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, x, k, m, ldx, CTA_M)
      || !make_map(&map_w, w, n, k, ldw, BK))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_bf16_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int k_tiles = (k + BK - 1) / BK;
  const int per = (k_tiles + split - 1) / split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((m + CTA_M - 1) / CTA_M, (n + BN - 1) / BN, split);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;   // a split's blocks form one cluster
  cudaError_t err = cudaLaunchKernelEx(&cfg, gemm_bf16_kernel<BN>, map_x,
                                       map_w, y, m, n, k_tiles, per, split,
                                       stages, out_dt, e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// codes: 5 * MAX_STAGES ints laid out fn[], kind[], head[], cast[], opdt[].
// x is [m, k] with rows of ldx elements, w [k, n] with rows of ldw; bn,
// split and stages are the bf16 route's plan (kernel.py::plan).
extern "C" int fused_matmul_launch(const void* x, const void* w, void* y,
                                   int m, int n, int k, int ldx, int ldw,
                                   int in_dt, int out_dt, int bn, int split,
                                   int stages, int n_stages,
                                   const int* codes,
                                   const void* const* operands,
                                   void* stream) {
  if (n_stages < 0 || n_stages > MAX_STAGES || m <= 0 || n <= 0 || k < 0)
    return (int)cudaErrorInvalidValue;
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
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (in_dt != DT_BF16) {
    if (ldx != k || ldw != n) return (int)cudaErrorInvalidValue;
    dim3 grid((n + FBN - 1) / FBN, (m + FBM - 1) / FBM);
    gemm_f32_kernel<<<grid, 256, 0, st>>>(
        reinterpret_cast<const float*>(x), reinterpret_cast<const float*>(w),
        y, m, n, k, out_dt, e);
    return (int)cudaGetLastError();
  }
  // TMA: 16-byte-aligned bases and row strides, no empty box
  if (k == 0 || ldx < k || ldw < n || ldx % 8 != 0 || ldw % 8 != 0
      || reinterpret_cast<uintptr_t>(x) % 16 != 0
      || reinterpret_cast<uintptr_t>(w) % 16 != 0
      || split < 1 || split > 8 || stages < 2 || stages > 8)
    return (int)cudaErrorInvalidValue;
  if (bn == 64)
    return launch_bf16<64>(x, w, y, m, n, k, ldx, ldw, split, stages, out_dt,
                           e, st);
  if (bn == 128)
    return launch_bf16<128>(x, w, y, m, n, k, ldx, ldw, split, stages,
                            out_dt, e, st);
  if (bn == 256)
    return launch_bf16<256>(x, w, y, m, n, k, ldx, ldw, split, stages,
                            out_dt, e, st);
  return (int)cudaErrorInvalidValue;
}
