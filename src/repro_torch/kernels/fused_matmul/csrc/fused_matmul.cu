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
//    the k range is also split in two between the blocks of a
//    thread-block cluster, so more SMs stream W.
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
//    dtype) alone, the bf16 split of k alone (kernel.py::plan, so a fused
//    product's columns are its parts' bits): m decides only how many 128-row
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
//
// The fp32 route (gemm_f32_kernel; every product of the paper's four
// networks) runs on fp32 FMAs, not on TF32 tensor cores (TF32 keeps about
// three decimal digits).  At the nets' shapes the 67 TFLOP/s FMA rate is
// 0.6-9 us of work: what bounds it is how many SMs have work and how long
// each waits on its loads.  So:
//  * Register tiles (4x4 outputs a thread, 64x64 or 32x32 a block, chosen
//    from m, n and the split by kernel.py::f32_tile) over a 2-stage
//    cp.async ring of 32-deep k steps, small enough for several blocks an
//    SM, each operand copied along its stored rows (16-byte copies where
//    the rows allow, 4-byte ones at ragged strides) into a padded layout
//    whose float4 reads are free of bank conflicts.
//  * k is cut into S contiguous ranges of whole 64-steps (kernel.py::plan,
//    a function of (n, k) alone) where one 64-row output would leave SMs
//    idle: conv1's dW, a 9 x 32 output over 50176 rows, is 88 ranks.
//    Each rank writes its partial tile to an fp32 workspace [S, m, n4];
//    the tile's last block to arrive (an atomic ticket on a per-tile
//    counter, which it resets) adds the S partials in rank order and runs
//    the epilogue once on the sum.  The ticket decides who adds, never
//    the order: no atomics touch a value, no host sync, no allocation.
//  * The order rule: each output element is one ascending fmaf chain
//    within each k range, the ranges' partials added in rank order 0, 1,
//    ..., S-1, then the epilogue.  S and the ranges follow (n, k) alone,
//    and no tile changes an element's order (zero-filled k past a range
//    adds exact zeros), so a row's result is the same bits at every m and
//    on every call; with S = 1 it is one chain over all of k.
//
// The grouped route (fused_matmul_grouped_launch; the MoE expert FFN,
// whose TPU counterpart is the reference's grouped einsum in
// core/lowering.py, outside any Pallas kernel): y[E, C, n] =
// chain(x[E, C, k] @ w[E, k, n]) in ONE launch, the experts on the grid
// (blockIdx.z = expert * split + rank).  Each expert runs the plan and the
// instruction sequence of its own 2-D launch (kernel.py::plan(n, k)), so a
// row's bits do not depend on E, on C, or on where the row sits in its
// expert's buffer: grouped = per-expert launches, bitwise.  The bf16 route
// reads x and w through rank-3 tensor maps with the expert as the outer
// dim, so a tile past C or past k reads TMA's zero fill and never the next
// expert's rows; stores are masked at C.  An epilogue's [E, C, n] operand
// is read at the global row e C + i; a row operand is every expert's.  The
// fp32 route takes the expert's base by plain pointer offsets.  Empty
// capacity rows are computed like any other (dropless C = T: the reference's
// semantics).  The backward's two layouts run grouped the same way: dX[e]
// = dY[e] [C, n] @ W[e]^T (w read K-major, the 2-D dX route's layout) and
// dW[e] = X[e]^T [k, C] @ dY[e] [C, n] (x read MN-major, the 2-D dW
// route's), whose contraction is C: a tile past C reads zeros in both
// operands, and the split over C is the 2-D dW launch's plan(n, C).
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
      // written as PyTorch's CUDA gelu(approximate="tanh") writes it, so
      // the fused epilogue gives the unfused op's bits
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      const float cube = a * a * a;
      return 0.5f * a * (1.0f + tanhf(c * (a + 0.044715f * cube)));
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

// The box at (c0, c1, c2) of a rank-3 map (the grouped route: c2 is the
// expert).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The box at (c0, c1) of a 2-D map, or of expert c2's matrix of a rank-3
// map (G = 1).
template <int G>
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  if (G)
    tma_load_3d(dst, map, bar, c0, c1, c2);
  else
    tma_load_2d(dst, map, bar, c0, c1);
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
// `rbase`: the global row of the block's row 0 less row0 (the grouped
// route's e C; 0 elsewhere).
__device__ __forceinline__ void prefetch_operands(const Epilogue& e,
                                                  int64_t rbase, int row0,
                                                  int m, int c0, int width,
                                                  int n) {
  const int cols = min(width, n - c0);
  if (cols <= 0) return;
  for (int s = 0; s < e.n; ++s) {
    if (e.kind[s] != KIND_FULL) continue;
    const int eb = e.opdt[s] == DT_BF16 ? 2 : 4;
    const uint32_t bytes = cols * eb;
    for (int r = row0; r < min(row0 + CTA_M, m); ++r) {
      const char* p = reinterpret_cast<const char*>(e.op[s])
          + ((rbase + r) * n + c0) * eb;
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

// d += A[64 x 16] * B[16 x N], fp32 accumulate (the scale-d predicate is
// true).  TA / TB are wgmma's transpose bits: TA = 1 reads A MN-major (the
// backward's x^T), TB = 1 reads B MN-major (the forward's w [k, n]); 0 reads
// the operand K-major.
template <int N, int TA, int TB> struct Wgmma;

template <int TA, int TB> struct Wgmma<64, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}"
        : F8(0), F8(8), F8(16), F8(24)
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB> struct Wgmma<128, TA, TB> {
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
        "%64, %65, p, 1, 1, %67, %68;\n}"
        : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB> struct Wgmma<256, TA, TB> {
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
        "%128, %129, p, 1, 1, %131, %132;\n}"
        : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56),
          F8(64), F8(72), F8(80), F8(88), F8(96), F8(104), F8(112), F8(120)
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

#undef F8

// One block: output rows [128 bx, +128), columns [BN by, +BN), k tiles
// [rank * tiles_per_split, +tiles_per_split) of its cluster's rank.
// Shared memory: `stages` ring slots of {x: 128 rows x 64 k, w: 64 k x BN
// as BN/64 sub-tiles of 64 columns}, each 128-byte swizzled by TMA, then
// the full/empty barriers.
//
// Operand layouts (the backward's products read their operands in place):
//  * TA = 0: x is [m, k] row-major, the K-major A operand (rows of 64 k,
//    128 bytes); TA = 1: x is stored [k, m] (the product takes x^T, the
//    weight gradient's X^T dY), the MN-major A operand, as two sub-tiles
//    of 64 m columns x 64 k rows, one per consumer warpgroup.
//  * TB = 1: w is [k, n] row-major, the MN-major B operand (the forward);
//    TB = 0: w is stored [n, k] (the product takes w^T, the input
//    gradient's dY W^T), the K-major B operand, BN rows of 64 k.
//  Each layout is one TMA box shape and one wgmma transpose bit: no
//  operand is copied or transposed in memory.  After the main loop the ring holds the
// accumulators in fragment order (part_bytes) where the epilogue or a
// split reads them back.
//
// wgmma accumulator layout (m64nN, f32): thread t of a warpgroup holds
// d[4j + 2h + b] = D[16 (t / 32) + (t % 32) / 4 + 8h][8j + 2 (t % 4) + b].
//
// G = 1 is the grouped route (any of the three layouts): the maps are rank
// 3 with the expert outer, blockIdx.z = expert * split + rank, `m` is each
// expert's output rows, and output row i of expert e is global row e m + i.
template <int BN, int TA, int TB, int G>
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
  const int expert = G ? static_cast<int>(blockIdx.z) / split : 0;
  const int64_t rbase = static_cast<int64_t>(expert) * m;
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
        if (TA == 0) {
          tma_load<G>(slot, &map_x, &full[st], kc, row0, expert);
        } else {
          tma_load<G>(slot, &map_x, &full[st], row0, kc, expert);
          tma_load<G>(slot + B_SUB, &map_x, &full[st], row0 + 64, kc,
                      expert);
        }
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          if (TB == 1)
            tma_load<G>(slot + A_TILE + j * B_SUB, &map_w, &full[st],
                        col0 + 64 * j, kc, expert);
          else
            tma_load<G>(slot + A_TILE + j * B_SUB, &map_w, &full[st], kc,
                        col0 + 64 * j, expert);
        }
        if (i == min(stages, nk) - 1)   // the ring is full: meanwhile
          prefetch_operands(e, rbase, row0, m, col0 + rank * (BN / split),
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
      // K-major: 8-row groups 1024 B apart, a k step +32 B.  MN-major:
      // 8-k-row groups 1024 B apart, 64-column sub-tiles B_SUB apart, a k
      // step +16 rows (2 KB).  A warpgroup's 64 rows of A are 8 KB
      // (= B_SUB) into the slot in either layout.
      const uint64_t da = TA ? smem_desc(a, B_SUB, 1024)
                             : smem_desc(a, 16, 1024);
      const uint64_t db = TB ? smem_desc(b, B_SUB, 1024)
                             : smem_desc(b, 16, 1024);
      constexpr uint64_t step_a = TA ? (16 * 128 >> 4) : 2;
      constexpr uint64_t step_b = TB ? (16 * 128 >> 4) : 2;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<BN, TA, TB>::run(d, da + step_a * kk, db + step_b * kk);
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
      run_epilogue8(e, v, rbase + row0 + r, col0 + c, n);
      store8(y, out_dt, rbase + row0 + r, col0 + c, n, v);
    }
    if (split > 1)
      cluster_sync();   // no rank leaves while another reads its tile
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA register tiles over a cp.async ring, fixed-order split over k
// ---------------------------------------------------------------------------

constexpr int F32_STAGES = 2;           // cp.async ring depth
constexpr int F32_TICKETS = 1 << 20;    // split tiles one launch may have

// One counter per output tile of a split launch: zero when the library is
// loaded, and set back to zero by the tile's last block, so every launch
// finds them zero (launches that share them run in stream order).
__device__ unsigned int f32_tickets[F32_TICKETS];

// Blocks an SM should hold at once, by threads a block: the register
// budget the compiler keeps to (256 threads: 85 registers a thread), so
// tall outputs run in few waves.
#define F32_MIN_BLOCKS(nt) ((nt) >= 256 ? 3 : (nt) >= 128 ? 2 : 8)
// The buffer a split's last block adds its partials in: 64 KB, or all a
// block may take where the launch has no more blocks than the card SMs.
constexpr int F32_FOLD_BYTES = 64 * 1024;
constexpr int F32_FOLD_BYTES_ALONE = 200 * 1024;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Copy the ROWS x COLS window at (r0, c0) of a row-major operand g (rows
// of ld floats) into shared memory s (rows of PITCH floats).  Elements at
// or past (rmax, cmax) arrive as zeros (cp.async's src-size fill).  KROWS:
// k runs along the window's rows (else along its columns); elements whose
// k offset in the window is klim or more are not copied (the FMA loop
// never reads them).  vec: ld and g allow 16-byte copies (c0 is then a
// multiple of 4), else one 4-byte copy an element.
template <int ROWS, int COLS, int PITCH, int NT, bool KROWS>
__device__ __forceinline__ void copy_tile(float* s, const float* g,
                                          int64_t ld, int r0, int rmax,
                                          int c0, int cmax, int klim,
                                          bool vec, int tid) {
  if (vec) {
    constexpr int CH = COLS / 4;
#pragma unroll
    for (int v = tid; v < ROWS * CH; v += NT) {
      const int r = v / CH, c = 4 * (v % CH);
      if ((KROWS ? r : c) >= klim) continue;
      const int gr = r0 + r, gc = c0 + c;
      const int bytes = gr < rmax ? 4 * max(0, min(4, cmax - gc)) : 0;
      cp_async16(s + r * PITCH + c, bytes ? g + gr * ld + gc : g, bytes);
    }
  } else {
#pragma unroll 4
    for (int v = tid; v < ROWS * COLS; v += NT) {
      const int r = v / COLS, c = v % COLS;
      if ((KROWS ? r : c) >= klim) continue;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rmax && gc < cmax;
      cp_async4(s + r * PITCH + c, ok ? g + gr * ld + gc : g, ok ? 4 : 0);
    }
  }
}

// One block: output rows [BM bx, +BM), columns [BN by, +BN), k range
// [kper bz, min(k, kper (bz + 1))) of rank bz of gridDim.z.  Each thread
// owns TM x TN outputs and keeps each one's sum as one fmaf chain in
// ascending k.  Shared memory: F32_STAGES ring slots of {A tile, B tile},
// each laid out as the operand is stored, so every cp.async walks the
// stored rows:
//  * TA = 0: x [m, k], A as BM rows of BK k (+4: a row is an odd number of
//    16-byte units, so 8 adjacent rows' float4 reads hit 8 bank groups);
//    TA = 1: x stored [k, m] (the weight gradient's X^T), A as BK rows of
//    BM.  Likewise B: TB = 0, w [k, n], BK rows of BN; TB = 1, w stored
//    [n, k] (the input gradient's W^T), BN rows of BK (+4).
//  * A thread's rows are 4-row groups BM/(TM/4) apart where A runs along m
//    in shared memory (its float4 reads take 4 rows, and a quarter warp's
//    reads 128 adjacent bytes), else rows ty + (BM/TM) i (its float4 reads
//    take 4 k); B's columns likewise.
// A split (gridDim.z > 1) writes its partial tile to ws [S, m, n4] (n4: n
// rounded up to 4), and the tile's last block to arrive, elected by an
// atomic ticket, adds the S partials in rank order 0, 1, ..., S-1 and runs
// the epilogue.  The ticket picks who adds, never the order: no atomics
// touch a value.
// Grouped (the MoE route): blockIdx.z = expert * split + rank; the
// expert's x, w start sx, sw elements on, its output rows (m of them) and
// its partial planes follow the earlier experts' (global row e m + i,
// workspace [E split, m, n4]), and its tiles draw their own tickets.  A
// 2-D launch is one expert (sx = sw = 0).
template <int BM, int BN, int BK, int TM, int TN, int TA, int TB>
__global__ void __launch_bounds__((BM / TM) * (BN / TN),
                                  F32_MIN_BLOCKS((BM / TM) * (BN / TN)))
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                void* __restrict__ y, float* __restrict__ ws, int m, int n,
                int k, int64_t ldx, int64_t ldw, int kper, int split,
                int64_t sx, int64_t sw, int vx, int vw, int smem4,
                int out_dt, Epilogue e) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int TX = BN / TN;           // threads along n
  constexpr int KP = BK + 4;            // shared rows that run along k
  constexpr int A_FL = TA ? BK * BM : BM * KP;
  constexpr int B_FL = TB ? BN * KP : BK * BN;
  constexpr int SLOT = A_FL + B_FL;
  extern __shared__ float4 f32_smem4[];
  float* sm = reinterpret_cast<float*>(f32_smem4);
  __shared__ int last;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int expert = blockIdx.z / split;
  const int rank = blockIdx.z - expert * split;
  const int64_t rbase = static_cast<int64_t>(expert) * m;
  x += expert * sx;
  w += expert * sw;
  const int kbeg = rank * kper, kend = min(k, kbeg + kper);
  const int steps = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  // rows of A and columns of B this thread owns
  auto arow = [&](int i) {
    return TA ? (i / 4) * (BM / (TM / 4)) + 4 * ty + i % 4 : ty + (BM / TM) * i;
  };
  auto bcol = [&](int j) {
    return TB ? tx + TX * j : (j / 4) * (BN / (TN / 4)) + 4 * tx + j % 4;
  };
  // k of a step past the range's end, rounded up to the FMA loop's groups
  // of 4, is never read: neither copied nor multiplied
  auto klim_of = [&](int k0) { return min(BK, (kend - k0 + 3) & ~3); };
  auto load = [&](int slot, int k0) {
    float* as = sm + slot * SLOT;
    float* bs = as + A_FL;
    const int kl = klim_of(k0);
    if (TA)
      copy_tile<BK, BM, BM, NT, true>(as, x, ldx, k0, kend, row0, m, kl,
                                      vx, tid);
    else
      copy_tile<BM, BK, KP, NT, false>(as, x, ldx, row0, m, k0, kend, kl,
                                       vx, tid);
    if (TB)
      copy_tile<BN, BK, KP, NT, false>(bs, w, ldw, col0, n, k0, kend, kl,
                                       vw, tid);
    else
      copy_tile<BK, BN, BN, NT, true>(bs, w, ldw, k0, kend, col0, n, kl,
                                      vw, tid);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < F32_STAGES - 1; ++s) {
    if (s < steps) load(s, kbeg + s * BK);
    cp_async_commit();
  }
#pragma unroll 1
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<F32_STAGES - 2>();   // step it has landed
    __syncthreads();                   // for every thread; slot it-1 free
    const int nxt = it + F32_STAGES - 1;
    if (nxt < steps) load(nxt % F32_STAGES, kbeg + nxt * BK);
    cp_async_commit();
    const float* as = sm + (it % F32_STAGES) * SLOT;
    const float* bs = as + A_FL;
    const int kl = klim_of(kbeg + it * BK);
    // not unrolled: the loop body is the kernel's largest code, and a
    // launch that finds it out of L2 fetches every line of it from DRAM
#pragma unroll 1
    for (int kq = 0; kq < kl; kq += 4) {
      float a[TM][4], b[TN][4];
      if (TA) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < TM; i += 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                &as[(kq + q) * BM + arow(i)]);
            a[i][q] = v.x; a[i + 1][q] = v.y; a[i + 2][q] = v.z;
            a[i + 3][q] = v.w;
          }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              &as[arow(i) * KP + kq]);
          a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
        }
      }
      if (TB) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              &bs[bcol(j) * KP + kq]);
          b[j][0] = v.x; b[j][1] = v.y; b[j][2] = v.z; b[j][3] = v.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < TN; j += 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                &bs[(kq + q) * BN + bcol(j)]);
            b[j][q] = v.x; b[j + 1][q] = v.y; b[j + 2][q] = v.z;
            b[j + 3][q] = v.w;
          }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][q], b[j][q], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  if (split == 1 && e.n == 0 && out_dt == DT_F32) {   // the bare product
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gr = row0 + arow(i);
      if (gr >= m) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gc = col0 + bcol(j);
        if (gc < n)
          reinterpret_cast<float*>(y)[(rbase + gr) * n + gc] = acc[i][j];
      }
    }
    return;
  }
  __syncthreads();   // every thread is done with the ring

  // The finished tile goes through shared memory as float4 chunks: rows
  // [0, vr) of the tile's valid rows, vc chunks of 4 columns each.
  const int vr = min(BM, m - row0);
  const int vc = (min(BN, n - col0) + 3) / 4;
  const int chunks = vr * vc;
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = arow(i);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = bcol(j);
        if (r < vr && c < 4 * vc) sm[r * 4 * vc + c] = acc[i][j];
      }
    }
  } else {
    // ---- split: this rank's partial tile, then the last block's sum ----
    const int n4 = (n + 3) & ~3;
    const int64_t plane = (int64_t)m * n4;
    float* const planes = ws + (int64_t)expert * split * plane;
    float* part = planes + rank * plane;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gr = row0 + arow(i);
      if (gr >= m) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gc = col0 + bcol(j);
        if (gc < n) __stcg(part + (int64_t)gr * n4 + gc, acc[i][j]);
      }
    }
    __threadfence();   // the partial is visible before the ticket is drawn
    __syncthreads();
    if (tid == 0) {
      unsigned int* t = &f32_tickets[(expert * gridDim.y + blockIdx.y)
                                     * gridDim.x + blockIdx.x];
      last = atomicAdd(t, 1u) == static_cast<unsigned int>(split - 1);
      if (last) atomicExch(t, 0u);   // every rank has drawn
    }
    __syncthreads();
    if (!last) return;
    __threadfence();

    // Each thread copies in the partials of the chunks it owns (chunk c
    // = tid + u NT), as many ranks a round as shared memory holds (smem4
    // float4s; cp.async reads L2, where the partials are, all of a
    // round's ranks in flight together), and adds them in rank order.
    // No thread reads another's chunks, so the rounds need no barrier.
    constexpr int MAXC = BM * BN / 4 / NT;   // chunks a thread owns
    const int per_round = max(1, smem4 / chunks);
    int64_t off[MAXC];                       // a chunk's place in a plane
    float4 sum[MAXC];
#pragma unroll
    for (int u = 0; u < MAXC; ++u) {
      const int c = tid + u * NT;
      off[u] = c < chunks
          ? (int64_t)(row0 + c / vc) * n4 + col0 + 4 * (c % vc) : 0;
    }
#pragma unroll 1
    for (int q0 = 0; q0 < split; q0 += per_round) {
      const int qn = min(per_round, split - q0);
#pragma unroll 1
      for (int q = 0; q < qn; ++q) {
        const float* plane_q = planes + (q0 + q) * plane;
#pragma unroll
        for (int u = 0; u < MAXC; ++u) {
          const int c = tid + u * NT;
          if (c < chunks)
            cp_async16(f32_smem4 + q * chunks + c, plane_q + off[u], 16);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
#pragma unroll
      for (int u = 0; u < MAXC; ++u) {
        const int c = tid + u * NT;
        if (c >= chunks) break;
#pragma unroll 1
        for (int q = 0; q < qn; ++q) {
          const float4 t = f32_smem4[q * chunks + c];
          if (q0 + q == 0) {
            sum[u] = t;
          } else {
            sum[u].x += t.x; sum[u].y += t.y; sum[u].z += t.z;
            sum[u].w += t.w;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < MAXC; ++u) {
      const int c = tid + u * NT;
      if (c >= chunks) break;
      f32_smem4[c] = sum[u];
    }
  }
  __syncthreads();

  // The epilogue, once per element, 4 columns of one row a thread and
  // step (a warp's stores cover whole rows).
#pragma unroll 1
  for (int c = tid; c < chunks; c += NT) {
    const int gr = row0 + c / vc, gc = col0 + 4 * (c % vc);
    float* v = sm + 4 * c;
#pragma unroll 1
    for (int q = 0; q < 4 && gc + q < n; ++q)
      v[q] = run_epilogue(e, v[q], rbase + gr, gc + q, n);
    if (out_dt == DT_F32 && n % 4 == 0) {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(y)
                                 + (rbase + gr) * n + gc) = f32_smem4[c];
    } else {
#pragma unroll 1
      for (int q = 0; q < 4 && gc + q < n; ++q)
        store_out(y, out_dt, (rbase + gr) * n + gc + q, v[q]);
    }
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

// A rank-3 bf16 tensor map of `groups` stacked [outer, inner] matrices
// (rows of `ld` elements, `outer` rows a matrix): boxes of 64 x
// `box_outer` x 1, out-of-bounds elements (past inner or outer within a
// matrix) read as zero.
static bool make_map3(CUtensorMap* map, const void* ptr, uint64_t inner,
                      uint64_t outer, uint64_t groups, uint64_t ld,
                      uint32_t box_outer) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t dims[3] = {inner, outer, groups};
  cuuint64_t strides[2] = {ld * 2, ld * outer * 2};
  cuuint32_t box[3] = {64, box_outer, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `groups` > 1 only with G = 1 (the grouped route: `groups` x and w
// operands stored back to back, each as the 2-D launch stores its own, and
// y [groups, m, n]).
template <int BN, int TA, int TB, int G>
static int launch_bf16(const void* x, const void* w, void* y, int groups,
                       int m, int n, int k, int ldx, int ldw, int split,
                       int stages, int out_dt, const Epilogue& e,
                       cudaStream_t st) {
  const size_t ring = static_cast<size_t>(stages) * stage_bytes(BN);
  const size_t smem = 1024 + ring + 16 * stages;
  if (smem > SMEM_MAX || ring < part_bytes(BN) || (BN / 8) % split != 0
      || (G == 0 && groups != 1) || (int64_t)groups * split > 65535)
    return (int)cudaErrorInvalidValue;
  // a [outer, inner] operand; grouped, `groups` of them back to back
  auto map = [&](CUtensorMap* mp, const void* p, uint64_t inner,
                 uint64_t outer, int ld, uint32_t box) {
    return G ? make_map3(mp, p, inner, outer, groups, ld, box)
             : make_map(mp, p, inner, outer, ld, box);
  };
  CUtensorMap map_x, map_w;
  const bool ok_x = TA ? map(&map_x, x, m, k, ldx, BK)
                       : map(&map_x, x, k, m, ldx, CTA_M);
  const bool ok_w = TB ? map(&map_w, w, n, k, ldw, BK)
                       : map(&map_w, w, k, n, ldw, 64);
  if (!ok_x || !ok_w) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_bf16_kernel<BN, TA, TB, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int k_tiles = (k + BK - 1) / BK;
  const int per = (k_tiles + split - 1) / split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((m + CTA_M - 1) / CTA_M, (n + BN - 1) / BN,
                     groups * split);
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, gemm_bf16_kernel<BN, TA, TB, G>,
                                       map_x,
                                       map_w, y, m, n, k_tiles, per, split,
                                       stages, out_dt, e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int TA, int TB, int G>
static int launch_bn(int bn, const void* x, const void* w, void* y,
                     int groups, int m, int n, int k, int ldx, int ldw,
                     int split, int stages, int out_dt, const Epilogue& e,
                     cudaStream_t st) {
  if (bn == 64)
    return launch_bf16<64, TA, TB, G>(x, w, y, groups, m, n, k, ldx, ldw,
                                      split, stages, out_dt, e, st);
  if (bn == 128)
    return launch_bf16<128, TA, TB, G>(x, w, y, groups, m, n, k, ldx, ldw,
                                       split, stages, out_dt, e, st);
  if (bn == 256)
    return launch_bf16<256, TA, TB, G>(x, w, y, groups, m, n, k, ldx, ldw,
                                       split, stages, out_dt, e, st);
  return (int)cudaErrorInvalidValue;
}

template <int BM, int BN, int BK, int TM, int TN, int TA, int TB>
static int launch_f32(const float* x, const float* w, void* y, float* ws,
                      int groups, int64_t sx, int64_t sw, int m, int n,
                      int k, int ldx, int ldw, int split, int kper,
                      int out_dt, const Epilogue& e, cudaStream_t st) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int SLOT = (TA ? BK * BM : BM * (BK + 4))
                     + (TB ? BN * (BK + 4) : BK * BN);
  // the ring, and after the main loop the finished tile; a split's last
  // block takes up to F32_FOLD_BYTES (F32_FOLD_BYTES_ALONE) for the
  // partials of its rounds
  constexpr int SMEM = 4 * (F32_STAGES * SLOT > BM * BN ? F32_STAGES * SLOT
                                                        : BM * BN);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          gemm_f32_kernel<BM, BN, BK, TM, TN, TA, TB>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, F32_FOLD_BYTES_ALONE);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  if ((int64_t)groups * split > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, groups * split);
  int smem = SMEM;
  if (split > 1) {
    const int64_t fold = (int64_t)split * (m < BM ? m : BM)
                         * (((n < BN ? n : BN) + 3) / 4) * 16;
    const int cap = (int64_t)grid.x * grid.y * grid.z <= sms
        ? F32_FOLD_BYTES_ALONE : F32_FOLD_BYTES;
    if (fold > smem)   // more room for the rounds, never less than SMEM
      smem = fold < cap ? (int)fold : (cap > smem ? cap : smem);
  }
  if (grid.y > 65535
      || (split > 1 && (int64_t)grid.x * grid.y * groups > F32_TICKETS))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies where the stored rows and the base allow them
  const int vx = ldx % 4 == 0 && sx % 4 == 0
                 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vw = ldw % 4 == 0 && sw % 4 == 0
                 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  gemm_f32_kernel<BM, BN, BK, TM, TN, TA, TB><<<grid, NT, smem, st>>>(
      x, w, y, ws, m, n, k, ldx, ldw, kper, split, sx, sw, vx, vw, smem / 16,
      out_dt, e);
  return (int)cudaGetLastError();
}

// The fp32 tiles by index (kernel.py::F32_TILES): BM x BN outputs a block,
// BK the k depth of a ring stage, TM x TN outputs a thread.
#define F32_TILE_LIST(X) X(64, 64, 32, 4, 4) X(32, 32, 32, 4, 4)

template <int TA, int TB>
static int launch_tile(int tile, const float* x, const float* w, void* y,
                       float* ws, int groups, int64_t sx, int64_t sw, int m,
                       int n, int k, int ldx, int ldw, int split, int kper,
                       int out_dt, const Epilogue& e, cudaStream_t st) {
  int i = 0;
#define F32_CASE(BM, BN, BK, TM, TN)                                       \
  if (tile == i++)                                                         \
    return launch_f32<BM, BN, BK, TM, TN, TA, TB>(                         \
        x, w, y, ws, groups, sx, sw, m, n, k, ldx, ldw, split, kper,       \
        out_dt, e, st);
  F32_TILE_LIST(F32_CASE)
#undef F32_CASE
  return (int)cudaErrorInvalidValue;
}

// The fp32 tiles as the library builds them: (BM, BN, BK, TM, TN) for each
// index into out[5 * i ...]; returns how many there are (at most max_tiles
// written).
extern "C" int fused_matmul_f32_tiles(int* out, int max_tiles) {
  int i = 0;
#define F32_STATE(BM, BN, BK, TM, TN)                                      \
  if (i < max_tiles) {                                                     \
    out[5 * i] = BM; out[5 * i + 1] = BN; out[5 * i + 2] = BK;             \
    out[5 * i + 3] = TM; out[5 * i + 4] = TN;                              \
  }                                                                        \
  ++i;
  F32_TILE_LIST(F32_STATE)
#undef F32_STATE
  return i;
}

// codes: 5 * MAX_STAGES ints laid out fn[], kind[], head[], cast[], opdt[].
static Epilogue read_chain(int n_stages, const int* codes,
                           const void* const* operands) {
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
  return e;
}

// y [groups, m, n] = chain(A[g] @ B[g]) for each of `groups` groups in one
// launch (G = 1; a 2-D launch is G = 0 and one group).  A is x [m, k] with
// rows of ldx elements, or with ta x stored [k, m] (A = x^T); B is w [k, n]
// with rows of ldw, or with tb w stored [n, k] (B = w^T); a grouped
// launch's groups are stored so, back to back.  bn, split and stages are
// the bf16 route's plan (kernel.py::plan), every group's that of its own
// 2-D launch; the fp32 route takes its tile index, its split and the k of
// each rank (kper), and with split > 1 a workspace ws of groups * split *
// m * n4 floats (n4: n rounded up to 4).  The three layouts the port
// launches: the forward (ta = tb = 0), the input gradient dY W^T (tb) and
// the weight gradient X^T dY (ta).
template <int G>
static int launch_layout(const void* x, const void* w, void* y, void* ws,
                         int groups, int m, int n, int k, int ldx, int ldw,
                         int ta, int tb, int in_dt, int out_dt, int bn,
                         int split, int stages, int tile, int kper,
                         int n_stages, const int* codes,
                         const void* const* operands, void* stream) {
  if (n_stages < 0 || n_stages > MAX_STAGES || groups <= 0 || m <= 0
      || n <= 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  if ((ta != 0 && ta != 1) || (tb != 0 && tb != 1) || (ta && tb))
    return (int)cudaErrorInvalidValue;
  const Epilogue e = read_chain(n_stages, codes, operands);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // the stored rows: x's are k long (m with ta), w's n (k with tb); a
  // group's x is m rows (k with ta), its w k rows (n with tb)
  const int rx = ta ? m : k, rw = tb ? k : n;
  const int64_t sx = (int64_t)(ta ? k : m) * ldx;
  const int64_t sw = (int64_t)(tb ? n : k) * ldw;
  if (in_dt != DT_BF16) {
    // the ranks' k ranges: multiples of 4 long (16-byte copies stay
    // aligned), together [0, k), the last one not empty; a split has its
    // workspace
    if (ldx < rx || ldw < rw || split < 1 || kper < 4 || kper % 4 != 0
        || (int64_t)(split - 1) * kper >= (k > 0 ? k : 1)
        || (int64_t)split * kper < k
        || (split > 1 && ws == nullptr))
      return (int)cudaErrorInvalidValue;
    const float* xf = reinterpret_cast<const float*>(x);
    const float* wf = reinterpret_cast<const float*>(w);
    float* wsf = reinterpret_cast<float*>(ws);
    if (ta)
      return launch_tile<1, 0>(tile, xf, wf, y, wsf, groups, sx, sw, m, n,
                               k, ldx, ldw, split, kper, out_dt, e, st);
    if (tb)
      return launch_tile<0, 1>(tile, xf, wf, y, wsf, groups, sx, sw, m, n,
                               k, ldx, ldw, split, kper, out_dt, e, st);
    return launch_tile<0, 0>(tile, xf, wf, y, wsf, groups, sx, sw, m, n, k,
                             ldx, ldw, split, kper, out_dt, e, st);
  }
  // TMA: 16-byte-aligned bases and row strides, no empty box
  if (k == 0 || ldx < rx || ldw < rw || ldx % 8 != 0 || ldw % 8 != 0
      || reinterpret_cast<uintptr_t>(x) % 16 != 0
      || reinterpret_cast<uintptr_t>(w) % 16 != 0
      || split < 1 || split > 8 || stages < 2 || stages > 8)
    return (int)cudaErrorInvalidValue;
  if (ta)
    return launch_bn<1, 1, G>(bn, x, w, y, groups, m, n, k, ldx, ldw, split,
                              stages, out_dt, e, st);
  if (tb)
    return launch_bn<0, 0, G>(bn, x, w, y, groups, m, n, k, ldx, ldw, split,
                              stages, out_dt, e, st);
  return launch_bn<0, 1, G>(bn, x, w, y, groups, m, n, k, ldx, ldw, split,
                            stages, out_dt, e, st);
}

// One product y [m, n] = chain(A @ B) (launch_layout with one group).
extern "C" int fused_matmul_launch(const void* x, const void* w, void* y,
                                   void* ws, int m, int n, int k, int ldx,
                                   int ldw, int ta, int tb,
                                   int in_dt, int out_dt, int bn, int split,
                                   int stages, int tile, int kper,
                                   int n_stages,
                                   const int* codes,
                                   const void* const* operands,
                                   void* stream) {
  return launch_layout<0>(x, w, y, ws, 1, m, n, k, ldx, ldw, ta, tb, in_dt,
                          out_dt, bn, split, stages, tile, kper, n_stages,
                          codes, operands, stream);
}

// The grouped route (launch_layout with G = 1): the MoE expert FFN (ta =
// tb = 0) and its grouped dX (tb) and dW (ta).  A full epilogue operand is
// [groups * m, n], a row operand [n].
extern "C" int fused_matmul_grouped_launch(const void* x, const void* w,
                                           void* y, void* ws, int groups,
                                           int m, int n, int k, int ldx,
                                           int ldw, int ta, int tb,
                                           int in_dt, int out_dt,
                                           int bn, int split, int stages,
                                           int tile, int kper, int n_stages,
                                           const int* codes,
                                           const void* const* operands,
                                           void* stream) {
  return launch_layout<1>(x, w, y, ws, groups, m, n, k, ldx, ldw, ta, tb,
                          in_dt, out_dt, bn, split, stages, tile, kper,
                          n_stages, codes, operands, stream);
}
