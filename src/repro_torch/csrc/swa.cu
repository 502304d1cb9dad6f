// Causal, optionally sliding-window, flash-attention forward with GQA.
//
// Replaces the TPU kernel src/repro/kernels/swa/kernel.py::swa_attention
// (_kernel). For q (b, s, h, d) and k, v (b, s, kh, d), h % kh == 0:
//
//   o[b, i, hq] = sum_j softmax_j(q_i . k_j / sqrt(d)) v_j
//
// over keys j <= i (and j > i - window when window > 0), with the KV head
// kh_idx = hq / (h / kh): K and V are never repeated in memory. Numerics as
// the TPU kernel: scores in float32, masked entries -2e38, an online softmax
// with a float32 running maximum and sum, p rounded to v's type before the PV
// product (accumulated in float32), the denominator clamped at 1e-30, output
// in q's type. The bfloat16 kernel keeps its softmax in base 2 (scores times
// scale * log2(e), exp2f), which is the same function up to rounding.
//
// What bounds it on an H100: 4*d operations per (query, key) pair in the
// band, per head. At the prefill shapes of the serving path (s = 2048 and
// 8192, d = 128) that is over a thousand operations per byte of q, k, v
// and o, so the bound is the bf16 tensor-core rate.
//
// Design: the TPU kernel walked a static band of KV blocks per query block
// with clamped index maps and masked the duplicates, because its grid is
// static. Here a block takes a query tile and loops over exactly the KV
// tiles of its band, [q0 - window + 1, q_end], or [0, q_end] without a
// window: fully masked tiles are never visited. Query tiles are issued
// longest band first. The running maximum, sum and output accumulator live
// in registers. q, k, v and o are read through their strides in the
// (b, s, h, d) layout the model produces (no transposes, no padding copies);
// ragged s is zero-filled in the loads and masked. The per-element mask runs
// only on tiles that cross the diagonal, the window's lower edge or s. The
// score fragment is re-packed in registers as the A operand of the p v
// product (the FA2 layout), so p never touches shared memory. Three kernels:
//  * bfloat16, d = 64 and 128 (the serving path): warpgroup MMA (wgmma),
//    warp-specialised, described at swa_wgmma_kernel below. One producer
//    warp feeds K and V by TMA through mbarrier-guarded rings; one consumer
//    warpgroup per query head (64 rows), up to three heads of a KV head per
//    block; each warpgroup issues tile t's q k^T together with tile t-1's
//    p v so its softmax overlaps the tensor cores.
//    A K or V layout no TMA map can describe, or a driver without
//    cuTensorMapEncodeTiled, is refused (cudaErrorNotSupported), not served
//    by another kernel.
//  * bfloat16, d = 96 and 256 (FA2-class, mma.sync m16n8k16): 8 warps x 16
//    query rows, 64-key tiles.
//    q's A fragments are loaded once (ldmatrix.x4) and held in registers
//    (d = 256 re-reads them from shared memory, for registers). K and V come
//    through two-stage cp.async rings (16-byte, .cg, rows padded by 16 bytes
//    so ldmatrix is conflict-free): V of tile t loads while q k^T of tile t
//    runs, K of tile t+1 while the softmax and p v of tile t run. K's B
//    fragments come from ldmatrix, V's from ldmatrix.trans on V's natural
//    (key, d) layout; a warp skips a tile wholly masked for its 16 rows
//    (bitwise the same result).
//  * float32: plain FMA (TF32 would break the float32 gates), 32 x 32 tiles,
//    8 threads per query row; p goes through shared memory.
// Head widths d in {64, 96, 128, 256} are instantiated; other d are refused.
// No atomics anywhere: a call is bitwise repeatable.
#include <cuda.h>   // CUtensorMap and its enums (the driver is reached through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float kNegInf = -2.0e38f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;   // strides in elements; the last dim is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int s, h, kh, window;
  int heads_per_block;   // wgmma kernel: query heads of one KV head per block
  int kv_heads_inner;    // wgmma kernel: K's and V's maps order (d, head, seq, batch)
  float scale;
};

// First key of the band of a query tile starting at q0, rounded down to a tile.
__device__ __forceinline__ int band_start(int q0, int window, int tile) {
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  return (lo / tile) * tile;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int s, int window) {
  return kpos <= qpos && kpos < s && (window <= 0 || kpos > qpos - window);
}

// ------------------------------------------------------------------ bfloat16
constexpr int kBQ = 128;       // query rows per block (8 warps x 16)
constexpr int kBK = 64;        // keys per tile
constexpr int kMmaThreads = 256;
constexpr int kStages = 2;     // K and V ring depth
constexpr float kLog2e = 1.4426950408889634f;

// q lives in registers for d <= 128; d = 256 would leave too few for o.
template <int D>
constexpr bool kQInRegs = D <= 128;

// K ring, V ring (kStages x kBK rows of D + 8 bf16 each), and a q tile of
// its own when q is not held in registers (else q is staged in the V ring,
// whose kStages * kBK rows hold the kBQ query rows).
template <int D>
constexpr size_t mma_smem_bytes() {
  return (size_t)(2 * kStages * kBK + (kQInRegs<D> ? 0 : kBQ)) * (D + 8) *
         sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Start copying rows [r0, r0 + ROWS) of a (seq, D) slab with row stride ss
// into shared rows of D + 8; rows at or past s are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long ss, int r0, int s) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const bool ok = r0 + r < s;
    cp_async16(dst + r * (D + 8) + c, ok ? src + (r0 + r) * ss + c : src, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1) swa_mma_kernel(Params P) {
  constexpr int kRow = D + 8;   // bf16 per shared row (16-byte pad)
  constexpr bool kQReg = kQInRegs<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // kStages x (kBK, kRow)
  __nv_bfloat16* Vs = Ks + kStages * kBK * kRow;                     // kStages x (kBK, kRow)
  __nv_bfloat16* Qs = kQReg ? Vs : Vs + kStages * kBK * kRow;        // (kBQ, kRow)

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest bands first
  const int bi = blockIdx.y / P.h, hq = blockIdx.y % P.h;
  const int hk = hq / (P.h / P.kh);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(P.q) + bi * P.q_sb + hq * P.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(P.k) + bi * P.k_sb + hk * P.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(P.v) + bi * P.v_sb + hk * P.v_sh;

  const int q_end = min(q0 + kBQ, P.s);
  const int kv_begin = band_start(q0, P.window, kBK);
  const int n_tiles = (q_end - kv_begin + kBK - 1) / kBK;
  const int row_lo = q0 + warp * 16, row_hi = row_lo + 15;   // this warp's rows
  const int row0 = row_lo + g;   // this thread's rows: row0 and row0 + 8

  // ldmatrix lane offsets (elements): A of q, B of k, B of v (transposed)
  const int a_off = (lane % 16) * kRow + (lane / 16) * 8;
  const int kb_off = ((lane % 8) + (lane / 16) * 8) * kRow + ((lane / 8) % 2) * 8;
  const int vb_off = ((lane % 8) + ((lane / 8) % 2) * 8) * kRow + (lane / 16) * 8;

  stage_rows<D, kBQ>(Qs, qg, P.q_ss, q0, P.s);
  stage_rows<D, kBK>(Ks, kg, P.k_ss, kv_begin, P.s);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[kQReg ? D / 16 : 1][4];
  if (kQReg) {
#pragma unroll
    for (int kk = 0; kk < (kQReg ? D / 16 : 1); ++kk)
      ldsm_x4(qf[kk], Qs + warp * 16 * kRow + a_off + kk * 16);
    __syncthreads();   // the V ring is free for V
  }

  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nt][j] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const float scale_log2 = P.scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = kv_begin + t * kBK;
    const __nv_bfloat16* Kt = Ks + (t % kStages) * kBK * kRow;
    const __nv_bfloat16* Vt = Vs + (t % kStages) * kBK * kRow;
    stage_rows<D, kBK>(Vs + (t % kStages) * kBK * kRow, vg, P.v_ss, kv0, P.s);
    cp_async_commit();

    // warp-uniform: a tile wholly masked for this warp's rows changes nothing
    const bool skip = row_lo >= P.s || kv0 > row_hi ||
                      (P.window > 0 && kv0 + kBK - 1 <= row_lo - P.window);
    const bool need_mask = kv0 + kBK - 1 > row_lo || kv0 + kBK > P.s ||
                           (P.window > 0 && kv0 <= row_hi - P.window);
    float sc[kBK / 8][4];
    if (!skip) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nt][j] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        if (kQReg) {
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j] = qf[kQReg ? kk : 0][j];
        } else {
          ldsm_x4(a, Qs + warp * 16 * kRow + a_off + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < kBK / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, Kt + np * 16 * kRow + kb_off + kk * 16);
          mma_bf16(sc[2 * np], a, b[0], b[1]);
          mma_bf16(sc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    if (t + 1 < n_tiles)
      stage_rows<D, kBK>(Ks + ((t + 1) % kStages) * kBK * kRow, kg, P.k_ss, kv0 + kBK, P.s);
    cp_async_commit();

    if (!skip) {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = sc[nt][j] * scale_log2;
          if (need_mask && !visible(row0 + (j >> 1) * 8, kv0 + nt * 8 + t4 * 2 + (j & 1), P.s,
                                    P.window))
            x = kNegInf;
          sc[nt][j] = x;
          mx[j >> 1] = fmaxf(mx[j >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {   // a row lives in the 4 threads of a quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pj = exp2f(sc[nt][j] - m[j >> 1]);
          sc[nt][j] = pj;
          l[j >> 1] += pj;   // this thread's share of the row sum, unrounded
        }
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        o[nt][0] *= corr[0];
        o[nt][1] *= corr[0];
        o[nt][2] *= corr[1];
        o[nt][3] *= corr[1];
      }
    }
    cp_async_wait<1>();   // V of tile t has landed (K of t + 1 may be in flight)
    __syncthreads();
    if (!skip) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // the score fragments of keys 16kk .. 16kk+15, rounded to bf16, are
        // the A fragment of the p v product
        const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                               pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                               pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                               pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, Vt + kk * 16 * kRow + vb_off + np * 16);
          mma_bf16(o[2 * np], a, b[0], b[1]);
          mma_bf16(o[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    cp_async_wait<0>();   // K of tile t + 1 has landed
    __syncthreads();      // and every warp is done with this tile's K and V
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(P.o) + bi * P.o_sb + hq * P.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    if (qpos >= P.s) continue;
    __nv_bfloat16* orow = og + qpos * P.o_ss + t4 * 2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(orow + nt * 8) =
          pack_bf16(o[nt][2 * r] / den[r], o[nt][2 * r + 1] / den[r]);
  }
}

// ------------------------------------------------------- bfloat16, wgmma
// Warp-specialised: one producer warp keeps K and V tiles in flight with TMA
// (tensor-map copies that land 128-byte-swizzled, completion counted on
// mbarriers), and one consumer warpgroup per query head, 64 query rows
// each, computes. A block packs the three query heads that share a KV head
// when three divide h / kh (each K and V tile is then read from L2 once for
// all three), else takes one. 64-key tiles. q, K and V sit in shared memory
// in the layout that wgmma's descriptors read: a (rows, D) tile is D / 64
// column blocks of (rows, 64) bf16, each row 128 bytes with its 16-byte
// chunks XOR-ed by row % 8. K and V each have a three-stage ring guarded by
// full and empty barriers, so the warpgroups run without block-wide
// barriers, and each warpgroup's loop is software-pipelined: tile t's q k^T
// product is issued together with tile t-1's p v product, so the softmax of
// tile t runs on the CUDA cores while the tensor cores work on p v.
constexpr int kWgRows = 64;        // query rows per block (and per warpgroup)
constexpr int kWgThreads = 128;    // one warpgroup
constexpr int kWgMaxHeads = 3;     // consumer warpgroups (query heads) per block, at most
constexpr int kWgStages = 3;       // depth of the K ring and of the V ring

// Shared memory: the K and V rings, one q tile per consumer, and the four
// barrier arrays (full and empty, K and V).
template <int D>
size_t wg_smem_bytes(int heads) {
  return (size_t)(heads * kWgRows + 2 * kWgStages * kBK) * D * sizeof(__nv_bfloat16) +
         4 * kWgStages * sizeof(uint64_t);
}

// Query heads per block for h / kh query heads per KV head: three when
// they divide it, else one. Measured on the H100 (with this kernel's
// cp.async predecessor): three warpgroups in one block beat two one-head
// blocks per SM at d = 128, but two warpgroups in one block lost to two
// one-head blocks at d = 64, on registers. Only groups of 3 (h / kh = 24/8)
// were timed; groups of 2, 4 and 8 take one head per block, unmeasured.
inline int wg_heads_per_block(int group) { return group % kWgMaxHeads == 0 ? kWgMaxHeads : 1; }

// d (+)= A B over one k16 step: A (64 x 16) and B (16 x 64, K-major) from
// shared memory through their descriptors; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d += A B over one k16 step: A (64 x 16) from registers (the mma.sync A
// fragment layout per warp), B (16 x 64, N-major: transposed) from shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d += A B over one k16 step: A (64 x 16) from registers (the mma.sync A
// fragment layout per warp), B (16 x 128, N-major: transposed) from shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Byte offset of (row, col) in a swizzled tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ int sw_off(int row, int col) {
  return (col / 64) * ROWS * 128 + row * 128 + ((((col % 64) / 8) ^ (row % 8)) * 16) +
         (col % 8) * 2;
}

// Start copying rows [r0, r0 + ROWS) into a swizzled tile, by the kWgThreads
// threads of one warpgroup (wt: the thread's index in it).
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows_sw(unsigned char* dst, const __nv_bfloat16* src,
                                              long long ss, int r0, int s, int wt) {
  constexpr int kChunks = D / 8;
  for (int idx = wt; idx < ROWS * kChunks; idx += kWgThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const bool ok = r0 + r < s;
    cp_async16(dst + sw_off<ROWS>(r, c), ok ? src + (r0 + r) * ss + c : src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// arrive, and expect `bytes` of TMA copies to complete on the barrier
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// TMA: copy the box at (c0, c1, c2, c3) of a 4-d tensor map into shared memory
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {   // ex2.approx: 2^x, denormals to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor, 128-byte swizzle: lbo and sbo in bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, int lbo, int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {   // at most N wgmma groups still in flight
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async's writes, made visible to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pins registers that an asynchronous wgmma reads or writes, so the
// compiler moves no access across the fence and wait around it.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

template <int N>
__device__ __forceinline__ void keep_u32(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Online softmax of one 64 x 64 score tile held as wgmma accumulators (in
// base 2): masks it if asked, updates the running maximum m and sum l,
// returns the factor the output accumulated so far must take (corr), and
// writes p rounded to bf16 as the register A operand of the p v product
// (the mma.sync A layout per warp: keys 16kk .. 16kk+15 in pa[kk]).
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], uint32_t (&pa)[kBK / 16][4],
                                             float scale_log2, bool need_mask, int row0,
                                             int kv0, int t4, int s, int window) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = sc[nt * 4 + j] * scale_log2;
      if (need_mask &&
          !visible(row0 + (j >> 1) * 8, kv0 + nt * 8 + t4 * 2 + (j & 1), s, window))
        x = kNegInf;
      sc[nt * 4 + j] = x;
      mx[j >> 1] = fmaxf(mx[j >> 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // a row lives in the 4 threads of a quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = fast_exp2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float pj = fast_exp2(sc[i] - m[(i >> 1) & 1]);
    sc[i] = pj;
    l[(i >> 1) & 1] += pj;   // this thread's share of the row sum, unrounded
  }
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads * kWgMaxHeads + 32)
    swa_wgmma_kernel(Params P, const __grid_constant__ CUtensorMap tmap_k,
                     const __grid_constant__ CUtensorMap tmap_v) {
  // the swizzle atoms must sit on 1024-byte boundaries
  extern __shared__ __align__(1024) unsigned char base[];
  if (smem_addr(base) & 1023) __trap();
  constexpr int kTileB = kBK * D * 2;   // bytes of one K or V tile
  const int heads = P.heads_per_block;
  unsigned char* Ks = base;                            // kWgStages x (kBK, D)
  unsigned char* Vs = Ks + kWgStages * kTileB;         // kWgStages x (kBK, D)
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kWgStages * kTileB + heads * kWgRows * D * 2);
  uint64_t* k_full = bars;
  uint64_t* k_empty = bars + kWgStages;
  uint64_t* v_full = bars + 2 * kWgStages;
  uint64_t* v_empty = bars + 3 * kWgStages;
  const int wg = threadIdx.x / kWgThreads, wt = threadIdx.x % kWgThreads;
  const bool producer = wg == heads;   // the last warp

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest bands first
  // blockIdx.y: (batch, KV head, which pack of `heads` of its query heads)
  const int packs = P.h / P.kh / heads;
  const int bi = blockIdx.y / (P.kh * packs);
  const int hk = blockIdx.y / packs % P.kh;
  const int q0 = qt * kWgRows;
  const int q_end = min(q0 + kWgRows, P.s);
  const int kv_begin = band_start(q0, P.window, kBK);
  // every tile of the band has a visible key for some row of the block (the
  // first holds q0's window start, the last ends at or before q_end)
  const int n_tiles = (q_end - kv_begin + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&k_empty[i], 4 * heads);   // one arrival per consumer warp
      mbar_init(&v_empty[i], 4 * heads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int hq = hk * (P.h / P.kh) + blockIdx.y % packs * heads + (producer ? 0 : wg);
  unsigned char* Qs = Vs + kWgStages * kTileB + wg * kWgRows * D * 2;   // (kWgRows, D)
  if (!producer) {
    const __nv_bfloat16* qg =
        static_cast<const __nv_bfloat16*>(P.q) + bi * P.q_sb + hq * P.q_sh;
    stage_rows_sw<D, kWgRows>(Qs, qg, P.q_ss, q0, P.s, wt);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
  }
  __syncthreads();   // barriers initialised, q tiles in place

  if (producer) {
    if (wt % 32 == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kWgStages, use = t / kWgStages;
        const int kv0 = kv_begin + t * kBK;
        const int c1 = P.kv_heads_inner ? hk : kv0, c2 = P.kv_heads_inner ? kv0 : hk;
        if (use > 0) mbar_wait(&k_empty[st], (use - 1) & 1);
        mbar_expect(&k_full[st], kTileB);
#pragma unroll
        for (int blk = 0; blk < D / 64; ++blk)
          tma_load_4d(Ks + st * kTileB + blk * kBK * 128, &tmap_k, &k_full[st], blk * 64, c1,
                      c2, bi);
        if (use > 0) mbar_wait(&v_empty[st], (use - 1) & 1);
        mbar_expect(&v_full[st], kTileB);
#pragma unroll
        for (int blk = 0; blk < D / 64; ++blk)
          tma_load_4d(Vs + st * kTileB + blk * kBK * 128, &tmap_v, &v_full[st], blk * 64, c1,
                      c2, bi);
      }
    }
    return;
  }

  const int warp = wt / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0 and row0 + 8
  auto kstage = [&](int t) { return Ks + (t % kWgStages) * kTileB; };
  auto vstage = [&](int t) { return Vs + (t % kWgStages) * kTileB; };
  auto wait_k = [&](int t) { mbar_wait(&k_full[t % kWgStages], (t / kWgStages) & 1); };
  auto wait_v = [&](int t) { mbar_wait(&v_full[t % kWgStages], (t / kWgStages) & 1); };
  auto free_k = [&](int t) {
    if (lane == 0) mbar_arrive(&k_empty[t % kWgStages]);
  };
  auto free_v = [&](int t) {
    if (lane == 0) mbar_arrive(&v_empty[t % kWgStages]);
  };
  auto need_mask = [&](int kv0) {
    return kv0 + kBK - 1 > q0 || kv0 + kBK > P.s ||
           (P.window > 0 && kv0 <= q0 + kWgRows - 1 - P.window);
  };
  auto qk = [&](float (&sc)[32], int t) {   // issue S = q K_t^T
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int blk = kk / 4, kb = (kk % 4) * 32;
      wgmma_ss_n64(sc, sw128_desc(Qs + blk * kWgRows * 128 + kb, 16, 1024),
                   sw128_desc(kstage(t) + blk * kBK * 128 + kb, 16, 1024), kk > 0);
    }
    wg_commit();
  };
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, corr[2];
  uint32_t pa[kBK / 16][4];
  auto pv = [&](int t) {   // rescale o, then issue o += p V_t
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt * 4 + 0] *= corr[0];
      o[nt * 4 + 1] *= corr[0];
      o[nt * 4 + 2] *= corr[1];
      o[nt * 4 + 3] *= corr[1];
    }
    keep(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)   // V is N-major: a transposed B, column blocks apart
      wgmma_pv<D>(o, pa[kk], sw128_desc(vstage(t) + kk * 16 * 128, kBK * 128, 1024));
    wg_commit();
  };
  const float scale_log2 = P.scale * kLog2e;
  float sc[32];

  // tile 0: S_0 and its softmax
  wait_k(0);
  qk(sc, 0);
  wg_wait<0>();
  keep(sc);
  free_k(0);
  softmax_tile(sc, m, l, corr, pa, scale_log2, need_mask(kv_begin), row0, kv_begin, t4,
               P.s, P.window);

  for (int t = 1; t < n_tiles; ++t) {
    const int kv0 = kv_begin + t * kBK;
    wait_k(t);
    qk(sc, t);            // S_t ...
    wait_v(t - 1);
    pv(t - 1);            // ... and o += p_{t-1} V_{t-1} behind it
    wg_wait<1>();         // S_t is done; p v runs on
    keep(sc);
    free_k(t);
    uint32_t pn[kBK / 16][4];
    float cn[2];
    softmax_tile(sc, m, l, cn, pn, scale_log2, need_mask(kv0), row0, kv0, t4, P.s, P.window);
    wg_wait<0>();         // p_{t-1} v is done: its registers and V stage are free
    keep(o);
    keep_u32(pa);
    free_v(t - 1);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pn[kk][j];
    corr[0] = cn[0];
    corr[1] = cn[1];
  }
  wait_v(n_tiles - 1);
  pv(n_tiles - 1);
  wg_wait<0>();
  keep(o);
  keep_u32(pa);

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(P.o) + bi * P.o_sb + hq * P.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    if (qpos >= P.s) continue;
    __nv_bfloat16* orow = og + qpos * P.o_ss + t4 * 2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(orow + nt * 8) =
          pack_bf16(o[nt * 4 + 2 * r] / den[r], o[nt * 4 + 2 * r + 1] / den[r]);
  }
}

// ------------------------------------------------------------------- float32
constexpr int kFB = 32;          // query rows and keys per tile
constexpr int kSimtThreads = 256;  // 8 threads per query row

template <int D>
constexpr size_t simt_smem_bytes() {
  return (size_t)(2 * kFB * (D + 1) + kFB * D + kFB * (kFB + 1)) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads) swa_simt_kernel(Params P) {
  extern __shared__ float fsm[];
  float* Qs = fsm;                    // (row, d), padded rows
  float* Ks = Qs + kFB * (D + 1);     // (key, d), padded rows
  float* Vs = Ks + kFB * (D + 1);     // (key, d)
  float* Ps = Vs + kFB * D;           // (row, key), padded rows

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bi = blockIdx.y / P.h, hq = blockIdx.y % P.h;
  const int hk = hq / (P.h / P.kh);
  const int q0 = qt * kFB;
  const int tid = threadIdx.x, row = tid / 8, c8 = tid % 8;
  const float* qg = static_cast<const float*>(P.q) + bi * P.q_sb + hq * P.q_sh;
  const float* kg = static_cast<const float*>(P.k) + bi * P.k_sb + hk * P.k_sh;
  const float* vg = static_cast<const float*>(P.v) + bi * P.v_sb + hk * P.v_sh;

  for (int idx = tid; idx < kFB * D; idx += kSimtThreads) {
    const int r = idx / D, c = idx % D;
    Qs[r * (D + 1) + c] = q0 + r < P.s ? qg[(q0 + r) * P.q_ss + c] : 0.0f;
  }
  float o[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j] = 0.0f;
  float m = kNegInf, l = 0.0f;
  const int qpos = q0 + row;
  const int q_end = min(q0 + kFB, P.s);

  for (int kv0 = band_start(q0, P.window, kFB); kv0 < q_end; kv0 += kFB) {
    __syncthreads();
    for (int idx = tid; idx < kFB * D; idx += kSimtThreads) {
      const int r = idx / D, c = idx % D;
      const bool ok = kv0 + r < P.s;
      Ks[r * (D + 1) + c] = ok ? kg[(kv0 + r) * P.k_ss + c] : 0.0f;
      Vs[r * D + c] = ok ? vg[(kv0 + r) * P.v_ss + c] : 0.0f;
    }
    __syncthreads();

    float sv[kFB / 8];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kFB / 8; ++j) {
      const int key = c8 + 8 * j;
      float acc = 0.0f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) acc = fmaf(Qs[row * (D + 1) + c], Ks[key * (D + 1) + c], acc);
      sv[j] = visible(qpos, kv0 + key, P.s, P.window) ? acc * P.scale : kNegInf;
      mx = fmaxf(mx, sv[j]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float corr = expf(m - mx);
    m = mx;
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kFB / 8; ++j) {
      const float pj = expf(sv[j] - m);
      psum += pj;
      Ps[row * (kFB + 1) + c8 + 8 * j] = pj;
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * corr + psum;
    __syncwarp();   // a row's p is written and read by the same 8 threads of one warp
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j] *= corr;
    for (int key = 0; key < kFB; ++key) {
      const float pk = Ps[row * (kFB + 1) + key];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) o[j] = fmaf(pk, Vs[key * D + c8 + 8 * j], o[j]);
    }
  }
  if (qpos < P.s) {
    float* orow = static_cast<float*>(P.o) + bi * P.o_sb + hq * P.o_sh + qpos * P.o_ss;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) orow[c8 + 8 * j] = o[j] / den;
  }
}

// cuTensorMapEncodeTiled, found through the runtime's driver entry points
// (no link against libcuda); null if the driver does not provide it.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The TMA map of K or V, a (b, s, heads, D) bf16 tensor with element strides
// (sb, ss, sh, 1): boxes of 64 of D by kBK rows, landing 128-byte-swizzled;
// rows past s read as zeros. The head dimension goes inside the sequence
// dimension if heads_inner, else outside. False if the layout cannot be mapped.
bool kv_tensor_map(CUtensorMap* map, const void* ptr, int D, int s, int heads, int b,
                   long long sb, long long ss, long long sh, bool heads_inner) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(heads_inner ? heads : s),
                              (cuuint64_t)(heads_inner ? s : heads), (cuuint64_t)b};
  const long long inner = heads_inner ? sh : ss, outer = heads_inner ? ss : sh;
  const long long batch = b > 1 ? sb : outer * (heads_inner ? s : heads);
  const cuuint64_t strides[3] = {(cuuint64_t)inner * 2, (cuuint64_t)outer * 2,
                                 (cuuint64_t)batch * 2};
  const cuuint32_t box[4] = {64, heads_inner ? 1u : (cuuint32_t)kBK,
                             heads_inner ? (cuuint32_t)kBK : 1u, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lets a kernel use `bytes` of dynamic shared memory.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
cudaError_t launch(int dtype, int b, const Params& P, cudaStream_t stream) {
  if (dtype == 1) {
    if constexpr (D == 64 || D == 128) {
      CUtensorMap map_k, map_v;
      // the map's dimensions in the order of the strides (one order for both)
      const bool heads_inner = P.k_sh <= P.k_ss && P.v_sh <= P.v_ss;
      if (!kv_tensor_map(&map_k, P.k, D, P.s, P.kh, b, P.k_sb, P.k_ss, P.k_sh, heads_inner) ||
          !kv_tensor_map(&map_v, P.v, D, P.s, P.kh, b, P.v_sb, P.v_ss, P.v_sh, heads_inner))
        return cudaErrorNotSupported;
      Params Q = P;
      Q.kv_heads_inner = heads_inner;
      Q.heads_per_block = wg_heads_per_block(P.h / P.kh);
      const size_t smem = wg_smem_bytes<D>(Q.heads_per_block);
      cudaError_t err = opt_in_smem(swa_wgmma_kernel<D>, wg_smem_bytes<D>(kWgMaxHeads));
      if (err != cudaSuccess) return err;
      dim3 grid((P.s + kWgRows - 1) / kWgRows, b * P.h / Q.heads_per_block);
      swa_wgmma_kernel<D>
          <<<grid, kWgThreads * Q.heads_per_block + 32, smem, stream>>>(Q, map_k, map_v);
    } else {
      const size_t smem = mma_smem_bytes<D>();
      cudaError_t err = opt_in_smem(swa_mma_kernel<D>, smem);
      if (err != cudaSuccess) return err;
      dim3 grid((P.s + kBQ - 1) / kBQ, b * P.h);
      swa_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(P);
    }
  } else {
    const size_t smem = simt_smem_bytes<D>();
    cudaError_t err = opt_in_smem(swa_simt_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((P.s + kFB - 1) / kFB, b * P.h);
    swa_simt_kernel<D><<<grid, kSimtThreads, smem, stream>>>(P);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v and o all of it). d in {64, 96, 128,
// 256}. strides: 12 element strides, (batch, seq, head) of q, k, v and o in
// that order; the head-width dimension must be contiguous and, for bfloat16,
// every row 16-byte aligned. Returns a cudaError_t (0 on success).
int repro_swa_attention(int dtype, int d, int b, int s, int h, int kh, int window,
                        const void* q, const void* k, const void* v, void* o,
                        const long long* strides, void* stream_handle) {
  if (b <= 0 || s <= 0 || h <= 0 || kh <= 0 || h % kh != 0 || window < 0 ||
      (dtype != 0 && dtype != 1) || (long long)b * h > 65535)
    return cudaErrorInvalidValue;
  Params P;
  P.q = q;
  P.k = k;
  P.v = v;
  P.o = o;
  P.q_sb = strides[0];
  P.q_ss = strides[1];
  P.q_sh = strides[2];
  P.k_sb = strides[3];
  P.k_ss = strides[4];
  P.k_sh = strides[5];
  P.v_sb = strides[6];
  P.v_ss = strides[7];
  P.v_sh = strides[8];
  P.o_sb = strides[9];
  P.o_ss = strides[10];
  P.o_sh = strides[11];
  P.s = s;
  P.h = h;
  P.kh = kh;
  P.window = window;
  P.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));   // 1/sqrt(d) as the TPU wrapper rounds it
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  switch (d) {
    case 64: return launch<64>(dtype, b, P, stream);
    case 96: return launch<96>(dtype, b, P, stream);
    case 128: return launch<128>(dtype, b, P, stream);
    case 256: return launch<256>(dtype, b, P, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The head widths the kernel is instantiated for, for the wrapper's check.
int repro_swa_supports(int d) { return d == 64 || d == 96 || d == 128 || d == 256; }

}  // extern "C"
