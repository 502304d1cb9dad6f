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
// in q's type.
//
// What bounds it on an H100: 4*d operations per (query, key) pair in the
// band, per head. At the prefill shapes of the serving path (s = 2048 and
// 8192, d = 128) that is over a thousand operations per byte of q, k, v
// and o, so the bound is the bf16 tensor-core rate.
//
// Design: the TPU kernel walked a static band of KV blocks per query block
// with clamped index maps and masked the duplicates, because its grid is
// static. Here one block takes one (batch*head, query tile) pair and loops
// over exactly the KV tiles of its band, [q0 - window + 1, q_end], or
// [0, q_end] without a window: fully masked tiles are never visited. Query
// tiles are issued longest band first. The running maximum, sum and output
// accumulator live in registers; q, k and v tiles in shared memory. q, k, v
// and o are read through their strides in the (b, s, h, d) layout the model
// produces (no transposes, no padding copies); ragged s is masked in the
// loads and stores.
//  * bfloat16: 4 warps x 16 query rows, 64-key tiles, mma.sync m16n8k16
//    (bf16 in, float32 accumulate) for both q k^T and p v; the score
//    fragment is re-packed in registers as the A operand of the p v product
//    (the FA2 layout), so p never touches shared memory. v is stored
//    transposed in shared memory so its B fragments are 32-bit loads.
//  * float32: plain FMA (TF32 would break the float32 gates), 32 x 32 tiles,
//    8 threads per query row; p goes through shared memory.
// Head widths d in {64, 96, 128, 256} are instantiated; other d are refused.
// No double buffering or TMA yet: loads and math of a tile do not overlap.
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
constexpr int kBQ = 64;        // query rows per block (4 warps x 16)
constexpr int kBK = 64;        // keys per tile
constexpr int kMmaThreads = 128;
constexpr int kVRow = kBK + 8; // bf16 per row of transposed v (pad: no bank conflicts)

template <int D>
constexpr size_t mma_smem_bytes() {
  return (size_t)(2 * kBQ * (D + 8) + D * kVRow) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) swa_mma_kernel(Params P) {
  constexpr int kRow = D + 8;   // bf16 per row of q and k in shared memory
  constexpr int kVec = 8;       // bf16 per 16-byte load
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * kRow;
  __nv_bfloat16* Vt = Ks + kBK * kRow;   // (d, key)

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
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int idx = tid; idx < kBQ * (D / kVec); idx += kMmaThreads) {
    const int r = idx / (D / kVec), c = (idx % (D / kVec)) * kVec;
    uint4 val = zero;
    if (q0 + r < P.s) val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * P.q_ss + c);
    *reinterpret_cast<uint4*>(Qs + r * kRow + c) = val;
  }

  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nt][j] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0 and row0 + 8
  const int q_end = min(q0 + kBQ, P.s);

  for (int kv0 = band_start(q0, P.window, kBK); kv0 < q_end; kv0 += kBK) {
    __syncthreads();   // the previous tile is consumed (and q is staged)
    for (int idx = tid; idx < kBK * (D / kVec); idx += kMmaThreads) {
      const int r = idx / (D / kVec), c = (idx % (D / kVec)) * kVec;
      uint4 val = zero;
      if (kv0 + r < P.s) val = *reinterpret_cast<const uint4*>(kg + (kv0 + r) * P.k_ss + c);
      *reinterpret_cast<uint4*>(Ks + r * kRow + c) = val;
    }
    for (int idx = tid; idx < kBK * (D / kVec); idx += kMmaThreads) {
      // consecutive threads take consecutive keys: the transposed stores hit
      // consecutive shared-memory addresses
      const int r = idx % kBK, c = (idx / kBK) * kVec;
      uint4 val = zero;
      if (kv0 + r < P.s) val = *reinterpret_cast<const uint4*>(vg + (kv0 + r) * P.v_ss + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < kVec; ++j) Vt[(c + j) * kVRow + r] = e[j];
    }
    __syncthreads();

    float sc[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[nt][j] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + (warp * 16 + g) * kRow + kk * 16 + t4 * 2;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * kRow), ld32(qa + 8),
                             ld32(qa + 8 * kRow + 8)};
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const __nv_bfloat16* kb = Ks + (nt * 8 + g) * kRow + kk * 16 + t4 * 2;
        mma_bf16(sc[nt], a, ld32(kb), ld32(kb + 8));
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qpos = row0 + (j >> 1) * 8;
        const int kpos = kv0 + nt * 8 + t4 * 2 + (j & 1);
        const float x = visible(qpos, kpos, P.s, P.window) ? sc[nt][j] * P.scale : kNegInf;
        sc[nt][j] = x;
        mx[j >> 1] = fmaxf(mx[j >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {   // a row lives in the 4 threads of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(sc[nt][j] - m[j >> 1]);
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
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // the score fragments of keys 16kk .. 16kk+15, rounded to bf16, are the
      // A fragment of the p v product
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const __nv_bfloat16* vb = Vt + (nt * 8 + g) * kVRow + kk * 16 + t4 * 2;
        mma_bf16(o[nt], a, ld32(vb), ld32(vb + 8));
      }
    }
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

template <int D>
cudaError_t launch(int dtype, int b, const Params& P, cudaStream_t stream) {
  if (dtype == 1) {
    const size_t smem = mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(swa_mma_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid((P.s + kBQ - 1) / kBQ, b * P.h);
    swa_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(P);
  } else {
    const size_t smem = simt_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(swa_simt_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
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
