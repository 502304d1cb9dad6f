// The tiled Gram product out = r^T F (reducing over samples) and its ordered
// split sum, shared by score.cu (the score Gram S[c,e] = r_c^T F_e / n, all
// tiles) and gram.cu (G = S^T S / n, the same body with r = F = S, C = 1 and
// only the tiles on and above the diagonal).
//
// What bounds it on an H100: 2*n*p*p operations per channel pair against
// 4*(2*n*p + p*p) bytes (half the operand bytes in bfloat16), hundreds of
// operations per byte at the fit and kernels_bench shapes, so the FP32 FMA
// rate (67 TFLOP/s).
//
// Operands are float32 or bfloat16 (each of r and F its own type: the score
// kernel's bfloat16 path multiplies its float32 r by a bfloat16 F). Sums are
// float32 either way: a bfloat16 value converts to float32 exactly, and so
// does the product of two, so a bfloat16 call gives bitwise what a float32
// call on the float32 upcasts of its operands gives.
//
// Design: a classic SGEMM schedule in plain float32 FMA (TF32 fails the
// float32 gates). A 128 x 128 output tile per block of 256 threads, 8 x 8
// outputs per thread (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
// likewise with tx), read from shared memory four at a time. Sample slabs of
// 16 rows of both operands pass through two shared buffers in the operands'
// own types (converted to float32 where they are read), the next slab
// copied by cp.async while this one is used, one __syncthreads per slab.
// Each operand is copied in units of W elements (the copy width the wrapper
// picks): 16 bytes where rows and base allow it (float32 p % 4 == 0,
// bfloat16 p % 8 == 0, 16-byte base), 4 bytes where they do not (a
// bfloat16 pair needs an even p and a 4-byte base), and a plain load and
// store of a single bfloat16 otherwise (cp.async copies no 2-byte unit).
// Out-of-range samples and columns are zero-filled by the copy, so ragged
// edges need no other masking.
//
// Symmetric mode (gram): blockIdx.x walks the upper triangle of tiles row
// by row and an off-diagonal tile is written to both (i, j) and (j, i), so
// G is bitwise symmetric. Samples are split across blocks when the output has few tiles
// (a function of the shape alone, chosen by the wrapper); each split writes
// its own partial and gram_reduce_kernel sums the splits in split order, so
// a call repeats bitwise without atomics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// Operand type codes of the C entries (newton.cu's codes; float64 is not an
// operand type of the score, logits and Gram kernels).
enum Dtype { kFloat32 = 0, kBFloat16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// A float32 result in the output type: rounded once, to nearest even.
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

constexpr int kGramTile = 128;     // output tile edge (rows and columns)
constexpr int kGramSlab = 16;      // samples per pipeline stage
constexpr int kGramStages = 2;     // cp.async ring depth
constexpr int kGramThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// W elements of T from gmem to smem, zeros when !pred: cp.async for a 16- or
// 4-byte unit, a plain load and store for a single bfloat16.
template <typename T, int W>
__device__ __forceinline__ void copy_elems(T* smem, const T* gmem, bool pred) {
  constexpr int kBytes = W * (int)sizeof(T);
  static_assert(kBytes == 16 || kBytes == 4 || kBytes == 2, "a 16-, 4- or 2-byte unit");
  if constexpr (kBytes == 16) {
    cp_async16(smem, gmem, pred);
  } else if constexpr (kBytes == 4) {
    cp_async4(smem, gmem, pred);
  } else {
    *smem = pred ? *gmem : zero_of<T>();
  }
}

// Four consecutive shared-memory elements (a 4-aligned column) as float32.
__device__ __forceinline__ void ld4(const float* s, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(s);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* s, float* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(s);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// Row and column tile of output tile t: the upper triangle row by row
// (symmetric) or all tiles row by row.
__device__ __forceinline__ void gram_tile_of(int t, int tiles, bool symmetric, int& ti,
                                             int& tj) {
  if (!symmetric) {
    ti = t / tiles;
    tj = t % tiles;
    return;
  }
  ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  tj = ti + t;
}

// Store one thread's 8 x 8 outputs (divided by n when divide) and, for an
// off-diagonal symmetric tile, their transpose.
template <bool VEC>
__device__ __forceinline__ void gram_store(float* o, const float (&acc)[8][8], int i0, int j0,
                                           int ty, int tx, int p, float n_f, bool divide,
                                           bool mirror) {
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + (a < 4 ? ty * 4 + a : 64 + ty * 4 + a - 4);
    if (i >= p) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) v[b] = divide ? acc[a][h * 4 + b] / n_f : acc[a][h * 4 + b];
      if (VEC && j + 3 < p) {
        *reinterpret_cast<float4*>(o + (size_t)i * p + j) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (j + b < p) o[(size_t)i * p + j + b] = v[b];
      }
    }
  }
  if (!mirror) return;
  // out[j, i] = out[i, j]: four rows i are contiguous along a row j
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const int j = j0 + (b < 4 ? tx * 4 + b : 64 + tx * 4 + b - 4);
    if (j >= p) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + h * 64 + ty * 4;
      float v[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) v[a] = divide ? acc[h * 4 + a][b] / n_f : acc[h * 4 + a][b];
      if (VEC && i + 3 < p) {
        *reinterpret_cast<float4*>(o + (size_t)j * p + i) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (i + a < p) o[(size_t)j * p + i + a] = v[a];
      }
    }
  }
}

// One slab of 16 samples of an operand's 128 columns c0 .. c0 + 127, in
// copies of W elements (p % W == 0 and the base aligned to the copy, so a
// copy is in range whole or not at all).
template <typename T, int W>
__device__ __forceinline__ void gram_stage(T (*dst)[kGramTile], const T* src, int sb, int s_end,
                                           int c0, int p, int tid) {
  constexpr int kPerRow = kGramTile / W;
#pragma unroll
  for (int q = 0; q < kGramSlab * kPerRow / kGramThreads; ++q) {
    const int idx = tid + q * kGramThreads;
    const int row = idx / kPerRow, col = (idx % kPerRow) * W;
    const int s = sb + row;
    const bool s_ok = s < s_end;
    const size_t off = (size_t)(s_ok ? s : 0) * p;
    copy_elems<T, W>(&dst[row][col], src + off + (c0 + col < p ? c0 + col : 0),
                     s_ok && c0 + col < p);
  }
}

// out[split, c, e, i, j] = sum over this split's samples of r[c, s, i] F[e, s, j],
// divided by n when there is a single split (scale_out). r is TA, copied WA
// elements at a time, F is TB, WB at a time; the outputs are stored as
// float4s where r's copies are 16 bytes (p % 4 == 0).
template <typename TA, typename TB, int WA, int WB, bool SYM>
__global__ void __launch_bounds__(kGramThreads, 2)
gram_tile_kernel(const TA* __restrict__ r, const TB* __restrict__ F,
                 float* __restrict__ out, int C, int n, int p, int tiles, int chunk,
                 float n_f, int scale_out) {
  constexpr bool kVecStore = WA * sizeof(TA) == 16;
  __shared__ __align__(16) TA As[kGramStages][kGramSlab][kGramTile];   // r slab (s, i)
  __shared__ __align__(16) TB Bs[kGramStages][kGramSlab][kGramTile];   // F slab (s, j)
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  int ti, tj;
  gram_tile_of(blockIdx.x, tiles, SYM, ti, tj);
  const int i0 = ti * kGramTile, j0 = tj * kGramTile;
  const int ce = blockIdx.y, split = blockIdx.z;
  const int c = ce / C, e = ce % C;
  const size_t np = (size_t)n * p;
  const TA* rc = r + c * np;
  const TB* Fe = F + e * np;
  const int s_begin = split * chunk, s_end = min(n, s_begin + chunk);
  const int slabs = (s_end - s_begin + kGramSlab - 1) / kGramSlab;

  auto load = [&](int slab, int stage) {
    const int sb = s_begin + slab * kGramSlab;
    gram_stage<TA, WA>(As[stage], rc, sb, s_end, i0, p, tid);
    gram_stage<TB, WB>(Bs[stage], Fe, sb, s_end, j0, p, tid);
  };

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;

#pragma unroll
  for (int st = 0; st < kGramStages - 1; ++st) {
    if (st < slabs) load(st, st);
    cp_async_commit();
  }
  for (int k = 0; k < slabs; ++k) {
    cp_async_wait<kGramStages - 2>();
    __syncthreads();   // slab k landed for all; slab k - 1's buffer is free
    if (k + kGramStages - 1 < slabs) load(k + kGramStages - 1, (k + kGramStages - 1) % kGramStages);
    cp_async_commit();
    const int st = k % kGramStages;
#pragma unroll
    for (int kk = 0; kk < kGramSlab; ++kk) {
      float av[8], bv[8];
      ld4(&As[st][kk][ty * 4], av);
      ld4(&As[st][kk][64 + ty * 4], av + 4);
      ld4(&Bs[st][kk][tx * 4], bv);
      ld4(&Bs[st][kk][64 + tx * 4], bv + 4);
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }
  cp_async_wait<0>();

  const size_t pp = (size_t)p * p;
  float* o = out + ((size_t)split * C * C + ce) * pp;
  gram_store<kVecStore>(o, acc, i0, j0, ty, tx, p, n_f, scale_out != 0, SYM && ti != tj);
}

// S = (sum over splits, in split order) / n.
__global__ void gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ S,
                                   long long total, int splits, float n_f) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float sum = 0.0f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * total + idx];
  S[idx] = sum / n_f;
}

// Output tiles the Gram product launches: the upper triangle (symmetric) or all.
inline int gram_tile_count(int p, bool symmetric) {
  const int t = (p + kGramTile - 1) / kGramTile;
  return symmetric ? t * (t + 1) / 2 : t * t;
}

// The Gram product and, with splits > 1, its ordered sum into S.
// partial holds splits*C*C*p*p floats when splits > 1 (unused otherwise).
// wa, wb: the copy widths of r and F in elements; the pairs instantiated are
// float32 (4, 4) and (1, 1), a float32 r with a bfloat16 F (4, 8), (1, 2)
// and (1, 1), and bfloat16 (8, 8), (2, 2) and (1, 1). Any other pair is
// refused with cudaErrorInvalidValue.
template <bool SYM, typename TA, typename TB, int WA, int WB>
cudaError_t launch_gram_tiles(const TA* r, const TB* F, float* out, int C, int n, int p,
                              int splits, int chunk, cudaStream_t stream) {
  const int tiles = (p + kGramTile - 1) / kGramTile;
  dim3 grid(gram_tile_count(p, SYM), C * C, splits);
  gram_tile_kernel<TA, TB, WA, WB, SYM><<<grid, kGramThreads, 0, stream>>>(
      r, F, out, C, n, p, tiles, chunk, static_cast<float>(n), splits == 1);
  return cudaGetLastError();
}

template <bool SYM, typename TA, typename TB>
cudaError_t launch_gram(const TA* r, const TB* F, float* partial, float* S, int C, int n, int p,
                        int splits, int chunk, int wa, int wb, cudaStream_t stream) {
  float* out = splits == 1 ? S : partial;
  constexpr bool kA32 = std::is_same<TA, float>::value, kB32 = std::is_same<TB, float>::value;
  const int w = wa * 16 + wb;
  cudaError_t err = cudaErrorInvalidValue;
  if constexpr (kA32 && kB32) {
    if (w == 4 * 16 + 4)
      err = launch_gram_tiles<SYM, TA, TB, 4, 4>(r, F, out, C, n, p, splits, chunk, stream);
    else if (w == 1 * 16 + 1)
      err = launch_gram_tiles<SYM, TA, TB, 1, 1>(r, F, out, C, n, p, splits, chunk, stream);
  } else if constexpr (kA32) {
    if (w == 4 * 16 + 8)
      err = launch_gram_tiles<SYM, TA, TB, 4, 8>(r, F, out, C, n, p, splits, chunk, stream);
    else if (w == 1 * 16 + 2)
      err = launch_gram_tiles<SYM, TA, TB, 1, 2>(r, F, out, C, n, p, splits, chunk, stream);
    else if (w == 1 * 16 + 1)
      err = launch_gram_tiles<SYM, TA, TB, 1, 1>(r, F, out, C, n, p, splits, chunk, stream);
  } else {
    if (w == 8 * 16 + 8)
      err = launch_gram_tiles<SYM, TA, TB, 8, 8>(r, F, out, C, n, p, splits, chunk, stream);
    else if (w == 2 * 16 + 2)
      err = launch_gram_tiles<SYM, TA, TB, 2, 2>(r, F, out, C, n, p, splits, chunk, stream);
    else if (w == 1 * 16 + 1)
      err = launch_gram_tiles<SYM, TA, TB, 1, 1>(r, F, out, C, n, p, splits, chunk, stream);
  }
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)C * C * p * p;
  const int threads = 256;
  gram_reduce_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                       stream>>>(partial, S, total, splits, static_cast<float>(n));
  return cudaGetLastError();
}

}  // namespace
