// The tiled Gram product out = r^T F (reducing over samples) and its ordered
// split sum, shared by score.cu (the score Gram S[c,e] = r_c^T F_e / n, all
// tiles) and gram.cu (G = S^T S / n, the same body with r = F = S, C = 1 and
// only the tiles on and above the diagonal).
//
// What bounds it on an H100: 2*n*p*p float32 operations per channel pair
// against 4*(2*n*p + p*p) bytes, hundreds of operations per byte at the fit
// and kernels_bench shapes, so the FP32 FMA rate (67 TFLOP/s).
//
// Design: a classic SGEMM schedule in plain float32 FMA (TF32 fails the
// float32 gates). A 128 x 128 output tile per block of 256 threads, 8 x 8
// outputs per thread (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
// likewise with tx), read from shared memory as float4s. Sample slabs of 16
// rows of both operands pass through two shared buffers, the next slab
// copied by cp.async while this one is used, one __syncthreads per slab.
// Where p % 4 == 0 and the operands are 16-byte aligned each thread copies
// float4s; otherwise 4-byte copies. Out-of-range samples and columns are
// zero-filled by the copy (src-size 0), so ragged edges need no other masking.
//
// Symmetric mode (gram): blockIdx.x walks the upper triangle of tiles row
// by row and an off-diagonal tile is written to both (i, j) and (j, i), so
// G is bitwise symmetric. Samples are split across blocks when the output has few tiles
// (a function of the shape alone, chosen by the wrapper); each split writes
// its own partial and gram_reduce_kernel sums the splits in split order, so
// a call repeats bitwise without atomics.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kGramTile = 128;     // output tile edge (rows and columns)
constexpr int kGramSlab = 16;      // samples per pipeline stage
constexpr int kGramStages = 2;     // cp.async ring depth
constexpr int kGramThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool pred) {
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

// out[split, c, e, i, j] = sum over this split's samples of r[c, s, i] F[e, s, j],
// divided by n when there is a single split (scale_out).
template <bool VEC, bool SYM>
__global__ void __launch_bounds__(kGramThreads, 2)
gram_tile_kernel(const float* __restrict__ r, const float* __restrict__ F,
                 float* __restrict__ out, int C, int n, int p, int tiles, int chunk,
                 float n_f, int scale_out) {
  __shared__ __align__(16) float As[kGramStages][kGramSlab][kGramTile];   // r slab (s, i)
  __shared__ __align__(16) float Bs[kGramStages][kGramSlab][kGramTile];   // F slab (s, j)
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  int ti, tj;
  gram_tile_of(blockIdx.x, tiles, SYM, ti, tj);
  const int i0 = ti * kGramTile, j0 = tj * kGramTile;
  const int ce = blockIdx.y, split = blockIdx.z;
  const int c = ce / C, e = ce % C;
  const size_t np = (size_t)n * p;
  const float* rc = r + c * np;
  const float* Fe = F + e * np;
  const int s_begin = split * chunk, s_end = min(n, s_begin + chunk);
  const int slabs = (s_end - s_begin + kGramSlab - 1) / kGramSlab;

  auto load = [&](int slab, int stage) {
    const int sb = s_begin + slab * kGramSlab;
    if (VEC) {
#pragma unroll
      for (int q = 0; q < kGramSlab * kGramTile / (4 * kGramThreads); ++q) {
        const int idx = tid + q * kGramThreads;
        const int row = idx / 32, col = (idx % 32) * 4;
        const int s = sb + row;
        const bool s_ok = s < s_end;
        const size_t off = (size_t)(s_ok ? s : 0) * p;
        cp_async16(&As[stage][row][col], rc + off + (i0 + col < p ? i0 + col : 0),
                   s_ok && i0 + col < p);
        cp_async16(&Bs[stage][row][col], Fe + off + (j0 + col < p ? j0 + col : 0),
                   s_ok && j0 + col < p);
      }
    } else {
#pragma unroll
      for (int q = 0; q < kGramSlab * kGramTile / kGramThreads; ++q) {
        const int idx = tid + q * kGramThreads;
        const int row = idx / kGramTile, col = idx % kGramTile;
        const int s = sb + row;
        const bool s_ok = s < s_end;
        const size_t off = (size_t)(s_ok ? s : 0) * p;
        cp_async4(&As[stage][row][col], rc + off + (i0 + col < p ? i0 + col : 0),
                  s_ok && i0 + col < p);
        cp_async4(&Bs[stage][row][col], Fe + off + (j0 + col < p ? j0 + col : 0),
                  s_ok && j0 + col < p);
      }
    }
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
      const float4 a0 = *reinterpret_cast<const float4*>(&As[st][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[st][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[st][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[st][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }
  cp_async_wait<0>();

  const size_t pp = (size_t)p * p;
  float* o = out + ((size_t)split * C * C + ce) * pp;
  gram_store<VEC>(o, acc, i0, j0, ty, tx, p, n_f, scale_out != 0, SYM && ti != tj);
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
// vec: p % 4 == 0 and r, F 16-byte aligned (float4 copies and stores).
template <bool SYM>
cudaError_t launch_gram(const float* r, const float* F, float* partial, float* S, int C,
                        int n, int p, int splits, int chunk, int vec, cudaStream_t stream) {
  const int tiles = (p + kGramTile - 1) / kGramTile;
  dim3 grid(gram_tile_count(p, SYM), C * C, splits);
  float* out = splits == 1 ? S : partial;
  const float n_f = static_cast<float>(n);
  if (vec)
    gram_tile_kernel<true, SYM><<<grid, kGramThreads, 0, stream>>>(r, F, out, C, n, p, tiles,
                                                                  chunk, n_f, splits == 1);
  else
    gram_tile_kernel<false, SYM><<<grid, kGramThreads, 0, stream>>>(r, F, out, C, n, p, tiles,
                                                                   chunk, n_f, splits == 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)C * C * p * p;
  const int threads = 256;
  gram_reduce_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                       stream>>>(partial, S, total, splits, n_f);
  return cudaGetLastError();
}

}  // namespace
