// The tiled Gram product out = r^T F (reducing over samples) and its ordered
// split sum, shared by score.cu (the score Gram S[c,e] = r_c^T F_e / n) and
// gram.cu (G = S^T S / n, the same body with r = F = S and C = 1).
//
// Plain float32 FMA on a 64 x 64 output tile, 16 x 16 threads with 4 x 4
// outputs each. Samples are split across blocks when the output has few
// tiles; each split writes its own partial and score_reduce_kernel sums the
// splits in split order, so the result is deterministic without atomics.
// Ragged edges of n and p are masked in the loads and stores.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output tile edge (rows and columns)
constexpr int kDepth = 16;    // reduction depth per shared-memory stage
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

// partial[split, c, e, i, j] = sum over this split's samples of
// r[c, s, i] F[e, s, j]; with scale_out (a single split) it writes that / n.
__global__ void __launch_bounds__(kThreads)
score_gram_kernel(const float* __restrict__ r, const float* __restrict__ F,
                  float* __restrict__ out, int C, int n, int p, int chunk, float n_f,
                  int scale_out) {
  __shared__ float As[kDepth][kTile];   // r tile, stored (sample, i)
  __shared__ float Bs[kDepth][kTile];   // F tile, stored (sample, j)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int ce = blockIdx.z % (C * C), split = blockIdx.z / (C * C);
  const int c = ce / C, e = ce % C;
  const size_t np = (size_t)n * p;
  const float* rc = r + c * np;
  const float* Fe = F + e * np;
  const int s_begin = split * chunk, s_end = min(n, s_begin + chunk);

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  for (int k0 = s_begin; k0 < s_end; k0 += kDepth) {
    for (int idx = threadIdx.x; idx < kTile * kDepth; idx += kThreads) {
      const int kk = idx / kTile, col = idx % kTile;
      const int s = k0 + kk;
      const bool s_ok = s < s_end;
      As[kk][col] = (s_ok && i0 + col < p) ? rc[(size_t)s * p + i0 + col] : 0.0f;
      Bs[kk][col] = (s_ok && j0 + col < p) ? Fe[(size_t)s * p + j0 + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = As[kk][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }

  const size_t pp = (size_t)p * p;
  float* o = out + ((size_t)split * C * C + ce) * pp;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx + 16 * b;
      if (i < p && j < p) o[(size_t)i * p + j] = scale_out ? acc[a][b] / n_f : acc[a][b];
    }
  }
}

// S = (sum over splits, in split order) / n.
__global__ void score_reduce_kernel(const float* __restrict__ partial, float* __restrict__ S,
                                    long long total, int splits, float n_f) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float sum = 0.0f;
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * total + idx];
  S[idx] = sum / n_f;
}

// The Gram product and, with splits > 1, its ordered sum into S.
// partial holds splits*C*C*p*p floats when splits > 1 (unused otherwise).
cudaError_t launch_gram(const float* r, const float* F, float* partial, float* S, int C,
                        int n, int p, int splits, int chunk, cudaStream_t stream) {
  const int tiles = (p + kTile - 1) / kTile;
  dim3 grid(tiles, tiles, C * C * splits);
  float* out = splits == 1 ? S : partial;
  score_gram_kernel<<<grid, kThreads, 0, stream>>>(r, F, out, C, n, p, chunk,
                                                   static_cast<float>(n), splits == 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)C * C * p * p;
  const int threads = 256;
  score_reduce_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                        stream>>>(partial, S, total, splits, static_cast<float>(n));
  return cudaGetLastError();
}

}  // namespace
