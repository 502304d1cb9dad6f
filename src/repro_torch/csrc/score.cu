// Fused channelized score statistics of the pseudo-likelihood.
//
// Replaces the TPU kernel src/repro/kernels/cl/kernel.py::cl_score_channels,
// both of its Pallas bodies: _score_kernel_c1 (C = 1) and _score_kernel (C > 1).
// For F (C, n, p), Theta (C, p, p), mask A (p, p) and bias b (C, p):
//
//   eta[c, s, i] = sum_j F[c, s, j] Theta[c, j, i] A[j, i] + b[c, i]
//   r[:, s, i]   = family residual at (F[:, s, i], eta[:, s, i])   (all C at once)
//   S[c, e, i, j] = sum_s r[c, s, i] F[e, s, j] / n
//
// What bounds it on an H100: two dense float32 products of 2*C*n*p*p and
// 2*C*C*n*p*p operations, far above the card's operations-per-byte ridge at
// the sizes the fit path uses, so the bound is the float32 FMA rate.
//
// Design: the TPU kernel kept a (bm, p) feature strip in VMEM so one pass
// gave eta, r and S. At p in the thousands that strip does not fit in a
// block's 227 KB of shared memory, so the work is two kernels:
//  (a) a tiled masked product over (sample tile, node tile) output blocks.
//      Theta*A is formed on the tile in shared memory and never written to
//      device memory. All C channels of a tile live in one block, so the
//      epilogue sees every channel of a node (the Potts softmax needs them).
//      It adds the bias, applies the residual and writes eta and r.
//  (b) a tiled product S[c,e] = r_c^T F_e reducing over samples. Samples are
//      split across blocks when the output has few tiles (at p = 100 it is a
//      handful), and a third small kernel sums the splits in a fixed order,
//      so the result is deterministic without float atomics.
// Both use plain float32 FMA, not TF32: the float32 parity gates need it.
// Ragged edges of n and p are masked in the loads and stores.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output tile edge (rows and columns)
constexpr int kDepth = 16;    // reduction depth per shared-memory stage
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

enum Kind { kIsing = 0, kGaussian = 1, kPotts = 2 };

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

template <int KIND, int C>
__global__ void __launch_bounds__(kThreads)
logits_residual_kernel(const float* __restrict__ F, const float* __restrict__ theta,
                       const float* __restrict__ mask, const float* __restrict__ bias,
                       float* __restrict__ eta, float* __restrict__ r, int n, int p) {
  __shared__ float As[C][kDepth][kTile];   // F tile, stored (j, sample)
  __shared__ float Bs[C][kDepth][kTile];   // (Theta * A) tile, stored (j, node)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int s0 = blockIdx.x * kTile, i0 = blockIdx.y * kTile;
  const size_t np = (size_t)n * p;

  float acc[C][4][4];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[c][a][b] = 0.0f;

  for (int j0 = 0; j0 < p; j0 += kDepth) {
    for (int idx = threadIdx.x; idx < kTile * kDepth; idx += kThreads) {
      // A: consecutive threads walk j (contiguous in F); B: walk i (contiguous)
      const int am = idx / kDepth, ak = idx % kDepth;
      const int bk = idx / kTile, bn = idx % kTile;
      const int s = s0 + am, ja = j0 + ak;
      const int jb = j0 + bk, i = i0 + bn;
      const bool a_ok = s < n && ja < p;
      const bool b_ok = jb < p && i < p;
      const float mk = b_ok ? mask[(size_t)jb * p + i] : 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        As[c][ak][am] = a_ok ? F[c * np + (size_t)s * p + ja] : 0.0f;
        Bs[c][bk][bn] = b_ok ? theta[(size_t)c * p * p + (size_t)jb * p + i] * mk : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float av[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) av[a] = As[c][kk][ty + 16 * a];
#pragma unroll
        for (int b = 0; b < 4; ++b) bv[b] = Bs[c][kk][tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[c][a][b] = fmaf(av[a], bv[b], acc[c][a][b]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int s = s0 + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + tx + 16 * b;
      if (s >= n || i >= p) continue;
      const size_t off = (size_t)s * p + i;
      float e[C], y[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        e[c] = acc[c][a][b] + bias[c * p + i];
        y[c] = F[c * np + off];              // the node's own features: the target
        eta[c * np + off] = e[c];
      }
      if (KIND == kIsing) {
        r[off] = 2.0f * y[0] * sigmoidf(-2.0f * y[0] * e[0]);
      } else if (KIND == kGaussian) {
        r[off] = y[0] - e[0];
      } else {
        // softmax over [0, eta_0 .. eta_{C-1}]: the reference state's logit is 0
        float m = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) m = fmaxf(m, e[c]);
        float den = expf(-m);
#pragma unroll
        for (int c = 0; c < C; ++c) den += expf(e[c] - m);
#pragma unroll
        for (int c = 0; c < C; ++c) r[c * np + off] = y[c] - expf(e[c] - m) / den;
      }
    }
  }
}

// partial[split, c, e, i, j] = sum over this split's samples of
// r[c, s, i] F[e, s, j]; with scale_out (a single split) it writes S = that / n.
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

template <int KIND, int C>
cudaError_t launch_logits(const float* F, const float* theta, const float* mask,
                          const float* bias, float* eta, float* r, int n, int p,
                          cudaStream_t stream) {
  dim3 grid((n + kTile - 1) / kTile, (p + kTile - 1) / kTile);
  logits_residual_kernel<KIND, C><<<grid, kThreads, 0, stream>>>(F, theta, mask, bias, eta, r,
                                                                 n, p);
  return cudaGetLastError();
}

cudaError_t launch_potts(int C, const float* F, const float* theta, const float* mask,
                         const float* bias, float* eta, float* r, int n, int p,
                         cudaStream_t stream) {
  switch (C) {
    case 1: return launch_logits<kPotts, 1>(F, theta, mask, bias, eta, r, n, p, stream);
    case 2: return launch_logits<kPotts, 2>(F, theta, mask, bias, eta, r, n, p, stream);
    case 3: return launch_logits<kPotts, 3>(F, theta, mask, bias, eta, r, n, p, stream);
    case 4: return launch_logits<kPotts, 4>(F, theta, mask, bias, eta, r, n, p, stream);
    case 5: return launch_logits<kPotts, 5>(F, theta, mask, bias, eta, r, n, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Largest channel count the Potts instantiations cover: the static shared
// tiles of the logits kernel hold 2*C*16*64 floats, under 48 KB up to C = 5.
int repro_score_max_channels() { return 5; }

// kind: 0 ising, 1 gaussian, 2 potts. All tensors float32, contiguous.
// partial holds splits*C*C*p*p floats when splits > 1 (unused otherwise);
// chunk is the sample count per split. Returns a cudaError_t (0 on success).
int repro_score_channels(int kind, int C, const float* F, const float* theta,
                         const float* mask, const float* bias, float* eta, float* r,
                         float* partial, float* S, int n, int p, int splits, int chunk,
                         void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (n <= 0 || p <= 0 || C <= 0 || splits <= 0 || chunk <= 0) return cudaErrorInvalidValue;
  cudaError_t err;
  switch (kind) {
    case kIsing:
      if (C != 1) return cudaErrorInvalidValue;
      err = launch_logits<kIsing, 1>(F, theta, mask, bias, eta, r, n, p, stream);
      break;
    case kGaussian:
      if (C != 1) return cudaErrorInvalidValue;
      err = launch_logits<kGaussian, 1>(F, theta, mask, bias, eta, r, n, p, stream);
      break;
    case kPotts:
      err = launch_potts(C, F, theta, mask, bias, eta, r, n, p, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int tiles = (p + kTile - 1) / kTile;
  dim3 grid(tiles, tiles, C * C * splits);
  float* out = splits == 1 ? S : partial;
  score_gram_kernel<<<grid, kThreads, 0, stream>>>(r, F, out, C, n, p, chunk,
                                                   static_cast<float>(n), splits == 1);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)C * C * p * p;
  const int threads = 256;
  score_reduce_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                        stream>>>(partial, S, total, splits, static_cast<float>(n));
  return cudaGetLastError();
}

}  // extern "C"
