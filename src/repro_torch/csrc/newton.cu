// Bucket Newton statistics for the degree-bucketed local CL fits.
//
// Replaces the TPU kernel src/repro/kernels/cl/newton.py::bucket_newton_stats
// (Pallas body _newton_kernel). For every node a of a degree bucket:
//
//   eta[c, s] = base[a, c, s] + sum_j W[a, j*C + c] * Z[a, c, j, s]
//   r, kappa  = family epilogue at (eta, xi[a, s])        (times sw if weighted)
//   g[a, (j,c)]         = sum_s Z[a, c, j, s] r[c, s]
//   K[a, (j,c), (f,e)]  = sum_s Z[a, c, j, s] kappa[c, e, s] Z[a, e, f, s]
//
// with the coordinate-major flat layout [(d0,c0), (d0,c1), ..., (d1,c0), ...].
//
// What bounds it on an H100: d*C is tiny (2 to 65*C) and n is long, so each
// node is one long reduction over samples with a few FLOPs per design byte;
// the kernel is bound by reading Z (k*C*d*n values) from device memory.
//
// Design: the TPU grid (node, sample tile) ran in order on one core and carried
// g and K in its output block. Here blocks run in any order, so the grid is
// (node x sample split), with enough splits that a bucket of a few nodes still
// covers the SMs. A block walks its sample range in tiles staged in shared
// memory (coalesced along the contiguous sample axis), computes eta, r and
// kappa for the tile, and accumulates its share of g and the upper triangle of
// K in float32. Each output entry is split over "lanes" of threads when there
// are fewer entries than threads. Per-split partials go to a float32 scratch
// that a second kernel sums in a fixed order: the result is deterministic, with
// no float atomics. Epilogue kind, input type and weighting are template
// parameters, as they were trace-time constants in Pallas. There is no lane
// padding of the d*C axis (that was for the TPU's 128-wide registers).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

enum Kind { kIsing = 0, kGaussian = 1, kPotts = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<double>(double v) {
  return static_cast<float>(v);
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// Upper-triangle entry t (row-major over a <= b) of a dC x dC matrix.
__device__ __forceinline__ int tri_row_start(int row, int dC) {
  return row * dC - row * (row - 1) / 2;
}

__device__ __forceinline__ void tri_decode(int t, int dC, int* a, int* b) {
  // closed-form guess, then exact integer correction of float rounding
  const float D = 2.0f * dC + 1.0f;
  int row = static_cast<int>(floorf(0.5f * (D - sqrtf(D * D - 8.0f * t))));
  row = max(0, min(row, dC - 1));
  while (row > 0 && tri_row_start(row, dC) > t) --row;
  while (row + 1 < dC && tri_row_start(row + 1, dC) <= t) ++row;
  *a = row;
  *b = row + (t - tri_row_start(row, dC));
}

template <int KIND, typename T, bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
newton_partial_kernel(const T* __restrict__ Z, const T* __restrict__ base,
                      const T* __restrict__ xi, const float* __restrict__ W,
                      const T* __restrict__ sw, float* __restrict__ partial,
                      int k, int C, int d, int n, int splits, int tn) {
  extern __shared__ float smem[];
  const int node = blockIdx.x / splits;
  const int split = blockIdx.x % splits;
  const int dC = d * C;
  const int E = dC + dC * (dC + 1) / 2;           // g entries + upper K
  const int lanes = E >= kThreads ? 1 : kThreads / E;
  const int nslots = E * lanes;
  const int stride = tn + 1;                      // pad: rows fall on other banks

  float* Zs = smem;                               // (C*d, stride)
  float* eta_s = Zs + C * d * stride;             // (C, stride)
  float* r_s = eta_s + C * stride;                // (C, stride)
  float* k_s = r_s + C * stride;                  // (C*C, stride)
  float* x_s = k_s + C * C * stride;              // (stride)
  float* W_s = x_s + stride;                      // (dC)
  float* acc = W_s + dC;                          // (nslots)

  const int tid = threadIdx.x;
  for (int i = tid; i < dC; i += kThreads) W_s[i] = W[(size_t)node * dC + i];
  for (int i = tid; i < nslots; i += kThreads) acc[i] = 0.0f;

  int chunk = (n + splits - 1) / splits;
  chunk = ((chunk + tn - 1) / tn) * tn;
  const int s_begin = split * chunk;
  const int s_end = min(n, s_begin + chunk);

  const T* Zn = Z + (size_t)node * C * d * n;
  const T* bn = base + (size_t)node * C * n;
  const T* xn = xi + (size_t)node * n;
  const T* wn = WEIGHTED ? sw + (size_t)node * n : nullptr;

  for (int s0 = s_begin; s0 < s_end; s0 += tn) {
    const int len = min(tn, s_end - s0);
    __syncthreads();                              // previous tile fully consumed
    for (int idx = tid; idx < C * d * tn; idx += kThreads) {
      const int row = idx / tn, t = idx % tn;
      Zs[row * stride + t] = t < len ? to_f32(Zn[(size_t)row * n + s0 + t]) : 0.0f;
    }
    for (int t = tid; t < tn; t += kThreads) x_s[t] = t < len ? to_f32(xn[s0 + t]) : 0.0f;
    __syncthreads();
    for (int idx = tid; idx < C * tn; idx += kThreads) {
      const int c = idx / tn, t = idx % tn;
      float e = t < len ? to_f32(bn[(size_t)c * n + s0 + t]) : 0.0f;
      for (int j = 0; j < d; ++j) e += W_s[j * C + c] * Zs[(c * d + j) * stride + t];
      eta_s[c * stride + t] = e;
    }
    __syncthreads();
    for (int t = tid; t < tn; t += kThreads) {
      const bool live = t < len;
      const float x = x_s[t];
      const float w = (WEIGHTED && live) ? to_f32(wn[s0 + t]) : 1.0f;
      if (KIND == kIsing) {
        const float r = 2.0f * x * sigmoidf(-2.0f * x * eta_s[t]);
        const float kap = r * (2.0f * x - r);
        r_s[t] = live ? r * w : 0.0f;
        k_s[t] = live ? kap * w : 0.0f;
      } else if (KIND == kGaussian) {
        r_s[t] = live ? (x - eta_s[t]) * w : 0.0f;
        k_s[t] = live ? w : 0.0f;
      } else {
        // softmax over [0, eta_0 .. eta_{C-1}]: the reference state's logit is 0
        float m = 0.0f;
        for (int c = 0; c < C; ++c) m = fmaxf(m, eta_s[c * stride + t]);
        float den = expf(-m);
        for (int c = 0; c < C; ++c) den += expf(eta_s[c * stride + t] - m);
        for (int c = 0; c < C; ++c) {
          const float pc = expf(eta_s[c * stride + t] - m) / den;
          const float y = (x == static_cast<float>(c + 1)) ? 1.0f : 0.0f;
          r_s[c * stride + t] = live ? (y - pc) * w : 0.0f;
          for (int e = 0; e < C; ++e) {
            const float pe = expf(eta_s[e * stride + t] - m) / den;
            const float kap = (c == e) ? (pc - pc * pe) : (-pc * pe);
            k_s[(c * C + e) * stride + t] = live ? kap * w : 0.0f;
          }
        }
      }
    }
    __syncthreads();
    for (int slot = tid; slot < nslots; slot += kThreads) {
      const int ent = slot / lanes, lane = slot % lanes;
      float sum = 0.0f;
      if (ent < dC) {
        const int c = ent % C, j = ent / C;
        const float* z = Zs + (c * d + j) * stride;
        const float* r = r_s + c * stride;
        for (int t = lane; t < len; t += lanes) sum += z[t] * r[t];
      } else {
        int a, b;
        tri_decode(ent - dC, dC, &a, &b);
        const int ca = a % C, ja = a / C, cb = b % C, jb = b / C;
        const float* za = Zs + (ca * d + ja) * stride;
        const float* zb = Zs + (cb * d + jb) * stride;
        const float* kp = k_s + (ca * C + cb) * stride;
        for (int t = lane; t < len; t += lanes) sum += za[t] * kp[t] * zb[t];
      }
      acc[slot] += sum;
    }
  }
  __syncthreads();
  float* out = partial + ((size_t)split * k + node) * E;
  for (int ent = tid; ent < E; ent += kThreads) {
    float sum = 0.0f;
    for (int l = 0; l < lanes; ++l) sum += acc[ent * lanes + l];
    out[ent] = sum;
  }
}

// Sums the per-split partials in split order and scatters them to g and K.
__global__ void newton_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ g, float* __restrict__ K,
                                     int k, int dC, int splits) {
  const int E = dC + dC * (dC + 1) / 2;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)k * E) return;
  const int node = static_cast<int>(idx / E), ent = static_cast<int>(idx % E);
  float sum = 0.0f;
  for (int s = 0; s < splits; ++s) sum += partial[((size_t)s * k + node) * E + ent];
  if (ent < dC) {
    g[(size_t)node * dC + ent] = sum;
  } else {
    int a, b;
    tri_decode(ent - dC, dC, &a, &b);
    float* Kn = K + (size_t)node * dC * dC;
    Kn[(size_t)a * dC + b] = sum;
    Kn[(size_t)b * dC + a] = sum;
  }
}

template <int KIND, typename T, bool WEIGHTED>
cudaError_t launch_partial(const void* Z, const void* base, const void* xi, const float* W,
                           const void* sw, float* partial, int k, int C, int d, int n,
                           int splits, int tn, size_t smem, cudaStream_t stream) {
  auto kern = newton_partial_kernel<KIND, T, WEIGHTED>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<k * splits, kThreads, smem, stream>>>(
      static_cast<const T*>(Z), static_cast<const T*>(base), static_cast<const T*>(xi), W,
      static_cast<const T*>(sw), partial, k, C, d, n, splits, tn);
  return cudaGetLastError();
}

template <int KIND, typename T>
cudaError_t dispatch_weighted(int weighted, const void* Z, const void* base, const void* xi,
                              const float* W, const void* sw, float* partial, int k, int C,
                              int d, int n, int splits, int tn, size_t smem,
                              cudaStream_t stream) {
  if (weighted)
    return launch_partial<KIND, T, true>(Z, base, xi, W, sw, partial, k, C, d, n, splits, tn,
                                         smem, stream);
  return launch_partial<KIND, T, false>(Z, base, xi, W, sw, partial, k, C, d, n, splits, tn,
                                        smem, stream);
}

template <int KIND>
cudaError_t dispatch_dtype(int dtype, int weighted, const void* Z, const void* base,
                           const void* xi, const float* W, const void* sw, float* partial,
                           int k, int C, int d, int n, int splits, int tn, size_t smem,
                           cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return dispatch_weighted<KIND, float>(weighted, Z, base, xi, W, sw, partial, k, C, d, n,
                                            splits, tn, smem, stream);
    case 1:
      return dispatch_weighted<KIND, double>(weighted, Z, base, xi, W, sw, partial, k, C, d,
                                             n, splits, tn, smem, stream);
    case 2:
      return dispatch_weighted<KIND, __nv_bfloat16>(weighted, Z, base, xi, W, sw, partial, k,
                                                    C, d, n, splits, tn, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared-memory bytes one block of the partial kernel needs.
size_t repro_newton_smem_bytes(int C, int d, int tn) {
  const int dC = d * C;
  const int E = dC + dC * (dC + 1) / 2;
  const int nslots = E >= kThreads ? E : (kThreads / E) * E;
  const int stride = tn + 1;
  const size_t floats = (size_t)C * d * stride + 2 * (size_t)C * stride +
                        (size_t)C * C * stride + stride + dC + nslots;
  return floats * sizeof(float);
}

// kind: 0 ising, 1 gaussian, 2 potts. dtype of Z/base/xi/sw: 0 float32,
// 1 float64, 2 bfloat16. W is float32. partial holds splits*k*E floats.
// Returns a cudaError_t (0 on success).
int repro_newton_stats(int kind, int dtype, int weighted, const void* Z, const void* base,
                       const void* xi, const float* W, const void* sw, float* partial,
                       float* g, float* K, int k, int C, int d, int n, int splits, int tn,
                       void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (k <= 0 || C <= 0 || d <= 0 || n <= 0 || splits <= 0 || tn <= 0)
    return cudaErrorInvalidValue;
  if ((kind == kIsing || kind == kGaussian) && C != 1) return cudaErrorInvalidValue;
  const size_t smem = repro_newton_smem_bytes(C, d, tn);
  cudaError_t err;
  switch (kind) {
    case kIsing:
      err = dispatch_dtype<kIsing>(dtype, weighted, Z, base, xi, W, sw, partial, k, C, d, n,
                                   splits, tn, smem, stream);
      break;
    case kGaussian:
      err = dispatch_dtype<kGaussian>(dtype, weighted, Z, base, xi, W, sw, partial, k, C, d,
                                      n, splits, tn, smem, stream);
      break;
    case kPotts:
      err = dispatch_dtype<kPotts>(dtype, weighted, Z, base, xi, W, sw, partial, k, C, d, n,
                                   splits, tn, smem, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int dC = d * C;
  const long long total = (long long)k * (dC + dC * (dC + 1) / 2);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  newton_reduce_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(partial, g, K, k,
                                                                              dC, splits);
  return cudaGetLastError();
}

}  // extern "C"
