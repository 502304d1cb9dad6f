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
// What bounds it on an H100: d*C is small (2 to ~300) and n is long, so each
// node is one long reduction over samples with few operations per design
// byte; the least time is one read of Z, base, xi (and sw) from device
// memory. What keeps a kernel from that bound differs with the width, so
// there are two regimes, picked by the wrapper from (C, d) alone:
//
//  * narrow (C == 1, d <= 8; the field bucket is d = 5): register streaming.
//    The kernel is templated on d, so every thread keeps g and the upper
//    triangle of K (d + d(d+1)/2 floats) in registers, reads its samples'
//    Z, base, xi and sw straight from device memory as 16-byte vectors
//    (coalesced along the sample axis, d + 3 loads in flight), and computes
//    eta, r and kappa in registers: no shared-memory staging and no index
//    decoding. The block sums its threads with warp shuffles and then the
//    8 warps' partials in shared memory, in a fixed order.
//  * wide (anything else; Potts always): a register-tiled product
//    Z' diag(kappa) Z'^T over the upper triangle of 4 x 4 tiles, in a
//    channel-major padded row order (row (c, j) at c*dp + j, dp = d rounded
//    up to 4, so a row tile lies in one channel). Each thread owns one tile,
//    fixed at launch; g rides along as one extra column tile whose B
//    operand is r. Sample tiles of the raw inputs come through a two-stage
//    cp.async ring (16-byte copies where rows are aligned); per tile the
//    block computes eta, r, kappa once, writes A = Z' and B_c = kappa[c, .] Z'
//    (kappa applied once) to shared memory sample-major, and each thread
//    accumulates 16 products per sample from two float4 loads. When a
//    bucket has fewer tiles than threads, "lanes" of threads share a tile
//    and take every lanes-th sample, summed in lane order at the end; more
//    tiles than threads go to tile groups (a grid dimension).
//
// The TPU grid (node, sample tile) ran in order on one core and carried g
// and K in its output block. Here blocks run in any order, so a bucket of
// few nodes is cut into sample splits (the wrapper picks them from the
// shape so that k * splits reaches four blocks per SM of the 132, where the
// samples allow). With one split a block writes g and K itself; with more,
// per-split partials go to a float32 scratch that a second kernel sums in
// split order (8 lanes per output, then a fixed shuffle tree). The result is bitwise deterministic for a
// shape, with no float atomics. Epilogue kind and input type are template
// parameters; sample weights are a null-or-not pointer.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNarrowMaxD = 8;     // narrow regime: C == 1 and d <= 8
constexpr int kReduceLanes = 8;    // partial sums per output of the reduce kernel
constexpr size_t kWideSmemSoft = 113 * 1024;   // two blocks per SM
constexpr size_t kWideSmemMax = 232448;        // one block per SM (sm_90)

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

// 16 bytes of T at an aligned address, as floats.
template <typename T> __device__ __forceinline__ void load_vec(const T* p, float* out);
template <> __device__ __forceinline__ void load_vec<float>(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
template <> __device__ __forceinline__ void load_vec<double>(const double* p, float* out) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  out[0] = static_cast<float>(v.x);
  out[1] = static_cast<float>(v.y);
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16>(const __nv_bfloat16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The 16 / sizeof(T) samples of row at s (zero past s_end).
template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, int s, int s_end, bool vec_ok,
                                           float* out) {
  constexpr int V = 16 / sizeof(T);
  if (vec_ok && s + V <= s_end) {
    load_vec<T>(row + s, out);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = s + v < s_end ? to_f32(row[s + v]) : 0.0f;
  }
}

// Single-channel epilogue: residual and curvature at logit eta, target x.
template <int KIND>
__device__ __forceinline__ void epilogue1(float eta, float x, float* r, float* kap) {
  if (KIND == kIsing) {
    const float rr = 2.0f * x * sigmoidf(-2.0f * x * eta);
    *r = rr;
    *kap = rr * (2.0f * x - rr);
  } else if (KIND == kGaussian) {
    *r = x - eta;
    *kap = 1.0f;
  } else {   // softmax over [0, eta]: the reference state's logit is 0
    const float m = fmaxf(0.0f, eta);
    const float ez = expf(eta - m);
    const float p = ez / (expf(-m) + ez);
    *r = (x == 1.0f ? 1.0f : 0.0f) - p;
    *kap = p - p * p;
  }
}

// ------------------------------------------------------------------ narrow
template <int D>
__device__ __forceinline__ constexpr int tri_index(int a, int b) {   // a <= b
  return D + a * D - a * (a - 1) / 2 + (b - a);
}

template <int KIND, typename T, int D>
__global__ void __launch_bounds__(kThreads)
newton_narrow_kernel(const T* __restrict__ Z, const T* __restrict__ base,
                     const T* __restrict__ xi, const float* __restrict__ W,
                     const T* __restrict__ sw, float* __restrict__ partial,
                     float* __restrict__ g, float* __restrict__ K, int k, int n, int splits,
                     int chunk, int vec_ok) {
  constexpr int V = 16 / sizeof(T);
  constexpr int E = D + D * (D + 1) / 2;
  __shared__ float red[kThreads / 32][E];
  __shared__ float tot[E];
  const int node = blockIdx.x / splits;
  const int split = blockIdx.x % splits;
  const int s_begin = split * chunk;
  const int s_end = min(n, s_begin + chunk);
  const T* Zn = Z + (size_t)node * D * n;
  const T* bn = base + (size_t)node * n;
  const T* xn = xi + (size_t)node * n;
  const T* wn = sw != nullptr ? sw + (size_t)node * n : nullptr;

  float w[D];
#pragma unroll
  for (int j = 0; j < D; ++j) w[j] = W[(size_t)node * D + j];
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;

#pragma unroll 2
  for (int s = s_begin + threadIdx.x * V; s < s_end; s += kThreads * V) {
    float z[D][V], b[V], x[V], wt[V];
#pragma unroll
    for (int j = 0; j < D; ++j) load_chunk<T>(Zn + (size_t)j * n, s, s_end, vec_ok, z[j]);
    load_chunk<T>(bn, s, s_end, vec_ok, b);
    load_chunk<T>(xn, s, s_end, vec_ok, x);
    if (wn != nullptr) {
      load_chunk<T>(wn, s, s_end, vec_ok, wt);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) wt[v] = s + v < s_end ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float eta = b[v];
#pragma unroll
      for (int j = 0; j < D; ++j) eta = fmaf(w[j], z[j][v], eta);
      float r, kap;
      epilogue1<KIND>(eta, x[v], &r, &kap);
      r *= wt[v];   // weight, and 0 past the split
      kap *= wt[v];
#pragma unroll
      for (int a = 0; a < D; ++a) {
        acc[a] = fmaf(z[a][v], r, acc[a]);
        const float kz = kap * z[a][v];
#pragma unroll
        for (int bb = a; bb < D; ++bb)
          acc[tri_index<D>(a, bb)] = fmaf(kz, z[bb][v], acc[tri_index<D>(a, bb)]);
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    float v = acc[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][e] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float sum = 0.0f;
#pragma unroll
    for (int wp = 0; wp < kThreads / 32; ++wp) sum += red[wp][e];
    if (splits > 1)
      partial[((size_t)split * k + node) * E + e] = sum;
    else
      tot[e] = sum;
  }
  if (splits > 1) return;
  __syncthreads();
  if (threadIdx.x < D) g[(size_t)node * D + threadIdx.x] = tot[threadIdx.x];
  for (int t = threadIdx.x; t < D * D; t += kThreads) {
    const int a = t / D, bb = t % D;
    K[(size_t)node * D * D + t] = tot[a <= bb ? tri_index<D>(a, bb) : tri_index<D>(bb, a)];
  }
}

// -------------------------------------------------------------------- wide
// Tile geometry of a wide bucket, fixed by (C, d) and the input type.
struct WideShape {
  int dp, Rp, NT, n_upper, n_tiles, groups, tpg, lanes, TS, lgTS;
};

__host__ __device__ inline size_t round16(size_t b) { return (b + 15) / 16 * 16; }

// Bytes of shared memory a block of the wide kernel uses at sample tile TS.
inline size_t wide_smem_bytes(int C, int d, int elem, int weighted, int TS) {
  const int dp = (d + 3) / 4 * 4, Rp = C * dp, dC = C * d;
  const int rows = C * d + C + 1 + (weighted ? 1 : 0);
  const size_t raw = 2 * round16((size_t)rows * TS * elem);
  const size_t ab = (size_t)TS * Rp + (size_t)C * TS * (Rp + 4);
  const size_t red = (size_t)kThreads * 16;
  const size_t floats = (size_t)(dC + 3) / 4 * 4 + 2 * (size_t)C * TS + (size_t)C * C * TS +
                        (ab > red ? ab : red);
  return raw + floats * sizeof(float) + 2 * kThreads * sizeof(int);
}

// The largest sample tile that fits (two blocks per SM if it can); TS = 0 if none.
inline WideShape wide_shape(int C, int d, int elem, int weighted) {
  WideShape w;
  w.dp = (d + 3) / 4 * 4;
  w.Rp = C * w.dp;
  w.NT = w.Rp / 4;
  w.n_upper = w.NT * (w.NT + 1) / 2;
  w.n_tiles = w.n_upper + w.NT;   // + one g tile per row tile
  w.groups = (w.n_tiles + kThreads - 1) / kThreads;
  w.tpg = (w.n_tiles + w.groups - 1) / w.groups;
  w.TS = 0;
  const int tiles[3] = {64, 32, 16};
  const size_t caps[2] = {kWideSmemSoft, kWideSmemMax};
  for (int c = 0; c < 2 && !w.TS; ++c)
    for (int t = 0; t < 3 && !w.TS; ++t)
      if (wide_smem_bytes(C, d, elem, weighted, tiles[t]) <= caps[c]) w.TS = tiles[t];
  const int lanes = kThreads / w.tpg;
  w.lanes = lanes < 1 ? 1 : (w.TS && lanes > w.TS ? w.TS : lanes);
  w.lgTS = w.TS == 64 ? 6 : w.TS == 32 ? 5 : 4;
  return w;
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
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct WideArgs {
  const void* Z;
  const void* base;
  const void* xi;
  const float* W;
  const void* sw;
  float* partial;
  float* g;
  float* K;
  int k, C, d, n, splits, chunk, vec_ok;
  WideShape w;
};

// Start copying the samples [s0, s0 + TS) of every staged row (Z's C*d rows,
// base's C, xi, then sw) into one stage of the ring; zeros past s_end.
template <typename T>
__device__ __forceinline__ void stage_tile(T* raw, const T* Zn, const T* bn, const T* xn,
                                           const T* wn, int rows, int Cd, int C, int n,
                                           int lgTS, int s0, int s_end, bool vec_ok) {
  constexpr int V = 16 / sizeof(T);
  constexpr int lgV = V == 8 ? 3 : V == 4 ? 2 : 1;
  const int TS = 1 << lgTS, lg_cpr = lgTS - lgV;   // 16-byte chunks per row: TS / V
  for (int idx = threadIdx.x; idx < rows << lg_cpr; idx += kThreads) {
    const int row = idx >> lg_cpr, s = s0 + (idx & ((1 << lg_cpr) - 1)) * V;
    const T* src = row < Cd ? Zn + (size_t)row * n
                 : row < Cd + C ? bn + (size_t)(row - Cd) * n
                 : row == Cd + C ? xn : wn;
    T* dst = raw + row * TS + (s - s0);
    if (vec_ok) {
      // s_end and s are multiples of V here: a chunk is all in or all out
      cp_async16(dst, s < s_end ? src + s : src, s < s_end ? 16 : 0);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) dst[v] = s + v < s_end ? src[s + v] : T(0.0f);
    }
  }
}

template <int KIND, typename T>
__global__ void __launch_bounds__(kThreads) newton_wide_kernel(WideArgs P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WideShape& w = P.w;
  const int C = P.C, d = P.d, n = P.n, dC = C * d, Cd = C * d, TS = w.TS;
  const bool weighted = P.sw != nullptr;
  const int rows = Cd + C + 1 + (weighted ? 1 : 0);
  const size_t raw_bytes = round16((size_t)rows * TS * sizeof(T));
  T* raw0 = reinterpret_cast<T*>(smem);
  T* raw1 = reinterpret_cast<T*>(smem + raw_bytes);
  float* W_s = reinterpret_cast<float*>(smem + 2 * raw_bytes);
  float* r_s = W_s + (dC + 3) / 4 * 4;           // (C, TS)
  float* eta_s = r_s + C * TS;                    // (C, TS)
  float* k_s = eta_s + C * TS;                    // (C, C, TS)
  float* A = k_s + C * C * TS;                    // (TS, Rp) sample-major
  float* B = A + TS * w.Rp;                       // (C, TS, Rp + 4)
  float* red = A;                                 // reused after the last tile
  const size_t ab = (size_t)TS * w.Rp + (size_t)C * TS * (w.Rp + 4);
  int* tile_i = reinterpret_cast<int*>(A + (ab > (size_t)kThreads * 16 ? ab : kThreads * 16));
  int* tile_j = tile_i + kThreads;
  const int BP = w.Rp + 4;

  const int node = blockIdx.x / P.splits;
  const int split = blockIdx.x % P.splits;
  const int s_begin = split * P.chunk;
  const int s_end = min(n, s_begin + P.chunk);
  const T* Zn = static_cast<const T*>(P.Z) + (size_t)node * Cd * n;
  const T* bn = static_cast<const T*>(P.base) + (size_t)node * C * n;
  const T* xn = static_cast<const T*>(P.xi) + (size_t)node * n;
  const T* wn = weighted ? static_cast<const T*>(P.sw) + (size_t)node * n : nullptr;
  const bool vec_ok = P.vec_ok != 0;

  // this thread's tile and lane, fixed for the whole launch
  const int tid = threadIdx.x;
  const int tl = tid % w.tpg, lane = tid / w.tpg;
  const int tile = blockIdx.y * w.tpg + tl;
  const bool active = lane < w.lanes && tile < w.n_tiles;
  int ti = 0, tj = 0;
  if (tile < w.n_tiles) {
    if (tile >= w.n_upper) {
      ti = tile - w.n_upper;
      tj = w.NT;   // the g column tile
    } else {
      int t = tile;
      while (t >= w.NT - ti) {
        t -= w.NT - ti;
        ++ti;
      }
      tj = ti + t;
    }
  }
  if (lane == 0) {
    tile_i[tl] = ti;
    tile_j[tl] = tj;
  }
  const float* Ap = A + 4 * ti;
  const float* Bp = B + (size_t)((4 * ti) / w.dp) * TS * BP + 4 * tj;

  // this thread's sample and first row in the per-tile build of A and B
  const int b_s = tid & (TS - 1), b_row = tid >> w.lgTS, b_step = kThreads >> w.lgTS;
  const int b_c = b_row / w.dp, b_j = b_row % w.dp;

  for (int i = tid; i < dC; i += kThreads) W_s[i] = P.W[(size_t)node * dC + i];
  float acc[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) acc[q] = 0.0f;

  const int n_tiles_s = (s_end - s_begin + TS - 1) / TS;
  if (n_tiles_s > 0)
    stage_tile<T>(raw0, Zn, bn, xn, wn, rows, Cd, C, n, w.lgTS, s_begin, s_end, vec_ok);
  cp_async_commit();
  for (int t = 0; t < n_tiles_s; ++t) {
    const int s0 = s_begin + t * TS;
    const int len = min(TS, s_end - s0);
    T* cur = (t & 1) ? raw1 : raw0;
    if (t + 1 < n_tiles_s)
      stage_tile<T>((t & 1) ? raw0 : raw1, Zn, bn, xn, wn, rows, Cd, C, n, w.lgTS, s0 + TS,
                    s_end, vec_ok);
    cp_async_commit();
    cp_async_wait_1();   // this thread's copies of tile t have landed
    __syncthreads();     // everyone's have; the last tile's products are done

    // eta, r, kappa per sample (all C channels of a sample in one thread)
    for (int s = tid; s < len; s += kThreads) {
      const float x = to_f32(cur[(Cd + C) * TS + s]);
      const float wt = weighted ? to_f32(cur[(Cd + C + 1) * TS + s]) : 1.0f;
      for (int c = 0; c < C; ++c) {
        float e = to_f32(cur[(Cd + c) * TS + s]);
        for (int j = 0; j < d; ++j) e = fmaf(W_s[j * C + c], to_f32(cur[(c * d + j) * TS + s]), e);
        eta_s[c * TS + s] = e;
      }
      if (KIND == kIsing || KIND == kGaussian) {
        float r, kap;
        epilogue1<KIND>(eta_s[s], x, &r, &kap);
        r_s[s] = r * wt;
        k_s[s] = kap * wt;
      } else {
        // softmax over [0, eta_0 .. eta_{C-1}]: the reference state's logit is 0
        float m = 0.0f;
        for (int c = 0; c < C; ++c) m = fmaxf(m, eta_s[c * TS + s]);
        float den = expf(-m);
        for (int c = 0; c < C; ++c) {
          const float ez = expf(eta_s[c * TS + s] - m);
          eta_s[c * TS + s] = ez;
          den += ez;
        }
        for (int c = 0; c < C; ++c) eta_s[c * TS + s] /= den;   // p_c
        for (int c = 0; c < C; ++c) {
          const float pc = eta_s[c * TS + s];
          r_s[c * TS + s] = ((x == static_cast<float>(c + 1)) ? 1.0f - pc : -pc) * wt;
          for (int e = 0; e < C; ++e) {
            const float pe = eta_s[e * TS + s];
            k_s[(c * C + e) * TS + s] = ((c == e) ? (pc - pc * pe) : (-pc * pe)) * wt;
          }
        }
      }
    }
    __syncthreads();

    // A[s, (c, j)] = Z[c, j, s]; B[c, s, (e, f)] = kappa[c, e, s] Z[e, f, s];
    // B[c, s, Rp] = r[c, s]; padding rows and columns are 0. A thread keeps
    // one sample and walks rows b_row, b_row + b_step, ... ((c, j) stepped,
    // not divided)
    if (b_s < len) {
      int c = b_c, j = b_j;
      for (int row = b_row; row < w.Rp; row += b_step) {
        const float z = j < d ? to_f32(cur[(c * d + j) * TS + b_s]) : 0.0f;
        A[b_s * w.Rp + row] = z;
        for (int cr = 0; cr < C; ++cr)
          B[(cr * TS + b_s) * BP + row] = k_s[(cr * C + c) * TS + b_s] * z;
        j += b_step;
        while (j >= w.dp) {
          j -= w.dp;
          ++c;
        }
      }
      for (int cr = b_row; cr < C; cr += b_step) {
        float* bg = B + (cr * TS + b_s) * BP + w.Rp;
        bg[0] = r_s[cr * TS + b_s];
        bg[1] = 0.0f;
        bg[2] = 0.0f;
        bg[3] = 0.0f;
      }
    }
    __syncthreads();

    if (active) {
      for (int s = lane; s < len; s += w.lanes) {
        const float4 a = *reinterpret_cast<const float4*>(Ap + s * w.Rp);
        const float4 b = *reinterpret_cast<const float4*>(Bp + s * BP);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r * 4 + cc] = fmaf(av[r], bv[cc], acc[r * 4 + cc]);
      }
    }
  }
  __syncthreads();   // the last products are done: A is free for the lane sums
  if (active) {
#pragma unroll
    for (int q = 0; q < 16; ++q) red[(lane * w.tpg + tl) * 16 + q] = acc[q];
  }
  __syncthreads();
  for (int item = tid; item < w.tpg * 16; item += kThreads) {
    const int tt = item / 16, q = item % 16;
    const int tile_g = blockIdx.y * w.tpg + tt;
    if (tile_g >= w.n_tiles) continue;
    float sum = 0.0f;
    for (int l = 0; l < w.lanes; ++l) sum += red[(l * w.tpg + tt) * 16 + q];
    if (P.splits > 1) {
      P.partial[(((size_t)split * P.k + node) * w.n_tiles + tile_g) * 16 + q] = sum;
      continue;
    }
    const int i = tile_i[tt], jt = tile_j[tt], r = q / 4, cc = q % 4;
    const int ra = 4 * i + r, c = ra / w.dp, j = ra % w.dp;
    if (j >= d) continue;
    if (jt == w.NT) {
      if (cc == 0) P.g[(size_t)node * dC + j * C + c] = sum;
      continue;
    }
    const int cb = 4 * jt + cc, e = cb / w.dp, f = cb % w.dp;
    if (f >= d || (i == jt && r > cc)) continue;
    float* Kn = P.K + (size_t)node * dC * dC;
    Kn[(size_t)(j * C + c) * dC + f * C + e] = sum;
    Kn[(size_t)(f * C + e) * dC + j * C + c] = sum;
  }
}

// ------------------------------------------------------------------ reduce
// Sums the per-split partials of every output in split order: 8 lanes take
// every 8th split, then a fixed shuffle tree. layout 0: narrow (g, then the
// upper triangle row by row); layout 1: wide 4 x 4 tiles.
__global__ void newton_reduce_kernel(const float* __restrict__ partial, float* __restrict__ g,
                                     float* __restrict__ K, int k, int C, int d, int splits,
                                     int layout, int dp, int NT, int n_upper, int E) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long out = gid / kReduceLanes;
  const int lane = static_cast<int>(gid % kReduceLanes);
  const int dC = d * C;
  const long long per = dC + (long long)dC * dC;
  const bool valid = out < (long long)k * per;
  const int node = valid ? static_cast<int>(out / per) : 0;
  const int o = valid ? static_cast<int>(out % per) : 0;
  int A = 0, Bc = 0, pe = 0;
  if (o < dC) {
    A = o;
    if (layout == 0) {
      pe = A;
    } else {
      const int ra = (A % C) * dp + A / C;
      pe = (n_upper + ra / 4) * 16 + (ra % 4) * 4;
    }
  } else {
    A = (o - dC) / dC;
    Bc = (o - dC) % dC;
    if (layout == 0) {
      const int lo = min(A, Bc), hi = max(A, Bc);
      pe = dC + lo * dC - lo * (lo - 1) / 2 + (hi - lo);
    } else {
      int ra = (A % C) * dp + A / C, rb = (Bc % C) * dp + Bc / C;
      if (ra > rb) {
        const int tmp = ra;
        ra = rb;
        rb = tmp;
      }
      const int i = ra / 4, jt = rb / 4;
      pe = (i * NT - i * (i - 1) / 2 + (jt - i)) * 16 + (ra % 4) * 4 + rb % 4;
    }
  }
  float sum = 0.0f;
  if (valid)
    for (int s = lane; s < splits; s += kReduceLanes)
      sum += partial[((size_t)s * k + node) * E + pe];
#pragma unroll
  for (int off = 1; off < kReduceLanes; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (!valid || lane != 0) return;
  if (o < dC)
    g[(size_t)node * dC + A] = sum;
  else
    K[(size_t)node * dC * dC + (size_t)A * dC + Bc] = sum;
}

// ------------------------------------------------------------------ launch
template <int KIND, typename T, int D>
cudaError_t launch_narrow(const void* Z, const void* base, const void* xi, const float* W,
                          const void* sw, float* partial, float* g, float* K, int k, int n,
                          int splits, int chunk, int vec_ok, cudaStream_t stream) {
  newton_narrow_kernel<KIND, T, D><<<k * splits, kThreads, 0, stream>>>(
      static_cast<const T*>(Z), static_cast<const T*>(base), static_cast<const T*>(xi), W,
      static_cast<const T*>(sw), partial, g, K, k, n, splits, chunk, vec_ok);
  return cudaGetLastError();
}

template <int KIND, typename T>
cudaError_t narrow_by_d(int d, const void* Z, const void* base, const void* xi, const float* W,
                        const void* sw, float* partial, float* g, float* K, int k, int n,
                        int splits, int chunk, int vec_ok, cudaStream_t stream) {
#define REPRO_NARROW(DD)                                                                   \
  case DD:                                                                                 \
    return launch_narrow<KIND, T, DD>(Z, base, xi, W, sw, partial, g, K, k, n, splits, chunk, \
                                      vec_ok, stream);
  switch (d) {
    REPRO_NARROW(1)
    REPRO_NARROW(2)
    REPRO_NARROW(3)
    REPRO_NARROW(4)
    REPRO_NARROW(5)
    REPRO_NARROW(6)
    REPRO_NARROW(7)
    REPRO_NARROW(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_NARROW
}

template <int KIND, typename T>
cudaError_t launch_wide(const WideArgs& P, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(P.C, P.d, sizeof(T), P.sw != nullptr, P.w.TS);
  auto kern = newton_wide_kernel<KIND, T>;
  static bool opted_in = false;   // the cap is set once per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kWideSmemMax));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  kern<<<dim3(P.k * P.splits, P.w.groups), kThreads, smem, stream>>>(P);
  return cudaGetLastError();
}

template <int KIND, typename T>
cudaError_t dispatch(bool narrow, int d, const void* Z, const void* base, const void* xi,
                     const float* W, const void* sw, float* partial, float* g, float* K,
                     const WideArgs& P, int k, int n, int splits, int chunk, int vec_ok,
                     cudaStream_t stream) {
  if (narrow)
    return narrow_by_d<KIND, T>(d, Z, base, xi, W, sw, partial, g, K, k, n, splits, chunk,
                                vec_ok, stream);
  return launch_wide<KIND, T>(P, stream);
}

template <int KIND>
cudaError_t dispatch_dtype(int dtype, bool narrow, int d, const void* Z, const void* base,
                           const void* xi, const float* W, const void* sw, float* partial,
                           float* g, float* K, const WideArgs& P, int k, int n, int splits,
                           int chunk, int vec_ok, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return dispatch<KIND, float>(narrow, d, Z, base, xi, W, sw, partial, g, K, P, k, n,
                                   splits, chunk, vec_ok, stream);
    case 1:
      return dispatch<KIND, double>(narrow, d, Z, base, xi, W, sw, partial, g, K, P, k, n,
                                    splits, chunk, vec_ok, stream);
    case 2:
      return dispatch<KIND, __nv_bfloat16>(narrow, d, Z, base, xi, W, sw, partial, g, K, P, k,
                                           n, splits, chunk, vec_ok, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

inline int elem_size(int dtype) { return dtype == 1 ? 8 : dtype == 2 ? 2 : 4; }

inline bool is_narrow(int C, int d) { return C == 1 && d <= kNarrowMaxD; }

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared-memory bytes one block needs (0 for the narrow regime, whose
// accumulators live in registers); more than 232448 means the width is
// too large for the kernel.
size_t repro_newton_smem_bytes(int C, int d, int dtype, int weighted) {
  if (is_narrow(C, d)) return 0;
  const WideShape w = wide_shape(C, d, elem_size(dtype), weighted);
  if (w.TS == 0) return wide_smem_bytes(C, d, elem_size(dtype), weighted, 16);
  return wide_smem_bytes(C, d, elem_size(dtype), weighted, w.TS);
}

// Floats of split-partial scratch a launch with `splits` > 1 needs.
size_t repro_newton_partial_floats(int k, int C, int d, int dtype, int weighted, int splits) {
  if (splits <= 1) return 0;
  if (is_narrow(C, d)) return (size_t)splits * k * (d + d * (d + 1) / 2);
  const WideShape w = wide_shape(C, d, elem_size(dtype), weighted);
  return (size_t)splits * k * w.n_tiles * 16;
}

// kind: 0 ising, 1 gaussian, 2 potts. dtype of Z/base/xi/sw: 0 float32,
// 1 float64, 2 bfloat16; sw may be null (unweighted). W is float32. Samples
// [i*chunk, (i+1)*chunk) form split i; chunk is a multiple of 8 unless
// splits == 1. partial holds repro_newton_partial_floats floats (unused
// with one split). narrow is the regime the caller planned for (1 narrow,
// 0 wide); a launch whose regime is not the one this library picks for
// (C, d) is refused. Returns a cudaError_t (0 on success).
int repro_newton_stats(int kind, int dtype, const void* Z, const void* base, const void* xi,
                       const float* W, const void* sw, float* partial, float* g, float* K,
                       int k, int C, int d, int n, int splits, int chunk, int narrow_planned,
                       void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (k <= 0 || C <= 0 || d <= 0 || n <= 0 || splits <= 0 || chunk <= 0 ||
      (long long)(splits - 1) * chunk >= n || (splits > 1 && chunk % 8 != 0) ||
      (long long)k * splits > 2147483647LL)
    return cudaErrorInvalidValue;
  if ((kind == kIsing || kind == kGaussian) && C != 1) return cudaErrorInvalidValue;
  if (dtype < 0 || dtype > 2) return cudaErrorInvalidValue;
  const int elem = elem_size(dtype);
  const bool narrow = is_narrow(C, d);
  if (narrow != (narrow_planned != 0)) return cudaErrorInvalidValue;
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec_ok = ((size_t)n * elem) % 16 == 0 && aligned(Z) && aligned(base) &&
                     aligned(xi) && (sw == nullptr || aligned(sw));
  WideArgs P{Z, base, xi, W, sw, partial, g, K, k, C, d, n, splits, chunk, vec_ok, {}};
  if (!narrow) {
    P.w = wide_shape(C, d, elem, sw != nullptr);
    if (P.w.TS == 0) return cudaErrorInvalidValue;
  }
  cudaError_t err;
  switch (kind) {
    case kIsing:
      err = dispatch_dtype<kIsing>(dtype, narrow, d, Z, base, xi, W, sw, partial, g, K, P, k,
                                   n, splits, chunk, vec_ok, stream);
      break;
    case kGaussian:
      err = dispatch_dtype<kGaussian>(dtype, narrow, d, Z, base, xi, W, sw, partial, g, K, P,
                                      k, n, splits, chunk, vec_ok, stream);
      break;
    case kPotts:
      err = dispatch_dtype<kPotts>(dtype, narrow, d, Z, base, xi, W, sw, partial, g, K, P, k,
                                   n, splits, chunk, vec_ok, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return err;
  const int dC = d * C;
  const long long threads = (long long)k * (dC + (long long)dC * dC) * kReduceLanes;
  const int block = 256;
  const long long blocks = (threads + block - 1) / block;
  if (narrow) {
    newton_reduce_kernel<<<static_cast<unsigned>(blocks), block, 0, stream>>>(
        partial, g, K, k, C, d, splits, 0, 0, 0, 0, d + d * (d + 1) / 2);
  } else {
    newton_reduce_kernel<<<static_cast<unsigned>(blocks), block, 0, stream>>>(
        partial, g, K, k, C, d, splits, 1, P.w.dp, P.w.NT, P.w.n_upper, P.w.n_tiles * 16);
  }
  return cudaGetLastError();
}

}  // extern "C"
