// Fused channelized score statistics of the pseudo-likelihood.
//
// Replaces the TPU kernel src/repro/kernels/cl/kernel.py::cl_score_channels,
// both of its Pallas bodies: _score_kernel_c1 (C = 1) and _score_kernel (C > 1),
// and, through its epilogue-free instantiation (kind kLogits, entry
// repro_cl_logits), the TPU kernel cl_logits of the same file (_logits_kernel).
// For F (C, n, p), Theta (C, p, p), mask A (p, p) and bias b (C, p):
//
//   eta[c, s, i] = sum_j F[c, s, j] Theta[c, j, i] A[j, i] + b[c, i]
//   r[:, s, i]   = family residual at (F[:, s, i], eta[:, s, i])   (all C at once)
//   S[c, e, i, j] = sum_s r[c, s, i] F[e, s, j] / n
//
// What bounds it on an H100: the masked product needs only the nonzeros of A
// (2*C*n*nnz operations; on a sensor grid a column of A holds at most 4 of p
// rows), so it is bound by the bytes of F in, eta (and r) out and A once. The
// Gram S is a dense 2*C*C*n*p*p product, bound by the FP32 FMA rate.
//
// Design: the TPU kernel kept a (bm, p) feature strip in VMEM so one pass
// gave eta, r and S. At p in the thousands that strip does not fit in a
// block's 227 KB of shared memory, and a dense product over A multiplies
// mostly zeros, so the work is three kernels (and, for inputs that are not
// all finite, the (d) kernels below, between (b) and (c)):
//  (a) mask_csc_kernel, a pre-pass over A (read once, coalesced along i):
//      for each node tile of 32 columns, the union of its columns' nonzero
//      rows in ascending order, and for each column its nonzero rows as
//      positions in that union with the values Theta[c, j, i] * A[j, i]
//      (compressed sparse columns, sized for the worst case of p entries a
//      column, so no count ever crosses to the host). Up to p = 128 it is
//      skipped: a launch and a workspace then cost more than they save, and
//      every tile walks all p rows densely;
//  (b) masked_logits_kernel over (node tile, sample tile) blocks: it stages
//      F at the union's rows for its 128 samples in shared memory, chunk by
//      chunk, and each thread (one node, 16 samples) walks its column's list
//      in ascending j with fmaf from 0. A tile whose entries fill at least
//      half of (columns x union rows) takes a dense walk over the union with
//      Theta*A staged beside F instead (a dense mask). Both walks add the same
//      products in the same ascending order; a zero of A adds nothing, so
//      with finite inputs eta is bitwise what a dense product over all j
//      gives. All C channels of a node live in one thread, so the epilogue
//      adds the bias, applies the family residual (the Potts softmax needs
//      every channel) and writes eta and r;
//  (c) S[c,e] = r_c^T F_e through the Gram body (gram_body.cuh, shared with
//      gram.cu), all tiles, samples split as the wrapper chose, partials
//      summed in split order: deterministic without float atomics.
// cl_logits is (a), (b) and (d) with the epilogue writing eta only.
// Plain float32 FMA throughout, not TF32: the float32 parity gates need it.
//
// Operand types. F, Theta, A and b are all float32 or all bfloat16 (the
// template parameter T, the dtype code of the C entries). Every stage reads
// its operands in T and converts them to float32 where they are read, which
// is exact, so the sums, the epilogue and the Gram are the float32 ones:
// a bfloat16 call gives bitwise what a float32 call on the float32 upcasts
// of its operands gives, with eta and r then rounded once to bfloat16 (as
// the TPU kernel's epilogue rounds them). The bytes of F, Theta and A read,
// and of eta and r written, halve. In bfloat16: the pre-pass stores Theta*A
// in float32 as before; the masked product gathers F with plain loads,
// since cp.async copies no 2-byte unit, and stores them converted to the
// float32 shared buffer at once (held in registers across the chunk's
// products instead, as Theta*A is on a dense tile, the gathers read wrong
// values for C = 1 and 4 on sparse tiles, for a cause not found); the
// epilogue also writes the float32
// r to a workspace rf, which the Gram reads as its r, since the TPU kernel
// forms S from r before rounding it (and a Gram over the rounded r is off
// by up to 2^-9 a term); the Gram reads F as bfloat16 (gram_body.cuh). The
// non-finite stage tests the values after conversion: a bfloat16 inf or
// NaN is one in float32 too.
//
// Non-finite inputs. The reference forms Theta*A first, so where a non-finite
// Theta[c, j, i] or F[c, s, j] meets a zero of A[j, i] the product is NaN
// (inf * 0) and so is eta[c, s, i]. A walk over all p rows (FULL, and the
// dense walk over a union) multiplies by that zero and gets the NaN itself;
// the sparse walk and the rows outside a tile's union never see it. So,
// without FULL, (d) follows the masked product: nonfinite_scan_kernel reads
// F and Theta once, bound by their bytes, and flags a non-finite value in
// either; colbad_kernel (Theta flagged) finds the channels of each column
// with a non-finite Theta at a zero of A; nonfinite_fixup_kernel (a flag
// set) writes those NaNs, and the residuals there. Checks inside the masked
// product itself cost it about as much as the scan (the product already
// runs near the card's memory rate) and it stays as it was: with finite
// inputs the last two kernels read the flags and return, and eta, r and S
// are bitwise what they were without (d).
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <type_traits>

#include <cuda_runtime.h>

#include "gram_body.cuh"

namespace {

// kLogits writes eta only (r is not touched): the cl_logits contract
enum Kind { kIsing = 0, kGaussian = 1, kPotts = 2, kLogits = 3 };

constexpr int kNodeTile = 32;     // columns i of a block: one per lane
constexpr int kSampleTile = 128;  // samples of a block: 16 per warp
constexpr int kThreadSamples = 16;
constexpr int kMaskThreads = 256;  // the masked product's block
constexpr int kPreThreads = 512;   // the pre-pass's block: 16 warps
constexpr int kPreRows = 16;       // rows of A each warp reads per pre-pass step
constexpr int kRow = kSampleTile + 4;   // a staged row of F: float4-aligned, conflict-free
// union rows staged per chunk (two chunks in flight)
template <int C>
constexpr int kUnionChunk = C == 1 ? 32 : C == 2 ? 16 : 8;
// up to this many nodes the pre-pass is skipped: every tile walks all p rows
// densely (the launch and the workspace cost more than the walk saves)
constexpr int kFullRows = 128;
// a column's entries held in registers at a time (sparse walk)
template <int C>
constexpr int kEntryBatch = C <= 2 ? 8 : 4;
// two buffers of F [C][kUc][kRow] and Theta*A [C][kUc][32]
template <int C>
constexpr int kMaskedSmem = 2 * C * kUnionChunk<C> * (kRow + kNodeTile) * (int)sizeof(float);

// The pre-pass's output, carved from one workspace of
// repro_masked_workspace_words(C, p) 4-byte words.
struct MaskCsc {
  float* vals;   // (C, p, p): vals[c][e][i], entry e of column i
  int* uidx;     // (p, p): uidx[e][i], the entry's position in its tile's union
  int* urows;    // (tiles, p): the tile's union rows, ascending
  int* ucount;   // (tiles,): union size
  int* etotal;   // (tiles,): entries of the tile's columns
  int* nnz;      // (p,): entries of column i
  int* colbad;   // (p,): bit c set when column i has a non-finite Theta[c] at a zero of A
  int* flags;    // (2,): [0] F holds a non-finite value, [1] Theta does
};

inline int node_tiles(int p) { return (p + kNodeTile - 1) / kNodeTile; }

inline size_t masked_workspace_words(int C, int p) {
  if (p <= kFullRows) return 0;
  const size_t pp = (size_t)p * p, tiles = node_tiles(p);
  return (size_t)C * pp + pp + tiles * p + 2 * tiles + 2 * (size_t)p + 2;
}

inline MaskCsc carve(void* work, int C, int p) {
  const size_t pp = (size_t)p * p, tiles = node_tiles(p);
  MaskCsc w;
  w.vals = static_cast<float*>(work);
  int* q = reinterpret_cast<int*>(w.vals + C * pp);
  w.uidx = q;
  q += pp;
  w.urows = q;
  q += tiles * p;
  w.ucount = q;
  q += tiles;
  w.etotal = q;
  q += tiles;
  w.nnz = q;
  q += p;
  w.colbad = q;
  q += p;
  w.flags = q;
  return w;
}

// One block per node tile. The scan: warp w reads rows j0 + 16w .. j0 + 16w
// + 15 of the tile's 32 columns (lane = column), the next step's rows loaded
// while this step's are appended. Entries and union rows are appended in
// ascending j: a step's offsets are prefix sums over the warps (kept
// identically in every warp's registers) plus the rank of the row within the
// warp's bit mask. The scan stores each entry's row j in its value slot; the
// values Theta[c, j, i] * A[j, i] follow in a second pass shared by all warps,
// with many loads in flight, so the scan never waits on Theta. Block 0 also
// clears the non-finite flags. The values are float32 whatever T is.
template <typename T>
__global__ void __launch_bounds__(kPreThreads)
mask_csc_kernel(const T* __restrict__ mask, const T* __restrict__ theta, int C, int p,
                MaskCsc ws) {
  constexpr int kWarps = kPreThreads / 32;
  constexpr int kStep = kWarps * kPreRows;
  constexpr int kValBatch = 8;
  __shared__ int s_u[kWarps];
  __shared__ int s_c[kWarps][32];
  const int tile = blockIdx.x, lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int i = tile * kNodeTile + lane;
  const bool col_ok = i < p;
  const size_t pp = (size_t)p * p;
  int* urows = ws.urows + (size_t)tile * p;
  int ubase = 0, cbase = 0;
  if (tile == 0 && threadIdx.x < 2) ws.flags[threadIdx.x] = 0;
  float m[kPreRows];
#pragma unroll
  for (int q = 0; q < kPreRows; ++q) {
    const int j = w * kPreRows + q;
    m[q] = (col_ok && j < p) ? to_f32(mask[(size_t)j * p + i]) : 0.0f;
  }
  for (int j0 = 0; j0 < p; j0 += kStep) {
    const int jw = j0 + w * kPreRows;
    float next[kPreRows];
#pragma unroll
    for (int q = 0; q < kPreRows; ++q) {
      const int j = jw + kStep + q;
      next[q] = (col_ok && j < p) ? to_f32(mask[(size_t)j * p + i]) : 0.0f;
    }
    unsigned cbits = 0, ubits = 0;
#pragma unroll
    for (int q = 0; q < kPreRows; ++q) {
      const bool nz = m[q] != 0.0f;
      cbits |= static_cast<unsigned>(nz) << q;
      ubits |= static_cast<unsigned>(__ballot_sync(0xffffffffu, nz) != 0) << q;
    }
    if (lane == 0) s_u[w] = __popc(ubits);
    s_c[w][lane] = __popc(cbits);
    __syncthreads();
    int uoff = ubase, coff = cbase, utot = 0, ctot = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      if (v < w) {
        uoff += s_u[v];
        coff += s_c[v][lane];
      }
      utot += s_u[v];
      ctot += s_c[v][lane];
    }
    // lane q < 16 writes union row q of the warp's rows
    if (lane < kPreRows && ((ubits >> lane) & 1u))
      urows[uoff + __popc(ubits & ((1u << lane) - 1u))] = jw + lane;
#pragma unroll
    for (int q = 0; q < kPreRows; ++q) {
      if ((cbits >> q) & 1u) {
        const size_t at = (size_t)(coff + __popc(cbits & ((1u << q) - 1u))) * p + i;
        ws.uidx[at] = uoff + __popc(ubits & ((1u << q) - 1u));
        ws.vals[at] = __int_as_float(jw + q);   // the row, until the value pass
      }
    }
    ubase += utot;
    cbase += ctot;
#pragma unroll
    for (int q = 0; q < kPreRows; ++q) m[q] = next[q];
    __syncthreads();   // s_u and s_c are rewritten by the next step
  }
  // values: warp w takes entries w, w + 16, ... of every column (the scan's
  // writes are visible to the block after the barrier above)
  for (int e0 = w; e0 < cbase; e0 += kWarps * kValBatch) {
    int j[kValBatch];
    float mk[kValBatch];
#pragma unroll
    for (int q = 0; q < kValBatch; ++q) {
      const int e = e0 + q * kWarps;
      j[q] = e < cbase ? __float_as_int(ws.vals[(size_t)e * p + i]) : 0;
    }
#pragma unroll
    for (int q = 0; q < kValBatch; ++q)
      mk[q] = e0 + q * kWarps < cbase ? to_f32(mask[(size_t)j[q] * p + i]) : 0.0f;
    for (int c = C - 1; c >= 0; --c) {   // channel 0 last: its slot held the row
#pragma unroll
      for (int q = 0; q < kValBatch; ++q) {
        const int e = e0 + q * kWarps;
        if (e < cbase)
          ws.vals[c * pp + (size_t)e * p + i] =
              to_f32(theta[c * pp + (size_t)j[q] * p + i]) * mk[q];
      }
    }
  }
  if (w == 0) {
    if (col_ok) ws.nnz[i] = cbase;
    int e = cbase;
#pragma unroll
    for (int o = 16; o; o >>= 1) e += __shfl_xor_sync(0xffffffffu, e, o);
    if (lane == 0) {
      ws.ucount[tile] = ubase;
      ws.etotal[tile] = e;
    }
  }
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// inf or NaN: the exponent bits all set
__device__ __forceinline__ bool nonfinite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}
// any of the values of T packed in a 32-bit word (one float32, two bfloat16)
template <typename T>
__device__ __forceinline__ bool nonfinite_word(unsigned x) {
  if constexpr (std::is_same<T, float>::value)
    return (x & 0x7f800000u) == 0x7f800000u;
  else
    return ((x & 0x7f800000u) == 0x7f800000u) | ((x & 0x7f80u) == 0x7f80u);
}

__device__ __forceinline__ void fma16(float (&acc)[kThreadSamples], const float* f, float v) {
#pragma unroll
  for (int q = 0; q < kThreadSamples / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(f)[q];
    acc[4 * q + 0] = fmaf(x.x, v, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(x.y, v, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(x.z, v, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(x.w, v, acc[4 * q + 3]);
  }
}

// Block (node tile, sample tile); lane = node, warp w = samples 16w .. 16w + 15.
// Chunks of the tile's union rows pass through two shared buffers: F at the
// next chunk's rows is copied (cp.async, 4-byte gathers) while this chunk is
// used, and on a dense tile Theta*A at the next chunk's rows waits in
// registers. The union rows a thread gathers are read one chunk earlier still,
// so no copy waits on an address, and the tile's bookkeeping, the first union
// rows and a column's first entries are all read at once on entry. FULL: no
// pre-pass ran (p <= kFullRows); the union is all p rows and every tile dense.
// A bfloat16 F takes the same gathers as plain loads, converted and stored
// to the float32 buffer at once (a chunk's loads are issued together).
// rf (bfloat16 score kinds only) receives r in float32.
template <int KIND, int C, bool FULL, typename T>
__global__ void __launch_bounds__(kMaskThreads)
masked_logits_kernel(const T* __restrict__ F, const T* __restrict__ theta,
                     const T* __restrict__ mask, const T* __restrict__ bias, MaskCsc ws,
                     T* __restrict__ eta, T* __restrict__ r, float* __restrict__ rf, int n,
                     int p) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kTh = kSampleTile / 32;                   // sample groups a thread gathers
  constexpr int kUc = kUnionChunk<C>;
  constexpr int kFPer = kUc / 8;                          // union rows a thread gathers F at
  constexpr int kVPer = kUc * kNodeTile / kMaskThreads;   // Theta*A values a thread stages
  extern __shared__ __align__(16) float smem[];
  float* Fs = smem;                              // [2][C][kUc][kRow]
  float* Vs = smem + 2 * C * kUc * kRow;         // [2][C][kUc][kNodeTile]
  const int tile = blockIdx.x, lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int i0 = tile * kNodeTile, i = i0 + lane;
  const int s0 = blockIdx.y * kSampleTile, sw = w * kThreadSamples;
  const size_t np = (size_t)n * p, pp = (size_t)p * p;
  // FULL (p <= kFullRows, no pre-pass): the union is all p rows, walked densely
  const int* urows = FULL ? nullptr : ws.urows + (size_t)tile * p;

  // union rows of chunk k for this thread's F gathers (jf) and Theta*A (jv),
  // read before the union's size is known: a row past the tile's p slots
  // reads as 0 and is masked by the size later
  int jf[kFPer], jv[kVPer];
  auto row_of = [&](int u) { return u >= p ? 0 : FULL ? u : urows[u]; };
  auto load_rows = [&](int k) {
#pragma unroll
    for (int q = 0; q < kFPer; ++q) jf[q] = row_of(k * kUc + q * 8 + (lane >> 2));
#pragma unroll
    for (int q = 0; q < kVPer; ++q) jv[q] = row_of(k * kUc + w + 8 * q);
  };
  load_rows(0);
  const int U = FULL ? p : ws.ucount[tile];
  const int etotal = FULL ? 0 : ws.etotal[tile];
  const int my_n = i < p && !FULL ? ws.nnz[i] : 0;
  // sparse walk: this column's entries in ascending j, kB of them in
  // registers, all of a batch's loads in flight at once; the first batch is
  // read on entry, before the column's count is known (a slot past the
  // count is never used)
  constexpr int kB = kEntryBatch<C>;
  int eb = 0;
  int bu[kB];
  float bv[C][kB];
  auto load_batch = [&](bool known) {
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const bool ok = i < p && !FULL && eb + q < (known ? my_n : p);
      const size_t at = (size_t)(eb + q) * p + i;
      bu[q] = ok ? ws.uidx[at] : INT_MAX;
#pragma unroll
      for (int c = 0; c < C; ++c) bv[c][q] = ok ? ws.vals[c * pp + at] : 0.0f;
    }
  };
  load_batch(false);
  const int cols = min(kNodeTile, p - i0);
  const bool dense = FULL || 2 * etotal >= cols * U;
  const int chunks = (U + kUc - 1) / kUc;

  // F[c, s, urows[u]]: a warp covers 8 rows x 4 samples (32-byte runs of a
  // row of F where the union is contiguous; 32 distinct banks in Fs).
  // float32: cp.async into Fs[buf]; bfloat16: loads converted into Fs[buf]
  auto stage_f = [&](int k, int buf) {
    const int uc = min(kUc, U - k * kUc);
#pragma unroll
    for (int q = 0; q < kFPer; ++q) {
      const int uu = q * 8 + (lane >> 2);
#pragma unroll
      for (int th = 0; th < kTh; ++th) {
        const int t = (w + 8 * th) * 4 + (lane & 3);
        const bool ok = uu < uc && s0 + t < n;
        const size_t src = (size_t)(ok ? s0 + t : 0) * p + (ok ? jf[q] : 0);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float* dst = Fs + ((buf * C + c) * kUc + uu) * kRow + t;
          if constexpr (kF32)
            cp_async4(dst, F + c * np + src, ok);
          else
            *dst = ok ? to_f32(F[c * np + src]) : 0.0f;
        }
      }
    }
  };
  float vr[C][kVPer];
  auto load_v = [&](int k) {
    const int uc = min(kUc, U - k * kUc);
#pragma unroll
    for (int q = 0; q < kVPer; ++q) {
      const bool ok = w + 8 * q < uc && i < p;
      const size_t at = ok ? (size_t)jv[q] * p + i : 0;
      const float mk = ok ? to_f32(mask[at]) : 0.0f;
#pragma unroll
      // at a zero of A a finite Theta gives +-0, which leaves every sum
      // bitwise as it was; a non-finite one gives the reference's NaN
      for (int c = 0; c < C; ++c) {
        const float t = ok ? to_f32(theta[c * pp + at]) : 0.0f;
        vr[c][q] = t * mk;
      }
    }
  };
  auto store_v = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kVPer; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c)
        Vs[((buf * C + c) * kUc + w + 8 * q) * kNodeTile + lane] = vr[c][q];
  };

  float acc[C][kThreadSamples];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int t = 0; t < kThreadSamples; ++t) acc[c][t] = 0.0f;

#pragma unroll
  for (int q = 0; q < kB; ++q)
    if (q >= my_n) bu[q] = INT_MAX;   // slots past the column's entries

  if (chunks > 0) {
    stage_f(0, 0);
    if (dense) load_v(0);
    load_rows(1);
    if (dense) store_v(0);
  }
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1;
    if (k + 1 < chunks) {
      stage_f(k + 1, buf ^ 1);
      if (dense) load_v(k + 1);
      load_rows(k + 2);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // chunk k's F (and Theta*A) are in buf for every thread
    const int u0 = k * kUc, uc = min(kUc, U - u0);
    if (dense) {
      for (int uu = 0; uu < uc; ++uu) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          fma16(acc[c], Fs + ((buf * C + c) * kUc + uu) * kRow + sw,
                Vs[((buf * C + c) * kUc + uu) * kNodeTile + lane]);
      }
      if (k + 1 < chunks) store_v(buf ^ 1);
    } else {
      // the batch's entries in this chunk, in order; entries below u0 were
      // used in earlier chunks
      while (true) {
#pragma unroll
        for (int q = 0; q < kB; ++q) {
          if (bu[q] >= u0 && bu[q] < u0 + uc) {
#pragma unroll
            for (int c = 0; c < C; ++c)
              fma16(acc[c], Fs + ((buf * C + c) * kUc + bu[q] - u0) * kRow + sw, bv[c][q]);
          }
        }
        if (bu[kB - 1] < u0 + uc && eb + kB < my_n) {
          eb += kB;
          load_batch(true);
        } else {
          break;
        }
      }
    }
    __syncthreads();   // buf is refilled with chunk k + 2 next
  }
  cp_async_wait<0>();

  if (i >= p) return;
  // r in the output type and, for bfloat16, unrounded in rf for the Gram
  auto put_r = [&](size_t at, float v) {
    r[at] = from_f32<T>(v);
    if constexpr (!kF32) rf[at] = v;
  };
  float b[C];
#pragma unroll
  for (int c = 0; c < C; ++c) b[c] = to_f32(bias[c * p + i]);
#pragma unroll
  for (int t = 0; t < kThreadSamples; ++t) {
    const int s = s0 + sw + t;
    if (s >= n) continue;
    const size_t off = (size_t)s * p + i;
    float ev[C], y[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ev[c] = acc[c][t] + b[c];
      eta[c * np + off] = from_f32<T>(ev[c]);
    }
    if (KIND == kLogits) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) y[c] = to_f32(F[c * np + off]);   // the node's own features
    if (KIND == kIsing) {
      put_r(off, 2.0f * y[0] * sigmoidf(-2.0f * y[0] * ev[0]));
    } else if (KIND == kGaussian) {
      put_r(off, y[0] - ev[0]);
    } else {
      // softmax over [0, eta_0 .. eta_{C-1}]: the reference state's logit is 0
      float m = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) m = fmaxf(m, ev[c]);
      float den = expf(-m);
#pragma unroll
      for (int c = 0; c < C; ++c) den += expf(ev[c] - m);
#pragma unroll
      for (int c = 0; c < C; ++c) put_r(c * np + off, y[c] - expf(ev[c] - m) / den);
    }
  }
}

constexpr int kFixThreads = 256;
constexpr int kFixBlocks = 4 * 132;   // four per SM of an H100
constexpr int kFixList = 1024;        // non-finite entries of a row of F held at once

// Sets *flag when any of a[0 .. count) is not finite; 16-byte loads, four in
// flight a thread, where a is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void flag_nonfinite(const T* __restrict__ a, size_t count, int* flag) {
  constexpr int kPer = 16 / sizeof(T);   // values of a 16-byte load
  const size_t tid = blockIdx.x * (size_t)kFixThreads + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * kFixThreads;
  bool bad = false;
  size_t head = 0;
  if (reinterpret_cast<size_t>(a) % 16 == 0) {
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const size_t n4 = count / kPer;
    auto nf4 = [](uint4 v) {
      return nonfinite_word<T>(v.x) | nonfinite_word<T>(v.y) | nonfinite_word<T>(v.z) |
             nonfinite_word<T>(v.w);
    };
    size_t k = tid;
    for (; k + 3 * stride < n4; k += 4 * stride) {
      const uint4 v0 = a4[k], v1 = a4[k + stride], v2 = a4[k + 2 * stride],
                  v3 = a4[k + 3 * stride];
      bad |= nf4(v0) | nf4(v1) | nf4(v2) | nf4(v3);
    }
    for (; k < n4; k += stride) bad |= nf4(a4[k]);
    head = n4 * kPer;
  }
  for (size_t k = head + tid; k < count; k += stride) bad |= nonfinite(to_f32(a[k]));
  if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = 1;
}

// (d) flags[0] when F holds a non-finite value, flags[1] when Theta does.
template <typename T>
__global__ void __launch_bounds__(kFixThreads)
nonfinite_scan_kernel(const T* __restrict__ F, size_t nf, const T* __restrict__ theta,
                      size_t nt, MaskCsc ws) {
  flag_nonfinite(F, nf, ws.flags);
  flag_nonfinite(theta, nt, ws.flags + 1);
}

// (d) When Theta is flagged: colbad[i] gets bit c when some zero of A[:, i]
// meets a non-finite Theta[c, :, i]. One thread per column, rows in order.
// Otherwise it returns at once.
template <typename T>
__global__ void __launch_bounds__(kFixThreads)
colbad_kernel(const T* __restrict__ theta, const T* __restrict__ mask, MaskCsc ws, int C,
              int p) {
  if (!ws.flags[1]) return;
  const int i = blockIdx.x * kFixThreads + threadIdx.x;
  if (i >= p) return;
  const size_t pp = (size_t)p * p;
  int bits = 0;
  for (int j = 0; j < p; ++j) {
    if (to_f32(mask[(size_t)j * p + i]) != 0.0f) continue;
    for (int c = 0; c < C; ++c)
      if (nonfinite(to_f32(theta[c * pp + (size_t)j * p + i]))) bits |= 1 << c;
  }
  ws.colbad[i] = bits;
}

// (d) When a flag is set: eta[c, s, i] = NaN where a zero of A[:, i] meets
// a non-finite Theta[c, :, i] (colbad) or a non-finite F[c, s, :], and the
// residuals there follow (the Potts softmax takes every channel of the
// node). One row (c, s) of F per block step: its non-finite columns are
// listed in shared memory, then each thread takes columns i. With no flag
// set every block returns after reading the flags. rf (bfloat16 score kinds)
// gets the NaNs of r too, before the Gram reads it.
template <int KIND, int C, typename T>
__global__ void __launch_bounds__(kFixThreads)
nonfinite_fixup_kernel(const T* __restrict__ F, const T* __restrict__ mask, MaskCsc ws,
                       T* __restrict__ eta, T* __restrict__ r, float* __restrict__ rf, int n,
                       int p) {
  __shared__ int s_list[kFixList];
  __shared__ int s_cnt;
  const bool fbad = ws.flags[0] != 0, tbad = ws.flags[1] != 0;
  if (!fbad && !tbad) return;
  const size_t np = (size_t)n * p;
  const float nan = __int_as_float(0x7fc00000);
  auto put_r = [&](size_t at) {
    r[at] = from_f32<T>(nan);
    if constexpr (!std::is_same<T, float>::value) rf[at] = nan;
  };
  for (int row = blockIdx.x; row < C * n; row += gridDim.x) {
    const int c = row / n, s = row % n;
    const T* f = F + c * np + (size_t)s * p;
    if (threadIdx.x == 0) s_cnt = 0;
    __syncthreads();
    if (fbad) {
      for (int j = threadIdx.x; j < p; j += kFixThreads) {
        if (nonfinite(to_f32(f[j]))) {
          const int at = atomicAdd(&s_cnt, 1);
          if (at < kFixList) s_list[at] = j;
        }
      }
    }
    __syncthreads();
    const int cnt = s_cnt;
    for (int i = threadIdx.x; i < p; i += kFixThreads) {
      bool bad = tbad && ((ws.colbad[i] >> c) & 1);
      if (cnt <= kFixList) {
        for (int e = 0; e < cnt && !bad; ++e)
          bad = to_f32(mask[(size_t)s_list[e] * p + i]) == 0.0f;
      } else {   // more than the list holds: walk the row
        for (int j = 0; j < p && !bad; ++j)
          bad = nonfinite(to_f32(f[j])) && to_f32(mask[(size_t)j * p + i]) == 0.0f;
      }
      if (!bad) continue;
      const size_t off = (size_t)s * p + i;
      eta[c * np + off] = from_f32<T>(nan);
      if (KIND == kPotts) {
        for (int e = 0; e < C; ++e) put_r(e * np + off);
      } else if (KIND != kLogits) {
        put_r(off);
      }
    }
    __syncthreads();   // s_cnt and s_list are rewritten for the next row
  }
}

// The pre-pass, then the masked product with its epilogue.
template <int KIND, int C, typename T>
cudaError_t launch_logits(const T* F, const T* theta, const T* mask, const T* bias, void* work,
                          T* eta, T* r, float* rf, int n, int p, cudaStream_t stream) {
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(masked_logits_kernel<KIND, C, false, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaskedSmem<C>),
      cudaFuncSetAttribute(masked_logits_kernel<KIND, C, true, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaskedSmem<C>)};
  const bool full = p <= kFullRows;
  if (attr[full] != cudaSuccess) return attr[full];
  dim3 grid(node_tiles(p), (n + kSampleTile - 1) / kSampleTile);
  if (full) {
    masked_logits_kernel<KIND, C, true, T><<<grid, kMaskThreads, kMaskedSmem<C>, stream>>>(
        F, theta, mask, bias, MaskCsc{}, eta, r, rf, n, p);
    return cudaGetLastError();
  }
  const MaskCsc ws = carve(work, C, p);
  mask_csc_kernel<T><<<node_tiles(p), kPreThreads, 0, stream>>>(mask, theta, C, p, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  masked_logits_kernel<KIND, C, false, T><<<grid, kMaskThreads, kMaskedSmem<C>, stream>>>(
      F, theta, mask, bias, ws, eta, r, rf, n, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nonfinite_scan_kernel<T><<<kFixBlocks, kFixThreads, 0, stream>>>(
      F, (size_t)C * n * p, theta, (size_t)C * p * p, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colbad_kernel<T><<<(p + kFixThreads - 1) / kFixThreads, kFixThreads, 0, stream>>>(theta, mask,
                                                                                    ws, C, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nonfinite_fixup_kernel<KIND, C, T><<<std::min(C * n, kFixBlocks), kFixThreads, 0, stream>>>(
      F, mask, ws, eta, r, rf, n, p);
  return cudaGetLastError();
}

// The channel count as a template parameter, C = 1 .. 5.
template <int KIND, typename T>
cudaError_t launch_channels(int C, const T* F, const T* theta, const T* mask, const T* bias,
                            void* work, T* eta, T* r, float* rf, int n, int p,
                            cudaStream_t stream) {
  switch (C) {
    case 1: return launch_logits<KIND, 1>(F, theta, mask, bias, work, eta, r, rf, n, p, stream);
    case 2: return launch_logits<KIND, 2>(F, theta, mask, bias, work, eta, r, rf, n, p, stream);
    case 3: return launch_logits<KIND, 3>(F, theta, mask, bias, work, eta, r, rf, n, p, stream);
    case 4: return launch_logits<KIND, 4>(F, theta, mask, bias, work, eta, r, rf, n, p, stream);
    case 5: return launch_logits<KIND, 5>(F, theta, mask, bias, work, eta, r, rf, n, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The score statistics in operand type T: the masked product with the
// family's epilogue, then the Gram S = r^T F / n. A float32 call reads r
// for the Gram and copies both operands width elements at a time; a
// bfloat16 call reads the float32 rf (16-byte copies where F's are).
template <typename T>
cudaError_t launch_score(int kind, int C, const void* F_, const void* theta, const void* mask,
                         const void* bias, void* work, void* eta, void* r_, float* rf,
                         float* partial, float* S, int n, int p, int splits, int chunk,
                         int width, cudaStream_t stream) {
  const T* F = static_cast<const T*>(F_);
  const T* th = static_cast<const T*>(theta);
  const T* A = static_cast<const T*>(mask);
  const T* b = static_cast<const T*>(bias);
  T* e = static_cast<T*>(eta);
  T* r = static_cast<T*>(r_);
  cudaError_t err;
  switch (kind) {
    case kIsing:
      if (C != 1) return cudaErrorInvalidValue;
      err = launch_logits<kIsing, 1>(F, th, A, b, work, e, r, rf, n, p, stream);
      break;
    case kGaussian:
      if (C != 1) return cudaErrorInvalidValue;
      err = launch_logits<kGaussian, 1>(F, th, A, b, work, e, r, rf, n, p, stream);
      break;
    case kPotts:
      err = launch_channels<kPotts>(C, F, th, A, b, work, e, r, rf, n, p, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, float>::value)
    return launch_gram<false>(r, F, partial, S, C, n, p, splits, chunk, width, width, stream);
  else
    return launch_gram<false>(static_cast<const float*>(rf), F, partial, S, C, n, p, splits,
                              chunk, width == 8 ? 4 : 1, width, stream);
}

// cl_logits in operand type T: the masked product without an epilogue.
template <typename T>
cudaError_t launch_logits_only(int C, const void* F, const void* theta, const void* mask,
                               const void* bias, void* work, void* eta, int n, int p,
                               cudaStream_t stream) {
  return launch_channels<kLogits, T>(C, static_cast<const T*>(F), static_cast<const T*>(theta),
                                     static_cast<const T*>(mask), static_cast<const T*>(bias),
                                     work, static_cast<T*>(eta), nullptr, nullptr, n, p,
                                     stream);
}

// A copy width of width elements of T fits rows of p elements at base F.
template <typename T>
bool width_fits(int width, int p, const void* F) {
  const bool ok = std::is_same<T, float>::value ? (width == 4 || width == 1)
                                                : (width == 8 || width == 2 || width == 1);
  return ok && p % width == 0 && reinterpret_cast<uintptr_t>(F) % (width * sizeof(T)) == 0;
}

}  // namespace

extern "C" {

// Largest channel count the Potts and logits instantiations cover: the
// chunk sizes of the masked product are set for C = 1 .. 5.
int repro_score_max_channels() { return 5; }

// 4-byte words of the workspace the masked product's pre-pass fills for C
// channels and p nodes (worst case: p entries in every column), with the
// non-finite flags; none when p <= kFullRows, where there is no pre-pass and
// work may be null.
size_t repro_masked_workspace_words(int C, int p) { return masked_workspace_words(C, p); }

// kind: 0 ising, 1 gaussian, 2 potts. dtype of F, theta, mask, bias, eta and
// r: 0 float32, 2 bfloat16; all contiguous. rf holds C*n*p floats (the
// float32 r the Gram reads) for bfloat16 and may be null for float32; S and
// partial are float32. work holds repro_masked_workspace_words(C, p) words.
// partial holds splits*C*C*p*p floats when splits > 1 (unused otherwise);
// chunk is the sample count per split; width: the Gram body's copy width of
// F in elements (float32 4 or 1, bfloat16 8, 2 or 1; p % width == 0 and F
// aligned to a copy), and rf and partial 16-byte aligned. Returns a
// cudaError_t (0 on success).
int repro_score_channels(int kind, int dtype, int C, const void* F, const void* theta,
                         const void* mask, const void* bias, void* work, void* eta, void* r,
                         float* rf, float* partial, float* S, int n, int p, int splits,
                         int chunk, int width, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (n <= 0 || p <= 0 || C <= 0 || splits <= 0 || chunk <= 0) return cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    if (!width_fits<float>(width, p, F)) return cudaErrorInvalidValue;
    return launch_score<float>(kind, C, F, theta, mask, bias, work, eta, r, nullptr, partial, S,
                               n, p, splits, chunk, width, stream);
  }
  if (dtype == kBFloat16) {
    if (!width_fits<__nv_bfloat16>(width, p, F) || rf == nullptr) return cudaErrorInvalidValue;
    return launch_score<__nv_bfloat16>(kind, C, F, theta, mask, bias, work, eta, r, rf, partial,
                                       S, n, p, splits, chunk, width, stream);
  }
  return cudaErrorInvalidValue;
}

// eta[c] = F[c] (Theta[c] * A) + b[c] for C = 1 .. repro_score_max_channels();
// dtype of every tensor: 0 float32, 2 bfloat16; all contiguous; work as for
// repro_score_channels. Returns a cudaError_t (0 on success).
int repro_cl_logits(int dtype, int C, const void* F, const void* theta, const void* mask,
                    const void* bias, void* work, void* eta, int n, int p,
                    void* stream_handle) {
  if (n <= 0 || p <= 0) return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (dtype == kFloat32)
    return launch_logits_only<float>(C, F, theta, mask, bias, work, eta, n, p, stream);
  if (dtype == kBFloat16)
    return launch_logits_only<__nv_bfloat16>(C, F, theta, mask, bias, work, eta, n, p, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
