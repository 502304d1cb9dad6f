// Gram / empirical-Fisher accumulation G = S^T S / n.
//
// Replaces the TPU kernel src/repro/kernels/gram/kernel.py::gram (_kernel).
// For S (n, d) float32 or bfloat16 it writes G (d, d) float32, as the TPU
// kernel does (its dot takes preferred_element_type=float32).
//
// What bounds it on an H100: n*d*(d+1) operations (G is symmetric:
// d(d+1)/2 dot products of length n) against 4*(n*d + d*d) bytes (2*n*d +
// 4*d*d for a bfloat16 S); at the shapes it is called with (n in the
// thousands, d in the hundreds) that is hundreds of operations per byte, so
// the float32 FMA rate. For a bfloat16 S the bound is the BF16 tensor-core
// rate, which this body does not use: it converts at each read and sums in
// float32 FMA, as for float32.
//
// Design: the TPU kernel streamed (512, 128) sample strips through VMEM and
// carried the (128, 128) accumulator across the sequential sample axis of its
// grid. Here it is the score kernel's Gram body (gram_body.cuh) with
// r = F = S, C = 1 and p = d, in its symmetric mode: only the 128 x 128
// tiles on and above the diagonal are launched, an off-diagonal tile is
// written to both of its places (G is bitwise symmetric), the sample axis is
// split across blocks when the triangle has few tiles (the split count is a
// function of the shape, chosen by the wrapper), and the splits are summed in
// split order by a second kernel, so a call repeats bitwise without atomics.
// Plain float32 FMA, not TF32: the float32 gates need it. A bfloat16 S is
// staged in shared memory as bfloat16 and converted where it is read.
#include <stdint.h>

#include <cuda_runtime.h>

#include "gram_body.cuh"

extern "C" {

// dtype of S: 0 float32, 2 bfloat16. partial holds splits*d*d floats when
// splits > 1 (unused otherwise); chunk is the sample count per split; width
// is the copy width in elements (float32: 4 for d % 4 == 0 and a 16-byte
// aligned S, else 1; bfloat16: 8 for d % 8 == 0 and a 16-byte aligned S, 2
// for an even d and a 4-byte aligned S, else 1). Returns a cudaError_t (0 on
// success).
int repro_gram(int dtype, const void* S, float* partial, float* G, int n, int d, int splits,
               int chunk, int width, void* stream_handle) {
  if (n <= 0 || d <= 0 || splits <= 0 || chunk <= 0 || width <= 0 || d % width != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (dtype == kFloat32) {
    if (reinterpret_cast<uintptr_t>(S) % (4 * width) != 0) return cudaErrorInvalidValue;
    const float* s = static_cast<const float*>(S);
    return launch_gram<true>(s, s, partial, G, 1, n, d, splits, chunk, width, width, stream);
  }
  if (dtype == kBFloat16) {
    if (reinterpret_cast<uintptr_t>(S) % (2 * width) != 0) return cudaErrorInvalidValue;
    const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(S);
    return launch_gram<true>(s, s, partial, G, 1, n, d, splits, chunk, width, width, stream);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
