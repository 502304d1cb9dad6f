// Gram / empirical-Fisher accumulation G = S^T S / n.
//
// Replaces the TPU kernel src/repro/kernels/gram/kernel.py::gram (_kernel).
// For S (n, d) float32 it writes G (d, d) float32.
//
// What bounds it on an H100: n*d*(d+1) float32 operations (G is symmetric:
// d(d+1)/2 dot products of length n) against 4*(n*d + d*d) bytes; at the
// shapes it is called with (n in the thousands, d in the hundreds) that is
// hundreds of operations per byte, so the float32 FMA rate.
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
// Plain float32 FMA, not TF32: the float32 gates need it.
#include <cuda_runtime.h>

#include "gram_body.cuh"

extern "C" {

// partial holds splits*d*d floats when splits > 1 (unused otherwise); chunk is
// the sample count per split; vec: d % 4 == 0 and S 16-byte aligned.
// Returns a cudaError_t (0 on success).
int repro_gram(const float* S, float* partial, float* G, int n, int d, int splits, int chunk,
               int vec, void* stream_handle) {
  if (n <= 0 || d <= 0 || splits <= 0 || chunk <= 0) return cudaErrorInvalidValue;
  return launch_gram<true>(S, S, partial, G, 1, n, d, splits, chunk, vec,
                           static_cast<cudaStream_t>(stream_handle));
}

}  // extern "C"
