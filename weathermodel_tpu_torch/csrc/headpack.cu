// The head-layout probes P1 and P2 (scripts/abl_headpack.py's `run_v0` and `run_v1`):
// their C entry points. Both run headpack_hopper.cuh's wgmma body, `headpack_wgmma_kernel<G>`
// (G = 1 for P1, 3 for P2), on every shape; the note there gives the TPU kernels replaced,
// the bound, the design and the measured times.

#include <cuda_runtime.h>

#include "headpack_hopper.cuh"

extern "C" {

// q, k, v, o: bfloat16 [batch, t, h], contiguous, 8-byte aligned, h = heads x 36. P1 writes
// every head's columns of o; P2 (groups of 3) those of heads 0 .. 3 floor(heads / 3) - 1
// and leaves the rest of o as it was. Return a cudaError_t (0 on success).
int wm_headpack_v0(const void* q, const void* k, const void* v, void* o, int batch, int t,
                   int h, void* stream) {
  return headpack_hopper::launch<1>(q, k, v, o, batch, t, h, static_cast<cudaStream_t>(stream));
}

int wm_headpack_v1(const void* q, const void* k, const void* v, void* o, int batch, int t,
                   int h, void* stream) {
  return headpack_hopper::launch<3>(q, k, v, o, batch, t, h, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
