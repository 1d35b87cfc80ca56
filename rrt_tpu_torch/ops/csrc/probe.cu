// The toolchain probe for Hopper (sm_90a): out = x * 2 on one (8, 128)
// float32 tile, one block of 1024 threads, one element each.
//
// Replaces the JAX bench's PROBE Pallas kernel (bench.py: PROBE, run by
// probe_pallas), whose only job is to show that the kernel compiler and
// the launch path work on this machine before the bench runs. It is bound
// by nothing: 4 KiB in, 4 KiB out, one multiply per thread.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 8 * 128;

__global__ void __launch_bounds__(TILE)
    probe_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const int i = threadIdx.x;
  out[i] = x[i] * 2.0f;
}

}  // namespace

// Launches the probe on `stream`; x and out are device memory of TILE
// floats on `device`, which is made current only when it is not. Returns
// cudaGetLastError().
extern "C" int rrt_probe(const float* x, float* out, int device,
                         void* stream) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_kernel<<<1, TILE, 0, static_cast<cudaStream_t>(stream)>>>(x, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rrt_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
