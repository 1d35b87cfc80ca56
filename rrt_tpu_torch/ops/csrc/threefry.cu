// Threefry-2x32 random streams for Hopper (sm_90a): the uniforms and the
// derived keys of the port's every draw, bit for bit those of jax.random.
//
// Replaces XLA's threefry2x32 under jax.random (jax/_src/prng.py,
// `_threefry2x32_lowering`, `_threefry_random_bits_partitionable`,
// `_threefry_split_foldlike`, `threefry_fold_in`; random.py `_uniform`),
// which the JAX package reaches at every draw (e.g.
// rrt_tpu/render/integrator.py:194) and which is no Pallas kernel.
//
// Bound by operations: a uniform costs one hash, 20 rounds of an add, a
// rotate and a xor with 5 key injections, about 80 32-bit integer
// operations and a float subtraction, against 4 bytes written. So one thread
// computes one element in registers from its global flat index and writes
// it once: no shared memory, no reads but the key. The rotates are
// funnel shifts. `torch.rand` at the same shape (Philox) is the yardstick
// of speed; the port never calls it.
//
// Two entries, each one launch:
//   rrt_threefry_uniform: out[b, j] for every key b and every element j
//     of the block [lo, lo + width) along one axis of a draw whose axis
//     holds n_axis elements; the element's counter is its flat index g in
//     the whole draw, (g >> 32, g & 0xFFFFFFFF), so that the blocks of all
//     ranks put together equal the whole draw.
//   rrt_threefry_keys: out[b, i] = threefry2x32(key b, (0, c + i)) with
//     c = offset + *data (data read from device memory when given), the
//     keys of split (c = 0) and of fold_in (one key).
// Keys are int64 pairs holding uint32 words, read from device memory, so
// that a replayed CUDA graph uses the key its pass derived on the device.
// Each kernel adds one to its run counter (`runs[0]` uniform, `runs[1]`
// keys) from thread 0 of block 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, r1); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, r2); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, r3); x1 ^= x0;
}

// threefry2x32 of the counters (x0, x1) under the key (k0, k1), in place
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
}

// Index: uint32_t while the draw and the output stay below 2^32 elements,
// else uint64_t
template <typename Index>
__global__ void __launch_bounds__(THREADS)
    uniform_kernel(const int64_t* __restrict__ keys, Index total,
                   Index per_key, Index inner, Index width, Index n_axis,
                   Index lo, float* __restrict__ out,
                   unsigned long long* runs) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(runs, 1ull);
  const Index stride = static_cast<Index>(gridDim.x) * THREADS;
  for (Index j = static_cast<Index>(blockIdx.x) * THREADS + threadIdx.x;
       j < total; j += stride) {
    const Index b = j / per_key;
    const Index r = j - b * per_key;
    Index g = r;
    if (width != n_axis) {            // a block of the axis: its flat index
      const Index t = r / inner;
      const Index i = r - t * inner;
      const Index outer = t / width;
      const Index a = t - outer * width;
      g = (outer * n_axis + lo + a) * inner + i;
    }
    uint32_t x0 = static_cast<uint32_t>(static_cast<uint64_t>(g) >> 32);
    uint32_t x1 = static_cast<uint32_t>(g);
    threefry2x32(static_cast<uint32_t>(keys[2 * b]),
                 static_cast<uint32_t>(keys[2 * b + 1]), x0, x1);
    out[j] = __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
    keys_kernel(const int64_t* __restrict__ keys, int total, int count,
                const int64_t* __restrict__ data, uint32_t offset,
                int64_t* __restrict__ out, unsigned long long* runs) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(runs + 1, 1ull);
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= total) return;
  const int b = j / count;
  const uint32_t c = offset + static_cast<uint32_t>(j - b * count) +
                     (data ? static_cast<uint32_t>(data[0]) : 0u);
  uint32_t x0 = 0u, x1 = c;
  threefry2x32(static_cast<uint32_t>(keys[2 * b]),
               static_cast<uint32_t>(keys[2 * b + 1]), x0, x1);
  out[2 * j] = x0;
  out[2 * j + 1] = x1;
}

cudaError_t set_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

template <typename Index>
void launch_uniform(const int64_t* keys, Index total, Index per_key,
                    Index inner, Index width, Index n_axis, Index lo,
                    float* out, unsigned long long* runs,
                    cudaStream_t stream) {
  // a grid-stride loop over at most 132 SMs x 16 resident blocks a wave
  const uint64_t need = (static_cast<uint64_t>(total) + THREADS - 1) / THREADS;
  const unsigned grid = static_cast<unsigned>(need < 132 * 16 * 8 ? need
                                                                   : 132 * 16 * 8);
  uniform_kernel<Index><<<grid, THREADS, 0, stream>>>(
      keys, total, per_key, inner, width, n_axis, lo, out, runs);
}

}  // namespace

// Uniforms of n_keys keys (int64 pairs), per_key elements each: the block
// [lo, lo + width) along an axis of n_axis elements, `inner` elements
// after it. `wide` != 0 when the draw or the output holds 2^32 elements
// or more (64-bit indexing). Launches on `stream` of `device`; returns
// cudaGetLastError().
extern "C" int rrt_threefry_uniform(const int64_t* keys, long long n_keys,
                                    long long per_key, long long inner,
                                    long long width, long long n_axis,
                                    long long lo, int wide, float* out,
                                    unsigned long long* runs, int device,
                                    void* stream) {
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    launch_uniform<uint64_t>(keys, n_keys * per_key, per_key, inner, width,
                             n_axis, lo, out, runs, s);
  else
    launch_uniform<uint32_t>(
        keys, static_cast<uint32_t>(n_keys * per_key),
        static_cast<uint32_t>(per_key), static_cast<uint32_t>(inner),
        static_cast<uint32_t>(width), static_cast<uint32_t>(n_axis),
        static_cast<uint32_t>(lo), out, runs, s);
  return static_cast<int>(cudaGetLastError());
}

// count derived keys of each of n_keys keys: out[b, i] = threefry2x32(key
// b, (0, offset + i + *data)), data a device int64 or null.
extern "C" int rrt_threefry_keys(const int64_t* keys, int n_keys, int count,
                                 const int64_t* data, unsigned offset,
                                 int64_t* out, unsigned long long* runs,
                                 int device, void* stream) {
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n_keys * count;
  keys_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(keys, total, count, data,
                                                     offset, out, runs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rrt_threefry_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
