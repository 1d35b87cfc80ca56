// Cost micro-probes of the trace kernel's ingredients, for Hopper (sm_90a).
//
// Replaces the JAX package's TPU probes (tools/r5prim.py: build, eight
// kernels behind one pl.pallas_call). Each probe is one block of 1024
// threads, the (8, 128) tile of the TPU version with one lane per thread,
// and runs a loop of n_iter iterations whose every body depends on the
// carried accumulator, so that the compiler can neither hoist nor fold an
// iteration (`#pragma unroll 1` keeps the loop a loop). The time of one
// iteration is the cost of the ingredient on this card:
//
//   gate_full    slab against 6 box scalars in shared memory, an OR over
//                the block (__syncthreads_or), a uniform branch that
//                updates buf
//   gate_nowhen  the same without the branch
//   gate_nored   the slab alone
//   reduce_rt    a max over all 1024 lanes: warp shuffles, then shared
//   when_rt      a branch on a scalar integer predicate
//   sweep16      16 Moller-Trumbore-shaped tests against shared scalars
//   fori_chain   scalar integer arithmetic only (the loop floor)
//   dynread7     7 dynamically indexed reads per iteration from an
//                (8, 7, 8, 128) float table (224 KiB): in opt-in dynamic
//                shared memory when the card allows a block that much,
//                else in device memory; `*where` reports which
//
// Each probe computes exactly what its TPU version computes for the same
// (x, n_iter), with two deliberate differences that the plain PyTorch
// version (rrt_tpu_torch/tools/r5prim.py) shares: pl.reciprocal(approx=
// True) is the IEEE reciprocal, and dynread7's table, which the TPU
// version reads without ever writing, is initialised from x:
// wc[w, c] = x * (float)(1e-4 * (7 w + c + 1)).
//
// What bounds it: latency. One block on one SM; the loop carries one
// value, so each iteration waits for the last, and the barriers of the
// reducing probes wait for all 32 warps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false (each multiply and add rounds on its own, as in the
// plain version).

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 8 * 128;
constexpr int WSM = 32 * 8;        // (32, 8) box scalars
constexpr int RED = 64;            // 32 warp maxima and the block's
constexpr int WC = 8 * 7 * TILE;   // the dynread7 table
constexpr int SMEM_BASE = (WSM + RED) * sizeof(float);
constexpr int SMEM_WC = WC * sizeof(float);

enum Probe {
  GATE_FULL = 0, GATE_NOWHEN, GATE_NORED, REDUCE_RT, WHEN_RT, SWEEP16,
  FORI_CHAIN, DYNREAD7, N_PROBES
};

// NaN-propagating min/max: jnp.minimum / torch.minimum semantics
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// Does the ray (p, 1/p) reach box k of the table, at t >= 0?
__device__ __forceinline__ bool slab(const float* wsm, int k, float px,
                                  float py, float pz) {
  const float ix = 1.0f / px, iy = 1.0f / py, iz = 1.0f / pz;
  const float* b = wsm + 8 * k;
  const float tx0 = (b[0] - px) * ix, tx1 = (b[3] - px) * ix;
  const float ty0 = (b[1] - py) * iy, ty1 = (b[4] - py) * iy;
  const float tz0 = (b[2] - pz) * iz, tz1 = (b[5] - pz) * iz;
  const float tmn = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)), nmin(tz0, tz1));
  const float tmx = nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)), nmax(tz0, tz1));
  return (tmn <= tmx) && (tmx >= 0.0f);
}

template <int P>
__device__ float gate(const float* wsm, float xv, int n_iter) {
  float acc = xv, buf = xv;
#pragma unroll 1
  for (int i = 0; i < n_iter; ++i) {
    const bool r = slab(wsm, i % 32, acc, acc + 0.5f, acc + 1.0f);
    if (P == GATE_NORED) {
      acc = acc * 0.9999f + (r ? 1.0f : 0.0f);
      continue;
    }
    const bool pred = __syncthreads_or(r);
    if (P == GATE_NOWHEN) {
      acc = acc * 0.9999f + (pred ? 0.001f : 0.002f);
    } else {
      if (pred) buf = buf * 0.9999f + 0.001f;
      acc = acc * 0.9999f + 0.0001f;
    }
  }
  return acc + buf;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = nmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ float reduce_rt(float* red, float xv, int n_iter) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float acc = xv;
#pragma unroll 1
  for (int i = 0; i < n_iter; ++i) {
    const float m = warp_max(acc);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    if (warp == 0) {
      const float b = warp_max(red[lane]);
      if (lane == 0) red[32] = b;
    }
    __syncthreads();
    acc = acc * 0.9999f + red[32] * 1e-6f;
  }
  return acc;
}

__device__ float when_rt(float xv, int n_iter) {
  float buf = xv;
  int a = 3;
#pragma unroll 1
  for (int i = 0; i < n_iter; ++i) {
    if (a % 3 == 0) buf = buf * 0.9999f + 0.001f;
    a = a * 7 % 1001;
  }
  return buf;
}

__device__ float sweep16(const float* wsm, float xv, int n_iter) {
  float acc = xv;
#pragma unroll 1
  for (int i = 0; i < n_iter; ++i) {
    float bt = acc;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const float f = wsm[8 * t];
      const float sx = acc - f;
      const float sy = (acc - f) - 1.0f;
      const float sz = (acc - f) - 2.0f;
      const float s1x = sy * 2.0f - sz;
      const float s1y = sz * 2.0f - sx;
      const float s1z = sx * 2.0f - sy;
      const float den = s1x + s1y * 2.0f + s1z;
      const float inv = 1.0f / (den != 0.0f ? den : 1.0f);
      const float tt = (s1x * sx + s1y * sy + s1z * sz) * inv;
      const bool ok = (tt >= 0.0f) && (tt <= 10.0f) && (den != 0.0f);
      bt = nmin(bt, ok ? tt : 3e37f);
    }
    acc = bt * 0.999f + 0.01f;
  }
  return acc;
}

__device__ float fori_chain(int n_iter) {
  int a = 3;
#pragma unroll 1
  for (int i = 0; i < n_iter; ++i) a = a * 7 % 1001 + i % 3;
  return static_cast<float>(a);
}

__device__ float dynread7(float* wc, float xv, int n_iter) {
  const int t = threadIdx.x;
  // each thread writes and reads only its own lane: no barrier needed
  for (int w = 0; w < 8; ++w)
    for (int c = 0; c < 7; ++c)
      wc[(7 * w + c) * TILE + t] =
          xv * static_cast<float>(1e-4 * (7 * w + c + 1));
  float acc = xv;
#pragma unroll 1
  for (int i = 0; i < n_iter; ++i) {
    const float* row = wc + 7 * (i % 8) * TILE + t;
#pragma unroll
    for (int c = 0; c < 7; ++c) acc = acc * 0.9999f + row[c * TILE];
  }
  return acc;
}

template <int P>
__global__ void __launch_bounds__(TILE)
    r5prim_kernel(const float* __restrict__ x, float* __restrict__ out,
                  float* wc_device, int n_iter, int wc_shared) {
  extern __shared__ float smem[];
  float* wsm = smem;
  float* red = smem + WSM;
  const int t = threadIdx.x;
  // the box table from the input, so that nothing is a compile-time
  // constant: rows k = 0..31, lo = x0 * 0.1 - 1 - 0.01 k, hi = x0 * 0.1 +
  // 1 + 0.01 k in all three axes
  if (t < 32) {
    const float base = x[0] * 0.1f;
    const float off = static_cast<float>(0.01 * t);
    for (int c = 0; c < 3; ++c) {
      wsm[8 * t + c] = (base - 1.0f) - off;
      wsm[8 * t + c + 3] = (base + 1.0f) + off;
    }
  }
  __syncthreads();
  const float xv = x[t];
  float res;
  if constexpr (P == GATE_FULL || P == GATE_NOWHEN || P == GATE_NORED)
    res = gate<P>(wsm, xv, n_iter);
  else if constexpr (P == REDUCE_RT)
    res = reduce_rt(red, xv, n_iter);
  else if constexpr (P == WHEN_RT)
    res = when_rt(xv, n_iter);
  else if constexpr (P == SWEEP16)
    res = sweep16(wsm, xv, n_iter);
  else if constexpr (P == FORI_CHAIN)
    res = fori_chain(n_iter);
  else
    res = dynread7(wc_shared ? smem + WSM + RED : wc_device, xv, n_iter);
  out[t] = res;
}

template <int P>
cudaError_t launch(const float* x, float* out, float* wc_device, int n_iter,
                   int device, int* where, cudaStream_t stream) {
  int smem = SMEM_BASE, wc_shared = 0;
  if (P == DYNREAD7) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    if (SMEM_BASE + SMEM_WC <= optin) {
      smem += SMEM_WC;
      wc_shared = 1;
      err = cudaFuncSetAttribute(r5prim_kernel<P>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
    } else if (wc_device == nullptr) {
      return cudaErrorInvalidValue;
    }
  }
  *where = wc_shared;
  r5prim_kernel<P><<<1, TILE, smem, stream>>>(x, out, wc_device, n_iter,
                                              wc_shared);
  return cudaGetLastError();
}

}  // namespace

// Launches probe `probe` (the Probe order above) for n_iter iterations on
// `stream`: x and out are device memory of one (8, 128) float tile,
// wc_device an (8, 7, 8, 128) float table in device memory used by
// dynread7 only when shared memory cannot hold it. Writes 1 to *where
// when the table went to shared memory, 0 otherwise. Returns the launch's
// cudaGetLastError().
extern "C" int rrt_r5prim(int probe, const float* x, float* out,
                          float* wc_device, int n_iter, int device,
                          int* where, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *where = 0;
  switch (probe) {
    case GATE_FULL:
      err = launch<GATE_FULL>(x, out, wc_device, n_iter, device, where, s);
      break;
    case GATE_NOWHEN:
      err = launch<GATE_NOWHEN>(x, out, wc_device, n_iter, device, where, s);
      break;
    case GATE_NORED:
      err = launch<GATE_NORED>(x, out, wc_device, n_iter, device, where, s);
      break;
    case REDUCE_RT:
      err = launch<REDUCE_RT>(x, out, wc_device, n_iter, device, where, s);
      break;
    case WHEN_RT:
      err = launch<WHEN_RT>(x, out, wc_device, n_iter, device, where, s);
      break;
    case SWEEP16:
      err = launch<SWEEP16>(x, out, wc_device, n_iter, device, where, s);
      break;
    case FORI_CHAIN:
      err = launch<FORI_CHAIN>(x, out, wc_device, n_iter, device, where, s);
      break;
    case DYNREAD7:
      err = launch<DYNREAD7>(x, out, wc_device, n_iter, device, where, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* rrt_r5prim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
