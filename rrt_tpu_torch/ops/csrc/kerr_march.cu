// The Kerr march of a batch of lanes to its end, for Hopper (sm_90a): RK4
// steps of Hamilton's equations of the Kerr–Schild Hamiltonian against a
// thin emissive disk, one thread a lane.
//
// Replaces no Pallas kernel. It stands in for the JAX package's jitted
// `lax.scan` over RK4 steps whose ∂ℋ is `jax.grad` of ℋ
// (rrt_tpu/render/kerr_scene.py:186, rrt_tpu/physics/kerr.py:121), which
// the port first ran as ~840 small PyTorch kernels a step (autograd's ∂ℋ),
// replayed in CUDA graphs of 20-step blocks.
//
// Bound by float32 instruction throughput: a live step is ~600
// operations on 7 floats of state, and the lanes' state is read once and
// written once. Two things kept the card idle before, and the design
// answers both:
//   launches: the whole march of a batch is one launch; each thread keeps
//     its lane's state in registers for every step, and ∂ℋ/∂p and ∂ℋ/∂x
//     are written out by hand (`rhs`), not taken by autograd;
//   dead lanes: a lane stops at the step where it is captured, escapes or
//     meets the disk, where the step-by-step march kept stepping it with a
//     zero step to the last step. A warp runs until its slowest lane
//     settles; `issued` counts the lane-slots the warps stepped (32 × the
//     most steps a lane of the warp ran, one warp-max and one atomic a
//     warp), so that the live steps over it say how much divergence costs.
//
// Every operation is the plain version's (`physics/kerr._rhs`,
// `render/kerr_scene._disk_step`), in its order, and the library is
// built with --fmad=false and IEEE division and square root, so the two
// round alike. Constants are written as double literals cast to float, as
// PyTorch casts a Python number. The disk's profile (r_in / r)^q is powf,
// which PyTorch's pow of two float tensors also calls on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr unsigned FULL = 0xFFFFFFFFu;

constexpr float K_STEP = static_cast<float>(0.18);
constexpr float K_STEP_MIN = static_cast<float>(0.02);
constexpr float K_EPS30 = static_cast<float>(1e-30);
constexpr float K_EPS20 = static_cast<float>(1e-20);
constexpr float K_FLOOR = static_cast<float>(1e-3);

// the hole, the disk and the radii, read once on the host
struct Hole {
  float mass, a, rh, capture2, escape2, r_in, r_out, q, e0, e1, e2;
  int beaming;
};

Hole make_hole(const float* h, int beaming) {
  return Hole{h[0], h[1], h[2], h[3], h[4],  h[5],
              h[6], h[7], h[8], h[9], h[10], beaming};
}

struct Deriv {
  float x, y, z, px, py, pz;
};

// PyTorch's clamp: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

__device__ __forceinline__ float clamp_range(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// physics/kerr._kerr_r2
__device__ float kerr_r2(float x, float y, float z, float a) {
  float rho2 = x * x + y * y + z * z;
  float b = rho2 - a * a;
  return 0.5f * b + sqrtf(0.25f * b * b + a * a * z * z + K_EPS30);
}

// physics/kerr._rhs: (∂ℋ/∂p, −∂ℋ/∂x) at (x, p), its derivation there
__device__ Deriv rhs(float x, float y, float z, float px, float py,
                     float pz, float pt, float mass, float a) {
  float a2 = a * a;
  float az2 = a2 * z * z;
  float b = x * x + y * y + z * z - a2;
  float d = sqrtf(0.25f * b * b + az2 + K_EPS30);
  float r2 = 0.5f * b + d;
  float r = sqrtf(r2);
  float den = r2 * r2 + az2 + K_EPS30;
  float h = mass * r2 * r / den;
  float s = r2 + a2;
  float lx = (r * x + a * y) / s;
  float ly = (r * y - a * x) / s;
  float rz = clamp_min(r, K_EPS20);
  float lz = z / rz;
  float lp = -pt + px * lx + py * ly + pz * lz;
  float c = 2.0f * h * lp;
  float f = 1.0f + b / (d + d);
  float gx = f * x;
  float gy = f * y;
  float gz = (f + a2 / d) * z;
  float hr = h * (1.5f * den - 2.0f * r2 * r2) / (r2 * den);
  float k = (px * x + py * y - 2.0f * r * (px * lx + py * ly)) /
                (2.0f * r * s) -
            pz * lz / (2.0f * r * rz);
  float w = lp * lp * hr + c * k;
  Deriv out;
  out.x = px - c * lx;
  out.y = py - c * ly;
  out.z = pz - c * lz;
  out.px = w * gx + c * (r * px - a * py) / s;
  out.py = w * gy + c * (r * py + a * px) / s;
  out.pz = w * gz + c * pz / rz - lp * lp * (2.0f * h * a2 * z / den);
  return out;
}

// render/kerr_scene._doppler_g: g of a Keplerian emitter at (x, y, 0)
__device__ float doppler_g(float x, float y, float px, float py,
                           float mass, float a) {
  float r = sqrtf(clamp_min(x * x + y * y, K_EPS20));
  float sq_m = sqrtf(mass);
  float r15 = r * sqrtf(r);
  float omega = sq_m / (r15 + a * sq_m);
  float ut_inner = 1.0f - 3.0f * mass / r + 2.0f * a * sq_m / r15;
  float ut = 1.0f / sqrtf(clamp_min(ut_inner, K_FLOOR));
  float lz = x * py - y * px;
  float denom = ut * (1.0f - omega * lz);
  return 1.0f / clamp_min(denom, K_FLOOR);
}

// one lane's march; returns the steps it ran (begun not yet settled)
__device__ int march_lane(float* x3, float* p3, float pt, bool& captured,
                          bool& escaped, float* acc, bool& hit,
                          int n_steps, const Hole& k) {
  float x = x3[0], y = x3[1], z = x3[2];
  float px = p3[0], py = p3[1], pz = p3[2];
  int steps = 0;
  for (; steps < n_steps; ++steps) {
    if (captured || escaped || hit) break;
    // adaptive step: fine near the hole, coarse far away
    float r = sqrtf(kerr_r2(x, y, z, k.a));
    float dl = clamp_range(K_STEP * (r - 0.5f * k.rh), K_STEP_MIN, 2.0f);
    float half = 0.5f * dl;
    Deriv k1 = rhs(x, y, z, px, py, pz, pt, k.mass, k.a);
    Deriv k2 = rhs(x + half * k1.x, y + half * k1.y, z + half * k1.z,
                   px + half * k1.px, py + half * k1.py, pz + half * k1.pz,
                   pt, k.mass, k.a);
    Deriv k3 = rhs(x + half * k2.x, y + half * k2.y, z + half * k2.z,
                   px + half * k2.px, py + half * k2.py, pz + half * k2.pz,
                   pt, k.mass, k.a);
    Deriv k4 = rhs(x + dl * k3.x, y + dl * k3.y, z + dl * k3.z,
                   px + dl * k3.px, py + dl * k3.py, pz + dl * k3.pz, pt,
                   k.mass, k.a);
    float h6 = dl / 6.0f;
    float nx = x + h6 * (k1.x + 2.0f * k2.x + 2.0f * k3.x + k4.x);
    float ny = y + h6 * (k1.y + 2.0f * k2.y + 2.0f * k3.y + k4.y);
    float nz = z + h6 * (k1.z + 2.0f * k2.z + 2.0f * k3.z + k4.z);
    float npx = px + h6 * (k1.px + 2.0f * k2.px + 2.0f * k3.px + k4.px);
    float npy = py + h6 * (k1.py + 2.0f * k2.py + 2.0f * k3.py + k4.py);
    float npz = pz + h6 * (k1.pz + 2.0f * k2.pz + 2.0f * k3.pz + k4.pz);
    float nr2 = kerr_r2(nx, ny, nz, k.a);
    captured = nr2 <= k.capture2;
    escaped = nr2 > k.escape2;
    // the disk: the chord's z changes sign within [r_in, r_out]
    if (z * nz < 0.0f) {
      float dz = z - nz;
      float s = z / (fabsf(dz) > K_EPS20 ? dz : 1.0f);
      float cx = x + s * (nx - x);
      float cy = y + s * (ny - y);
      float cr = sqrtf(clamp_min(cx * cx + cy * cy, K_EPS20));
      if (cr >= k.r_in && cr <= k.r_out) {
        hit = true;
        float profile = powf(k.r_in / cr, k.q);
        float boost = 1.0f;
        if (k.beaming) {
          float g = doppler_g(cx, cy, npx, npy, k.mass, k.a);
          float g2 = g * g;
          boost = g2 * g2;
        }
        float pb = profile * boost;
        acc[0] = k.e0 * pb;
        acc[1] = k.e1 * pb;
        acc[2] = k.e2 * pb;
      }
    }
    x = nx, y = ny, z = nz;
    px = npx, py = npy, pz = npz;
  }
  x3[0] = x, x3[1] = y, x3[2] = z;
  p3[0] = px, p3[1] = py, p3[2] = pz;
  return steps;
}

__global__ void __launch_bounds__(THREADS)
    march_kernel(float* __restrict__ x, float* __restrict__ p,
                 const float* __restrict__ pt, uint8_t* __restrict__ captured,
                 uint8_t* __restrict__ escaped, float* __restrict__ acc,
                 uint8_t* __restrict__ hit, int32_t* __restrict__ settled,
                 unsigned long long* issued, unsigned long long* runs,
                 long long n, int n_steps, Hole k) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  int steps = 0;
  if (i < n) {
    bool cap = captured[i] != 0, esc = escaped[i] != 0, h = hit[i] != 0;
    float a3[3] = {acc[3 * i], acc[3 * i + 1], acc[3 * i + 2]};
    steps = march_lane(x + 3 * i, p + 3 * i, pt[i], cap, esc, a3, h,
                       n_steps, k);
    captured[i] = cap;
    escaped[i] = esc;
    hit[i] = h;
    acc[3 * i] = a3[0], acc[3 * i + 1] = a3[1], acc[3 * i + 2] = a3[2];
    settled[i] = n_steps - steps;
  }
  // every thread of the warp reaches here, those past n with 0 steps
  const unsigned most = __reduce_max_sync(FULL, static_cast<unsigned>(steps));
  if ((threadIdx.x & 31) == 0 && most > 0)
    atomicAdd(issued, 32ull * most);
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(runs, 1ull);
}

unsigned grid(long long n) {
  return static_cast<unsigned>(n > 0 ? (n + THREADS - 1) / THREADS : 1);
}

cudaError_t set_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// March n lanes (x, p: (n, 3) float32; pt, acc (n, 3): float32;
// captured, escaped, hit: (n,) bool bytes) up to n_steps steps each, in
// place; settled (n,) int32 gets the steps each lane began settled;
// `issued` (one uint64) gains the lane-slots the warps stepped, `runs`
// (one uint64) one. `hole` holds 11 floats: mass, spin, r_h, the capture
// and escape radii squared, r_in, r_out, q and the emission's 3 channels.
// Launches one kernel on `stream` of `device`; returns cudaGetLastError().
extern "C" int rrt_kerr_march(float* x, float* p, const float* pt,
                              uint8_t* captured, uint8_t* escaped,
                              float* acc, uint8_t* hit, int32_t* settled,
                              unsigned long long* issued,
                              unsigned long long* runs, long long n,
                              int n_steps, const float* hole, int beaming,
                              int device, void* stream) {
  if (n < 0 || n_steps < 0 || hole == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  march_kernel<<<grid(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, p, pt, captured, escaped, acc, hit, settled, issued, runs, n,
      n_steps, make_hole(hole, beaming));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rrt_kerr_march_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
