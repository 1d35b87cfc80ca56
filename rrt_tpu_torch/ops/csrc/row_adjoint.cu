// Row adjoints of a gather, for Hopper (sm_90a): the gradient of
// `table.<field>[ids]` with respect to the table, for every field of one
// gather at once, summed in a fixed order.
//
// Replaces no TPU kernel. The JAX package's BSDF gathers
// (rrt_tpu/render/bsdf.py `_gather`) take their adjoints from XLA's
// scatter-add; the port's from autograd's advanced indexing, whose
// backward is `index_put_(accumulate=True)`: one sort of every lane id
// and a serial sum of each run of equal ids, a launch a field. A gather of
// a lane batch onto a material table of a handful of rows is the worst
// case of that design (a few runs, each tens of thousands of lanes long).
//
// Bound by bytes: a lane reads its id (8 bytes) and its gradient columns
// (4 bytes each, at most 17 for the BSDF table), and the rows written are
// a few hundred bytes. So one pass reads every lane once, coalesced, and
// keeps every partial sum on chip:
//   rrt_row_adjoint launches two kernels on `stream`.
//   partials: each block takes a contiguous slice of the lanes; each warp
//     walks its 32-lane chunks of the slice. A chunk's gradients are read
//     at once, coalesced, into the warp's staging area in shared memory
//     (so that one chunk waits on memory once, not once a column). Then
//     lane c of the warp walks column c down the chunk's lanes in order
//     and adds each run of lanes of one row to the warp's own partial of
//     (row, column), in shared memory (or, where the warps' partials of
//     every row and column would not fit beside the staging in 48 KB, in
//     the block's slice of a global workspace). The block then sums its
//     warps' partials in warp order into its row of `block_sums`.
//   finish: one thread a (row, column) sums the blocks' rows in block
//     order and writes the field's output; thread 0 adds one run and the
//     lanes to `counts` (integer atomics).
// No float atomics anywhere: every sum is taken in an order fixed by the
// grid, so the result is the same bits at every run. Ids are clamped into
// [0, rows - 1], as the gather clamps them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_FIELDS = 8;
constexpr int MAX_COLUMNS = 32;   // a warp's staging: 4 KB
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Fields {
  const float* grad[MAX_FIELDS];  // (n, width) row-major, a field's gradient
  float* out[MAX_FIELDS];         // (rows, width) row-major, its adjoint
  int width[MAX_FIELDS];
  int col[MAX_FIELDS];            // its first column among all the fields'
  int n_fields;
  int cols;                       // the fields' widths summed
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
    partials_kernel(const int64_t* __restrict__ ids, long long n,
                    long long per_block, int rows, Fields f,
                    float* __restrict__ block_sums,
                    float* __restrict__ warp_partials) {
  // shared: each warp's staged chunk (32 x cols floats), then, unless
  // they live in `warp_partials`, each warp's partials (rows x cols)
  extern __shared__ float smem[];
  const int cols = f.cols, slots = rows * cols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* stage = smem + warp * 32 * cols;
  float* acc = warp_partials
                   ? warp_partials + static_cast<size_t>(blockIdx.x) * WARPS *
                                         slots
                   : smem + WARPS * 32 * cols;
  for (int s = threadIdx.x; s < WARPS * slots; s += THREADS) acc[s] = 0.f;
  __syncthreads();
  float* mine = acc + warp * slots;
  const long long lo = static_cast<long long>(blockIdx.x) * per_block;
  const long long hi = lo + per_block < n ? lo + per_block : n;
  for (long long base = lo + warp * 32; base < hi; base += THREADS) {
    const int valid = hi - base < 32 ? static_cast<int>(hi - base) : 32;
    int row = 0;
    if (lane < valid) {
      const long long v = ids[base + lane];
      row = v < 0 ? 0 : v >= rows ? rows - 1 : static_cast<int>(v);
    }
    // the chunk's gradients, read as each field's contiguous run of
    // width x 32 floats (every load issued before any is used), into
    // stage[lane of the chunk][column]
    for (int k = 0; k < f.n_fields; ++k) {
      const int w = f.width[k];
      const float* g = f.grad[k] + base * w;
      for (int e = lane; e < w * valid; e += 32)
        stage[(e / w) * cols + f.col[k] + e % w] = g[e];
    }
    __syncwarp();
    // lane c walks column c down the chunk's lanes in order, summing in a
    // register while the row stays the same (the ids of a batch of
    // neighbouring pixels mostly do)
    int cur = __shfl_sync(FULL, row, 0);
    float run = 0.f;
    for (int l = 0; l < valid; ++l) {
      const int r = __shfl_sync(FULL, row, l);
      if (r != cur) {
        if (lane < cols) mine[cur * cols + lane] += run;
        run = 0.f;
        cur = r;
      }
      if (lane < cols) run += stage[l * cols + lane];
    }
    if (lane < cols) mine[cur * cols + lane] += run;
    __syncwarp();
  }
  __syncthreads();
  for (int s = threadIdx.x; s < slots; s += THREADS) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += acc[w * slots + s];
    block_sums[static_cast<size_t>(blockIdx.x) * slots + s] = t;
  }
}

__global__ void __launch_bounds__(THREADS)
    finish_kernel(const float* __restrict__ block_sums, int blocks, int rows,
                  Fields f, long long n, unsigned long long* counts) {
  const int slots = rows * f.cols;
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s == 0) {
    atomicAdd(counts, 1ull);
    atomicAdd(counts + 1, static_cast<unsigned long long>(n));
  }
  if (s >= slots) return;
  float t = 0.f;
  for (int b = 0; b < blocks; ++b)
    t += block_sums[static_cast<size_t>(b) * slots + s];
  const int r = s / f.cols, c = s - r * f.cols;
  int k = 0;
  while (k + 1 < f.n_fields && f.col[k + 1] <= c) ++k;
  f.out[k][r * f.width[k] + (c - f.col[k])] = t;
}

cudaError_t set_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// The row adjoints of n lanes onto `rows` rows for n_fields fields
// (n_fields <= 8): out[k][r, :] = the sum of grads[k][i, :] over the lanes
// i whose id, clamped into [0, rows - 1], is r. `grads`, `outs` and
// `widths` are host arrays of the fields' device pointers and widths.
// `blocks` blocks of 256 threads; `block_sums` holds blocks x rows x
// (widths summed, at most 32) floats; `warp_partials` is null when the 8
// warps' staging and partials fit in 48 KB of shared memory, else a
// workspace of 8 times `block_sums`.
// `counts` (2 uint64 on the device) gets one run and n lanes. Launches on
// `stream` of `device`; returns cudaGetLastError().
extern "C" int rrt_row_adjoint(const int64_t* ids, long long n, int rows,
                               int n_fields, const float* const* grads,
                               float* const* outs, const int* widths,
                               int blocks, float* block_sums,
                               float* warp_partials,
                               unsigned long long* counts, int device,
                               void* stream) {
  int cols = 0;
  for (int k = 0; k < n_fields && k < MAX_FIELDS; ++k) cols += widths[k];
  if (n_fields < 1 || n_fields > MAX_FIELDS || rows < 1 || blocks < 1 ||
      cols > MAX_COLUMNS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Fields f{};
  for (int k = 0, c = 0; k < n_fields; c += widths[k++]) {
    f.grad[k] = grads[k];
    f.out[k] = outs[k];
    f.width[k] = widths[k];
    f.col[k] = c;
  }
  f.n_fields = n_fields;
  f.cols = cols;
  // a slice of whole warps' chunks a block
  long long per_block = (n + blocks - 1) / blocks;
  per_block = (per_block + 31) / 32 * 32;
  const size_t shared =
      sizeof(float) * WARPS * cols * (32 + (warp_partials ? 0 : rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  partials_kernel<<<blocks, THREADS, shared, s>>>(
      ids, n, per_block, rows, f, block_sums, warp_partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = rows * cols;
  finish_kernel<<<(slots + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      block_sums, blocks, rows, f, n, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rrt_row_adjoint_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
