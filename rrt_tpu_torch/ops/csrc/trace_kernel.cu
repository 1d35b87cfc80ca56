// Curved and flat ray traversal for Hopper (sm_90a): persistent warps that
// take rays from a queue, and walk each chord's hierarchy lane by lane or
// cooperatively over the warp.
//
// Replaces the JAX package's fused Pallas kernel
// (rrt_tpu/ops/trace_kernel.py: pallas_trace_raw and its _kernel, in the
// lazy, windowed, any-hit and flat modes). For every ray the kernel marches
// Schwarzschild chords one Δθ step at a time (`march`, `absorb`), tests each
// chord that touches the scene bbox against the part -> supercluster ->
// cluster -> triangle hierarchy and the live spheres, and stops at the
// ray's own first event. No chord table is kept in memory: a chord is
// marched, tested and dropped. The rules are listed in
// rrt_tpu_torch/ops/trace_kernel.py, whose `trace_rays_reference` is the
// plain version this kernel must match bit for bit on calm lanes.
//
// What bounds it on the card: float32 operations, not bytes. A ray reads 32
// bytes and writes 46; the scene tables are kilobytes to a few megabytes.
// A marched chord costs ~150 operations (`march`, `absorb`, the scene-box
// slab), a box test 24, a triangle test 47. The main path's first-vertex
// shadow lane marches 22.5 chords and needs 77 box and 313 triangle tests
// (~20k operations; its counters report 214 box tests, since they count
// the empty clusters that item 3 skips), so its 4,194,304-lane launch is
// bound at 1.25 ms by the 66.9 TFLOP/s float32 peak; the 1,048,576 camera
// lanes at 0.23 ms (`tools/trace_modes.trace_work`, PERF.md). What kept
// the one-thread-per-ray kernel far from that, and what this one does
// about it:
//
//  1. Lanes end at different chords (a masked lane on its first), and a
//     warp waited for its slowest lane. Here one block per SM stays
//     resident (SMs x blocks per SM, from the occupancy query), and each
//     warp loops while the launch's queue has rays: in one step every lane
//     with a ray marches one chord; a lane whose ray ended writes its
//     outputs, and idle lanes take the next ray indices from a global
//     counter with one warp-aggregated atomicAdd: at once, or, in a warp
//     whose rays all left one point (a pinhole camera's neighbouring
//     pixels, which march in step), once the whole warp is idle
//     (`take_rays`).
//  2. Each lane walked its own passing nodes, so a warp issued the union of
//     its lanes' superclusters, clusters and triangles. With `Coop`, the
//     warp gathers (lane, node) pairs with __ballot_sync and spreads each
//     pair's children over lanes: a part's superclusters over pow2(spp)
//     lanes, a supercluster's 8 cluster boxes over 8 lanes, a cluster's
//     triangles over cs_k lanes; neighbouring lanes read neighbouring rows.
//     A triangle that hits folds (t, prim) into its owner's slot with a
//     64-bit shared-memory atomicMin on an order-preserving key, so the
//     owner gets the lowest t, then the lowest id, of the part, as the
//     one-ray loop did; parts stay in order with tmax narrowed by the
//     earlier parts, spheres last; counters are added per owning lane. It
//     pays for the deep hierarchy of a multi-part scene (3.2x on
//     `cbox_dense`) and costs more than it saves on a single-supercluster
//     scene such as the Cornell box, which the launcher walks lane by lane.
//  3. Known failures are skipped: a supercluster row carries the mask of
//     its clusters that hold any valid triangle (an empty cluster's box
//     fails every slab), a cluster row the prefix of its rows that holds
//     the valid ones. Results and counters are those of testing them all.
//  4. Tables in shared memory: the box tables (and the triangle table when
//     it fits) are copied once per resident block; a scene whose boxes do
//     not fit reads every table from device memory through L1/L2, and the
//     launcher reports which (`tables_in`). Shared memory ran 3-7% faster
//     than L1/L2 on the main path's batches and `cbox_dense` (PERF.md).
//  5. min.NaN / max.NaN single instructions in the slabs; traversal results
//     returned by value; 0 spill bytes at the widths `threads()` sets.
//
// The arithmetic of every test is unchanged. Build: nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false -shared
// -Xcompiler -fPIC (no fast math: the same IEEE operations in the same
// order as the plain version). The arithmetic lives in plain __device__
// functions: written inline in a templated kernel body, it kept nvcc's
// front end busy for minutes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float BIG = 3e37f;
constexpr int SUP = 8;
// Threads of a block, one block per SM: the per-lane traversal fits 64
// registers without spills at 1024 threads; the cooperative one keeps more
// live (up to 80 registers) and ran fastest at 640 (PERF.md, PR 3). These
// macros, and the three below, let `tools/trace_modes.py` build the
// choices the kernel makes for itself as fixed variants, to compare them.
#ifndef RRT_TRACE_LANE_THREADS
#define RRT_TRACE_LANE_THREADS 1024
#endif
#ifndef RRT_TRACE_COOP_THREADS
#define RRT_TRACE_COOP_THREADS 640
#endif
// traversal: -1 by the scene (see rrt_trace), 0 lane by lane, 1 cooperative
#ifndef RRT_TRACE_TRAVERSAL
#define RRT_TRACE_TRAVERSAL -1
#endif
// refill: 0 by the warp's rays (see take_rays), n > 0 once n lanes are idle
#ifndef RRT_TRACE_REFILL
#define RRT_TRACE_REFILL 0
#endif
// tables: the first layout tried (below), the next when it does not fit
#ifndef RRT_TRACE_LAYOUT
#define RRT_TRACE_LAYOUT 0
#endif
template <bool Coop>
__host__ __device__ constexpr int threads() {
  return Coop ? RRT_TRACE_COOP_THREADS : RRT_TRACE_LANE_THREADS;
}
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long KEY_NONE = ~0ull;

// layout of the params row (TraceTables.params), 20 floats
constexpr int P_BH = 0, P_R = 3, P_DT = 4, P_COS = 5, P_SIN = 6;
constexpr int P_GLO = 7, P_GHI = 10, P_SLO = 13, P_SHI = 16;
constexpr int N_PARAMS4 = 5;

// per-warp scratch in shared memory, in float4 units: each lane's ray and
// chord as rows (p, tmin), (u, tmax), (inv, tmax); each lane's best-hit
// key; the counters added by other lanes; three rank tables of (lane,
// node) pairs
constexpr int SCR_RAY = 0, SCR_BEST = 96, SCR_CNT = 112, SCR_RANK = 128;
constexpr int SCR = 152;

// where the tables are read from: every table in shared memory; the
// triangles in device memory and the rest in shared memory; every table in
// device memory (through L1 and L2)
constexpr int SHARED_ALL = 0, SHARED_BOXES = 1, DEVICE_ALL = 2;

struct Tables {
  const float4* params;  // (20,) floats
  const float4* tri;     // (R, 12): v0 xyz, e1 xyz, e2 xyz, valid, 0, 0
  const float4* cl;      // (K_pad, 8): lo xyz, hi xyz, valid prefix, 0
  const float4* sup;     // (K_pad / SUP, 8): ..., non-empty cluster mask, 0
  const float4* part;    // (n_parts, 8)
  const float4* sph;     // (S, 4): centre xyz, radius
  int n_parts, spp, sup_shift, cs_k, cs_shift, n_live_sph, sph_id0, n_sph;
};

// The tables as one block reads them.
struct View {
  const float4 *params, *part, *sph, *sup, *cl, *tri;
};

// One warp's scratch.
struct Scratch {
  float4* ray;
  unsigned long long* best;
  int *nis, *ncu, *rank;
};

template <bool Shared>
__device__ __forceinline__ float4 ld4(const float4* p) {
  if (Shared) return *p;
  return __ldg(p);
}

template <bool Shared>
__device__ __forceinline__ float ldf(const float* p) {
  if (Shared) return *p;
  return __ldg(p);
}

// NaN-propagating min/max: torch.minimum / jnp.minimum semantics (fminf
// would drop the NaN of a 0 * inf slab product)
__device__ __forceinline__ float nmin(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Does [tmin, tmax] of the ray touch the box (lo xyz, hi xyz)?
__device__ __forceinline__ bool slab(float lox, float loy, float loz,
                                     float hix, float hiy, float hiz,
                                     float px, float py, float pz, float ix,
                                     float iy, float iz, float tmin,
                                     float tmax) {
  const float tx0 = (lox - px) * ix, tx1 = (hix - px) * ix;
  const float ty0 = (loy - py) * iy, ty1 = (hiy - py) * iy;
  const float tz0 = (loz - pz) * iz, tz1 = (hiz - pz) * iz;
  const float tmn = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)), nmin(tz0, tz1));
  const float tmx = nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)), nmax(tz0, tz1));
  return (tmn <= tmx) && (tmn <= tmax) && (tmx >= tmin) && (tmax >= tmin);
}

// The same test against a box row (lo xyz, hi x), (hi yz, skip, 0) and a
// chord's rows (p, tmin), (inv, tmax).
__device__ __forceinline__ bool slab_row(float4 a, float4 b, float4 pt,
                                         float4 it) {
  return slab(a.x, a.y, a.z, a.w, b.x, b.y, pt.x, pt.y, pt.z, it.x, it.y,
              it.z, pt.w, it.w);
}

// Möller–Trumbore against one triangle row; writes t, returns ok.
__device__ __forceinline__ bool tri_test(float4 a, float4 b, float4 c,
                                         float px, float py, float pz,
                                         float ux, float uy, float uz,
                                         float tmin, float tmax, float& t) {
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const bool valid = c.y > 0.0f;
  const float sx = px - v0x, sy = py - v0y, sz = pz - v0z;
  const float s1x = uy * e2z - uz * e2y;
  const float s1y = uz * e2x - ux * e2z;
  const float s1z = ux * e2y - uy * e2x;
  const float s2x = sy * e1z - sz * e1y;
  const float s2y = sz * e1x - sx * e1z;
  const float s2z = sx * e1y - sy * e1x;
  const float denom = s1x * e1x + s1y * e1y + s1z * e1z;
  const bool okd = denom != 0.0f;
  const float inv = 1.0f / (okd ? denom : 1.0f);
  t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv;
  const float b1 = (s1x * sx + s1y * sy + s1z * sz) * inv;
  const float b2 = (s2x * ux + s2y * uy + s2z * uz) * inv;
  const float b0 = 1.0f - b1 - b2;
  return okd && valid && (t >= tmin) && (t <= tmax) && (b0 >= 0.0f) &&
         (b1 >= 0.0f) && (b2 >= 0.0f);
}

// Sphere row (centre, radius): near root preferred, far root accepted.
__device__ __forceinline__ bool sphere_test(float4 s, float px, float py,
                                            float pz, float ux, float uy,
                                            float uz, float tmin, float tmax,
                                            float& ts) {
  const float tx = px - s.x, ty = py - s.y, tz = pz - s.z;
  const float b = 2.0f * (tx * ux + ty * uy + tz * uz);
  const float c = tx * tx + ty * ty + tz * tz - s.w * s.w;
  const float disc = b * b - 4.0f * c;
  const bool has = (disc >= 0.0f) && (s.w > 0.0f);
  const float sq = sqrtf(has ? disc : 1.0f);
  const float t1 = (-b - sq) * 0.5f;
  const float t2 = (-b + sq) * 0.5f;
  const bool ok1 = (t1 >= tmin) && (t1 <= tmax);
  const bool ok2 = (t2 >= tmin) && (t2 <= tmax);
  ts = ok1 ? t1 : t2;
  return has && (ok1 || ok2);
}

// (t, prim) as one 64-bit key whose unsigned order is the lexicographic
// order of (t, prim); t = -0 is keyed as +0, since the first-event rule
// compares t with `<`, for which the two are equal.
__device__ __forceinline__ unsigned long long hit_key(float t, int prim) {
  unsigned u = __float_as_uint(t == 0.0f ? 0.0f : t);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned>(prim);
}

__device__ __forceinline__ float key_time(unsigned long long key) {
  const unsigned u = static_cast<unsigned>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// One chord of the geodesic march.
struct Chord {
  float dx, dy, dz;     // unit direction
  float ix, iy, iz;     // inverse direction
  float len;            // length (0 when dead)
  bool dead;            // degenerate: radial, at the centre or zero length
};

// One Δθ geodesic step from (p, u) around the hole (b, r), with cos Δθ and
// sin Δθ from the host: the op forms of trace_kernel.py:802-862.
__device__ __forceinline__ Chord march(float px, float py, float pz,
                                       float ux, float uy, float uz,
                                       float bx, float by, float bz, float r,
                                       float dt, float ct, float st) {
  const float xax = px - bx, xay = py - by, xaz = pz - bz;
  const float d2 = xax * xax + xay * xay + xaz * xaz;
  const bool at_c = d2 <= 0.0f;
  const float dist = sqrtf(at_c ? 1.0f : d2);
  const float u = 1.0f / dist;
  const float xhx = xax * u, xhy = xay * u, xhz = xaz * u;
  const float ddx = ux * xhx + uy * xhy + uz * xhz;
  const float yax = ux - ddx * xhx, yay = uy - ddx * xhy,
              yaz = uz - ddx * xhz;
  const float y2 = yax * yax + yay * yay + yaz * yaz;
  const bool dead = (y2 < 1e-24f) || at_c;
  const float rdyn = 1.0f / sqrtf(dead ? 1.0f : y2);
  const float yhx = yax * rdyn, yhy = yay * rdyn, yhz = yaz * rdyn;
  const float up = -u * ddx * rdyn;
  const float f1 = -u + 1.5f * r * u * u;
  const float u2 = u + up * dt / 2.0f;
  const float f2 = -u2 + 1.5f * r * u2 * u2;
  const float u3 = u + up * dt / 2.0f + f1 * dt * dt / 4.0f;
  const float f3 = -u3 + 1.5f * r * u3 * u3;
  const float u_new = u + up * dt + (f1 + f2 + f3) * dt * dt / 6.0f;
  const float tiny = 1e-30f;
  const float u_safe =
      fabsf(u_new) > tiny ? u_new : (u_new >= 0.0f ? tiny : -tiny);
  const float d_new = fminf(fmaxf(1.0f / u_safe, -1e9f), 1e9f);
  const float cx = bx + d_new * ct * xhx + d_new * st * yhx - px;
  const float cy = by + d_new * ct * xhy + d_new * st * yhy - py;
  const float cz = bz + d_new * ct * xhz + d_new * st * yhz - pz;
  const float c2 = cx * cx + cy * cy + cz * cz;
  const bool zl = c2 <= 0.0f;
  const float clen = sqrtf(zl ? 1.0f : c2);
  const float rclen = 1.0f / clen;
  Chord c;
  c.dx = cx * rclen;
  c.dy = cy * rclen;
  c.dz = cz * rclen;
  c.ix = 1.0f / c.dx;
  c.iy = 1.0f / c.dy;
  c.iz = 1.0f / c.dz;
  c.len = zl ? 0.0f : clen;
  c.dead = dead || zl;
  return c;
}

// Does the chord [0, len] from p along d cross the event horizon
// (trace_kernel.py:864-877)?
__device__ __forceinline__ bool absorb(float px, float py, float pz,
                                       float dx, float dy, float dz,
                                       float len, float bx, float by,
                                       float bz, float r) {
  const float tx = px - bx, ty = py - by, tz = pz - bz;
  const float b = 2.0f * (tx * dx + ty * dy + tz * dz);
  const float c = tx * tx + ty * ty + tz * tz - r * r;
  const float disc = b * b - 4.0f * c;
  const bool has = disc >= 0.0f;
  const float sq = sqrtf(has ? disc : 1.0f);
  const float t1 = (-b - sq) * 0.5f;
  const float t2 = (-b + sq) * 0.5f;
  const bool ok1 = (t1 >= 0.0f) && (t1 <= len);
  const bool ok2 = (t2 >= 0.0f) && (t2 <= len);
  return has && (ok1 || ok2) && (r > 0.0f);
}

__device__ __forceinline__ float pad_dir(float v) {
  return fabsf(v) < 1e-20f ? 1e-20f : v;
}

struct Rays {
  const float *o, *d, *min_t, *max_t;
  int n;
};

struct Out {
  bool *hit, *absd;
  float* t;
  int *prim, *seg;
  float *seg_o, *seg_d;
  int *nisect, *ncull;
};

// One ray's first event. A ray without a hit keeps its origin and padded
// direction as its segment.
__device__ __forceinline__ void finish(const Out& out, const Rays& rays,
                                       int i, bool hit, bool absd, float t,
                                       int prim, int seg, float px, float py,
                                       float pz, float dx, float dy, float dz,
                                       int nis, int ncu) {
  if (!hit) {
    px = rays.o[3 * i], py = rays.o[3 * i + 1], pz = rays.o[3 * i + 2];
    dx = pad_dir(rays.d[3 * i]), dy = pad_dir(rays.d[3 * i + 1]),
    dz = pad_dir(rays.d[3 * i + 2]);
  }
  out.hit[i] = hit;
  out.absd[i] = absd;
  out.t[i] = hit ? t : 0.0f;
  out.prim[i] = hit ? prim : -1;
  out.seg[i] = seg;
  out.seg_o[3 * i] = px;
  out.seg_o[3 * i + 1] = py;
  out.seg_o[3 * i + 2] = pz;
  out.seg_d[3 * i] = dx;
  out.seg_d[3 * i + 1] = dy;
  out.seg_d[3 * i + 2] = dz;
  out.nisect[i] = nis;
  out.ncull[i] = ncu;
}

// Copy a table into shared memory with the whole block, 16 bytes a thread.
__device__ __forceinline__ void copy4(float4* dst, const float4* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

// Stage the block's tables after the warps' scratch (cooperative
// traversal only): params, parts, spheres and the box tables unless Layout
// is DEVICE_ALL; the triangle table when Layout is SHARED_ALL. (host:
// smem_bytes)
template <int Layout, bool Coop>
__device__ __forceinline__ View stage_tables(const Tables& tb, float4* smem) {
  View v{tb.params, tb.part, tb.sph, tb.sup, tb.cl, tb.tri};
  if (Layout == DEVICE_ALL) return v;
  float4* s = smem + (Coop ? threads<Coop>() / 32 * SCR : 0);
  copy4(s, tb.params, N_PARAMS4);
  v.params = s;
  s += N_PARAMS4;
  copy4(s, tb.part, 2 * tb.n_parts);
  v.part = s;
  s += 2 * tb.n_parts;
  copy4(s, tb.sph, tb.n_sph);
  v.sph = s;
  s += tb.n_sph;
  const int n_sup = tb.n_parts * tb.spp, n_cl = n_sup * SUP;
  copy4(s, tb.sup, 2 * n_sup);
  v.sup = s;
  s += 2 * n_sup;
  copy4(s, tb.cl, 2 * n_cl);
  v.cl = s;
  s += 2 * n_cl;
  if (Layout == SHARED_ALL) {
    copy4(s, tb.tri, 3 * n_cl * tb.cs_k);
    v.tri = s;
  }
  return v;
}

// The superclusters, clusters and triangles of part p for the warp's lanes
// in R (lanes whose chord passed the part's slab), spread over the warp.
// Hits go to each owner's best-hit key, box and triangle tests to its
// counters. Every bound here is warp-uniform, so every lane reaches every
// ballot.
template <int Layout>
__device__ __forceinline__ void sweep_part(const Tables& tb, const View& v,
                                           const Scratch& w, int lane,
                                           unsigned R, int p) {
  constexpr bool BoxS = Layout != DEVICE_ALL;
  constexpr bool TriS = Layout == SHARED_ALL;
  const unsigned lt = (1u << lane) - 1u;
  int* rank0 = w.rank;
  int* rank1 = w.rank + 32;
  int* rank2 = w.rank + 64;
  if ((R >> lane) & 1u) rank0[__popc(R & lt)] = lane;
  __syncwarp();
  const int nR = __popc(R), spp = tb.spp, cs = tb.cs_k;
  const int sup_sh = tb.sup_shift, cs_sh = tb.cs_shift;
  const int child = lane & ((1 << sup_sh) - 1);
  const unsigned group = sup_sh == 5 ? FULL : (1u << (1 << sup_sh)) - 1u;
  // (lane, part) pairs: spp superclusters each, 32 >> sup_sh pairs a pass
  for (int b0 = 0; b0 < nR; b0 += 32 >> sup_sh) {
    const int q = b0 + (lane >> sup_sh);
    bool ok = false;
    int owner = 0, e0 = 0;
    if (q < nR) {
      owner = rank0[q];
      if (child < spp) {
        const int u = p * spp + child;
        ok = slab_row(ld4<BoxS>(v.sup + 2 * u), ld4<BoxS>(v.sup + 2 * u + 1),
                      w.ray[3 * owner], w.ray[3 * owner + 2]);
        e0 = owner | (u << 5);
      }
    }
    const unsigned MS = __ballot_sync(FULL, ok);
    // one add per pair, by the first lane of its group
    if (child == 0 && q < nR) {
      const int n_ok = __popc((MS >> lane) & group);
      if (n_ok) atomicAdd(w.ncu + owner, SUP * n_ok);
    }
    if (MS == 0) continue;
    if (ok) rank1[__popc(MS & lt)] = e0;
    __syncwarp();
    const int nS = __popc(MS);
    // (lane, supercluster) pairs: SUP cluster boxes each, 4 pairs a pass
    for (int b1 = 0; b1 < nS; b1 += 32 / SUP) {
      const int q1 = b1 + (lane >> 3);
      bool ok1 = false;
      int e1 = 0;
      int owner = 0;
      if (q1 < nS) {
        const int e = rank1[q1], u = e >> 5, c = lane & (SUP - 1);
        owner = e & 31;
        // an empty cluster (not in its supercluster's mask) fails: skip it
        const unsigned live =
            static_cast<unsigned>(ld4<BoxS>(v.sup + 2 * u + 1).z);
        if ((live >> c) & 1u) {
          const int k = u * SUP + c;
          const float4 cb = ld4<BoxS>(v.cl + 2 * k + 1);
          ok1 = slab_row(ld4<BoxS>(v.cl + 2 * k), cb, w.ray[3 * owner],
                         w.ray[3 * owner + 2]);
          // the cluster, its owner and its prefix of valid triangle rows
          e1 = owner | (static_cast<int>(cb.z) << 5) | (k << 10);
        }
      }
      const unsigned MC = __ballot_sync(FULL, ok1);
      if ((lane & (SUP - 1)) == 0 && q1 < nS) {
        const int n_ok = __popc((MC >> lane) & 0xffu);
        if (n_ok) atomicAdd(w.nis + owner, cs * n_ok);
      }
      if (MC == 0) continue;
      if (ok1) rank2[__popc(MC & lt)] = e1;
      __syncwarp();
      const int nC = __popc(MC);
      // (lane, cluster) pairs: cs triangles each, 32 >> cs_sh pairs a pass
      for (int b2 = 0; b2 < nC; b2 += 32 >> cs_sh) {
        const int q2 = b2 + (lane >> cs_sh);
        const int e = q2 < nC ? rank2[q2] : 0, c = lane & (cs - 1);
        if (c < ((e >> 5) & 31)) {
          const int owner = e & 31, ti = (e >> 10) * cs + c;
          const float4 pt = w.ray[3 * owner], ut = w.ray[3 * owner + 1];
          float t;
          if (tri_test(ld4<TriS>(v.tri + 3 * ti), ld4<TriS>(v.tri + 3 * ti + 1),
                       ld4<TriS>(v.tri + 3 * ti + 2), pt.x, pt.y, pt.z, ut.x,
                       ut.y, ut.z, pt.w, ut.w, t))
            atomicMin(w.best + owner, hit_key(t, ti));
        }
      }
      __syncwarp();
    }
    __syncwarp();
  }
}

struct Trav {
  float t;
  int prim, nis, ncu;
};

// Best (t, prim) of each traversing lane's chord, whose (p, tmin),
// (u, tmax0), (inv, tmax0) rows the lane wrote to its scratch: parts in
// order, each with tmax narrowed to the best hit of the earlier parts; inside a
// part the lowest t, then the lowest prim; the live spheres last. Any-hit
// stops after the first part with a hit. Called by every lane of the warp.
template <bool Occlusion, int Layout>
__device__ __forceinline__ Trav traverse(const Tables& tb, const View& v,
                                         const Scratch& w, int lane,
                                         bool trav, float tmax0) {
  constexpr bool TabS = Layout != DEVICE_ALL;
  Trav r{BIG, -1, 0, 0};
  __syncwarp();
  for (int p = 0; p < tb.n_parts; ++p) {
    const bool live = trav && !(Occlusion && r.prim >= 0);
    if (!__any_sync(FULL, live)) break;
    const float tmax = r.prim >= 0 ? nmin(tmax0, r.t) : tmax0;
    bool reach = false;
    if (live) {
      w.ray[3 * lane + 1].w = tmax;
      w.ray[3 * lane + 2].w = tmax;
      r.ncu += 1;
      reach = slab_row(ld4<TabS>(v.part + 2 * p), ld4<TabS>(v.part + 2 * p + 1),
                       w.ray[3 * lane], w.ray[3 * lane + 2]);
      if (reach) r.ncu += tb.spp;
    }
    const unsigned R = __ballot_sync(FULL, reach);
    if (R == 0) continue;
    sweep_part<Layout>(tb, v, w, lane, R, p);
    __syncwarp();
    if (reach) {
      const unsigned long long key = w.best[lane];
      if (key != KEY_NONE) {
        w.best[lane] = KEY_NONE;
        const float t = key_time(key);
        const int id = static_cast<int>(key & 0xffffffffu);
        if (t < r.t || (t == r.t && id < r.prim)) {
          r.t = t;
          r.prim = id;
        }
      }
    }
    __syncwarp();
  }
  if (tb.n_live_sph > 0 && trav && !(Occlusion && r.prim >= 0)) {
    const float* prm = reinterpret_cast<const float*>(v.params);
    const float tmax = r.prim >= 0 ? nmin(tmax0, r.t) : tmax0;
    const float4 pt = w.ray[3 * lane], ut = w.ray[3 * lane + 1],
                 it = w.ray[3 * lane + 2];
    r.ncu += 1;
    if (slab(ldf<TabS>(prm + P_SLO), ldf<TabS>(prm + P_SLO + 1),
             ldf<TabS>(prm + P_SLO + 2), ldf<TabS>(prm + P_SHI),
             ldf<TabS>(prm + P_SHI + 1), ldf<TabS>(prm + P_SHI + 2), pt.x,
             pt.y, pt.z, it.x, it.y, it.z, pt.w, tmax)) {
      r.nis += tb.n_live_sph;
      for (int si = 0; si < tb.n_live_sph; ++si) {
        float ts;
        if (sphere_test(ld4<TabS>(v.sph + si), pt.x, pt.y, pt.z, ut.x, ut.y,
                        ut.z, pt.w, tmax, ts) &&
            ts < r.t) {
          r.t = ts;
          r.prim = tb.sph_id0 + si;
        }
      }
    }
  }
  if (trav) {
    r.nis += w.nis[lane];
    r.ncu += w.ncu[lane];
    w.nis[lane] = 0;
    w.ncu[lane] = 0;
  }
  return r;
}

// The same result for one lane, by its own loop over the hierarchy (the
// one-thread-per-ray traversal): every lane of the warp walks its own
// passing nodes.
template <bool Occlusion, int Layout>
__device__ __forceinline__ Trav traverse_lane(const Tables& tb, const View& v,
                                              float px, float py, float pz,
                                              float ux, float uy, float uz,
                                              float ix, float iy, float iz,
                                              float tmin, float tmax0) {
  constexpr bool BoxS = Layout != DEVICE_ALL;
  constexpr bool TriS = Layout == SHARED_ALL;
  Trav r{BIG, -1, 0, 0};
  const int cs = tb.cs_k, spp = tb.spp;
  for (int p = 0; p < tb.n_parts; ++p) {
    if (Occlusion && r.prim >= 0) break;
    const float tmax = r.prim >= 0 ? nmin(tmax0, r.t) : tmax0;
    r.ncu += 1;
    const float4 pa = ld4<BoxS>(v.part + 2 * p),
                 pb = ld4<BoxS>(v.part + 2 * p + 1);
    if (!slab(pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, px, py, pz, ix, iy, iz,
              tmin, tmax))
      continue;
    r.ncu += spp;
    for (int u = p * spp; u < (p + 1) * spp; ++u) {
      const float4 sa = ld4<BoxS>(v.sup + 2 * u),
                   sb = ld4<BoxS>(v.sup + 2 * u + 1);
      if (!slab(sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, px, py, pz, ix, iy, iz,
                tmin, tmax))
        continue;
      r.ncu += SUP;
      // only the clusters with valid rows (an empty one's box fails), and
      // only their prefix of rows that holds the valid ones
      for (unsigned live = static_cast<unsigned>(sb.z); live;
           live &= live - 1) {
        const int k = u * SUP + __ffs(live) - 1;
        const float4 ca = ld4<BoxS>(v.cl + 2 * k),
                     cb = ld4<BoxS>(v.cl + 2 * k + 1);
        if (!slab(ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, px, py, pz, ix, iy, iz,
                  tmin, tmax))
          continue;
        r.nis += cs;
        const int end = k * cs + static_cast<int>(cb.z);
        for (int ti = k * cs; ti < end; ++ti) {
          float t;
          if (tri_test(ld4<TriS>(v.tri + 3 * ti),
                       ld4<TriS>(v.tri + 3 * ti + 1),
                       ld4<TriS>(v.tri + 3 * ti + 2), px, py, pz, ux, uy, uz,
                       tmin, tmax, t) &&
              t < r.t) {
            r.t = t;
            r.prim = ti;
          }
        }
      }
    }
  }
  if (tb.n_live_sph > 0 && !(Occlusion && r.prim >= 0)) {
    const float* prm = reinterpret_cast<const float*>(v.params);
    const float tmax = r.prim >= 0 ? nmin(tmax0, r.t) : tmax0;
    r.ncu += 1;
    if (slab(ldf<BoxS>(prm + P_SLO), ldf<BoxS>(prm + P_SLO + 1),
             ldf<BoxS>(prm + P_SLO + 2), ldf<BoxS>(prm + P_SHI),
             ldf<BoxS>(prm + P_SHI + 1), ldf<BoxS>(prm + P_SHI + 2), px, py,
             pz, ix, iy, iz, tmin, tmax)) {
      r.nis += tb.n_live_sph;
      for (int si = 0; si < tb.n_live_sph; ++si) {
        float ts;
        if (sphere_test(ld4<BoxS>(v.sph + si), px, py, pz, ux, uy, uz, tmin,
                        tmax, ts) &&
            ts < r.t) {
          r.t = ts;
          r.prim = tb.sph_id0 + si;
        }
      }
    }
  }
  return r;
}

// One step's traversal of the warp's chords: cooperative, or lane by lane.
// The lane's chord is (p, u, inv, tmin, tmax0); `trav` lanes take part.
template <bool Coop, bool Occlusion, int Layout>
__device__ __forceinline__ Trav traverse_step(
    const Tables& tb, const View& v, const Scratch& w, int lane, bool trav,
    float px, float py, float pz, float ux, float uy, float uz, float ix,
    float iy, float iz, float tmin, float tmax0) {
  if (!Coop) {
    if (!trav) return Trav{BIG, -1, 0, 0};
    return traverse_lane<Occlusion, Layout>(tb, v, px, py, pz, ux, uy, uz, ix,
                                            iy, iz, tmin, tmax0);
  }
  if (trav) {
    w.ray[3 * lane] = make_float4(px, py, pz, tmin);
    w.ray[3 * lane + 1] = make_float4(ux, uy, uz, tmax0);
    w.ray[3 * lane + 2] = make_float4(ix, iy, iz, tmax0);
  }
  return traverse<Occlusion, Layout>(tb, v, w, lane, trav, tmax0);
}

// Does a warp whose idle lanes are `need` take new rays now? An idle lane
// takes one at once, unless the warp's rays all left one point: a pinhole
// camera's rays, neighbouring pixels that march in step. A ray taken alone
// would fall out of step with such a warp and its traversal would diverge,
// so that warp waits until all its lanes are idle (PERF.md, PR 3).
__device__ __forceinline__ bool take_rays(unsigned need, bool in_step) {
  if (RRT_TRACE_REFILL > 0) return __popc(need) >= RRT_TRACE_REFILL;
  return in_step ? need == FULL : need != 0u;
}

template <bool Curved, bool Occlusion, int Layout, bool Coop>
__global__ void __launch_bounds__(threads<Coop>(), 1)
    trace_kernel(Rays rays, Tables tb, int n_seg, Out out, int* next,
                 unsigned long long* runs) {
  constexpr bool TabS = Layout != DEVICE_ALL;
  // the launch's own count of its runs: a CUDA graph's replay runs the
  // kernel without its launcher, and this count still sees it
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(runs, 1ull);
  extern __shared__ float4 smem[];
  const View v = stage_tables<Layout, Coop>(tb, smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4* ws = smem + warp * SCR;
  const Scratch w{ws + SCR_RAY,
                  reinterpret_cast<unsigned long long*>(ws + SCR_BEST),
                  reinterpret_cast<int*>(ws + SCR_CNT),
                  reinterpret_cast<int*>(ws + SCR_CNT) + 32,
                  reinterpret_cast<int*>(ws + SCR_RANK)};
  if (Coop) {
    w.best[lane] = KEY_NONE;
    w.nis[lane] = 0;
    w.ncu[lane] = 0;
  }
  __syncthreads();

  const unsigned lt = (1u << lane) - 1u;
  const float* prm = reinterpret_cast<const float*>(v.params);
  const auto P = [prm](int k) { return ldf<TabS>(prm + k); };
  int ray = -1, s = 0, nis = 0, ncu = 0;
  float px = 0.0f, py = 0.0f, pz = 0.0f, ux = 0.0f, uy = 0.0f, uz = 0.0f;
  bool open = true;      // warp-uniform: the queue may still hold rays
  bool in_step = false;  // warp-uniform: its rays all left one point
  while (true) {
    // refill the lanes without a ray: one atomicAdd for the warp
    if (open) {
      const unsigned need = __ballot_sync(FULL, ray < 0);
      if (take_rays(need, in_step)) {
        const int leader = __ffs(need) - 1, cnt = __popc(need);
        int base = 0;
        if (lane == leader) base = atomicAdd(next, cnt);
        base = __shfl_sync(FULL, base, leader);
        if (ray < 0) {
          const int i = base + __popc(need & lt);
          if (i < rays.n) {
            ray = i;
            s = 0;
            nis = 0;
            ncu = 0;
            px = rays.o[3 * i], py = rays.o[3 * i + 1], pz = rays.o[3 * i + 2];
            ux = pad_dir(rays.d[3 * i]), uy = pad_dir(rays.d[3 * i + 1]),
            uz = pad_dir(rays.d[3 * i + 2]);
          }
        }
        open = base + cnt < rays.n;
        if (need == FULL) {
          // all lanes were idle, so every ray the warp holds was taken
          // now, lane 0's first: more than one, all from lane 0's origin?
          const float ox = __shfl_sync(FULL, px, 0),
                      oy = __shfl_sync(FULL, py, 0),
                      oz = __shfl_sync(FULL, pz, 0);
          const bool got = ray >= 0;
          in_step = __popc(__ballot_sync(FULL, got)) > 1 &&
                    !__any_sync(FULL, got && (px != ox || py != oy ||
                                              pz != oz));
        }
      }
    }
    const bool active = ray >= 0;
    if (!__any_sync(FULL, active)) break;

    if (!Curved) {
      // flat: one traversal of [min_t, max_t] along the ray itself
      const Trav r = traverse_step<Coop, Occlusion, Layout>(
          tb, v, w, lane, active, px, py, pz, ux, uy, uz, 1.0f / ux,
          1.0f / uy, 1.0f / uz, active ? rays.min_t[ray] : 0.0f,
          active ? rays.max_t[ray] : 0.0f);
      if (active) {
        const bool hit = r.prim >= 0;
        finish(out, rays, ray, hit, false, r.t, r.prim, hit ? 0 : 1, px, py,
               pz, ux, uy, uz, r.nis, r.ncu);
        ray = -1;
      }
      continue;
    }

    // curved: every live lane marches one chord of its own ray
    bool fin = false, absd = false, trav = false;
    Chord c{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, false};
    if (active) {
      c = march(px, py, pz, ux, uy, uz, P(P_BH), P(P_BH + 1), P(P_BH + 2),
                P(P_R), P(P_DT), P(P_COS), P(P_SIN));
      // a degenerate lane dies; absorption beats same-segment geometry
      if (c.dead) {
        fin = true;
      } else if (absorb(px, py, pz, c.dx, c.dy, c.dz, c.len, P(P_BH),
                        P(P_BH + 1), P(P_BH + 2), P(P_R))) {
        fin = true;
        absd = true;
      } else {
        trav = slab(P(P_GLO), P(P_GLO + 1), P(P_GLO + 2), P(P_GHI),
                    P(P_GHI + 1), P(P_GHI + 2), px, py, pz, c.ix, c.iy, c.iz,
                    0.0f, c.len);
      }
    }
    const Trav r = traverse_step<Coop, Occlusion, Layout>(
        tb, v, w, lane, trav, px, py, pz, c.dx, c.dy, c.dz, c.ix, c.iy, c.iz,
        0.0f, c.len);
    const bool hit = trav && r.prim >= 0;
    if (trav) {
      nis += r.nis;
      ncu += r.ncu;
    }
    if (active) {
      if (hit) {
        fin = true;
      } else if (!fin) {
        px = px + c.dx * c.len;
        py = py + c.dy * c.len;
        pz = pz + c.dz * c.len;
        ux = c.dx, uy = c.dy, uz = c.dz;
        fin = ++s == n_seg;  // 2π exhausted: an escape
      }
      if (fin) {
        finish(out, rays, ray, hit, absd, r.t, r.prim, s, px, py, pz, c.dx,
               c.dy, c.dz, nis, ncu);
        ray = -1;
      }
    }
  }
}

// Shared-memory bytes of a block in the given layout (device: stage_tables).
size_t smem_bytes(const Tables& tb, int layout, bool coop) {
  const size_t n_sup = static_cast<size_t>(tb.n_parts) * tb.spp;
  const size_t n_cl = n_sup * SUP;
  size_t f4 = coop ? static_cast<size_t>(threads<true>() / 32) * SCR : 0;
  if (layout != DEVICE_ALL)
    f4 += N_PARAMS4 + 2 * static_cast<size_t>(tb.n_parts) + tb.n_sph +
          2 * n_sup + 2 * n_cl;
  if (layout == SHARED_ALL) f4 += 3 * n_cl * tb.cs_k;
  return 16 * f4;
}

constexpr int MAX_DEVICES = 64;
struct DeviceInfo {
  bool known = false;
  int sms = 0, optin = 0;
};
DeviceInfo g_dev[MAX_DEVICES];

// The opt-in limit of each kernel instance, raised once per device, and
// its resident blocks per SM for the last shared-memory size it ran with.
struct InstanceInfo {
  bool raised = false;
  size_t smem = 0;
  int blocks = 0;
};
InstanceInfo g_inst[MAX_DEVICES][24];

struct Launch {
  Rays rays;
  Tables tb;
  int n_seg;
  Out out;
  int *next, device;
  unsigned long long* runs;
  size_t smem;
  cudaStream_t stream;
  int* info;
};

template <bool Curved, bool Occlusion, int Layout, bool Coop>
cudaError_t launch(const Launch& l) {
  auto kernel = trace_kernel<Curved, Occlusion, Layout, Coop>;
  constexpr int inst = Curved * 12 + Occlusion * 6 + Layout * 2 + Coop;
  InstanceInfo& ii = g_inst[l.device][inst];
  cudaError_t err;
  if (!ii.raised) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               g_dev[l.device].optin);
    if (err != cudaSuccess) return err;
    ii.raised = true;
  }
  if (ii.smem != l.smem || ii.blocks == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ii.blocks, kernel, threads<Coop>(), l.smem);
    if (err != cudaSuccess) return err;
    if (ii.blocks == 0) return cudaErrorInvalidConfiguration;
    ii.smem = l.smem;
  }
  const int grid = g_dev[l.device].sms * ii.blocks;
  l.info[0] = grid;
  l.info[1] = ii.blocks;
  l.info[4] = threads<Coop>();
  kernel<<<grid, threads<Coop>(), l.smem, l.stream>>>(l.rays, l.tb, l.n_seg,
                                                      l.out, l.next, l.runs);
  return cudaGetLastError();
}

template <bool Curved, bool Occlusion, bool Coop>
cudaError_t launch_layout(int layout, const Launch& l) {
  if (layout == SHARED_ALL)
    return launch<Curved, Occlusion, SHARED_ALL, Coop>(l);
  if (layout == SHARED_BOXES)
    return launch<Curved, Occlusion, SHARED_BOXES, Coop>(l);
  return launch<Curved, Occlusion, DEVICE_ALL, Coop>(l);
}

template <bool Curved, bool Occlusion>
cudaError_t launch_mode(bool coop, int layout, const Launch& l) {
  return coop ? launch_layout<Curved, Occlusion, true>(layout, l)
              : launch_layout<Curved, Occlusion, false>(layout, l);
}

int ceil_log2(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}

}  // namespace

// Launches the trace of n rays on `stream`; returns a cudaError_t code.
// Every pointer is device memory of the layouts above; `next` is one int
// set to 0, the launch's ray queue; `runs` is a counter in device memory
// that every run of the kernel adds one to. `info` receives the grid, the blocks
// per SM, the table layout (0: every table in shared memory, 1: triangles
// in device memory and the rest in shared memory, 2: every table in device
// memory), the shared-memory bytes of a block, the threads of a block and
// whether the traversal was cooperative (1) or per lane (0).
extern "C" int rrt_trace(const float* o, const float* d, const float* min_t,
                         const float* max_t, int n, const float* params,
                         const float* tri, const float* cl, const float* sup,
                         const float* part, const float* sph, int n_parts,
                         int spp, int cs_k, int n_live_sph, int sph_id0,
                         int n_sph, int n_seg, int curved, int occlusion,
                         bool* hit, bool* absd,
                         float* t, int* prim, int* seg, float* seg_o,
                         float* seg_d, int* nisect, int* ncull, int* next,
                         unsigned long long* runs, int* info, int device,
                         void* stream) {
  if (device < 0 || device >= MAX_DEVICES || spp < 1 || spp > 32 ||
      (cs_k != 8 && cs_k != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cur != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  DeviceInfo& di = g_dev[device];
  if (!di.known) {
    err = cudaDeviceGetAttribute(&di.sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &di.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    di.known = true;
  }
  const Tables tb{reinterpret_cast<const float4*>(params),
                  reinterpret_cast<const float4*>(tri),
                  reinterpret_cast<const float4*>(cl),
                  reinterpret_cast<const float4*>(sup),
                  reinterpret_cast<const float4*>(part),
                  reinterpret_cast<const float4*>(sph),
                  n_parts, spp, ceil_log2(spp), cs_k, ceil_log2(cs_k),
                  n_live_sph, sph_id0, n_sph};
  // by default a hierarchy deeper than one supercluster goes to the
  // cooperative traversal, and a single-part, single-supercluster scene
  // (the Cornell box) is walked lane by lane, which ran faster there
  // (PERF.md, PR 3)
  const bool coop = RRT_TRACE_TRAVERSAL < 0 ? n_parts > 1 || spp > 1
                                            : RRT_TRACE_TRAVERSAL == 1;
  int layout = RRT_TRACE_LAYOUT;
  while (layout < DEVICE_ALL &&
         smem_bytes(tb, layout, coop) > static_cast<size_t>(di.optin))
    ++layout;
  const size_t smem = smem_bytes(tb, layout, coop);
  if (smem > static_cast<size_t>(di.optin))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  info[2] = layout;
  info[3] = static_cast<int>(smem);
  info[5] = coop;
  const Launch l{Rays{o, d, min_t, max_t, n},
                 tb,
                 n_seg,
                 Out{hit, absd, t, prim, seg, seg_o, seg_d, nisect, ncull},
                 next,
                 device,
                 runs,
                 smem,
                 static_cast<cudaStream_t>(stream),
                 info};
  if (curved)
    err = occlusion ? launch_mode<true, true>(coop, layout, l)
                    : launch_mode<true, false>(coop, layout, l);
  else
    err = occlusion ? launch_mode<false, true>(coop, layout, l)
                    : launch_mode<false, false>(coop, layout, l);
  return static_cast<int>(err);
}

extern "C" const char* rrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
