// The many-object kernels for Hopper (sm_90a): the fused whole-frame
// renderer and the cluster-culled nearest-hit query, over one Morton
// cluster pack.
//
// mesh_fused_kernel replaces the TPU kernel
// ttrt/kernels/mesh_fused.py::_fused_kernel (:194, launched at :1334 by
// render_band_mesh_fused), procedural and textured (image-cubemap) skies,
// nearest or bilinear, with `specular` and `energy_model="subtract"`; an
// image sky's texels are loaded in the kernel (common.cuh::Sky) where the
// TPU kernel deferred them to an epilogue gather (:1284, :1350-1379). Its
// plain PyTorch version is
// ttrt_torch/kernels/mesh_fused.py::render_band_mesh_fused_plain.
// cluster_nearest_kernel replaces ttrt/kernels/mesh_pallas.py::_mesh_kernel
// (:70, launched at :361 by cluster_nearest), modes "cull" and "dense". Its
// wrapper is ttrt_torch/kernels/mesh.py::cluster_nearest_cuda, its plain
// version the dense tester ttrt_torch/mesh/dense.py::dense_nearest.
// pathtrace_mesh_kernel path-traces a MeshScene (--pathtrace --scene
// many): pathtrace.cuh's trace_path, the demo path tracer's estimator and
// random stream unchanged, over this file's MeshTracer, with the staged
// quarter boxes (stage_boxes) and the fused kernel's sample threads. The
// JAX package has no such kernel (its many-object path tracer is the eager
// estimator); its plain version is
// ttrt_torch/kernels/pathtrace.py::pathtrace_frame_plain on a MeshScene,
// which traces every object with the fused kernel's plain tests.
//
// Design of mesh_fused_kernel: one thread per (pixel, sample). A pixel's S
// samples run on S neighbouring threads of one block (a whole band's
// samples up to 32, else rounds of at most 32), so a warp holds about
// three pixels' jittered, nearly parallel rays; a block holds
// P = block / S pixels, consecutive in the band's row-major order. Each
// thread runs common.cuh's trace_sample<true> and the per-sample sky and
// normalization (sample_color) for its sample; the pixel's first thread
// adds the S colors from shared memory in sample order, from 0.0f, and
// scales the sum (common.cuh::sample_threads), so the bits are the plain
// version's.
// The full 480x280x10 frame is 11,200 blocks of 120 threads, about ten
// waves at 8 blocks an SM, which the hardware block scheduler balances.
// Each trace walks the pack's tree (BvhTracer, below): per ray, from the
// root, near child first, with a stack of pushed far children in local
// memory. The node table (at 10k spheres 8,192 nodes, 256 KB) is read in
// place, through L1. Neither keeps the TPU kernel's (ray tile, phase)
// grid, VMEM state, sublane-class partials or two-level sweep, which
// worked around the TPU's scalar-sync cost.
//
// Design of cluster_nearest_kernel: one thread per ray, blocks of 128,
// the eager integrator's batches of 1,344,000 rays about nine waves; it
// walks with nearest() in index order (IndexBoxes). Staging its
// 11,264-byte box table in shared memory lost on the bounce rays
// (PERF.md); the table is read in place, through L1.
//
// The flat walk of pathtrace_mesh_kernel and cluster_nearest_kernel
// (nearest(), MeshTracer), the same in every layout: each trace walks the
// K subclusters in the per-frame near-to-far order the wrapper computes
// (pathtrace_mesh) or in index order (cluster_nearest), slab-tests each
// subcluster's four quarter AABBs with the clamped 1/d
// (mesh_fused.py:283-288, :602-622), skips a quarter whose entry time is
// past the best t so far, and narrow-tests the quarter's real objects (32
// Morton-consecutive ones, fewer at the end of the pack). nearest() takes
// a sphere's square root only for a hit (a miss never uses it), and runs
// a quarter's narrow tests in a loop made for its kind of object
// (narrow_quarter<TRI>), chosen once a subcluster. Shadow rays take the
// same walk and stop at the first blocker. Only the addresses the boxes
// come from differ (TableBoxes, StagedBoxes, IndexBoxes). PERF.md records
// the walk bodies compared: making a subcluster's four slab tests before
// its narrow tests (the same tests in the same order) was faster on some
// nearest-hit batches and slower on the fused kernel, so it went.
//
// The tree walk of mesh_fused_kernel (BvhTracer): the same slab test
// (quarter()) on the nodes of a binary tree over single objects
// (ttrt_torch/mesh/bvh.py: leaves of 4 Morton-consecutive objects of one
// kind, the implicit complete tree over them, every box widened as the
// quarter boxes are), the same narrow tests (narrow_quarter<TRI>, the
// shadow rays' sqrt-free tests) on the leaves it reaches, in another
// order. PERF.md records the walks compared: the per-ray walk with its
// stack in local memory beat the same walk with the stack in a column of
// shared memory, a bit a level in place of the stack (each far child
// slab-tested again on its way back), a warp-uniform walk (a node entered
// when any lane needs it) and leaves of 8 objects.
// Sphere and triangle rows stay in device memory behind L1/L2: at 10k
// spheres the pack is about 400 KB, more than a block's 227 KB of shared
// memory.
//
// Arithmetic is the plain versions', op for op (build with --fmad=false):
// the expanded sphere quadratic with the pack's ccr2 = |C|^2 - r^2
// (mesh_fused.py:651-658), Moller-Trumbore with the reference's plane
// epsilons (:682-728), the sqrt-free shadow any-hit tests with the
// point-light cutoff (:743-768, :787), and render.cu's hit fixups, lighting
// and reflected ray (common.cuh). The narrow tests' products are
// contracted into fmaf exactly where XLA:CPU contracts them in JAX's
// compiled dense tester (ttrt_torch/mesh/dense.py lists the pattern), so
// cluster_nearest agrees with ttrt.mesh.dense.dense_nearest to the bit on
// the CPU tests' inputs. Tie rule: on an exact float tie in t the
// lower original object id wins, t0 < best || (t0 == best && id < best_id).
// The TPU kernel keeps the first-visited object instead
// (mesh_fused.py:96-107); the lowest id is the oracle's rule
// (ttrt/mesh/scene.py:134-137), makes the result independent of the visit
// order, and lets the culled kernels equal their exhaustive plain versions
// bit for bit. The floor mesh's shared edges produce such ties. The culling
// is exact because the kernel tables widen every quarter AABB and tree
// node (ttrt_torch/mesh/clusters.py::BOX_PAD) by more than the narrow
// tests' rounding can place a hit outside it, and a node's box holds its
// children's, so its float entry time is never later than theirs.
//
// What bounds them on this card: operations, not bytes. A batch of the
// eager integrator (1,344,000 rays) needs 329 slab tests and 359-440
// narrow tests a ray, 0.30-0.33 ms at the FP32 peak; the index-order
// walk makes 1.1-1.2x those narrow tests, and on bounce rays the lanes of
// a warp take different quarters (a warp issues about 7x its lanes'
// tests on bounce 3's batch), which only a traversal change can undo.
// For the fused kernel: a 480x280x10x10 frame at 10k spheres reads the
// 0.7 MB pack and writes 2.2 MB, microseconds at 3.35 TB/s, but performs
// 13.8 million traces. The flat sweep made 329 slab tests and hundreds of
// narrow tests each (PERF.md's 2.6 ms bound counts them); the tree walk
// makes about 180-200 slab tests and 40-70 narrow tests a trace
// (chip_smoke.py's walk_work), about 1.2 ms of operations, and takes
// about 30x that: each step waits on a dependent load of two nodes, and
// the lanes of a warp walk different nodes. What held the one-thread-a-
// pixel form at 63x the flat bound (PERF.md, runs R-U: a grid of 1,050
// blocks that lasted as long as its slowest 10-sample chain) is answered
// by many short blocks; the loads' latency, by launch bounds that keep 64
// warps on an SM.

#include <math_constants.h>

#include <type_traits>

#include "common.cuh"
#include "pathtrace.cuh"

namespace {

constexpr int QUARTERS = 4;       // culling boxes per subcluster
constexpr int QBLOCK = 32;        // objects per quarter
constexpr int SUB = QUARTERS * QBLOCK;  // objects per subcluster

// The pack as the kernels read it (ttrt_torch/mesh/clusters.py::KernelTables),
// objects in Morton order; subcluster `sub` of the spheres holds positions
// sub*128 .. sub*128+127, quarter q of it positions +32q .. +32q+31.
struct MeshGeom {
  const float4* sph;      // cx cy cz ccr2
  const float4* sph_mat;  // cr cg cb refl
  const float* sph_spec;
  const int* sph_id;      // original id
  const float4* tri;      // 3 per triangle: v0xyz e1x | e1yz e2xy | e2z 0 0 0
  const float4* tri_nrm;  // nx ny nz 0
  const float4* tri_mat;  // cr cg cb refl
  const float* tri_spec;
  const int* tri_id;
  const float4* qbox;     // 2 per quarter: lo xyz hi.x | hi.yz n_obj 0
  const int* order;       // mesh_fused's visit order of the K subclusters
  int kb_sph, kb_tri;
  bool cull;              // false: test every object (mode "dense")
};

// Conservative clamped 1/d (mesh_fused.py:283-288): |d| floored keeping
// its sign, so an axis-parallel ray gets huge slab times and the test can
// only pass more boxes, never fewer.
__device__ __forceinline__ float cinv(float dc) {
  float m = fmaxf(fabsf(dc), 1e-12f);
  return 1.0f / (dc >= 0.0f ? m : -m);
}

// Slab test of row `row` of the box table `qbox` (mesh_fused.py:602-622):
// passes when the ray line meets the box at t >= 0; returns the count of
// real objects in the quarter (0 when it does not pass) and the entry
// time tn.
__device__ __forceinline__ int quarter(const float4* qbox, bool cull, int row,
                                       float ox, float oy, float oz,
                                       float ivx, float ivy, float ivz,
                                       float& tn) {
  const float4 a = qbox[2 * row];
  const float4 b = qbox[2 * row + 1];
  const int n = (int)b.z;
  tn = 0.0f;
  if (n == 0 || !cull) return n;
  float t1 = (a.x - ox) * ivx, t2 = (a.w - ox) * ivx;
  float n_ = fminf(t1, t2), f_ = fmaxf(t1, t2);
  t1 = (a.y - oy) * ivy;
  t2 = (b.x - oy) * ivy;
  n_ = fmaxf(n_, fminf(t1, t2));
  f_ = fminf(f_, fmaxf(t1, t2));
  t1 = (a.z - oz) * ivz;
  t2 = (b.y - oz) * ivz;
  n_ = fmaxf(n_, fminf(t1, t2));
  f_ = fminf(f_, fmaxf(t1, t2));
  tn = n_;
  return f_ >= fmaxf(n_, 0.0f) ? n : 0;
}

// Where the walk reads the quarter boxes. Both visit the subclusters in
// the same order and run the same slab test on the same boxes; only the
// addresses differ.
// In place: the kernel tables' qbox, subcluster `sub`'s quarters at rows
// 4*sub .. 4*sub+3, visited in `order`.
struct TableBoxes {
  const float4* box;
  const int* order;
  __device__ __forceinline__ int sub(int i) const { return order[i]; }
  __device__ __forceinline__ int row(int i, int sub, int q) const {
    return sub * QUARTERS + q;
  }
};

// In index order: the kernel tables' qbox, subclusters 0..K-1.
struct IndexBoxes {
  const float4* box;
  __device__ __forceinline__ int sub(int i) const { return i; }
  __device__ __forceinline__ int row(int i, int sub, int q) const {
    return i * QUARTERS + q;
  }
};

// Staged: the table gathered into visit order (the i-th visited
// subcluster's quarters at rows 4*i .. 4*i+3) and the order itself, in
// shared memory.
struct StagedBoxes {
  const float4* box;
  const int* order;
  __device__ __forceinline__ int sub(int i) const { return order[i]; }
  __device__ __forceinline__ int row(int i, int sub, int q) const {
    return i * QUARTERS + q;
  }
};

// Per-ray terms of the expanded sphere quadratic (ttrt_torch/mesh/dense.py).
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float od, oo, fa, inv2a;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  const float a = dx * dx + dy * dy + dz * dz;
  r.inv2a = 0.5f / a;
  r.od = ox * dx + oy * dy + oz * dz;
  r.oo = ox * ox + oy * oy + oz * oz;
  r.fa = 4.0f * a;
  return r;
}

// ax*bx + ay*by + az*bz as fma(az, bz, fma(ay, by, ax*bx)) (common.cuh's
// dot3 is fma(az, bz, fma(ax, bx, ay*by))); a*b - c*d as fma(a, b, -(c*d)).
__device__ __forceinline__ float dot_zyx(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  return fmaf(az, bz, fmaf(ay, by, ax * bx));
}

__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
  return fmaf(a, b, -(c * d));
}

// Sphere narrow test: b = 2 (o.d - C.d), c = o.o - 2 C.o + ccr2,
// disc = b*b - 4a*c, hit = disc >= 0 && b < 0 && c > 0; sphere_root is
// its t0.
__device__ __forceinline__ bool sphere_hit(const float4 c, const Ray& r,
                                           float& b, float& disc) {
  const float cd = dot_zyx(c.x, c.y, c.z, r.dx, r.dy, r.dz);
  const float co = dot_zyx(c.x, c.y, c.z, r.ox, r.oy, r.oz);
  b = 2.0f * (r.od - cd);
  const float cc = r.oo - 2.0f * co + c.w;
  disc = fmaf(b, b, -(r.fa * cc));
  return disc >= 0.0f && b < 0.0f && cc > 0.0f;
}

__device__ __forceinline__ float sphere_root(float b, float disc,
                                             const Ray& r) {
  return (-b - sqrtf(fmaxf(disc, 0.0f))) * r.inv2a;
}

// Moller-Trumbore with the reference's plane epsilons
// (TerminalRayTracer.c:680,685): |det| > 1e-5 and t > 1e-5.
__device__ __forceinline__ bool tri_t(const float4* v, float ox, float oy,
                                      float oz, float dx, float dy, float dz,
                                      float& t) {
  const float4 A = v[0], B = v[1], C = v[2];
  const float v0x = A.x, v0y = A.y, v0z = A.z;
  const float e1x = A.w, e1y = B.x, e1z = B.y;
  const float e2x = B.z, e2y = B.w, e2z = C.x;
  const float px = cross_term(dy, e2z, dz, e2y);
  const float py = cross_term(dz, e2x, dx, e2z);
  const float pz = cross_term(dx, e2y, dy, e2x);
  const float det = dot3(e1x, e1y, e1z, px, py, pz);
  const bool ok = fabsf(det) > PLANE_DENOM_EPS_F;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
  const float u = dot3(sx, sy, sz, px, py, pz) * inv;
  const float qx = cross_term(sy, e1z, sz, e1y);
  const float qy = cross_term(sz, e1x, sx, e1z);
  const float qz = cross_term(sx, e1y, sy, e1x);
  const float v_ = dot_zyx(dx, dy, dz, qx, qy, qz) * inv;
  t = dot_zyx(e2x, e2y, e2z, qx, qy, qz) * inv;
  return ok && u >= 0.0f && v_ >= 0.0f && u + v_ <= 1.0f && t > PLANE_T_EPS_F;
}

struct Nearest {
  float t;    // inf on a miss
  int id;     // original id, -1 on a miss
  int pos;    // Morton position in the sphere or triangle table
  bool tri;
};

// Narrow-tests the n objects of a quarter from position `base` of the
// sphere (TRI = false) or triangle table and folds them into `best`, the
// lowest id winning an exact tie in t.
template <bool TRI>
__device__ __forceinline__ void narrow_quarter(const MeshGeom& g,
                                               const Ray& r, int base, int n,
                                               Nearest& best) {
  for (int j = 0; j < n; ++j) {
    const int pos = base + j;
    float t;
    if (TRI) {
      if (!tri_t(g.tri + 3 * pos, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t))
        continue;
    } else {
      float b, disc;
      if (!sphere_hit(g.sph[pos], r, b, disc)) continue;
      t = sphere_root(b, disc, r);
    }
    if (t > best.t) continue;
    const int id = TRI ? g.tri_id[pos] : g.sph_id[pos];
    if (t < best.t || id < best.id) {
      best.t = t;
      best.id = id;
      best.pos = pos;
      best.tri = TRI;
    }
  }
}

// Visited subcluster i, subcluster `sub` of the spheres (TRI = false) or
// the triangles: quarter by quarter, the slab test, then the narrow tests
// if the ray enters the quarter no later than the best t so far.
template <bool TRI, class Boxes>
__device__ __forceinline__ void walk_subcluster(const MeshGeom& g,
                                                const Boxes& bx, int i,
                                                int sub, const Ray& r,
                                                float ivx, float ivy,
                                                float ivz, Nearest& best) {
  const int row_sub = TRI ? sub + g.kb_sph : sub;
  for (int q = 0; q < QUARTERS; ++q) {
    float tn;
    const int n = quarter(bx.box, g.cull, bx.row(i, row_sub, q), r.ox, r.oy,
                          r.oz, ivx, ivy, ivz, tn);
    if (n > 0 && !(tn > best.t))
      narrow_quarter<TRI>(g, r, sub * SUB + q * QBLOCK, n, best);
  }
}

// Nearest (t, original id) over the pack: the culled walk, with the
// lowest id winning an exact tie in t.
template <class Boxes>
__device__ Nearest nearest(const MeshGeom& g, const Boxes& bx, float ox,
                           float oy, float oz, float dx, float dy, float dz) {
  const Ray r = make_ray(ox, oy, oz, dx, dy, dz);
  const float ivx = cinv(dx), ivy = cinv(dy), ivz = cinv(dz);
  Nearest best;
  best.t = CUDART_INF_F;
  best.id = -1;
  best.pos = 0;
  best.tri = false;
  const int K = g.kb_sph + g.kb_tri;
  for (int i = 0; i < K; ++i) {
    const int sub = bx.sub(i);
    if (sub >= g.kb_sph)
      walk_subcluster<true>(g, bx, i, sub - g.kb_sph, r, ivx, ivy, ivz, best);
    else
      walk_subcluster<false>(g, bx, i, sub, r, ivx, ivy, ivz, best);
  }
  return best;
}

// The hit record of a trace from o along d whose nearest object is b
// (b.id >= 0): the object's material and finish_hit's point and normal.
__device__ __forceinline__ Hit nearest_hit(const MeshGeom& g,
                                           const Nearest& b, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz) {
  Hit h;
  if (b.tri) {
    const float4 m = g.tri_mat[b.pos];
    const float4 n = g.tri_nrm[b.pos];
    h.cr = m.x; h.cg = m.y; h.cb = m.z; h.refl = m.w;
    h.spec = g.tri_spec[b.pos];
    finish_hit(h, b.t, ox, oy, oz, dx, dy, dz, nullptr, n.x, n.y, n.z);
  } else {
    const float4 m = g.sph_mat[b.pos];
    const float4 c = g.sph[b.pos];
    const float center[3] = {c.x, c.y, c.z};
    h.cr = m.x; h.cg = m.y; h.cb = m.z; h.refl = m.w;
    h.spec = g.sph_spec[b.pos];
    finish_hit(h, b.t, ox, oy, oz, dx, dy, dz, center, 0.0f, 0.0f, 0.0f);
  }
  return h;
}

// Whether the object at table position pos (a triangle when is_tri)
// blocks the shadow ray from p along the UNIT direction ld (a == 1),
// before tmax only when has_tmax (point lights); soo = p.p, od = p.ld.
// Sqrt-free for a sphere.
__device__ __forceinline__ bool shadow_blocks(const MeshGeom& g, bool is_tri,
                                              int pos, float px, float py,
                                              float pz, float ldx, float ldy,
                                              float ldz, float soo, float od,
                                              bool has_tmax, float tmax) {
  bool hit;
  if (is_tri) {
    float t;
    hit = tri_t(g.tri + 3 * pos, px, py, pz, ldx, ldy, ldz, t);
    if (has_tmax) hit = hit && t < tmax;
  } else {
    const float4 c = g.sph[pos];
    const float co = dot_zyx(c.x, c.y, c.z, px, py, pz);
    const float cc = soo - 2.0f * co + c.w;
    const float cd = dot_zyx(c.x, c.y, c.z, ldx, ldy, ldz);
    const float b = 2.0f * (od - cd);
    const float disc = fmaf(b, b, -(4.0f * cc));
    hit = disc >= 0.0f && b < 0.0f && cc > 0.0f;
    if (has_tmax) {
      // t0 < tmax  <=>  sqrt(disc) > -b - 2*tmax
      const float rhs = -b - 2.0f * tmax;
      hit = hit && (rhs < 0.0f || disc > rhs * rhs);
    }
  }
  return hit;
}

// The many-object tracer for common.cuh's trace_sample.
template <class Boxes>
struct MeshTracer {
  MeshGeom g;
  Boxes bx;

  __device__ Hit trace(float ox, float oy, float oz, float dx, float dy,
                       float dz) const {
    const Nearest b = nearest(g, bx, ox, oy, oz, dx, dy, dz);
    if (b.id < 0) return miss_hit(ox, oy, oz, dx, dy, dz);
    return nearest_hit(g, b, ox, oy, oz, dx, dy, dz);
  }

  // Any-hit shadow test from p along a UNIT direction (a == 1), blockers
  // before tmax only when has_tmax (point lights).
  __device__ bool blocked(float px, float py, float pz, float ldx, float ldy,
                          float ldz, bool has_tmax, float tmax) const {
    const float soo = px * px + py * py + pz * pz;
    const float od = px * ldx + py * ldy + pz * ldz;
    const float ivx = cinv(ldx), ivy = cinv(ldy), ivz = cinv(ldz);
    const int K = g.kb_sph + g.kb_tri;
    for (int i = 0; i < K; ++i) {
      const int sub = bx.sub(i);
      const bool is_tri = sub >= g.kb_sph;
      for (int q = 0; q < QUARTERS; ++q) {
        float tn;
        const int n = quarter(bx.box, g.cull, bx.row(i, sub, q), px, py, pz,
                              ivx, ivy, ivz, tn);
        if (n == 0 || (has_tmax && tn > tmax)) continue;
        const int base = (is_tri ? sub - g.kb_sph : sub) * SUB + q * QBLOCK;
        for (int j = 0; j < n; ++j)
          if (shadow_blocks(g, is_tri, base + j, px, py, pz, ldx, ldy, ldz,
                            soo, od, has_tmax, tmax))
            return true;
      }
    }
    return false;
  }
};

// The fused kernel's walk: a per-ray, near-first walk of the tree over
// single objects (ttrt_torch/mesh/bvh.py). `node` is the kernel tables'
// node table, two float4 a node in the quarter boxes' layout (lo xyz hi.x
// | hi.yz n_obj first), node 1 the root, nodes 2i and 2i+1 the children of
// node i, nodes `leaves` .. 2 * leaves - 1 the leaves. A leaf holds n_obj
// consecutive objects of one kind from position `first` of the kernels'
// combined numbering (spheres 0 .., triangles kb_sph * SUB ..). The walk
// slab-tests both children of a node with quarter(), goes into the nearer
// one that the ray enters before its limit and pushes the other with its
// entry time; a popped node entered after the limit is skipped. Its depth
// is at most BVH_STACK (the C entry refuses a deeper table), so is the
// stack.
constexpr int BVH_STACK = 24;

struct BvhTracer {
  MeshGeom g;
  const float4* node;
  int leaves;

  // Calls leaf(first, n) on each leaf the ray (o, 1/d) enters at a time no
  // later than limit(), near child first, until leaf returns true.
  template <class Limit, class Leaf>
  __device__ __forceinline__ void walk(float ox, float oy, float oz,
                                       float ivx, float ivy, float ivz,
                                       Limit limit, Leaf leaf) const {
    int stack[BVH_STACK];
    float stack_t[BVH_STACK];
    int sp = 0;
    int at = 1;
    float tn;
    if (quarter(node, true, at, ox, oy, oz, ivx, ivy, ivz, tn) == 0 ||
        tn > limit())
      return;
    for (;;) {
      if (at >= leaves) {
        const float4 b = node[2 * at + 1];
        if (leaf((int)b.w, (int)b.z)) return;
      } else {
        const int c = 2 * at;
        float t0, t1;
        const bool go0 =
            quarter(node, true, c, ox, oy, oz, ivx, ivy, ivz, t0) > 0 &&
            !(t0 > limit());
        const bool go1 =
            quarter(node, true, c + 1, ox, oy, oz, ivx, ivy, ivz, t1) > 0 &&
            !(t1 > limit());
        if (go0 && go1) {
          const bool right_first = t1 < t0;
          stack[sp] = right_first ? c : c + 1;
          stack_t[sp] = right_first ? t0 : t1;
          ++sp;
          at = right_first ? c + 1 : c;
          continue;
        }
        if (go0 || go1) {
          at = go0 ? c : c + 1;
          continue;
        }
      }
      do {
        if (sp == 0) return;
        --sp;
      } while (stack_t[sp] > limit());
      at = stack[sp];
    }
  }

  __device__ Hit trace(float ox, float oy, float oz, float dx, float dy,
                       float dz) const {
    const Ray r = make_ray(ox, oy, oz, dx, dy, dz);
    Nearest b;
    b.t = CUDART_INF_F;
    b.id = -1;
    b.pos = 0;
    b.tri = false;
    const int tri0 = g.kb_sph * SUB;
    walk(ox, oy, oz, cinv(dx), cinv(dy), cinv(dz), [&] { return b.t; },
         [&](int first, int n) {
           if (first >= tri0)
             narrow_quarter<true>(g, r, first - tri0, n, b);
           else
             narrow_quarter<false>(g, r, first, n, b);
           return false;
         });
    if (b.id < 0) return miss_hit(ox, oy, oz, dx, dy, dz);
    return nearest_hit(g, b, ox, oy, oz, dx, dy, dz);
  }

  // Any-hit shadow test from p along a UNIT direction (a == 1), blockers
  // before tmax only when has_tmax (point lights): shadow_blocks on the
  // leaves the walk reaches.
  __device__ bool blocked(float px, float py, float pz, float ldx, float ldy,
                          float ldz, bool has_tmax, float tmax) const {
    const float soo = px * px + py * py + pz * pz;
    const float od = px * ldx + py * ldy + pz * ldz;
    const float limit = has_tmax ? tmax : CUDART_INF_F;
    const int tri0 = g.kb_sph * SUB;
    bool hit = false;
    walk(px, py, pz, cinv(ldx), cinv(ldy), cinv(ldz), [&] { return limit; },
         [&](int first, int n) {
           const bool is_tri = first >= tri0;
           const int base = is_tri ? first - tri0 : first;
           for (int j = 0; j < n && !hit; ++j)
             hit = shadow_blocks(g, is_tri, base + j, px, py, pz, ldx, ldy,
                                 ldz, soo, od, has_tmax, tmax);
           return hit;
         });
    return hit;
  }
};

// The camera and the lights go into dynamic shared memory up to this size:
// thousands of lights. More are read in place from their global arrays.
constexpr size_t SMEM_LIGHT_BYTES = 48 * 1024;

// The launch shape of mesh_fused_kernel: a pixel's samples on S <=
// MAX_ROUND threads of one block (common.cuh::sample_threads); the block
// is the smallest of FUSED_BLOCK, 2 * FUSED_BLOCK, ... FUSED_MAX_THREADS
// that keeps the most warps resident on an SM (common.cuh::pick_block).
// The launch bounds hold a thread to
// 65536 / (FUSED_MAX_THREADS * FUSED_MIN_BLOCKS) = 32 registers, so that
// an SM holds its full 64 warps: the tree walk waits on a dependent load a
// step, and more warps in flight hide it better than registers spare the
// spills (64, 40 and 32 registers compared in PERF.md).
constexpr int FUSED_BLOCK = 128;
constexpr int FUSED_MAX_THREADS = 512;
constexpr int FUSED_MIN_BLOCKS = 4;

// Bytes of the staged boxes of K subclusters: 8 float4 each, then the
// visit order, padded to whole float4s.
inline size_t staged_box_bytes(int K) {
  return (size_t)K * 2 * QUARTERS * sizeof(float4) +
         (size_t)((K + 3) & ~3) * sizeof(int);
}

// One 16-byte asynchronous copy from global to shared memory (cp.async,
// through L2), and the wait for every copy this thread issued.
__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The boxes the walk reads: staged in shared memory (StagedBoxes) or in
// place (TableBoxes).
template <bool SMEM_BOXES>
using Boxes =
    typename std::conditional<SMEM_BOXES, StagedBoxes, TableBoxes>::type;

// With SMEM_BOXES, starts the block's copy of the quarter boxes, gathered
// into the frame's visit order, and of the order itself to the start of
// its dynamic shared memory `smem` (staged_box_bytes), and points `bx` at
// them; the caller waits with cp_async_wait_all() and a barrier. Returns
// the first float of shared memory past them.
template <bool SMEM_BOXES>
__device__ __forceinline__ float* stage_boxes(const MeshGeom& g,
                                              float4* smem,
                                              Boxes<SMEM_BOXES>& bx) {
  if constexpr (SMEM_BOXES) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int K = g.kb_sph + g.kb_tri;
    constexpr int ROW4 = 2 * QUARTERS;  // float4s of a subcluster's boxes
    int* order = reinterpret_cast<int*>(smem + ROW4 * K);
    for (int j = tid; j < ROW4 * K; j += nt)
      cp_async16(smem + j, g.qbox + ROW4 * g.order[j / ROW4] + j % ROW4);
    for (int i = tid; i < K; i += nt) order[i] = g.order[i];
    bx.box = smem;
    bx.order = order;
    return reinterpret_cast<float*>(order + ((K + 3) & ~3));
  } else {
    return reinterpret_cast<float*>(smem);
  }
}

// Dynamic shared memory of a block, in this order: the sample sums
// (common.cuh::SampleSums); with smem_lights the camera and the lights.
// ROUNDS = false is the one-round launch (S == n_samples).
template <bool ROUNDS>
__global__ void __launch_bounds__(FUSED_MAX_THREADS, FUSED_MIN_BLOCKS)
mesh_fused_kernel(const float* __restrict__ cam_in,
                  const float* __restrict__ dl_in, int n_dl,
                  const float* __restrict__ pl_in, int n_pl, MeshGeom g,
                  const float4* __restrict__ nodes, int leaves, int W, int H,
                  int N, int n_rows, int n_samples, int S, int bounce_limit,
                  int specular, int subtract, Sky sky, float scale,
                  int smem_lights, float* __restrict__ out_rgb,
                  int* __restrict__ out_count) {
  extern __shared__ float4 smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const SampleSums sm = sample_sums<1>(reinterpret_cast<float*>(smem), S);
  const float* cam = cam_in;
  Lights L;
  L.dl = dl_in;
  L.pl = pl_in;
  L.n_dl = n_dl;
  L.n_pl = n_pl;
  if (smem_lights) {
    float* sl = sm.end;
    const int n_dlf = DLIGHT_FLOATS * n_dl, n_plf = PLIGHT_FLOATS * n_pl;
    for (int i = tid; i < CAM_FLOATS + n_dlf + n_plf; i += nt) {
      sl[i] = i < CAM_FLOATS ? cam_in[i]
              : i < CAM_FLOATS + n_dlf ? dl_in[i - CAM_FLOATS]
                                       : pl_in[i - CAM_FLOATS - n_dlf];
    }
    cam = sl;
    L.dl = sl + CAM_FLOATS;
    L.pl = L.dl + n_dlf;
  }
  __syncthreads();

  const BvhTracer tr{g, nodes, leaves};
  const int n_lights = n_dl + n_pl;
  sample_threads<ROUNDS, 1>(
      sm, S, W, n_rows, n_samples,
      [&](int col, int row, int k, float& pr, float& pg, float& pb) {
        const Sample smp =
            trace_sample<true>(tr, L, cam, col, row, k, W, H, N,
                               bounce_limit, specular != 0, subtract != 0);
        sample_color(smp, sky, subtract != 0, pr, pg, pb);
        return Counts<1>{{(unsigned)(smp.bounces + smp.hits * n_lights)}};
      },
      ScaledWrite{scale, out_rgb, out_count});
}

MeshGeom make_geom(const float* sph, const float* sph_mat,
                   const float* sph_spec, const int* sph_id, const float* tri,
                   const float* tri_nrm, const float* tri_mat,
                   const float* tri_spec, const int* tri_id,
                   const float* qbox, const int* order, int kb_sph,
                   int kb_tri, bool cull) {
  MeshGeom g;
  g.sph = reinterpret_cast<const float4*>(sph);
  g.sph_mat = reinterpret_cast<const float4*>(sph_mat);
  g.sph_spec = sph_spec;
  g.sph_id = sph_id;
  g.tri = reinterpret_cast<const float4*>(tri);
  g.tri_nrm = reinterpret_cast<const float4*>(tri_nrm);
  g.tri_mat = reinterpret_cast<const float4*>(tri_mat);
  g.tri_spec = tri_spec;
  g.tri_id = tri_id;
  g.qbox = reinterpret_cast<const float4*>(qbox);
  g.order = order;
  g.kb_sph = kb_sph;
  g.kb_tri = kb_tri;
  g.cull = cull;
  return g;
}


// The launch shape of one band (see FUSED_BLOCK above).
struct FusedShape : SampleShape {
  bool smem_lights;
};

using FusedKernel = decltype(&mesh_fused_kernel<true>);

FusedKernel fused_kernel(bool rounds) {
  return rounds ? mesh_fused_kernel<true> : mesh_fused_kernel<false>;
}

cudaError_t fused_shape(int n_dl, int n_pl, int W, int n_rows, int n_samples,
                        FusedShape& sh) {
  sample_rounds(n_samples, sh);
  const size_t light_bytes =
      sizeof(float) * ((size_t)CAM_FLOATS + (size_t)DLIGHT_FLOATS * n_dl +
                       (size_t)PLIGHT_FLOATS * n_pl);
  sh.smem_lights = light_bytes <= SMEM_LIGHT_BYTES;
  const FusedKernel kernel = fused_kernel(sh.rounds);
  int optin = 0;
  cudaError_t err = allow_max_smem(kernel, optin);
  if (err == cudaSuccess)
    err = pick_block(kernel, sh.smem_lights ? light_bytes : 0, 1, optin,
                     FUSED_BLOCK, FUSED_MAX_THREADS, (long long)W * n_rows,
                     sh);
  if (err != cudaSuccess) return err;
  return sh.resident > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// The tree's leaf count from its table's rows (2 * leaves, leaves a power
// of two), or -1 when the table is not such a table or deeper than the
// walk's stack.
int bvh_leaves(int n_nodes) {
  if (n_nodes < 2 || (n_nodes & (n_nodes - 1)) != 0) return -1;
  const int leaves = n_nodes / 2;
  return leaves <= (1 << BVH_STACK) ? leaves : -1;
}

// The launch shape of pathtrace_mesh_kernel: a pixel's samples on S <=
// MAX_ROUND threads of one block; the block is the smallest of
// PT_MESH_BLOCK, 2 * PT_MESH_BLOCK, ... PT_MESH_MAX_THREADS that keeps the
// most warps resident on an SM (common.cuh::pick_block), with launch
// bounds of 64 registers a thread.
constexpr int PT_MESH_BLOCK = 128;
constexpr int PT_MESH_MAX_THREADS = 512;
constexpr int PT_MESH_MIN_BLOCKS = 2;

// The path-traced W x H x N frame of a MeshScene: pathtrace.cuh's
// trace_path over the MeshTracer, a pixel's samples on S threads of one
// block (common.cuh::sample_threads), each pixel's sample sum (reduce_sum)
// or its mean clipped to [0, 1] written with its two counts. Dynamic
// shared memory, in this order: with SMEM_BOXES the quarter boxes in the
// frame's visit order and the order (stage_boxes); the sample sums with
// two count channels; the camera and the area lights. ROUNDS = false is
// the one-round launch (S == N).
template <bool SMEM_BOXES, bool ROUNDS>
__global__ void __launch_bounds__(PT_MESH_MAX_THREADS, PT_MESH_MIN_BLOCKS)
pathtrace_mesh_kernel(const float* __restrict__ cam_in,
                      const float* __restrict__ al_in, int n_al, MeshGeom g,
                      int W, int H, int N, int S, int bounce_limit, Sky sky,
                      int reduce_sum, uint32_t seed,
                      float* __restrict__ out_rgb,
                      int* __restrict__ out_count) {
  extern __shared__ float4 smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  Boxes<SMEM_BOXES> bx{g.qbox, g.order};
  float* tail = stage_boxes<SMEM_BOXES>(g, smem, bx);
  const SampleSums sm = sample_sums<2>(tail, S);
  float* cam = sm.end;
  for (int i = tid; i < CAM_FLOATS + AL_FLOATS * n_al; i += nt)
    cam[i] = i < CAM_FLOATS ? cam_in[i] : al_in[i - CAM_FLOATS];
  if (SMEM_BOXES) cp_async_wait_all();
  __syncthreads();

  const MeshTracer<Boxes<SMEM_BOXES>> tr{g, bx};
  const float* al = cam + CAM_FLOATS;
  const PathWrite<true> sum{N, out_rgb, out_count};
  const PathWrite<false> mean{N, out_rgb, out_count};
  sample_threads<ROUNDS, 2>(
      sm, S, W, H, N,
      [&](int col, int row, int k, float& pr, float& pg, float& pb) {
        return trace_path(tr, cam, al, n_al, sky, col, row, k, W, H,
                          bounce_limit, seed, pr, pg, pb);
      },
      [&](int pix, int n_pixels, float r, float g_, float b,
          const Counts<2>& n) {
        if (reduce_sum)
          sum(pix, n_pixels, r, g_, b, n);
        else
          mean(pix, n_pixels, r, g_, b, n);
      });
}

using PathMeshKernel = decltype(&pathtrace_mesh_kernel<true, true>);

PathMeshKernel pathtrace_mesh_kernel_for(bool smem_boxes, bool rounds) {
  return smem_boxes ? (rounds ? pathtrace_mesh_kernel<true, true>
                              : pathtrace_mesh_kernel<true, false>)
                    : (rounds ? pathtrace_mesh_kernel<false, true>
                              : pathtrace_mesh_kernel<false, false>);
}

struct PathMeshShape : SampleShape {
  bool smem_boxes;
};

// The boxes are staged when they fit in a block beside the sample sums,
// the camera and the lights; else the kernel reads them in place.
cudaError_t pathtrace_mesh_shape(int K, int n_al, int W, int H, int N,
                                 PathMeshShape& sh) {
  sample_rounds(N, sh);
  const size_t cam_bytes =
      sizeof(float) * ((size_t)CAM_FLOATS + (size_t)AL_FLOATS * n_al);
  for (sh.smem_boxes = true;; sh.smem_boxes = false) {
    const PathMeshKernel kernel =
        pathtrace_mesh_kernel_for(sh.smem_boxes, sh.rounds);
    int optin = 0;
    cudaError_t err = allow_max_smem(kernel, optin);
    if (err == cudaSuccess)
      err = pick_block(kernel,
                       (sh.smem_boxes ? staged_box_bytes(K) : 0) + cam_bytes,
                       2, optin, PT_MESH_BLOCK, PT_MESH_MAX_THREADS,
                       (long long)W * H, sh);
    if (err != cudaSuccess) return err;
    if (sh.resident > 0) return cudaSuccess;
    if (!sh.smem_boxes) return cudaErrorInvalidConfiguration;
  }
}

// The launch bounds of cluster_nearest_kernel hold a thread to
// 65536 / (NEAREST_MAX_THREADS * NEAREST_MIN_BLOCKS) = 64 registers; its
// block is the smallest of NEAREST_BLOCK, 2 * NEAREST_BLOCK, ...
// NEAREST_MAX_THREADS that keeps the most warps resident on an SM
// (common.cuh::pick_block). PERF.md records the layouts compared before
// these were kept (a 40-register cap spills; the box table staged in
// shared memory lost on bounce rays).
constexpr int NEAREST_BLOCK = 128;
constexpr int NEAREST_MAX_THREADS = 512;
constexpr int NEAREST_MIN_BLOCKS = 2;

// One thread per ray; the quarter boxes read in place, through L1.
__global__ void __launch_bounds__(NEAREST_MAX_THREADS, NEAREST_MIN_BLOCKS)
cluster_nearest_kernel(const float* __restrict__ ox,
                       const float* __restrict__ oy,
                       const float* __restrict__ oz,
                       const float* __restrict__ dx,
                       const float* __restrict__ dy,
                       const float* __restrict__ dz, int n, MeshGeom g,
                       float* __restrict__ out_t, int* __restrict__ out_id) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Nearest best = nearest(g, IndexBoxes{g.qbox}, ox[i], oy[i], oz[i],
                               dx[i], dy[i], dz[i]);
  out_t[i] = best.t;
  out_id[i] = best.id;
}

// The launch for n rays (one thread each).
cudaError_t nearest_shape(int n, SampleShape& sh) {
  sh.samples = 1;
  sh.rounds = false;
  const cudaError_t err =
      pick_block(cluster_nearest_kernel, 0, 0, 0, NEAREST_BLOCK,
                 NEAREST_MAX_THREADS, n, sh);
  if (err != cudaSuccess) return err;
  return sh.resident > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

extern "C" {

// Render rows [cam[15], cam[15] + n_rows) and samples
// [cam[16], cam[16] + n_samples) of a W x H x N frame on `stream`; writes
// the (3, n_rows, W) sample sum times `scale` and the per-pixel trace
// counts. `nodes` is the kernel tables' node table of n_nodes rows of 8
// floats (ttrt_torch/mesh/bvh.py). `texels` is the image sky's
// (6, sky_dim, sky_dim) int32 table, read only when sky_kind is SKY_IMAGE.
// Returns cudaGetLastError() (0 on success). The float4 tables must be
// 16-byte aligned (fresh torch allocations are).
int ttrt_mesh_fused(const float* cam, const float* dl, int n_dl,
                    const float* pl, int n_pl, const float* sph,
                    const float* sph_mat, const float* sph_spec,
                    const int* sph_id, const float* tri, const float* tri_nrm,
                    const float* tri_mat, const float* tri_spec,
                    const int* tri_id, const float* nodes, int n_nodes,
                    int kb_sph, int kb_tri, int W, int H, int N, int n_rows,
                    int n_samples, int bounce_limit, int specular,
                    int subtract, int sky_kind, int sky_dim, int bilinear,
                    const int* texels, float scale, float* out_rgb,
                    int* out_count, void* stream) {
  const int leaves = bvh_leaves(n_nodes);
  if (n_dl < 0 || n_pl < 0 ||
      W < 1 || H < 1 || N < 1 || n_rows < 1 || n_samples < 1 ||
      kb_sph < 0 || kb_tri < 0 || sky_dim < 1 || sky_kind < SKY_COLORS ||
      sky_kind > SKY_IMAGE || (sky_kind == SKY_IMAGE && texels == nullptr) ||
      nodes == nullptr || leaves < 0)
    return (int)cudaErrorInvalidValue;
  const Sky sky{sky_kind, sky_dim, bilinear != 0, texels};
  const MeshGeom g =
      make_geom(sph, sph_mat, sph_spec, sph_id, tri, tri_nrm, tri_mat,
                tri_spec, tri_id, nullptr, nullptr, kb_sph, kb_tri, true);
  FusedShape sh;
  const cudaError_t err = fused_shape(n_dl, n_pl, W, n_rows, n_samples, sh);
  if (err != cudaSuccess) return (int)err;
  fused_kernel(sh.rounds)<<<sh.blocks, sh.threads, sh.smem,
                            (cudaStream_t)stream>>>(
      cam, dl, n_dl, pl, n_pl, g, reinterpret_cast<const float4*>(nodes),
      leaves, W, H, N, n_rows, n_samples, sh.samples, bounce_limit, specular,
      subtract, sky, scale, sh.smem_lights ? 1 : 0, out_rgb, out_count);
  return (int)cudaGetLastError();
}

// The launch shape ttrt_mesh_fused takes for a band of these sizes, into
// out[10]: sample threads of a pixel, pixels of a block, threads of a
// block, blocks, dynamic shared bytes of a block, camera and lights
// staged (1) or read in place (0), blocks an SM holds, SMs, and the
// chosen instantiation's registers and local (stack and spill) bytes of a
// thread. Returns a CUDA error code (0 on success).
int ttrt_mesh_fused_layout(int n_dl, int n_pl, int W, int n_rows,
                           int n_samples, int* out) {
  if (n_dl < 0 || n_pl < 0 || W < 1 || n_rows < 1 || n_samples < 1)
    return (int)cudaErrorInvalidValue;
  FusedShape sh;
  cudaError_t err = fused_shape(n_dl, n_pl, W, n_rows, n_samples, sh);
  int dev = 0, sms = 0;
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, fused_kernel(sh.rounds));
  if (err != cudaSuccess) return (int)err;
  const int vals[10] = {sh.samples, sh.pixels, sh.threads, sh.blocks,
                        (int)sh.smem, sh.smem_lights ? 1 : 0, sh.resident,
                        sms, attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

// Nearest (t, original id) of n rays on `stream`; t = inf and id = -1 on a
// miss. mode 0 culls with the quarter AABBs, mode 1 tests every object.
int ttrt_cluster_nearest(const float* ox, const float* oy, const float* oz,
                         const float* dx, const float* dy, const float* dz,
                         int n, const float* sph, const int* sph_id,
                         const float* tri, const int* tri_id,
                         const float* qbox, int kb_sph, int kb_tri, int mode,
                         float* out_t, int* out_id, void* stream) {
  if (n < 0 || kb_sph < 0 || kb_tri < 0 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const MeshGeom g =
      make_geom(sph, nullptr, nullptr, sph_id, tri, nullptr, nullptr,
                nullptr, tri_id, qbox, nullptr, kb_sph, kb_tri, mode == 0);
  SampleShape sh;
  const cudaError_t err = nearest_shape(n, sh);
  if (err != cudaSuccess) return (int)err;
  cluster_nearest_kernel<<<sh.blocks, sh.threads, 0, (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, n, g, out_t, out_id);
  return (int)cudaGetLastError();
}

// The launch shape ttrt_cluster_nearest takes for n rays, into out[6]:
// threads of a block, blocks, blocks an SM holds, SMs, and the kernel's
// registers and local (spill) bytes of a thread. Returns a CUDA error code
// (0 on success).
int ttrt_cluster_nearest_layout(int n, int* out) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  SampleShape sh;
  cudaError_t err = nearest_shape(n, sh);
  int dev = 0, sms = 0;
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, cluster_nearest_kernel);
  if (err != cudaSuccess) return (int)err;
  const int vals[6] = {sh.threads, sh.blocks, sh.resident, sms,
                       attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}

// Path-trace the W x H x N frame of a MeshScene on `stream`
// (pathtrace_mesh_kernel): `cam` is the packed camera, `al` the n_al area
// lights (8 floats each), the tables and the visit order `order` as
// ttrt_mesh_fused's. Writes the (3, H, W) clipped sample mean, or with
// `reduce_sum` the unclipped sample sum, and the (2, H, W) counts:
// nearest-hit traces | hits << 16 and the unblocked shadow rays. Returns
// cudaGetLastError() (0 on success).
int ttrt_pathtrace_mesh(const float* cam, const float* al, int n_al,
                        const float* sph, const float* sph_mat,
                        const float* sph_spec, const int* sph_id,
                        const float* tri, const float* tri_nrm,
                        const float* tri_mat, const float* tri_spec,
                        const int* tri_id, const float* qbox,
                        const int* order, int kb_sph, int kb_tri, int W,
                        int H, int N, int bounce_limit, int sky_kind,
                        int sky_dim, int bilinear, int reduce_sum,
                        uint32_t seed, float* out_rgb, int* out_count,
                        void* stream) {
  if (kb_sph < 0 || kb_tri < 0 || order == nullptr ||
      !path_args_ok(n_al, W, H, N, bounce_limit, sky_kind, sky_dim))
    return (int)cudaErrorInvalidValue;
  const Sky sky{sky_kind, sky_dim, bilinear != 0, nullptr};
  const MeshGeom g =
      make_geom(sph, sph_mat, sph_spec, sph_id, tri, tri_nrm, tri_mat,
                tri_spec, tri_id, qbox, order, kb_sph, kb_tri, true);
  PathMeshShape sh;
  const cudaError_t err =
      pathtrace_mesh_shape(kb_sph + kb_tri, n_al, W, H, N, sh);
  if (err != cudaSuccess) return (int)err;
  pathtrace_mesh_kernel_for(sh.smem_boxes, sh.rounds)<<<
      sh.blocks, sh.threads, sh.smem, (cudaStream_t)stream>>>(
      cam, al, n_al, g, W, H, N, sh.samples, bounce_limit, sky, reduce_sum,
      seed, out_rgb, out_count);
  return (int)cudaGetLastError();
}

// The launch shape ttrt_pathtrace_mesh takes for a frame of these sizes,
// into out[10] (common.cuh::write_layout; `staged`: the boxes). Returns a
// CUDA error code (0 on success).
int ttrt_pathtrace_mesh_layout(int kb_sph, int kb_tri, int n_al, int W,
                               int H, int N, int* out) {
  if (kb_sph < 0 || kb_tri < 0 || n_al < 0 || W < 1 || H < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  PathMeshShape sh;
  const cudaError_t err =
      pathtrace_mesh_shape(kb_sph + kb_tri, n_al, W, H, N, sh);
  if (err != cudaSuccess) return (int)err;
  return write_layout(sh, sh.smem_boxes,
                      pathtrace_mesh_kernel_for(sh.smem_boxes, sh.rounds),
                      out);
}

}  // extern "C"
