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
//
// Design. One thread per pixel (mesh_fused, 16x8 pixel blocks so that a
// warp's rays are coherent) or per ray (cluster_nearest), with common.cuh's
// sample and bounce loops: none of the TPU kernel's (ray tile, phase) grid,
// VMEM state, sublane-class partials or two-level sweep, which worked
// around the TPU's scalar-sync cost. Each trace walks the K subclusters in
// the per-frame near-to-far order the wrapper computes (mesh_fused) or in
// index order (cluster_nearest), slab-tests each subcluster's four quarter
// AABBs with the clamped 1/d (mesh_fused.py:283-288, :602-622), skips a
// quarter whose entry time is past the best t so far, and narrow-tests the
// quarter's real objects (32 Morton-consecutive ones, fewer at the end of
// the pack). Shadow rays take the same walk and stop at the first blocker.
// Geometry stays in device memory behind L1/L2: at 10k spheres the pack is
// about 400 KB, more than a block's 227 KB of shared memory.
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
// is exact because the kernel tables widen every quarter AABB
// (ttrt_torch/mesh/clusters.py::BOX_PAD) by more than the narrow tests'
// rounding can place a hit outside it.
//
// What bounds it on this card: operations, not bytes. A 480x280x10x10 frame
// at 10k spheres reads the 0.7 MB pack and writes 2.2 MB, microseconds at
// 3.35 TB/s, but performs millions of traces, each with hundreds of slab
// tests and about a thousand narrow tests (chip_smoke.py counts them and
// PERF.md gives the bound). The walk is divergent: the rays of a warp live
// for different numbers of bounces and enter different quarters. Staging
// the visited subclusters in shared memory and a tighter per-warp order are
// later work.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int QUARTERS = 4;       // culling boxes per subcluster
constexpr int QBLOCK = 32;        // objects per quarter
constexpr int SUB = QUARTERS * QBLOCK;  // objects per subcluster
constexpr int TILE_X = 16;        // mesh_fused pixel block
constexpr int TILE_Y = 8;
constexpr int NEAREST_BLOCK = 128;

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
  const int* order;       // visit order of the K subclusters; null: 0..K-1
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

// Slab test of quarter `row` (mesh_fused.py:602-622): passes when the ray
// line meets the box at t >= 0; returns the count of real objects in the
// quarter (0 when it does not pass) and the entry time tn.
__device__ __forceinline__ int quarter(const MeshGeom& g, int row, float ox,
                                       float oy, float oz, float ivx,
                                       float ivy, float ivz, float& tn) {
  const float4 a = g.qbox[2 * row];
  const float4 b = g.qbox[2 * row + 1];
  const int n = (int)b.z;
  tn = 0.0f;
  if (n == 0 || !g.cull) return n;
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
// disc = b*b - 4a*c, hit = disc >= 0 && b < 0 && c > 0.
__device__ __forceinline__ bool sphere_t(const float4 c, const Ray& r,
                                         float& t0) {
  const float cd = dot_zyx(c.x, c.y, c.z, r.dx, r.dy, r.dz);
  const float co = dot_zyx(c.x, c.y, c.z, r.ox, r.oy, r.oz);
  const float b = 2.0f * (r.od - cd);
  const float cc = r.oo - 2.0f * co + c.w;
  const float disc = fmaf(b, b, -(r.fa * cc));
  t0 = (-b - sqrtf(fmaxf(disc, 0.0f))) * r.inv2a;
  return disc >= 0.0f && b < 0.0f && cc > 0.0f;
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

// Nearest (t, original id) over the pack: the culled walk, with the
// lowest id winning an exact tie in t.
__device__ Nearest nearest(const MeshGeom& g, float ox, float oy, float oz,
                           float dx, float dy, float dz) {
  const Ray r = make_ray(ox, oy, oz, dx, dy, dz);
  const float ivx = cinv(dx), ivy = cinv(dy), ivz = cinv(dz);
  Nearest best;
  best.t = CUDART_INF_F;
  best.id = -1;
  best.pos = 0;
  best.tri = false;
  const int K = g.kb_sph + g.kb_tri;
  for (int i = 0; i < K; ++i) {
    const int sub = g.order != nullptr ? g.order[i] : i;
    const bool is_tri = sub >= g.kb_sph;
    for (int q = 0; q < QUARTERS; ++q) {
      float tn;
      const int n = quarter(g, sub * QUARTERS + q, ox, oy, oz, ivx, ivy, ivz,
                            tn);
      if (n == 0 || tn > best.t) continue;
      const int base = (is_tri ? sub - g.kb_sph : sub) * SUB + q * QBLOCK;
      for (int j = 0; j < n; ++j) {
        const int pos = base + j;
        float t;
        bool hit;
        if (is_tri) {
          hit = tri_t(g.tri + 3 * pos, ox, oy, oz, dx, dy, dz, t);
        } else {
          hit = sphere_t(g.sph[pos], r, t);
        }
        if (!hit || t > best.t) continue;
        const int id = is_tri ? g.tri_id[pos] : g.sph_id[pos];
        if (t < best.t || id < best.id) {
          best.t = t;
          best.id = id;
          best.pos = pos;
          best.tri = is_tri;
        }
      }
    }
  }
  return best;
}

// The many-object tracer for common.cuh's render_pixel.
struct MeshTracer {
  MeshGeom g;

  __device__ Hit trace(float ox, float oy, float oz, float dx, float dy,
                       float dz) const {
    const Nearest b = nearest(g, ox, oy, oz, dx, dy, dz);
    if (b.id < 0) return miss_hit(ox, oy, oz, dx, dy, dz);
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

  // Any-hit shadow test from p along a UNIT direction (a == 1), blockers
  // before tmax only when has_tmax (point lights).
  __device__ bool blocked(float px, float py, float pz, float ldx, float ldy,
                          float ldz, bool has_tmax, float tmax) const {
    const float soo = px * px + py * py + pz * pz;
    const float od = px * ldx + py * ldy + pz * ldz;
    const float ivx = cinv(ldx), ivy = cinv(ldy), ivz = cinv(ldz);
    const int K = g.kb_sph + g.kb_tri;
    for (int i = 0; i < K; ++i) {
      const int sub = g.order != nullptr ? g.order[i] : i;
      const bool is_tri = sub >= g.kb_sph;
      for (int q = 0; q < QUARTERS; ++q) {
        float tn;
        const int n = quarter(g, sub * QUARTERS + q, px, py, pz, ivx, ivy,
                              ivz, tn);
        if (n == 0 || (has_tmax && tn > tmax)) continue;
        const int base = (is_tri ? sub - g.kb_sph : sub) * SUB + q * QBLOCK;
        for (int j = 0; j < n; ++j) {
          const int pos = base + j;
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
          if (hit) return true;
        }
      }
    }
    return false;
  }
};

// The camera and the lights go into dynamic shared memory up to this size
// (no opt-in attribute needed): thousands of lights. More are read in place
// from their global arrays.
constexpr size_t SMEM_LIGHT_BYTES = 48 * 1024;

__global__ void __launch_bounds__(TILE_X * TILE_Y)
mesh_fused_kernel(const float* __restrict__ cam_in,
                  const float* __restrict__ dl_in, int n_dl,
                  const float* __restrict__ pl_in, int n_pl, MeshGeom g,
                  int W, int H, int N, int n_rows, int n_samples,
                  int bounce_limit, int specular, int subtract, Sky sky,
                  float scale, int smem,
                  float* __restrict__ out_rgb,
                  int* __restrict__ out_count) {
  extern __shared__ float sbuf[];
  const int n_dlf = DLIGHT_FLOATS * n_dl, n_plf = PLIGHT_FLOATS * n_pl;
  const float* cam = cam_in;
  Lights L;
  L.dl = dl_in;
  L.pl = pl_in;
  L.n_dl = n_dl;
  L.n_pl = n_pl;
  if (smem) {
    const int tid = threadIdx.y * TILE_X + threadIdx.x;
    for (int i = tid; i < CAM_FLOATS + n_dlf + n_plf; i += TILE_X * TILE_Y) {
      sbuf[i] = i < CAM_FLOATS ? cam_in[i]
                : i < CAM_FLOATS + n_dlf ? dl_in[i - CAM_FLOATS]
                                         : pl_in[i - CAM_FLOATS - n_dlf];
    }
    __syncthreads();
    cam = sbuf;
    L.dl = sbuf + CAM_FLOATS;
    L.pl = L.dl + n_dlf;
  }

  const int col = blockIdx.x * TILE_X + threadIdx.x;
  const int row = blockIdx.y * TILE_Y + threadIdx.y;
  if (col >= W || row >= n_rows) return;

  MeshTracer tr;
  tr.g = g;

  float acc_r, acc_g, acc_b;
  int bounces, hits;
  render_pixel(tr, L, cam, col, row, W, H, N, n_samples, bounce_limit,
               specular != 0, subtract != 0, sky, acc_r, acc_g, acc_b,
               bounces, hits);
  const int n_pixels = W * n_rows;
  const int pix = row * W + col;
  out_rgb[pix] = acc_r * scale;
  out_rgb[n_pixels + pix] = acc_g * scale;
  out_rgb[2 * n_pixels + pix] = acc_b * scale;
  out_count[pix] = bounces + hits * (n_dl + n_pl);
}

__global__ void __launch_bounds__(NEAREST_BLOCK)
cluster_nearest_kernel(const float* __restrict__ ox,
                       const float* __restrict__ oy,
                       const float* __restrict__ oz,
                       const float* __restrict__ dx,
                       const float* __restrict__ dy,
                       const float* __restrict__ dz, int n, MeshGeom g,
                       float* __restrict__ out_t, int* __restrict__ out_id) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Nearest b = nearest(g, ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
  out_t[i] = b.t;
  out_id[i] = b.id;
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

}  // namespace

extern "C" {

// Render rows [cam[15], cam[15] + n_rows) and samples
// [cam[16], cam[16] + n_samples) of a W x H x N frame on `stream`; writes
// the (3, n_rows, W) sample sum times `scale` and the per-pixel trace
// counts. `texels` is the image sky's (6, sky_dim, sky_dim) int32 table,
// read only when sky_kind is SKY_IMAGE. Returns cudaGetLastError() (0 on
// success). The float4 tables must be 16-byte aligned (fresh torch
// allocations are).
int ttrt_mesh_fused(const float* cam, const float* dl, int n_dl,
                    const float* pl, int n_pl, const float* sph,
                    const float* sph_mat, const float* sph_spec,
                    const int* sph_id, const float* tri, const float* tri_nrm,
                    const float* tri_mat, const float* tri_spec,
                    const int* tri_id, const float* qbox, const int* order,
                    int kb_sph, int kb_tri, int W, int H, int N, int n_rows,
                    int n_samples, int bounce_limit, int specular,
                    int subtract, int sky_kind, int sky_dim, int bilinear,
                    const int* texels, float scale, float* out_rgb,
                    int* out_count, void* stream) {
  if (n_dl < 0 || n_pl < 0 ||
      W < 1 || H < 1 || N < 1 || n_rows < 1 || n_samples < 1 ||
      kb_sph < 0 || kb_tri < 0 || sky_dim < 1 || sky_kind < SKY_COLORS ||
      sky_kind > SKY_IMAGE || (sky_kind == SKY_IMAGE && texels == nullptr))
    return (int)cudaErrorInvalidValue;
  const Sky sky{sky_kind, sky_dim, bilinear != 0, texels};
  const MeshGeom g =
      make_geom(sph, sph_mat, sph_spec, sph_id, tri, tri_nrm, tri_mat,
                tri_spec, tri_id, qbox, order, kb_sph, kb_tri, true);
  const size_t bytes =
      sizeof(float) * ((size_t)CAM_FLOATS + (size_t)DLIGHT_FLOATS * n_dl +
                       (size_t)PLIGHT_FLOATS * n_pl);
  const bool smem = bytes <= SMEM_LIGHT_BYTES;
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid((W + TILE_X - 1) / TILE_X, (n_rows + TILE_Y - 1) / TILE_Y);
  mesh_fused_kernel<<<grid, block, smem ? bytes : 0, (cudaStream_t)stream>>>(
      cam, dl, n_dl, pl, n_pl, g, W, H, N, n_rows, n_samples, bounce_limit,
      specular, subtract, sky, scale, smem ? 1 : 0, out_rgb, out_count);
  return (int)cudaGetLastError();
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
  const int grid = (n + NEAREST_BLOCK - 1) / NEAREST_BLOCK;
  cluster_nearest_kernel<<<grid, NEAREST_BLOCK, 0, (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, n, g, out_t, out_id);
  return (int)cudaGetLastError();
}

}  // extern "C"
