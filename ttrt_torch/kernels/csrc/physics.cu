// The physics step kernel: physics/world.py::physics_step_plain (the sphere
// world without obstacles) for `substeps` substeps in ONE launch.
//
// No TPU kernel: JAX jits the step (ttrt/physics/world.py) into its frame
// program. The eager step is a few thousand one-element ATen ops a frame
// (6 bodies, 15 pairs, 4 substeps), so launches, not operations or bytes,
// set its time; this kernel's bound is its one launch.
//
// Design: one block holds the whole world for the whole call. Thread k < n
// is body k (its state in registers, a copy in shared memory for the
// pairs); thread q < P = n(n-1)/2 is the q-th pair (i, j), i < j, in the
// upper-triangle order of world.py::_pair_indices. A substep is
//
//   integrate (bodies) | barrier | GJK, impulse, correction (pairs) |
//   barrier | pair sums, ground, walls (bodies)
//
// so the world never leaves the block and the host never waits. Each pair
// runs gjk.py::gjk_distance's general loop on the sphere supports alone
// (a lane stops at its own `done`, as the eager lockstep loop masks a done
// lane, which never changes again) and computes only the simplex case its
// size selects (the eager code computes every case and selects: the same
// bits). Each body adds its pair terms in _PairSums's fixed order, one at a
// time: as body i in pair order, then as body j in pair order; no atomics.
//
// Floating point: the eager ops one for one, in their association order
// (Vec3.dot is (x*x + y*y) + z*z), built with --fmad=false and IEEE
// division; the square root is the correctly rounded one (vec.py::sqrt_rn);
// constants are Python doubles rounded once to float32, as PyTorch rounds a
// scalar operand; clamps keep a NaN, as PyTorch's do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_PAIRS = MAX_THREADS;
constexpr int MAX_BODIES = 45;  // the largest n with n(n-1)/2 <= MAX_PAIRS
constexpr int MAX_ITERS = 20;   // gjk.py::MAX_ITERS

constexpr float GJK_EPS = (float)1e-10;       // gjk.py::_EPS
constexpr float PROGRESS_TOL = (float)1e-7;   // the convergence test
constexpr float TINY2 = (float)1e-12;         // |v|^2 at the origin
constexpr float CORE_EPS = (float)1e-9;       // cores that coincide
constexpr float SAFE_LEN = (float)1e-12;      // the normal's divisor floor
constexpr float IM_FLOOR = (float)1e-12;      // the inverse-mass sum floor
constexpr float NORMALIZE_GUARD = (float)1e-4;  // config.NORMALIZE_GUARD

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// gjk.py::_lerp: p + t e
__device__ __forceinline__ V3 lerp(V3 p, float t, V3 e) {
  return {p.x + t * e.x, p.y + t * e.y, p.z + t * e.z};
}

// torch.clamp_min / clamp: a NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// gjk.py::_safe: a denominator, 1 where it is within _EPS of 0
__device__ __forceinline__ float safe(float den) {
  return fabsf(den) < GJK_EPS ? 1.0f : den;
}

// vec.py::Vec3.normalize: identity when the length is <= 1e-4
__device__ __forceinline__ V3 normalize(V3 v) {
  const float len = __fsqrt_rn(dot(v, v));
  const float inv = len > NORMALIZE_GUARD ? 1.0f / len : 1.0f;
  return {v.x * inv, v.y * inv, v.z * inv};
}

// The closest point to the origin on triangle pqr and the sub-simplex that
// supports it (gjk.py::_closest_simplex's size-3 case and its tri_closest):
// vertices over edges over the face interior. Returns the sub-simplex's
// size; its points go to s1, s2 (the third is r's slot, left as the caller
// had it).
__device__ int triangle(V3 p, V3 q, V3 r, V3& cp, V3& s1, V3& s2) {
  const V3 e1 = sub(q, p);
  const V3 e2 = sub(r, p);
  const float d1 = dot(e1, neg(p));
  const float d2 = dot(e2, neg(p));
  const float d3 = dot(e1, neg(q));
  const float d4 = dot(e2, neg(q));
  const float d5 = dot(e1, neg(r));
  const float d6 = dot(e2, neg(r));
  const float vc = d1 * d4 - d3 * d2;
  const float vb = d5 * d2 - d1 * d6;
  const float va = d3 * d6 - d5 * d4;
  if (d1 <= 0.0f && d2 <= 0.0f) {  // vertex p
    cp = p, s1 = p, s2 = p;
    return 1;
  }
  if (d3 >= 0.0f && d4 <= d3) {  // vertex q
    cp = q, s1 = q, s2 = q;
    return 1;
  }
  if (d6 >= 0.0f && d5 <= d6) {  // vertex r
    cp = r, s1 = r, s2 = r;
    return 1;
  }
  if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {  // edge pq
    cp = lerp(p, d1 / safe(d1 - d3), e1), s1 = p, s2 = q;
    return 2;
  }
  if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {  // edge pr
    cp = lerp(p, d2 / safe(d2 - d6), e2), s1 = p, s2 = r;
    return 2;
  }
  if (va <= 0.0f && d4 - d3 >= 0.0f && d5 - d6 >= 0.0f) {  // edge qr
    cp = lerp(q, (d4 - d3) / safe((d4 - d3) + (d5 - d6)), sub(r, q));
    s1 = q, s2 = r;
    return 2;
  }
  const float den = safe(va + vb + vc);
  const float w_b = vb / den;
  const float w_c = vc / den;
  cp = {p.x + w_b * e1.x + w_c * e2.x, p.y + w_b * e1.y + w_c * e2.y,
        p.z + w_b * e1.z + w_c * e2.z};
  s1 = p, s2 = q;
  return 3;
}

// gjk.py::_closest_simplex on the points (a, b, c, d) of a simplex of
// `size` (1..4), the case of that size alone: the closest point to the
// origin, the supporting sub-simplex compacted into n1, n2, n3 (the
// caller's p1, p2, p3), and its size.
__device__ int closest_simplex(V3 a, V3 b, V3 c, V3 d, int size, V3& closest,
                               V3& n1, V3& n2, V3& n3) {
  if (size == 1) {
    closest = a, n1 = a, n2 = a, n3 = a;
    return 1;
  }
  if (size == 2) {
    const V3 ab = sub(b, a);
    float t = -dot(a, ab) / clamp_min(dot(ab, ab), GJK_EPS);
    t = clamp(t, 0.0f, 1.0f);
    closest = lerp(a, t, ab);
    n1 = t >= 1.0f ? b : a;
    n2 = b;
    n3 = a;
    return t > 0.0f && t < 1.0f ? 2 : 1;
  }
  if (size == 3) {
    n3 = c;
    return triangle(a, b, c, closest, n1, n2);
  }
  // size 4: the origin against the 4 faces; inside all, distance 0; else the
  // nearest separating face's triangle case (a face that does not separate
  // never wins: its distance is inf)
  const V3 faces[4][4] = {{a, b, c, d}, {a, b, d, c}, {a, c, d, b},
                          {b, c, d, a}};
  bool inside = true;
  float best = 0.0f;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const V3 p = faces[f][0], q = faces[f][1], r = faces[f][2];
    const V3 nrm = cross(sub(q, p), sub(r, p));
    const bool sep = dot(nrm, neg(p)) * dot(nrm, sub(faces[f][3], p)) < 0.0f;
    inside = inside && !sep;
    if (f > 0 && !sep) continue;
    V3 cp, s1, s2;
    triangle(p, q, r, cp, s1, s2);
    const float dist = sep ? dot(cp, cp) : INFINITY;
    if (f == 0 || dist < best) {
      closest = cp, n1 = p, n2 = q, n3 = r, best = dist;
    }
  }
  if (inside) {
    closest = {0.0f, 0.0f, 0.0f};
    return 4;
  }
  return 3;
}

// gjk.py::gjk_distance on two spheres (a point core and its radius as the
// margin; the support of a point is the point, in every direction): the
// signed distance and the unit normal from B toward A.
__device__ void gjk_spheres(V3 ca, float ra, V3 cb, float rb, float& dist,
                            V3& normal) {
  const V3 x0 = sub(ca, cb);
  // the support of A - B toward any direction (the first one, the
  // normalized guess, included)
  const V3 w0 = sub(ca, cb);
  V3 p1 = w0, p2 = w0, p3 = w0, closest = w0;
  int size = 1;
  bool done = false;
  for (int it = 0; it < MAX_ITERS && !done; ++it) {
    const V3 v = closest;
    const float vlen2 = dot(v, v);
    const V3 w = sub(ca, cb);  // the support toward -v
    const float progress = vlen2 - dot(v, w);
    if (progress <= PROGRESS_TOL * clamp_min(vlen2, 1.0f) || vlen2 < TINY2)
      break;  // converged: no significant progress toward the origin
    // insert w at the front; the eager loop's 4th slot is never read
    V3 nw, r1, r2, r3;
    const int rsize =
        closest_simplex(w, p1, p2, p3, min(size + 1, 4), nw, r1, r2, r3);
    p1 = r1, p2 = r2, p3 = r3, size = rsize, closest = nw;
    done = rsize == 4 && dot(nw, nw) < TINY2;
  }
  const V3 v = closest;
  const float core = __fsqrt_rn(clamp_min(dot(v, v), 0.0f));
  dist = core - (ra + rb);
  const float s = clamp_min(core, SAFE_LEN);
  // deep overlap (the cores coincide): the initial guess's axis
  normal = core < CORE_EPS ? normalize(x0)
                           : V3{v.x / s, v.y / s, v.z / s};
}

// the index of pair (i, j), i < j, in the upper-triangle order
__device__ __forceinline__ int pair_index(int i, int j, int n) {
  return i * (2 * n - i - 1) / 2 + (j - i - 1);
}

__global__ void __launch_bounds__(MAX_THREADS) physics_step_kernel(
    const float* __restrict__ pos_x, const float* __restrict__ pos_y,
    const float* __restrict__ pos_z, const float* __restrict__ vel_x,
    const float* __restrict__ vel_y, const float* __restrict__ vel_z,
    const float* __restrict__ t_in, const float* __restrict__ radius,
    const float* __restrict__ inv_mass, const float* __restrict__ gravity,
    const float* __restrict__ restitution, const float* __restrict__ ground_y,
    const float* __restrict__ bounds, const float* __restrict__ dt, int n,
    int substeps, float* __restrict__ out) {
  // the bodies' integrated state, which the pairs read
  __shared__ float s_px[MAX_BODIES], s_py[MAX_BODIES], s_pz[MAX_BODIES];
  __shared__ float s_vx[MAX_BODIES], s_vy[MAX_BODIES], s_vz[MAX_BODIES];
  // each pair's impulse, correction and normal, which the bodies add
  __shared__ float s_jimp[MAX_PAIRS], s_corr[MAX_PAIRS];
  __shared__ float s_nx[MAX_PAIRS], s_ny[MAX_PAIRS], s_nz[MAX_PAIRS];

  const int tid = threadIdx.x;
  const int n_pairs = n * (n - 1) / 2;
  const bool is_body = tid < n;
  const bool is_pair = tid < n_pairs;

  const float h = dt[0] / (float)substeps;
  const float e = restitution[0];
  const float neg_e = -e;
  const float neg_e1 = -(1.0f + e);
  // gravity * h * movable, with movable 1 or 0 (a static body's inv_mass
  // is 0)
  const float gx_h = gravity[0] * h, gy_h = gravity[1] * h,
              gz_h = gravity[2] * h;

  float px = 0.0f, py = 0.0f, pz = 0.0f, vx = 0.0f, vy = 0.0f, vz = 0.0f;
  float im = 0.0f, movable = 0.0f, floor_y = 0.0f, hi = 0.0f;
  if (is_body) {
    px = pos_x[tid], py = pos_y[tid], pz = pos_z[tid];
    vx = vel_x[tid], vy = vel_y[tid], vz = vel_z[tid];
    im = inv_mass[tid];
    movable = im > 0.0f ? 1.0f : 0.0f;
    floor_y = ground_y[0] + radius[tid];
    hi = bounds[0] - radius[tid];
  }
  int pi = 0, pj = 0;
  float ra = 0.0f, rb = 0.0f, ima = 0.0f, imb = 0.0f;
  if (is_pair) {
    int q = tid;  // the pair's place among body pi's pairs
    while (q >= n - 1 - pi) {
      q -= n - 1 - pi;
      ++pi;
    }
    pj = pi + 1 + q;
    ra = radius[pi], rb = radius[pj];
    ima = inv_mass[pi], imb = inv_mass[pj];
  }
  float t = t_in[0];

  for (int step = 0; step < substeps; ++step) {
    // semi-implicit Euler
    if (is_body) {
      vx = vx + gx_h * movable;
      vy = vy + gy_h * movable;
      vz = vz + gz_h * movable;
      px = px + vx * h;
      py = py + vy * h;
      pz = pz + vz * h;
      s_px[tid] = px, s_py[tid] = py, s_pz[tid] = pz;
      s_vx[tid] = vx, s_vy[tid] = vy, s_vz[tid] = vz;
    }
    __syncthreads();

    // sphere-sphere contacts through the general GJK query
    if (is_pair) {
      float dist;
      V3 nrm;
      gjk_spheres({s_px[pi], s_py[pi], s_pz[pi]}, ra,
                  {s_px[pj], s_py[pj], s_pz[pj]}, rb, dist, nrm);
      const float pen = clamp_min(-dist, 0.0f);
      const bool touching = dist < 0.0f;
      const float vn = dot(sub({s_vx[pi], s_vy[pi], s_vz[pi]},
                               {s_vx[pj], s_vy[pj], s_vz[pj]}),
                           nrm);
      const bool act = touching && vn < 0.0f;
      const float im_sum = clamp_min(ima + imb, IM_FLOOR);
      s_jimp[tid] = act ? neg_e1 * vn / im_sum : 0.0f;
      s_corr[tid] = touching ? pen / im_sum : 0.0f;
      s_nx[tid] = nrm.x, s_ny[tid] = nrm.y, s_nz[tid] = nrm.z;
    }
    __syncthreads();

    if (is_body) {
      // the pair terms, in _PairSums's order: as body i, then as body j
      for (int j = tid + 1; j < n; ++j) {
        const int q = pair_index(tid, j, n);
        const float a = s_jimp[q] * im, c = s_corr[q] * im;
        vx = vx + a * s_nx[q], vy = vy + a * s_ny[q], vz = vz + a * s_nz[q];
        px = px + c * s_nx[q], py = py + c * s_ny[q], pz = pz + c * s_nz[q];
      }
      for (int i = 0; i < tid; ++i) {
        const int q = pair_index(i, tid, n);
        const float b = -s_jimp[q] * im, c = -s_corr[q] * im;
        vx = vx + b * s_nx[q], vy = vy + b * s_ny[q], vz = vz + b * s_nz[q];
        px = px + c * s_nx[q], py = py + c * s_ny[q], pz = pz + c * s_nz[q];
      }
      // the ground plane: clamp and restitution bounce
      const bool below = py < floor_y;
      py = below ? floor_y : py;
      vy = below && vy < 0.0f ? neg_e * vy : vy;
      // the soft walls at |x|, |z| = bounds
      bool over = px > hi, under = px < -hi;
      px = over ? hi : (under ? -hi : px);
      vx = (over && vx > 0.0f) || (under && vx < 0.0f) ? neg_e * vx : vx;
      over = pz > hi, under = pz < -hi;
      pz = over ? hi : (under ? -hi : pz);
      vz = (over && vz > 0.0f) || (under && vz < 0.0f) ? neg_e * vz : vz;
    }
    t = t + h;
  }

  if (is_body) {
    out[tid] = px, out[n + tid] = py, out[2 * n + tid] = pz;
    out[3 * n + tid] = vx, out[4 * n + tid] = vy, out[5 * n + tid] = vz;
  }
  if (tid == 0) out[6 * n] = t;
}

bool physics_args_ok(int n) {
  return n >= 1 && n <= MAX_BODIES && n * (n - 1) / 2 <= MAX_PAIRS;
}

// one thread a body and one a pair, in whole warps
int physics_threads(int n) {
  const int need = max(n, n * (n - 1) / 2);
  return (need + 31) / 32 * 32;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success). Reads the
// state's 7 leaves and the world's parameters (each a device pointer; the
// 0-dim ones and dt one float, gravity 3), writes the new state to `out`:
// pos.x, pos.y, pos.z, vel.x, vel.y, vel.z (n floats each), then t.
int ttrt_physics_step(const float* pos_x, const float* pos_y,
                      const float* pos_z, const float* vel_x,
                      const float* vel_y, const float* vel_z, const float* t,
                      const float* radius, const float* inv_mass,
                      const float* gravity, const float* restitution,
                      const float* ground_y, const float* bounds,
                      const float* dt, int n, int substeps, float* out,
                      void* stream) {
  if (!physics_args_ok(n)) return (int)cudaErrorInvalidValue;
  physics_step_kernel<<<1, physics_threads(n), 0, (cudaStream_t)stream>>>(
      pos_x, pos_y, pos_z, vel_x, vel_y, vel_z, t, radius, inv_mass, gravity,
      restitution, ground_y, bounds, dt, n, substeps, out);
  return (int)cudaGetLastError();
}

// The launch ttrt_physics_step takes for n bodies, into out[5]: threads a
// block, blocks, registers a thread, local (spill) bytes a thread, static
// shared bytes. Returns a CUDA error code (0 on success).
int ttrt_physics_layout(int n, int* out) {
  if (!physics_args_ok(n)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, physics_step_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = physics_threads(n);
  out[1] = 1;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = (int)attr.sharedSizeBytes;
  return 0;
}

}  // extern "C"
