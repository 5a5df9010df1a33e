// Demo-scene render kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ttrt/kernels/render_pallas.py::_render_kernel
// (:894, launched at :1154), procedural-sky variant, with its flags
// `specular` and `energy_model="subtract"`. Its plain PyTorch version is
// ttrt_torch/kernels/render.py::render_frame_plain, which mirrors this math
// op for op.
//
// Design: one thread per pixel. Each thread loops over the AA samples
// k = 0..N-1 in order and, per sample, over the bounces with a real loop
// that exits when the ray dies (a dead ray changes no accumulator, so the
// exit is exact). It sums the per-sample normalized colors and multiplies
// by 1/N, which is the JAX package's reshape(N,H,W).sum(0) * (1/N)
// (render_pallas.py:1350-1352). Outputs: (3, H, W) float32 and a per-pixel
// int32 trace count (bounces + hits * n_lights, render_pallas.py:1050-1057),
// 2.2 MB a frame at 480x280 against the 27 MB of per-ray outputs the TPU
// kernel writes. The scene is a packed float32 buffer (the PackedScene
// layout: cam 17, spheres 9 each, plane 16, directional lights 6 each,
// point lights 7 each) that each block copies into shared memory once.
// None of the TPU kernel's shape is kept: no unrolled bounce chain, no
// (16, 128) tiles, no SMEM scalar tables.
//
// Floating point follows the JAX oracle: build with --fmad=false and
// without --use_fast_math, so every product and sum rounds as written and
// sqrtf and '/' are IEEE. Each Python-side constant is folded in double and
// cast to float once, as JAX's weak-typed scalars are. XLA:CPU contracts
// a*b + c into fma inside the oracle's compiled bounce loop (the left
// product of a*b + c*d); the kernel writes those fmaf calls out (dot3 and
// the explicit fmaf below), so the near-zero hit-offset term
// c = |p - center|^2 - r^2 rounds as the oracle's does. Ray generation
// (but for its normalize) and the sky fold stay uncontracted, as the oracle
// computes them op by op.
//
// What bounds it on this card, from arithmetic (not measured): 1,344,000
// rays a frame at 480x280x10 and about 3.4 traces per ray (the JAX oracle
// counts 3517 traces for 1024 rays at 32x16x2) is a few GFLOP a frame,
// microseconds at the H100's FP32 rate. So expect the kernel to be bound by
// latency and warp divergence (rays of one warp die at different bounces),
// and the frame by the ANSI encode, the 3,360,286-byte copy to the host and
// write(2).

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int CAM_FLOATS = 17;
constexpr int SPHERE_FLOATS = 9;
constexpr int PLANE_FLOATS = 16;
constexpr int DLIGHT_FLOATS = 6;
constexpr int PLIGHT_FLOATS = 7;
constexpr int MAX_SPHERES = 64;
constexpr int MAX_DLIGHTS = 8;
constexpr int MAX_PLIGHTS = 8;
constexpr int MAX_SCENE_FLOATS =
    CAM_FLOATS + SPHERE_FLOATS * MAX_SPHERES + PLANE_FLOATS +
    DLIGHT_FLOATS * MAX_DLIGHTS + PLIGHT_FLOATS * MAX_PLIGHTS;
constexpr int BLOCK = 128;

constexpr double PI_D = 3.14159265358979323846;
constexpr float PI_F = (float)PI_D;
constexpr float TWO_PI_F = (float)(2.0 * PI_D);
constexpr float EPSILON_F = (float)1e-6;
constexpr float GUARD2_F = (float)(1e-4 * 1e-4);
constexpr float PLANE_DENOM_EPS_F = (float)1e-5;
constexpr float PLANE_T_EPS_F = (float)1e-5;
constexpr float CONTRIBUTION_EPS_F = (float)1e-5;

// Cube axes in face order +X,-X,+Y,-Y,+Z,-Z and the per-face u/v axes with
// the reference's uv fixups folded in (ttrt_torch/render/skybox.py; a CPU
// test checks these literals against those tables).
__constant__ float CUBEMAP_AXES[6][3] = {
    {1.0f, 0.0f, 0.0f}, {-1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f},
    {0.0f, -1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}, {0.0f, 0.0f, -1.0f}};
__constant__ float U_AXIS[6][3] = {
    {0.0f, 0.0f, 1.0f}, {0.0f, 0.0f, -1.0f}, {-1.0f, 0.0f, 0.0f},
    {1.0f, 0.0f, -0.0f}, {-1.0f, 0.0f, 0.0f}, {1.0f, -0.0f, 0.0f}};
__constant__ float V_AXIS[6][3] = {
    {0.0f, -1.0f, 0.0f}, {0.0f, -1.0f, 0.0f}, {0.0f, 0.0f, 1.0f},
    {-0.0f, 0.0f, 1.0f}, {0.0f, -1.0f, 0.0f}, {0.0f, -1.0f, 0.0f}};
// face colors of the 'colors' cubemap, /255
__constant__ float FACE_COLORS[6][3] = {
    {1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 1.0f}, {0.0f, 1.0f, 0.0f},
    {1.0f, 0.0f, 1.0f}, {0.0f, 0.0f, 1.0f}, {1.0f, 1.0f, 0.0f}};

struct Scene {
  const float* cam;
  const float* sph;
  const float* plane;
  const float* dl;
  const float* pl;
  int n_sph, n_dl, n_pl;
};

// ax*bx + ay*by + az*bz as XLA:CPU contracts it in the oracle's compiled
// bounce loop: fma(az, bz, fma(ax, bx, ay*by)).
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return fmaf(az, bz, fmaf(ax, bx, ay * by));
}

// Guarded normalize (TerminalRayTracer.c:439-450): identity when the
// squared length is <= 1e-8, else multiply by 1/sqrt.
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  float len2 = dot3(x, y, z, x, y, z);
  if (len2 > GUARD2_F) {
    float inv = 1.0f / sqrtf(len2);
    x = x * inv;
    y = y * inv;
    z = z * inv;
  }
}

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

struct Hit {
  bool is_hit;
  float px, py, pz;  // EPSILON-offset hit point
  float nx, ny, nz;  // normalized normal
  float cr, cg, cb, refl, spec;
};

// Nearest-hit trace (render_pallas.py:194): sqrt-free sphere predicate
// disc >= 0 && b < 0 && c > 0, t compare, first object wins ties, winner
// point and normal computed once.
__device__ Hit trace(const Scene& s, float ox, float oy, float oz, float dx,
                     float dy, float dz) {
  float a = dot3(dx, dy, dz, dx, dy, dz);
  float inv2a = 0.5f / a;
  float best_t = FLT_MAX;
  int best = -1;
  for (int i = 0; i < s.n_sph; ++i) {
    const float* q = s.sph + SPHERE_FLOATS * i;
    float ocx = ox - q[0], ocy = oy - q[1], ocz = oz - q[2];
    float b = 2.0f * dot3(ocx, ocy, ocz, dx, dy, dz);
    float c = fmaf(-q[3], q[3], dot3(ocx, ocy, ocz, ocx, ocy, ocz));
    float disc = fmaf(b, b, -(4.0f * a * c));
    if (disc >= 0.0f && b < 0.0f && c > 0.0f) {
      float t0 = (-b - sqrtf(fmaxf(disc, 0.0f))) * inv2a;
      if (t0 < best_t) {
        best_t = t0;
        best = i;
      }
    }
  }
  const float* p = s.plane;
  float denom = dot3(dx, dy, dz, p[3], p[4], p[5]);
  float safe = denom == 0.0f ? 1.0f : denom;
  float tp = dot3(p[0] - ox, p[1] - oy, p[2] - oz, p[3], p[4], p[5]) / safe;
  bool take_p = fabsf(denom) > PLANE_DENOM_EPS_F && tp > PLANE_T_EPS_F &&
                tp < best_t;
  if (take_p) best_t = tp;

  Hit h;
  h.is_hit = take_p || best >= 0;
  if (!h.is_hit) {
    // miss: point = origin, normal = direction (normalized), refl = 0
    h.px = ox; h.py = oy; h.pz = oz;
    h.nx = dx; h.ny = dy; h.nz = dz;
    normalize3(h.nx, h.ny, h.nz);
    h.cr = h.cg = h.cb = 0.0f;
    h.refl = 0.0f;
    h.spec = 0.0f;
    return h;
  }
  float px = fmaf(best_t, dx, ox), py = fmaf(best_t, dy, oy),
        pz = fmaf(best_t, dz, oz);
  float nx, ny, nz;
  if (take_p) {
    // checker parity (TerminalRayTracer.c:850): float -> int truncation
    int odd = ((int)(floorf(px) + floorf(pz))) & 1;
    const float* m = odd ? p + 10 : p + 6;
    h.cr = m[0]; h.cg = m[1]; h.cb = m[2]; h.refl = m[3];
    h.spec = odd ? p[15] : p[14];
    nx = p[3]; ny = p[4]; nz = p[5];
  } else {
    const float* q = s.sph + SPHERE_FLOATS * best;
    h.cr = q[4]; h.cg = q[5]; h.cb = q[6]; h.refl = q[7]; h.spec = q[8];
    nx = px - q[0]; ny = py - q[1]; nz = pz - q[2];
  }
  // EPSILON back-offset along the guarded-normalized (origin - point)
  float tox = ox - px, toy = oy - py, toz = oz - pz;
  normalize3(tox, toy, toz);
  h.px = fmaf(tox, EPSILON_F, px);
  h.py = fmaf(toy, EPSILON_F, py);
  h.pz = fmaf(toz, EPSILON_F, pz);
  normalize3(nx, ny, nz);
  h.nx = nx; h.ny = ny; h.nz = nz;
  return h;
}

// Any-hit shadow trace along a UNIT direction (the quadratic's a is 1);
// has_tmax: point lights only count blockers before the light
// (TerminalRayTracer.c:937-942).
__device__ bool shadow_any_hit(const Scene& s, float px, float py, float pz,
                               float ldx, float ldy, float ldz, bool has_tmax,
                               float tmax) {
  for (int i = 0; i < s.n_sph; ++i) {
    const float* q = s.sph + SPHERE_FLOATS * i;
    float ocx = px - q[0], ocy = py - q[1], ocz = pz - q[2];
    float c = fmaf(-q[3], q[3], dot3(ocx, ocy, ocz, ocx, ocy, ocz));
    float b = 2.0f * dot3(ocx, ocy, ocz, ldx, ldy, ldz);
    float disc = fmaf(b, b, -(4.0f * c));
    bool hit = disc >= 0.0f && b < 0.0f && c > 0.0f;
    if (has_tmax) {
      // t0 < tmax  <=>  sqrt(disc) > -b - 2*tmax
      float rhs = -b - 2.0f * tmax;
      hit = hit && (rhs < 0.0f || disc > rhs * rhs);
    }
    if (hit) return true;
  }
  const float* p = s.plane;
  float denom = dot3(ldx, ldy, ldz, p[3], p[4], p[5]);
  float safe = denom == 0.0f ? 1.0f : denom;
  float tp = dot3(p[0] - px, p[1] - py, p[2] - pz, p[3], p[4], p[5]) / safe;
  bool phit = fabsf(denom) > PLANE_DENOM_EPS_F && tp > PLANE_T_EPS_F;
  if (has_tmax) phit = phit && tp < tmax;
  return phit;
}

// Diffuse shading with shadow rays (apply_lighting,
// TerminalRayTracer.c:894-963), optional Blinn-Phong specular.
__device__ void apply_lighting(const Scene& s, const Hit& h, float vx,
                               float vy, float vz, bool specular, float& outr,
                               float& outg, float& outb) {
  float r = 0.0f, g = 0.0f, b = 0.0f;
  for (int i = 0; i < s.n_dl; ++i) {
    const float* l = s.dl + DLIGHT_FLOATS * i;
    if (shadow_any_hit(s, h.px, h.py, h.pz, l[0], l[1], l[2], false, 0.0f))
      continue;
    float ndotl = fminf(dot3(h.nx, h.ny, h.nz, l[0], l[1], l[2]), 1.0f);
    float cr = l[3] * ndotl * h.cr, cg = l[4] * ndotl * h.cg,
          cb = l[5] * ndotl * h.cb;
    if (specular) {
      float hx = l[0] + vx, hy = l[1] + vy, hz = l[2] + vz;
      normalize3(hx, hy, hz);
      float sp = powf(clamp01(dot3(h.nx, h.ny, h.nz, hx, hy, hz)), h.spec);
      cr = fmaf(l[3], sp, cr); cg = fmaf(l[4], sp, cg); cb = fmaf(l[5], sp, cb);
    }
    r = r + cr; g = g + cg; b = b + cb;
  }
  for (int i = 0; i < s.n_pl; ++i) {
    const float* l = s.pl + PLIGHT_FLOATS * i;
    float lvx = l[0] - h.px, lvy = l[1] - h.py, lvz = l[2] - h.pz;
    float light_d2 = dot3(lvx, lvy, lvz, lvx, lvy, lvz);
    float intensity = clamp01(l[6] / light_d2);
    float ldx = lvx, ldy = lvy, ldz = lvz;
    normalize3(ldx, ldy, ldz);
    float tmax = sqrtf(light_d2);
    if (shadow_any_hit(s, h.px, h.py, h.pz, ldx, ldy, ldz, true, tmax))
      continue;
    float ndotl = fminf(dot3(h.nx, h.ny, h.nz, ldx, ldy, ldz), 1.0f);
    float scale = intensity * ndotl;
    float cr = l[3] * scale * h.cr, cg = l[4] * scale * h.cg,
          cb = l[5] * scale * h.cb;
    if (specular) {
      float hx = ldx + vx, hy = ldy + vy, hz = ldz + vz;
      normalize3(hx, hy, hz);
      float sp = intensity *
                 powf(clamp01(dot3(h.nx, h.ny, h.nz, hx, hy, hz)), h.spec);
      cr = fmaf(l[3], sp, cr); cg = fmaf(l[4], sp, cg); cb = fmaf(l[5], sp, cb);
    }
    r = r + cr; g = g + cg; b = b + cb;
  }
  outr = clamp01(r);
  outg = clamp01(g);
  outb = clamp01(b);
}

// Nearest-texel procedural sky (render_pallas.py:470-565), bit-identical to
// the generators' float32 texels.
__device__ void sky_color(float dx, float dy, float dz, int dim, int kind,
                          float& r, float& g, float& b) {
  normalize3(dx, dy, dz);
  float best = dx * CUBEMAP_AXES[0][0] + dy * CUBEMAP_AXES[0][1] +
               dz * CUBEMAP_AXES[0][2];
  int face = 0;
  for (int f = 1; f < 6; ++f) {
    float d = dx * CUBEMAP_AXES[f][0] + dy * CUBEMAP_AXES[f][1] +
              dz * CUBEMAP_AXES[f][2];
    if (d > best) {
      best = d;
      face = f;
    }
  }
  float inv = 1.0f / best;
  float sx = dx * inv, sy = dy * inv, sz = dz * inv;
  const float* ax = CUBEMAP_AXES[face];
  float t2 = sx * ax[0] + sy * ax[1] + sz * ax[2];
  float ox = (sx - t2 * ax[0]) * 0.5f;
  float oy = (sy - t2 * ax[1]) * 0.5f;
  float oz = (sz - t2 * ax[2]) * 0.5f;
  const float* ua = U_AXIS[face];
  const float* va = V_AXIS[face];
  float u = ox * ua[0] + oy * ua[1] + oz * ua[2];
  float v = ox * va[0] + oy * va[1] + oz * va[2];
  u = fminf(fmaxf(u, -0.5f), 0.5f);
  v = fminf(fmaxf(v, -0.5f), 0.5f);
  float fdim = (float)dim;
  int ui = min((int)((u + 0.5f) * fdim), dim - 1);
  int vi = min((int)((v + 0.5f) * fdim), dim - 1);

  const float* hue = FACE_COLORS[face];
  if (kind == 0) {  // 'colors': texels are exactly 0 or 255
    r = hue[0]; g = hue[1]; b = hue[2];
    return;
  }
  // 'uv_checker'. jnp.mod is floor-mod; fmodf truncates, and the two
  // agree here only because the dividend is >= 0.
  float u01 = (float)ui / fdim;
  float v01 = (float)vi / fdim;
  float checker = fmodf(floorf(u01 * 8.0f) + floorf(v01 * 8.0f), 2.0f);
  float shade = 0.25f + 0.5f * checker;
  float rr = clamp01(hue[0] * shade + 0.3f * u01);
  float gg = clamp01(hue[1] * shade + 0.3f * v01);
  float bb = hue[2] * shade;
  // replay the generator's (x*255) -> uint8 truncation -> /255
  r = (float)(int)(rr * 255.0f) / 255.0f;
  g = (float)(int)(gg * 255.0f) / 255.0f;
  b = (float)(int)(bb * 255.0f) / 255.0f;
}

// Triangle wave (TerminalRayTracer.c:225-228). jnp.mod is floor-mod; fmodf
// truncates, and the two agree here only because t >= 0 (k >= 0).
__device__ __forceinline__ float tri(float t) {
  float m = fmodf(t, TWO_PI_F);
  return m < PI_F ? m / PI_F : 2.0f - m / PI_F;
}

__global__ void __launch_bounds__(BLOCK)
render_kernel(const float* __restrict__ scene_buf, int n_sph, int n_dl,
              int n_pl, int W, int H, int N, int bounce_limit, int specular,
              int subtract, int sky_kind, int sky_dim,
              float* __restrict__ out_rgb, int* __restrict__ out_count) {
  __shared__ float sbuf[MAX_SCENE_FLOATS];
  const int n_floats = CAM_FLOATS + SPHERE_FLOATS * n_sph + PLANE_FLOATS +
                       DLIGHT_FLOATS * n_dl + PLIGHT_FLOATS * n_pl;
  for (int i = threadIdx.x; i < n_floats; i += blockDim.x)
    sbuf[i] = scene_buf[i];
  __syncthreads();

  const int n_pixels = W * H;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pixels) return;

  Scene s;
  s.cam = sbuf;
  s.sph = s.cam + CAM_FLOATS;
  s.plane = s.sph + SPHERE_FLOATS * n_sph;
  s.dl = s.plane + PLANE_FLOATS;
  s.pl = s.dl + DLIGHT_FLOATS * n_dl;
  s.n_sph = n_sph;
  s.n_dl = n_dl;
  s.n_pl = n_pl;
  const float* cam = s.cam;

  const float fW = (float)W, fH = (float)H, fN = (float)N;
  const float col = (float)(pix % W);
  const float row = (float)(pix / W) + cam[15];
  const float szc = cam[12], sw = cam[13], sh = cam[14];
  const float pixel_w = sw / fW;
  const float pixel_h = sh / fH;
  const float sx0 = (col / fW) * sw - sw / 2.0f;
  const float sy0 = -((row / fH) * sh - sh / 2.0f);
  const int n_lights = n_dl + n_pl;

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int traces = 0;
  for (int k = 0; k < N; ++k) {
    // primary ray (TerminalRayTracer.c:978-1011)
    const float kf = (float)k + cam[16];
    const float jit_x = tri(TWO_PI_F * kf / fN) / 2.0f * pixel_w;
    const float jit_y = tri(PI_F * kf / fN) / 2.0f * pixel_h;
    const float sxv = sx0 + jit_x;
    const float syv = sy0 + jit_y;
    // reference quirk: direction = screen offset in basis - camera ORIGIN
    float dx = sxv * cam[0] + syv * cam[3] + szc * cam[6] - cam[9];
    float dy = sxv * cam[1] + syv * cam[4] + szc * cam[7] - cam[10];
    float dz = sxv * cam[2] + syv * cam[5] + szc * cam[8] - cam[11];
    normalize3(dx, dy, dz);
    float ox = cam[9], oy = cam[10], oz = cam[11];

    // masked bounce loop (render_pallas.py:718), exiting once dead
    float pr = 0.0f, pg = 0.0f, pb = 0.0f;
    float contrib = 1.0f, total = 0.0f, sky_w = 0.0f;
    for (int bounce = 0; bounce < bounce_limit; ++bounce) {
      if (!(contrib > CONTRIBUTION_EPS_F)) break;
      Hit h = trace(s, ox, oy, oz, dx, dy, dz);
      total = total + contrib;
      traces += 1;
      if (!h.is_hit) {
        sky_w = contrib;
        contrib = 0.0f;
        break;
      }
      traces += n_lights;
      float lr, lg, lb;
      apply_lighting(s, h, -dx, -dy, -dz, specular != 0, lr, lg, lb);
      float hw = subtract ? contrib * (1.0f - h.refl) : contrib;
      pr = fmaf(hw, lr, pr);
      pg = fmaf(hw, lg, pg);
      pb = fmaf(hw, lb, pb);
      contrib = contrib * h.refl;
      float dn = 2.0f * dot3(dx, dy, dz, h.nx, h.ny, h.nz);
      float rdx = fmaf(-dn, h.nx, dx), rdy = fmaf(-dn, h.ny, dy),
            rdz = fmaf(-dn, h.nz, dz);
      normalize3(rdx, rdy, rdz);
      dx = rdx; dy = rdy; dz = rdz;
      ox = h.px; oy = h.py; oz = h.pz;
    }
    // procedural sky fold at the final (frozen-on-death) direction
    float skr, skg, skb;
    sky_color(dx, dy, dz, sky_dim, sky_kind, skr, skg, skb);
    pr = pr + sky_w * skr;
    pg = pg + sky_w * skg;
    pb = pb + sky_w * skb;
    if (!subtract) {
      // the subtract model's weights partition unity: no divide
      const float inv_total = 1.0f / (total > 0.0f ? total : 1.0f);
      pr = pr * inv_total;
      pg = pg * inv_total;
      pb = pb * inv_total;
    }
    acc_r = acc_r + pr;
    acc_g = acc_g + pg;
    acc_b = acc_b + pb;
  }
  const float inv_n = (float)(1.0 / (double)N);
  out_rgb[pix] = acc_r * inv_n;
  out_rgb[n_pixels + pix] = acc_g * inv_n;
  out_rgb[2 * n_pixels + pix] = acc_b * inv_n;
  out_count[pix] = traces;
}

}  // namespace

extern "C" {

// Largest sphere, directional-light and point-light counts the kernel's
// shared-memory scene buffer holds.
void ttrt_render_limits(int* out) {
  out[0] = MAX_SPHERES;
  out[1] = MAX_DLIGHTS;
  out[2] = MAX_PLIGHTS;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). The
// caller allocates `out_rgb` (3*H*W floats) and `out_count` (H*W ints).
int ttrt_render(const float* scene_buf, int n_sph, int n_dl, int n_pl, int W,
                int H, int N, int bounce_limit, int specular, int subtract,
                int sky_kind, int sky_dim, float* out_rgb, int* out_count,
                void* stream) {
  if (n_sph < 0 || n_sph > MAX_SPHERES || n_dl < 0 || n_dl > MAX_DLIGHTS ||
      n_pl < 0 || n_pl > MAX_PLIGHTS || W < 1 || H < 1 || N < 1 ||
      sky_dim < 1 || (sky_kind != 0 && sky_kind != 1))
    return (int)cudaErrorInvalidValue;
  const int n_pixels = W * H;
  const int grid = (n_pixels + BLOCK - 1) / BLOCK;
  render_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      scene_buf, n_sph, n_dl, n_pl, W, H, N, bounce_limit, specular, subtract,
      sky_kind, sky_dim, out_rgb, out_count);
  return (int)cudaGetLastError();
}

}  // extern "C"
