// Device functions shared by the render kernels (render.cu, mesh.cu,
// pathtrace.cu): the float helpers that round like the JAX oracle, the sky
// (a procedural pattern or an image cubemap's texels), the lighting with
// shadow rays, and the per-pixel sample and bounce loops.
// A kernel supplies a tracer: a type with
//
//   Hit  trace(ox, oy, oz, dx, dy, dz) const;    // nearest hit + fixups
//   bool blocked(px, py, pz, ldx, ldy, ldz, has_tmax, tmax) const;
//
// and trace_sample runs one AA sample of the reference's frame loop over
// it; sample_threads spreads a pixel's samples over threads of one block
// and adds their colors in sample order and their counts (any number of
// channels) for the kernel's pixel write. Floating point
// rules (build with --fmad=false, no fast math; the fmaf/dot3 contractions
// written out) are explained in render.cu.

#pragma once

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int CAM_FLOATS = 17;
constexpr int DLIGHT_FLOATS = 6;
constexpr int PLIGHT_FLOATS = 7;

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

// The miss record: point = origin, normal = direction (normalized),
// reflectivity 0 (TerminalRayTracer.c:858-867).
__device__ __forceinline__ Hit miss_hit(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Hit h;
  h.is_hit = false;
  h.px = ox; h.py = oy; h.pz = oz;
  h.nx = dx; h.ny = dy; h.nz = dz;
  normalize3(h.nx, h.ny, h.nz);
  h.cr = h.cg = h.cb = 0.0f;
  h.refl = 0.0f;
  h.spec = 0.0f;
  return h;
}

// The hit fixups (TerminalRayTracer.c:870-886) at ray parameter t: the
// point o + t d, pushed EPSILON back toward the origin along the guarded-
// normalized (origin - point); the raw normal (nx, ny, nz) is normalized.
// `center` != nullptr makes the raw normal point - center (a sphere).
__device__ __forceinline__ void finish_hit(Hit& h, float t, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz,
                                           const float* center, float nx,
                                           float ny, float nz) {
  h.is_hit = true;
  float px = fmaf(t, dx, ox), py = fmaf(t, dy, oy), pz = fmaf(t, dz, oz);
  if (center != nullptr) {
    nx = px - center[0]; ny = py - center[1]; nz = pz - center[2];
  }
  float tox = ox - px, toy = oy - py, toz = oz - pz;
  normalize3(tox, toy, toz);
  h.px = fmaf(tox, EPSILON_F, px);
  h.py = fmaf(toy, EPSILON_F, py);
  h.pz = fmaf(toz, EPSILON_F, pz);
  normalize3(nx, ny, nz);
  h.nx = nx; h.ny = ny; h.nz = nz;
}

struct Lights {
  const float* dl;  // n_dl x 6: normalized -direction, color
  const float* pl;  // n_pl x 7: position, color, intensity
  int n_dl, n_pl;
};

// Diffuse shading with shadow rays (apply_lighting,
// TerminalRayTracer.c:894-963), optional Blinn-Phong specular.
template <class Tracer>
__device__ void apply_lighting(const Tracer& tr, const Lights& L,
                               const Hit& h, float vx, float vy, float vz,
                               bool specular, float& outr, float& outg,
                               float& outb) {
  float r = 0.0f, g = 0.0f, b = 0.0f;
  for (int i = 0; i < L.n_dl; ++i) {
    const float* l = L.dl + DLIGHT_FLOATS * i;
    if (tr.blocked(h.px, h.py, h.pz, l[0], l[1], l[2], false, 0.0f))
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
  for (int i = 0; i < L.n_pl; ++i) {
    const float* l = L.pl + PLIGHT_FLOATS * i;
    float lvx = l[0] - h.px, lvy = l[1] - h.py, lvz = l[2] - h.pz;
    float light_d2 = dot3(lvx, lvy, lvz, lvx, lvy, lvz);
    float intensity = clamp01(l[6] / light_d2);
    float ldx = lvx, ldy = lvy, ldz = lvz;
    normalize3(ldx, ldy, ldz);
    float tmax = sqrtf(light_d2);
    if (tr.blocked(h.px, h.py, h.pz, ldx, ldy, ldz, true, tmax)) continue;
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

// Sky kinds (ttrt_torch/kernels/render.py::SKY_KINDS and SKY_IMAGE).
constexpr int SKY_COLORS = 0;
constexpr int SKY_UV_CHECKER = 1;
constexpr int SKY_IMAGE = 2;

// The cubemap the kernels sample: a procedural pattern evaluated in place
// (SKY_COLORS, SKY_UV_CHECKER), or an image cubemap's packed 0x00RRGGBB
// texels, (6, dim, dim) in face order, read from device memory
// (SKY_IMAGE). The texel loads take the place of the TPU kernels' deferred
// epilogue gather, the texel index they carried in bits 10..30 of the count
// stream (hence JAX's dim <= 591 cap, which the port does not have) and the
// quad-packed bilinear table (ttrt/render/skybox.py:197-206). A 256-texel
// cubemap is 1,572,864 bytes, which L2 holds.
struct Sky {
  int kind;
  int dim;
  bool bilinear;
  const int* texels;  // SKY_IMAGE only
};

// (face, u, v) of get_skybox_color (TerminalRayTracer.c:700-776): the
// strict-greater face scan, the folded uv fixups, u and v clamped to
// [-0.5, 0.5].
__device__ void sky_face_uv(float dx, float dy, float dz, int& face,
                            float& u, float& v) {
  normalize3(dx, dy, dz);
  float best = dx * CUBEMAP_AXES[0][0] + dy * CUBEMAP_AXES[0][1] +
               dz * CUBEMAP_AXES[0][2];
  face = 0;
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
  u = ox * ua[0] + oy * ua[1] + oz * ua[2];
  v = ox * va[0] + oy * va[1] + oz * va[2];
  u = fminf(fmaxf(u, -0.5f), 0.5f);
  v = fminf(fmaxf(v, -0.5f), 0.5f);
}

// Texel (face, row vi, column ui) of a procedural cubemap
// (render_pallas.py:518), bit-identical to the generators' float32 texels.
__device__ void procedural_texel(int face, int ui, int vi, int dim, int kind,
                                 float& r, float& g, float& b) {
  const float* hue = FACE_COLORS[face];
  if (kind == 0) {  // 'colors': texels are exactly 0 or 255
    r = hue[0]; g = hue[1]; b = hue[2];
    return;
  }
  // 'uv_checker'. jnp.mod is floor-mod; fmodf truncates, and the two
  // agree here only because the dividend is >= 0.
  const float fdim = (float)dim;
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

// Texel (face, row vi, column ui) of the sky as float [0, 1] channels: the
// procedural pattern, or the image texel divided by 255 as the JAX oracle's
// eager _unpack does (ttrt/render/skybox.py:157-168: a true division, IEEE
// '/' without fast math; XLA's jitted epilogue multiplies by 1/255 instead).
// The port packs texels as int32 (ttrt_torch/assets.py), JAX as uint32;
// both hold values below 2^24, so the signed shifts and masks are exact.
__device__ __forceinline__ void texel(const Sky& sky, int face, int ui,
                                      int vi, float& r, float& g, float& b) {
  if (sky.kind != SKY_IMAGE) {
    procedural_texel(face, ui, vi, sky.dim, sky.kind, r, g, b);
    return;
  }
  const int t =
      __ldg(sky.texels + ((size_t)(face * sky.dim + vi) * sky.dim + ui));
  r = (float)((t >> 16) & 0xFF) / 255.0f;
  g = (float)((t >> 8) & 0xFF) / 255.0f;
  b = (float)(t & 0xFF) / 255.0f;
}

// The sky along d (render_pallas.py:559, :568; ttrt/render/skybox.py
// sample_skybox): the nearest texel by the reference's int truncation, or
// (bilinear) the four texels around (u, v), clamped within the face and
// blended in sample_skybox(bilinear=True)'s lerp order, uncontracted.
__device__ void sky_color(float dx, float dy, float dz, const Sky& sky,
                          float& r, float& g, float& b) {
  int face;
  float u, v;
  sky_face_uv(dx, dy, dz, face, u, v);
  const int dim = sky.dim;
  const float fdim = (float)dim;
  if (!sky.bilinear) {
    int ui = min((int)((u + 0.5f) * fdim), dim - 1);
    int vi = min((int)((v + 0.5f) * fdim), dim - 1);
    texel(sky, face, ui, vi, r, g, b);
    return;
  }
  const float fu = (u + 0.5f) * fdim - 0.5f;
  const float fv = (v + 0.5f) * fdim - 0.5f;
  const int u0 = min(max((int)floorf(fu), 0), dim - 1);
  const int v0 = min(max((int)floorf(fv), 0), dim - 1);
  const int u1 = min(u0 + 1, dim - 1);
  const int v1 = min(v0 + 1, dim - 1);
  const float wu = clamp01(fu - (float)u0);
  const float wv = clamp01(fv - (float)v0);
  float c00[3], c01[3], c10[3], c11[3];
  texel(sky, face, u0, v0, c00[0], c00[1], c00[2]);
  texel(sky, face, u1, v0, c01[0], c01[1], c01[2]);
  texel(sky, face, u0, v1, c10[0], c10[1], c10[2]);
  texel(sky, face, u1, v1, c11[0], c11[1], c11[2]);
  float out[3];
  for (int ch = 0; ch < 3; ++ch) {
    const float top = c00[ch] * (1.0f - wu) + c01[ch] * wu;
    const float bot = c10[ch] * (1.0f - wu) + c11[ch] * wu;
    out[ch] = top * (1.0f - wv) + bot * wv;
  }
  r = out[0]; g = out[1]; b = out[2];
}

// Triangle wave (TerminalRayTracer.c:225-228). jnp.mod is floor-mod; fmodf
// truncates, and the two agree here only because t >= 0 (k >= 0).
__device__ __forceinline__ float tri(float t) {
  float m = fmodf(t, TWO_PI_F);
  return m < PI_F ? m / PI_F : 2.0f - m / PI_F;
}

// One AA sample of a pixel (column col_i, row row_i of the band; the
// band's first row and first sample are cam[15] and cam[16]): its primary
// ray (TerminalRayTracer.c:978-1011) and the masked bounce loop
// (render_pallas.py:718) as a real loop that exits once the ray dies (a dead
// ray changes no accumulator, so the exit is exact). Returns the shaded
// color before the sky, the contribution total, the sky weight, the final
// (frozen-on-death) direction and the bounces and hits. SHADE=false skips
// the lighting and its shadow rays (JAX's _bounce_chain(shade=False),
// render_pallas.py:725-729): nothing of the contribution chain, the sky
// weight, the counts or the direction depends on them, so those equal the
// shaded chain's bit for bit.
struct Sample {
  float pr, pg, pb, total, sky_w;
  float dx, dy, dz;
  int bounces, hits;
};

template <bool SHADE, class Tracer>
__device__ Sample trace_sample(const Tracer& tr, const Lights& L,
                               const float* cam, int col_i, int row_i, int k,
                               int W, int H, int N, int bounce_limit,
                               bool specular, bool subtract) {
  const float fW = (float)W, fH = (float)H, fN = (float)N;
  const float col = (float)col_i;
  const float row = (float)row_i + cam[15];
  const float szc = cam[12], sw = cam[13], sh = cam[14];
  const float pixel_w = sw / fW;
  const float pixel_h = sh / fH;
  const float kf = (float)k + cam[16];
  const float jit_x = tri(TWO_PI_F * kf / fN) / 2.0f * pixel_w;
  const float jit_y = tri(PI_F * kf / fN) / 2.0f * pixel_h;
  const float sxv = (col / fW) * sw - sw / 2.0f + jit_x;
  const float syv = -((row / fH) * sh - sh / 2.0f) + jit_y;
  // reference quirk: direction = screen offset in basis - camera ORIGIN
  float dx = sxv * cam[0] + syv * cam[3] + szc * cam[6] - cam[9];
  float dy = sxv * cam[1] + syv * cam[4] + szc * cam[7] - cam[10];
  float dz = sxv * cam[2] + syv * cam[5] + szc * cam[8] - cam[11];
  normalize3(dx, dy, dz);
  float ox = cam[9], oy = cam[10], oz = cam[11];

  Sample s;
  s.pr = 0.0f; s.pg = 0.0f; s.pb = 0.0f;
  s.total = 0.0f; s.sky_w = 0.0f;
  s.bounces = 0; s.hits = 0;
  float contrib = 1.0f;
  for (int bounce = 0; bounce < bounce_limit; ++bounce) {
    if (!(contrib > CONTRIBUTION_EPS_F)) break;
    Hit h = tr.trace(ox, oy, oz, dx, dy, dz);
    s.total = s.total + contrib;
    s.bounces += 1;
    if (!h.is_hit) {
      s.sky_w = contrib;
      contrib = 0.0f;
      break;
    }
    s.hits += 1;
    if (SHADE) {
      float lr, lg, lb;
      apply_lighting(tr, L, h, -dx, -dy, -dz, specular, lr, lg, lb);
      float hw = subtract ? contrib * (1.0f - h.refl) : contrib;
      s.pr = fmaf(hw, lr, s.pr);
      s.pg = fmaf(hw, lg, s.pg);
      s.pb = fmaf(hw, lb, s.pb);
    }
    contrib = contrib * h.refl;
    float dn = 2.0f * dot3(dx, dy, dz, h.nx, h.ny, h.nz);
    float rdx = fmaf(-dn, h.nx, dx), rdy = fmaf(-dn, h.ny, dy),
          rdz = fmaf(-dn, h.nz, dz);
    normalize3(rdx, rdy, rdz);
    dx = rdx; dy = rdy; dz = rdz;
    ox = h.px; oy = h.py; oz = h.pz;
  }
  s.dx = dx; s.dy = dy; s.dz = dz;
  return s;
}

// One sample's color: the sky folded in at its final direction when the
// sky weight is positive, then the contribution-total normalization. A
// sample whose sky weight is 0 skips the sky: pr + 0 * sky == pr exactly,
// so it loads no texel. sample_threads adds these in sample order.
__device__ __forceinline__ void sample_color(const Sample& s, const Sky& sky,
                                             bool subtract, float& pr,
                                             float& pg, float& pb) {
  pr = s.pr;
  pg = s.pg;
  pb = s.pb;
  if (s.sky_w > 0.0f) {
    float skr, skg, skb;
    sky_color(s.dx, s.dy, s.dz, sky, skr, skg, skb);
    pr = pr + s.sky_w * skr;
    pg = pg + s.sky_w * skg;
    pb = pb + s.sky_w * skb;
  }
  if (!subtract) {
    // the subtract model's weights partition unity: no divide
    const float inv_total = 1.0f / (s.total > 0.0f ? s.total : 1.0f);
    pr = pr * inv_total;
    pg = pg * inv_total;
    pb = pb * inv_total;
  }
}

// A pixel's samples on neighbouring threads of one block (render.cu's,
// mesh.cu's and pathtrace.cu's frame kernels). A pixel's S sample threads
// take all its samples in one round up to MAX_ROUND, else the fewest
// rounds of at most MAX_ROUND, as even as they go; a block holds P =
// blockDim.x / S pixels, consecutive in the band's row-major order.
constexpr int MAX_ROUND = 32;

// A sample's NC counts; sample_threads adds each channel over the pixel's
// samples as an unsigned integer, exact in any order.
template <int NC>
struct Counts {
  unsigned c[NC];
};

// Shared memory of the sample sums of a block of `threads` threads and
// `pixels` pixels: each thread's color of the round (3 floats) and its
// `counts` counts (unsigneds), and each pixel's sum between rounds (3
// floats).
inline size_t sample_sum_bytes(int threads, int pixels, int counts) {
  return (3 * sizeof(float) + counts * sizeof(unsigned)) * (size_t)threads +
         3 * sizeof(float) * (size_t)pixels;
}

struct SampleSums {
  float* col_r;
  float* col_g;
  float* col_b;
  unsigned* count;  // channel c of thread t at count[c * blockDim.x + t]
  float* acc;
  int P;        // pixels of the block
  float* end;   // the first float past the sums
};

// The sample sums with NC count channels of this block's shared memory
// from `base` on.
template <int NC>
__device__ __forceinline__ SampleSums sample_sums(float* base, int S) {
  const int nt = blockDim.x;
  SampleSums sm;
  sm.P = nt / S;
  sm.col_r = base;
  sm.col_g = sm.col_r + nt;
  sm.col_b = sm.col_g + nt;
  sm.count = reinterpret_cast<unsigned*>(sm.col_b + nt);
  sm.acc = reinterpret_cast<float*>(sm.count + NC * nt);
  sm.end = sm.acc + 3 * sm.P;
  return sm;
}

// The render and fused kernels' pixel write: the sample sum times `scale`
// (1/N for the average, 1 for the sum) and the count.
struct ScaledWrite {
  float scale;
  float* __restrict__ out_rgb;
  int* __restrict__ out_count;

  __device__ __forceinline__ void operator()(int pix, int n_pixels, float r,
                                             float g, float b,
                                             const Counts<1>& n) const {
    out_rgb[pix] = r * scale;
    out_rgb[n_pixels + pix] = g * scale;
    out_rgb[2 * n_pixels + pix] = b * scale;
    out_count[pix] = (int)n.c[0];
  }
};

// A pixel's frame loop with its samples spread over its S threads:
// thread s of the pixel takes sample k0 + s of each round k0 = 0, S, 2S,
// ..., through sample(col, row, k, r, g, b), which returns the sample's
// Counts<NC>. The pixel's first thread adds each round's colors in sample
// order, from 0.0f, the sum between rounds waiting in shared memory, so
// the sum rounds as the plain versions' in-order sum over the samples
// (render.py::render_band_plain, mesh_fused.py's, pathtrace.py's
// _reduce_samples), and hands it with the counts' sums to write(pix,
// n_pixels, r, g, b, counts). ROUNDS = false is the one-round launch (S
// == n_samples): without the round loop nothing computed before the
// sample is kept across it. Every thread of the block must call it (it
// synchronizes the block).
template <bool ROUNDS, int NC, class SampleFn, class WriteFn>
__device__ __forceinline__ void sample_threads(
    const SampleSums& sm, int S, int W, int n_rows, int n_samples,
    SampleFn sample, WriteFn write) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int p = tid / S, s = tid - p * S;
  const int pix = blockIdx.x * sm.P + p;
  const int n_pixels = W * n_rows;
  const bool live = pix < n_pixels;
  const int row = pix / W, col = pix - row * W;
  for (int c = 0; c < NC; ++c) sm.count[c * nt + tid] = 0;
  const int n_rounds = ROUNDS ? (n_samples + S - 1) / S : 1;
  for (int round = 0; round < n_rounds; ++round) {
    const int k0 = round * S;
    if (k0 > 0) __syncthreads();  // the last round's colors are added
    const int k = k0 + s;
    if (live && k < n_samples) {
      float pr, pg, pb;
      const Counts<NC> n = sample(col, row, k, pr, pg, pb);
      for (int c = 0; c < NC; ++c) sm.count[c * nt + tid] += n.c[c];
      sm.col_r[tid] = pr;
      sm.col_g[tid] = pg;
      sm.col_b[tid] = pb;
    }
    __syncthreads();
    if (!live || s != 0) continue;
    float r = 0.0f, g = 0.0f, b = 0.0f;
    if (k0 > 0) {
      r = sm.acc[p];
      g = sm.acc[sm.P + p];
      b = sm.acc[2 * sm.P + p];
    }
    const int m = min(S, n_samples - k0);
    for (int j = 0; j < m; ++j) {
      r = r + sm.col_r[tid + j];
      g = g + sm.col_g[tid + j];
      b = b + sm.col_b[tid + j];
    }
    if (k0 + S < n_samples) {
      sm.acc[p] = r;
      sm.acc[sm.P + p] = g;
      sm.acc[2 * sm.P + p] = b;
      continue;
    }
    Counts<NC> total;
    for (int c = 0; c < NC; ++c) {
      total.c[c] = 0;
      for (int j = 0; j < S; ++j) total.c[c] += sm.count[c * nt + tid + j];
    }
    write(pix, n_pixels, r, g, b, total);
  }
}

// The launch shape of a sample-thread kernel for a band.
struct SampleShape {
  int samples;   // S, sample threads of a pixel
  int pixels;    // P, pixels of a block
  int threads;   // P * S
  int blocks;
  size_t smem;   // dynamic shared memory of a block
  bool rounds;   // more than one round of S samples
  int resident;  // blocks an SM holds (the occupancy calculator's)
};

// S and whether a pixel's samples take rounds.
inline void sample_rounds(int n_samples, SampleShape& sh) {
  const int rounds = (n_samples + MAX_ROUND - 1) / MAX_ROUND;
  sh.samples = (n_samples + rounds - 1) / rounds;
  sh.rounds = rounds > 1;
}

// Let `kernel` take a block's whole opt-in shared memory; its size into
// `optin`.
template <class Kernel>
cudaError_t allow_max_smem(Kernel kernel, int& optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return err;
}

// The block of `kernel` for n_pixels pixels of sh.samples threads each:
// the smallest of block_min, 2 * block_min, ... block_max threads (whole
// pixels) that keeps the most warps resident on an SM, with `fixed` bytes
// of a block's shared memory and, when `sum_counts` > 0, its sample sums
// with that many count channels, at most `max_smem` in all. Small blocks end sooner (a block lasts as long as
// its slowest thread); a large `fixed` table leaves room for few blocks
// an SM and calls for larger ones. sh.resident stays 0 when no block
// fits.
template <class Kernel>
cudaError_t pick_block(Kernel kernel, size_t fixed, int sum_counts,
                       int max_smem, int block_min, int block_max,
                       long long n_pixels, SampleShape& sh) {
  sh.pixels = sh.threads = sh.resident = sh.blocks = 0;
  sh.smem = 0;
  int best_warps = 0;
  for (int b = block_min; b <= block_max; b *= 2) {
    const int P = b / sh.samples, threads = P * sh.samples;
    const size_t smem =
        fixed + (sum_counts > 0 ? sample_sum_bytes(threads, P, sum_counts)
                                : (size_t)0);
    if (smem > (size_t)max_smem) continue;
    int resident = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    const int warps = resident * ((threads + 31) / 32);
    if (warps > best_warps) {
      best_warps = warps;
      sh.pixels = P;
      sh.threads = threads;
      sh.smem = smem;
      sh.resident = resident;
    }
  }
  if (sh.resident > 0)
    sh.blocks = (int)((n_pixels + sh.pixels - 1) / sh.pixels);
  return cudaSuccess;
}

// A launch shape into out[10], as the ttrt_*_layout functions report it:
// sample threads of a pixel, pixels of a block, threads of a block,
// blocks, dynamic shared bytes of a block, `staged` (the scene in shared
// memory, 1, or read in place, 0), blocks an SM holds, SMs, and
// `kernel`'s registers and local bytes of a thread. Returns a CUDA error
// code (0 on success).
template <class Kernel>
int write_layout(const SampleShape& sh, bool staged, Kernel kernel,
                 int* out) {
  int dev = 0, sms = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const int vals[10] = {sh.samples, sh.pixels, sh.threads, sh.blocks,
                        (int)sh.smem, staged ? 1 : 0, sh.resident,
                        sms, attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

constexpr int SPHERE_FLOATS = 9;
constexpr int PLANE_FLOATS = 16;
// The demo scene's tracer for render.cu's kernels and the path
// tracer (pathtrace.cu): a linear scan of any number of spheres in index
// order, then the ground plane, read from shared memory or, for a scene
// too large for it, from the global scene buffer.
struct DemoTracer {
  const float* sph;
  const float* plane;
  int n_sph;

  // Nearest-hit trace (render_pallas.py:194): sqrt-free sphere predicate
  // disc >= 0 && b < 0 && c > 0, t compare, first object wins ties, winner
  // point and normal computed once.
  __device__ Hit trace(float ox, float oy, float oz, float dx, float dy,
                       float dz) const {
    float a = dot3(dx, dy, dz, dx, dy, dz);
    float inv2a = 0.5f / a;
    float best_t = FLT_MAX;
    int best = -1;
    for (int i = 0; i < n_sph; ++i) {
      const float* q = sph + SPHERE_FLOATS * i;
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
    const float* p = plane;
    float denom = dot3(dx, dy, dz, p[3], p[4], p[5]);
    float safe = denom == 0.0f ? 1.0f : denom;
    float tp = dot3(p[0] - ox, p[1] - oy, p[2] - oz, p[3], p[4], p[5]) / safe;
    bool take_p = fabsf(denom) > PLANE_DENOM_EPS_F && tp > PLANE_T_EPS_F &&
                  tp < best_t;
    if (take_p) best_t = tp;
    if (!take_p && best < 0) return miss_hit(ox, oy, oz, dx, dy, dz);

    Hit h;
    if (take_p) {
      // checker parity (TerminalRayTracer.c:850): float -> int truncation
      float px = fmaf(best_t, dx, ox), pz = fmaf(best_t, dz, oz);
      int odd = ((int)(floorf(px) + floorf(pz))) & 1;
      const float* m = odd ? p + 10 : p + 6;
      h.cr = m[0]; h.cg = m[1]; h.cb = m[2]; h.refl = m[3];
      h.spec = odd ? p[15] : p[14];
      finish_hit(h, best_t, ox, oy, oz, dx, dy, dz, nullptr, p[3], p[4],
                 p[5]);
    } else {
      const float* q = sph + SPHERE_FLOATS * best;
      h.cr = q[4]; h.cg = q[5]; h.cb = q[6]; h.refl = q[7]; h.spec = q[8];
      finish_hit(h, best_t, ox, oy, oz, dx, dy, dz, q, 0.0f, 0.0f, 0.0f);
    }
    return h;
  }

  // Any-hit shadow trace along a UNIT direction (the quadratic's a is 1);
  // has_tmax: point lights only count blockers before the light
  // (TerminalRayTracer.c:937-942).
  __device__ bool blocked(float px, float py, float pz, float ldx, float ldy,
                          float ldz, bool has_tmax, float tmax) const {
    for (int i = 0; i < n_sph; ++i) {
      const float* q = sph + SPHERE_FLOATS * i;
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
    const float* p = plane;
    float denom = dot3(ldx, ldy, ldz, p[3], p[4], p[5]);
    float safe = denom == 0.0f ? 1.0f : denom;
    float tp = dot3(p[0] - px, p[1] - py, p[2] - pz, p[3], p[4], p[5]) / safe;
    bool phit = fabsf(denom) > PLANE_DENOM_EPS_F && tp > PLANE_T_EPS_F;
    if (has_tmax) phit = phit && tp < tmax;
    return phit;
  }
};

}  // namespace
