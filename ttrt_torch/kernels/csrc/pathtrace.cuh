// The Monte-Carlo path tracer's estimator over any tracer of common.cuh
// (a type with trace() and blocked()): pathtrace.cu instantiates it over
// the demo scene's DemoTracer, mesh.cu over the many-object MeshTracer.
// Its plain PyTorch version is ttrt_torch/kernels/pathtrace.py::_traced_paths,
// which mirrors this math op for op.
//
// Per path, as the JAX kernel (ttrt/kernels/pathtrace_pallas.py::
// _pathtrace_kernel, :101): next-event estimation (NEE) with one surface
// sample on every spherical area light and an any-hit shadow ray cut at
// sqrt(d2) * (1 - 5e-5); a specular (probability = reflectivity) or
// cosine-diffuse continuation; Russian roulette from bounce 3; the sky at
// the exit direction weighted by the throughput frozen at the miss.
//
// Random numbers: the JAX kernel's counter-based hash, u = u01(mix32(idx ^
// mix32(seed + (bounce*64 + purpose) * 0x9E3779B9))), in uint32 arithmetic,
// with the JAX kernel's ray index idx = k * (W*H) + row * W + col. So every
// draw equals the Pallas lane's; u01 takes the 24 high bits, exact in float.

#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int AL_FLOATS = 8;  // position 3, radius, color 3, intensity
// the NEE purposes 10 + 3*li and 11 + 3*li meet the cosine draw's 40 at an
// 11th light (pathtrace_pallas.py:355-360)
constexpr int MAX_AREA_LIGHTS = 10;
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr float TMAX_SCALE = (float)(1.0 - 5e-5);
// purposes of the draws (pathtrace_pallas.py:157-252)
constexpr int JITTER_BOUNCE = 63;
constexpr int NEE = 10, BRANCH = 30, COSINE = 40, ROULETTE = 50;

// murmur3 fmix32 (pathtrace_pallas.py:70).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The draws of one ray index (pathtrace_pallas.py:80, 127-138).
struct Rng {
  uint32_t idx, seed;

  __device__ float operator()(int bounce, int purpose) const {
    const uint32_t sc = (uint32_t)(bounce * 64 + purpose) * GOLDEN;
    const uint32_t h = mix32(idx ^ mix32(seed + sc));
    return (float)(int)(h >> 8) * (1.0f / 16777216.0f);
  }

  // uniform unit-sphere direction from the draws (purpose, purpose + 1)
  __device__ void sphere(int bounce, int purpose, float& x, float& y,
                         float& z) const {
    z = (*this)(bounce, purpose) * 2.0f - 1.0f;
    const float phi = (*this)(bounce, purpose + 1) * TWO_PI_F;
    const float r = sqrtf(fmaxf(fmaf(-z, z, 1.0f), 0.0f));
    x = r * cosf(phi);
    y = r * sinf(phi);
  }
};

// One path of the frame: sample k of pixel (col, row), its ray index k *
// n_pixels + pix in the JAX kernel's sample-major order. Its color, the
// sky at the exit direction weighted by the throughput at the miss plus
// the NEE radiance, goes to (pr, pg, pb); its counts are the nearest-hit
// traces | hits << 16 and the NEE shadow rays that found their light
// unblocked.
template <class Tracer>
__device__ __forceinline__ Counts<2> trace_path(
    const Tracer& tr, const float* cam, const float* al, int n_al,
    const Sky& sky_map, int col_i, int row_i, int k, int W, int H,
    int bounce_limit, uint32_t seed, float& pr, float& pg, float& pb) {
  const int n_pixels = W * H;
  const int pix = row_i * W + col_i;
  const float fW = (float)W, fH = (float)H;
  const float col = (float)col_i;
  const float row = (float)row_i + cam[15];
  const float szc = cam[12], sw = cam[13], sh = cam[14];
  int nearest = 0, hits = 0, unblocked = 0;
  const Rng rng{(uint32_t)(k * n_pixels + pix), seed};
  // primary ray (pathtrace_pallas.py:144-168): random jitter in [0, pixel)
  const float jit_x = rng(JITTER_BOUNCE, 0) * (sw / fW);
  const float jit_y = rng(JITTER_BOUNCE, 1) * (sh / fH);
  const float sxv = (col / fW) * sw - sw / 2.0f + jit_x;
  const float syv = -((row / fH) * sh - sh / 2.0f) + jit_y;
  // reference quirk: direction = screen offset in basis - camera ORIGIN
  float dx = sxv * cam[0] + syv * cam[3] + szc * cam[6] - cam[9];
  float dy = sxv * cam[1] + syv * cam[4] + szc * cam[7] - cam[10];
  float dz = sxv * cam[2] + syv * cam[5] + szc * cam[8] - cam[11];
  normalize3(dx, dy, dz);
  float ox = cam[9], oy = cam[10], oz = cam[11];

  float tp[3] = {1.0f, 1.0f, 1.0f};
  float rad[3] = {0.0f, 0.0f, 0.0f};
  float sky_w[3] = {0.0f, 0.0f, 0.0f};
  for (int b = 0; b < bounce_limit; ++b) {
    const Hit h = tr.trace(ox, oy, oz, dx, dy, dz);
    nearest += 1;
    if (!h.is_hit) {  // the sky weight of the exit; the path ends
      sky_w[0] = tp[0]; sky_w[1] = tp[1]; sky_w[2] = tp[2];
      break;
    }
    hits += 1;
    const float c[3] = {h.cr, h.cg, h.cb};

    // next-event estimation: one surface sample on every area light
    for (int li = 0; li < n_al; ++li) {
      const float* l = al + AL_FLOATS * li;
      float sx, sy, sz;
      rng.sphere(b, NEE + 3 * li, sx, sy, sz);
      const float tlx = fmaf(l[3], sx, l[0]) - h.px;
      const float tly = fmaf(l[3], sy, l[1]) - h.py;
      const float tlz = fmaf(l[3], sz, l[2]) - h.pz;
      const float d2 = dot3(tlx, tly, tlz, tlx, tly, tlz);
      float wix = tlx, wiy = tly, wiz = tlz;
      normalize3(wix, wiy, wiz);
      const float ndotl =
          fmaxf(dot3(h.nx, h.ny, h.nz, wix, wiy, wiz), 0.0f);
      // any-hit occlusion cut just short of the light sample
      const float tmax = sqrtf(d2) * TMAX_SCALE;
      const bool blocked =
          tr.blocked(h.px, h.py, h.pz, wix, wiy, wiz, true, tmax);
      const float fall = fminf(l[7] / fmaxf(d2, 1e-8f), 1.0f);
      const float w = blocked ? 0.0f : fall * ndotl;
      unblocked += blocked ? 0 : 1;
      for (int ch = 0; ch < 3; ++ch)
        rad[ch] = fmaf(tp[ch] * w * l[4 + ch], c[ch], rad[ch]);
    }

    // specular (probability = reflectivity) or cosine-diffuse
    const bool spec = rng(b, BRANCH) < h.refl;
    float ndx, ndy, ndz;
    if (spec) {
      const float dn = 2.0f * dot3(dx, dy, dz, h.nx, h.ny, h.nz);
      ndx = fmaf(-dn, h.nx, dx);
      ndy = fmaf(-dn, h.ny, dy);
      ndz = fmaf(-dn, h.nz, dz);
    } else {
      float usx, usy, usz;
      rng.sphere(b, COSINE, usx, usy, usz);
      ndx = h.nx + usx;
      ndy = h.ny + usy;
      ndz = h.nz + usz;
      if (dot3(ndx, ndy, ndz, ndx, ndy, ndz) < 1e-8f) {
        ndx = h.nx; ndy = h.ny; ndz = h.nz;  // s == -n
      }
    }
    normalize3(ndx, ndy, ndz);
    if (!spec)
      for (int ch = 0; ch < 3; ++ch) tp[ch] = tp[ch] * c[ch];

    // Russian roulette from bounce 3
    bool survive = true;
    if (b >= 3) {
      const float maxc = fmaxf(tp[0], fmaxf(tp[1], tp[2]));
      const float p_cont = fminf(fmaxf(maxc, 0.05f), 1.0f);
      survive = rng(b, ROULETTE) < p_cont;
      const float inv_p = 1.0f / p_cont;
      for (int ch = 0; ch < 3; ++ch) tp[ch] = tp[ch] * inv_p;
    }
    ox = h.px; oy = h.py; oz = h.pz;
    dx = ndx; dy = ndy; dz = ndz;
    if (!survive) break;
  }
  // the sky at the exit direction, weighted by the throughput at the miss
  float sky[3];
  sky_color(dx, dy, dz, sky_map, sky[0], sky[1], sky[2]);
  pr = fmaf(sky_w[0], sky[0], rad[0]);
  pg = fmaf(sky_w[1], sky[1], rad[1]);
  pb = fmaf(sky_w[2], sky[2], rad[2]);
  // nearest <= bounce_limit, and a pixel's sum stays under 0x8000 (the
  // gate N * bounce_limit <= 0x7FFF), so the packed sums never carry
  return Counts<2>{{(unsigned)nearest | ((unsigned)hits << 16),
                    (unsigned)unblocked}};
}

// The path tracers' pixel write (common.cuh::sample_threads): the sample
// sum (SUM) or the sum divided by N and clipped to [0, 1], and the two
// counts. A division, as the plain version's acc / N: a product with 1/N
// rounds some sums differently, so ScaledWrite's `scale` does not serve.
template <bool SUM>
struct PathWrite {
  int N;
  float* __restrict__ out_rgb;
  int* __restrict__ out_count;

  __device__ __forceinline__ void operator()(int pix, int n_pixels, float r,
                                             float g, float b,
                                             const Counts<2>& n) const {
    if (SUM) {
      out_rgb[pix] = r;
      out_rgb[n_pixels + pix] = g;
      out_rgb[2 * n_pixels + pix] = b;
    } else {
      const float fN = (float)N;
      out_rgb[pix] = clamp01(r / fN);
      out_rgb[n_pixels + pix] = clamp01(g / fN);
      out_rgb[2 * n_pixels + pix] = clamp01(b / fN);
    }
    out_count[pix] = (int)n.c[0];
    out_count[n_pixels + pix] = (int)n.c[1];
  }
};

// The gates both path-tracing launches share: at most MAX_AREA_LIGHTS
// lights, a procedural sky, a ray index within int, and N * bounce_limit
// <= 0x7FFF so that a pixel's packed counts never carry.
inline bool path_args_ok(int n_al, int W, int H, int N, int bounce_limit,
                         int sky_kind, int sky_dim) {
  return n_al >= 0 && n_al <= MAX_AREA_LIGHTS && W >= 1 && H >= 1 &&
         N >= 1 && bounce_limit >= 0 && sky_dim >= 1 &&
         (sky_kind == SKY_COLORS || sky_kind == SKY_UV_CHECKER) &&
         (long long)W * H * N <= 0x7FFFFFFFLL &&
         (long long)N * bounce_limit <= 0x7FFF;
}

}  // namespace
