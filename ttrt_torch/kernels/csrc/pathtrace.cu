// Monte-Carlo path-tracing kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ttrt/kernels/pathtrace_pallas.py::_pathtrace_kernel
// (:101, launched at :322), procedural sky, nearest or bilinear, with the
// frame's reduce modes of pathtrace_frame_pallas (:334): the clipped mean,
// or the unclipped sample sum (:372-376) that the sharded renderer adds up
// across devices before one divide and clip. Its plain
// PyTorch version is ttrt_torch/kernels/pathtrace.py::pathtrace_frame_plain,
// which mirrors this math op for op.
//
// Per path, as the JAX kernel: next-event estimation (NEE) with one surface
// sample on every spherical area light and an any-hit shadow ray cut at
// sqrt(d2) * (1 - 5e-5); a specular (probability = reflectivity) or
// cosine-diffuse continuation; Russian roulette from bounce 3; the sky at
// the exit direction weighted by the throughput frozen at the miss.
//
// Random numbers: the JAX kernel's counter-based hash, u = u01(mix32(idx ^
// mix32(seed + (bounce*64 + purpose) * 0x9E3779B9))), in uint32 arithmetic,
// with the JAX kernel's ray index idx = k * (W*H) + row * W + col. So every
// draw equals the Pallas lane's; u01 takes the 24 high bits, exact in float.
//
// Design: one thread per pixel, 1-D blocks of 128. The scene (camera,
// spheres, plane) and the area lights, any number of spheres, go into
// shared memory once a block when they fit in 48 KB, else they are read in
// place.
// Each thread loops over its N samples in order and, per sample, over the
// bounces with a real loop that exits once the path is dead (a dead path
// changes no accumulator, so the exit is exact). It writes the (3, H, W)
// sum of its samples in sample order, divided by N and clipped to [0, 1]
// (or left as it is, SUM), and its work: nearest-hit traces | hits << 16, and the NEE
// shadow rays that found the light unblocked. None of the TPU kernel's
// shape is kept: no unrolled bounce chain, no (16, 128) ray tiles, no SMEM
// scalar tables.
//
// Floating point follows the demo kernel (render.cu): --fmad=false, no fast
// math, the contractions written out with fmaf and dot3, cosf and sinf as
// PyTorch's CUDA cos and sin call them, so the plain version on the card
// computes the same bits.
//
// What bounds it on this card: the operations. The demo frame at
// 480x280x10 spp, 10 bounces needs about 0.8 GFLOP (chip_smoke.py's
// pathtrace_ops on its work: 2.57 M nearest-hit traces of 6 spheres and the
// plane, 1.22 M hits, each with a light sample and a shadow ray), 0.0119 ms
// at the FP32 peak, and moves 2.7 MB. Measured on an NVIDIA H100 80GB HBM3
// at 700 W: 0.2188 ms, 18x that bound. Paths of one warp end at different
// bounces, so lanes idle in the bounce loop: divergence is the likely cost
// (occupancy and divergence are not measured).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int AL_FLOATS = 8;  // position 3, radius, color 3, intensity
// the NEE purposes 10 + 3*li and 11 + 3*li meet the cosine draw's 40 at an
// 11th light (pathtrace_pallas.py:355-360)
constexpr int MAX_AREA_LIGHTS = 10;
constexpr int PT_BLOCK = 128;
// the scene goes into dynamic shared memory up to this size (as in
// render.cu), else it is read in place
constexpr size_t SMEM_SCENE_BYTES = 48 * 1024;
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

// SMEM: the scene is copied into shared memory, else read in place; the
// spheres keep their index order either way. SUM: each pixel's unclipped
// sample sum, else its sample mean clipped to [0, 1].
template <bool SMEM, bool SUM>
__global__ void __launch_bounds__(PT_BLOCK)
pathtrace_kernel(const float* __restrict__ scene_buf, int n_sph, int n_al,
                 int W, int H, int N, int bounce_limit, int sky_kind,
                 int sky_dim, int bilinear, uint32_t seed,
                 float* __restrict__ out_rgb, int* __restrict__ out_count) {
  extern __shared__ float sbuf[];
  const float* sb = scene_buf;
  if (SMEM) {
    const int n_floats = CAM_FLOATS + SPHERE_FLOATS * n_sph + PLANE_FLOATS +
                         AL_FLOATS * n_al;
    for (int i = threadIdx.x; i < n_floats; i += blockDim.x)
      sbuf[i] = scene_buf[i];
    __syncthreads();
    sb = sbuf;
  }

  const int n_pixels = W * H;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pixels) return;

  const float* cam = sb;
  DemoTracer tr;
  tr.sph = sb + CAM_FLOATS;
  tr.plane = tr.sph + SPHERE_FLOATS * n_sph;
  tr.n_sph = n_sph;
  const float* al = tr.plane + PLANE_FLOATS;

  const float fW = (float)W, fH = (float)H;
  const float col = (float)(pix % W);
  const float row = (float)(pix / W) + cam[15];
  const float szc = cam[12], sw = cam[13], sh = cam[14];
  const Sky sky_map{sky_kind, sky_dim, bilinear != 0, nullptr};

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int nearest = 0, hits = 0, unblocked = 0;
  for (int k = 0; k < N; ++k) {
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
    acc_r = acc_r + fmaf(sky_w[0], sky[0], rad[0]);
    acc_g = acc_g + fmaf(sky_w[1], sky[1], rad[1]);
    acc_b = acc_b + fmaf(sky_w[2], sky[2], rad[2]);
  }
  if (SUM) {
    out_rgb[pix] = acc_r;
    out_rgb[n_pixels + pix] = acc_g;
    out_rgb[2 * n_pixels + pix] = acc_b;
  } else {
    const float fN = (float)N;
    out_rgb[pix] = clamp01(acc_r / fN);
    out_rgb[n_pixels + pix] = clamp01(acc_g / fN);
    out_rgb[2 * n_pixels + pix] = clamp01(acc_b / fN);
  }
  out_count[pix] = nearest | (hits << 16);
  out_count[n_pixels + pix] = unblocked;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// `reduce_sum` writes each pixel's unclipped sample sum, else the clipped
// mean. The caller allocates `out_rgb` (3*H*W floats) and `out_count`
// (2*H*W ints).
int ttrt_pathtrace(const float* scene_buf, int n_sph, int n_al, int W, int H,
                   int N, int bounce_limit, int sky_kind, int sky_dim,
                   int bilinear, int reduce_sum, uint32_t seed,
                   float* out_rgb, int* out_count, void* stream) {
  if (n_sph < 0 || n_al < 0 ||
      n_al > MAX_AREA_LIGHTS || W < 1 || H < 1 || N < 1 ||
      bounce_limit < 0 || sky_dim < 1 ||
      (sky_kind != SKY_COLORS && sky_kind != SKY_UV_CHECKER) ||
      (long long)W * H * N > 0x7FFFFFFFLL ||
      (long long)N * bounce_limit > 0x7FFF)
    return (int)cudaErrorInvalidValue;
  const size_t bytes =
      sizeof(float) * ((size_t)CAM_FLOATS + (size_t)SPHERE_FLOATS * n_sph +
                       PLANE_FLOATS + (size_t)AL_FLOATS * n_al);
  const bool smem = bytes <= SMEM_SCENE_BYTES;
  const auto kernel =
      reduce_sum ? (smem ? pathtrace_kernel<true, true>
                         : pathtrace_kernel<false, true>)
                 : (smem ? pathtrace_kernel<true, false>
                         : pathtrace_kernel<false, false>);
  const int n_pixels = W * H;
  const int grid = (n_pixels + PT_BLOCK - 1) / PT_BLOCK;
  kernel<<<grid, PT_BLOCK, smem ? bytes : 0, (cudaStream_t)stream>>>(
      scene_buf, n_sph, n_al, W, H, N, bounce_limit, sky_kind, sky_dim,
      bilinear, seed, out_rgb, out_count);
  return (int)cudaGetLastError();
}

}  // extern "C"
