// Demo-scene render kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ttrt/kernels/render_pallas.py::_render_kernel
// (:894, launched at :1154), procedural-sky variant (nearest or bilinear),
// with its flags `specular` and `energy_model="subtract"`. Its plain
// PyTorch version is ttrt_torch/kernels/render.py::render_frame_plain,
// which mirrors this math op for op.
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
// the explicit fmaf calls here and in common.cuh), so the near-zero
// hit-offset term c = |p - center|^2 - r^2 rounds as the oracle's does.
// Ray generation
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

#include "common.cuh"

namespace {

constexpr int MAX_SCENE_FLOATS =
    CAM_FLOATS + SPHERE_FLOATS * MAX_SPHERES + PLANE_FLOATS +
    DLIGHT_FLOATS * MAX_DLIGHTS + PLIGHT_FLOATS * MAX_PLIGHTS;
constexpr int BLOCK = 128;

__global__ void __launch_bounds__(BLOCK)
render_kernel(const float* __restrict__ scene_buf, int n_sph, int n_dl,
              int n_pl, int W, int H, int N, int bounce_limit, int specular,
              int subtract, int sky_kind, int sky_dim, int bilinear,
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

  DemoTracer tr;
  tr.sph = sbuf + CAM_FLOATS;
  tr.plane = tr.sph + SPHERE_FLOATS * n_sph;
  tr.n_sph = n_sph;
  Lights L;
  L.dl = tr.plane + PLANE_FLOATS;
  L.pl = L.dl + DLIGHT_FLOATS * n_dl;
  L.n_dl = n_dl;
  L.n_pl = n_pl;

  float acc_r, acc_g, acc_b;
  int traces;
  render_pixel(tr, L, sbuf, pix % W, pix / W, W, H, N, N, bounce_limit,
               specular != 0, subtract != 0, sky_kind, sky_dim, bilinear != 0,
               acc_r, acc_g, acc_b, traces);
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
                int sky_kind, int sky_dim, int bilinear, float* out_rgb,
                int* out_count, void* stream) {
  if (n_sph < 0 || n_sph > MAX_SPHERES || n_dl < 0 || n_dl > MAX_DLIGHTS ||
      n_pl < 0 || n_pl > MAX_PLIGHTS || W < 1 || H < 1 || N < 1 ||
      sky_dim < 1 || (sky_kind != 0 && sky_kind != 1))
    return (int)cudaErrorInvalidValue;
  const int n_pixels = W * H;
  const int grid = (n_pixels + BLOCK - 1) / BLOCK;
  render_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      scene_buf, n_sph, n_dl, n_pl, W, H, N, bounce_limit, specular, subtract,
      sky_kind, sky_dim, bilinear, out_rgb, out_count);
  return (int)cudaGetLastError();
}

}  // extern "C"
