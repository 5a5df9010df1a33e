// Demo-scene render kernels for Hopper (sm_90a).
//
// render_kernel<false> replaces the TPU kernel
// ttrt/kernels/render_pallas.py::_render_kernel (:894, launched at :1154):
// its procedural-sky variant and its textured (image-cubemap) variant, each
// nearest or bilinear, with the flags `specular` and
// `energy_model="subtract"`, for the whole frame (render_frame_pallas,
// :1263) or for a band of rows x a slice of AA samples with the sample sum
// or average (render_band_pallas, :1357), the launch of each device of the
// sharded renderers. render_kernel<true> replaces _render_kernel_acc (:612,
// launched at :1083), the pixel-rate layout: the same frame, with each
// pixel's counts written as the 16|16 sums bounces | hits << 16 of its
// samples (:711-715). sky_weight_kernel replaces _sky_weight_kernel (:860,
// launched at :1181): the per-ray sky weight of the bounce chain, with no
// lighting. Their plain PyTorch versions are
// ttrt_torch/kernels/render.py::render_band_plain, render_frame_pixel_rate_plain
// and sky_weights_plain, which mirror this math op for op.
//
// Design: one thread per pixel of the band. Each thread loops over its AA
// samples k = 0..n_samples-1 in order (the sample index and the row carry
// the band's offsets, cam[16] and cam[15], and the jitter uses the frame's
// N) and, per sample, over the bounces with a real loop that exits when the
// ray dies (a dead ray changes no accumulator, so the exit is exact). It
// sums the per-sample normalized colors and multiplies by `scale`: 1/N
// gives the JAX package's reshape(N,H,W).sum(0) * (1/N)
// (render_pallas.py:1350-1352) and its acc layout's in-order sum times 1/N
// (:1097-1100), 1 the band's sample sum (:1398-1400). Outputs: (3, n_rows,
// W) float32 and a per-pixel int32 count (bounces + hits * n_lights,
// render_pallas.py:1050-1057, or the 16|16 sums), 2.2 MB a frame at 480x280
// against the 27 MB of per-ray outputs the TPU kernel writes;
// sky_weight_kernel writes the (N, H, W) float32 sky weights, sample-major
// as the JAX rays. The scene is a packed float32 buffer (the PackedScene
// layout: cam 17, spheres 9 each, plane 16, directional lights 6 each, point
// lights 7 each) of any size, which each block copies into shared memory
// once when it fits in 48 KB and otherwise reads in place; an image sky's
// texel table stays in device memory (common.cuh::Sky). None of the TPU
// kernel's shape is kept: no unrolled bounce chain, no (16, 128) tiles, no
// SMEM scalar tables, no deferred sky gather, and no kernel split for the
// decoy sky (the Mosaic scheduling cliff it insured against does not exist
// here).
//
// Floating point follows the JAX oracle: build with --fmad=false and
// without --use_fast_math, so every product and sum rounds as written and
// sqrtf and '/' are IEEE. Each Python-side constant is folded in double and
// cast to float once, as JAX's weak-typed scalars are. XLA:CPU contracts
// a*b + c into fma inside the oracle's compiled bounce loop (the left
// product of a*b + c*d); the kernel writes those fmaf calls out (dot3 and
// the explicit fmaf calls here and in common.cuh), so the near-zero
// hit-offset term c = |p - center|^2 - r^2 rounds as the oracle's does.
// Ray generation (but for its normalize), the texel unpacking, the bilinear
// lerps and the sky fold stay uncontracted, as the oracle computes them op
// by op.
//
// What bounds it on this card: the operations. A frame at 480x280x10 and
// t = 1.5 makes 5,249,350 traces, each at least a shadow trace's 128 FP32
// operations, 0.0100 ms at the FP32 peak; its bytes (the scene, a
// 1,572,864-byte texel table at dim 256, 2.2 MB of output) take about a
// tenth of that. Measured on an NVIDIA H100 80GB HBM3 at 700 W: about
// 0.23 ms for the kernel alone (PERF.md), so latency and warp divergence
// (rays of one warp die at different bounces) bound it, and the frame is
// bound by the host (the ANSI encode, the 3,360,286-byte copy to the host
// and write(2)).

#include "common.cuh"

namespace {

constexpr int BLOCK = 128;
// A scene of up to this many bytes goes into dynamic shared memory (the
// launch needs no opt-in attribute below 48 KB): 1,357 spheres with the
// demo's two lights. A larger scene is read in place from the global
// buffer (SMEM = false), through L1 and L2: a block holding a larger table
// would leave room for only a few blocks on an SM.
constexpr size_t SMEM_SCENE_BYTES = 48 * 1024;

size_t scene_bytes(int n_sph, int n_dl, int n_pl) {
  return sizeof(float) *
         ((size_t)CAM_FLOATS + (size_t)SPHERE_FLOATS * n_sph + PLANE_FLOATS +
          (size_t)DLIGHT_FLOATS * n_dl + (size_t)PLIGHT_FLOATS * n_pl);
}

// Point the tracer and the lights into the packed scene and return the
// camera row: with SMEM, a copy in the shared memory `sbuf` (every thread
// of the block takes part), else the global buffer itself. Objects keep
// their index order either way, so the nearest hit and its ties do not
// depend on where they are read from.
template <bool SMEM>
__device__ __forceinline__ const float* load_scene(
    const float* __restrict__ scene_buf, int n_sph, int n_dl, int n_pl,
    float* sbuf, DemoTracer& tr, Lights& L) {
  const float* s = scene_buf;
  if (SMEM) {
    const int n_floats = CAM_FLOATS + SPHERE_FLOATS * n_sph + PLANE_FLOATS +
                         DLIGHT_FLOATS * n_dl + PLIGHT_FLOATS * n_pl;
    for (int i = threadIdx.x; i < n_floats; i += blockDim.x)
      sbuf[i] = scene_buf[i];
    __syncthreads();
    s = sbuf;
  }
  tr.sph = s + CAM_FLOATS;
  tr.plane = tr.sph + SPHERE_FLOATS * n_sph;
  tr.n_sph = n_sph;
  L.dl = tr.plane + PLANE_FLOATS;
  L.pl = L.dl + DLIGHT_FLOATS * n_dl;
  L.n_dl = n_dl;
  L.n_pl = n_pl;
  return s;
}

// Rows [cam[15], cam[15] + n_rows) and samples [cam[16], cam[16] +
// n_samples) of the W x H x N frame: one thread per pixel of the band
// writes its sample sum times `scale` (1/N for the average, 1 for the
// sum). PIXEL_RATE: out_count holds the pixel's 16|16 sums (the acc
// layout) instead of its trace count.
template <bool PIXEL_RATE, bool SMEM>
__global__ void __launch_bounds__(BLOCK)
render_kernel(const float* __restrict__ scene_buf, int n_sph, int n_dl,
              int n_pl, int W, int H, int N, int n_rows, int n_samples,
              int bounce_limit, int specular, int subtract, Sky sky,
              float scale, float* __restrict__ out_rgb,
              int* __restrict__ out_count) {
  extern __shared__ float sbuf[];
  DemoTracer tr;
  Lights L;
  const float* cam =
      load_scene<SMEM>(scene_buf, n_sph, n_dl, n_pl, sbuf, tr, L);

  const int n_pixels = W * n_rows;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pixels) return;

  float acc_r, acc_g, acc_b;
  int bounces, hits;
  render_pixel(tr, L, cam, pix % W, pix / W, W, H, N, n_samples,
               bounce_limit, specular != 0, subtract != 0, sky, acc_r, acc_g,
               acc_b, bounces, hits);
  out_rgb[pix] = acc_r * scale;
  out_rgb[n_pixels + pix] = acc_g * scale;
  out_rgb[2 * n_pixels + pix] = acc_b * scale;
  // hits may reach 0xFFFF (check_pixel_rate): shift it unsigned, so bit 31
  // is set without a signed overflow
  out_count[pix] =
      PIXEL_RATE ? (int)((unsigned)bounces | ((unsigned)hits << 16))
                 : bounces + hits * (n_dl + n_pl);
}

// The sky weight of every ray, out_w[k * H * W + pixel]: the bounce chain
// of render_kernel with the lighting compiled out (trace_sample<false>).
template <bool SMEM>
__global__ void __launch_bounds__(BLOCK)
sky_weight_kernel(const float* __restrict__ scene_buf, int n_sph, int n_dl,
                  int n_pl, int W, int H, int N, int bounce_limit,
                  float* __restrict__ out_w) {
  extern __shared__ float sbuf[];
  DemoTracer tr;
  Lights L;
  const float* cam =
      load_scene<SMEM>(scene_buf, n_sph, n_dl, n_pl, sbuf, tr, L);

  const int n_pixels = W * H;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pixels) return;
  for (int k = 0; k < N; ++k) {
    const Sample s = trace_sample<false>(tr, L, cam, pix % W, pix / W, k, W,
                                         H, N, bounce_limit, false, false);
    out_w[k * n_pixels + pix] = s.sky_w;
  }
}

bool scene_ok(int n_sph, int n_dl, int n_pl, int W, int H, int N) {
  return n_sph >= 0 && n_dl >= 0 && n_pl >= 0 && W >= 1 && H >= 1 &&
         N >= 1 && (long long)W * H * N <= 0x7FFFFFFFLL &&
         scene_bytes(n_sph, n_dl, n_pl) <= 0x7FFFFFFFu;
}

}  // namespace

extern "C" {

// Launch render_kernel on `stream` for rows [cam[15], cam[15] + n_rows)
// and samples [cam[16], cam[16] + n_samples) of the W x H x N frame;
// returns cudaGetLastError() (0 on success). `texels` is the image sky's
// (6, sky_dim, sky_dim) int32 table (read only when sky_kind is
// SKY_IMAGE); `scale` multiplies each pixel's sample sum; `pixel_rate`
// selects the 16|16 counts. The caller allocates `out_rgb` (3*n_rows*W
// floats) and `out_count` (n_rows*W ints).
int ttrt_render(const float* scene_buf, int n_sph, int n_dl, int n_pl, int W,
                int H, int N, int n_rows, int n_samples, int bounce_limit,
                int specular, int subtract, int sky_kind, int sky_dim,
                int bilinear, const int* texels, float scale, int pixel_rate,
                float* out_rgb, int* out_count, void* stream) {
  if (!scene_ok(n_sph, n_dl, n_pl, W, H, N) || n_rows < 1 || n_rows > H ||
      n_samples < 1 || n_samples > N || sky_dim < 1 ||
      sky_kind < SKY_COLORS || sky_kind > SKY_IMAGE ||
      (sky_kind == SKY_IMAGE && texels == nullptr) ||
      (pixel_rate && (long long)n_samples * bounce_limit > 0xFFFF))
    return (int)cudaErrorInvalidValue;
  const Sky sky{sky_kind, sky_dim, bilinear != 0, texels};
  const size_t bytes = scene_bytes(n_sph, n_dl, n_pl);
  const bool smem = bytes <= SMEM_SCENE_BYTES;
  const auto kernel = pixel_rate ? (smem ? render_kernel<true, true>
                                         : render_kernel<true, false>)
                                 : (smem ? render_kernel<false, true>
                                         : render_kernel<false, false>);
  const int grid = (W * n_rows + BLOCK - 1) / BLOCK;
  kernel<<<grid, BLOCK, smem ? bytes : 0, (cudaStream_t)stream>>>(
      scene_buf, n_sph, n_dl, n_pl, W, H, N, n_rows, n_samples, bounce_limit,
      specular, subtract, sky, scale, out_rgb, out_count);
  return (int)cudaGetLastError();
}

// Launch sky_weight_kernel on `stream`; returns cudaGetLastError(). The
// caller allocates `out_w` (N*H*W floats).
int ttrt_sky_weights(const float* scene_buf, int n_sph, int n_dl, int n_pl,
                     int W, int H, int N, int bounce_limit, float* out_w,
                     void* stream) {
  if (!scene_ok(n_sph, n_dl, n_pl, W, H, N))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = scene_bytes(n_sph, n_dl, n_pl);
  const bool smem = bytes <= SMEM_SCENE_BYTES;
  const auto kernel =
      smem ? sky_weight_kernel<true> : sky_weight_kernel<false>;
  const int grid = (W * H + BLOCK - 1) / BLOCK;
  kernel<<<grid, BLOCK, smem ? bytes : 0, (cudaStream_t)stream>>>(
      scene_buf, n_sph, n_dl, n_pl, W, H, N, bounce_limit, out_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
