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
// The estimator (next-event estimation on the spherical area lights, a
// specular or cosine-diffuse continuation, Russian roulette from bounce
// 3) and its counter-based random stream are pathtrace.cuh's trace_path,
// shared with mesh.cu's many-object path tracer.
//
// Design: one thread per (pixel, sample). A pixel's N samples run on S
// neighbouring threads of one block, all of them up to 32, else in rounds
// of at most 32 (common.cuh::sample_threads); each thread traces its own
// path, sample k with the JAX kernel's ray index, its bounces a real loop
// that exits once the path is dead (a dead path changes no accumulator,
// so the exit is exact). The pixel's first thread adds the paths' colors
// in sample order from 0.0f, as the plain version's in-order sum does,
// and writes the sum (SUM) or the sum divided by N and clipped to [0, 1]
// (a division, as the plain version's: a product with 1/N rounds some
// sums differently, so the render kernel's `scale` does not serve), and
// the sums of two per-path counts: nearest-hit traces | hits << 16 and
// the NEE shadow rays that found the light unblocked. The block is
// common.cuh::pick_block's. The scene (camera, spheres, plane) and the
// area lights, any number of spheres, go into shared memory once a block
// when they fit in 48 KB, else they are read in place. None of the TPU
// kernel's shape is kept: no unrolled bounce chain, no (16, 128) ray
// tiles, no SMEM scalar tables.
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
// at the FP32 peak, and moves 2.7 MB. On an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md, run AJ): the one-thread-a-pixel form took 0.2026 ms,
// 17x that bound, its 1,050 blocks of 128 less than one wave, the launch
// as long as its slowest pixel's 10 paths; spread over threads, the frame
// is 5,376 blocks of 250 threads (25 pixels x 10 samples), 10.2 waves, in
// 0.1522 ms (13x). What remains is divergence: a warp's lanes hold one
// path each, and paths end at different bounces (misses, Russian
// roulette).

#include "pathtrace.cuh"

namespace {

// The launch: the smallest of PT_BLOCK, 2 * PT_BLOCK, ... PT_MAX_THREADS
// threads (whole pixels of S sample threads) that keeps the most warps
// resident on an SM (common.cuh::pick_block), with launch bounds that hold
// a thread to 65536 / (PT_MAX_THREADS * PT_MIN_BLOCKS) = 64 registers.
// PERF.md records the layouts compared before these were kept (runs AH
// and AI, an NVIDIA H100 80GB HBM3 at 700 W): 120-thread blocks were 3.4%
// slower than 250-thread ones, as in the render kernel; a 42-register cap
// spilled and was slower, and no cap (75-89 registers) 2-3% slower.
constexpr int PT_BLOCK = 256;
constexpr int PT_MAX_THREADS = 512;
constexpr int PT_MIN_BLOCKS = 2;
// the scene goes into dynamic shared memory up to this size (as in
// render.cu), else it is read in place
constexpr size_t SMEM_SCENE_BYTES = 48 * 1024;

// The W x H x N frame, a pixel's samples on S threads of one block
// (common.cuh::sample_threads): writes each pixel's sample sum (SUM) or
// its mean clipped to [0, 1] and its two counts. Shared memory: the
// sample sums with two count channels, then with SMEM the scene (the
// spheres keep their index order either way). ROUNDS = false is the
// one-round launch (S == N).
template <bool SMEM, bool SUM, bool ROUNDS>
__global__ void __launch_bounds__(PT_MAX_THREADS, PT_MIN_BLOCKS)
pathtrace_kernel(const float* __restrict__ scene_buf, int n_sph, int n_al,
                 int W, int H, int N, int S, int bounce_limit, int sky_kind,
                 int sky_dim, int bilinear, uint32_t seed,
                 float* __restrict__ out_rgb, int* __restrict__ out_count) {
  extern __shared__ float sbuf[];
  const SampleSums sm = sample_sums<2>(sbuf, S);
  const float* sb = scene_buf;
  if (SMEM) {
    const int n_floats = CAM_FLOATS + SPHERE_FLOATS * n_sph + PLANE_FLOATS +
                         AL_FLOATS * n_al;
    for (int i = threadIdx.x; i < n_floats; i += blockDim.x)
      sm.end[i] = scene_buf[i];
    __syncthreads();
    sb = sm.end;
  }
  const float* cam = sb;
  DemoTracer tr;
  tr.sph = sb + CAM_FLOATS;
  tr.plane = tr.sph + SPHERE_FLOATS * n_sph;
  tr.n_sph = n_sph;
  const float* al = tr.plane + PLANE_FLOATS;
  const Sky sky_map{sky_kind, sky_dim, bilinear != 0, nullptr};

  sample_threads<ROUNDS, 2>(
      sm, S, W, H, N,
      [&](int col, int row, int k, float& pr, float& pg, float& pb) {
        return trace_path(tr, cam, al, n_al, sky_map, col, row, k, W, H,
                          bounce_limit, seed, pr, pg, pb);
      },
      PathWrite<SUM>{N, out_rgb, out_count});
}

size_t scene_bytes(int n_sph, int n_al) {
  return sizeof(float) *
         ((size_t)CAM_FLOATS + (size_t)SPHERE_FLOATS * n_sph + PLANE_FLOATS +
          (size_t)AL_FLOATS * n_al);
}

using PathKernel = decltype(&pathtrace_kernel<true, false, false>);

PathKernel pathtrace_kernel_for(bool smem, bool sum, bool rounds) {
  if (sum)
    return smem ? (rounds ? pathtrace_kernel<true, true, true>
                          : pathtrace_kernel<true, true, false>)
                : (rounds ? pathtrace_kernel<false, true, true>
                          : pathtrace_kernel<false, true, false>);
  return smem ? (rounds ? pathtrace_kernel<true, false, true>
                        : pathtrace_kernel<true, false, false>)
              : (rounds ? pathtrace_kernel<false, false, true>
                        : pathtrace_kernel<false, false, false>);
}

struct PathShape : SampleShape {
  bool smem_scene;
};

// The launch of a W x H x N frame (see PT_BLOCK above).
cudaError_t pathtrace_shape(int n_sph, int n_al, int W, int H, int N,
                            bool sum, PathShape& sh) {
  sample_rounds(N, sh);
  const size_t bytes = scene_bytes(n_sph, n_al);
  sh.smem_scene = bytes <= SMEM_SCENE_BYTES;
  const PathKernel kernel = pathtrace_kernel_for(sh.smem_scene, sum,
                                                 sh.rounds);
  int optin = 0;
  cudaError_t err = allow_max_smem(kernel, optin);
  if (err == cudaSuccess)
    err = pick_block(kernel, sh.smem_scene ? bytes : 0, 2, optin, PT_BLOCK,
                     PT_MAX_THREADS, (long long)W * H, sh);
  if (err != cudaSuccess) return err;
  return sh.resident > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
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
  if (n_sph < 0 ||
      !path_args_ok(n_al, W, H, N, bounce_limit, sky_kind, sky_dim))
    return (int)cudaErrorInvalidValue;
  PathShape sh;
  const cudaError_t err =
      pathtrace_shape(n_sph, n_al, W, H, N, reduce_sum != 0, sh);
  if (err != cudaSuccess) return (int)err;
  pathtrace_kernel_for(sh.smem_scene, reduce_sum != 0, sh.rounds)<<<
      sh.blocks, sh.threads, sh.smem, (cudaStream_t)stream>>>(
      scene_buf, n_sph, n_al, W, H, N, sh.samples, bounce_limit, sky_kind,
      sky_dim, bilinear, seed, out_rgb, out_count);
  return (int)cudaGetLastError();
}

// The launch shape ttrt_pathtrace takes for a frame of these sizes, into
// out[10] (common.cuh::write_layout). Returns a CUDA error code (0 on
// success).
int ttrt_pathtrace_layout(int n_sph, int n_al, int W, int H, int N,
                          int reduce_sum, int* out) {
  if (n_sph < 0 || n_al < 0 || W < 1 || H < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  PathShape sh;
  const cudaError_t err =
      pathtrace_shape(n_sph, n_al, W, H, N, reduce_sum != 0, sh);
  if (err != cudaSuccess) return (int)err;
  return write_layout(
      sh, sh.smem_scene,
      pathtrace_kernel_for(sh.smem_scene, reduce_sum != 0, sh.rounds), out);
}

}  // extern "C"
