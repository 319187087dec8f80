// RGB-uv histogram forward: hist[b, c, i, j] = sum_n iy[n] * ku_c[n, i] * kv_c[n, j].
//
// Replaces histogan_tpu/ops/histogram_pallas.py::_fwd_kernel (the Pallas
// TPU kernel behind _hist_core). Input is the packed pixel array
// (B, N, 8) = [u0 v0 u1 v1 u2 v2 iy 0] that pack_pixels builds; output is
// the (B, 3, 64, 64) un-normalised histogram. The bin kernel is
// inverse-quadratic, ku = 1 / (1 + (u - c_i)^2 * inv_sigma2), against 64
// centres on [-3, 3] (np.linspace(-3, 3, 64) in float32).
//
// What bounds it on an H100: the contraction is 3 * 64 * 64 * 2 flops per
// pixel, about 0.55 GFLOP for one 150x150 target image, against about
// 0.7 MB of packed input read once: some 800 flops per byte, far above the
// card's fp32 ridge. So it is bound by fp32 FMA throughput, and the design
// keeps the FMA pipes fed:
//   * every block owns one (image, plane, pixel chunk) and accumulates the
//     whole 64x64 plane in registers, a 4x4 tile per thread (256 threads),
//     in plain fp32 FMA: no TF32 and no tensor cores, so the sums keep the
//     1e-6 agreement with the fp32 einsum;
//   * a loop over 64-pixel tiles builds iy*ku and kv in shared memory once
//     per tile, so the 64x64x64 FMAs of a tile read only shared memory
//     (two float4 loads per 16 FMAs, bank-conflict free);
//   * the pixels of an image are split over enough chunks to give every
//     SM work even for a single target image (the TPU kernel walked them
//     in sequence); the chunk partials are summed in a fixed order by a
//     second kernel, not with atomics, so the result is deterministic;
//   * the ragged edge is masked in the kernel (a pixel past the end gets
//     iy = 0 and adds nothing) where the TPU version padded to 512.
// ku, kv and iy*ku are computed with round-to-nearest intrinsics (no FMA
// contraction), as the plain PyTorch version computes them.

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, a 4x4 register tile each
constexpr int kTile = 64;      // pixels per shared-memory tile
constexpr int kPack = 8;       // floats per packed pixel
constexpr int kPlane = kBins * kBins;

__device__ __forceinline__ float inverse_quadratic(float x, float centre, float inv_sigma2) {
  const float d = __fsub_rn(x, centre);
  return __frcp_rn(__fadd_rn(1.0f, __fmul_rn(__fmul_rn(d, d), inv_sigma2)));
}

// grid (n_chunks, 3, B). Writes the chunk's partial plane to
// dst[((b * 3 + c) * n_chunks + s) * 4096].
__global__ void __launch_bounds__(kThreads)
hist_partial_kernel(const float* __restrict__ packed, float* __restrict__ dst,
                    int n_pixels, int chunk, int n_chunks, float inv_sigma2) {
  const int s = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  __shared__ float px_u[kTile];
  __shared__ float px_v[kTile];
  __shared__ float px_iy[kTile];
  __shared__ __align__(16) float a_tile[kTile][kBins];  // iy * ku
  __shared__ __align__(16) float b_tile[kTile][kBins];  // kv

  // This thread's bin when building the tiles. Centre as numpy computes
  // linspace: i * (6 / 63) - 3 in double, then rounded to float.
  const int bin = tid & (kBins - 1);
  const float centre =
      (float)__dadd_rn(__dmul_rn((double)bin, __ddiv_rn(6.0, 63.0)), -3.0);

  const int tx = tid & 15;  // output columns j = 4 tx .. 4 tx + 3
  const int ty = tid >> 4;  // output rows    i = 4 ty .. 4 ty + 3
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;

  const float* img = packed + (size_t)b * n_pixels * kPack;
  const int start = s * chunk;
  const int stop = min(start + chunk, n_pixels);

  for (int t0 = start; t0 < stop; t0 += kTile) {
    if (tid < kTile) {
      const int n = t0 + tid;
      float u = 0.0f, v = 0.0f, iy = 0.0f;  // masked pixel: iy = 0 adds nothing
      if (n < stop) {
        const float* px = img + (size_t)n * kPack;
        u = px[2 * c];
        v = px[2 * c + 1];
        iy = px[6];
      }
      px_u[tid] = u;
      px_v[tid] = v;
      px_iy[tid] = iy;
    }
    __syncthreads();

    // Consecutive threads write consecutive bins of one pixel row.
#pragma unroll 4
    for (int p = tid >> 6; p < kTile; p += kThreads / kBins) {
      a_tile[p][bin] = __fmul_rn(px_iy[p], inverse_quadratic(px_u[p], centre, inv_sigma2));
      b_tile[p][bin] = inverse_quadratic(px_v[p], centre, inv_sigma2);
    }
    __syncthreads();

    // The tile's sum is kept apart and then added to the running sum: the
    // fp32 rounding then grows with 64 + chunk / 64 terms, not chunk.
    float tile_acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) tile_acc[r][q] = 0.0f;
#pragma unroll 8
    for (int p = 0; p < kTile; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(&a_tile[p][4 * ty]);
      const float4 k = *reinterpret_cast<const float4*>(&b_tile[p][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) tile_acc[r][q] = fmaf(av[r], kv[q], tile_acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] += tile_acc[r][q];
    __syncthreads();
  }

  float* plane = dst + (((size_t)b * 3 + c) * n_chunks + s) * kPlane;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    *reinterpret_cast<float4*>(&plane[(4 * ty + r) * kBins + 4 * tx]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// grid (B * 3, kPlane / kThreads). out[plane, e] = sum over s, in order,
// of partial[plane, s, e].
__global__ void __launch_bounds__(kThreads)
hist_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int n_chunks) {
  const size_t plane = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  const float* src = partial + plane * n_chunks * kPlane + e;
  float sum = 0.0f;
  for (int s = 0; s < n_chunks; ++s) sum += src[(size_t)s * kPlane];
  out[plane * kPlane + e] = sum;
}

}  // namespace

extern "C" {

// packed (batch, n_pixels, 8) fp32, contiguous; out (batch, 3, 64, 64) fp32.
// partial (batch, 3, n_chunks, 64, 64) fp32 scratch, unused (may equal out)
// when n_chunks == 1. Launches on `stream` and returns cudaGetLastError().
int histogram_fwd(const float* packed, float* partial, float* out, int batch, int n_pixels,
                  int chunk, int n_chunks, float inv_sigma2, int device, void* stream) {
  if (batch < 1 || batch > 65535 || n_pixels < 1 || chunk < 1 || chunk % kTile != 0 ||
      n_chunks < 1 || (long long)chunk * (n_chunks - 1) >= n_pixels ||
      (long long)chunk * n_chunks < n_pixels) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = n_chunks == 1 ? out : partial;
  hist_partial_kernel<<<dim3(n_chunks, 3, batch), kThreads, 0, st>>>(packed, dst, n_pixels, chunk,
                                                                     n_chunks, inv_sigma2);
  if (n_chunks > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    hist_reduce_kernel<<<dim3(batch * 3, kPlane / kThreads), kThreads, 0, st>>>(partial, out,
                                                                               n_chunks);
  }
  return (int)cudaGetLastError();
}

const char* histogram_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
