// RGB-uv histogram backward: d(loss)/d(packed) from g = d(loss)/d(hist).
//
// Replaces histogan_tpu/ops/histogram_pallas.py::_bwd_kernel (the Pallas
// TPU kernel behind _hist_core's custom VJP). Inputs are the packed pixel
// array (B, N, 8) = [u0 v0 u1 v1 u2 v2 iy 0] that pack_pixels builds and
// g (B, 3, 64, 64); the output is (B, N, 8). For one plane c, with
// ku[i] = 1 / (1 + (u - c_i)^2 * inv_sigma2) and kv[j] likewise over v:
//   kvg[i] = sum_j kv[j] g[i, j]            kug[j] = sum_i iy ku[i] g[i, j]
//   du     = sum_i iy kvg[i] * (-2 (u - c_i) inv_sigma2) * ku[i]^2
//   dv     = sum_j kug[j]    * (-2 (v - c_j) inv_sigma2) * kv[j]^2
//   diy   += sum_i ku[i] kvg[i]             (summed over the planes 0, 1, 2)
// and column 7 is 0.
//
// What bounds it on an H100: per pixel and plane the two 64x64 products
// are 8192 FMAs against 32 bytes of pixel read and written, and g is
// 48 KB per image, shared by all of its pixels. So it is bound by fp32
// FMA throughput and by feeding g to the FMA pipes. The design:
//   * one thread per pixel, all three planes, so the pixel's 8 outputs
//     belong to one thread: no atomics, no second pass, and diy is summed
//     over the planes in a fixed order;
//   * kv and the running kug of the pixel stay in registers (64 + 64), and
//     one pass over the rows i of g feeds both products: each g[i, j] read
//     from shared memory serves two FMAs;
//   * g is staged one 16 KB plane at a time in static shared memory, and
//     every thread of a warp reads the same g element at once (a broadcast
//     with no bank conflicts);
//   * plain fp32 FMA, no TF32 and no tensor cores; ku, kv, iy*ku and the
//     factors of du and dv use round-to-nearest intrinsics (no FMA
//     contraction), as the plain PyTorch version rounds them; the bin
//     centres are computed as numpy computes linspace;
//   * the ragged edge is masked: a thread past the end computes on zeros
//     and stores nothing (the TPU version padded to 512 pixels).

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 64;
constexpr int kThreads = 128;  // pixels per block
constexpr int kPack = 8;       // floats per packed pixel
constexpr int kPlane = kBins * kBins;

__device__ __forceinline__ float inverse_quadratic(float d, float inv_sigma2) {
  return __frcp_rn(__fadd_rn(1.0f, __fmul_rn(__fmul_rn(d, d), inv_sigma2)));
}

// d k / d x of the inverse-quadratic bin kernel, as the plain version
// writes it: (-2 d inv_sigma2) * k^2.
__device__ __forceinline__ float slope(float d, float k, float inv_sigma2) {
  return __fmul_rn(__fmul_rn(__fmul_rn(-2.0f, d), inv_sigma2), __fmul_rn(k, k));
}

// grid (ceil(N / kThreads), B); one thread per pixel.
__global__ void __launch_bounds__(kThreads)
hist_bwd_kernel(const float* __restrict__ packed, const float* __restrict__ g,
                float* __restrict__ dpacked, int n_pixels, float inv_sigma2) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool live = n < n_pixels;

  __shared__ __align__(16) float g_plane[kPlane];
  __shared__ float centres[kBins];
  if (threadIdx.x < kBins) {
    centres[threadIdx.x] =
        (float)__dadd_rn(__dmul_rn((double)threadIdx.x, __ddiv_rn(6.0, 63.0)), -3.0);
  }

  float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // u0 v0 u1 v1
  float4 hi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // u2 v2 iy 0
  const size_t row = ((size_t)b * n_pixels + n) * kPack;
  if (live) {
    lo = *reinterpret_cast<const float4*>(packed + row);
    hi = *reinterpret_cast<const float4*>(packed + row + 4);
  }
  const float iy = hi.z;
  const float us[3] = {lo.x, lo.z, hi.x};
  const float vs[3] = {lo.y, lo.w, hi.y};
  float out[6];
  float diy = 0.0f;

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    __syncthreads();  // the previous plane's readers are done with g_plane
    const float4* src = reinterpret_cast<const float4*>(g + ((size_t)b * 3 + c) * kPlane);
    for (int k = threadIdx.x; k < kPlane / 4; k += kThreads) {
      reinterpret_cast<float4*>(g_plane)[k] = src[k];
    }
    __syncthreads();

    const float u = us[c];
    const float v = vs[c];
    float kv[kBins];
    float kug[kBins];
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      kv[j] = inverse_quadratic(__fsub_rn(v, centres[j]), inv_sigma2);
      kug[j] = 0.0f;
    }

    float du = 0.0f;
    float diy_c = 0.0f;
#pragma unroll 1
    for (int i = 0; i < kBins; ++i) {
      const float du_arg = __fsub_rn(u, centres[i]);
      const float ku = inverse_quadratic(du_arg, inv_sigma2);
      const float a = __fmul_rn(iy, ku);
      const float4* g_row = reinterpret_cast<const float4*>(g_plane + i * kBins);
      float kvg = 0.0f;
#pragma unroll
      for (int q = 0; q < kBins / 4; ++q) {
        const float4 gq = g_row[q];
        kvg = fmaf(kv[4 * q + 0], gq.x, kvg);
        kvg = fmaf(kv[4 * q + 1], gq.y, kvg);
        kvg = fmaf(kv[4 * q + 2], gq.z, kvg);
        kvg = fmaf(kv[4 * q + 3], gq.w, kvg);
        kug[4 * q + 0] = fmaf(a, gq.x, kug[4 * q + 0]);
        kug[4 * q + 1] = fmaf(a, gq.y, kug[4 * q + 1]);
        kug[4 * q + 2] = fmaf(a, gq.z, kug[4 * q + 2]);
        kug[4 * q + 3] = fmaf(a, gq.w, kug[4 * q + 3]);
      }
      du = __fadd_rn(du, __fmul_rn(__fmul_rn(iy, kvg), slope(du_arg, ku, inv_sigma2)));
      diy_c = __fadd_rn(diy_c, __fmul_rn(ku, kvg));
    }

    float dv = 0.0f;
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      const float dv_arg = __fsub_rn(v, centres[j]);
      dv = __fadd_rn(dv, __fmul_rn(kug[j], slope(dv_arg, kv[j], inv_sigma2)));
    }
    out[2 * c] = du;
    out[2 * c + 1] = dv;
    diy = __fadd_rn(diy, diy_c);
  }

  if (live) {
    *reinterpret_cast<float4*>(dpacked + row) = make_float4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<float4*>(dpacked + row + 4) = make_float4(out[4], out[5], diy, 0.0f);
  }
}

}  // namespace

extern "C" {

// packed (batch, n_pixels, 8) and g (batch, 3, 64, 64) fp32, contiguous;
// dpacked (batch, n_pixels, 8) fp32. Launches on `stream` and returns
// cudaGetLastError().
int histogram_bwd(const float* packed, const float* g, float* dpacked, int batch, int n_pixels,
                  float inv_sigma2, int device, void* stream) {
  if (batch < 1 || batch > 65535 || n_pixels < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_pixels + kThreads - 1) / kThreads, batch);
  hist_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, g, dpacked, n_pixels, inv_sigma2);
  return (int)cudaGetLastError();
}

const char* histogram_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
