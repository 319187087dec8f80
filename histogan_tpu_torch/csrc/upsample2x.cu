// 2x bilinear upsample of an NCHW tensor (half-pixel centres, no
// antialias: nn.Upsample(scale_factor=2, mode='bilinear',
// align_corners=False)), forward (U1) and backward (U2).
//
// Replaces no TPU kernel: the JAX package's upsample2x
// (histogan_tpu/ops/resize.py) is XLA's jax.image.resize, with no Pallas
// kernel. It was added because aten's CUDA forward for an NCHW tensor
// (upsample_bilinear2d_out_frame) starts one thread per output pixel and
// loops over all N * C planes in each: at G's first block (2048 channels,
// 4^2 -> 8^2, batch 16) that is 64 threads of 32 768 serial loads each,
// one memory latency an iteration, and G's upsamples took 29 % of a
// sampling request on an H100.
//
// What bounds it on an H100: the bytes. U1 reads each input element once
// and writes four, with 12 fp32 operations an output; U2 reads four
// gradient elements and writes one, with 40 operations: both far under the
// card's 20 operations a byte. At (16, 64, 128^2) U1 moves 335 MB, 0.10 ms
// at 3.35 TB/s. The design:
//   * One thread per input element (n, c, i, j) in both kernels: the
//     parallelism is N * C * H * W whatever the shape, from 2048 channels
//     at 4^2 to 64 at 128^2, so every shape fills the card with no switch.
//   * U1 writes its 2x2 output quad, each output row as one pair (8 bytes
//     in fp32, 4 in bf16): a warp's stores are whole runs of 256 or 128
//     bytes. It reads the clamped 3x3 neighbourhood; neighbouring threads
//     read the same lines, which L1 serves, so device memory sees each
//     input line about once.
//   * The weights are aten's for a scale of 2: source row 0.5 (r + 0.5) -
//     0.5, clamped at 0, gives output row 2i the rows i - 1 and i at 0.25
//     and 0.75 (row 0: row 0 at 1 and row min(1, H - 1) at 0), and output
//     row 2i + 1 the rows i and min(i + 1, H - 1) at 0.75 and 0.25;
//     columns alike. The expression and its order are aten's,
//     h0 (w0 a + w1 b) + h1 (w0 c + w1 d), and so are its roundings: nvcc
//     fuses each sum's left product into an fma in aten's kernel, and U1
//     writes those fmas out. So U1 equals aten's forward bit for bit
//     (tests/test_torch_cuda.py), and the plain version
//     (ops/resize.py, upsample2x_plain), which rounds each step alone, to
//     an ulp or two. Rounding each step alone here as well put about a
//     sixth of the fp32 outputs an ulp off aten's, and the benchmark's
//     check, whose reference runs aten, read wider first-step gaps.
//   * U2 is a gather: each input-gradient element sums the output-gradient
//     rows 2i - 1 .. 2i + 2 and columns 2j - 1 .. 2j + 2 with the same
//     weights (a tap past an edge reads 0 at weight 0; the last row's two
//     taps on output row 2H - 1 fold into one weight of 1), each row along
//     its columns first and then over the rows, in fp32 (fp64 for fp64).
//     It needs no atomics and no zero fill, and gives the same bits on
//     every run (aten's backward adds with atomicAdd); it equals
//     upsample2x_bwd_plain bit for bit.
//   * bf16 is loaded, computed in fp32 and rounded once on store, as aten
//     does with its accscalar_t; fp64 (the float64 oracles that check the
//     port on the card) is computed in fp64.
//   * Offsets are 32-bit where the output has fewer than 2^31 elements,
//     else 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kFloat32 = 0, kBFloat16 = 1, kFloat64 = 2;  // the dtype argument

// The type a value is computed in: fp32 for fp32 and bf16, fp64 for fp64.
template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

template <typename A> struct Pair { A x, y; };

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ double load(const double* p) { return *p; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }

// The two values at p[0], p[1] (p is even, so the pair is aligned).
__device__ __forceinline__ Pair<float> load_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return {v.x, v.y};
}
__device__ __forceinline__ Pair<float> load_pair(const __nv_bfloat16* p) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return {v.x, v.y};
}
__device__ __forceinline__ Pair<double> load_pair(const double* p) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  return {v.x, v.y};
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

// A product or sum rounded by itself, never contracted into an fma.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

// aten's h0 (w0 a + w1 b) + h1 (w0 c + w1 d) with aten's roundings: each
// sum's left product fused into an fma, its right product rounded alone.
template <typename A>
__device__ __forceinline__ A blend(A h0, A h1, A w0, A w1, A a, A b, A c, A d) {
  return fma(h0, fma(w0, a, mul(w1, b)), mul(h1, fma(w0, c, mul(w1, d))));
}

// ((k0 v0 + k1 v1) + k2 v2) + k3 v3.
template <typename A>
__device__ __forceinline__ A sum4(A k0, A k1, A k2, A k3, A v0, A v1, A v2, A v3) {
  return add(add(add(mul(k0, v0), mul(k1, v1)), mul(k2, v2)), mul(k3, v3));
}

// U1: x (planes, h, w) -> y (planes, 2h, 2w); one thread per element of x.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
upsample2x_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, I total, int h, int w) {
  using A = typename Acc<T>::type;
  const I idx = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int j = static_cast<int>(idx % w);
  const I row = idx / w;
  const int i = static_cast<int>(row % h);
  const I plane = row / h;
  const T* src = x + plane * (static_cast<I>(h) * w);
  const int it = max(i - 1, 0), ib = min(i + 1, h - 1);
  const int jl = max(j - 1, 0), jr = min(j + 1, w - 1);
  const int rows[3] = {it, i, ib};
  A v[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const T* line = src + static_cast<I>(rows[r]) * w;
    v[r][0] = load(line + jl);
    v[r][1] = load(line + j);
    v[r][2] = load(line + jr);
  }
  // Output row 2i blends rows it and i, or row 0 at 1 and ib at 0 when
  // i == 0; output row 2i + 1 rows i and ib. Columns alike: the even
  // column's right tap is j, or jr at weight 0 when j == 0.
  const bool up = i > 0, left = j > 0;
  const A q = 0.25, t = 0.75;
  const A hi0 = up ? q : A(1), hi1 = up ? t : A(0);
  const A wj0 = left ? q : A(1), wj1 = left ? t : A(0);
  const A e0 = up ? v[1][0] : v[2][0];  // the even row's bottom row
  const A e1 = up ? v[1][1] : v[2][1];
  const A e2 = up ? v[1][2] : v[2][2];
  T* out = y + plane * (static_cast<I>(4) * h * w) + static_cast<I>(2 * i) * (2 * w) + 2 * j;
  store_pair(out,
             blend(hi0, hi1, wj0, wj1, v[0][0], left ? v[0][1] : v[0][2], e0, left ? e1 : e2),
             blend(hi0, hi1, t, q, v[0][1], v[0][2], e1, e2));
  store_pair(out + 2 * w,
             blend(t, q, wj0, wj1, v[1][0], left ? v[1][1] : v[1][2], v[2][0],
                   left ? v[2][1] : v[2][2]),
             blend(t, q, t, q, v[1][1], v[1][2], v[2][1], v[2][2]));
}

// U2: g (planes, 2h, 2w) -> dx (planes, h, w); one thread per element of dx.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
upsample2x_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx, I total, int h, int w) {
  using A = typename Acc<T>::type;
  const I idx = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int j = static_cast<int>(idx % w);
  const I row = idx / w;
  const int i = static_cast<int>(row % h);
  const I plane = row / h;
  const int wo = 2 * w;
  const T* src = g + plane * (static_cast<I>(4) * h * w);
  // the weights of taps 2j - 1 .. 2j + 2 (columns) and 2i - 1 .. 2i + 2 (rows)
  const A q = 0.25, t = 0.75, one = 1, zero = 0;
  const A c0 = j > 0 ? q : zero, c1 = j > 0 ? t : one;
  const A c2 = j < w - 1 ? t : one, c3 = j < w - 1 ? q : zero;
  const A r0 = i > 0 ? q : zero, r1 = i > 0 ? t : one;
  const A r2 = i < h - 1 ? t : one, r3 = i < h - 1 ? q : zero;
  A s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 2 * i - 1 + k;
    if (r < 0 || r >= 2 * h) {
      s[k] = zero;
      continue;
    }
    const T* line = src + static_cast<I>(r) * wo + 2 * j;
    const Pair<A> mid = load_pair(line);
    const A left = j > 0 ? load(line - 1) : zero;
    const A right = j < w - 1 ? load(line + 2) : zero;
    s[k] = sum4(c0, c1, c2, c3, left, mid.x, mid.y, right);
  }
  store(dx + idx, sum4(r0, r1, r2, r3, s[0], s[1], s[2], s[3]));
}

template <typename T>
cudaError_t launch(bool backward, const void* in, void* out, long long planes, int h, int w,
                   cudaStream_t st) {
  const long long total = planes * h * w;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  if (4 * total < (1LL << 31)) {
    const int n = static_cast<int>(total);
    if (backward) {
      upsample2x_bwd_kernel<T, int><<<blocks, kThreads, 0, st>>>(src, dst, n, h, w);
    } else {
      upsample2x_fwd_kernel<T, int><<<blocks, kThreads, 0, st>>>(src, dst, n, h, w);
    }
  } else if (backward) {
    upsample2x_bwd_kernel<T, long long><<<blocks, kThreads, 0, st>>>(src, dst, total, h, w);
  } else {
    upsample2x_fwd_kernel<T, long long><<<blocks, kThreads, 0, st>>>(src, dst, total, h, w);
  }
  return cudaGetLastError();
}

int run(bool backward, const void* in, void* out, long long planes, int h, int w, int dtype,
        int device, void* stream) {
  if (planes < 1 || h < 1 || w < 1 || planes * h * w > (1LL << 40) ||
      (planes * h * w + kThreads - 1) / kThreads > 0x7fffffffLL || device < 0 ||
      device >= kMaxDevices || dtype < kFloat32 || dtype > kFloat64) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    err = launch<__nv_bfloat16>(backward, in, out, planes, h, w, st);
  } else if (dtype == kFloat64) {
    err = launch<double>(backward, in, out, planes, h, w, st);
  } else {
    err = launch<float>(backward, in, out, planes, h, w, st);
  }
  return (int)err;
}

}  // namespace

extern "C" {

// x (planes, h, w), contiguous, of `dtype` (0 fp32, 1 bf16, 2 fp64); y
// (planes, 2h, 2w) of the same type, aligned to two elements. Launches U1
// on `stream` and returns cudaGetLastError().
int upsample2x_fwd(const void* x, void* y, long long planes, int h, int w, int dtype,
                   int device, void* stream) {
  return run(false, x, y, planes, h, w, dtype, device, stream);
}

// g (planes, 2h, 2w), contiguous and aligned to two elements; dx (planes,
// h, w) of the same type. Launches U2 on `stream` and returns
// cudaGetLastError().
int upsample2x_bwd(const void* g, void* dx, long long planes, int h, int w, int dtype,
                   int device, void* stream) {
  return run(true, g, dx, planes, h, w, dtype, device, stream);
}

const char* upsample2x_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
