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
// What bounds it on an H100: per pixel and plane the products kv.g^T and
// ku.g are 2 x 64 x 64 FMAs, 49 152 FLOP a pixel over the three planes,
// against 32 bytes of pixel read and 32 written (g, 48 KB an image, is
// shared by all of its pixels): bound by operations. The kernel gate,
// 1e-5 of max|plain| per column, rules out one-pass TF32 (about 6e-4), so
// the products run on the tensor cores in split TF32, three TF32 products
// per fp32 product (see split_tf32), a third of the 495 TFLOP/s dense TF32
// peak: 19.5 us at (16, 64^2). The bytes take 1.5 us there and the ~5000
// elementwise operations a pixel 5 us on the fp32 pipes. mma.sync
// m16n8k8 TF32 reaches about 64 % of that peak on the card, and an SMSP
// issues nothing else while it dispatches one, so each instruction beside
// the mma adds to the time: the design keeps those few.
//   * One block per (image, pixel chunk), 8 warps, one block per SM; a
//     warp takes 16 pixels at a time (the M of m16n8k8) through all three
//     planes, so a pixel's 8 outputs belong to one warp: no atomics, no
//     second pass, diy summed over the planes in a fixed order.
//   * g is staged once per block, all three planes, already split into hi
//     and lo, in two layouts: GA[i][j/2] for kv.g^T and GB[i/2][j] for
//     ku.g. Each entry is a float4 {hi x0, hi x1, lo x0, lo x1} that is
//     exactly one thread's B fragment pair (b0, b1), so one LDS.128 feeds
//     three mma and the inner loop splits no B. Row strides of 36 and 66
//     float4 keep both reads free of bank conflicts (207 KB of dynamic
//     shared memory).
//   * The A operands (kv, then ku) are made in registers at the (pixel,
//     bin) places of the thread's A fragment. The K bins are permuted
//     within each k-step (k column q -> bin 2q, q + 4 -> bin 2q + 1, the
//     B rows alike) so that they are the bins of the thread's accumulator
//     columns: the ku and kv of the A operands serve again in the epilogue.
//   * The epilogue works in the accumulator layout: each thread sums its
//     16 bins in order, and the 4 threads of a quad add theirs with two
//     xor shuffles (the same bits on every lane): bitwise deterministic.
//     iy and -2 inv_sigma2 are taken out of the sums.
//   * ku and kv use the approximate reciprocal (rcp.approx, about 1 ulp;
//     its argument is >= 1), which runs beside the mma at no cost; fp32
//     elsewhere.
//   * The plane loop is rolled: its body is a third of the unrolled code,
//     and the registers it needs fit without spills.
//   * The ragged edge is masked: a row past the end computes on zeros and
//     is never stored (the TPU version padded to 512 pixels).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 64;
constexpr int kPack = 8;     // floats per packed pixel
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;    // pixels per warp step: the M of m16n8k8
constexpr int kPlane = kBins * kBins;
constexpr int kStrideA = 36;                     // float4 per GA row (32 + 4 pad)
constexpr int kStrideB = 66;                     // float4 per GB row (64 + 2 pad)
constexpr int kPlaneA = kBins * kStrideA;        // GA[i][jp], i < 64, jp < 32
constexpr int kPlaneB = kBins / 2 * kStrideB;    // GB[ip][j], ip < 32, j < 64
constexpr int kPlaneF4 = kPlaneA + kPlaneB;
constexpr int kSmemBytes = 3 * kPlaneF4 * (int)sizeof(float4);  // 211 968
constexpr int kMaxDevices = 64;

// x = hi + lo for split TF32. The tensor core reads a TF32 operand as the
// top 19 bits of its register, so x itself serves as hi = x truncated to
// TF32 (10 mantissa bits), and lo = x - hi, exact, is truncated in turn:
// the split costs two instructions, and hi.hi + hi.lo + lo.hi misses a.b
// by under 3 * 2^-20 |a| |b| (the two truncated lo and the dropped lo.lo).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi & 0xffffe000u)));
}

__device__ __forceinline__ float4 split_pair(float x0, float x1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(x0, h0, l0);
  split_tf32(x1, h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                     __uint_as_float(l1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], float b0,
                                         float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// d = a.b, the first term of a product: the accumulator starts from zero
// without a move per register.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4], float b0,
                                               float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)), "f"(0.0f));
}

// 1 / (1 + d^2 inv_sigma2) with the approximate reciprocal (the argument
// is >= 1, so ftz changes nothing).
__device__ __forceinline__ float bin_kernel(float d, float inv_sigma2) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(fmaf(d * d, inv_sigma2, 1.0f)));
  return r;
}

// acc[t][2p + e] = sum over the 64 bins of A times B[.][n] for the
// thread's accumulator rows p (gid, gid + 8) and columns n = bin
// 8t + 2q + e of the 8 n-tiles t. a[s] is the thread's A fragment of
// k-step s, in the order of the mma's a0 .. a3: a[s][2e + p] is row p at
// K bin 8s + 2q + e. The K bins are permuted within each k-step (k column
// q -> 2q, q + 4 -> 2q + 1, the B rows alike) so that they are the bins of
// the accumulator columns. tab points at the thread's first B pair; the
// pair of (s, t) is at tab[t * kT + s * kS].
template <int kT, int kS>
__device__ __forceinline__ void product(const float4* __restrict__ tab, const float (&a)[8][4],
                                        float (&acc)[8][4]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(a[s][j], hi[j], lo[j]);
    // The three terms, each over the 8 independent accumulators in turn, so
    // that no mma waits on the one just issued.
    float4 b[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) b[t] = tab[t * kT + s * kS];
#pragma unroll
    for (int t = 0; t < 8; ++t) {  // lo.hi
      if (s == 0) {
        mma_tf32_first(acc[t], lo, b[t].x, b[t].y);
      } else {
        mma_tf32(acc[t], lo, b[t].x, b[t].y);
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) mma_tf32(acc[t], hi, b[t].z, b[t].w);  // hi.lo
#pragma unroll
    for (int t = 0; t < 8; ++t) mma_tf32(acc[t], hi, b[t].x, b[t].y);  // hi.hi
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// grid (n_chunks, B), kThreads threads, kSmemBytes of dynamic shared
// memory. Block (s, b) takes pixels [s * chunk, min((s + 1) * chunk, N))
// of image b; chunk is a multiple of kRows.
__global__ void __launch_bounds__(kThreads, 1)
hist_bwd_kernel(const float* __restrict__ packed, const float* __restrict__ g,
                float* __restrict__ dpacked, int n_pixels, int chunk, float inv_sigma2) {
  extern __shared__ float4 smem[];  // per plane c: GA at c * kPlaneF4, GB after it
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;  // accumulator rows gid and gid + 8
  const int q = lane & 3;     // lane in the quad

  // Stage g's three planes, split into hi and lo, in both layouts. An item
  // is two rows 2ip, 2ip + 1 by four columns 4w .. 4w + 3 of one plane:
  // two float4 loads give 4 GA pairs and 4 GB pairs. All of a thread's
  // loads are issued before its first store.
  constexpr int kItems = 3 * (kBins / 2) * (kBins / 4);
  constexpr int kPerThread = kItems / kThreads;
  static_assert(kItems % kThreads == 0, "every thread stages the same number of items");
  const float* gb = g + (size_t)b * 3 * kPlane;
  float4 x0[kPerThread], x1[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int item = threadIdx.x + k * kThreads;
    const int c = item / (kItems / 3), r = item % (kItems / 3), ip = r >> 4, w = r & 15;
    const float4* src = reinterpret_cast<const float4*>(gb + c * kPlane + 2 * ip * kBins) + w;
    x0[k] = src[0];
    x1[k] = src[kBins / 4];
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int item = threadIdx.x + k * kThreads;
    const int c = item / (kItems / 3), r = item % (kItems / 3), ip = r >> 4, w = r & 15;
    float4* ga = smem + c * kPlaneF4 + 2 * ip * kStrideA + 2 * w;          // GA[2ip][2w]
    float4* gbt = smem + c * kPlaneF4 + kPlaneA + ip * kStrideB + 4 * w;   // GB[ip][4w]
    ga[0] = split_pair(x0[k].x, x0[k].y);
    ga[1] = split_pair(x0[k].z, x0[k].w);
    ga[kStrideA] = split_pair(x1[k].x, x1[k].y);
    ga[kStrideA + 1] = split_pair(x1[k].z, x1[k].w);
    gbt[0] = split_pair(x0[k].x, x1[k].x);
    gbt[1] = split_pair(x0[k].y, x1[k].y);
    gbt[2] = split_pair(x0[k].z, x1[k].z);
    gbt[3] = split_pair(x0[k].w, x1[k].w);
  }

  // The bin centres in pairs, cpair[4t + q] = (c[8t + 2q], c[8t + 2q + 1]):
  // the thread's bins of n-tile (or k-step) t. Centres as numpy computes
  // linspace: i * (6 / 63) - 3 in double, rounded to float.
  __shared__ float2 cpair[kBins / 2];
  if (threadIdx.x < kBins / 2) {
    float c[2];
    for (int e = 0; e < 2; ++e)
      c[e] = (float)__dadd_rn(__dmul_rn((double)(2 * threadIdx.x + e), __ddiv_rn(6.0, 63.0)),
                              -3.0);
    cpair[threadIdx.x] = make_float2(c[0], c[1]);
  }
  const float m2s = -2.0f * inv_sigma2;
  __syncthreads();

  const float* img = packed + (size_t)b * n_pixels * kPack;
  float* dimg = dpacked + (size_t)b * n_pixels * kPack;
  const int start = blockIdx.x * chunk;
  const int stop = min(start + chunk, n_pixels);
  // Per plane, with x the accumulator at (row p, bin m) and d = u - c_m:
  //   du  = -2 inv_sigma2 iy sum_m (x ku)(d ku)   over x = kvg = kv . g^T
  //   diy = sum_m x ku
  //   dv  = -2 inv_sigma2 iy sum_m (x kv)(d kv)   over x = ku . g
  // iy and -2 inv_sigma2 leave the sums, so that the A operands are kv and
  // ku themselves and each term is three or four instructions.
  for (int row0 = start + warp * kRows; row0 < stop; row0 += kWarps * kRows) {
    int rows[2];  // the thread's pixel rows gid and gid + 8; past the end: zeros
    bool live[2];
    float iy[2], diy[2] = {0.0f, 0.0f};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      rows[p] = row0 + gid + 8 * p;
      live[p] = rows[p] < stop;
      iy[p] = live[p] ? img[(size_t)rows[p] * kPack + 6] : 0.0f;
    }

#pragma unroll 1  // a rolled loop: one plane's code, a third of the unrolled size
    for (int c = 0; c < 3; ++c) {
      const float4* plane = smem + c * kPlaneF4;
      float us[2], vs[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float2 uv = live[p]
            ? *reinterpret_cast<const float2*>(img + (size_t)rows[p] * kPack + 2 * c)
            : make_float2(0.0f, 0.0f);
        us[p] = uv.x;
        vs[p] = uv.y;
      }
      // a holds kv, then ku: the A operand of each product in turn.
      float a[8][4];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const float2 cp = cpair[4 * s + q];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            a[s][2 * e + p] = bin_kernel(vs[p] - (e ? cp.y : cp.x), inv_sigma2);
          }
      }

      // kvg = kv . g^T: K = j, N = i; B[j][i] = g[i][j] from GA.
      float acc[8][4];
      product<8 * kStrideA, 4>(plane + gid * kStrideA + q, a, acc);
      float du[2] = {0.0f, 0.0f}, diy_c[2] = {0.0f, 0.0f};
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float2 cp = cpair[4 * t + q];
            const float d = us[p] - (e ? cp.y : cp.x);
            const float k = bin_kernel(d, inv_sigma2);
            const float xk = acc[t][2 * p + e] * k;
            diy_c[p] += xk;
            du[p] = fmaf(xk, d * k, du[p]);
            a[t][2 * e + p] = k;
          }

      // ku . g: K = i, N = j; B[i][j] = g[i][j] from GB.
      product<8, 4 * kStrideB>(plane + kPlaneA + q * kStrideB + gid, a, acc);
      float dv[2] = {0.0f, 0.0f};
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float2 cp = cpair[4 * t + q];
            const float d = vs[p] - (e ? cp.y : cp.x);
            const float k = bin_kernel(d, inv_sigma2);
            dv[p] = fmaf(acc[t][2 * p + e] * k, d * k, dv[p]);
          }

      // Sum over the quad; lane p of the quad stores row p's (du, dv).
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float scale = m2s * iy[p];
        const float du_p = scale * quad_sum(du[p]);
        const float dv_p = scale * quad_sum(dv[p]);
        diy[p] += quad_sum(diy_c[p]);
        if (q == p && live[p]) {
          *reinterpret_cast<float2*>(dimg + (size_t)rows[p] * kPack + 2 * c) =
              make_float2(du_p, dv_p);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (q == p && live[p]) {
        *reinterpret_cast<float2*>(dimg + (size_t)rows[p] * kPack + 6) =
            make_float2(diy[p], 0.0f);
      }
    }
  }
}

}  // namespace

extern "C" {

// packed (batch, n_pixels, 8) and g (batch, 3, 64, 64) fp32, contiguous;
// dpacked (batch, n_pixels, 8) fp32. Launches on `stream` and returns
// cudaGetLastError().
int histogram_bwd(const float* packed, const float* g, float* dpacked, int batch, int n_pixels,
                  float inv_sigma2, int device, void* stream) {
  if (batch < 1 || batch > 65535 || n_pixels < 1 || device < 0 || device >= kMaxDevices) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // Per device, once: the shared-memory opt-in and the SM count.
  static int sms[kMaxDevices];
  if (sms[device] == 0) {
    int count = 0;
    err = cudaFuncSetAttribute(hist_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return (int)err;
    sms[device] = count;
  }
  // One block per SM: split each image into sms / batch chunks of whole
  // 16-row steps, no chunk empty.
  const int steps = (n_pixels + kRows - 1) / kRows;
  int n_chunks = sms[device] / batch;
  n_chunks = n_chunks < 1 ? 1 : n_chunks > steps ? steps : n_chunks;
  const int chunk = (steps + n_chunks - 1) / n_chunks * kRows;
  n_chunks = (n_pixels + chunk - 1) / chunk;
  hist_bwd_kernel<<<dim3(n_chunks, batch), kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(packed, g, dpacked, n_pixels, chunk,
                                                          inv_sigma2);
  return (int)cudaGetLastError();
}

const char* histogram_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
