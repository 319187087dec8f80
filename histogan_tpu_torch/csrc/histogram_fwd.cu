// RGB-uv histogram forward: hist[b, c, i, j] = sum_n iy[n] * ku_c[n, i] * kv_c[n, j].
//
// Replaces histogan_tpu/ops/histogram_pallas.py::_fwd_kernel (the Pallas
// TPU kernel behind _hist_core). Input is the packed pixel array
// (B, N, 8) = [u0 v0 u1 v1 u2 v2 iy 0] that pack_pixels builds; output is
// the (B, 3, 64, 64) un-normalised histogram. The bin kernel is
// inverse-quadratic, ku = 1 / (1 + (u - c_i)^2 * inv_sigma2), against 64
// centres on [-3, 3] (np.linspace(-3, 3, 64) in float32).
//
// What bounds it on an H100: per pixel and plane one 64x64 outer product,
// 8192 FLOP, 24 576 a pixel over the three planes, against 32 bytes of
// packed pixel read once: bound by operations. The gate (1e-5 of
// max|plain|) rules out one-pass TF32 (about 1e-4), so the product runs on
// the tensor cores in split TF32, three TF32 products per fp32 product (see
// split_tf32), a third of the 495 TFLOP/s dense TF32 peak: 9.8 us at
// (16, 64^2). mma.sync m16n8k8 TF32 reaches about 63 % of that peak on the
// card, and an SMSP issues nothing else while it dispatches one, so every
// instruction beside the mma adds to the time: the design keeps those few.
//   * Per plane D[i][j] += sum_n A[i][n] B[n][j], A = iy ku (M = bin i),
//     B = kv (N = bin j), K = 8 pixels a k-step: mma.sync m16n8k8, 4 m-tiles
//     x 8 n-tiles, lo.hi + hi.lo + hi.hi for each. A warp owns the whole
//     64x64 plane: 128 fp32 accumulators a thread.
//   * The operands are made in registers, each (pixel, bin) once. In the
//     m16n8k8 fragments thread (gid, q) holds A at bins gid + 8k (k < 8)
//     for pixels q and q + 4 of the k-step, and B at the same bins for the
//     same pixels: per k-step it computes 8 ku and 8 kv for each of its two
//     pixels (32 reciprocals, 16 products by iy), and its 8 bin centres
//     live in registers for the kernel's life. 96 HMMA a k-step against
//     about 180 other instructions.
//   * One block per (image, plane, pixel chunk), 4 warps, two blocks per
//     SM (255 registers a thread at most, no spills). The block stages its
//     chunk's packed pixels 64 at a time (2 KB, 16 bytes a thread) into a
//     ring of kStages tiles in shared memory by cp.async, so that pixel
//     loads leave the HMMA stream; warp w takes pixels 16w .. 16w + 15 of
//     each tile, two k-steps.
//   * The tensor core's fp32 accumulation does not round to nearest, so no
//     accumulator runs longer than kGroup tiles (16 k-steps, 48 mma):
//     then it is added in fp32 into the thread's running sum in shared
//     memory and starts again from the next product (mma_tf32_first).
//   * No atomics. The block's 4 running sums are added in a fixed order,
//     warp w taking m-tile w, and the block writes its chunk's partial
//     plane; a second kernel sums the chunk partials in a fixed order, 16
//     bytes a thread. The split (ops/histogram_cuda.py, split_pixels) runs
//     all blocks in one wave, for a single image too. (A plane's chunks as
//     one thread-block cluster, summed through distributed shared memory
//     with no second kernel, were slower on the H100 at (16, 64^2) and
//     (16, 150^2), clusters of 5 blocks.)
//   * The ragged edge is masked: cp.async fills a pixel past the end with
//     zeros, so its iy, and with it its A, is 0 and it adds exactly 0 (the
//     TPU version padded to 512 pixels).
//   * ku and kv use the approximate reciprocal (rcp.approx, about 1 ulp;
//     its argument is >= 1), which runs beside the mma at no cost; fp32
//     elsewhere.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 64;
constexpr int kPack = 8;        // floats per packed pixel
constexpr int kWarps = 4;       // one per m-tile in the block's final sum
constexpr int kThreads = kWarps * 32;
constexpr int kStep = 8;        // pixels per k-step: the K of m16n8k8
constexpr int kWarpSteps = 2;   // k-steps per warp per tile
constexpr int kTile = kWarps * kWarpSteps * kStep;  // 64 pixels per tile
constexpr int kStages = 3;      // tiles in the cp.async ring
constexpr int kGroup = 8;       // tiles per accumulator run: 16 k-steps
constexpr int kPlane = kBins * kBins;
constexpr int kAccF4 = 32;                        // float4 accumulators a thread
constexpr int kSumsF4 = kWarps * kAccF4 * 32;     // running sums [warp][k][lane]
constexpr int kTileF4 = kTile * kPack / 4;        // one 16-byte copy per thread
constexpr int kSmemBytes = (kSumsF4 + kStages * kTileF4) * (int)sizeof(float4);  // 71 680
constexpr int kReduceThreads = 256;
constexpr int kReduceGroups = 8;
constexpr int kReduceWidth = kReduceThreads / kReduceGroups;  // float4 entries per block
constexpr int kMaxDevices = 64;
static_assert(kTileF4 == kThreads, "every thread copies 16 bytes of each tile");
static_assert(kWarps == 4, "warp w sums m-tile w of the block's plane");

// x = hi + lo for split TF32. The tensor core reads a TF32 operand as the
// top 19 bits of its register, so x itself serves as hi = x truncated to
// TF32 (10 mantissa bits), and lo = x - hi, exact, is truncated in turn:
// the split costs two instructions, and hi.hi + hi.lo + lo.hi misses a.b
// by under 3 * 2^-20 |a| |b| (the two truncated lo and the dropped lo.lo).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi & 0xffffe000u)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a.b, the first term of an accumulator run: it starts from zero
// without a move per register.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// 1 / (1 + d^2 inv_sigma2) with the approximate reciprocal (the argument
// is >= 1, so ftz changes nothing).
__device__ __forceinline__ float bin_kernel(float d, float inv_sigma2) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(fmaf(d * d, inv_sigma2, 1.0f)));
  return r;
}

// 16 bytes from global to shared memory, bypassing L1; the bytes past
// src_bytes (0 or 16) are filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// One k-step of plane c: the thread's pixels q and q + 4 are at px and
// px + 4 * kPack (shared memory); cen[k] is the centre of bin gid + 8k.
// acc[mt][nt] is the thread's fragment of the 16x8 tile (m-tile mt, n-tile
// nt): rows (bins) 16 mt + gid and + 8, columns 8 nt + 2q and + 1.
template <bool kFirst>
__device__ __forceinline__ void k_step(const float* __restrict__ px, int c,
                                       const float (&cen)[8], float inv_sigma2,
                                       float (&acc)[4][8][4]) {
  float u[2], v[2], iy[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float2 uv = *reinterpret_cast<const float2*>(px + p * 4 * kPack + 2 * c);
    u[p] = uv.x;
    v[p] = uv.y;
    iy[p] = px[p * 4 * kPack + 6];
  }
  // B = kv at bin 8 nt + gid: b0 of pixel q, b1 of pixel q + 4.
  uint32_t bh[8][2], bl[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      split_tf32(bin_kernel(v[p] - cen[nt], inv_sigma2), bh[nt][p], bl[nt][p]);
    }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    // A = iy ku: a[2p + e] at bin 16 mt + 8e + gid (centre 2 mt + e) and
    // pixel q + 4p, the order of the mma's a0 .. a3.
    uint32_t ah[4], al[4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        split_tf32(__fmul_rn(iy[p], bin_kernel(u[p] - cen[2 * mt + e], inv_sigma2)),
                   ah[2 * p + e], al[2 * p + e]);
      }
    // The three terms, each over the 8 independent accumulators in turn,
    // so that no mma waits on the one just issued.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {  // lo.hi
      if (kFirst) {
        mma_tf32_first(acc[mt][nt], al, bh[nt][0], bh[nt][1]);
      } else {
        mma_tf32(acc[mt][nt], al, bh[nt][0], bh[nt][1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_tf32(acc[mt][nt], ah, bl[nt][0], bl[nt][1]);  // hi.lo
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_tf32(acc[mt][nt], ah, bh[nt][0], bh[nt][1]);  // hi.hi
  }
}

// Writes the plane entries of float4 k of lane `lane` of the accumulator
// layout: rows 16 (k / 8) + gid and + 8, columns 8 (k % 8) + 2q and + 1.
__device__ __forceinline__ void store_entry(float* plane, int k, int lane, float4 x) {
  const int i = 16 * (k >> 3) + (lane >> 2);
  const int j = 8 * (k & 7) + 2 * (lane & 3);
  *reinterpret_cast<float2*>(plane + i * kBins + j) = make_float2(x.x, x.y);
  *reinterpret_cast<float2*>(plane + (i + 8) * kBins + j) = make_float2(x.z, x.w);
}

__device__ __forceinline__ void add4(float4& x, const float4 y) {
  x.x += y.x;
  x.y += y.y;
  x.z += y.z;
  x.w += y.w;
}

// grid (n_chunks, 3, B), kThreads threads, kSmemBytes of dynamic shared
// memory. Block (s, c, b) takes pixels [s * chunk, min((s + 1) * chunk, N))
// of image b, plane c (chunk a multiple of kTile), and writes its partial
// plane to dst[((b * 3 + c) * n_chunks + s) * 4096].
__global__ void __launch_bounds__(kThreads, 2)
hist_partial_kernel(const float* __restrict__ packed, float* __restrict__ dst, int n_pixels,
                    int chunk, int n_chunks, float inv_sigma2) {
  extern __shared__ float4 smem[];  // running sums, then the ring of pixel tiles
  const int s = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int q = lane & 3;
  float4* sums = smem + warp * kAccF4 * 32 + lane;  // the thread's k-th at sums[32 k]
  float* ring = reinterpret_cast<float*>(smem + kSumsF4);

  // The thread's bin centres, bins gid + 8k, as numpy computes linspace:
  // i * (6 / 63) - 3 in double, rounded to float.
  float cen[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    cen[k] = (float)__dadd_rn(__dmul_rn((double)(gid + 8 * k), __ddiv_rn(6.0, 63.0)), -3.0);

  const float* img = packed + (size_t)b * n_pixels * kPack;
  const int start = s * chunk;
  const int stop = min(start + chunk, n_pixels);
  const int n_tiles = (stop - start + kTile - 1) / kTile;

  // Tile t into ring slot t % kStages: the thread copies half h of pixel p.
  auto fetch = [&](int t) {
    if (t < n_tiles) {
      const int p = threadIdx.x >> 1;
      const int h = threadIdx.x & 1;
      const int n = start + t * kTile + p;
      const bool live = n < stop;
      cp_async16(ring + (t % kStages) * kTile * kPack + 4 * threadIdx.x,
                 img + (size_t)(live ? n : start) * kPack + 4 * h, live ? 16 : 0);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

#pragma unroll
  for (int k = 0; k < kAccF4; ++k) sums[32 * k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);

  float acc[4][8][4];
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed, for this thread's copy
    __syncthreads();               // ... for every thread's; slot (t - 1) is free
    fetch(t + kStages - 1);
    const float* px = ring + (t % kStages) * kTile * kPack
                    + (warp * kWarpSteps * kStep + q) * kPack;
    if (t % kGroup == 0) {
      k_step<true>(px, c, cen, inv_sigma2, acc);
    } else {
      k_step<false>(px, c, cen, inv_sigma2, acc);
    }
#pragma unroll
    for (int ks = 1; ks < kWarpSteps; ++ks)
      k_step<false>(px + ks * kStep * kPack, c, cen, inv_sigma2, acc);
    if ((t + 1) % kGroup == 0 || t + 1 == n_tiles) {  // end of a run: into the sum
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          float4 x = sums[32 * (8 * mt + nt)];
          add4(x, make_float4(acc[mt][nt][0], acc[mt][nt][1], acc[mt][nt][2], acc[mt][nt][3]));
          sums[32 * (8 * mt + nt)] = x;
        }
    }
  }
  __syncthreads();

  // Warp w adds m-tile w of the 4 warps' sums in order and writes it.
  float* plane = dst + (((size_t)b * 3 + c) * n_chunks + s) * kPlane;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int k = 8 * warp + nt;
    float4 x = smem[32 * k + lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) add4(x, smem[32 * (w * kAccF4 + k) + lane]);
    store_entry(plane, k, lane, x);
  }
}

// grid (B * 3, kPlane / 4 / kReduceWidth), kReduceThreads threads. out[plane,
// e] = sum over the chunk partials partial[plane, s, e] in a fixed order:
// the kReduceGroups groups of a block each add every kReduceGroups-th
// partial in order, four entries at a time, then the group sums are added
// in order.
__global__ void __launch_bounds__(kReduceThreads)
hist_reduce_kernel(const float4* __restrict__ partial, float4* __restrict__ out, int n_chunks) {
  __shared__ float4 part[kReduceThreads];
  const size_t plane = blockIdx.x;
  const int g = threadIdx.x / kReduceWidth;
  const int e = blockIdx.y * kReduceWidth + threadIdx.x % kReduceWidth;
  const float4* src = partial + plane * n_chunks * (kPlane / 4) + e;
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s = g; s < n_chunks; s += kReduceGroups) add4(sum, src[(size_t)s * (kPlane / 4)]);
  part[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x < kReduceWidth) {
    float4 total = part[threadIdx.x];
    for (int k = 1; k < kReduceGroups; ++k) add4(total, part[k * kReduceWidth + threadIdx.x]);
    out[plane * (kPlane / 4) + e] = total;
  }
}

}  // namespace

extern "C" {

// packed (batch, n_pixels, 8) fp32, contiguous, 16-byte aligned; out
// (batch, 3, 64, 64) fp32. partial (batch, 3, n_chunks, 64, 64) fp32
// scratch, unused (may equal out) when n_chunks == 1. Launches on `stream`
// and returns cudaGetLastError().
int histogram_fwd(const float* packed, float* partial, float* out, int batch, int n_pixels,
                  int chunk, int n_chunks, float inv_sigma2, int device, void* stream) {
  if (batch < 1 || batch > 65535 || n_pixels < 1 || chunk < 1 || chunk % kTile != 0 ||
      n_chunks < 1 || (long long)chunk * (n_chunks - 1) >= n_pixels ||
      (long long)chunk * n_chunks < n_pixels || device < 0 || device >= kMaxDevices) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static bool ready[kMaxDevices];  // per device, once: the shared-memory opt-in
  if (!ready[device]) {
    err = cudaFuncSetAttribute(hist_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    ready[device] = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = n_chunks == 1 ? out : partial;
  hist_partial_kernel<<<dim3(n_chunks, 3, batch), kThreads, kSmemBytes, st>>>(
      packed, dst, n_pixels, chunk, n_chunks, inv_sigma2);
  if (n_chunks > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    hist_reduce_kernel<<<dim3(batch * 3, kPlane / 4 / kReduceWidth), kReduceThreads, 0, st>>>(
        reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(out), n_chunks);
  }
  return (int)cudaGetLastError();
}

const char* histogram_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
