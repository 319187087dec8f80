"""What bounds the histogram kernels (K1 forward, K2 backward) on the card.

    python -m histogan_tpu_torch.tools.mma_ceiling

Needs a CUDA card and nvcc. Both kernels run their products as mma.sync
m16n8k8 TF32 (HMMA.1688 in SASS), 24 of them at a time over 8
independent accumulators (the three split terms in turn), between their
elementwise work. This measures, on one block of 4, 8 or 12 warps per
SM, the rate of that instruction alone and beside the other
instructions the kernels issue: one LDS.128 per three HMMA, one or three
FFMA per HMMA, one MUFU.RCP per three HMMA. It prints TFLOP/s (TF32,
2048 FLOP an HMMA) and the time per HMMA on one SMSP, in ns and in
cycles at the card's maximum SM clock. Then it counts by opcode
(cuobjdump -sass) the instructions of each kernel's hot loop, the loop
with the most HMMA: K2's per-plane loop and K1's per-tile loop (two
k-steps of 96 HMMA each, and a third copy of the k-step that starts an
accumulator run), the instructions that their time is made of. Last it
runs K1 back to back for about a second at two shapes, reads the SM
clock (nvidia-smi) meanwhile, and prints the cycles one SMSP spends per
k-step: the call's time (CUDA events, K1's two kernels and the host
work between calls) over the k-steps of the SMSP with the most.
"""

from __future__ import annotations

import collections
import ctypes
import re
import subprocess
from pathlib import Path

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %4, %5}, {%6, %7}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(b1));
}

// kExtra: 0 HMMA alone, 1 + one LDS.128 per three HMMA, 2 + one FFMA per
// HMMA, 3 + three FFMA per HMMA, 4 + one MUFU.RCP per three HMMA.
template <int kExtra>
__global__ void probe(float* out, int iters) {
  extern __shared__ float4 sm[];  // 8192 float4
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) sm[i] = make_float4(i, 1.0f, 2.0f, 3.0f);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t a0 = threadIdx.x, a1 = 3u * threadIdx.x;
  float acc[8][4] = {};
  float f[8];
  for (int i = 0; i < 8; ++i) f[i] = 0.001f * threadIdx.x + i;
  for (int it = 0; it < iters; ++it) {
    if (kExtra == 2 || kExtra == 3) {
#pragma unroll
      for (int r = 0; r < (kExtra == 2 ? 3 : 9); ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = fmaf(f[i], 0.999f, 0.5f);
    }
    if (kExtra == 4) {
#pragma unroll
      for (int i = 0; i < 8; ++i) asm volatile("rcp.approx.ftz.f32 %0, %0;" : "+f"(f[i]));
    }
    float4 b[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {  // conflict-free: lanes read consecutive float4
      b[t] = kExtra == 1 ? sm[(lane + 32 * t + 256 * (it & 7)) & 8191]
                         : make_float4(__uint_as_float(5u * threadIdx.x + t), 1.0f, 2.0f, 3.0f);
    }
    uint32_t hi[8][2], lo[8][2];  // the B pairs as K2 reads them: hi x0, hi x1, lo x0, lo x1
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      hi[t][0] = __float_as_uint(b[t].x);
      hi[t][1] = __float_as_uint(b[t].y);
      lo[t][0] = __float_as_uint(b[t].z);
      lo[t][1] = __float_as_uint(b[t].w);
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) mma(acc[t], a0, a1, hi[t][0], hi[t][1]);
#pragma unroll
    for (int t = 0; t < 8; ++t) mma(acc[t], a0, a1, lo[t][0], lo[t][1]);
#pragma unroll
    for (int t = 0; t < 8; ++t) mma(acc[t], a0, a1, hi[t][0], hi[t][1]);
  }
  float s = 0.0f;
  for (int i = 0; i < 8; ++i) s += f[i];
  for (int t = 0; t < 8; ++t)
    for (int e = 0; e < 4; ++e) s += acc[t][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int kExtra>
static cudaError_t launch(float* out, int blocks, int threads, int iters) {
  const int smem = 8192 * (int)sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(probe<kExtra>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  probe<kExtra><<<blocks, threads, smem>>>(out, iters);
  return cudaGetLastError();
}

// Milliseconds of the second of two runs, or -1 on an error.
extern "C" float mma_ceiling(int extra, int blocks, int threads, int iters) {
  float* out = nullptr;
  if (cudaMalloc(&out, (size_t)blocks * threads * sizeof(float)) != cudaSuccess) return -1.0f;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = -1.0f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    cudaError_t err = extra == 0 ? launch<0>(out, blocks, threads, iters)
                    : extra == 1 ? launch<1>(out, blocks, threads, iters)
                    : extra == 2 ? launch<2>(out, blocks, threads, iters)
                    : extra == 3 ? launch<3>(out, blocks, threads, iters)
                                 : launch<4>(out, blocks, threads, iters);
    cudaEventRecord(e1);
    if (err != cudaSuccess || cudaEventSynchronize(e1) != cudaSuccess) {
      ms = -1.0f;
      break;
    }
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  return ms;
}
"""

EXTRAS = ("HMMA alone", "+1 LDS.128 per 3 HMMA", "+1 FFMA per HMMA", "+3 FFMA per HMMA",
          "+1 MUFU.RCP per 3 HMMA")
HMMA_PER_ITER = 24
FLOP_PER_HMMA = 2 * 16 * 8 * 8


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _build():
    from histogan_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / "mma_ceiling.cu"
    lib = cuda_build.BUILD_DIR / "libmma_ceiling.so"
    src.write_text(SOURCE)
    subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).mma_ceiling
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_float
    return fn


def plane_loop_opcodes(sass: str) -> collections.Counter:
    """Opcodes of the loop (a backward branch) with the most HMMA in
    ``sass`` (cuobjdump -sass text). Addresses start again at 0 in each
    function, so each function's loops are taken in that function."""
    functions = [[]]
    for line in sass.splitlines():
        if "Function :" in line:
            functions.append([])
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if m:
            functions[-1].append((int(m.group(1), 16), m.group(2).split(".")[0], m.group(3)))
    best = collections.Counter()
    for ins in functions:
        for addr, op, rest in ins:
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            start = int(target.group(1), 16) if target else addr
            if start < addr:
                body = collections.Counter(o for a, o, _ in ins if start <= a <= addr)
                if body["HMMA"] > best["HMMA"]:
                    best = body
    return best


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mma_ceiling needs a CUDA card")
    from histogan_tpu_torch.ops import cuda_build, histogram_cuda

    print(_smi("name,power.limit"))
    max_mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fn = _build()
    iters = 4000
    for extra, what in enumerate(EXTRAS):
        for warps in (4, 8, 12):
            ms = fn(extra, sms, 32 * warps, iters)
            if ms <= 0:
                raise RuntimeError(f"mma_ceiling launch failed ({what}, {warps} warps)")
            hmma = sms * warps * iters * HMMA_PER_ITER
            ns = 1e6 * ms / (hmma / (4 * sms))  # per HMMA on one SMSP
            print(f"mma_ceiling: {what:24s} {warps:2d} warps/SM: {ms:.4f} ms, "
                  f"{hmma * FLOP_PER_HMMA / ms / 1e9:.1f} TFLOP/s, {ns:.3f} ns = "
                  f"{ns * max_mhz / 1e3:.2f} cycles at {max_mhz:.0f} MHz per HMMA per SMSP")
    libs = cuda_build.build(("histogram_fwd", "histogram_bwd"))
    cuobjdump = Path(cuda_build.nvcc()).with_name("cuobjdump")
    for name, loop in (("histogram_bwd", "K2's plane loop"), ("histogram_fwd", "K1's tile loop")):
        sass = subprocess.run([str(cuobjdump), "-sass", str(libs[name])], capture_output=True,
                              text=True, check=True).stdout
        ops = plane_loop_opcodes(sass)
        print(f"mma_ceiling: {loop}: {sum(ops.values())} instructions, "
              + ", ".join(f"{op} {n}" for op, n in ops.most_common()))
    for b, n in ((16, 64 * 64), (8, 250 * 250)):
        k1_cycles(histogram_cuda, b, n, sms)
    return 0


def k1_cycles(histogram_cuda, b: int, n: int, sms: int) -> None:
    """K1's C entry point back to back at (b, n) for about a second, on
    buffers allocated once (so that the host keeps ahead of the card): ms
    per call (CUDA events), the SM clock that nvidia-smi samples every
    100 ms meanwhile, and the cycles per k-step on the SMSP with the most
    k-steps (one warp of each of its SM's resident blocks)."""
    import torch

    x = torch.rand((b, n, 3), device="cuda", generator=torch.Generator("cuda").manual_seed(n))
    packed = histogram_cuda.pack_pixels(x).contiguous()
    chunk, n_chunks = histogram_cuda.split_pixels(b, n, sms)
    tiles = -(-chunk // histogram_cuda.TILE)
    rounds = -(-3 * b * n_chunks // (histogram_cuda.BLOCKS_PER_SM * sms))
    ksteps = rounds * histogram_cuda.BLOCKS_PER_SM * 2 * tiles  # 2 k-steps a warp a tile
    out = torch.empty((b, 3, 64, 64), device="cuda")
    partial = torch.empty((b, 3, n_chunks, 64, 64), device="cuda") if n_chunks > 1 else out
    lib = histogram_cuda._library("histogram_fwd")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.histogram_fwd(packed.data_ptr(), partial.data_ptr(), out.data_ptr(), b, n,
                                chunk, n_chunks, 2500.0, 0, stream)
        if err:
            raise RuntimeError(f"histogram_fwd launch failed: CUDA error {err}")

    call()
    torch.cuda.synchronize()
    reps = max(100, int(1.0 / (b * n * 73728 / 1.5e14)))  # ~1 s at 150 TFLOP/s of split TF32
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
    finally:
        smi.terminate()
        samples, _ = smi.communicate()
    mhz = sorted(float(v) for v in samples.split())
    ms = start.elapsed_time(end) / reps
    mid = mhz[len(mhz) // 2]
    print(f"mma_ceiling: K1 at B={b} N={n}: {ms:.4f} ms a call over {reps} calls; SM clock "
          f"{mhz[0]:.0f}/{mid:.0f}/{mhz[-1]:.0f} MHz (min/median/max of {len(mhz)} samples); "
          f"{ksteps} k-steps on the busiest SMSP ({n_chunks} chunks of {tiles} tiles): "
          f"{ms * mid * 1e3 / ksteps:.0f} cycles a k-step at the median clock")


if __name__ == "__main__":
    raise SystemExit(main())
