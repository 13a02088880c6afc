// Batched Goldilocks NTT tile kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of starkpack_winterfell_tpu/ops/pallas/
// ntt4.py (_make_body / _build_call): all log2(n) radix-2 stages of a
// length-n NTT along axis 1 of a contiguous (B, n, lanes) array of canonical
// u64 words, in one pass over the array, with an optional fused epilogue
// multiply by a static (n, lanes) table.
//
//   DIF: natural-order input, bit-reversed output
//   DIT: bit-reversed input, natural-order output
//   (the staged butterflies are gl64::tile_stages of gl64_stages.cuh).
//
// Bound on this card.  Bytes: the function reads the array once and writes
// it once (plus the epilogue table, read once per batch entry from L2), 16
// bytes per word against 3.35 TB/s.  Operations: log2(n)/2 butterflies per
// word, each one field multiply, one add and one subtract (28 + 10 + 8
// 32-bit integer instructions in the SASS, csrc/gl64_sass_count.py), against
// 132 SMs x 64 INT32 lanes x 1.98 GHz.  From n = 16 up the operations are
// the larger of the two, about four times the bytes at n = 4096, so a stage
// that touched device memory would add to a time the arithmetic already sets.
// So the design keeps every
// stage in shared memory: one thread block stages a (n, LG) tile — n rows of
// LG adjacent lanes, LG a power of two chosen by the wrapper so the tile is
// at most 128 KB — runs the stages with __syncthreads() between them, and
// writes back through the epilogue.  Adjacent lanes are adjacent in memory,
// so a tile row is one contiguous LG*8-byte segment and consecutive threads
// touch consecutive words both in global and in shared memory.
//
// This is not a carry-over of the TPU kernel's roll-and-select butterflies
// or its 128-lane blocks: those are shapes of the TPU's vector unit.

#include <cstdint>
#include <cuda_runtime.h>

#include "gl64_stages.cuh"

namespace {

template <bool DIF>
__global__ void ntt_tile_kernel(const uint64_t* __restrict__ x,
                                uint64_t* __restrict__ out,
                                const uint64_t* __restrict__ tw,
                                const uint64_t* __restrict__ ep,
                                int n, int log_n, int lanes, int log_lg,
                                int groups) {
  extern __shared__ uint64_t sm[];
  const int lg = 1 << log_lg;
  const int lmask = lg - 1;
  const int b = blockIdx.x / groups;
  const int lane0 = (blockIdx.x % groups) << log_lg;
  const int nl = min(lg, lanes - lane0);  // ragged last group
  const size_t base = (size_t)b * n * lanes + lane0;
  const int total = n << log_lg;

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int l = t & lmask;
    const int row = t >> log_lg;
    if (l < nl) sm[t] = x[base + (size_t)row * lanes + l];
  }
  __syncthreads();

  gl64::tile_stages<DIF>(sm, tw, n, log_n, log_lg);

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int l = t & lmask;
    const int row = t >> log_lg;
    if (l < nl) {
      uint64_t v = sm[t];
      if (ep != nullptr) v = gl64::mul(v, __ldg(ep + (size_t)row * lanes + lane0 + l));
      out[base + (size_t)row * lanes + l] = v;
    }
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  x/out: (B, n, lanes) u64,
// contiguous; tw: (n/2,) powers of the size-n root; ep: (n, lanes) or NULL.
// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// the cudaError_t of the attribute call or of the launch (0 = success).
extern "C" int ntt_tile_launch(const void* x, void* out, const void* tw,
                               const void* ep, int B, int n, int lanes,
                               int log_lg, int dif, int threads,
                               void* stream) {
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  if ((1 << log_n) != n || n < 2) return (int)cudaErrorInvalidValue;
  const int lg = 1 << log_lg;
  const int groups = (lanes + lg - 1) / lg;
  const size_t smem = (size_t)n * lg * sizeof(uint64_t);
  auto kern = dif ? ntt_tile_kernel<true> : ntt_tile_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (long long)B * groups;
  if (grid <= 0 || grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)out, (const uint64_t*)tw,
      (const uint64_t*)ep, n, log_n, lanes, log_lg, groups);
  return (int)cudaGetLastError();
}
