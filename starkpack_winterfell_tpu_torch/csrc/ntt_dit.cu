// Decimation-in-time Goldilocks NTT kernels for Hopper (sm_90a): the small
// transforms of the prover (trace lengths up to 4096 in one call, longer ones
// as the two halves of a four-step transform).
//
// Replaces the two Pallas TPU kernels of starkpack_winterfell_tpu/ops/pallas/
// ntt_kernel.py:
//
//   ntt_dit_axis0  <- _make_kernel / _build_call: all log2(n) DIT stages
//       along axis 0 of a contiguous (n, lanes) array of canonical u64 words;
//   ntt_dit_axis1  <- _make_kernel3 / _build_call3: the same stages along
//       axis 1 of a contiguous (B, n, lanes) array, with an optional
//       elementwise multiply of every (n, lanes) slab by a static (n, lanes)
//       table BEFORE the stages (template flag PRE; the four-step inner
//       twiddle, row-permuted and 1/n-scaled where the table is made).
//
// Both take rows in bit-reversed order and return natural order, with
// w = tw[j * n/m] for butterfly j of a size-m group (gl64_stages.cuh).
//
// Bound on this card.  Bytes: the array read once and written once (plus the
// PRE table, read once per batch entry, from L2 after the first), 16 bytes
// per word against 3.35 TB/s.  Operations: log2(n)/2 butterflies per word at
// 46 32-bit integer instructions each (csrc/gl64_sass_count.py), 28 more per
// word with PRE, against 132 SMs x 64 INT32 lanes x 1.98 GHz.  From n = 16 up
// the operations are the larger bound, so the design keeps every stage out of
// device memory: a block stages an (n, LG) tile in dynamic shared memory,
// runs the stages with __syncthreads() between them and writes the tile
// back.  LG (a power of two, chosen by the wrapper) trades the row segment a
// warp reads (LG*8 contiguous bytes) against the tile's size: about 32 KB a
// tile where n allows it, so that several blocks share an SM and one block's
// barriers overlap another's arithmetic, and at least 4 lanes (one 32-byte
// sector) up to the 128 KB tile of n = 4096.  The ragged last lane group is
// masked, never padded.
//
// Not carried over from the TPU kernels: the (log n, n) per-position twiddle
// planes, the roll-and-select butterflies and the 128-lane blocks, which are
// shapes of the TPU's vector unit.

#include <cstdint>
#include <cuda_runtime.h>

#include "gl64_stages.cuh"

namespace {

// One (n, LG) tile whose first word is x[base]: rows `lanes` words apart,
// lanes lane0 .. lane0 + nl - 1 of every row.
template <bool PRE>
__device__ __forceinline__ void dit_tile(uint64_t* sm,
                                         const uint64_t* __restrict__ x,
                                         uint64_t* __restrict__ out,
                                         const uint64_t* __restrict__ tw,
                                         const uint64_t* __restrict__ pre,
                                         size_t base, int lane0, int n,
                                         int log_n, int lanes, int log_lg) {
  const int lg = 1 << log_lg;
  const int lmask = lg - 1;
  const int nl = min(lg, lanes - lane0);  // ragged last group
  const int total = n << log_lg;

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int l = t & lmask;
    const int row = t >> log_lg;
    if (l < nl) {
      uint64_t v = x[base + (size_t)row * lanes + l];
      if (PRE) v = gl64::mul(v, __ldg(pre + (size_t)row * lanes + lane0 + l));
      sm[t] = v;
    }
  }
  __syncthreads();

  gl64::tile_stages<false>(sm, tw, n, log_n, log_lg);

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int l = t & lmask;
    const int row = t >> log_lg;
    if (l < nl) out[base + (size_t)row * lanes + l] = sm[t];
  }
}

// (n, lanes): one block per group of LG lanes.
__global__ void ntt_dit_axis0_kernel(const uint64_t* __restrict__ x,
                                     uint64_t* __restrict__ out,
                                     const uint64_t* __restrict__ tw,
                                     int n, int log_n, int lanes, int log_lg) {
  extern __shared__ uint64_t sm[];
  const int lane0 = blockIdx.x << log_lg;
  dit_tile<false>(sm, x, out, tw, nullptr, (size_t)lane0, lane0, n, log_n,
                  lanes, log_lg);
}

// (B, n, lanes): one block per batch entry and group of LG lanes.
template <bool PRE>
__global__ void ntt_dit_axis1_kernel(const uint64_t* __restrict__ x,
                                     uint64_t* __restrict__ out,
                                     const uint64_t* __restrict__ tw,
                                     const uint64_t* __restrict__ pre,
                                     int n, int log_n, int lanes, int log_lg,
                                     int groups) {
  extern __shared__ uint64_t sm[];
  const int b = blockIdx.x / groups;
  const int lane0 = (blockIdx.x % groups) << log_lg;
  dit_tile<PRE>(sm, x, out, tw, pre, (size_t)b * n * lanes + lane0, lane0, n,
                log_n, lanes, log_lg);
}

int log2_exact(int n) {
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  return ((1 << log_n) == n && n >= 2) ? log_n : -1;
}

}  // namespace

// Plain C interfaces (loaded with ctypes).  Arrays are contiguous u64; tw is
// the (n/2,) table of powers of the size-n root.  Both launch on `stream`, do
// not synchronise and allocate nothing, and return the cudaError_t of the
// attribute call or of the launch (0 = success).

// x/out: (n, lanes).
extern "C" int ntt_dit_axis0_launch(const void* x, void* out, const void* tw,
                                    int n, int lanes, int log_lg, int threads,
                                    void* stream) {
  const int log_n = log2_exact(n);
  if (log_n < 0 || lanes <= 0) return (int)cudaErrorInvalidValue;
  const int lg = 1 << log_lg;
  const int groups = (lanes + lg - 1) / lg;
  const size_t smem = (size_t)n * lg * sizeof(uint64_t);
  cudaError_t e = cudaFuncSetAttribute(
      ntt_dit_axis0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ntt_dit_axis0_kernel<<<(unsigned)groups, threads, smem,
                         (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)out, (const uint64_t*)tw, n, log_n, lanes,
      log_lg);
  return (int)cudaGetLastError();
}

// x/out: (B, n, lanes); pre: (n, lanes) or NULL.
extern "C" int ntt_dit_axis1_launch(const void* x, void* out, const void* tw,
                                    const void* pre, int B, int n, int lanes,
                                    int log_lg, int threads, void* stream) {
  const int log_n = log2_exact(n);
  if (log_n < 0 || lanes <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const int lg = 1 << log_lg;
  const int groups = (lanes + lg - 1) / lg;
  const size_t smem = (size_t)n * lg * sizeof(uint64_t);
  auto kern = pre != nullptr ? ntt_dit_axis1_kernel<true>
                             : ntt_dit_axis1_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (long long)B * groups;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)out, (const uint64_t*)tw,
      (const uint64_t*)pre, n, log_n, lanes, log_lg, groups);
  return (int)cudaGetLastError();
}
