// Batched limb-field NTT tile kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of starkpack_winterfell_tpu/ops/pallas/
// limb_kernel.py (_make_kernel / _build_call): all log2(n) radix-2 DIT
// stages of a length-n NTT along axis 1 of contiguous (B, n, lanes) word
// planes of canonical field elements — bit-reversed rows in, natural rows
// out, no 1/n scale — in one pass over the array, with an optional fused
// pre-multiply of the input by a static (n, lanes) table.
//
//   DIT: (a, b) -> (a + b*w, a - b*w)        stages m = 2, 4, ..., n
//   with w = tw[j * n/m] = root^(j * n/m) for butterfly j of a size-m group.
//
// Bound on this card.  Bytes: the function reads the planes once and writes
// them once, 32 bytes per f128 element (16 per f62 element) against 3.35
// TB/s.  Operations: log2(n)/2 butterflies per element, each one field
// multiply (f128: seven 64 x 64 products and two carry chains), one add and
// one subtract, against 132 SMs x 64 INT32 lanes x 1.98 GHz (instruction
// counts: csrc/gl64_sass_count.py).
// The operations are the larger of the two from n = 4 up, so a stage that
// touched device memory would add to a time the arithmetic already sets.
// The design therefore keeps every stage in shared memory: one thread block
// stages a (n, LG) tile — n rows of LG adjacent lanes, LG a power of two
// chosen by the wrapper so the tile is at most 128 KB — as one plane per
// word, runs the stages with __syncthreads() between them and writes back.
// Adjacent lanes are adjacent in memory, so a tile row is one contiguous
// LG*8-byte segment per plane and consecutive threads touch consecutive
// words both in global and in shared memory.
//
// This is not a carry-over of the TPU kernel's roll-and-select butterflies,
// its (log n, n) per-position twiddle planes or its 128-lane blocks: those
// are shapes of the TPU's vector unit.  The kernel is a template over the
// field type; f128 (two word planes) and f62 (one) are built here.

#include <cstdint>
#include <cuda_runtime.h>

#include "f128.cuh"
#include "f62.cuh"

namespace {

template <class FE>
__global__ void __launch_bounds__(512)
limb_ntt_tile_kernel(const uint64_t* __restrict__ x_lo,
                     const uint64_t* __restrict__ x_hi,
                     uint64_t* __restrict__ o_lo, uint64_t* __restrict__ o_hi,
                     const uint64_t* __restrict__ tw_lo,
                     const uint64_t* __restrict__ tw_hi,
                     const uint64_t* __restrict__ pre_lo,
                     const uint64_t* __restrict__ pre_hi,
                     int n, int log_n, int lanes, int log_lg, int groups) {
  extern __shared__ uint64_t sm[];
  const int lg = 1 << log_lg;
  const int lmask = lg - 1;
  const int total = n << log_lg;
  uint64_t* s_lo = sm;
  uint64_t* s_hi = sm + total;  // unused by a one-word field
  const int b = blockIdx.x / groups;
  const int lane0 = (blockIdx.x % groups) << log_lg;
  const int nl = min(lg, lanes - lane0);  // ragged last group
  const size_t base = (size_t)b * n * lanes + lane0;

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int l = t & lmask;
    const int row = t >> log_lg;
    if (l < nl) {
      FE v = FE::load(x_lo, x_hi, base + (size_t)row * lanes + l);
      if (pre_lo != nullptr)
        v = fe_mul(v, FE::load(pre_lo, pre_hi, (size_t)row * lanes + lane0 + l));
      FE::store(s_lo, s_hi, t, v);
    }
  }
  __syncthreads();

  const int nb = total >> 1;  // butterflies per stage
  for (int s = 1; s <= log_n; ++s) {  // group size m = 2^s
    const int half = 1 << (s - 1);
    const int stride = n >> s;  // twiddle index multiplier n/m
    for (int t = threadIdx.x; t < nb; t += blockDim.x) {
      const int l = t & lmask;
      const int k = t >> log_lg;
      const int j = k & (half - 1);
      const int i0 = ((k >> (s - 1)) << s) + j;
      const int p0 = (i0 << log_lg) + l;
      const int p1 = p0 + (half << log_lg);
      const FE w = FE::load(tw_lo, tw_hi, (size_t)j * stride);
      const FE a = FE::load(s_lo, s_hi, p0);
      const FE tm = fe_mul(FE::load(s_lo, s_hi, p1), w);
      FE::store(s_lo, s_hi, p0, fe_add(a, tm));
      FE::store(s_lo, s_hi, p1, fe_sub(a, tm));
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int l = t & lmask;
    const int row = t >> log_lg;
    if (l < nl)
      FE::store(o_lo, o_hi, base + (size_t)row * lanes + l,
                FE::load(s_lo, s_hi, t));
  }
}

// most dynamic shared memory a launch asks for: a 16384-word tile (the
// wrapper's TILE_WORDS)
constexpr int MAX_SMEM_BYTES = 16384 * 8;

template <class FE>
int limb_ntt_tile_launch(const void* x_lo, const void* x_hi, void* o_lo,
                         void* o_hi, const void* tw_lo, const void* tw_hi,
                         const void* pre_lo, const void* pre_hi, int B, int n,
                         int lanes, int log_lg, int threads, void* stream) {
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  if ((1 << log_n) != n || n < 2 || threads < 1 || threads > 512)
    return (int)cudaErrorInvalidValue;
  const int lg = 1 << log_lg;
  const int groups = (lanes + lg - 1) / lg;
  const size_t smem = (size_t)n * lg * FE::WORDS * sizeof(uint64_t);
  if (smem > (size_t)MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  auto kern = limb_ntt_tile_kernel<FE>;
  const long long grid = (long long)B * groups;
  if (grid <= 0 || grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)x_lo, (const uint64_t*)x_hi, (uint64_t*)o_lo,
      (uint64_t*)o_hi, (const uint64_t*)tw_lo, (const uint64_t*)tw_hi,
      (const uint64_t*)pre_lo, (const uint64_t*)pre_hi, n, log_n, lanes, log_lg,
      groups);
  return (int)cudaGetLastError();
}

}  // namespace

// Raises both instantiations' dynamic shared-memory limit to the most a
// launch asks for; called once when the library is loaded, so no launch pays
// for the attribute call.  Returns the first cudaError_t (0 = success).
extern "C" int limb_ntt_tile_init() {
  cudaError_t e = cudaFuncSetAttribute(limb_ntt_tile_kernel<F128>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       MAX_SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(limb_ntt_tile_kernel<F62>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM_BYTES);
  return (int)e;
}

// Plain C interface (loaded with ctypes), one entry per field.  x/out:
// (B, n, lanes) u64 planes, contiguous (the high planes NULL for f62); tw:
// (n/2,) powers of the size-n root; pre: (n, lanes) or NULL.  Launches on
// `stream`, does not synchronise, allocates nothing.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int limb_ntt_tile_f128_launch(
    const void* x_lo, const void* x_hi, void* o_lo, void* o_hi,
    const void* tw_lo, const void* tw_hi, const void* pre_lo,
    const void* pre_hi, int B, int n, int lanes, int log_lg, int threads,
    void* stream) {
  return limb_ntt_tile_launch<F128>(x_lo, x_hi, o_lo, o_hi, tw_lo, tw_hi, pre_lo,
                                    pre_hi, B, n, lanes, log_lg, threads, stream);
}

extern "C" int limb_ntt_tile_f62_launch(
    const void* x_lo, const void* x_hi, void* o_lo, void* o_hi,
    const void* tw_lo, const void* tw_hi, const void* pre_lo,
    const void* pre_hi, int B, int n, int lanes, int log_lg, int threads,
    void* stream) {
  return limb_ntt_tile_launch<F62>(x_lo, x_hi, o_lo, o_hi, tw_lo, tw_hi, pre_lo,
                                   pre_hi, B, n, lanes, log_lg, threads, stream);
}
