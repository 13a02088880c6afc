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
//
// and three options that fold the four-step pipeline's layout moves
// (ops/ntt4.py) into the same pass:
//   * transposed store: the output is written (B, lanes, n);
//   * zero-interleaved input (DIT only): x is (B, n/f, lanes) and stands for
//     the (B, n, lanes) array holding x's row r at row r*f and zeros in the
//     f-1 rows after it.  The first log2(f) DIT stages of such an array only
//     copy each row into the f-1 rows after it ((a, 0) -> (a, a)), so the
//     kernel fills all f rows with x's row and starts at stage log2(f) + 1;
//   * pre-multiply: x's rows times a static (rows of x, lanes) table before
//     the stages.
//
// Bound on this card.  Bytes: the rows of x read once, the output written
// once, 8 bytes a word against 3.35 TB/s.  Operations: (log2 n - log2 f)
// stages of n/2 butterflies per lane, 28 + 10 + 8 32-bit integer
// instructions each in the SASS (csrc/gl64_sass_count.py), plus 28 per word
// and table, against 132 SMs x 64 INT32 lanes x 1.98 GHz.  From n = 16 up
// the operations are the larger bound, about four times the bytes at
// n = 4096, so the design spends as few instructions as it can beside the
// field arithmetic and keeps the integer units busy while words move:
//   * a block owns an (n, LG) tile (LG adjacent lanes, a power of two the
//     wrapper picks); each thread holds R = 2^K words of one lane in
//     registers and runs K stages there (gl64_radix.cuh), so the tile goes
//     through shared memory once every K stages: at n = 4096 and K = 4 the
//     first pass reads device memory, two exchanges follow, and the last
//     pass writes device memory (or the tile, for a transposed store, which
//     then leaves it row by row);
//   * the (n/2,) root-power table is copied into shared memory once per
//     block: no butterfly reads device memory for its twiddle;
//   * the tile is 32 KB where n allows (the wrapper's choice; 64 KB at
//     n = 4096 when the block writes rows of two lanes straight to device
//     memory), so two or more blocks share an SM and one block's loads,
//     barriers and stores overlap another's butterflies; K is 3 where that
//     lets more blocks share an SM and 4 where shared memory allows only two;
//   * tile positions are swizzled (gl64::swz) so the strided accesses of a
//     pass and the row-major read of the transposed store spread over the
//     shared-memory banks.
//
// This is not a carry-over of the TPU kernel's roll-and-select butterflies
// or its 128-lane blocks: those are shapes of the TPU's vector unit.

#include <cstdint>
#include <cuda_runtime.h>

#include "gl64_radix.cuh"

namespace {

constexpr int MAX_THREADS = 256;
// a ceiling on the dynamic shared memory of a launch, above what the
// wrapper's tiles ask for: the (n/2,) twiddles of n = 4096, a 16384-word tile
// and its half-size staging rows
constexpr int MAX_SMEM_BYTES = (2048 + 16384 + 8192) * 8;

struct TileArgs {
  const uint64_t* x;
  uint64_t* out;
  const uint64_t* tw;
  const uint64_t* ep;   // (n, lanes) or null
  const uint64_t* pre;  // (n >> log_f, lanes) or null
  int n, log_n, lanes, log_lg, groups, log_f, transposed;
};

// One pass of KP stages on bits s0 .. s0+KP-1 over the block's tile; the
// first pass reads x (or the staged rows), the last writes out (or the tile).
template <bool DIF, int KP>
__device__ __forceinline__ void tile_pass(const TileArgs& a,
                                          const uint64_t* tws, uint64_t* tile,
                                          const uint64_t* stage, int b,
                                          int lane0, int nl, int s0,
                                          bool first, bool last) {
  constexpr int R = 1 << KP;
  const int lmask = (1 << a.log_lg) - 1;
  const int tasks = (a.n >> KP) << a.log_lg;
  const size_t xbase = (size_t)b * (a.n >> a.log_f) * a.lanes + lane0;
  const size_t obase = (size_t)b * a.n * a.lanes + lane0;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int l = t & lmask;
    const int q = t >> a.log_lg;
    const int low = q & ((1 << s0) - 1);
    const int p0 = low | ((q >> s0) << (s0 + KP));
    const bool live = l < nl;
    uint64_t v[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int p = p0 | (i << s0);
      if (!first) {
        v[i] = tile[(gl64::swz(p) << a.log_lg) | l];
      } else if (a.log_f > 0) {
        v[i] = stage[((p >> a.log_f) << a.log_lg) | l];
      } else {
        uint64_t w = 0;
        if (live) {
          w = a.x[xbase + (size_t)p * a.lanes + l];
          if (a.pre != nullptr)
            w = gl64::mul(w, __ldg(a.pre + (size_t)p * a.lanes + lane0 + l));
        }
        v[i] = w;
      }
    }
    gl64::radix_pass<DIF, KP>(v, tws, a.log_n, s0, low);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int p = p0 | (i << s0);
      uint64_t w = v[i];
      if (last && a.ep != nullptr && live)
        w = gl64::mul(w, __ldg(a.ep + (size_t)p * a.lanes + lane0 + l));
      if (last && !a.transposed) {
        if (live) a.out[obase + (size_t)p * a.lanes + l] = w;
      } else {
        tile[(gl64::swz(p) << a.log_lg) | l] = w;
      }
    }
  }
  __syncthreads();
}

template <bool DIF, int K>
__global__ void __launch_bounds__(MAX_THREADS)
    ntt_tile_kernel(const TileArgs a) {
  extern __shared__ uint64_t smem[];
  const int half_n = a.n >> 1;
  uint64_t* tws = smem;
  uint64_t* tile = smem + half_n;
  uint64_t* stage = tile + (a.n << a.log_lg);
  const int lmask = (1 << a.log_lg) - 1;
  const int b = blockIdx.x / a.groups;
  const int lane0 = (blockIdx.x % a.groups) << a.log_lg;
  const int nl = min(1 << a.log_lg, a.lanes - lane0);

  for (int t = threadIdx.x; t < half_n; t += blockDim.x) tws[t] = __ldg(a.tw + t);
  if (a.log_f > 0) {
    // the rows of x, pre-multiplied once each, for the f positions they fill
    const int rows_in = a.n >> a.log_f;
    const size_t xbase = (size_t)b * rows_in * a.lanes + lane0;
    for (int t = threadIdx.x; t < (rows_in << a.log_lg); t += blockDim.x) {
      const int l = t & lmask;
      const int r = t >> a.log_lg;
      uint64_t w = 0;
      if (l < nl) {
        w = a.x[xbase + (size_t)r * a.lanes + l];
        if (a.pre != nullptr)
          w = gl64::mul(w, __ldg(a.pre + (size_t)r * a.lanes + lane0 + l));
      }
      stage[t] = w;
    }
  }
  __syncthreads();

  const int nbits = a.log_n - a.log_f;
  const int passes = (nbits + K - 1) / K;
  int done = 0;
  for (int ps = 0; ps < passes; ++ps) {
    const int k = ps == 0 ? nbits - (passes - 1) * K : K;
    const int s0 = DIF ? a.log_n - done - k : a.log_f + done;
    const bool first = ps == 0, last = ps == passes - 1;
    switch (k) {
      case 1: tile_pass<DIF, 1>(a, tws, tile, stage, b, lane0, nl, s0, first, last); break;
      case 2: tile_pass<DIF, 2>(a, tws, tile, stage, b, lane0, nl, s0, first, last); break;
      case 3: tile_pass<DIF, 3>(a, tws, tile, stage, b, lane0, nl, s0, first, last); break;
      default:
        if constexpr (K >= 4)
          tile_pass<DIF, 4>(a, tws, tile, stage, b, lane0, nl, s0, first, last);
        break;
    }
    done += k;
  }

  if (a.transposed) {
    // (B, lanes, n): consecutive threads write consecutive rows of one lane
    const int total = a.n << a.log_lg;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int row = t & (a.n - 1);
      const int l = t >> a.log_n;
      if (l < nl)
        a.out[((size_t)b * a.lanes + lane0 + l) * a.n + row] =
            tile[(gl64::swz(row) << a.log_lg) | l];
    }
  }
}

template <bool DIF, int K>
cudaError_t set_smem_limit() {
  return cudaFuncSetAttribute(ntt_tile_kernel<DIF, K>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              MAX_SMEM_BYTES);
}

}  // namespace

// Plain C interface (loaded with ctypes).

// Raises every instantiation's dynamic shared-memory limit to the most any
// launch asks for; called once when the library is loaded, so no launch pays
// for the attribute call.  Returns the first cudaError_t (0 = success).
extern "C" int ntt_tile_init() {
  cudaError_t e = cudaSuccess;
  const cudaError_t r[] = {set_smem_limit<true, 3>(), set_smem_limit<true, 4>(),
                           set_smem_limit<false, 3>(), set_smem_limit<false, 4>()};
  for (cudaError_t x : r)
    if (e == cudaSuccess) e = x;
  return (int)e;
}

// x: (B, n >> log_f, lanes); out: (B, n, lanes), or (B, lanes, n) when
// `transposed`; tw: (n/2,) powers of the size-n root; ep: (n, lanes) or NULL;
// pre: (n >> log_f, lanes) or NULL; log_f > 0 (zero-interleaved input) only
// for the DIT; radix_log: K, 3 or 4.  All contiguous.  Launches on `stream`,
// does not synchronise, allocates nothing.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int ntt_tile_launch(const void* x, void* out, const void* tw,
                               const void* ep, const void* pre, int B, int n,
                               int lanes, int log_lg, int dif, int log_f,
                               int transposed, int radix_log, int threads,
                               void* stream) {
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  if ((1 << log_n) != n || n < 2 || log_f < 0 || log_f >= log_n ||
      (dif && log_f != 0) || (radix_log != 3 && radix_log != 4) ||
      threads < 32 || threads > MAX_THREADS || lanes <= 0)
    return (int)cudaErrorInvalidValue;
  const int lg = 1 << log_lg;
  const int groups = (lanes + lg - 1) / lg;
  const size_t smem = ((size_t)(n >> 1) + ((size_t)n << log_lg) +
                       (log_f > 0 ? (size_t)(n >> log_f) << log_lg : 0)) *
                      sizeof(uint64_t);
  if (smem > (size_t)MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  const long long grid = (long long)B * groups;
  if (grid <= 0 || grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const TileArgs a{(const uint64_t*)x,  (uint64_t*)out,       (const uint64_t*)tw,
                   (const uint64_t*)ep, (const uint64_t*)pre, n,
                   log_n,               lanes,                log_lg,
                   groups,              log_f,                transposed};
  auto kern = dif ? (radix_log == 4 ? ntt_tile_kernel<true, 4> : ntt_tile_kernel<true, 3>)
                  : (radix_log == 4 ? ntt_tile_kernel<false, 4> : ntt_tile_kernel<false, 3>);
  kern<<<(unsigned)grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
