// Decimation-in-time Goldilocks NTT kernels for Hopper (sm_90a): the small
// transforms of the prover (lengths up to 4096 in one call, longer ones as
// the two halves of a four-step transform).
//
// Replaces the two Pallas TPU kernels of starkpack_winterfell_tpu/ops/pallas/
// ntt_kernel.py:
//
//   ntt_last       <- _make_kernel / _build_call with the entry around it,
//       pallas_ntt_batched: the NTT of every row of a contiguous (rows, n)
//       array along its last axis, natural order in and out, n <= 4096;
//   dit_tile_kernel<GL64, K>  <- _make_kernel3 / _build_call3: all log2(n)
//       DIT stages along axis 1 of a (B, n, lanes) array with an optional
//       elementwise multiply of every (n, lanes) slab by a static table
//       BEFORE the stages (the four-step inner twiddle, 1/n-scaled where the
//       table is made).  The Pallas kernel takes bit-reversed rows; this one
//       takes natural rows and bit-reverses on the load, reads and writes
//       through strides (the four-step's transposed store), and is the
//       Goldilocks instantiation of csrc/dit_tile.cuh, which kernel 4 shares.
//
// Bound on this card.  Bytes: the array read once and written once, 8 bytes
// a word each way against 3.35 TB/s.  Operations: log2(n)/2 butterflies per
// word, a multiply, an add and a subtract each, and a multiply per word and
// table, at the per-pipe instruction counts of csrc/gl64_sass_count.py.
// From n = 16 up the operations are the larger bound.
//
// ntt_last.  The TPU kernel runs along axis 0 because the TPU keeps the
// transform axis on sublanes, and its entry transposes, gathers the
// bit-reversed rows and multiplies by 1/n around it.  Here a row is
// contiguous, so the kernel reads the caller's layout as it is:
//   * n <= 32: one thread a row; it reads its row into registers in
//     bit-reversed order and runs every stage there (gl64_radix.cuh);
//   * n >= 64: a block owns 2^log_rb rows (a tile of about 4096 words).
//     The first pass reads R = 16 words of a row at stride n/16 (consecutive
//     threads on consecutive words: coalesced) at the natural indices whose
//     bit reversals are the R positions the thread's first four stages
//     combine, so the bit reversal costs nothing; later passes exchange
//     through the swizzled tile in shared memory, and the last pass writes
//     consecutive words of a row straight to device memory;
//   * x is read through its row and column strides, so a transposed view
//     (the FRI fold's rows, which lie down the columns of the layer's
//     evaluations) is read where it lies, with no copy: for n <= 32 the
//     threads of a warp then read consecutive words;
//   * optional: zero padding of rows shorter than n (x is (rows, n_in)), an
//     (n_in,) table multiplied into the input (evaluate_poly_with_offset's
//     offset powers) and one word multiplied into the output (the inverse's
//     1/n).
//
// dit_tile_kernel<GL64, K>: see csrc/dit_tile.cuh (radix-2^K passes in
// registers, twiddles in shared memory, several blocks per SM).
//
// Not carried over from the TPU kernels: the (log n, n) per-position twiddle
// planes, the roll-and-select butterflies and the 128-lane blocks, which are
// shapes of the TPU's vector unit.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "gl64_radix.cuh"
// Goldilocks as a field type of the DIT tile frame (csrc/dit_tile.cuh)
#include "gl64_fe.cuh"

#include "dit_tile.cuh"

namespace {

constexpr int LAST_MAX_THREADS = 256;
constexpr int LAST_K = 4;  // stages a pass of ntt_last runs in registers
// most dynamic shared memory a launch asks for: ntt_last's twiddles of
// n = 4096 beside a tile of at most 8192 words
constexpr int LAST_MAX_SMEM_BYTES = (2048 + 8192) * 8;

struct LastArgs {
  const uint64_t* x;    // (rows, n_in), word (r, c) at x[r * rs + c * cs]
  uint64_t* out;        // (rows, n), contiguous
  const uint64_t* tw;   // (n/2,)
  const uint64_t* pre;  // (n_in,) or null
  uint64_t scale;
  long long rs, cs;
  int has_scale, rows, n, log_n, n_in, log_rb;
};

__device__ __forceinline__ uint64_t last_load(const LastArgs& a, int row, int c) {
  uint64_t w = 0;
  if (row < a.rows && c < a.n_in) {
    w = a.x[(size_t)row * a.rs + (size_t)c * a.cs];
    if (a.pre != nullptr) w = gl64::mul(w, __ldg(a.pre + c));
  }
  return w;
}

__device__ __forceinline__ void last_store(const LastArgs& a, int row, int p,
                                           uint64_t w) {
  if (row < a.rows)
    a.out[(size_t)row * a.n + p] = a.has_scale ? gl64::mul(w, a.scale) : w;
}

// n = 2^LOGN <= 32: one thread a row, every stage in registers.
template <int LOGN>
__global__ void __launch_bounds__(LAST_MAX_THREADS)
    ntt_last_reg_kernel(const LastArgs a) {
  constexpr int N = 1 << LOGN;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= a.rows) return;
  uint64_t v[N];
#pragma unroll
  for (int p = 0; p < N; ++p) v[p] = last_load(a, row, gl64::crev(p, LOGN));  // bit-reversed
  gl64::radix_pass<false, LOGN>(v, a.tw, LOGN, 0, 0);
#pragma unroll
  for (int p = 0; p < N; ++p) last_store(a, row, p, v[p]);
}

// First pass of ntt_last (n >= 64): stages 1..KP on rows read from x.
template <int KP>
__device__ __forceinline__ void last_first_pass(const LastArgs& a,
                                                const uint64_t* tws,
                                                uint64_t* tile, int row0) {
  constexpr int R = 1 << KP;
  const int rest = a.log_n - KP;
  const int tasks = (1 << a.log_rb) << rest;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int r = t >> rest;
    const int c0 = t & ((1 << rest) - 1);
    // position (q << KP) | i holds x[rev(position)] = x[c0 + rev_KP(i) << rest]
    const int q = gl64::rev_bits(c0, rest);
    uint64_t v[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      v[i] = last_load(a, row0 + r, c0 | (gl64::crev(i, KP) << rest));
    gl64::radix_pass<false, KP>(v, tws, a.log_n, 0, 0);
#pragma unroll
    for (int i = 0; i < R; ++i)
      tile[(r << a.log_n) + gl64::swz((q << KP) | i)] = v[i];
  }
  __syncthreads();
}

// A later pass of ntt_last: LAST_K stages on bits s0.. through the tile; the
// last pass writes the rows out.
__device__ __forceinline__ void last_pass(const LastArgs& a,
                                          const uint64_t* tws, uint64_t* tile,
                                          int row0, int s0, bool last) {
  constexpr int R = 1 << LAST_K;
  const int rest = a.log_n - LAST_K;
  const int tasks = (1 << a.log_rb) << rest;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int r = t >> rest;
    const int q = t & ((1 << rest) - 1);
    const int low = q & ((1 << s0) - 1);
    const int p0 = low | ((q >> s0) << (s0 + LAST_K));
    uint64_t* row_tile = tile + (r << a.log_n);
    uint64_t v[R];
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = row_tile[gl64::swz(p0 | (i << s0))];
    gl64::radix_pass<false, LAST_K>(v, tws, a.log_n, s0, low);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int p = p0 | (i << s0);
      if (last)
        last_store(a, row0 + r, p, v[i]);
      else
        row_tile[gl64::swz(p)] = v[i];
    }
  }
  __syncthreads();
}

// n >= 64: a block transforms 2^log_rb rows through a tile in shared memory.
__global__ void __launch_bounds__(LAST_MAX_THREADS)
    ntt_last_kernel(const LastArgs a) {
  extern __shared__ uint64_t smem[];
  uint64_t* tws = smem;
  uint64_t* tile = smem + (a.n >> 1);
  const int row0 = blockIdx.x << a.log_rb;
  for (int t = threadIdx.x; t < (a.n >> 1); t += blockDim.x) tws[t] = __ldg(a.tw + t);
  __syncthreads();
  const int passes = (a.log_n + LAST_K - 1) / LAST_K;
  const int k0 = a.log_n - (passes - 1) * LAST_K;
  switch (k0) {
    case 1: last_first_pass<1>(a, tws, tile, row0); break;
    case 2: last_first_pass<2>(a, tws, tile, row0); break;
    case 3: last_first_pass<3>(a, tws, tile, row0); break;
    default: last_first_pass<4>(a, tws, tile, row0); break;
  }
  for (int ps = 1; ps < passes; ++ps)
    last_pass(a, tws, tile, row0, k0 + (ps - 1) * LAST_K, ps == passes - 1);
}

int log2_exact(int n) {
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  return ((1 << log_n) == n && n >= 2) ? log_n : -1;
}

}  // namespace

// Plain C interfaces (loaded with ctypes).  Arrays are contiguous u64; tw is
// the (n/2,) table of powers of the size-n root.  The launchers launch on
// `stream`, do not synchronise and allocate nothing, and return the
// cudaError_t of the launch (0 = success).

// Raises the dynamic shared-memory limit of every kernel that can ask for
// more than 48 KB to the most its launches ask for; called once when the
// library is loaded, so no launch pays for the attribute call.
extern "C" int ntt_dit_init() {
  cudaError_t e = cudaFuncSetAttribute(
      ntt_last_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      LAST_MAX_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  return dit_tile_init<GL64>();
}

// x: (rows, n_in), n_in <= n, word (r, c) at x[r * row_stride + c *
// col_stride] (strides in words, not negative); out: (rows, n), contiguous;
// pre: (n_in,) or NULL; the output is multiplied by `scale` when has_scale.
// log_rb: log2 of the rows a block transforms (n >= 64 only); threads: the
// block size.
extern "C" int ntt_last_launch(const void* x, void* out, const void* tw,
                               const void* pre, unsigned long long scale,
                               int has_scale, long long row_stride,
                               long long col_stride, int rows, int n, int n_in,
                               int log_rb, int threads, void* stream) {
  const int log_n = log2_exact(n);
  if (log_n < 0 || log_n > 12 || rows <= 0 || n_in < 1 || n_in > n ||
      row_stride < 0 || col_stride < 0 || threads < 32 ||
      threads > LAST_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  LastArgs a{(const uint64_t*)x, (uint64_t*)out, (const uint64_t*)tw,
             (const uint64_t*)pre, (uint64_t)scale, row_stride, col_stride,
             has_scale, rows, n, log_n, n_in, log_rb};
  cudaStream_t st = (cudaStream_t)stream;
  if (log_n <= 5) {
    const unsigned grid = (unsigned)((rows + threads - 1) / threads);
    switch (log_n) {
      case 1: ntt_last_reg_kernel<1><<<grid, threads, 0, st>>>(a); break;
      case 2: ntt_last_reg_kernel<2><<<grid, threads, 0, st>>>(a); break;
      case 3: ntt_last_reg_kernel<3><<<grid, threads, 0, st>>>(a); break;
      case 4: ntt_last_reg_kernel<4><<<grid, threads, 0, st>>>(a); break;
      default: ntt_last_reg_kernel<5><<<grid, threads, 0, st>>>(a); break;
    }
    return (int)cudaGetLastError();
  }
  const size_t smem = ((size_t)(n >> 1) + ((size_t)n << log_rb)) * sizeof(uint64_t);
  if (log_rb < 0 || smem > (size_t)LAST_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  const long long grid = ((long long)rows + (1LL << log_rb) - 1) >> log_rb;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  ntt_last_kernel<<<(unsigned)grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The DIT tile of csrc/dit_tile.cuh on Goldilocks words (dit_tile_launch
// there): x and the output read and written through strides[0..7] (x: g, d,
// c, l; out: g, d, p, l), pre through strides[8..9], row (G, n_in), col (G,
// lanes).
extern "C" int dit_tile_gl64_launch(const void* x, void* out, const void* tw,
                                    const void* pre, const void* row, const void* col,
                                    const long long* strides, int B, int n, int n_in,
                                    int lanes, int log_lg, int n_groups, int rows_in,
                                    int rows_out, int threads, void* stream) {
  return dit_tile_launch<GL64>(x, nullptr, out, nullptr, tw, nullptr, pre, nullptr, row,
                               nullptr, col, nullptr, 0, 0, 0, strides, B, n, n_in, lanes,
                               log_lg, n_groups, rows_in, rows_out, threads, stream);
}
