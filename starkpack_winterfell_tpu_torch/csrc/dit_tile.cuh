// Batched DIT NTT tile for Hopper (sm_90a), a template over the field type:
// kernel 3 (Goldilocks, ntt_dit.cu) and kernel 4 (f128 and f62,
// limb_ntt_tile.cu) are its instantiations.
//
// The function.  All log2(n) radix-2 DIT stages of length-n NTTs along axis 2
// of a logical (G, D, n, lanes) array of word planes (one plane per 64-bit
// word of an element; B = G*D batch entries, G groups of D), NATURAL-order
// rows in and natural order out: the bit reversal rides on the load.  x and
// the output are read and written through strides (in words, per plane), so
// a transform along the contiguous axis (rows of x), a transposed store, a
// broadcast input (stride 0) and an interleaved store are strides, not
// copies.  Options, each one multiply per element where it
// is given:
//   * n_in <= n: x has n_in rows, the rows n_in .. n-1 are zero (a
//     zero-padded coset LDE);
//   * pre: an (n_in, lanes) table, read through its strides, multiplied
//     into every slab of x (the four-step inner twiddle);
//   * row, col: factors of group g, row (G, n_in)
//     along the transform axis and col (G, lanes) along the lanes, both
//     multiplied into x (a power series s^t split by a four-step view into
//     s^(c*t1) and s^t2, one series per coset; or a coset offset's powers);
//   * scale: one field element multiplied into the output (an inverse's 1/n).
//
//   DIT: (a, b) -> (a + b*w, a - b*w)   stages m = 2, 4, ..., n,
//   w = root^(j * n/m) for the butterfly at offset j of a size-m group.
//
// Bound on this card.  Bytes: x read once, the output written once.
// Operations: log2(n)/2 butterflies per element, one field multiply, add and
// subtract each, plus a multiply per element for each table or factor; the
// operations are the larger bound from n = 4 up (f128 about five times the
// bytes at n = 1024), so the design spends as few instructions as it can
// beside the field arithmetic and keeps the integer pipes busy while words
// move:
//   * a block owns an (n, LG) tile of LG lanes; a thread holds R = 2^K
//     elements of one lane in registers and runs K stages there, so the tile
//     goes through shared memory once every K stages (the first pass reads
//     x, the last writes the output);
//   * the (n/2,) root-power table is copied into shared memory once per
//     block; the first pass has its butterfly offsets at compile time, so
//     its products by root^0 = 1 are not computed;
//   * a thread's task mapping follows the layout it reads or writes: rows
//     fastest where the pass reads rows of x that lie along the transform
//     axis (the first pass: position (rev(c0) << K) | i holds row
//     c0 + rev_K(i) * n/R, so consecutive threads read consecutive words)
//     or writes output rows along it (the last pass), lanes fastest
//     otherwise;
//   * tile and twiddle positions are swizzled (gl64::swz), so the strided
//     accesses of a pass spread over the shared-memory banks;
//   * the wrapper sizes LG so that two blocks or more share an SM, and
//     splits lanes finer where the batch alone would leave SMs idle;
//   * a field may hold its twiddles in another form (f62: Montgomery form,
//     tw_prep / tw_mul, converted as the block copies the table in).
//
// This is not a carry-over of the TPU kernels' roll-and-select butterflies,
// their (log n, n) per-position twiddle planes or their 128-lane blocks:
// those are shapes of the TPU's vector unit.
//
// A field type FE provides FE::WORDS, FE::zero(), FE::load(lo, hi, i),
// FE::store(lo, hi, i, v), fe_add, fe_sub and fe_mul (csrc/f128.cuh).
#pragma once

#include <cstddef>
#include <cstdint>

#include "gl64_radix.cuh"

namespace {

constexpr int DIT_MAX_THREADS = 256;
// dynamic shared memory a launch may ask for: all a block of an H100 can have
constexpr int DIT_MAX_SMEM_BYTES = 232448;
// K, the stages a thread runs in registers between two exchanges through
// shared memory, for every field: at K = 4 the f128 instantiation spills
// (128 registers, the cap of two blocks an SM), and Goldilocks and f62 ran
// slower than at 3 (PERF.md)
constexpr int DIT_RADIX_LOG = 3;

struct DitArgs {
  const uint64_t* x_lo;
  const uint64_t* x_hi;  // the high planes: null for a one-word field
  uint64_t* o_lo;
  uint64_t* o_hi;
  const uint64_t* tw_lo;  // (n/2,)
  const uint64_t* tw_hi;
  const uint64_t* pre_lo;  // (n_in, lanes) through (ps_c, ps_l), or null
  const uint64_t* pre_hi;
  const uint64_t* row_lo;  // (G, n_in), or null
  const uint64_t* row_hi;
  const uint64_t* col_lo;  // (G, lanes), or null
  const uint64_t* col_hi;
  uint64_t scale[2];
  // batch entry (g, d), group g < G of member d < D: x word (g, d, c, l) at
  // g*xs_g + d*xs_d + c*xs_c + l*xs_l, in words
  long long xs_g, xs_d, xs_c, xs_l;
  long long os_g, os_d, os_p, os_l;  // output word (g, d, p, l)
  long long ps_c, ps_l;              // pre word (c, l)
  int has_scale, n, log_n, n_in, lanes, log_lg, groups, n_groups;
  int rows_in, rows_out;  // task mappings: rows fastest in the first / last pass
};

// The twiddle form of a field: the identity; a field whose butterflies
// multiply by twiddles held in another form overloads both (limb_ntt_tile.cu).
template <class FE>
__device__ __forceinline__ FE tw_prep(FE w) {
  return w;
}
template <class FE>
__device__ __forceinline__ FE tw_mul(FE a, FE w) {
  return fe_mul(a, w);
}

// Element (c, lane) of the block's batch entry (its x words from xb on, group
// g), c a natural row, times the tables given.
template <class FE>
__device__ __forceinline__ FE dit_load(const DitArgs& a, long long xb, int g, int c,
                                       int lane) {
  if (c >= a.n_in) return FE::zero();
  FE v = FE::load(a.x_lo, a.x_hi, (size_t)(xb + c * a.xs_c + lane * a.xs_l));
  if (a.pre_lo != nullptr)
    v = fe_mul(v, FE::load(a.pre_lo, a.pre_hi, (size_t)(c * a.ps_c + lane * a.ps_l)));
  if (a.row_lo != nullptr)
    v = fe_mul(v, FE::load(a.row_lo, a.row_hi, (size_t)g * a.n_in + c));
  if (a.col_lo != nullptr)
    v = fe_mul(v, FE::load(a.col_lo, a.col_hi, (size_t)g * a.lanes + lane));
  return v;
}

template <class FE>
__device__ __forceinline__ void dit_store(const DitArgs& a, long long ob, int p, int lane,
                                          FE v) {
  if (a.has_scale) v = fe_mul(v, FE::load(a.scale, a.scale + 1, 0));
  FE::store(a.o_lo, a.o_hi, (size_t)(ob + p * a.os_p + lane * a.os_l), v);
}

// The KP stages on bits s0 .. s0+KP-1 of the elements v[i] at positions
// p_i = low | (i << s0) | high (gl64_radix.cuh); FIRST: s0 = 0 and low = 0,
// so every butterfly offset is known at compile time.
template <class FE, int KP, bool FIRST>
__device__ __forceinline__ void dit_radix(FE (&v)[1 << KP], const uint64_t* tw_lo,
                                          const uint64_t* tw_hi, int log_n, int s0,
                                          int low) {
  constexpr int R = 1 << KP;
#pragma unroll
  for (int step = 0; step < KP; ++step) {
    const int h = 1 << step;
    const int shift = log_n - s0 - step - 1;  // log2(n / m), m = 2^(s0+step+1)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i & h) continue;
      const int m = i & (h - 1);
      FE t = v[i + h];
      if (!FIRST || m != 0) {  // offset 0 of the first pass: root^0 = 1
        const int j = FIRST ? m : (low | (m << s0));
        t = tw_mul(t, FE::load(tw_lo, tw_hi, gl64::swz(j << shift)));
      }
      v[i + h] = fe_sub(v[i], t);
      v[i] = fe_add(v[i], t);
    }
  }
}

// One pass of KP stages over the block's tile: the first reads x, the last
// writes the output; every other one reads and writes the tile.
template <class FE, int KP, bool FIRST>
__device__ __forceinline__ void dit_pass(const DitArgs& a, const uint64_t* tw_lo,
                                         const uint64_t* tw_hi, uint64_t* t_lo,
                                         uint64_t* t_hi, long long xb, long long ob, int g,
                                         int lane0, int nl, int s0, bool last) {
  constexpr int R = 1 << KP;
  const int log_q = a.log_n - KP;  // tasks of one lane: 2^log_q
  const int qmask = (1 << log_q) - 1;
  const int lmask = (1 << a.log_lg) - 1;
  const int tasks = 1 << (log_q + a.log_lg);
  const bool rows_fast = FIRST ? a.rows_in != 0 : (last && a.rows_out != 0);
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int q = rows_fast ? (t & qmask) : (t >> a.log_lg);
    const int l = rows_fast ? (t >> log_q) : (t & lmask);
    const bool live = l < nl;
    int low = 0, p0;
    FE v[R];
    if (FIRST) {
      // q is the natural row c0: position (rev(c0) << KP) | i holds row
      // c0 + (rev_KP(i) << log_q)
      p0 = (log_q > 0 ? gl64::rev_bits(q, log_q) : 0) << KP;
#pragma unroll
      for (int i = 0; i < R; ++i)
        v[i] = live ? dit_load<FE>(a, xb, g, q | (gl64::crev(i, KP) << log_q), lane0 + l)
                    : FE::zero();
    } else {
      low = q & ((1 << s0) - 1);
      p0 = low | ((q >> s0) << (s0 + KP));
#pragma unroll
      for (int i = 0; i < R; ++i)
        v[i] = FE::load(t_lo, t_hi, gl64::swz(((p0 | (i << s0)) << a.log_lg) | l));
    }
    dit_radix<FE, KP, FIRST>(v, tw_lo, tw_hi, a.log_n, s0, low);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int p = p0 | (i << s0);
      if (last) {
        if (live) dit_store(a, ob, p, lane0 + l, v[i]);
      } else {
        FE::store(t_lo, t_hi, gl64::swz((p << a.log_lg) | l), v[i]);
      }
    }
  }
  __syncthreads();
}

// One block per batch entry and group of LG lanes, the G groups of one
// member and lane group in consecutive blocks: the cosets of one LDE read
// the same input words and write the same output sectors at about the same
// time.
template <class FE, int K>
__global__ void __launch_bounds__(DIT_MAX_THREADS, 2) dit_tile_kernel(const DitArgs a) {
  extern __shared__ uint64_t smem[];
  const int half = a.n >> 1;
  const int total = a.n << a.log_lg;
  uint64_t* tw_lo = smem;
  uint64_t* tw_hi = smem + half;  // unused by a one-word field
  uint64_t* t_lo = smem + FE::WORDS * half;
  uint64_t* t_hi = t_lo + total;  // likewise
  const int g = blockIdx.x % a.n_groups;
  const int rest = blockIdx.x / a.n_groups;
  const int d = rest / a.groups;
  const long long xb = g * a.xs_g + d * a.xs_d, ob = g * a.os_g + d * a.os_d;
  const int lane0 = (rest % a.groups) << a.log_lg;
  const int nl = min(1 << a.log_lg, a.lanes - lane0);  // ragged last group

  for (int t = threadIdx.x; t < half; t += blockDim.x)
    FE::store(tw_lo, tw_hi, gl64::swz(t), tw_prep(FE::load(a.tw_lo, a.tw_hi, t)));
  __syncthreads();

  const int passes = (a.log_n + K - 1) / K;
  const int k0 = a.log_n - (passes - 1) * K;
  const bool one = passes == 1;
  switch (k0) {
    case 1: dit_pass<FE, 1, true>(a, tw_lo, tw_hi, t_lo, t_hi, xb, ob, g, lane0, nl, 0, one); break;
    case 2: dit_pass<FE, 2, true>(a, tw_lo, tw_hi, t_lo, t_hi, xb, ob, g, lane0, nl, 0, one); break;
    case 3: dit_pass<FE, 3, true>(a, tw_lo, tw_hi, t_lo, t_hi, xb, ob, g, lane0, nl, 0, one); break;
    default:
      if constexpr (K >= 4)
        dit_pass<FE, 4, true>(a, tw_lo, tw_hi, t_lo, t_hi, xb, ob, g, lane0, nl, 0, one);
      break;
  }
  for (int ps = 1; ps < passes; ++ps)
    dit_pass<FE, K, false>(a, tw_lo, tw_hi, t_lo, t_hi, xb, ob, g, lane0, nl,
                           k0 + (ps - 1) * K, ps == passes - 1);
}

}  // namespace

#ifdef __CUDACC__
namespace {

template <class FE>
int dit_tile_init() {
  return (int)cudaFuncSetAttribute(dit_tile_kernel<FE, DIT_RADIX_LOG>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   DIT_MAX_SMEM_BYTES);
}

// Checks the arguments and launches dit_tile_kernel<FE, DIT_RADIX_LOG> on
// `stream` over B = G*D batch entries; returns the cudaError_t of the
// launch (0 = success).
template <class FE>
int dit_tile_launch(const void* x_lo, const void* x_hi, void* o_lo, void* o_hi,
                    const void* tw_lo, const void* tw_hi, const void* pre_lo,
                    const void* pre_hi, const void* row_lo, const void* row_hi,
                    const void* col_lo, const void* col_hi, unsigned long long scale_lo,
                    unsigned long long scale_hi, int has_scale, const long long* strides,
                    int B, int n, int n_in, int lanes, int log_lg, int n_groups,
                    int rows_in, int rows_out, int threads, void* stream) {
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  if ((1 << log_n) != n || n < 2 || n_in < 1 || n_in > n || lanes <= 0 || B <= 0 ||
      log_lg < 0 || log_lg > 20 || n_groups < 1 || B % n_groups != 0 || threads < 32 ||
      threads > DIT_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const int lg = 1 << log_lg;
  const size_t smem = (size_t)FE::WORDS * ((size_t)(n >> 1) + ((size_t)n << log_lg)) *
                      sizeof(uint64_t);
  if (smem > (size_t)DIT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  const int groups = (lanes + lg - 1) / lg;
  const long long grid = (long long)B * groups;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  DitArgs a{(const uint64_t*)x_lo, (const uint64_t*)x_hi, (uint64_t*)o_lo, (uint64_t*)o_hi,
            (const uint64_t*)tw_lo, (const uint64_t*)tw_hi, (const uint64_t*)pre_lo,
            (const uint64_t*)pre_hi, (const uint64_t*)row_lo, (const uint64_t*)row_hi,
            (const uint64_t*)col_lo, (const uint64_t*)col_hi, {scale_lo, scale_hi},
            strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
            strides[6], strides[7], strides[8], strides[9], has_scale, n, log_n, n_in,
            lanes, log_lg, groups, n_groups, rows_in, rows_out};
  dit_tile_kernel<FE, DIT_RADIX_LOG><<<(unsigned)grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
#endif
