// Batched limb-field NTT tile kernel for Hopper (sm_90a): the f128 (two word
// planes) and f62 (one plane) instantiations of the DIT tile frame of
// csrc/dit_tile.cuh, which kernel 3 (Goldilocks, ntt_dit.cu) shares.
//
// Replaces the Pallas TPU kernel of starkpack_winterfell_tpu/ops/pallas/
// limb_kernel.py (_make_kernel / _build_call): all log2(n) radix-2 DIT
// stages of a length-n NTT along axis 1 of (B, n, lanes) word planes, with
// an optional fused pre-multiply by an (n, lanes) table.  The Pallas kernel
// takes bit-reversed rows and its entry transposes, gathers, scales and
// interleaves around it in XLA; here those moves are the kernel's own: the
// bit reversal on the load, the layouts through strides (a transform along
// the contiguous axis, a transposed or an interleaved store), row and
// column factors of a batch group on the input (a coset's offset powers,
// split by a four-step view) and a scale word on the output (the inverse's
// 1/n).  ops/limb_ntt.py says which caller uses which.
//
// Bound on this card.  Bytes: the planes read once and written once, 32
// bytes per f128 element (16 per f62 element) against 3.35 TB/s.
// Operations: log2(n)/2 butterflies per element, each one field multiply
// (f128: four 64 x 64 -> 128 products and two folds; f62: a Montgomery
// product by a twiddle held in Montgomery form), one add and one subtract,
// and a multiply per element for each table or factor, at the per-pipe
// instruction counts of csrc/gl64_sass_count.py; the operations are the
// larger bound from n = 4 up.  The design against it is dit_tile.cuh's:
// radix-2^K passes in registers, the twiddles in shared memory, products by
// root^0 skipped, tiles sized for two or more blocks an SM.
//
// f62 twiddles in Montgomery form.  The block converts each twiddle w to
// w*2^64 mod p (below 2p) as it copies the table in; a butterfly's product
// a*w is then one Montgomery product of canonical a by that word: below 2p
// (a*w' < 2p^2 < p*2^64), made canonical by one conditional subtract, with
// no conversion of the data.  The tables and factors multiplied into the
// input keep the canonical product of csrc/f62.cuh.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "f128.cuh"
#include "f62.cuh"
#include "f62_mont.cuh"

// f62 twiddles in Montgomery form (above); found by argument-dependent
// lookup from the frame's butterflies.
__device__ __forceinline__ F62 tw_prep(F62 w) { return F62::make(f62m::to_mont(w.v)); }
__device__ __forceinline__ F62 tw_mul(F62 a, F62 w) {
  return F62::make(f62m::sub_if(f62m::mul(a.v, w.v), F62::P));
}

#include "dit_tile.cuh"

// Raises both instantiations' dynamic shared-memory limit to the most a
// launch may ask for; called once when the library is loaded, so no launch
// pays for the attribute call.  Returns the first cudaError_t (0 = success).
extern "C" int limb_ntt_tile_init() {
  const int e = dit_tile_init<F128>();
  return e != 0 ? e : dit_tile_init<F62>();
}

// Plain C interface (loaded with ctypes), one entry per field: the planes
// (the high ones NULL for f62) of x, the output, tw ((n/2,) powers of the
// size-n root), pre, row and col (NULL where not given), the scale word and
// the strides of dit_tile_launch (csrc/dit_tile.cuh).  Launches on `stream`,
// does not synchronise, allocates nothing.  Returns the cudaError_t of the
// launch (0 = success).
#define LIMB_LAUNCH(NAME, FE)                                                         \
  extern "C" int NAME(const void* x_lo, const void* x_hi, void* o_lo, void* o_hi,     \
                      const void* tw_lo, const void* tw_hi, const void* pre_lo,       \
                      const void* pre_hi, const void* row_lo, const void* row_hi,     \
                      const void* col_lo, const void* col_hi,                         \
                      unsigned long long scale_lo, unsigned long long scale_hi,       \
                      int has_scale, const long long* strides, int B, int n,          \
                      int n_in, int lanes, int log_lg, int n_groups, int rows_in,     \
                      int rows_out, int threads, void* stream) {                      \
    return dit_tile_launch<FE>(x_lo, x_hi, o_lo, o_hi, tw_lo, tw_hi, pre_lo, pre_hi,  \
                               row_lo, row_hi, col_lo, col_hi, scale_lo, scale_hi,    \
                               has_scale, strides, B, n, n_in, lanes, log_lg,         \
                               n_groups, rows_in, rows_out, threads, stream);         \
  }

LIMB_LAUNCH(dit_tile_f128_launch, F128)
LIMB_LAUNCH(dit_tile_f62_launch, F62)
