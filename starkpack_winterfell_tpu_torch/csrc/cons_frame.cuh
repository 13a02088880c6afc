// Frame of the whole-AIR constraint kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of starkpack_winterfell_tpu/ops/pallas/
// cons_kernel.py (build_call).  This header is included at the END of a
// translation unit that ops/cons_kernel.py emit_cuda writes per (AIR class,
// field, plan groups).  That unit defines, before the include:
//
//   typedef <field type> FE;              (csrc/f128.cuh: F128)
//   CONS_W, CONS_K, CONS_NPER             trace width, transition
//                                         constraints, periodic columns
//   CONS_NGROUPS, CONS_NCC                boundary groups, their constraints
//   CONS_GROUP_SIZE[], CONS_CC_COL[]      constraints per group, the trace
//                                         column of each constraint
//   air_transition(cur, nxt, per, ev)     the AIR's transition, straight-line
//
// One thread = one point j of the constraint-evaluation (ce) domain.  It
// loads the periodic and divisor values of the point once, then walks the
// instances in order 0..n-1: the frame is LDE row j*shift (current) and row
// (j*shift + blowup) mod L (next), read by index from the (n, W, L) planes,
// so no sliced copy of the LDE exists; then the emitted transition,
// sum_k t_coef[k] * ev[k], the boundary groups sum cc * (state - value),
// each column times its divisor, the sum times final_power[i], accumulated
// in the field.  Field addition is exact, so the order of the accumulation
// does not show in the result.
//
// Per-instance scalars come from one (n, NS, words) bank in the order
// t_coefs (CONS_K), assertion values (CONS_NCC), composition coefficients
// (CONS_NCC), final_power (1).
//
// Bound on this card: operations.  A point of the Rescue128 chain AIR costs
// about 130 f128 multiplies, each seven 64 x 64 products, against 16 bytes
// per input element; every intermediate lives in registers, the inputs are
// read once and the (ce,) output written once.
#pragma once

namespace {

__device__ __forceinline__ FE cons_scalar(const uint64_t* bank, int row) {
  return FE::from_words(bank + (size_t)row * FE::WORDS);
}

__global__ void __launch_bounds__(128)
cons_eval_kernel(const uint64_t* __restrict__ lde_lo,
                 const uint64_t* __restrict__ lde_hi,
                 const uint64_t* __restrict__ per_lo,
                 const uint64_t* __restrict__ per_hi,
                 const uint64_t* __restrict__ div_lo,
                 const uint64_t* __restrict__ div_hi,
                 const uint64_t* __restrict__ scal,
                 uint64_t* __restrict__ out_lo, uint64_t* __restrict__ out_hi,
                 int n, long long L, long long ce, int shift, int blowup,
                 int per_len) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ce) return;

  FE per[CONS_NPER + 1];
#pragma unroll
  for (int p = 0; p < CONS_NPER; ++p)
    per[p] = FE::load(per_lo, per_hi,
                      (size_t)p * per_len + (size_t)(j & (per_len - 1)));
  FE dv[CONS_NGROUPS + 1];
#pragma unroll
  for (int d = 0; d <= CONS_NGROUPS; ++d)
    dv[d] = FE::load(div_lo, div_hi, (size_t)d * ce + j);

  const size_t row0 = (size_t)j * shift;
  const size_t row1 = (row0 + blowup) & (size_t)(L - 1);  // wraps at the end
  constexpr int NS = CONS_K + 2 * CONS_NCC + 1;

  FE total = FE::zero();
  for (int i = 0; i < n; ++i) {
    const size_t base = (size_t)i * CONS_W * L;
    FE cur[CONS_W], nxt[CONS_W];
#pragma unroll
    for (int c = 0; c < CONS_W; ++c) {
      cur[c] = FE::load(lde_lo, lde_hi, base + (size_t)c * L + row0);
      nxt[c] = FE::load(lde_lo, lde_hi, base + (size_t)c * L + row1);
    }
    const uint64_t* bank = scal + (size_t)i * NS * FE::WORDS;

    FE ev[CONS_K];
    air_transition(cur, nxt, per, ev);
    FE col = fe_mul(cons_scalar(bank, 0), ev[0]);
#pragma unroll
    for (int k = 1; k < CONS_K; ++k)
      col = fe_add(col, fe_mul(cons_scalar(bank, k), ev[k]));
    FE acc = fe_mul(col, dv[0]);

    int ci = 0;
#pragma unroll
    for (int g = 0; g < CONS_NGROUPS; ++g) {
      FE grp = FE::zero();
#pragma unroll
      for (int q = 0; q < CONS_GROUP_SIZE[g]; ++q, ++ci) {
        const FE diff = fe_sub(cur[CONS_CC_COL[ci]], cons_scalar(bank, CONS_K + ci));
        grp = fe_add(grp, fe_mul(cons_scalar(bank, CONS_K + CONS_NCC + ci), diff));
      }
      acc = fe_add(acc, fe_mul(grp, dv[1 + g]));
    }
    total = fe_add(total, fe_mul(acc, cons_scalar(bank, NS - 1)));
  }
  FE::store(out_lo, out_hi, (size_t)j, total);
}

}  // namespace

// Plain C interface (loaded with ctypes).  lde: (n, W, L) word planes; per:
// (NPER, per_len) planes, one period of each periodic column over the ce
// domain (per_len a power of two); div: (1 + NGROUPS, ce) planes; scal: the
// (n, NS, words) bank; out: (ce,) planes.  L a power of two, ce = L / shift.
// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// the cudaError_t of the launch (0 = success).
extern "C" int cons_eval_launch(const void* lde_lo, const void* lde_hi,
                                const void* per_lo, const void* per_hi,
                                const void* div_lo, const void* div_hi,
                                const void* scal, void* out_lo, void* out_hi,
                                int n, long long L, long long ce, int shift,
                                int blowup, int per_len, int threads,
                                void* stream) {
  if (n < 1 || ce < 1 || threads < 1 || threads > 128 || (L & (L - 1)) != 0 ||
      (per_len & (per_len - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const long long grid = (ce + threads - 1) / threads;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cons_eval_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)lde_lo, (const uint64_t*)lde_hi, (const uint64_t*)per_lo,
      (const uint64_t*)per_hi, (const uint64_t*)div_lo, (const uint64_t*)div_hi,
      (const uint64_t*)scal, (uint64_t*)out_lo, (uint64_t*)out_hi, n, L, ce,
      shift, blowup, per_len);
  return (int)cudaGetLastError();
}
