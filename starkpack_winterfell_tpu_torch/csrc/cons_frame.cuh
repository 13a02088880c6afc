// Frame of the whole-AIR constraint kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of starkpack_winterfell_tpu/ops/pallas/
// cons_kernel.py (build_call).  ops/cons_kernel.py emit_cuda writes one
// translation unit per (AIR class, field, plan groups); it defines, before
// including this header:
//
//   typedef <field type> FE;              (F128, csrc/f128.cuh; F62,
//                                         csrc/f62.cuh; GL64,
//                                         csrc/gl64_fe.cuh)
//   CONS_W, CONS_K, CONS_NPER             trace width, transition
//                                         constraints, periodic columns
//   CONS_NGROUPS, CONS_NCC                boundary groups, their constraints
//   CONS_NSINGLE, CONS_NSEQ               single-value and sequence ones
//   CONS_GROUP_SIZE[], CONS_CC_COL[]      constraints per group, the trace
//                                         column of each constraint
//   CONS_CC_VAL[]                         where each constraint's value is:
//                                         single s (>= 0) or sequence
//                                         table q (-1 - q)
//   CONS_ROLES, CONS_MIN_BLOCKS           roles a point is split into, and
//                                         the blocks an SM must hold
//
// and after it, in this anonymous namespace, cons_role(role, q): role r's
// share of the transition at one (point, instance), sum over its results k
// of t_coef[k] * ev[k], each ev[k] folded in as soon as it exists.
//
// Bound on this card: operations (a point of the Lamport+ body costs ~300
// f128 multiplies, each ~130 32-bit integer instructions, against 16 bytes
// per input element).  What held the first design of this kernel (one
// thread a point, the body in the order the AIR's python recorded it, every
// input and periodic value loaded up front) below half of that bound was the
// register file: 255 registers a thread and ~500 bytes of spills on the
// Lamport+ body, so an SM held two blocks of 128 threads, too few warps to
// hide the latency of the IMAD chains.  This design:
//   * splits a point's transition into CONS_ROLES roles, cones of results
//     that share few multiplies (the emitter's partition); a role is whole
//     warps (warp-uniform, no divergence): threads [r * PPB, (r + 1) * PPB)
//     of a block run role r on the block's PPB = CONS_THREADS / CONS_ROLES
//     points, over all instances;
//   * runs each role's operations in a depth-first schedule by result,
//     reading each input and constant where it is used;
//   * writes the field constants as literals, which IMAD takes as
//     immediates (a __constant__ table measured slower: ptxas loaded its
//     entries into registers);
//   * loads through cons_ld, whose index and address arithmetic is inside
//     the load's asm: written in C++, the compiler hoisted every column's
//     address out of the instance loop and held ~50 of them (two registers
//     each) across the whole body, which was most of the spills;
//   * asks ptxas for CONS_MIN_BLOCKS (3) blocks an SM: 168 registers, at
//     which the Lamport+ roles still spill a few hundred bytes (PERF.md).
// Each role's thread computes final_power[i] * (dv0 * its share + [role 0]
// the boundary groups, each times its divisor) summed over the instances;
// the CONS_ROLES partials of a point meet in shared memory and role 0 adds
// and stores them.  Field addition is exact, so the output does not depend
// on CONS_ROLES or on the order of any sum.
//
// The frame is LDE row j*shift (current) and row (j*shift + blowup) mod L
// (next) of the (n, W, L) planes, read by index: no sliced copy of the LDE
// exists.  A single-value assertion's value is a bank scalar; a sequence
// assertion's is its table's word at (instance i, point j): the
// interpolated value polynomial over the ce domain, (n, ce) per sequence,
// evaluated by the caller (kernel 4).  Per-instance scalars come from one
// (n, NS, words) bank in the order t_coefs (CONS_K), single assertion
// values (CONS_NSINGLE), composition coefficients (CONS_NCC), final_power.
#pragma once

#define CONS_THREADS 128

namespace {

constexpr int CONS_PPB = CONS_THREADS / CONS_ROLES;  // points a block
static_assert(CONS_THREADS % CONS_ROLES == 0 && CONS_PPB % 32 == 0,
              "a role is whole warps");
constexpr int CONS_NS = CONS_K + CONS_NSINGLE + CONS_NCC + 1;

struct ConsArgs {
  const uint64_t *lde_lo, *lde_hi, *per_lo, *per_hi, *div_lo, *div_hi;
  const uint64_t *seq_lo, *seq_hi, *scal;
  uint64_t *out_lo, *out_hi;
  int n;
  long long L, ce;
  int shift, blowup, per_len;
};

// what a role reads at one (point, instance), as 32-bit word indices (the
// launcher checks that every table holds fewer than 2^32 words): trace
// column c of the current row at lde[cur + c * L], of the next at
// lde[nxt + c * L]; periodic column p at per[pj + p * per_len]; the
// instance's scalars at bank
struct ConsPoint {
  const uint64_t *lde_lo, *lde_hi, *per_lo, *per_hi;
  uint32_t cur, nxt, L, pj, per_len;
  const uint64_t* bank;
};

// Word start + c * stride of the planes lo and hi.  Index, addresses and
// loads are one volatile asm: the compiler above ptxas can neither hoist a
// load out of the instance loop nor keep a column's address (two registers
// a plane) live from the loop's head, as it does with loads written in C++;
// nor merge the load with an earlier one of the same word.  So only the
// plane pointers, start and stride stay live, and each word is fetched
// where the schedule reads it.
__device__ __forceinline__ FE cons_ld(const uint64_t* lo, const uint64_t* hi,
                                      uint32_t start, uint32_t c, uint32_t stride) {
#ifdef __CUDA_ARCH__
  uint64_t w[FE::WORDS];
  if constexpr (FE::WORDS == 1) {
    asm volatile(
        "{\n\t.reg .u32 t;\n\t.reg .u64 a;\n\t"
        "mad.lo.u32 t, %3, %2, %1;\n\t"
        "mad.wide.u32 a, t, 8, %4;\n\t"
        "ld.global.nc.u64 %0, [a];\n\t}"
        : "=l"(w[0])
        : "r"(start), "r"(c), "r"(stride), "l"(lo));
  } else {
    asm volatile(
        "{\n\t.reg .u32 t;\n\t.reg .u64 a;\n\t"
        "mad.lo.u32 t, %4, %3, %2;\n\t"
        "mad.wide.u32 a, t, 8, %5;\n\t"
        "ld.global.nc.u64 %0, [a];\n\t"
        "mad.wide.u32 a, t, 8, %6;\n\t"
        "ld.global.nc.u64 %1, [a];\n\t}"
        : "=l"(w[0]), "=l"(w[1])
        : "r"(start), "r"(c), "r"(stride), "l"(lo), "l"(hi));
  }
  return FE::from_words(w);
#else
  return FE::load(lo, hi, (size_t)start + (size_t)c * stride);
#endif
}

__device__ __forceinline__ FE cons_scalar(const uint64_t* bank, int row) {
  return FE::from_words(bank + (size_t)row * FE::WORDS);
}

__device__ __forceinline__ FE cons_cur(const ConsPoint& q, int c) {
  return cons_ld(q.lde_lo, q.lde_hi, q.cur, c, q.L);
}
__device__ __forceinline__ FE cons_nxt(const ConsPoint& q, int c) {
  return cons_ld(q.lde_lo, q.lde_hi, q.nxt, c, q.L);
}
__device__ __forceinline__ FE cons_per(const ConsPoint& q, int p) {
  return cons_ld(q.per_lo, q.per_hi, q.pj, p, q.per_len);
}

// role r's share of the transition; written by the emitter after this header
__device__ __forceinline__ FE cons_role(int role, const ConsPoint& q);

// Pass 1, every thread: its role's partial of its point, into part[role][p].
__device__ __forceinline__ void cons_role_pass(const ConsArgs& a,
                                               FE (*part)[CONS_PPB]) {
  const int role = threadIdx.x / CONS_PPB;  // warp-uniform
  const int p = threadIdx.x % CONS_PPB;
  const long long j = (long long)blockIdx.x * CONS_PPB + p;
  if (j >= a.ce) return;
  const uint32_t row0 = (uint32_t)(j * a.shift);
  const uint32_t row1 = (row0 + a.blowup) & (uint32_t)(a.L - 1);  // wraps at the end
  const uint32_t ce = (uint32_t)a.ce;
  ConsPoint q{a.lde_lo, a.lde_hi, a.per_lo, a.per_hi, 0, 0, (uint32_t)a.L,
              (uint32_t)(j & (a.per_len - 1)), (uint32_t)a.per_len, nullptr};

  FE total = FE::zero();
  for (int i = 0; i < a.n; ++i) {
    const uint32_t base = (uint32_t)i * CONS_W * q.L;
    q.cur = base + row0;
    q.nxt = base + row1;
    q.bank = a.scal + (size_t)i * CONS_NS * FE::WORDS;
    FE acc = fe_mul(cons_role(role, q), cons_ld(a.div_lo, a.div_hi, (uint32_t)j, 0, ce));
    if (role == 0) {
      int ci = 0;
#pragma unroll
      for (int g = 0; g < CONS_NGROUPS; ++g) {
        FE grp = FE::zero();
#pragma unroll
        for (int c = 0; c < CONS_GROUP_SIZE[g]; ++c, ++ci) {
          const int v = CONS_CC_VAL[ci];
          // sequence -1 - v's (n, ce) table at (i, j)
          const FE value = v >= 0 ? cons_scalar(q.bank, CONS_K + v)
                                  : cons_ld(a.seq_lo, a.seq_hi, (uint32_t)i * ce + (uint32_t)j,
                                            -1 - v, (uint32_t)a.n * ce);
          const FE diff = fe_sub(cons_cur(q, CONS_CC_COL[ci]), value);
          grp = fe_add(grp, fe_mul(cons_scalar(q.bank, CONS_K + CONS_NSINGLE + ci), diff));
        }
        acc = fe_add(acc, fe_mul(grp, cons_ld(a.div_lo, a.div_hi, (uint32_t)j, 1 + g, ce)));
      }
    }
    total = fe_add(total, fe_mul(acc, cons_scalar(q.bank, CONS_NS - 1)));
  }
  part[role][p] = total;
}

// Pass 2, role 0's threads: the sum of the point's partials, stored.
__device__ __forceinline__ void cons_meet_pass(const ConsArgs& a,
                                               FE (*part)[CONS_PPB]) {
  const int p = threadIdx.x;
  const long long j = (long long)blockIdx.x * CONS_PPB + p;
  if (p >= CONS_PPB || j >= a.ce) return;
  FE total = part[0][p];
#pragma unroll
  for (int r = 1; r < CONS_ROLES; ++r) total = fe_add(total, part[r][p]);
  FE::store(a.out_lo, a.out_hi, (size_t)j, total);
}

__global__ void __launch_bounds__(CONS_THREADS, CONS_MIN_BLOCKS)
cons_eval_kernel(const ConsArgs a) {
  __shared__ FE part[CONS_ROLES][CONS_PPB];
  cons_role_pass(a, part);
  __syncthreads();
  cons_meet_pass(a, part);
}

}  // namespace

// Plain C interface (loaded with ctypes).  lde: (n, W, L) word planes; per:
// (NPER, per_len) planes, one period of each periodic column over the ce
// domain (per_len a power of two); div: (1 + NGROUPS, ce) planes; seq:
// (NSEQ, n, ce) planes (unread when NSEQ is 0); scal: the (n, NS, words)
// bank; out: (ce,) planes.  L a power of two, ce = L / shift.  Blocks of
// CONS_THREADS threads, CONS_PPB points each.  Launches on `stream`, does
// not synchronise, allocates nothing.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int cons_eval_launch(const void* lde_lo, const void* lde_hi,
                                const void* per_lo, const void* per_hi,
                                const void* div_lo, const void* div_hi,
                                const void* seq_lo, const void* seq_hi,
                                const void* scal, void* out_lo, void* out_hi,
                                int n, long long L, long long ce, int shift,
                                int blowup, int per_len, void* stream) {
  if (n < 1 || ce < 1 || (L & (L - 1)) != 0 || (per_len & (per_len - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  // word indices are 32-bit (ConsPoint)
  const long long words = 1LL << 32;
  if ((long long)n * CONS_W * L >= words || (1LL + CONS_NGROUPS) * ce >= words ||
      (long long)CONS_NSEQ * n * ce >= words || (long long)CONS_NPER * per_len >= words)
    return (int)cudaErrorInvalidValue;
  const long long grid = (ce + CONS_PPB - 1) / CONS_PPB;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const ConsArgs a{(const uint64_t*)lde_lo, (const uint64_t*)lde_hi,
                   (const uint64_t*)per_lo, (const uint64_t*)per_hi,
                   (const uint64_t*)div_lo, (const uint64_t*)div_hi,
                   (const uint64_t*)seq_lo, (const uint64_t*)seq_hi,
                   (const uint64_t*)scal,   (uint64_t*)out_lo,
                   (uint64_t*)out_hi,       n, L, ce, shift, blowup, per_len};
  cons_eval_kernel<<<(unsigned)grid, CONS_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
