// Radix-2 butterfly stages of a Goldilocks NTT on a tile in shared memory:
// the one copy shared by the three Goldilocks kernels (ntt_tile.cu,
// ntt_dit.cu).
//
// The tile is (n, LG) canonical u64 words, LG = 2^log_lg adjacent lanes per
// row, word (row, l) at sm[(row << log_lg) + l].  Every thread of the block
// must call tile_stages after the tile is loaded and a __syncthreads(); on
// return all stages are done and a barrier has been passed.
//
//   DIF: natural-order rows in, bit-reversed rows out
//        (a, b) -> (a + b, (a - b) * w)      stages m = n, n/2, ..., 2
//   DIT: bit-reversed rows in, natural-order rows out
//        (a, b) -> (a + b*w, a - b*w)        stages m = 2, 4, ..., n
//   with w = tw[j * n/m] = root^(j * n/m) for butterfly j of a size-m group:
//   one (n/2,) table of root powers serves every stage.
#pragma once

#include <cstdint>

#include "gl64.cuh"

namespace gl64 {

template <bool DIF>
__device__ __forceinline__ void tile_stages(uint64_t* sm,
                                            const uint64_t* __restrict__ tw,
                                            int n, int log_n, int log_lg) {
  const int lmask = (1 << log_lg) - 1;
  const int nb = (n << log_lg) >> 1;  // butterflies per stage
  for (int step = 0; step < log_n; ++step) {
    const int s = DIF ? (log_n - step) : (step + 1);  // group size m = 2^s
    const int half = 1 << (s - 1);
    const int stride = n >> s;  // twiddle index multiplier n/m
    for (int t = threadIdx.x; t < nb; t += blockDim.x) {
      const int l = t & lmask;
      const int k = t >> log_lg;
      const int j = k & (half - 1);
      const int i0 = ((k >> (s - 1)) << s) + j;
      const int p0 = (i0 << log_lg) + l;
      const int p1 = p0 + (half << log_lg);
      const uint64_t w = __ldg(tw + (size_t)j * stride);
      const uint64_t a = sm[p0];
      const uint64_t c = sm[p1];
      if (DIF) {
        sm[p0] = add(a, c);
        sm[p1] = mul(sub(a, c), w);
      } else {
        const uint64_t tmul = mul(c, w);
        sm[p0] = add(a, tmul);
        sm[p1] = sub(a, tmul);
      }
    }
    __syncthreads();
  }
}

}  // namespace gl64
