// K3: exact-shift photometry numerators for Hopper (sm_90a).
//
// Replaces both TPU Pallas numerator kernels of
// `synference_tpu/ops/photometry_kernel.py`: `_num_kernel` (through
// `pallas_photometry_num`, the "roll" variant) and `_num_kernel_bank`
// (through `pallas_photometry_num_bank`, the "bank" variant). Both compute,
// for each galaxy b with snapped shift s4_b = 8·m_b + rs_b,
//
//   num[b,f] = Σ_{l<L} fw[b,l] · table[rs_b, f, l + m_b]
//
// with fw the observed flux times dλ/λ and table[rs, f, j] the filter
// transmission at λ0·10^{(j + rs/8)Δ}. The TPU cannot slice a lane
// dimension at an arbitrary offset, so "roll" rotated the flux row with
// `pltpu.roll` and "bank" DMA'd one of 128 pre-rolled copies of the table;
// on the card an arbitrary-offset load has no alignment rule, so one
// kernel reads table[rs, f, l + m] directly and serves both names.
//
// What bounds it on the H100: the flux slab. fw is (B, L) fp32 read once
// (537 MB at B = 65536, L = 2048: 0.16 ms at 3.35 TB/s) against F8·L FMAs
// per galaxy; the (8, F8, L + max_shift) table (~0.7 MB) stays in L2 and is
// read through L1 by every warp.
//
// Design. One warp per galaxy, 8 per block: each lane strides the flux row
// by 32 columns and keeps 8 band sums in registers (bands in groups of 8),
// then a butterfly of warp shuffles adds the lanes. m is clipped to the
// table's reach (L + m ≤ n_cols), as the plain version does, so no load
// leaves the table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // galaxies per block
constexpr int NB = 8;     // bands per pass
constexpr int N_SUB = 8;  // sub-column shifts of the table

__global__ void __launch_bounds__(32 * WARPS)
k3_shift_num_kernel(const float* __restrict__ fw, int64_t ld_fw,
                    const float* __restrict__ table,
                    const int* __restrict__ s4, float* __restrict__ out,
                    int B, int L, int f8, int n_cols) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + threadIdx.x / 32;
  if (b >= B) return;
  const int s = max(s4[b], 0);
  const int m = min(s / N_SUB, n_cols - L);
  const int rs = s % N_SUB;
  const float* row = fw + (int64_t)b * ld_fw;
  for (int f0 = 0; f0 < f8; f0 += NB) {
    const float* t = table + ((int64_t)rs * f8 + f0) * n_cols + m;
    float acc[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int l = lane; l < L; l += 32) {
      const float v = row[l];
#pragma unroll
      for (int i = 0; i < NB; ++i)
        acc[i] = fmaf(v, t[(int64_t)i * n_cols + l], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    }
    if (lane < NB) {
      float v = acc[0];
#pragma unroll
      for (int i = 1; i < NB; ++i)
        if (lane == i) v = acc[i];
      out[(int64_t)b * f8 + f0 + lane] = v;
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// Needs f8 a multiple of 8 and n_cols >= L.
int k3_shift_num(const float* fw, int64_t ld_fw, const float* table,
                 const int* s4, float* out, int B, int L, int f8, int n_cols,
                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + WARPS - 1) / WARPS);
  k3_shift_num_kernel<<<grid, 32 * WARPS, 0, st>>>(fw, ld_fw, table, s4, out,
                                                   B, L, f8, n_cols);
  return (int)cudaGetLastError();
}

}  // extern "C"
