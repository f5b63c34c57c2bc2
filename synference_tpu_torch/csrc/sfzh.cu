// The lognormal × delta-Z SFZH of a batch in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's `_sfzh`
// (`synference_tpu/sed.py:541`) is XLA code, and the port's plain version
// is `BatchSEDSimulator._sfzh` in PyTorch (`ops/sfzh.py::
// lognormal_delta_sfzh_reference` is the same code for this model). Per
// row b, with the (B,) prologue (max_age, μ, τ, mass, the delta-Z index
// and fraction) computed by that code in PyTorch, and the A+1 age-bin edges
// e_j [yr]:
//
//   m_j      = ndtr((ln max(max(max_age − e_j, 0), 1) − μ) / τ)
//   w_a      = max(m_a − m_{a+1}, 0),  T = Σ_a w_a   (torch.cumsum's tree)
//   w_a      = T > 1e-30 ? w_a / max(T, 1e-30) : 1/A
//   sfzh[a·Z + z] = (w_a · wz_z) · mass,  wz_idx = 1 − frac,
//                   wz_{idx+1} = 0 + frac, wz = 0 elsewhere
//   marginal[a]   = Σ_z sfzh[a·Z + z]                (only when asked)
//
// What bounds it on the H100: the write of the (B, A·Z) SFZH, 201 MB at
// B = 65536, A·Z = 768 (0.060 ms at 3.35 TB/s); the CDFs are 2(A+1) logs
// and erfs a row. The plain version takes ~50 launches and three full
// passes over the SFZH (outer product, mass, age marginal), and its row
// total runs torch's in-row scan with 512 threads a 64-value row.
//
// Design. One warp a row: lane i holds ages i and 32 + i, the row total
// is a butterfly of shuffles, and the normalised age weights go through
// 256 bytes of shared memory to the lanes that write the row, in 16-byte
// stores, neighbouring lanes on neighbouring addresses.
//
// Bits. Every value equals the plain version's on the card, so K1 reads
// the same inputs:
// - each PyTorch op rounds on its own: the arithmetic is written with
//   __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn, which nvcc never
//   contracts into an FMA; logf and erff are what ATen's log and erf
//   kernels call; torch.special.ndtr is ATen's composite
//   (x·float(√½), erf, + 1, × 0.5); torch.clamp(v, min) is
//   isnan(v) ? v : fmaxf(v, min);
// - the row total is the last value of torch.cumsum's in-row Sklansky
//   scan (ATen's ScanUtils.cuh). Its chunks are 2·2^log_x wide, log_x from
//   `get_log_num_threads_x_inner_scan` (mirrored on the host,
//   `ops/sfzh.py::scan_chunk`). With the chunk at least A wide the
//   total is the balanced pairwise tree over the 64 values padded with
//   zeros: T(lo 32) and T(hi 32) by xor shuffles at offsets 1, 2, 4, 8,
//   16, then T(hi) + T(lo). With chunks of 32 and A > 32 (`split`) the
//   second chunk's first value is x_32 + T(lo) and its tree follows;
// - the age marginal of a delta Z has at most two nonzero terms, so any
//   order of its sum gives the bits of torch's reduction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxAges = 64;
constexpr int kRowsPerBlock = 8;  // one warp a row
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* max_age;
  const float* mu;
  const float* tau;
  const float* mass;
  const int64_t* z_idx;
  const float* z_frac;
  const float* edges;
  float* sfzh;
  float* marginal;  // null: not asked for
  int64_t B;
  int A, Z, split;
  float uniform;  // float(1/A), as torch.full_like casts it
};

// torch.clamp(v, min=lo): NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// the lognormal CDF at one age-bin edge (sfh.py: edge_times, lognormal_cdf)
__device__ __forceinline__ float lognormal_cdf(float max_age, float edge,
                                               float mu, float tau) {
  const float x = clamp_min(__fsub_rn(max_age, edge), 0.0f);
  const float u = __fdiv_rn(__fsub_rn(logf(clamp_min(x, 1.0f)), mu), tau);
  const float sqrt_half = static_cast<float>(0.70710678118654752440);
  return __fmul_rn(__fadd_rn(erff(__fmul_rn(u, sqrt_half)), 1.0f), 0.5f);
}

// the balanced pairwise sum of the warp's 32 values, in every lane
__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  }
  return v;
}

// one SFZH cell: (w_a · wz_z) · mass, the plain version's two products
__device__ __forceinline__ float cell(float wa, int z, int64_t zi, float wz_lo,
                                      float wz_hi, float mass) {
  const float wz = z == zi ? wz_lo : (z == zi + 1 ? wz_hi : 0.0f);
  return __fmul_rn(__fmul_rn(wa, wz), mass);
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
sfzh_lognormal_delta_kernel(const __grid_constant__ Params p) {
  __shared__ float s_w[kRowsPerBlock][kMaxAges];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = int64_t(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= p.B) return;  // whole warps leave together
  const float max_age = p.max_age[row], mu = p.mu[row], tau = p.tau[row];
  const float mass = p.mass[row];

  // age bins lane and 32 + lane; bins past A are the scan's zero padding
  float w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int a = lane + 32 * h;
    w[h] = 0.0f;
    if (a < p.A) {
      const float m0 = lognormal_cdf(max_age, p.edges[a], mu, tau);
      const float m1 = lognormal_cdf(max_age, p.edges[a + 1], mu, tau);
      w[h] = clamp_min(__fsub_rn(m0, m1), 0.0f);
    }
  }
  const float t_lo = warp_tree(w[0]);
  const float total =
      p.split ? warp_tree(lane == 0 ? __fadd_rn(w[1], t_lo) : w[1])
              : __fadd_rn(warp_tree(w[1]), t_lo);
  const bool has_mass = total > 1e-30f;
  const float den = clamp_min(total, 1e-30f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    w[h] = has_mass ? __fdiv_rn(w[h], den) : p.uniform;
    s_w[warp][lane + 32 * h] = w[h];
  }
  __syncwarp();

  // delta Z: torch's scatter (1 − frac) and scatter_add (0 + frac)
  const int64_t zi = p.z_idx[row];
  const float frac = p.z_frac[row];
  const float wz_lo = __fsub_rn(1.0f, frac), wz_hi = __fadd_rn(0.0f, frac);
  const int Z = p.Z, C = p.A * p.Z;
  const float* wa = s_w[warp];
  float* out = p.sfzh + row * C;
  if ((C & 3) == 0) {
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int j = lane; j < C / 4; j += 32) {
      int a = 4 * j / Z, z = 4 * j - a * Z;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = cell(wa[a], z, zi, wz_lo, wz_hi, mass);
        if (++z == Z) {
          z = 0;
          ++a;
        }
      }
      out4[j] = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int e = lane; e < C; e += 32) {
      out[e] = cell(wa[e / Z], e % Z, zi, wz_lo, wz_hi, mass);
    }
  }
  if (p.marginal != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int a = lane + 32 * h;
      if (a >= p.A) continue;
      float s = 0.0f;
      for (int z = 0; z < Z; ++z) {
        s = __fadd_rn(s, cell(w[h], z, zi, wz_lo, wz_hi, mass));
      }
      p.marginal[row * p.A + a] = s;
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a shape it does not take (1 <= A <= 64, Z >= 2,
// B >= 1). max_age, mu, tau, mass, z_frac (float) and z_idx (int64) are
// (B,); edges (A+1,); sfzh (B, A·Z) row-major, 16-byte aligned; marginal
// (B, A) or null. `split` 1 when torch's cumsum scans the rows in chunks
// of 32 and A > 32 (`ops/sfzh.py::scan_chunk`).
int sfzh_lognormal_delta(const float* max_age, const float* mu,
                         const float* tau, const float* mass,
                         const int64_t* z_idx, const float* z_frac,
                         const float* edges, float* sfzh, float* marginal,
                         int64_t B, int A, int Z, int split, float uniform,
                         void* stream) {
  if (A < 1 || A > kMaxAges || Z < 2 || B < 1) return cudaErrorInvalidValue;
  const Params p{max_age, mu,   tau, mass, z_idx, z_frac, edges, sfzh,
                 marginal, B,   A,   Z,    split, uniform};
  const int64_t blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  sfzh_lognormal_delta_kernel<<<dim3(unsigned(blocks)), kRowsPerBlock * 32,
                                0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
