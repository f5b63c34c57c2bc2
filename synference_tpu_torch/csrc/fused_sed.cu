// K2: full-table SED -> photometry kernel for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `synference_tpu/ops/fused_sed.py::_mega_kernel`
// as reached through `fused_sed_photometry` (the dense `photometry()` path,
// θ in any redshift order). For each galaxy b, over the whole λ support of L
// rest-frame columns and the n_knots knot rows of F8 bands:
//
//   lnu[b,l]  = Σ_c sfzh[b,c] · sed[c,l]                  (fp32 FMA in c order;
//                                                         sed carries dλ/λ)
//   fw[b,l]   = bf16( lnu · (fesc + (1−fesc)·exp(−τ_V[b]·k[l])) )
//   acc[b,r,f] = Σ_l fw[b,l] · knot[l, (r0_b + r)·F8 + f],  r = 0..3
//                                           (bf16 inputs, fp32 accumulation)
//   out[b,f]  = interp(acc; s[b]) / max(interp(den[·,f]; s[b]), 1e-30)
//               · scale[b]
//
// with r0_b = clamp(k_b − 1, 0, n_knots − 4) and k_b the knot interval of the
// galaxy's shift, interp as in knot_interp.cuh, the shift clipped at
// (n_knots−1)·δ − 1e-3.
//
// The TPU kernel contracts every knot column (the matrix unit wants the
// whole (L, n_knots·F8) product) and then selects 4 rows per galaxy with
// lane masks. An interpolated flux reads only knot rows k−1..k+2, so this
// kernel contracts just those 4·F8 columns per galaxy: a gathered product,
// the knot columns read by direct index from the bf16 knot matrix, which
// stays in L2 (2.6 MB at 1006 λ × 1296 knot columns). The values equal the
// full product's rows to fp32 summation order, with 1/40 of its FLOPs at the
// 162-knot headline model.
//
// What bounds it on the H100. What remains is the first product:
// 2·C·L FLOPs per galaxy (0.77 MFLOP at C = 384, L = 1006) against a few
// hundred bytes of per-galaxy input, so fp32 FMA throughput and shared-memory
// reads bound it, not device memory. It runs on the CUDA cores in fp32
// (wgmma has no fp32 input type; TF32 or split-bf16 would change the
// rounding of the bf16 knot-product input the kernel is held to), as a
// register tile of 8 galaxies × 4 λ columns per thread, summing over c in
// ascending order like the plain version's matrix product.
//
// Design. One launch over the batch, one block per TB galaxies, each block
// walks the whole λ support in LW-column chunks: per chunk it contracts lnu
// in registers, applies the screen, rounds fw to bf16 into shared memory,
// and adds the chunk's gathered knot products into a (TB × 4·F8) fp32
// accumulator in shared memory. The epilogue interpolates num and den at
// each galaxy's shift. Nothing (B, L)- or (B, n_knots·F8)-shaped reaches
// device memory, and no partial sums cross blocks.
//
// Not carried over from the TPU kernel: 8-row block padding, 128-lane
// padding and power-of-two knot slots, lane-mask row selection, the log-step
// roll reduction, and the reciprocal-form den slopes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "knot_interp.cuh"

namespace {

constexpr int TB = 64;   // galaxies per block
constexpr int LW = 128;  // λ columns per chunk
constexpr int CK = 16;   // SFZH cells per contraction step
constexpr int NT = 256;  // threads per block
constexpr int GR = 8;    // galaxies per thread in the lnu tile
constexpr int LR = 4;    // λ columns per thread in the lnu tile
constexpr int NKR = 4;   // knot rows a galaxy reads (k−1..k+2)
constexpr int SFZ_LD = TB + 4;  // sfz_s row: float4-aligned
constexpr int FW_LD = LW + 4;   // fw_s row: float4-aligned, rows 4 banks apart

static_assert((TB / GR) * (LW / LR) == NT, "the lnu tile covers the block");
static_assert(LR == 4 && GR == 8, "the lnu tile loads float4 vectors");

constexpr size_t kFixedSmem =
    sizeof(float) * (CK * SFZ_LD + CK * LW + TB * FW_LD) + sizeof(int) * TB;

__global__ void __launch_bounds__(NT)
k2_fused_sed_kernel(const float* __restrict__ sfzh, int64_t ld_sfzh,
                    const float* __restrict__ s_abs,
                    const float* __restrict__ tau_v,
                    const float* __restrict__ scale,
                    const float* __restrict__ sed, int64_t ld_sed,
                    const float* __restrict__ curve,
                    const __nv_bfloat16* __restrict__ knot, int64_t ld_knot,
                    const float* __restrict__ den, int64_t ld_den,
                    float* __restrict__ out, int B, int C, int L, int n_knots,
                    int f8, int delta, int order, float fesc, float s_max) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sfz_s = reinterpret_cast<float*>(smem_raw);  // [CK][SFZ_LD]
  float* sed_s = sfz_s + CK * SFZ_LD;                   // [CK][LW]
  float* fw_s = sed_s + CK * LW;                        // [TB][FW_LD]
  int* r0_s = reinterpret_cast<int*>(fw_s + TB * FW_LD);  // [TB]
  float* acc_s = reinterpret_cast<float*>(r0_s + TB);     // [TB][NKR·f8]

  const int tid = threadIdx.x;
  const int g_base = blockIdx.x * TB;
  const int acc_ld = NKR * f8;

  for (int e = tid; e < TB * acc_ld; e += NT) acc_s[e] = 0.f;
  for (int g = tid; g < TB; g += NT) {
    const int gg = g_base + g;
    const float c = gg < B ? fminf(fmaxf(s_abs[gg], 0.f), s_max) / (float)delta
                           : 0.f;
    r0_s[g] = min(max((int)floorf(c) - 1, 0), n_knots - NKR);
  }

  const int tx = tid % (LW / LR);  // λ columns LR·tx .. LR·tx+3
  const int ty = tid / (LW / LR);  // galaxies GR·ty .. GR·ty+7 (one per warp)
  float tau[GR];
#pragma unroll
  for (int i = 0; i < GR; ++i) {
    const int gg = g_base + GR * ty + i;
    tau[i] = gg < B ? tau_v[gg] : 0.f;
  }

  for (int l0 = 0; l0 < L; l0 += LW) {
    float lnu[GR][LR];
#pragma unroll
    for (int i = 0; i < GR; ++i)
#pragma unroll
      for (int j = 0; j < LR; ++j) lnu[i][j] = 0.f;

    for (int c0 = 0; c0 < C; c0 += CK) {
      __syncthreads();  // earlier readers of sfz_s / sed_s / fw_s are done
      for (int e = tid; e < TB * CK; e += NT) {
        const int g = e / CK, c = e % CK;
        const int gg = g_base + g, cc = c0 + c;
        sfz_s[c * SFZ_LD + g] =
            (gg < B && cc < C) ? sfzh[(int64_t)gg * ld_sfzh + cc] : 0.f;
      }
      for (int e = tid; e < CK * LW; e += NT) {
        const int c = e / LW, l = e % LW;
        const int cc = c0 + c, lg = l0 + l;
        sed_s[c * LW + l] =
            (cc < C && lg < L) ? sed[(int64_t)cc * ld_sed + lg] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(&sfz_s[c * SFZ_LD + GR * ty]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&sfz_s[c * SFZ_LD + GR * ty + 4]);
        const float4 bv =
            *reinterpret_cast<const float4*>(&sed_s[c * LW + LR * tx]);
        const float a[GR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[LR] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < GR; ++i)
#pragma unroll
          for (int j = 0; j < LR; ++j) lnu[i][j] = fmaf(a[i], b[j], lnu[i][j]);
      }
    }

    // dust screen, then round to bf16 (the knot product's input type)
#pragma unroll
    for (int j = 0; j < LR; ++j) {
      const int lg = l0 + LR * tx + j;
      const float k_l = lg < L ? curve[lg] : 0.f;
#pragma unroll
      for (int i = 0; i < GR; ++i) {
        float att = expf(-tau[i] * k_l);
        if (fesc != 0.f) att = fesc + (1.f - fesc) * att;
        fw_s[(GR * ty + i) * FW_LD + LR * tx + j] =
            __bfloat162float(__float2bfloat16_rn(lnu[i][j] * att));
      }
    }
    __syncthreads();

    // acc[g, r, f] += Σ_l fw[g, l] · knot[l0 + l, (r0_g + r)·F8 + f], two
    // adjacent knot columns per thread (F8 is even, so the pair is aligned)
    const int nl = min(LW, L - l0);
    const int pairs = acc_ld / 2;
    for (int e = tid; e < TB * pairs; e += NT) {
      const int g = e / pairs, j = 2 * (e % pairs);
      const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(
          knot + (int64_t)l0 * ld_knot + r0_s[g] * f8 + j);
      const int64_t kstep = ld_knot / 2;
      const float* fp = fw_s + g * FW_LD;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int l = 0; l < nl; ++l) {
        const float2 kv = __bfloat1622float2(kp[l * kstep]);
        s0 = fmaf(fp[l], kv.x, s0);
        s1 = fmaf(fp[l], kv.y, s1);
      }
      acc_s[g * acc_ld + j] += s0;
      acc_s[g * acc_ld + j + 1] += s1;
    }
  }
  __syncthreads();

  for (int e = tid; e < TB * f8; e += NT) {
    const int g = e / f8, f = e % f8;
    const int gg = g_base + g;
    if (gg >= B) continue;
    const float c = fminf(fmaxf(s_abs[gg], 0.f), s_max) / (float)delta;
    const int k = (int)floorf(c);
    const float t = c - (float)k;
    const int r0 = r0_s[g];
    const float* acc_g = acc_s + g * acc_ld + f;
    const auto num_at = [&](int kk) { return acc_g[(kk - r0) * f8]; };
    const auto den_at = [&](int kk) { return den[(int64_t)kk * ld_den + f]; };
    const float num = knot_interp(num_at, k, t, n_knots, order);
    const float dn = knot_interp(den_at, k, t, n_knots, order);
    out[(int64_t)gg * f8 + f] = num / fmaxf(dn, 1.0e-30f) * scale[gg];
  }
}

}  // namespace

extern "C" {

size_t k2_smem_bytes(int f8) {
  return kFixedSmem + sizeof(float) * TB * NKR * f8;
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// Needs n_knots >= 4, an even f8 and an even knot row stride.
int k2_fused_sed(const float* sfzh, int64_t ld_sfzh, const float* s_abs,
                 const float* tau_v, const float* scale, const float* sed,
                 int64_t ld_sed, const float* curve,
                 const __nv_bfloat16* knot, int64_t ld_knot, const float* den,
                 int64_t ld_den, float* out, int B, int C, int L, int n_knots,
                 int f8, int delta, int order, float fesc, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = k2_smem_bytes(f8);
  cudaError_t err = cudaFuncSetAttribute(
      k2_fused_sed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // same clip bound as `_knot_interp`: computed in double, rounded to float
  const float s_max = (float)((n_knots - 1) * (double)delta - 1.0e-3);
  const dim3 grid((B + TB - 1) / TB);
  k2_fused_sed_kernel<<<grid, NT, smem, st>>>(
      sfzh, ld_sfzh, s_abs, tau_v, scale, sed, ld_sed, curve, knot, ld_knot,
      den, ld_den, out, B, C, L, n_knots, f8, delta, order, fesc, s_max);
  return (int)cudaGetLastError();
}

}  // extern "C"
