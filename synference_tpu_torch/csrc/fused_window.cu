// K1: windowed SED -> photometry kernel for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `synference_tpu/ops/fused_sed.py::_mega_kernel`
// as reached through `fused_window_photometry` (the z-sorted window engine's
// fused body). For each galaxy b of a sub-chunk, over a window of W rest-frame
// λ columns and kc knot columns of F8 bands:
//
//   lnu[b,l] = Σ_c sfzh[b,c] · sed[c,l]                    (fp32 FMA; sed
//                                                           carries dλ/λ)
//   fw[b,l]  = bf16( lnu · (fesc + (1−fesc)·exp(−τ_V[b]·k[l])) )
//   acc[b,j] = Σ_l fw[b,l] · knot[l,j]      (bf16 inputs, fp32 accumulation)
//   out[b,f] = interp(acc[b,·,f]; s[b]) / max(interp(den[·,f]; s[b]), 1e-30)
//              · scale[b]
//
// with interp the monotone-cubic Fritsch–Butland Hermite (order 3) or the
// lerp (order 1) of `photometry_kernel._knot_interp` (knot_interp.cuh), the
// shift clipped at (kc−1)·δ − 1e-3.
//
// What bounds it on the H100. The first product dominates: B·C·W·2 FLOPs
// (1024 × 768 × 2048 at the north-star sub-chunk, 3.2 GFLOP) against a few
// MB of inputs, so it is bound by fp32 FMA throughput and shared-memory
// reads, not by device memory. This first version runs it on the CUDA cores
// in fp32 from shared-memory tiles (wgmma has no fp32 input type; a TF32 or
// split-bf16 scheme would change the rounding the parity tests hold it to).
// The second product is B·W·kc·F8·2, about a twelfth of the first.
//
// Design. A block owns TB galaxies and one contiguous range of λ chunks
// (blockIdx.y splits the window so a 1024-galaxy sub-chunk still fills the
// card). Per λ chunk it contracts lnu in registers, applies the screen,
// rounds to bf16 in shared memory, and adds fw @ knot into an fp32 (TB × KF)
// accumulator in shared memory. Each λ-split writes its partial accumulator;
// the epilogue kernel sums the splits in a fixed order (deterministic) and
// evaluates the interpolation and the ratio. Nothing (B, W)-shaped reaches
// device memory.
//
// A galaxy needs only the 4 knot columns k−1..k+2 around its own shift; the
// TPU kernel computes all kc for the matrix unit, and so does this one (K2,
// fused_sed.cu, contracts only the 4).
//
// Not carried over from the TPU kernel: 8-row block padding, 128-lane padding
// and power-of-two knot slots, lane-mask row selection and the log-step roll
// reduction. Here the epilogue reads the four knot rows by direct index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "knot_interp.cuh"

namespace {

constexpr int TB = 32;   // galaxies per block
constexpr int LW = 64;   // λ columns per chunk
constexpr int CK = 32;   // SFZH cells per contraction step
constexpr int KT = 128;  // knot columns per accumulation step
constexpr int NT = 256;  // threads per block
constexpr int GPT = TB * LW / NT;  // galaxies per thread in the lnu tile (8)
constexpr int SFZ_LD = TB + 4;     // padded row: float4-aligned, fewer conflicts
constexpr int FW_LD = LW + 1;      // padded row: conflict-free column reads

static_assert(GPT == 8, "the lnu tile assigns 8 galaxies per thread");

constexpr size_t kFixedSmem =
    sizeof(float) * (CK * SFZ_LD + CK * LW + TB * FW_LD) +
    sizeof(__nv_bfloat16) * LW * KT;

__global__ void __launch_bounds__(NT)
k1_partial(const float* __restrict__ sfzh, int64_t ld_sfzh,
           const float* __restrict__ tau_v,
           const float* __restrict__ sed, int64_t ld_sed,
           const float* __restrict__ curve,
           const __nv_bfloat16* __restrict__ knot, int64_t ld_knot,
           float* __restrict__ partial, int B, int C, int W, int KF,
           float fesc, int chunks_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sfz_s = reinterpret_cast<float*>(smem_raw);  // [CK][SFZ_LD]
  float* sed_s = sfz_s + CK * SFZ_LD;                   // [CK][LW]
  float* fw_s = sed_s + CK * LW;                        // [TB][FW_LD]
  __nv_bfloat16* knot_s =
      reinterpret_cast<__nv_bfloat16*>(fw_s + TB * FW_LD);  // [LW][KT]
  float* acc_s = reinterpret_cast<float*>(knot_s + LW * KT);  // [TB][KF]

  const int tid = threadIdx.x;
  const int g_base = blockIdx.x * TB;
  const int split = blockIdx.y;
  const int n_chunks = (W + LW - 1) / LW;
  const int ch0 = split * chunks_per_split;
  const int ch1 = min(n_chunks, ch0 + chunks_per_split);

  for (int e = tid; e < TB * KF; e += NT) acc_s[e] = 0.f;

  const int l = tid % LW;          // λ column of this thread in the chunk
  const int g0 = (tid / LW) * GPT;  // first of its GPT galaxies
  float tau[GPT];
#pragma unroll
  for (int i = 0; i < GPT; ++i) {
    const int g = g_base + g0 + i;
    tau[i] = g < B ? tau_v[g] : 0.f;
  }

  for (int ch = ch0; ch < ch1; ++ch) {
    const int lw0 = ch * LW;
    float lnu[GPT];
#pragma unroll
    for (int i = 0; i < GPT; ++i) lnu[i] = 0.f;

    for (int c0 = 0; c0 < C; c0 += CK) {
      __syncthreads();  // earlier readers of sfz_s / sed_s / fw_s are done
      for (int e = tid; e < TB * CK; e += NT) {
        const int g = e / CK, c = e % CK;
        const int gg = g_base + g, cc = c0 + c;
        sfz_s[c * SFZ_LD + g] =
            (gg < B && cc < C) ? sfzh[(int64_t)gg * ld_sfzh + cc] : 0.f;
      }
      for (int e = tid; e < CK * LW; e += NT) {
        const int c = e / LW, ll = e % LW;
        const int cc = c0 + c, lg = lw0 + ll;
        sed_s[c * LW + ll] =
            (cc < C && lg < W) ? sed[(int64_t)cc * ld_sed + lg] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < CK; ++c) {
        const float b = sed_s[c * LW + l];
        const float4 a0 =
            *reinterpret_cast<const float4*>(&sfz_s[c * SFZ_LD + g0]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&sfz_s[c * SFZ_LD + g0 + 4]);
        lnu[0] = fmaf(a0.x, b, lnu[0]);
        lnu[1] = fmaf(a0.y, b, lnu[1]);
        lnu[2] = fmaf(a0.z, b, lnu[2]);
        lnu[3] = fmaf(a0.w, b, lnu[3]);
        lnu[4] = fmaf(a1.x, b, lnu[4]);
        lnu[5] = fmaf(a1.y, b, lnu[5]);
        lnu[6] = fmaf(a1.z, b, lnu[6]);
        lnu[7] = fmaf(a1.w, b, lnu[7]);
      }
    }

    // dust screen, then round to bf16 (the second product's input type)
    const int lg = lw0 + l;
    const float k_l = lg < W ? curve[lg] : 0.f;
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      float att = expf(-tau[i] * k_l);
      if (fesc != 0.f) att = fesc + (1.f - fesc) * att;
      fw_s[(g0 + i) * FW_LD + l] =
          __bfloat162float(__float2bfloat16_rn(lnu[i] * att));
    }

    // acc += fw_chunk @ knot[lw0 : lw0+LW, :]
    for (int j0 = 0; j0 < KF; j0 += KT) {
      const int kt = min(KT, KF - j0);
      __syncthreads();  // fw_s complete; earlier readers of knot_s done
      for (int e = tid; e < LW * kt; e += NT) {
        const int ll = e / kt, j = e % kt;
        const int lk = lw0 + ll;
        knot_s[ll * KT + j] = lk < W ? knot[(int64_t)lk * ld_knot + j0 + j]
                                     : __float2bfloat16_rn(0.f);
      }
      __syncthreads();
      for (int e = tid; e < TB * kt; e += NT) {
        const int g = e / kt, j = e % kt;
        float sum = 0.f;
#pragma unroll 8
        for (int ll = 0; ll < LW; ++ll)
          sum = fmaf(fw_s[g * FW_LD + ll], __bfloat162float(knot_s[ll * KT + j]),
                     sum);
        acc_s[g * KF + j0 + j] += sum;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < TB * KF; e += NT) {
    const int g = e / KF, j = e % KF;
    const int gg = g_base + g;
    if (gg < B) partial[((int64_t)split * B + gg) * KF + j] = acc_s[e];
  }
}

__global__ void k1_epilogue(const float* __restrict__ partial, int n_split,
                            const float* __restrict__ s_rel,
                            const float* __restrict__ scale,
                            const float* __restrict__ den, int64_t ld_den,
                            float* __restrict__ out, int B, int kc, int f8,
                            int delta, float s_max, int order) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * f8) return;
  const int g = idx / f8, f = idx % f8;
  const float c = fminf(fmaxf(s_rel[g], 0.f), s_max) / (float)delta;
  const int k = (int)floorf(c);
  const float t = c - (float)k;
  const int kf = kc * f8;
  const auto num_at = [&](int kk) {
    float v = 0.f;
    for (int sp = 0; sp < n_split; ++sp)
      v += partial[((int64_t)sp * B + g) * kf + kk * f8 + f];
    return v;
  };
  const auto den_at = [&](int kk) { return den[(int64_t)kk * ld_den + f]; };
  const float num = knot_interp(num_at, k, t, kc, order);
  const float dn = knot_interp(den_at, k, t, kc, order);
  out[idx] = num / fmaxf(dn, 1.0e-30f) * scale[g];
}

}  // namespace

extern "C" {

size_t k1_smem_bytes(int kf) { return kFixedSmem + sizeof(float) * TB * kf; }

int k1_tile_galaxies() { return TB; }

int k1_chunk_columns() { return LW; }

const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = ok).
// `partial` is caller-allocated scratch of n_split·B·kc·f8 floats.
int k1_fused_window(const float* sfzh, int64_t ld_sfzh, const float* s_rel,
                    const float* tau_v, const float* scale, const float* sed,
                    int64_t ld_sed, const float* curve,
                    const __nv_bfloat16* knot, int64_t ld_knot,
                    const float* den, int64_t ld_den, float* partial,
                    float* out, int B, int C, int W, int kc, int f8, int delta,
                    int order, float fesc, int n_split, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kf = kc * f8;
  const size_t smem = k1_smem_bytes(kf);
  cudaError_t err = cudaFuncSetAttribute(
      k1_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (W + LW - 1) / LW;
  const int per_split = (n_chunks + n_split - 1) / n_split;
  const dim3 grid((B + TB - 1) / TB, n_split);
  k1_partial<<<grid, NT, smem, st>>>(sfzh, ld_sfzh, tau_v, sed, ld_sed, curve,
                                     knot, ld_knot, partial, B, C, W, kf,
                                     fesc, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // same clip bound as `_knot_interp`: computed in double, rounded to float
  const float s_max = (float)((kc - 1) * (double)delta - 1.0e-3);
  const int threads = 128;
  const int blocks = (B * f8 + threads - 1) / threads;
  k1_epilogue<<<blocks, threads, 0, st>>>(partial, n_split, s_rel, scale, den,
                                          ld_den, out, B, kc, f8, delta, s_max,
                                          order);
  return (int)cudaGetLastError();
}

}  // extern "C"
