// K1: windowed SED -> photometry kernel for Hopper (sm_90a), one launch per
// batch of z-sorted sub-chunks.
//
// Replaces the TPU Pallas kernel `synference_tpu/ops/fused_sed.py::_mega_kernel`
// as reached through `fused_window_photometry` (the z-sorted window engine's
// fused body). The JAX package runs one kernel call per sub-chunk inside one
// `lax.scan`; here one grid covers every sub-chunk of the batch: block x
// walks (sub-chunk, 128-galaxy tile), and each block reads its sub-chunk's
// window start (k0, l0) from a small int32 device array. Per galaxy, over
// the sub-chunk's window of W λ columns starting at l0 and its kc knots
// starting at k0:
//
//   lnu[b,l] = Σ_c sfzh[b,c] · sed[c,l0+l]                 (fp32 FMA; sed
//                                                           carries dλ/λ)
//   fw[b,l]  = bf16( lnu · (fesc + (1−fesc)·exp(−τ_V[b]·k[l0+l])) )
//
// (with a birth-cloud screen, lnu's sum over the young cells c < cy is
// scaled by exp(−τ_BC[b]·k[l0+l]) before the old cells join it; the
// `_bc` kernels; with a per-row escape fraction, the `_esc` kernels,
//   fw[b,l]  = bf16( fesc[b]·Σ_c sfzh[b,c]·inc[c,l0+l]
//                    + (1−fesc[b])·exp(−τ_V[b]·k[l0+l])·lnu[b,l] ),
// the incident table `inc` with dλ/λ too),
//   acc[b,j] = Σ_l fw[b,l] · knot[l0+l, k0·F8 + j]   (bf16 in, fp32 sum)
//   out[b,f] = interp(acc[b,·,f]; s[b] − k0·δ) / max(interp(den[k0+·,f]), 1e-30)
//              · scale[b]
//
// with interp the monotone-cubic Fritsch–Butland Hermite (order 3) or the
// lerp (order 1) of `photometry_kernel._knot_interp` over the window's kc
// knots (knot_interp.cuh). The arithmetic, its bound and its design are the
// core shared with K2 (sed_tile.cuh); a galaxy tile never straddles two
// sub-chunks, so a sub-chunk that is not a multiple of 128 rows masks its
// last tile. At F8 = 8 each block is alone (`k1_fused_window_kernel`); at
// more bands the band-group blocks of a galaxy tile run as one thread-block
// cluster (`k1_fused_window_cluster_kernel`) that computes the tile's first
// product once and shares its fw tiles through distributed shared memory.
// `k1_fused_window_bc_kernel` and `k1_fused_window_bc_cluster_kernel` are
// the same two with the birth-cloud screen (sed_tile.cuh, "Birth cloud"),
// `k1_fused_window_esc_kernel` and `k1_fused_window_esc_cluster_kernel`
// with the escape fraction (sed_tile.cuh, "Escape").
//
// Not carried over from the TPU kernel: 8-row block padding, 128-lane padding
// and power-of-two knot slots, lane-mask row selection and the log-step roll
// reduction.

#include "sed_tile.cuh"

namespace {

__global__ void __launch_bounds__(sed_tile::NT, 1)
k1_fused_window_kernel(const __grid_constant__ sed_tile::Args p) {
  sed_tile::run<false>(p);
}

__global__ void __launch_bounds__(sed_tile::NT_CL, 1)
k1_fused_window_cluster_kernel(const __grid_constant__ sed_tile::Args p) {
  sed_tile::run<true>(p);
}

__global__ void __launch_bounds__(sed_tile::NT, 1)
k1_fused_window_bc_kernel(const __grid_constant__ sed_tile::Args p) {
  sed_tile::run<false, true>(p);
}

__global__ void __launch_bounds__(sed_tile::NT_CL, 1)
k1_fused_window_bc_cluster_kernel(const __grid_constant__ sed_tile::Args p) {
  sed_tile::run<true, true>(p);
}

__global__ void __launch_bounds__(sed_tile::NT, 1)
k1_fused_window_esc_kernel(const __grid_constant__ sed_tile::Args p) {
  sed_tile::run<false, false, true>(p);
}

__global__ void __launch_bounds__(sed_tile::NT_CL, 1)
k1_fused_window_esc_cluster_kernel(const __grid_constant__ sed_tile::Args p) {
  sed_tile::run<true, false, true>(p);
}

}  // namespace

extern "C" {

const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// Rows [g·sub, (g+1)·sub) of the batch are sub-chunk g, with window start
// win[2g] (knot) and win[2g+1] (λ column); win = null puts one window at
// (0, 0). `s` is the absolute column shift; `sfzh` the (a_rows, C) A
// operand, row stride ld_a (`k_major` in ops/fused_sed.py); `sed_k`
// the (n_l, C) K-major table, row stride ld_sed (`k_major`); both with
// 16-byte aligned rows (TMA). `cluster` blocks share one galaxy tile's
// first product (1 at f8 = 8; at most 8; `cluster_size` in
// ops/fused_sed.py). `tau_bc` (B,) non-null takes the birth-cloud kernels,
// the cells 0 .. n_young − 1 behind it; `fesc` (B,) non-null the escape
// kernels, with `inc_k` the (n_l, C) K-major incident table, row stride
// ld_inc (at most one of the two).
int k1_fused_window(const float* sfzh, int64_t a_rows, int64_t ld_a,
                    const float* s, const float* tau_v, const float* tau_bc,
                    int n_young, const float* fesc_row, const float* scale,
                    const float* sed_k, int64_t n_l, int64_t ld_sed,
                    const float* inc_k, int64_t ld_inc,
                    const float* curve, const __nv_bfloat16* knot,
                    int64_t ld_knot, const float* den, int64_t ld_den,
                    const int* win, float* out, int B, int C, int W, int kc,
                    int f8, int delta, int order, float fesc, int sub,
                    int cluster, void* stream) {
  sed_tile::Args p{};
  p.order = nullptr;
  p.s = s;
  p.tau_v = tau_v;
  p.scale = scale;
  p.curve = curve;
  p.knot = knot;
  p.ld_knot = ld_knot;
  p.den = den;
  p.ld_den = ld_den;
  p.win = win;
  p.out = out;
  p.B = B;
  p.C = C;
  p.W = W;
  p.nk = kc;
  p.f8 = f8;
  p.delta = delta;
  p.order_interp = order;
  p.group_rows = sub;
  p.fesc = fesc;
  p.tau_bc = tau_bc;
  p.cy = n_young;
  p.fesc_row = fesc_row;
  return sed_tile::launch(
      fesc_row ? k1_fused_window_esc_kernel
      : tau_bc ? k1_fused_window_bc_kernel
               : k1_fused_window_kernel,
      fesc_row ? k1_fused_window_esc_cluster_kernel
      : tau_bc ? k1_fused_window_bc_cluster_kernel
               : k1_fused_window_cluster_kernel,
      p, sfzh, a_rows, ld_a, sed_k, n_l, ld_sed, inc_k, ld_inc,
      (B + sub - 1) / sub, cluster, static_cast<cudaStream_t>(stream));
}

// Into *out: how many clusters of `cluster` blocks of K1's (and K2's: the
// same core and resources) cluster kernel the card keeps resident at once.
int k1_max_active_clusters(int cluster, int* out) {
  return sed_tile::max_active_clusters(k1_fused_window_cluster_kernel,
                                       cluster, out);
}

}  // extern "C"
