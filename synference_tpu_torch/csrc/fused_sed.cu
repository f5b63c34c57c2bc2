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
//               (the `_bc` kernels first scale lnu's sum over the young
//               cells c < cy by exp(−τ_BC[b]·k[l]); the `_esc` kernels
//               take fw = bf16(fesc[b]·Σ_c sfzh·inc[c,l]
//               + (1−fesc[b])·exp(−τ_V[b]·k[l])·lnu), sed_tile.cuh)
//   acc[b,k,f] = Σ_l fw[b,l] · knot[l, k·F8 + f]  for the knots k−1..k+2 of
//                the galaxy's shift        (bf16 inputs, fp32 accumulation)
//   out[b,f]  = interp(acc; s[b]) / max(interp(den[·,f]; s[b]), 1e-30)
//               · scale[b]
//
// interp as in knot_interp.cuh, the shift clipped at (n_knots−1)·δ − 1e-3.
//
// The TPU kernel contracts every knot column (the matrix unit wants the
// whole (L, n_knots·F8) product) and selects 4 rows per galaxy with lane
// masks. Here the wrapper orders the rows by their first knot
// (`k2_row_order`), the kernel reads galaxy g from sfzh[order[g]] and writes
// out[order[g]], so one block's 128 galaxies span a narrow band of knots:
// the block stages that band of the bf16 knot matrix per λ chunk and runs
// the knot product on the tensor cores, instead of gathering each galaxy's
// 4·F8 knot columns from L2 for every λ row. The arithmetic, its bound and
// its design are the core shared with K1 (sed_tile.cuh), over one window
// that is the whole table. At more than 8 bands the band-group blocks of a
// galaxy tile run as one thread-block cluster (`k2_fused_sed_cluster_kernel`)
// that computes the tile's first product once per λ column, not once per
// band group.
//
// Not carried over from the TPU kernel: 8-row block padding, 128-lane
// padding and power-of-two knot slots, lane-mask row selection, the log-step
// roll reduction, and the reciprocal-form den slopes.

#include "sed_tile.cuh"

namespace {

__global__ void __launch_bounds__(sed_tile::NT, 1)
k2_fused_sed_kernel(const __grid_constant__ sed_tile::Args p) {
  sed_tile::run<false>(p);
}

__global__ void __launch_bounds__(sed_tile::NT_CL, 1)
k2_fused_sed_cluster_kernel(const __grid_constant__ sed_tile::Args p) {
  sed_tile::run<true>(p);
}

__global__ void __launch_bounds__(sed_tile::NT, 1)
k2_fused_sed_bc_kernel(const __grid_constant__ sed_tile::Args p) {
  sed_tile::run<false, true>(p);
}

__global__ void __launch_bounds__(sed_tile::NT_CL, 1)
k2_fused_sed_bc_cluster_kernel(const __grid_constant__ sed_tile::Args p) {
  sed_tile::run<true, true>(p);
}

__global__ void __launch_bounds__(sed_tile::NT, 1)
k2_fused_sed_esc_kernel(const __grid_constant__ sed_tile::Args p) {
  sed_tile::run<false, false, true>(p);
}

__global__ void __launch_bounds__(sed_tile::NT_CL, 1)
k2_fused_sed_esc_cluster_kernel(const __grid_constant__ sed_tile::Args p) {
  sed_tile::run<true, false, true>(p);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// `order` is a permutation of the B rows (int32); `sfzh` the (a_rows, C)
// A operand, sfzh's rows in that order, row stride ld_a (`k_major` in
// ops/fused_sed.py); `sed_k` the (L, C) K-major table, row stride ld_sed
// (`k_major`); both with 16-byte aligned rows (TMA); out is in row order.
// `cluster`, `tau_bc`, `n_young`, `fesc_row` and `inc_k` as in
// k1_fused_window (tau_bc and fesc_row in row order, read through `order`
// as tau_v is).
int k2_fused_sed(const float* sfzh, int64_t a_rows, int64_t ld_a,
                 const int* order, const float* s, const float* tau_v,
                 const float* tau_bc, int n_young, const float* fesc_row,
                 const float* scale, const float* sed_k, int64_t ld_sed,
                 const float* inc_k, int64_t ld_inc,
                 const float* curve, const __nv_bfloat16* knot,
                 int64_t ld_knot, const float* den, int64_t ld_den,
                 float* out, int B, int C, int L, int n_knots, int f8,
                 int delta, int interp_order, float fesc, int cluster,
                 void* stream) {
  sed_tile::Args p{};
  p.order = order;
  p.s = s;
  p.tau_v = tau_v;
  p.scale = scale;
  p.curve = curve;
  p.knot = knot;
  p.ld_knot = ld_knot;
  p.den = den;
  p.ld_den = ld_den;
  p.win = nullptr;
  p.out = out;
  p.B = B;
  p.C = C;
  p.W = L;
  p.nk = n_knots;
  p.f8 = f8;
  p.delta = delta;
  p.order_interp = interp_order;
  p.group_rows = B;
  p.fesc = fesc;
  p.tau_bc = tau_bc;
  p.cy = n_young;
  p.fesc_row = fesc_row;
  return sed_tile::launch(
      fesc_row ? k2_fused_sed_esc_kernel
      : tau_bc ? k2_fused_sed_bc_kernel
               : k2_fused_sed_kernel,
      fesc_row ? k2_fused_sed_esc_cluster_kernel
      : tau_bc ? k2_fused_sed_bc_cluster_kernel
               : k2_fused_sed_cluster_kernel,
      p, sfzh, a_rows, ld_a, sed_k, L, ld_sed, inc_k, ld_inc, 1, cluster,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
