// Shift-space knot interpolation of K1 and K2 (their shared core,
// sed_tile.cuh): the device form of
// `synference_tpu_torch/ops/photometry_kernel.py::_knot_interp`.
//
// Monotone-cubic Hermite through knots k−1..k+2 with scale-normalized
// Fritsch–Butland slopes (order 3), or the lerp between k and k+1 (order 1).
// At the table edges the missing neighbour is the linear extrapolation
// 2·v0 − v1 (k = 0) or 2·v1 − v0 (k + 2 > n_knots − 1). Num and den must go
// through the same function for the filter-edge staircase to cancel.

#pragma once

// Fritsch–Butland slope in the scale-normalized form of `_fb_slope`: the
// product form overflows fp32 at L_ν-scale knot values (~1e30).
__device__ __forceinline__ float fb_slope(float da, float db) {
  const bool same = (da > 0.f && db > 0.f) || (da < 0.f && db < 0.f);
  if (!same) return 0.f;
  const float m = fabsf(da) + fabsf(db);
  const float sc = 1.f / fmaxf(m, 1.0e-30f);
  const float das = da * sc, dbs = db * sc;
  const float ms = fabsf(das) + fabsf(dbs);
  const float na = das / ms, nb = dbs / ms;
  return m * (2.f * na * nb) / (na + nb);
}

// Interpolated value at fraction t of knot interval k (0 ≤ k ≤ n_knots − 2).
// `val(kk)` returns knot kk; it is called only for kk in
// [max(k − 1, 0), min(k + 2, n_knots − 1)].
template <class Val>
__device__ __forceinline__ float knot_interp(const Val& val, int k, float t,
                                             int n_knots, int order) {
  const float v0 = val(k), v1 = val(k + 1);
  if (order == 1) return v0 * (1.f - t) + v1 * t;
  const float vm1 = k == 0 ? 2.f * v0 - v1 : val(k - 1);
  const float v2 = k + 2 > n_knots - 1 ? 2.f * v1 - v0 : val(k + 2);
  const float m0 = fb_slope(v0 - vm1, v1 - v0);
  const float m1 = fb_slope(v1 - v0, v2 - v1);
  const float t2 = t * t, t3 = t2 * t;
  const float h00 = 2.f * t3 - 3.f * t2 + 1.f;
  const float h10 = t3 - 2.f * t2 + t;
  const float h01 = -2.f * t3 + 3.f * t2;
  const float h11 = t3 - t2;
  return h00 * v0 + h10 * m0 + h01 * v1 + h11 * m1;
}
