// Hero-wavelength comb and 95-sample table lerp shared by the render
// megakernel and the residual replay, so that the replay finds every
// wavelength in the same table cell as the forward did.
//
// Constants are the JAX kernel's python doubles rounded once to float.
#pragma once

namespace spt {

constexpr int kSamples = 95;     // N_CIE_SAMPLES
constexpr int kW = 7;            // N_RAY_WAVELENGTHS, hero at 0
constexpr float kLambdaMin = 360.0f;
constexpr float kLambdaMax = 830.0f;
constexpr float kSpan = 470.0f;
constexpr float kCellScale = (float)(94.0 / 470.0);
constexpr float kDelta = (float)(470.0 / 7.0);

// tables rows: CIE x, y, z, normalized D65, background SPD
constexpr int kCieX = 0, kCieY = 1, kCieZ = 2, kD65 = 3, kBg = 4;

__device__ __forceinline__ float lut(const float* row, int cell, float frac) {
  return fmaf(1.0f - frac, row[cell], frac * row[cell + 1]);
}

// Wavelength w of the comb of `hero` (spectrum.cu:31-48, with the wrap) and
// its table cell and fraction.
__device__ __forceinline__ void comb_cell(float hero, int w, float& lam,
                                          int& cell, float& frac) {
  const float lw = hero + (float)((double)w * (470.0 / 7.0));
  lam = lw > kLambdaMax ? lw - kSpan : lw;
  const float xg = (lam - kLambdaMin) * kCellScale;
  cell = min(max((int)xg, 0), kSamples - 2);
  frac = xg - (float)cell;
}

}  // namespace spt
