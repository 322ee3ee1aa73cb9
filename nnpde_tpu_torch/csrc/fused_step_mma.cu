// The bf16-dot mode of the fused loss+grad kernels (rows 1-3 bf16) in the
// tensor-core design (fwdlap_mma.cuh, DES_MMA): fused_mma_kernel, and on the
// nets beyond the other kernels' limits fused_mma_beyond.  Launched by
// fused_step.cu's entry points through fused_mma_fn; a translation unit of
// its own so that it compiles beside fused_step.cu's planned kernels.
#include "fwdlap_mma.cuh"
#include "fused_terms.cuh"

using namespace fwdlap;

// the tensor-core design at two blocks per SM (the plan counts on them; a
// third block's 85-register budget spills, chip_smoke.py mma_sweep)
// (fwdlap_mma.cuh's body: the loss terms form the cotangents)
// (WIDE: the variant for widths above 128 or the weights or sums in device
// memory; the DRM energy carries no Laplacian stream)
template <int MODE, bool WIDE>
__global__ void __launch_bounds__(NT, 2) fused_mma_kernel(PArgs a) {
  mma::body<mma::KIND_FUSED, WIDE, MODE != MODE_DRM>(
      a, [&](int base, const float* proj, const float* xs, float* ct, float* ps, float* grow) {
    point_terms<MODE>(a, a.T, base, proj, xs, ct, ps, grow);
  });
}
// the same body for the nets beyond the other kernels' limits (beyond_net,
// design bit DES_BEYOND beside DES_MMA): the loss terms without per-point
// arrays (point_terms' BEYOND), so any d; the body takes any width and depth
template <int MODE, bool WIDE>
__global__ void __launch_bounds__(NT, 2) fused_mma_beyond(PArgs a) {
  mma::body<mma::KIND_FUSED, WIDE, MODE != MODE_DRM>(
      a, [&](int base, const float* proj, const float* xs, float* ct, float* ps, float* grow) {
    point_terms<MODE, true>(a, a.T, base, proj, xs, ct, ps, grow);
  });
}


namespace {

template <int MODE>
const void* mma_of(bool wide, bool beyond) {
  if (beyond)
    return wide ? (const void*)fused_mma_beyond<MODE, true>
                : (const void*)fused_mma_beyond<MODE, false>;
  return wide ? (const void*)fused_mma_kernel<MODE, true>
              : (const void*)fused_mma_kernel<MODE, false>;
}

}  // namespace

const void* fused_mma_fn(int mode, bool wide, bool beyond) {
  if (mode == MODE_LINEAR) return mma_of<MODE_LINEAR>(wide, beyond);
  if (mode == MODE_ANALYTIC) return mma_of<MODE_ANALYTIC>(wide, beyond);
  if (mode == MODE_DRM) return mma_of<MODE_DRM>(wide, beyond);
  return nullptr;
}
