// Raw-patch gather: for each keypoint, the 38x38 window of a pyramid
// level image around its rounded position.
//
// Replaces the Pallas kernel orb_slam2_test_tpu/ops/patches.py
// `_patch_kernel` (launched by `extract_raw_patches`). The TPU kernel
// loads an aligned 48x256 superset and rolls it into place because
// Mosaic needs tile-aligned vector loads; none of that is needed here.
//
// Semantics: top-left corner (y0, x0) = (rint(y) - 19, rint(x) - 19),
// rounded half to even like jnp.round, clipped into [0, H-38] x
// [0, W-38]; out[k] = img[y0:y0+38, x0:x0+38].
//
// Layout: one block per keypoint; its threads stride over the 1444
// pixels of the window, so neighbouring threads read neighbouring
// columns of a row.
//
// What bounds it: launch latency and memory latency. One mono frame
// moves 1000 windows, about 5.8 MB written, in 8 launches (one per
// pyramid level, since each level is its own image). Batching all
// levels into one launch, and fusing the consumer (moments, blur,
// BRIEF selection) so the windows stay on chip, is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kPatchEx = 38;
constexpr int kHalf = kPatchEx / 2;
constexpr int kThreads = 256;

__global__ void patch_gather_kernel(const float* __restrict__ img, int h,
                                    int w, const float* __restrict__ xy,
                                    float* __restrict__ out) {
  const int k = blockIdx.x;
  const int x0 = min(max(static_cast<int>(rintf(xy[2 * k])) - kHalf, 0),
                     w - kPatchEx);
  const int y0 = min(max(static_cast<int>(rintf(xy[2 * k + 1])) - kHalf, 0),
                     h - kPatchEx);
  const float* src = img + static_cast<size_t>(y0) * w + x0;
  float* dst = out + static_cast<size_t>(k) * (kPatchEx * kPatchEx);
  for (int i = threadIdx.x; i < kPatchEx * kPatchEx; i += kThreads) {
    const int r = i / kPatchEx;
    const int c = i - r * kPatchEx;
    dst[i] = src[static_cast<size_t>(r) * w + c];
  }
}

}  // namespace

// img [h, w] float32, xy [n, 2] float32 (x, y), out [n, 38, 38] float32;
// all contiguous on the current device. Requires h, w >= 38.
extern "C" int patch_gather(const float* img, int h, int w, const float* xy,
                            int n, float* out, void* stream) {
  if (n > 0) {
    patch_gather_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        img, h, w, xy, out);
  }
  return static_cast<int>(cudaGetLastError());
}
