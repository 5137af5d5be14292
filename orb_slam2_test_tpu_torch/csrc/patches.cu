// Raw-patch gather: for each keypoint, the 38x38 window of its image
// around its rounded position, for up to 32 images in one launch.
//
// Replaces the Pallas kernel orb_slam2_test_tpu/ops/patches.py
// `_patch_kernel` (launched by `extract_raw_patches`, once per pyramid
// level). The TPU kernel loads an aligned 48x256 superset and rolls it
// into place because Mosaic needs tile-aligned vector loads; none of
// that is needed here.
//
// Semantics: top-left corner (y0, x0) = (rint(y) - 19, rint(x) - 19),
// rounded half to even like jnp.round, clipped into [0, H-38] x
// [0, W-38]; out[k] = img[y0:y0+38, x0:x0+38], an exact copy.
//
// Images: a table of up to 32 (pointer, h, w) and segment offsets
// seg[0..n_img], passed by value as a kernel parameter (no pointer
// table is uploaded). Keypoint k belongs to image i where
// seg[i] <= k < seg[i+1]. One launch covers every pyramid level of an
// image, or both sides of the stereo SAD (up to 16 levels x 2 images;
// the table is about 650 bytes of the 4 KB of kernel parameters).
//
// Layout: one warp per keypoint, 8 warps per 256-thread block. The warp
// copies its window into its own 5,776-byte slice of shared memory
// (46 KB per block) with loads of consecutive columns, then writes the
// patch, which is contiguous and 16-byte aligned (5,776 = 361 x 16),
// with float4 stores. A TMA 2D tile does not fit the load: a level's
// row pitch (1241 x 4 bytes at KITTI's level 0) is not a multiple of
// 16 bytes.
//
// What bounds it: bytes. A KITTI stereo frame writes 8,000 windows,
// 46.2 MB, and reads two 5.8 MB pyramids; at 3.35 TB/s that is about
// 17 us. The per-level kernel of the first port spent 0.6-1.0 ms on 32
// launches, most of it the host between them; this one takes 3.
#include <cuda_runtime.h>

namespace {

constexpr int kPatchEx = 38;
constexpr int kHalf = kPatchEx / 2;
constexpr int kPatchElems = kPatchEx * kPatchEx;  // 1444
constexpr int kPatchVec4 = kPatchElems / 4;       // 361 float4
constexpr int kWarps = 8;
constexpr int kMaxImages = 32;

}  // namespace

// The image table; the Python wrapper fills the same layout with
// ctypes (ops/patches.py `PatchLevels`).
struct PatchLevels {
  const float* img[kMaxImages];
  int h[kMaxImages];
  int w[kMaxImages];
  int seg[kMaxImages + 1];
  int n_img;
};

namespace {

__global__ void __launch_bounds__(kWarps * 32)
    patch_gather_levels_kernel(const PatchLevels lv,
                               const float* __restrict__ xy, int n,
                               float* __restrict__ out) {
  __shared__ __align__(16) float tile[kWarps][kPatchElems];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= n) return;  // the whole warp; the block has no barrier

  // the keypoint's image: the number of later segments started by k
  int i = 0;
#pragma unroll
  for (int j = 1; j < kMaxImages; ++j)
    i += (j < lv.n_img && k >= lv.seg[j]) ? 1 : 0;
  const float* img = lv.img[0];
  int h = lv.h[0], w = lv.w[0];
#pragma unroll
  for (int j = 1; j < kMaxImages; ++j) {
    if (j == i) {
      img = lv.img[j];
      h = lv.h[j];
      w = lv.w[j];
    }
  }

  const int x0 = min(max(static_cast<int>(rintf(xy[2 * k])) - kHalf, 0),
                     w - kPatchEx);
  const int y0 = min(max(static_cast<int>(rintf(xy[2 * k + 1])) - kHalf, 0),
                     h - kPatchEx);
  const float* src = img + static_cast<size_t>(y0) * w + x0;
  float* t = tile[warp];
  for (int e = lane; e < kPatchElems; e += 32) {
    const int r = e / kPatchEx;
    t[e] = __ldg(src + static_cast<size_t>(r) * w + (e - r * kPatchEx));
  }
  __syncwarp();
  const float4* t4 = reinterpret_cast<const float4*>(t);
  float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(k) * kPatchElems);
  for (int v = lane; v < kPatchVec4; v += 32) dst[v] = t4[v];
}

}  // namespace

// levels: the image table (host memory, copied into the launch's
// parameters); images [h_i, w_i] float32 with h_i, w_i >= 38; xy [n, 2]
// float32 (x, y); out [n, 38, 38] float32, 16-byte aligned. All device
// buffers contiguous on the current device.
extern "C" int patch_gather_levels(const PatchLevels* levels, const float* xy,
                                   int n, float* out, void* stream) {
  if (n > 0) {
    const int blocks = (n + kWarps - 1) / kWarps;
    patch_gather_levels_kernel<<<blocks, kWarps * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        *levels, xy, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
