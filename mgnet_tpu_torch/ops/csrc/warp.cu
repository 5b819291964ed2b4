// Bilinear grid_sample (zeros padding, align_corners=True) with the
// spatial-derivative fields of the view-synthesis warp.
//
// Replaces the TPU kernel mgnet_tpu/ops/pallas/warp.py:297-485
// (warp_bilinear_banded, pallas_call at :384). Its contract is
// mgnet_tpu/geometry/image.py:166-243 (_grid_sample_core): for output
// pixel p with normalized coords (cx, cy) and image plane I of size h x w,
//     x = (cx + 1) * 0.5 * (w - 1),  y = (cy + 1) * 0.5 * (h - 1)
//     x0 = floor(x), x1 = x0 + 1, wx1 = x - x0, wx0 = 1 - wx1 (same in y)
//     v_ab = I[clip(y_a), clip(x_b)] if corner (y_a, x_b) lies in the
//            image, else 0  (torch zeros padding, per corner)
//     out = v00 wy0 wx0 + v01 wy0 wx1 + v10 wy1 wx0 + v11 wy1 wx1
//     gx  = (wy0 (v01 - v00) + wy1 (v11 - v10)) * (w - 1) / 2
//     gy  = (wx0 (v10 - v00) + wx1 (v11 - v01)) * (h - 1) / 2
// gx, gy are d(out)/d(cx), d(out)/d(cy): the backward of the warp with
// respect to the coordinates is then elementwise (ops/warp.py).
//
// The TPU kernel is a banded MXU matmul because the TPU has no vector
// gather. The H100 has one, so this kernel gathers directly: one thread
// per output pixel reads its coordinates once, computes the corner
// weights and masks once, and loops over the channels of a planar
// [B, C, H, W] image (4 gathered loads per channel; neighbouring threads
// read neighbouring source pixels for a smooth warp, so the loads mostly
// coalesce). out, gx and gy are written in one pass, coalesced.
//
// Bound on an H100 at the training step's shape (B=4, C=3, 1024x1024):
//   bytes: image 50.3 MB + coords 33.6 MB + 3 outputs 151.0 MB
//          = 234.9 MB -> 70 us at 3.35 TB/s;
//   operations: ~60 f32 operations per output pixel -> 0.25 G -> 4 us
//          at 67 TFLOP/s.
// So it is bound by memory. The arithmetic follows the plain PyTorch
// version operation by operation (the library is built with
// -fmad=false), so the two agree bit for bit.
// Batch runs on blockIdx.y.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
warp_bilinear_kernel(const float* __restrict__ image,
                     const float* __restrict__ coords,
                     float* __restrict__ out, float* __restrict__ gx,
                     float* __restrict__ gy, int c, int h, int w,
                     long long n_out) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n_out) return;
  const long long b = blockIdx.y;
  const float* cp = coords + (b * n_out + p) * 2;
  const float fw1 = static_cast<float>(w - 1);
  const float fh1 = static_cast<float>(h - 1);
  const float x = (cp[0] + 1.0f) * 0.5f * fw1;
  const float y = (cp[1] + 1.0f) * 0.5f * fh1;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float x1 = x0 + 1.0f;
  const float y1 = y0 + 1.0f;
  const float wx1 = x - x0;
  const float wy1 = y - y0;
  const float wx0 = 1.0f - wx1;
  const float wy0 = 1.0f - wy1;
  const int x0c = static_cast<int>(fminf(fmaxf(x0, 0.0f), fw1));
  const int x1c = static_cast<int>(fminf(fmaxf(x1, 0.0f), fw1));
  const int y0c = static_cast<int>(fminf(fmaxf(y0, 0.0f), fh1));
  const int y1c = static_cast<int>(fminf(fmaxf(y1, 0.0f), fh1));
  const bool in_x0 = x0 >= 0.0f && x0 <= fw1;
  const bool in_x1 = x1 >= 0.0f && x1 <= fw1;
  const bool in_y0 = y0 >= 0.0f && y0 <= fh1;
  const bool in_y1 = y1 >= 0.0f && y1 <= fh1;
  const bool m00 = in_y0 && in_x0, m01 = in_y0 && in_x1;
  const bool m10 = in_y1 && in_x0, m11 = in_y1 && in_x1;
  const long long i00 = static_cast<long long>(y0c) * w + x0c;
  const long long i01 = static_cast<long long>(y0c) * w + x1c;
  const long long i10 = static_cast<long long>(y1c) * w + x0c;
  const long long i11 = static_cast<long long>(y1c) * w + x1c;
  const float w00 = wy0 * wx0, w01 = wy0 * wx1;
  const float w10 = wy1 * wx0, w11 = wy1 * wx1;
  const float sx = fw1 * 0.5f;
  const float sy = fh1 * 0.5f;
  const long long plane = static_cast<long long>(h) * w;
  for (int ch = 0; ch < c; ++ch) {
    const float* img = image + (b * c + ch) * plane;
    const float v00 = m00 ? img[i00] : 0.0f;
    const float v01 = m01 ? img[i01] : 0.0f;
    const float v10 = m10 ? img[i10] : 0.0f;
    const float v11 = m11 ? img[i11] : 0.0f;
    const long long o = (b * c + ch) * n_out + p;
    out[o] = ((v00 * w00 + v01 * w01) + v10 * w10) + v11 * w11;
    if (gx != nullptr) {
      gx[o] = (wy0 * (v01 - v00) + wy1 * (v11 - v10)) * sx;
      gy[o] = (wx0 * (v10 - v00) + wx1 * (v11 - v01)) * sy;
    }
  }
}

}  // namespace

// image: [batch, c, h, w] f32; coords: [batch, oh, ow, 2] f32 (x, y);
// out, gx, gy: [batch, c, oh, ow] f32 (gx, gy may both be null: value
// only). All contiguous on the device. Launches on `stream` and returns
// the launch status (cudaGetLastError); does not synchronise.
extern "C" int mgnet_warp_bilinear(const void* image, const void* coords,
                                   void* out, void* gx, void* gy,
                                   long long batch, int c, int h, int w,
                                   long long n_out, void* stream) {
  if (batch == 0 || n_out == 0 || c == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const dim3 grid(static_cast<unsigned>((n_out + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  warp_bilinear_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(image), static_cast<const float*>(coords),
      static_cast<float*>(out), static_cast<float*>(gx),
      static_cast<float*>(gy), c, h, w, n_out);
  return static_cast<int>(cudaGetLastError());
}
