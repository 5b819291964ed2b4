// Pixel-to-center nearest-neighbour assignment for panoptic fusion.
//
// Replaces the TPU kernel mgnet_tpu/ops/pallas/center_argmin.py:63-133
// (_kernel_kloop launched by _kloop_call; the "broadcast" variant _kernel
// at :49-60 computes the same function).
//
// For every pixel p = (py, px) of plane b it returns
//     argmin_k  c2[b,k] - 2 * (py * cy[b,k] + px * cx[b,k])
// with a strict `<` update, so ties go to the lowest k. The caller has
// already replaced invalid centers by the 1e12 sentinel and clamped c2.
//
// Bound on an H100 at the main path's shape (B=1, 1024x2048, K=128):
//   bytes: two f32 planes in, one int32 plane out = 12 B/pixel,
//          2,097,152 pixels -> 25.2 MB -> 7.5 us at 3.35 TB/s;
//   operations: 5 f32 operations per pixel and center (2 mul, 1 add,
//          1 scale by 2, 1 sub) -> 1.34 G -> 20 us at 67 TFLOP/s.
// So the kernel is bound by f32 compute, not by memory.
//
// What the design does about it:
//   * the K centers (3 x K floats) sit in shared memory and every warp
//     reads the same address at once (a broadcast, no bank conflict);
//   * each thread owns 4 adjacent pixels, so one triple of shared loads
//     feeds 4 pixels' arithmetic, and the planes are read once with
//     16-byte loads (scalar loads when the plane is not 16-byte aligned);
//   * the running (best, besti) pair lives in registers: no [pixels, K]
//     score tensor is ever formed;
//   * the score is evaluated with __fmul_rn/__fadd_rn/__fsub_rn in the
//     order of the plain PyTorch version, so nvcc cannot contract it into
//     FMAs. At 1024x2048 coordinates the f32 ulp of c2 is 0.25-0.5, so a
//     contraction would flip near-ties against the plain version. This
//     costs the FMA rate: 5 issued operations per pixel and center
//     instead of 3.
// Batch runs on blockIdx.z.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
center_argmin_kernel(const float* __restrict__ py,
                     const float* __restrict__ px,
                     const float* __restrict__ cy,
                     const float* __restrict__ cx,
                     const float* __restrict__ c2,
                     int* __restrict__ out, long long n, int k) {
  extern __shared__ float smem[];
  float* s_cy = smem;
  float* s_cx = smem + k;
  float* s_c2 = smem + 2 * k;
  const long long b = blockIdx.z;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    s_cy[i] = cy[b * k + i];
    s_cx[i] = cx[b * k + i];
    s_c2[i] = c2[b * k + i];
  }
  __syncthreads();

  const long long p0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kPix;
  if (p0 >= n) return;
  const float* pyb = py + b * n;
  const float* pxb = px + b * n;
  int* outb = out + b * n;

  float y[kPix], x[kPix];
  if (kVec) {
    const float4 vy = *reinterpret_cast<const float4*>(pyb + p0);
    const float4 vx = *reinterpret_cast<const float4*>(pxb + p0);
    y[0] = vy.x; y[1] = vy.y; y[2] = vy.z; y[3] = vy.w;
    x[0] = vx.x; x[1] = vx.y; x[2] = vx.z; x[3] = vx.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const bool in = p0 + j < n;
      y[j] = in ? pyb[p0 + j] : 0.0f;
      x[j] = in ? pxb[p0 + j] : 0.0f;
    }
  }

  float best[kPix];
  int besti[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    best[j] = __int_as_float(0x7f800000);  // +inf
    besti[j] = 0;
  }

  for (int i = 0; i < k; ++i) {
    const float cyi = s_cy[i];
    const float cxi = s_cx[i];
    const float c2i = s_c2[i];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const float dot =
          __fadd_rn(__fmul_rn(y[j], cyi), __fmul_rn(x[j], cxi));
      const float score = __fsub_rn(c2i, __fmul_rn(2.0f, dot));
      if (score < best[j]) {
        best[j] = score;
        besti[j] = i;
      }
    }
  }

  if (kVec) {
    *reinterpret_cast<int4*>(outb + p0) =
        make_int4(besti[0], besti[1], besti[2], besti[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (p0 + j < n) outb[p0 + j] = besti[j];
    }
  }
}

}  // namespace

// py, px: [batch, n] f32; cy, cx, c2: [batch, k] f32; out: [batch, n] int32.
// All contiguous on the device. Launches on `stream` and returns the launch
// status (cudaGetLastError); does not synchronise.
extern "C" int mgnet_center_argmin(const void* py, const void* px,
                                   const void* cy, const void* cx,
                                   const void* c2, void* out,
                                   long long batch, long long n, int k,
                                   void* stream) {
  if (batch == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const long long per_block = static_cast<long long>(kThreads) * kPix;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block), 1,
                  static_cast<unsigned>(batch));
  const size_t smem = 3 * static_cast<size_t>(k) * sizeof(float);
  const bool vec =
      n % kPix == 0 &&
      (reinterpret_cast<unsigned long long>(py) |
       reinterpret_cast<unsigned long long>(px) |
       reinterpret_cast<unsigned long long>(out)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fpy = static_cast<const float*>(py);
  const float* fpx = static_cast<const float*>(px);
  const float* fcy = static_cast<const float*>(cy);
  const float* fcx = static_cast<const float*>(cx);
  const float* fc2 = static_cast<const float*>(c2);
  int* iout = static_cast<int*>(out);
  if (vec) {
    center_argmin_kernel<true><<<grid, kThreads, smem, s>>>(
        fpy, fpx, fcy, fcx, fc2, iout, n, k);
  } else {
    center_argmin_kernel<false><<<grid, kThreads, smem, s>>>(
        fpy, fpx, fcy, fcx, fc2, iout, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}
