// Pixel-to-center nearest-neighbour assignment for panoptic fusion.
//
// Replaces the TPU kernel mgnet_tpu/ops/pallas/center_argmin.py:63-133
// (_kernel_kloop launched by _kloop_call; the "broadcast" variant _kernel
// at :49-60 computes the same function).
//
// For every pixel p = (py, px) of plane b it returns
//     argmin_k  s_k(p) = c2[b,k] - 2 * (py * cy[b,k] + px * cx[b,k])
// in f32, one rounding per operation in that order, with a strict `<`
// update from (+inf, 0), so ties go to the lowest k. The caller has already
// replaced invalid centers by the 1e12 sentinel and clamped c2 to 1e30.
//
// Design: per-tile center pruning, exact. A block owns a kTileH x kTileW
// tile of one image and runs three stages:
//   1. its pixels' (py, px) into registers (kPix adjacent pixels a thread,
//      16-byte loads when every row is 16-byte aligned), and the tile's box
//      [Y0, Y1] x [X0, X1] over its in-image pixels, with a flag for "every
//      coordinate finite";
//   2. a candidate set: the centers that can win some pixel of the tile
//      (the rule and its proof below), compacted in ascending index order
//      into shared memory, kThreads centers at a time;
//   3. the exact score loop of the plain version over the kept centers
//      only (__fmul_rn/__fadd_rn/__fsub_rn, so nvcc cannot contract the
//      score into FMAs: at 1024x2048 coordinates the f32 ulp of c2 is
//      0.25-0.5 and a contraction would flip near-ties).
//
// The rule, in f64 from the f32 inputs (center_candidates_reference in
// ops/center_argmin.py evaluates the same formulas in the same order):
//   ay = max(|Y0|, |Y1|), ax = max(|X0|, |X1|);
//   T_i = |c2_i| + 2 (ay |cy_i| + ax |cx_i|),  m_i = 2^-20 T_i + 2^-140;
//   i is eligible when T_i <= 2^120 (so finite);
//   hi_i = max_box |p - c_i|^2 + (c2_i - |c_i|^2) + m_i;
//   j* = the eligible center of least hi (lowest index on ties): the one
//        whose farthest point of the box is nearest;
//   G_i = (c2_i - c2_j*) - 2 (max(Y0 dcy, Y1 dcy) + max(X0 dcx, X1 dcx)),
//        dcy = cy_i - cy_j*, dcx = cx_i - cx_j*: the least, over the box,
//        of S_i(p) - S_j*(p), since that difference is linear in p;
//   i is dropped when it is eligible, i != j* and G_i > m_i + m_j*.
// A tile whose flag is false, or without an eligible center, keeps all K.
//
// Why a dropped center can neither win nor tie. Write S_i(p) for the exact
// value of s_i(p). For p in the box, |py cy_i| + |px cx_i| <= ay |cy_i| +
// ax |cx_i|, so no f32 intermediate exceeds 2^123 for an eligible i and
//   |s_i(p) - S_i(p)| <= u |c2_i| + 6u (ay |cy_i| + ax |cx_i|) + 2^-146
//                     <= 3.01 u T_i + 2^-146,        u = 2^-24
// (the four roundings of the chain; subnormal products add at most 2^-150
// each). The f64 evaluation of G_i errs by at most 5 * 2^-53 (T_i + T_j*),
// since every term of G_i is bounded by T_i + T_j*, and the rounding of m
// is relative 2^-52. With G_i > m_i + m_j* = 2^-20 (T_i + T_j*) + 2^-139,
// the exact least difference exceeds 2^-20 (T_i + T_j*) - 5 * 2^-53
// (T_i + T_j*) + 2^-139, more than the two chains' errors together
// (3.01 u (T_i + T_j*) + 2^-145). So for every pixel of the tile
//   s_i(p) > s_j*(p) >= min_k s_k(p),
// and i is neither the minimum nor tied with it: the lowest-index minimum,
// which the strict scan returns, and every index tied with it, stay in the
// kept list, in ascending order, and the scan over that list returns the
// same index. A pixel whose scores are all NaN or +inf keeps index 0 in
// both versions: a tile that drops any center has a finite s_j*.
// The rule evaluates |p - c|^2 only to choose j*; the drop test uses the
// expanded, linear form, whose f64 error scales with T like the f32
// chain's. (A test of the distance form's bounds against each other would
// cancel terms of size |c|^2 in f64: for centers near 1e20 and pixels near
// 1e3 that error, ~2^-51 |c|^2, exceeds the margin.)
//
// Bound on an H100 at the main path's shape (B=1, 1024x2048, K=128):
//   bytes: two f32 planes in, one int32 plane out = 12 B/pixel,
//          2,097,152 pixels -> 25.2 MB -> 7.5 us at 3.35 TB/s;
//   operations: 5 f32 operations (2 mul, 1 add, 1 scale by 2, 1 sub) per
//          pixel and kept center, at 33.5 T/s (the f32 rate without FMA),
//          plus 56 f64 operations per tile and center in stage 2 (31 to
//          find j*, 25 to test against it). On chip_smoke.py's case A
//          4.7% of the (tile, center) pairs are kept, so the kernel is
//          bound by bytes; with targets scattered over the image 79% are,
//          and it is bound by operations (PERF.md has each case's bound).
// Batch runs on blockIdx.z, tile rows on blockIdx.y, tile columns on
// blockIdx.x. The tile and pixels per thread can be set with -D (the tile
// sweep, tools/sweep_torch_center_argmin.py, chose 32x32 and 8).

#include <cuda_runtime.h>

#ifndef CENTER_TILE_H
#define CENTER_TILE_H 32
#endif
#ifndef CENTER_TILE_W
#define CENTER_TILE_W 32
#endif
#ifndef CENTER_PIX
#define CENTER_PIX 8
#endif

namespace {

constexpr int kTileH = CENTER_TILE_H;
constexpr int kTileW = CENTER_TILE_W;
constexpr int kPix = CENTER_PIX;  // adjacent pixels of one row a thread
constexpr int kRowThreads = kTileW / kPix;
constexpr int kThreads = kTileH * kRowThreads;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPix % 4 == 0 && kTileW % kPix == 0, "kPix: 16-byte groups");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");

constexpr double kMarginRel = 0x1p-20;
constexpr double kMarginAbs = 0x1p-140;
constexpr double kEligibleCap = 0x1p120;

struct Box {
  double y0, y1, x0, x1, ay, ax;
};

// m_i, or a negative value when center i is not eligible.
__device__ __forceinline__ double margin(const Box& bx, double cy, double cx,
                                         double c2) {
  const double t = fabs(c2) + 2.0 * (bx.ay * fabs(cy) + bx.ax * fabs(cx));
  return t <= kEligibleCap ? t * kMarginRel + kMarginAbs : -1.0;
}

__device__ __forceinline__ double far_bound(const Box& bx, double cy,
                                            double cx, double c2, double m) {
  const double dy = fmax(fabs(bx.y0 - cy), fabs(bx.y1 - cy));
  const double dx = fmax(fabs(bx.x0 - cx), fabs(bx.x1 - cx));
  const double delta = c2 - (cy * cy + cx * cx);
  return ((dy * dy + dx * dx) + delta) + m;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
center_argmin_kernel(const float* __restrict__ py,
                     const float* __restrict__ px,
                     const float* __restrict__ cy,
                     const float* __restrict__ cx,
                     const float* __restrict__ c2,
                     int* __restrict__ out, int h, int w, int k,
                     unsigned long long* __restrict__ kept_pairs) {
  __shared__ float4 s_kept[kThreads];  // (cy, cx, c2, index bits)
  __shared__ float s_box[4][kWarps];
  __shared__ int s_finite[kWarps];
  __shared__ double s_hi[kWarps];
  __shared__ int s_hi_idx[kWarps];
  __shared__ int s_count[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b = blockIdx.z;
  const int row = blockIdx.y * kTileH + tid / kRowThreads;
  const int col0 = blockIdx.x * kTileW + (tid % kRowThreads) * kPix;
  const long long at = (b * h + row) * static_cast<long long>(w) + col0;
  const float* cyb = cy + b * k;
  const float* cxb = cx + b * k;
  const float* c2b = c2 + b * k;

  // stage 1: the pixels, and the tile's box
  float y[kPix], x[kPix];
  bool in[kPix];
#pragma unroll
  for (int g = 0; g < kPix; g += 4) {
    if (kVec) {
      const bool ok = row < h && col0 + g < w;
      float4 vy = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vx = vy;
      if (ok) {
        vy = *reinterpret_cast<const float4*>(py + at + g);
        vx = *reinterpret_cast<const float4*>(px + at + g);
      }
      y[g] = vy.x; y[g + 1] = vy.y; y[g + 2] = vy.z; y[g + 3] = vy.w;
      x[g] = vx.x; x[g + 1] = vx.y; x[g + 2] = vx.z; x[g + 3] = vx.w;
#pragma unroll
      for (int j = g; j < g + 4; ++j) in[j] = ok;
    } else {
#pragma unroll
      for (int j = g; j < g + 4; ++j) {
        in[j] = row < h && col0 + j < w;
        y[j] = in[j] ? py[at + j] : 0.0f;
        x[j] = in[j] ? px[at + j] : 0.0f;
      }
    }
  }
  const float inf = __int_as_float(0x7f800000);
  float ymin = inf, ymax = -inf, xmin = inf, xmax = -inf;
  bool finite = true;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    if (in[j]) {
      ymin = fminf(ymin, y[j]);
      ymax = fmaxf(ymax, y[j]);
      xmin = fminf(xmin, x[j]);
      xmax = fmaxf(xmax, x[j]);
      finite = finite && isfinite(y[j]) && isfinite(x[j]);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    ymin = fminf(ymin, __shfl_xor_sync(kFull, ymin, d));
    ymax = fmaxf(ymax, __shfl_xor_sync(kFull, ymax, d));
    xmin = fminf(xmin, __shfl_xor_sync(kFull, xmin, d));
    xmax = fmaxf(xmax, __shfl_xor_sync(kFull, xmax, d));
  }
  finite = __all_sync(kFull, finite);
  if (lane == 0) {
    s_box[0][warp] = ymin;
    s_box[1][warp] = ymax;
    s_box[2][warp] = xmin;
    s_box[3][warp] = xmax;
    s_finite[warp] = finite;
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    ymin = fminf(ymin, s_box[0][v]);
    ymax = fmaxf(ymax, s_box[1][v]);
    xmin = fminf(xmin, s_box[2][v]);
    xmax = fmaxf(xmax, s_box[3][v]);
    finite = finite && s_finite[v];
  }
  Box bx;
  bx.y0 = ymin;
  bx.y1 = ymax;
  bx.x0 = xmin;
  bx.x1 = xmax;
  bx.ay = fmax(fabs(bx.y0), fabs(bx.y1));
  bx.ax = fmax(fabs(bx.x0), fabs(bx.x1));

  // stage 2a: j*, the eligible center of least hi, lowest index on ties
  double best_hi = inf;
  int best_idx = k;  // k: no eligible center
  if (finite) {
    for (int i = tid; i < k; i += kThreads) {
      const double ci_y = cyb[i], ci_x = cxb[i], ci_2 = c2b[i];
      const double m = margin(bx, ci_y, ci_x, ci_2);
      if (m >= 0.0) {
        const double hi = far_bound(bx, ci_y, ci_x, ci_2, m);
        if (hi < best_hi) {
          best_hi = hi;
          best_idx = i;
        }
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const double o_hi = __shfl_xor_sync(kFull, best_hi, d);
    const int o_idx = __shfl_xor_sync(kFull, best_idx, d);
    if (o_hi < best_hi || (o_hi == best_hi && o_idx < best_idx)) {
      best_hi = o_hi;
      best_idx = o_idx;
    }
  }
  if (lane == 0) {
    s_hi[warp] = best_hi;
    s_hi_idx[warp] = best_idx;
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    if (s_hi[v] < best_hi || (s_hi[v] == best_hi && s_hi_idx[v] < best_idx)) {
      best_hi = s_hi[v];
      best_idx = s_hi_idx[v];
    }
  }
  const int jstar = best_idx;
  const bool prune = jstar < k;  // implies a finite tile
  double j_y = 0.0, j_x = 0.0, j_2 = 0.0, j_m = 0.0;
  if (prune) {
    j_y = cyb[jstar];
    j_x = cxb[jstar];
    j_2 = c2b[jstar];
    j_m = margin(bx, j_y, j_x, j_2);
  }

  // stage 2b + 3: kThreads centers at a time, the kept ones compacted in
  // ascending order into shared memory, then the exact scan over them
  float best[kPix];
  int besti[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    best[j] = inf;
    besti[j] = 0;
  }
  long long kept_total = 0;
  for (int k0 = 0; k0 < k; k0 += kThreads) {
    const int i = k0 + tid;
    bool keep = false;
    float fy = 0.0f, fx = 0.0f, f2 = 0.0f;
    if (i < k) {
      fy = cyb[i];
      fx = cxb[i];
      f2 = c2b[i];
      keep = true;
      if (prune && i != jstar) {
        const double ci_y = fy, ci_x = fx, ci_2 = f2;
        const double m = margin(bx, ci_y, ci_x, ci_2);
        if (m >= 0.0) {
          const double dcy = ci_y - j_y;
          const double dcx = ci_x - j_x;
          const double gy = fmax(bx.y0 * dcy, bx.y1 * dcy);
          const double gx = fmax(bx.x0 * dcx, bx.x1 * dcx);
          const double g = (ci_2 - j_2) - 2.0 * (gy + gx);
          keep = !(g > m + j_m);
        }
      }
    }
    const unsigned ballot = __ballot_sync(kFull, keep);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      before += v < warp ? s_count[v] : 0;
      total += s_count[v];
    }
    if (keep) {
      s_kept[before + __popc(ballot & ((1u << lane) - 1u))] =
          make_float4(fy, fx, f2, __int_as_float(i));
    }
    __syncthreads();
    for (int q = 0; q < total; ++q) {
      const float4 c = s_kept[q];
      const int idx = __float_as_int(c.w);
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const float dot = __fadd_rn(__fmul_rn(y[j], c.x), __fmul_rn(x[j], c.y));
        const float score = __fsub_rn(c.z, __fmul_rn(2.0f, dot));
        if (score < best[j]) {
          best[j] = score;
          besti[j] = idx;
        }
      }
    }
    kept_total += total;
    __syncthreads();  // s_kept and s_count are rewritten by the next chunk
  }
  if (kept_pairs != nullptr && tid == 0) {
    atomicAdd(kept_pairs, static_cast<unsigned long long>(kept_total));
  }

#pragma unroll
  for (int g = 0; g < kPix; g += 4) {
    if (kVec) {
      if (in[g]) {
        *reinterpret_cast<int4*>(out + at + g) =
            make_int4(besti[g], besti[g + 1], besti[g + 2], besti[g + 3]);
      }
    } else {
#pragma unroll
      for (int j = g; j < g + 4; ++j) {
        if (in[j]) out[at + j] = besti[j];
      }
    }
  }
}

}  // namespace

// py, px: [batch, h, w] f32; cy, cx, c2: [batch, k] f32; out: [batch, h, w]
// int32. All contiguous on the device. kept_pairs: null, or one int64 on
// the device to which the launch adds the number of (tile, center) pairs it
// scanned. Launches on `stream` and returns the launch status
// (cudaGetLastError); does not synchronise.
extern "C" int mgnet_center_argmin(const void* py, const void* px,
                                   const void* cy, const void* cx,
                                   const void* c2, void* out,
                                   long long batch, int h, int w, int k,
                                   void* kept_pairs, void* stream) {
  if (batch == 0 || h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((w + kTileW - 1) / kTileW),
                  static_cast<unsigned>((h + kTileH - 1) / kTileH),
                  static_cast<unsigned>(batch));
  const bool vec =
      w % 4 == 0 &&
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
  auto* kept = static_cast<unsigned long long*>(kept_pairs);
  if (vec) {
    center_argmin_kernel<true><<<grid, kThreads, 0, s>>>(
        fpy, fpx, fcy, fcx, fc2, iout, h, w, k, kept);
  } else {
    center_argmin_kernel<false><<<grid, kThreads, 0, s>>>(
        fpy, fpx, fcy, fcx, fc2, iout, h, w, k, kept);
  }
  return static_cast<int>(cudaGetLastError());
}

