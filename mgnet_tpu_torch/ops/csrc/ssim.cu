// Fused SSIM + L1 photometric residual of the self-supervised depth loss:
// forward and backward.
//
// Replaces the TPU kernels of mgnet_tpu/ops/pallas/ssim.py:
//   forward  _kernel (:38) launched by _residual_batched (pallas_call at
//            :144);
//   backward _bwd_kernel (:199) launched by _bwd_batched (pallas_call at
//            :366), including its reflect-pad fold (:393-403).
//
// Forward. For planes x, y [B, C, H, W] it returns r [B, H, W]:
//   r = (1/C) sum_c  ws * clamp((1 - SSIM_c) / 2, 0, 1) + wl * |x_c - y_c|
// where SSIM uses 3x3 mean-pool statistics of the reflect-padded planes
// (mu_x, mu_y, E[x^2], E[y^2], E[xy]) with c1 = 1e-4, c2 = 9e-4
// (reference: mgnet_tpu/losses/photometric.py:90-126). One block per
// (b, 16-row tile, 32-column tile) stages the tile and its 1-pixel halo of
// x and y for one channel at a time in shared memory, with the reflect
// padding applied to the load indices (no padded copy in device memory),
// and keeps the channel sum in registers.
//
// Backward. Given the upstream g [B, H, W] it returns dx, dy [B, C, H, W]
// by the closed form of ssim.py:173-195: per pixel of the statistics, the
// cotangents q_mu_x, q_mu_y, q_xx (= q_yy), q_xy of the pooled maps; then
// in reflect-padded space
//   dx_pad = P^T q_mu_x + 2 x_pad P^T q_xx + y_pad P^T q_xy + dL1
//   dy_pad = P^T q_mu_y + 2 y_pad P^T q_xx + x_pad P^T q_xy - dL1
// with P^T the transposed 3x3 mean pool; then the reflect-pad transpose
// folds padded row (column) 0 onto 2 and H+1 onto H-1 (W+1 onto W-1).
// One block per (b, 16 x 32 output tile) recomputes the statistics over
// the tile plus a 2-pixel halo, forms the four q maps of the tile plus a
// 1-pixel halo in shared memory, and applies P^T, the L1 sign term and
// the fold there; a tile on the image border evaluates the padded-space
// gradient at the folded rows and columns too, which its q maps cover.
//
// Bounds on an H100 at the training step's shape (B=4, C=3, 1024x1024):
//   forward: x, y in (100.7 MB) + r out (16.8 MB) -> 35 us at 3.35 TB/s;
//            ~90 f32 operations per pixel and channel -> 1.1 G -> 17 us
//            at 67 TFLOP/s. Bound by memory.
//   backward: x, y, g in (117.4 MB) + dx, dy out (100.7 MB) -> 65 us;
//            ~300 f32 operations per pixel and channel -> 3.8 G -> 56 us.
//            Bound by memory, nearly balanced.
// Both evaluate their arithmetic in the order of the plain PyTorch
// versions in ops/ssim.py, one rounding per operation (the library is
// built with -fmad=false; divisions by 9 and by C are multiplications by
// the f32 reciprocal in both), so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;

// Source index of reflect-padded position p (pad 1, torch/numpy
// "reflect": -1 -> 1, n -> n - 2), clamped into [0, n) for the positions
// past the padding that a ragged tile touches but never uses.
__device__ __forceinline__ int reflect_index(int p, int n) {
  p = p < 0 ? -p : p;
  p = p >= n ? 2 * n - 2 - p : p;
  return min(max(p, 0), n - 1);
}

struct Params {
  float c1, c2;
  float ws;      // ssim weight
  float wl;      // 1 - ssim weight
  float inv9;    // f32(1 / 9)
  float inv_c;   // f32(1 / C)
  float gv_k;    // -0.5 * ssim weight
  float l1_k;    // (1 - ssim weight) / C
};

// ---------------------------------------------------------------- forward

__global__ void __launch_bounds__(kThreads)
ssim_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ out, int c, int h, int w, Params prm) {
  constexpr int SH = kTileH + 2, SW = kTileW + 2;
  __shared__ float sx[SH][SW];
  __shared__ float sy[SH][SW];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTileH;
  const int j0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const long long plane = static_cast<long long>(h) * w;
  constexpr int kRows = kTileH / kThreadsY;
  float acc[kRows];

  for (int ch = 0; ch < c; ++ch) {
    const float* xp = x + (static_cast<long long>(b) * c + ch) * plane;
    const float* yp = y + (static_cast<long long>(b) * c + ch) * plane;
    // smem (k, l) holds padded (i0 + k, j0 + l) = source (i0 + k - 1, ...)
    for (int e = tid; e < SH * SW; e += kThreads) {
      const int k = e / SW, l = e % SW;
      const long long src =
          static_cast<long long>(reflect_index(i0 + k - 1, h)) * w +
          reflect_index(j0 + l - 1, w);
      sx[k][l] = xp[src];
      sy[k][l] = yp[src];
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int ti = threadIdx.y + rr * kThreadsY;
      const int tj = threadIdx.x;
      float rx[3], ry[3], rxx[3], ryy[3], rxy[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float a0 = sx[ti][tj + k], a1 = sx[ti + 1][tj + k],
                    a2 = sx[ti + 2][tj + k];
        const float b0 = sy[ti][tj + k], b1 = sy[ti + 1][tj + k],
                    b2 = sy[ti + 2][tj + k];
        rx[k] = (a0 + a1) + a2;
        ry[k] = (b0 + b1) + b2;
        rxx[k] = (a0 * a0 + a1 * a1) + a2 * a2;
        ryy[k] = (b0 * b0 + b1 * b1) + b2 * b2;
        rxy[k] = (a0 * b0 + a1 * b1) + a2 * b2;
      }
      const float mu_x = ((rx[0] + rx[1]) + rx[2]) * prm.inv9;
      const float mu_y = ((ry[0] + ry[1]) + ry[2]) * prm.inv9;
      const float pxx = ((rxx[0] + rxx[1]) + rxx[2]) * prm.inv9;
      const float pyy = ((ryy[0] + ryy[1]) + ryy[2]) * prm.inv9;
      const float pxy = ((rxy[0] + rxy[1]) + rxy[2]) * prm.inv9;
      const float mu_xy = mu_x * mu_y;
      const float mu_xx = mu_x * mu_x;
      const float mu_yy = mu_y * mu_y;
      const float sig_x = pxx - mu_xx;
      const float sig_y = pyy - mu_yy;
      const float sig_xy = pxy - mu_xy;
      const float num = (2.0f * mu_xy + prm.c1) * (2.0f * sig_xy + prm.c2);
      const float den =
          ((mu_xx + mu_yy) + prm.c1) * ((sig_x + sig_y) + prm.c2);
      const float v = num / den;
      const float s = fminf(fmaxf((1.0f - v) / 2.0f, 0.0f), 1.0f);
      const float l1 = fabsf(sx[ti + 1][tj + 1] - sy[ti + 1][tj + 1]);
      const float res = prm.ws * s + prm.wl * l1;
      acc[rr] = ch == 0 ? res : acc[rr] + res;
    }
    __syncthreads();
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int i = i0 + threadIdx.y + rr * kThreadsY;
    const int j = j0 + threadIdx.x;
    if (i < h && j < w) {
      out[static_cast<long long>(b) * plane + static_cast<long long>(i) * w +
          j] = acc[rr] * prm.inv_c;
    }
  }
}

// --------------------------------------------------------------- backward

constexpr int kQH = kTileH + 2, kQW = kTileW + 2;  // q maps: tile + 1 halo
constexpr int kXH = kTileH + 4, kXW = kTileW + 4;  // x, y: tile + 2 halo

struct BwdSmem {
  float x[kXH][kXW];   // (k, l) <-> padded (i0 - 1 + k, j0 - 1 + l)
  float y[kXH][kXW];
  float q[4][kQH][kQW];  // (k, l) <-> q position (i0 - 1 + k, j0 - 1 + l)
};

// Padded-space gradient (dx_pad, dy_pad) at padded position (r, cc), with
// i0, j0 the tile origin. Needs q rows r-2..r and columns cc-2..cc (zero
// outside the image) and x_pad, y_pad at (r, cc), all inside the tile's
// shared memory, and g at source (r-1, cc-1) (zero outside the image).
__device__ __forceinline__ void padded_grad(
    const BwdSmem& sm, const float* __restrict__ gb, int r, int cc, int i0,
    int j0, int h, int w, const Params& prm, float& dx, float& dy) {
  float t[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float rs[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int qj = cc - 2 + k;
      float col[3];
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int qi = r - 2 + u;
        col[u] = (qi >= 0 && qi < h && qj >= 0 && qj < w)
                     ? sm.q[m][qi - i0 + 1][qj - j0 + 1]
                     : 0.0f;
      }
      rs[k] = ((col[0] + col[1]) + col[2]) * prm.inv9;
    }
    t[m] = (rs[0] + rs[1]) + rs[2];
  }
  const float xv = sm.x[r - i0 + 1][cc - j0 + 1];
  const float yv = sm.y[r - i0 + 1][cc - j0 + 1];
  const int si = r - 1, sj = cc - 1;
  const float gv = (si >= 0 && si < h && sj >= 0 && sj < w)
                       ? gb[static_cast<long long>(si) * w + sj]
                       : 0.0f;
  const float diff = xv - yv;
  const float sgn = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f);
  const float l1 = (prm.l1_k * gv) * sgn;
  dx = ((t[0] + (2.0f * xv) * t[2]) + yv * t[3]) + l1;
  dy = ((t[1] + (2.0f * yv) * t[2]) + xv * t[3]) - l1;
}

// Row fold of the reflect-pad transpose at padded (r, cc).
__device__ __forceinline__ void row_folded(
    const BwdSmem& sm, const float* __restrict__ gb, int r, int cc, int i0,
    int j0, int h, int w, const Params& prm, float& dx, float& dy) {
  padded_grad(sm, gb, r, cc, i0, j0, h, w, prm, dx, dy);
  float ex, ey;
  if (r == 2) {
    padded_grad(sm, gb, 0, cc, i0, j0, h, w, prm, ex, ey);
    dx = dx + ex;
    dy = dy + ey;
  }
  if (r == h - 1) {
    padded_grad(sm, gb, h + 1, cc, i0, j0, h, w, prm, ex, ey);
    dx = dx + ex;
    dy = dy + ey;
  }
}

__global__ void __launch_bounds__(kThreads)
ssim_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ g, float* __restrict__ dx,
                float* __restrict__ dy, int c, int h, int w, Params prm) {
  __shared__ BwdSmem sm;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTileH;
  const int j0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const long long plane = static_cast<long long>(h) * w;
  const float* gb = g + static_cast<long long>(b) * plane;

  for (int ch = 0; ch < c; ++ch) {
    const long long base = (static_cast<long long>(b) * c + ch) * plane;
    // x, y at padded rows i0-1 .. i0+kTileH+2 (source = padded - 1)
    for (int e = tid; e < kXH * kXW; e += kThreads) {
      const int k = e / kXW, l = e % kXW;
      const long long src =
          static_cast<long long>(reflect_index(i0 - 2 + k, h)) * w +
          reflect_index(j0 - 2 + l, w);
      sm.x[k][l] = x[base + src];
      sm.y[k][l] = y[base + src];
    }
    __syncthreads();
    // q maps at q rows i0-1 .. i0+kTileH; q (qi, qj) pools padded rows
    // qi..qi+2 = smem rows k..k+2 (dy-major sequential sums, as the plain
    // version and the TPU kernel)
    for (int e = tid; e < kQH * kQW; e += kThreads) {
      const int k = e / kQW, l = e % kQW;
      const int qi = i0 - 1 + k, qj = j0 - 1 + l;
      float q_mu_x = 0.0f, q_mu_y = 0.0f, q_xx = 0.0f, q_xy = 0.0f;
      if (qi >= 0 && qi < h && qj >= 0 && qj < w) {
        float sxs = 0.0f, sys = 0.0f, sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
        for (int u = 0; u < 3; ++u) {
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            const float a = sm.x[k + u][l + v];
            const float bb = sm.y[k + u][l + v];
            const bool first = u == 0 && v == 0;
            sxs = first ? a : sxs + a;
            sys = first ? bb : sys + bb;
            sxx = first ? a * a : sxx + a * a;
            syy = first ? bb * bb : syy + bb * bb;
            sxy = first ? a * bb : sxy + a * bb;
          }
        }
        const float mu_x = sxs * prm.inv9;
        const float mu_y = sys * prm.inv9;
        const float pxx = sxx * prm.inv9;
        const float pyy = syy * prm.inv9;
        const float pxy = sxy * prm.inv9;
        const float mu_xx = mu_x * mu_x;
        const float mu_yy = mu_y * mu_y;
        const float mu_xy = mu_x * mu_y;
        const float a = 2.0f * mu_xy + prm.c1;
        const float bv = 2.0f * (pxy - mu_xy) + prm.c2;
        const float cd = (mu_xx + mu_yy) + prm.c1;
        const float d = ((pxx - mu_xx) + (pyy - mu_yy)) + prm.c2;
        const float inv_cdd = 1.0f / (cd * d);
        const float vv = (a * bv) * inv_cdd;
        const float lh = (1.0f - vv) * 0.5f;
        const float gc = gb[static_cast<long long>(qi) * w + qj] * prm.inv_c;
        const float gv = (lh > 0.0f && lh < 1.0f) ? prm.gv_k * gc : 0.0f;
        const float ga = (gv * bv) * inv_cdd;
        const float gb2 = (gv * a) * inv_cdd;
        const float gcd = -(gv * vv) / cd;
        const float gd = -(gv * vv) / d;
        const float gab = ga - gb2;
        const float gcdd = gcd - gd;
        q_mu_x = 2.0f * (mu_y * gab + mu_x * gcdd);
        q_mu_y = 2.0f * (mu_x * gab + mu_y * gcdd);
        q_xx = gd;
        q_xy = 2.0f * gb2;
      }
      sm.q[0][k][l] = q_mu_x;
      sm.q[1][k][l] = q_mu_y;
      sm.q[2][k][l] = q_xx;
      sm.q[3][k][l] = q_xy;
    }
    __syncthreads();
    for (int e = tid; e < kTileH * kTileW; e += kThreads) {
      const int i = i0 + e / kTileW, j = j0 + e % kTileW;
      if (i >= h || j >= w) continue;
      const int r = i + 1, cc = j + 1;  // padded position
      float vx, vy, ex, ey;
      row_folded(sm, gb, r, cc, i0, j0, h, w, prm, vx, vy);
      if (cc == 2) {
        row_folded(sm, gb, r, 0, i0, j0, h, w, prm, ex, ey);
        vx = vx + ex;
        vy = vy + ey;
      }
      if (cc == w - 1) {
        row_folded(sm, gb, r, w + 1, i0, j0, h, w, prm, ex, ey);
        vx = vx + ex;
        vy = vy + ey;
      }
      const long long o = base + static_cast<long long>(i) * w + j;
      dx[o] = vx;
      dy[o] = vy;
    }
    __syncthreads();
  }
}

Params make_params(float c1, float c2, float ws, float wl, float inv9,
                   float inv_c, float gv_k, float l1_k) {
  Params p;
  p.c1 = c1;
  p.c2 = c2;
  p.ws = ws;
  p.wl = wl;
  p.inv9 = inv9;
  p.inv_c = inv_c;
  p.gv_k = gv_k;
  p.l1_k = l1_k;
  return p;
}

dim3 tile_grid(long long batch, int h, int w) {
  return dim3(static_cast<unsigned>((w + kTileW - 1) / kTileW),
              static_cast<unsigned>((h + kTileH - 1) / kTileH),
              static_cast<unsigned>(batch));
}

}  // namespace

// x, y: [batch, c, h, w] f32; out: [batch, h, w] f32; h, w >= 2. The
// float constants come from the wrapper (ops/ssim.py) as f32 casts of the
// plain version's Python scalars. Launches on `stream` and returns the
// launch status; does not synchronise.
extern "C" int mgnet_ssim_residual_fwd(const void* x, const void* y,
                                       void* out, long long batch, int c,
                                       int h, int w, float c1, float c2,
                                       float ws, float wl, float inv9,
                                       float inv_c, void* stream) {
  if (batch == 0 || h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  ssim_fwd_kernel<<<tile_grid(batch, h, w), dim3(kThreadsX, kThreadsY), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), c, h, w,
      make_params(c1, c2, ws, wl, inv9, inv_c, 0.0f, 0.0f));
  return static_cast<int>(cudaGetLastError());
}

// x, y: [batch, c, h, w] f32; g: [batch, h, w] f32; dx, dy: [batch, c, h,
// w] f32; h, w >= 2. gv_k = -0.5 * ssim weight, l1_k = (1 - ssim weight)
// / C. Launches on `stream` and returns the launch status.
extern "C" int mgnet_ssim_residual_bwd(const void* x, const void* y,
                                       const void* g, void* dx, void* dy,
                                       long long batch, int c, int h, int w,
                                       float c1, float c2, float inv9,
                                       float inv_c, float gv_k, float l1_k,
                                       void* stream) {
  if (batch == 0 || h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  ssim_bwd_kernel<<<tile_grid(batch, h, w), dim3(kThreadsX, kThreadsY), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(g), static_cast<float*>(dx),
      static_cast<float*>(dy), c, h, w,
      make_params(c1, c2, 0.0f, 0.0f, inv9, inv_c, gv_k, l1_k));
  return static_cast<int>(cudaGetLastError());
}
