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
// (reference: mgnet_tpu/losses/photometric.py:90-126). A block is one
// warp over 30 output columns and 6 output rows of one image. Lane l owns
// source column j0-1+l (a 1-column halo each side; its reflect index is
// computed once) and walks the band down one output row a step, with a
// window of 3 source rows in registers: x, y and the products x^2, y^2,
// xy, formed once per source row. The pool is separable in the plain
// version's order: the lane's column sums (v(i-1) + v(i)) + v(i+1) of the
// five maps, the neighbours' by shuffle, then (V(j-1) + V(j)) + V(j+1)
// and the scaling by 1/9; no shared memory and no barrier. For C = 3, the
// path's, the channels share the step: all three windows are in
// registers and the output row's channel sum is formed in order and
// written. The band's 8 source rows of x and y (32 consecutive floats a
// warp, per channel) are loaded 4 steps ahead of the step that takes them
// into the window: 6 of them before the first step. Any other C runs the
// channels one after the other with the band's sums in registers, and
// reads the band's 2 halo rows again for each channel. The tile sweep of
// tools/sweep_torch_ssim_fwd.py on an H100 (PERF.md, section 6) chose
// this: at C = 3 the shared step took 21-33% less time than the channels
// one after the other; loads issued ahead and bands shorter than 16 rows were
// faster (a 32-row band took twice as long as an 8-row one); register
// caps of 64 to 96 were no faster than 128, and ptxas uses 80 registers,
// below the 128 that __launch_bounds__(32, 16) allows.
//
// Backward. Given the upstream g [B, H, W] it returns dx, dy [B, C, H, W]
// by the closed form of ssim.py:173-195: per pixel of the statistics, the
// cotangents q_mu_x, q_mu_y, q_xx (= q_yy), q_xy of the pooled maps; then
// in reflect-padded space
//   dx_pad = P^T q_mu_x + 2 x_pad P^T q_xx + y_pad P^T q_xy + dL1
//   dy_pad = P^T q_mu_y + 2 y_pad P^T q_xx + x_pad P^T q_xy - dL1
// with P^T the transposed 3x3 mean pool; then the reflect-pad transpose
// folds padded row (column) 0 onto 2 and H+1 onto H-1 (W+1 onto W-1).
// A block is one warp and one tile of one (batch, channel) plane: 30
// output columns by 16 output rows. Lane l owns q column j0-1+l (the
// tile and a 1-column halo each side) and walks the band down, two q rows
// a step, from q row i0-1 (a 1-row halo above and below: 18 q rows for 16
// output rows). x and y of the last padded rows of a lane's 3-column
// window stay in registers; each new padded row is three 128-byte
// coalesced loads of each, the reflect padding applied to a lane's three
// column indices once and to a row index once. The statistics are the
// sequential row-major 9-term sums of the plain version, once per q
// position. The transposed pool is separable in the plain version's own
// order: the column sum V(r, j) = ((q(r-2, j) + q(r-1, j)) + q(r, j)) / 9
// is formed once per q position in its lane, the neighbours' V come by
// shuffle, and P^T q (r, cc) = (V(r, cc-2) + V(r, cc-1)) + V(r, cc): the
// same operations on the same operands as F.pad(q, 2) and the two sums of
// _pool3_transpose, so no rounding changes (q is zero outside the image,
// so the rows and columns past the border add exact zeros, as the pad
// does). The reflect fold runs only where it applies: on output rows 1
// and H-2 (padded rows 0 and H+1 are V rows of q rows 0 and H-1 with
// zeros) and on output columns 1 and W-2, where x_pad and y_pad equal the
// output's own and g is zero; elsewhere a warp takes the path without
// folds. g of the band is read once into shared memory and serves the q
// pass and the L1 sign term. Channels run as blocks (grid z = B x C), not
// as a loop inside the block, so g is read once per channel; on an H100
// that was the faster of the two at the training and the KITTI shapes in
// the tile sweep described in PERF.md (section 6). With channels as
// blocks the 16-row band was chosen over 32 rows for the KITTI shape
// (2x3x384x1280), where it was faster, at a slight cost at
// 4x3x1024x1024, and 64 rows was slower at both; 8 rows was timed only
// with the channel loop. The 80-register cap was faster than no cap.
//
// Bounds on an H100 at the training step's shape (B=4, C=3, 1024x1024):
//   forward: x, y in (100.7 MB) + r out (16.8 MB) -> 35 us at 3.35 TB/s;
//            55 f32 operations per pixel and channel (a division, a
//            comparison or an absolute value counted as one): 3
//            products, 10 column sums, 10 row sums, 5 scalings, the SSIM
//            expression 16, its clamp 4, the L1 term and the blend 5, and
//            1 for the channel mean (C - 1 sums and one scaling a pixel)
//            -> 0.69 G -> 10 us at 67 TFLOP/s. Bound by memory; the
//            kernel runs at about 1.5x the bound (PERF.md).
//   backward: x, y in (100.7 MB), g in once per channel (50.3 MB), dx, dy
//            out (100.7 MB): 251.7 MB -> 75 us (65 us with g read once);
//            153 f32 operations per pixel and channel (a division, a
//            comparison or a select counted as one): the statistics 72
//            (27 products, 40 sums, 5 scalings), the cotangents 44 (3
//            divisions), the transposed pool 20, the gradient 17 ->
//            1.93 G -> 29 us at 67 TFLOP/s. Bound by memory; the kernel
//            issues about 1.2x these operations (the halo) plus loads,
//            shuffles and index arithmetic, and is limited by issue: it
//            runs at about 3x the bound (PERF.md).
// Both evaluate their arithmetic in the order of the plain PyTorch
// versions in ops/ssim.py, one rounding per operation (the library is
// built with -fmad=false; divisions by 9 and by C are multiplications by
// the f32 reciprocal in both), so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

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

constexpr int kFwdTileW = 30;      // output columns of a block: lanes 1..30
constexpr int kFwdBand = 6;        // output rows of a block
constexpr int kFwdAhead = 4;       // rows loaded ahead of the step using them
constexpr int kFwdMinBlocks = 16;  // per SM: a cap of 128 registers
constexpr int kFwdInnerC = 3;      // the C whose channels share a row step

// x, y and the products x^2, y^2, xy at one source row of one channel, in
// the lane's column.
struct FwdRow {
  float x, y, xx, yy, xy;
};

__device__ __forceinline__ FwdRow fwd_row(float x, float y) {
  return FwdRow{x, y, x * x, y * y, x * y};
}

// (V(j-1) + V(j)) + V(j+1) of a column sum V formed in every lane: the
// neighbours' V by shuffle. Every lane of the warp calls it.
__device__ __forceinline__ float row_sum3(float v) {
  const float l = __shfl_up_sync(0xffffffffu, v, 1);
  const float r = __shfl_down_sync(0xffffffffu, v, 1);
  return (l + v) + r;
}

// One channel's ws * clamp((1 - SSIM) / 2, 0, 1) + wl * |x - y| at the
// output position whose window rows are a (above), b and c (below) in
// the lane's column. Every lane of the warp calls it.
__device__ __forceinline__ float fwd_term(const FwdRow& a, const FwdRow& b,
                                          const FwdRow& c,
                                          const Params& prm) {
  const float mu_x = row_sum3((a.x + b.x) + c.x) * prm.inv9;
  const float mu_y = row_sum3((a.y + b.y) + c.y) * prm.inv9;
  const float pxx = row_sum3((a.xx + b.xx) + c.xx) * prm.inv9;
  const float pyy = row_sum3((a.yy + b.yy) + c.yy) * prm.inv9;
  const float pxy = row_sum3((a.xy + b.xy) + c.xy) * prm.inv9;
  const float mu_xy = mu_x * mu_y;
  const float mu_xx = mu_x * mu_x;
  const float mu_yy = mu_y * mu_y;
  const float sig_x = pxx - mu_xx;
  const float sig_y = pyy - mu_yy;
  const float sig_xy = pxy - mu_xy;
  const float num = (2.0f * mu_xy + prm.c1) * (2.0f * sig_xy + prm.c2);
  const float den = ((mu_xx + mu_yy) + prm.c1) * ((sig_x + sig_y) + prm.c2);
  const float v = num / den;
  const float s = fminf(fmaxf((1.0f - v) / 2.0f, 0.0f), 1.0f);
  const float l1 = fabsf(b.x - b.y);
  return prm.ws * s + prm.wl * l1;
}

// Where a block's lane sits: the block is one warp over kFwdTileW output
// columns and kFwdBand output rows of one image; lane l owns source column
// j0 - 1 + l (a 1-column halo each side) and writes it if it is one of
// the tile's.
struct FwdLane {
  int i0;          // first output row of the band
  int jq;          // the lane's source column
  bool writes;
  long long plane;
  int col;         // jq reflected into the image
};

__device__ __forceinline__ FwdLane fwd_lane(int h, int w) {
  FwdLane l;
  const int lane = threadIdx.x;
  l.i0 = blockIdx.y * kFwdBand;
  l.jq = blockIdx.x * kFwdTileW - 1 + lane;
  l.writes = lane >= 1 && lane <= kFwdTileW && l.jq < w;
  l.plane = static_cast<long long>(h) * w;
  l.col = reflect_index(l.jq, w);
  return l;
}

// C = kC known: the lane walks the band one output row a step, holding
// the 3-row window of every channel in registers, and sums the channels
// of the output row in order. x and y of each channel's next source row
// (32 consecutive floats a warp) are loaded kFwdAhead steps before the
// step that takes them into the window.
template <int kC>
__global__ void __launch_bounds__(32, kFwdMinBlocks)
ssim_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ out, int h, int w, Params prm) {
  constexpr int kRows = kFwdBand + 2;  // source rows i0-1 .. i0+kFwdBand
  const FwdLane ln = fwd_lane(h, w);
  const long long base = static_cast<long long>(blockIdx.z) * kC * ln.plane +
                         ln.col;
  const float* xp = x + base;
  const float* yp = y + base;
  float* op = out + static_cast<long long>(blockIdx.z) * ln.plane + ln.jq;
  float rx[kRows][kC], ry[kRows][kC];
  FwdRow win[3][kC];
  auto load = [&](int k) {
    if (k >= kRows) return;
    const int off = reflect_index(ln.i0 - 1 + k, h) * w;
#pragma unroll
    for (int ch = 0; ch < kC; ++ch) {
      rx[k][ch] = __ldg(xp + ch * ln.plane + off);
      ry[k][ch] = __ldg(yp + ch * ln.plane + off);
    }
  };
  auto take = [&](int k) {
#pragma unroll
    for (int ch = 0; ch < kC; ++ch) {
      win[k % 3][ch] = fwd_row(rx[k][ch], ry[k][ch]);
    }
  };
#pragma unroll
  for (int k = 0; k < 2 + kFwdAhead; ++k) load(k);
  take(0);
  take(1);
#pragma unroll
  for (int r = 0; r < kFwdBand; ++r) {
    const int i = ln.i0 + r;
    load(r + 2 + kFwdAhead);
    take(r + 2);
    const FwdRow(&a)[kC] = win[r % 3];
    const FwdRow(&b)[kC] = win[(r + 1) % 3];
    const FwdRow(&c)[kC] = win[(r + 2) % 3];
    float acc = fwd_term(a[0], b[0], c[0], prm);
#pragma unroll
    for (int ch = 1; ch < kC; ++ch) {
      acc = acc + fwd_term(a[ch], b[ch], c[ch], prm);
    }
    if (ln.writes && i < h) {
      op[static_cast<long long>(i) * w] = acc * prm.inv_c;
    }
  }
}

// Any C: the same tile and walk, one channel after the other, with the
// band's channel sums in registers; each channel reads the band's two
// halo rows again.
__global__ void __launch_bounds__(32, kFwdMinBlocks)
ssim_fwd_planes_kernel(const float* __restrict__ x,
                       const float* __restrict__ y, float* __restrict__ out,
                       int c, int h, int w, Params prm) {
  const FwdLane ln = fwd_lane(h, w);
  float acc[kFwdBand];
  for (int ch = 0; ch < c; ++ch) {
    const long long base =
        (static_cast<long long>(blockIdx.z) * c + ch) * ln.plane + ln.col;
    const float* xp = x + base;
    const float* yp = y + base;
    auto load = [&](int i) {
      const int off = reflect_index(i, h) * w;
      return fwd_row(__ldg(xp + off), __ldg(yp + off));
    };
    FwdRow win[3];
    win[0] = load(ln.i0 - 1);
    win[1] = load(ln.i0);
#pragma unroll
    for (int r = 0; r < kFwdBand; ++r) {
      win[(r + 2) % 3] = load(ln.i0 + r + 1);
      const float t =
          fwd_term(win[r % 3], win[(r + 1) % 3], win[(r + 2) % 3], prm);
      acc[r] = ch == 0 ? t : acc[r] + t;
    }
  }
  float* op = out + static_cast<long long>(blockIdx.z) * ln.plane + ln.jq;
#pragma unroll
  for (int r = 0; r < kFwdBand; ++r) {
    const int i = ln.i0 + r;
    if (ln.writes && i < h) {
      op[static_cast<long long>(i) * w] = acc[r] * prm.inv_c;
    }
  }
}

// --------------------------------------------------------------- backward

constexpr int kBwdTileW = 30;  // output columns of a block: lanes 1..30
constexpr int kBwdBand = 16;   // output rows of a block

// Column sums V of the four q maps at one padded row, for a lane's own q
// column (c) and its left and right neighbours' (l, r).
struct VRow {
  float l[4], c[4], r[4];
};

// V = ((q(r-2) + q(r-1)) + q(r)) / 9 in the lane's column, then the
// neighbours' V by shuffle. Every lane of the warp calls it.
__device__ __forceinline__ void make_vrow(const float (&qa)[4],
                                          const float (&qb)[4],
                                          const float (&qc)[4], float inv9,
                                          VRow& v) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    v.c[m] = ((qa[m] + qb[m]) + qc[m]) * inv9;
    v.l[m] = __shfl_up_sync(0xffffffffu, v.c[m], 1);
    v.r[m] = __shfl_down_sync(0xffffffffu, v.c[m], 1);
  }
}

// Which padded column a transposed pool is taken at: the lane's own, or
// the fold columns 0 and W+1, whose V terms outside the image are zero.
enum PadCol { kOwnCol, kCol0, kColW1 };

template <int kCol>
__device__ __forceinline__ void pool_t(const VRow& v, float (&t)[4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (kCol == kOwnCol) {
      t[m] = (v.l[m] + v.c[m]) + v.r[m];
    } else if (kCol == kCol0) {
      t[m] = (0.0f + 0.0f) + v.l[m];  // V(-2) + V(-1) + V(0)
    } else {
      t[m] = (v.r[m] + 0.0f) + 0.0f;  // V(W-1) + V(W) + V(W+1)
    }
  }
}

// Padded-space gradient from the transposed pools t, x_pad, y_pad and g.
__device__ __forceinline__ void grad_at(const float (&t)[4], float xv,
                                        float yv, float gv, const Params& prm,
                                        float& dx, float& dy) {
  const float diff = xv - yv;
  const float sgn = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f);
  const float l1 = (prm.l1_k * gv) * sgn;
  dx = ((t[0] + (2.0f * xv) * t[2]) + yv * t[3]) + l1;
  dy = ((t[1] + (2.0f * yv) * t[2]) + xv * t[3]) - l1;
}

// The row fold at padded column kCol: the gradient at the output's padded
// row, plus padded row 0 on output row 1 and padded row H+1 on output row
// H-2, in that order. The reflect pad makes x_pad, y_pad at the folded
// rows and columns equal to the output's own; g is zero there.
template <int kCol>
__device__ __forceinline__ void row_folded(const VRow& vr, const VRow& v0,
                                           const VRow& vh, bool top, bool bot,
                                           float xv, float yv, float gv,
                                           const Params& prm, float& dx,
                                           float& dy) {
  float t[4], ex, ey;
  pool_t<kCol>(vr, t);
  grad_at(t, xv, yv, kCol == kOwnCol ? gv : 0.0f, prm, dx, dy);
  if (top) {
    pool_t<kCol>(v0, t);
    grad_at(t, xv, yv, 0.0f, prm, ex, ey);
    dx = dx + ex;
    dy = dy + ey;
  }
  if (bot) {
    pool_t<kCol>(vh, t);
    grad_at(t, xv, yv, 0.0f, prm, ex, ey);
    dx = dx + ex;
    dy = dy + ey;
  }
}

// x, y at a lane's three source columns of one padded row.
struct RawRow {
  float x[3], y[3];
};

// Sums of x, y, x^2, y^2, xy over a 3x3 window, row-major one term at a
// time (_pool3_seq's order), the products formed from the window rows.
struct Sums {
  float x, y, xx, yy, xy;
};

// Adds one window row to the sums; kFirst starts them with its first entry.
template <bool kFirst>
__device__ __forceinline__ void sum_row(const RawRow& r, Sums& s) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a = r.x[k], bb = r.y[k];
    if (kFirst && k == 0) {
      s.x = a;
      s.y = bb;
      s.xx = a * a;
      s.yy = bb * bb;
      s.xy = a * bb;
    } else {
      s.x = s.x + a;
      s.y = s.y + bb;
      s.xx = s.xx + a * a;
      s.yy = s.yy + bb * bb;
      s.xy = s.xy + a * bb;
    }
  }
}

// Cotangents (q_mu_x, q_mu_y, q_xx, q_xy) of the pooled statistics at one
// q position from its window sums and g there, in the order of the plain
// version (ssim.py:173-195 in closed form).
__device__ __forceinline__ void cotangents(const Sums& s, float gq,
                                           const Params& prm, float (&q)[4]) {
  const float mu_x = s.x * prm.inv9;
  const float mu_y = s.y * prm.inv9;
  const float pxx = s.xx * prm.inv9;
  const float pyy = s.yy * prm.inv9;
  const float pxy = s.xy * prm.inv9;
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
  const float gc = gq * prm.inv_c;
  const float gv = (lh > 0.0f && lh < 1.0f) ? prm.gv_k * gc : 0.0f;
  const float ga = (gv * bv) * inv_cdd;
  const float gb2 = (gv * a) * inv_cdd;
  const float gcd = -(gv * vv) / cd;
  const float gd = -(gv * vv) / d;
  const float gab = ga - gb2;
  const float gcdd = gcd - gd;
  q[0] = 2.0f * (mu_y * gab + mu_x * gcdd);
  q[1] = 2.0f * (mu_x * gab + mu_y * gcdd);
  q[2] = gd;
  q[3] = 2.0f * gb2;
}

// dx, dy at output row i from q rows i-1 (qa), i (qb), i+1 (qc) and x, y
// at the output position. Every lane of the warp calls it; `folds` (the
// same in the whole warp) says whether a fold row or column may apply.
__device__ __forceinline__ void output_row(
    const float (&qa)[4], const float (&qb)[4], const float (&qc)[4],
    float xv, float yv, float gv, int i, int jq, int h, int w, bool folds,
    const Params& prm, float& ox, float& oy) {
  VRow vr;
  make_vrow(qa, qb, qc, prm.inv9, vr);
  if (!folds) {
    float t[4];
    pool_t<kOwnCol>(vr, t);
    grad_at(t, xv, yv, gv, prm, ox, oy);
    return;
  }
  const float zero4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const bool top = i == 1, bot = i == h - 2;
  VRow v0 = {}, vh = {};
  if (top) make_vrow(zero4, zero4, qa, prm.inv9, v0);  // padded row 0
  if (bot) make_vrow(qc, zero4, zero4, prm.inv9, vh);  // padded row H+1
  float ex, ey;
  row_folded<kOwnCol>(vr, v0, vh, top, bot, xv, yv, gv, prm, ox, oy);
  if (jq == 1) {
    row_folded<kCol0>(vr, v0, vh, top, bot, xv, yv, gv, prm, ex, ey);
    ox = ox + ex;
    oy = oy + ey;
  }
  if (jq == w - 2) {
    row_folded<kColW1>(vr, v0, vh, top, bot, xv, yv, gv, prm, ex, ey);
    ox = ox + ex;
    oy = oy + ey;
  }
}

// One warp per block: the kBwdTileW output columns of a column tile and
// kBwdBand output rows of one (batch, channel) plane, two q rows a step.
// At most 80 registers, so that 24 warps fit on an SM.
__global__ void __launch_bounds__(32, 24)
ssim_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ g, float* __restrict__ dx,
                float* __restrict__ dy, int c, int h, int w, Params prm) {
  // g at q rows i0-1 .. i0+kBwdBand+1 of the lane's column, zero outside
  __shared__ float gw[(kBwdBand + 3) * 32];
  const int lane = threadIdx.x;
  const int i0 = blockIdx.y * kBwdBand;
  const int i1 = min(i0 + kBwdBand, h);
  const int b = blockIdx.z / c;
  const int jq = blockIdx.x * kBwdTileW - 1 + lane;  // the lane's q column
  const bool col_in = jq >= 0 && jq < w;
  const bool writes = lane >= 1 && lane <= kBwdTileW && jq < w;
  const int src[3] = {reflect_index(jq - 1, w), reflect_index(jq, w),
                      reflect_index(jq + 1, w)};
  const bool fold_cols = __any_sync(0xffffffffu, jq == 1 || jq == w - 2);
  const long long plane = static_cast<long long>(h) * w;
  const long long base = static_cast<long long>(blockIdx.z) * plane;
  const float* gb = g + static_cast<long long>(b) * plane;
#pragma unroll
  for (int k = 0; k < kBwdBand + 3; ++k) {
    const int qi = i0 - 1 + k;
    gw[k * 32 + lane] = (col_in && qi >= 0 && qi < h)
                            ? gb[static_cast<long long>(qi) * w + jq]
                            : 0.0f;
  }
  __syncwarp();
  const float* gq_at = gw - (i0 - 1) * 32 + lane;  // gq_at[qi * 32]
  const float* xp = x + base;
  const float* yp = y + base;

  auto load = [&](int padded, RawRow& r) {
    const int off = reflect_index(padded - 1, h) * w;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r.x[k] = __ldg(xp + (off + src[k]));
      r.y[k] = __ldg(yp + (off + src[k]));
    }
  };
  // q at (qi, jq) from padded rows qi .. qi+2, zero outside the image
  auto q_row = [&](const RawRow& r0, const RawRow& r1, const RawRow& r2,
                   int qi, float(&q)[4]) {
    Sums s;
    float t[4];
    sum_row<true>(r0, s);
    sum_row<false>(r1, s);
    sum_row<false>(r2, s);
    cotangents(s, gq_at[qi * 32], prm, t);
    const bool in = col_in && qi >= 0 && qi < h;
#pragma unroll
    for (int m = 0; m < 4; ++m) q[m] = in ? t[m] : 0.0f;
  };
  auto emit = [&](const float(&qa)[4], const float(&qb)[4],
                  const float(&qc)[4], const RawRow& rp, int i) {
    const bool folds = fold_cols || i == 1 || i == h - 2;
    float ox, oy;
    output_row(qa, qb, qc, rp.x[1], rp.y[1], gq_at[i * 32], i, jq, h, w,
               folds, prm, ox, oy);
    if (writes) {
      const long long o = base + static_cast<long long>(i) * w + jq;
      dx[o] = ox;
      dy[o] = oy;
    }
  };
  // The step at q rows qi, qi+1: the window holds padded rows qi, qi+1 in
  // ra, rb and takes qi+2, qi+3 into rc, rd; qc, qd take q rows qi, qi+1,
  // so output rows qi-1 (q rows qa, qb, qc) and qi (qb, qc, qd) are
  // formed. Two steps an iteration: the windows rotate by renaming.
  auto step = [&](const RawRow& ra, const RawRow& rb, RawRow& rc,
                  RawRow& rd, const float(&qa)[4], const float(&qb)[4],
                  float(&qc)[4], float(&qd)[4], int qi) {
    load(qi + 2, rc);
    load(qi + 3, rd);
    q_row(ra, rb, rc, qi, qc);
    q_row(rb, rc, rd, qi + 1, qd);
    if (qi > i0) emit(qa, qb, qc, ra, qi - 1);
    if (qi >= i0 && qi < i1) emit(qb, qc, qd, rb, qi);
  };
  RawRow r0, r1, r2, r3;
  float q0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, q1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float q2[4], q3[4];
  load(i0 - 1, r0);
  load(i0, r1);
  for (int qi = i0 - 1;;) {
    step(r0, r1, r2, r3, q0, q1, q2, q3, qi);
    qi += 2;
    if (qi > i1) break;
    step(r2, r3, r0, r1, q2, q3, q0, q1, qi);
    qi += 2;
    if (qi > i1) break;
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
  const dim3 grid(static_cast<unsigned>((w + kFwdTileW - 1) / kFwdTileW),
                  static_cast<unsigned>((h + kFwdBand - 1) / kFwdBand),
                  static_cast<unsigned>(batch));
  const Params prm = make_params(c1, c2, ws, wl, inv9, inv_c, 0.0f, 0.0f);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* of = static_cast<float*>(out);
  if (c == kFwdInnerC) {
    ssim_fwd_kernel<kFwdInnerC><<<grid, 32, 0, s>>>(xf, yf, of, h, w, prm);
  } else {
    ssim_fwd_planes_kernel<<<grid, 32, 0, s>>>(xf, yf, of, c, h, w, prm);
  }
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
  if (batch == 0 || c == 0 || h == 0 || w == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const dim3 grid(static_cast<unsigned>((w + kBwdTileW - 1) / kBwdTileW),
                  static_cast<unsigned>((h + kBwdBand - 1) / kBwdBand),
                  static_cast<unsigned>(batch * c));
  ssim_bwd_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(g), static_cast<float*>(dx),
      static_cast<float*>(dy), c, h, w,
      make_params(c1, c2, 0.0f, 0.0f, inv9, inv_c, gv_k, l1_k));
  return static_cast<int>(cudaGetLastError());
}
