// One photometric ESIKF iteration over M tracked points, fused: the
// Hopper port of the TPU kernel fast_livo2_tpu/ops/pallas_photo.py:
// photo_iteration (Pallas body `_kernel`, pallas_photo.py:63-201), which
// the VIO photometric update calls once per iteration, up to 4 pyramid
// levels x 5 iterations a frame (fast_livo2_tpu/core/vio.py:546-582).
//
// What it computes is the TPU kernel's function, not its block
// structure. Per point i (one row of pts_meta):
//   pf = Rcw pos + Pcw; z = pf.z guarded at 1e-9; okf = ok & (pf.z > 1e-6)
//   (u, v) = pinhole projection, radtan applied only if has_dist > 0.5
//   s = 1 << clip(slog, 0, max_slog)              (the stride clamp)
//   x0 = floor(u/s)*s - 5s clipped as ONE block to [0, W - 12s];
//   y0 = floor(v/s)*s - 5s; each of the 12 rows clipped to [0, H-1]
//   window[r][c] = img(row(y0 + r s), x0 + c s), r, c < 12
//   val/du/dv = bilinear (weights from the sub-stride fraction) on 8x8
//   res = tau * val - ref
//   ten okf-masked patch sums, then the closed-form row
//   [HTH(49) | HTz(7) | err | cnt] with H_c = a_c du + b_c dv (c < 6),
//   H_6 = expo * val.
// The TPU kernel selected the strided taps with a one-hot matrix
// product because Mosaic has no strided dynamic loads; here the block
// loads its 144 taps directly. floor(u/s)*s is clamped to +-2^30 before
// the int conversion (undefined in C++ out of range), as the plain
// version in ops/photo_iteration.py does.
//
// Design. Stage 1: one block of 64 threads per point, one thread per
// patch pixel. The block loads its 12 x 12 window into shared memory,
// each thread forms val/du/dv/res for its pixel, warp shuffles and then
// shared memory reduce the ten sums, six threads form the Jacobian
// coefficients a_c, b_c, and thread j writes column j of the point's
// 64-float row to the scratch rows (M, 64). Stage 2: one block of 64
// threads, thread j sums column j over the M rows in order. No atomics,
// so the result is the same from run to run. FP32 FFMA throughout; no
// tensor cores, no TF32.
//
// What bounds it on an H100: at the main path's M = 396 it must read
// 396 x 144 taps + 396 x (8 + 64) point floats + 64 params and write
// 64 floats, about 342 KB (0.1 us at 3.35 TB/s), and it does about
// 1.8 MFLOP (0.03 us at 67 TFLOP/s FP32). Both are far below the cost
// of two dependent launches, so latency sets its time: one SM-wave of
// 396 small blocks, then a 64-thread serial column sum. The image
// (H x W f32, 1.3 MB at 640 x 512) stays in the 50 MB L2 across blocks.
//
// C interface for ctypes:
//   photo_iteration_launch(img, meta, ref, par, rows, out, H, W, M,
//                          max_slog, stream)
// img (H, W), meta (M, 8), ref (M, 8, 8), par (1, 64) contiguous float32
// device pointers; rows (M, 64) scratch and out (64,) outputs. Launches
// both stages on `stream` and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWin = 12;
constexpr int kPs = 8;
constexpr int kMetaW = 8;
constexpr int kParW = 64;
constexpr int kOutW = 64;
constexpr int kThreads = kPs * kPs;  // one thread per patch pixel
constexpr int kSums = 10;
constexpr float kFloorClamp = 1073741824.0f;  // 2^30

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__global__ void __launch_bounds__(kThreads)
photo_rows_kernel(const float* __restrict__ img, const float* __restrict__ meta,
                  const float* __restrict__ ref, const float* __restrict__ par,
                  float* __restrict__ rows, int H, int W, int max_slog) {
  __shared__ float P[kParW];
  __shared__ float win[kWin][kWin];
  __shared__ float part[kThreads / 32][kSums];
  __shared__ float S[kSums];
  __shared__ float a[6];
  __shared__ float b[6];

  const int i = blockIdx.x;
  const int t = threadIdx.x;
  P[t] = par[t];
  __syncthreads();

  // Projection: every thread computes the same per-point scalars.
  const float* m = meta + static_cast<size_t>(i) * kMetaW;
  const float px = m[0], py = m[1], pz = m[2];
  const int slog = static_cast<int>(m[3]);
  const bool ok0 = m[4] > 0.5f;
  const float pfx = P[0] * px + P[1] * py + P[2] * pz + P[9];
  const float pfy = P[3] * px + P[4] * py + P[5] * pz + P[10];
  const float pfz = P[6] * px + P[7] * py + P[8] * pz + P[11];
  const float tau = P[12];
  const float fx = P[31], fy = P[32], cx = P[33], cy = P[34];
  const float k1 = P[35], k2 = P[36], p1 = P[37], p2 = P[38];
  const float expo = P[39];
  const bool z_ok = pfz > 1e-6f;
  const float z = fabsf(pfz) < 1e-9f ? 1e-9f : pfz;
  const float un = pfx / z;
  const float vn = pfy / z;
  float uu = un, vv = vn;
  if (P[40] > 0.5f) {
    const float r2 = un * un + vn * vn;
    const float radial = 1.0f + k1 * r2 + k2 * r2 * r2;
    uu = un * radial + 2.0f * p1 * un * vn + p2 * (r2 + 2.0f * un * un);
    vv = vn * radial + p1 * (r2 + 2.0f * vn * vn) + 2.0f * p2 * un * vn;
  }
  const float u = fx * uu + cx;
  const float v = fy * vv + cy;
  const float okf = (ok0 && z_ok) ? 1.0f : 0.0f;

  // The clamped stride and the clipped 12 x 12 window.
  const int lo = -(kPs / 2) - 1;
  const int sd = 1 << clampi(slog, 0, max_slog);
  const float sf = static_cast<float>(sd);
  const float ui = floorf(u / sf) * sf;
  const float vi = floorf(v / sf) * sf;
  int x0 = static_cast<int>(fminf(fmaxf(ui, -kFloorClamp), kFloorClamp)) + lo * sd;
  const int y0 = static_cast<int>(fminf(fmaxf(vi, -kFloorClamp), kFloorClamp)) + lo * sd;
  x0 = min(max(x0, 0), W - kWin * sd);
  for (int e = t; e < kWin * kWin; e += kThreads) {
    const int r = e / kWin;
    const int c = e - r * kWin;
    const int y = clampi(y0 + r * sd, 0, H - 1);
    win[r][c] = img[static_cast<size_t>(y) * W + x0 + c * sd];
  }
  __syncthreads();

  // This thread's pixel of the 8 x 8 patch.
  const float su = (u - ui) / sf;
  const float sv = (v - vi) / sf;
  const float w_tl = (1.0f - su) * (1.0f - sv);
  const float w_tr = su * (1.0f - sv);
  const float w_bl = (1.0f - su) * sv;
  const float w_br = su * sv;
  const int pr = t / kPs;
  const int pc = t - pr * kPs;
  auto bil = [&](int r0, int c0) {
    const int r = r0 + pr;
    const int c = c0 + pc;
    return w_tl * win[r][c] + w_tr * win[r][c + 1] + w_bl * win[r + 1][c] +
           w_br * win[r + 1][c + 1];
  };
  const float val = bil(1, 1);
  const float du = 0.5f * (bil(1, 2) - bil(1, 0));
  const float dv = 0.5f * (bil(2, 1) - bil(0, 1));
  const float res = tau * val - ref[static_cast<size_t>(i) * kThreads + t];

  // Ten patch sums: S_uu S_uv S_vv S_uval S_vval S_valval S_ures S_vres
  // S_valres S_resres.
  float q[kSums] = {du * du, du * dv, dv * dv, du * val, dv * val,
                    val * val, du * res, dv * res, val * res, res * res};
#pragma unroll
  for (int k = 0; k < kSums; ++k) q[k] = warp_sum(q[k]);
  if ((t & 31) == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) part[t >> 5][k] = q[k];
  }

  // Jacobian-chain coefficients: Jdpi rows A, B; skew(pf); Jdphi_dR =
  // P[13:22], Jdp_dR = P[22:31], Rcw = P[0:9] (row-major).
  if (t < 6) {
    const float zi = 1.0f / z;
    const float zi2 = zi * zi;
    const float g = tau / sf;
    const float zero = zi * 0.0f;
    const float A[3] = {fx * zi, zero, -fx * pfx * zi2};
    const float B[3] = {zero, fy * zi, -fy * pfy * zi2};
    const float ph[3][3] = {{zero, -pfz, pfy}, {pfz, zero, -pfx}, {-pfy, pfx, zero}};
    float PA[3], PB[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      PA[c] = A[0] * ph[0][c] + A[1] * ph[1][c] + A[2] * ph[2][c];
      PB[c] = B[0] * ph[0][c] + B[1] * ph[1][c] + B[2] * ph[2][c];
    }
    if (t < 3) {
      const int c = t;
      const float* Jphi = P + 13;
      const float* Jp = P + 22;
      a[c] = g * ((PA[0] * Jphi[c] + PA[1] * Jphi[3 + c] + PA[2] * Jphi[6 + c]) -
                  (A[0] * Jp[c] + A[1] * Jp[3 + c] + A[2] * Jp[6 + c]));
      b[c] = g * ((PB[0] * Jphi[c] + PB[1] * Jphi[3 + c] + PB[2] * Jphi[6 + c]) -
                  (B[0] * Jp[c] + B[1] * Jp[3 + c] + B[2] * Jp[6 + c]));
    } else {
      const int c = t - 3;
      a[t] = -g * (A[0] * P[c] + A[1] * P[3 + c] + A[2] * P[6 + c]);
      b[t] = -g * (B[0] * P[c] + B[1] * P[3 + c] + B[2] * P[6 + c]);
    }
  }
  __syncthreads();
  if (t < kSums) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += part[w][t];
    S[t] = okf * s;
  }
  __syncthreads();

  // Column t of the row.
  const float S_uu = S[0], S_uv = S[1], S_vv = S[2], S_uval = S[3];
  const float S_vval = S[4], S_valval = S[5], S_ures = S[6], S_vres = S[7];
  const float S_valres = S[8], S_resres = S[9];
  float e = 0.0f;
  if (t < 49) {
    const int c = t / 7;
    const int d = t - c * 7;
    if (c < 6 && d < 6) {
      e = a[c] * a[d] * S_uu + (a[c] * b[d] + b[c] * a[d]) * S_uv + b[c] * b[d] * S_vv;
    } else if (c < 6) {
      e = expo * (a[c] * S_uval + b[c] * S_vval);
    } else if (d < 6) {
      e = expo * (a[d] * S_uval + b[d] * S_vval);
    } else {
      e = expo * expo * S_valval;
    }
  } else if (t < 55) {
    const int c = t - 49;
    e = a[c] * S_ures + b[c] * S_vres;
  } else if (t == 55) {
    e = expo * S_valres;
  } else if (t == 56) {
    e = S_resres;
  } else if (t == 57) {
    e = okf * static_cast<float>(kPs * kPs);
  }
  rows[static_cast<size_t>(i) * kOutW + t] = e;
}

// out[j] = sum over m of rows[m][j], in order m = 0..M-1.
__global__ void photo_sum_kernel(const float* __restrict__ rows,
                                 float* __restrict__ out, int M) {
  const int j = threadIdx.x;
  float acc = 0.0f;
  for (int m = 0; m < M; ++m) acc += rows[static_cast<size_t>(m) * kOutW + j];
  out[j] = acc;
}

}  // namespace

extern "C" int photo_iteration_launch(const void* img, const void* meta,
                                      const void* ref, const void* par,
                                      void* rows, void* out, int H, int W,
                                      int M, int max_slog, void* stream) {
  if (H < 1 || W < kWin || M < 0 || max_slog < 0 || max_slog > 20 ||
      (kWin << max_slog) > W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0) {
    photo_rows_kernel<<<M, kThreads, 0, s>>>(
        static_cast<const float*>(img), static_cast<const float*>(meta),
        static_cast<const float*>(ref), static_cast<const float*>(par),
        static_cast<float*>(rows), H, W, max_slog);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  photo_sum_kernel<<<1, kOutW, 0, s>>>(static_cast<const float*>(rows),
                                       static_cast<float*>(out), M);
  return static_cast<int>(cudaGetLastError());
}
