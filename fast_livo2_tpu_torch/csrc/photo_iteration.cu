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
//   H_6 = expo * val; out = the rows summed over points.
// The TPU kernel selected the strided taps with a one-hot matrix
// product because Mosaic has no strided dynamic loads; here each warp
// loads its 144 taps directly. floor(u/s)*s is clamped to +-2^30 before
// the int conversion (undefined in C++ out of range), as the plain
// version in ops/photo_iteration.py does. max_slog is lowered here while
// 12 * 2^max_slog > W (pallas_photo.py:214-218).
//
// Design: ONE launch, one warp per point, eight points a block
// (ceil(M / 8) blocks: 50 at the main path's M = 396, one wave on the
// 132 SMs). The warp loads its window into its own 12 x 12 tile of
// shared memory, waits with __syncwarp only, and each lane forms
// val/du/dv/res for two of the 64 pixels; the ten sums are butterfly
// shuffles (every lane ends with the same bits), lanes 0-5 form the
// Jacobian coefficients a_c, b_c, and shuffles hand them to the lanes
// that write the 64 row entries into the warp's slot of shared memory.
// After one block barrier 64 threads sum the eight rows in warp order
// into the block's partial row (scratch, ceil(M / 8) x 64). The sum over
// blocks runs in the same launch (the last-block pattern of CUDA's
// threadFenceReduction sample): every block fences its partial and
// draws a ticket with one atomicAdd; the block that draws the last one
// reads all partials past L1 (__ldcg), four threads a column each
// summing a fixed quarter of the blocks in block order, combines the
// quarters in a fixed order, writes out and sets the ticket back to 0.
// The result therefore does not depend on which block finished last: it
// is the same bits from run to run. M = 0 still runs one block, which
// writes zeros; idle warps (M not a multiple of 8) add zero rows. FP32
// FFMA throughout: no tensor cores, no TF32 (the products are 7-wide
// closed forms and the filter stays f32). TMA does not fit: the window
// has element strides up to 16 and per-row clipping.
//
// What bounds it on an H100: at M = 396 it must read the distinct taps
// (about 24k floats on a rendered frame) + 396 x (8 + 64) point floats +
// 64 params and write 64 floats, about 212 KB (0.06 us at 3.35 TB/s),
// and it does about 1.8 MFLOP (0.03 us at 67 TFLOP/s FP32). Both are far
// below one launch, so latency sets its time: the launch plus one
// point's dependent chain (parameter load -> projection -> 144 tap loads
// from L2 -> bilinear and shuffles -> row), then the last block's sum of
// ceil(M / 8) partials. The image (H x W f32, 1.3 MB at 640 x 512) stays
// in the 50 MB L2 across calls.
//
// Why not a cluster with a DSMEM reduction: a cluster holds at most 8
// (16 non-portable) blocks, so one cluster could not span the grid at
// the main path's 50 blocks, and making each warp loop over several
// points would lengthen the dependent chain that sets the time. The
// ticket costs one fence and one atomic a block, at any M.
//
// C interface for ctypes:
//   photo_iteration_launch(img, meta, ref, par, partials, ticket, out,
//                          H, W, M, max_slog, device, stream)
// img (H, W), meta (M, 8), ref (M, 8, 8), par (1, 64) contiguous float32
// pointers on CUDA device `device`; partials (>= ceil(M / 8) x 64 floats)
// and ticket (one uint32, 0 before the first call, left at 0 by every
// call) are scratch owned by the caller for this stream; out (64,) is the
// output. Launches on `stream` and returns cudaGetLastError()
// (launch_on.cuh).

#include <cuda_runtime.h>

#include "launch_on.cuh"

namespace {

constexpr int kWin = 12;
constexpr int kPs = 8;
constexpr int kMetaW = 8;
constexpr int kParW = 64;
constexpr int kOutW = 64;
constexpr int kWarps = 8;  // points a block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kParts = kThreads / kOutW;  // threads a column in the final sum
constexpr int kSums = 10;
constexpr float kFloorClamp = 1073741824.0f;  // 2^30
constexpr unsigned kFull = 0xffffffffu;
static_assert(kParts == 4, "the final sum combines exactly four parts");

// Every lane returns the same bits: each butterfly step adds the same
// two values on both partners (a + b == b + a).
__device__ __forceinline__ float warp_allsum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// The 64-float row of one point, computed by one warp: lane l returns
// entries l (e0) and l + 32 (e1). m and refi are the point's meta and
// reference rows, P the parameter row and win the warp's window tile,
// both in shared memory.
__device__ __forceinline__ void point_row(
    const float* __restrict__ img, const float* __restrict__ m,
    const float* __restrict__ refi, const float* P, float (*win)[kWin],
    int H, int W, int max_slog, int lane, float& e0, float& e1) {
  // Projection: every lane computes the same per-point scalars.
  const float px = __ldg(m), py = __ldg(m + 1), pz = __ldg(m + 2);
  const int slog = static_cast<int>(__ldg(m + 3));
  const bool ok0 = __ldg(m + 4) > 0.5f;
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
  for (int e = lane; e < kWin * kWin; e += 32) {
    const int r = e / kWin;
    const int c = e - r * kWin;
    const int y = clampi(y0 + r * sd, 0, H - 1);
    win[r][c] = __ldg(img + static_cast<size_t>(y) * W + x0 + c * sd);
  }
  __syncwarp();

  // Pixels (pr, pc) and (pr + 4, pc) of the 8 x 8 patch; ten sums:
  // S_uu S_uv S_vv S_uval S_vval S_valval S_ures S_vres S_valres S_resres.
  const float su = (u - ui) / sf;
  const float sv = (v - vi) / sf;
  const float w_tl = (1.0f - su) * (1.0f - sv);
  const float w_tr = su * (1.0f - sv);
  const float w_bl = (1.0f - su) * sv;
  const float w_br = su * sv;
  const int pr = lane >> 3;
  const int pc = lane & 7;
  float S[kSums] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = pr + 4 * h;
    auto bil = [&](int r0, int c0) {
      const int r = r0 + rr;
      const int c = c0 + pc;
      return w_tl * win[r][c] + w_tr * win[r][c + 1] + w_bl * win[r + 1][c] +
             w_br * win[r + 1][c + 1];
    };
    const float val = bil(1, 1);
    const float du = 0.5f * (bil(1, 2) - bil(1, 0));
    const float dv = 0.5f * (bil(2, 1) - bil(0, 1));
    const float res = tau * val - __ldg(refi + lane + 32 * h);
    const float q[kSums] = {du * du, du * dv, dv * dv, du * val, dv * val,
                            val * val, du * res, dv * res, val * res, res * res};
#pragma unroll
    for (int k = 0; k < kSums; ++k) S[k] += q[k];
  }
#pragma unroll
  for (int k = 0; k < kSums; ++k) S[k] = okf * warp_allsum(S[k]);

  // Jacobian-chain coefficients a_c, b_c on lane c < 6: Jdpi rows A, B;
  // skew(pf); Jdphi_dR = P[13:22], Jdp_dR = P[22:31], Rcw = P[0:9]
  // (row-major).
  const float zi = 1.0f / z;
  const float zi2 = zi * zi;
  const float g = tau / sf;
  const float zero = zi * 0.0f;
  const float A[3] = {fx * zi, zero, -fx * pfx * zi2};
  const float B[3] = {zero, fy * zi, -fy * pfy * zi2};
  float am = 0.0f, bm = 0.0f;
  if (lane < 3) {
    const float ph[3][3] = {{zero, -pfz, pfy}, {pfz, zero, -pfx}, {-pfy, pfx, zero}};
    float PA[3], PB[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      PA[c] = A[0] * ph[0][c] + A[1] * ph[1][c] + A[2] * ph[2][c];
      PB[c] = B[0] * ph[0][c] + B[1] * ph[1][c] + B[2] * ph[2][c];
    }
    const int c = lane;
    const float* Jphi = P + 13;
    const float* Jp = P + 22;
    am = g * ((PA[0] * Jphi[c] + PA[1] * Jphi[3 + c] + PA[2] * Jphi[6 + c]) -
              (A[0] * Jp[c] + A[1] * Jp[3 + c] + A[2] * Jp[6 + c]));
    bm = g * ((PB[0] * Jphi[c] + PB[1] * Jphi[3 + c] + PB[2] * Jphi[6 + c]) -
              (B[0] * Jp[c] + B[1] * Jp[3 + c] + B[2] * Jp[6 + c]));
  } else if (lane < 6) {
    const int c = lane - 3;
    am = -g * (A[0] * P[c] + A[1] * P[3 + c] + A[2] * P[6 + c]);
    bm = -g * (B[0] * P[c] + B[1] * P[3 + c] + B[2] * P[6 + c]);
  }

  // Row entry j: HTH (c, d) for j < 49, HTz c for j < 56, err, cnt, pad.
  auto entry = [&](int j) {
    int c = 6, d = 6;  // 6: the exposure column, which takes no a, b
    if (j < 49) {
      c = j / 7;
      d = j - 7 * c;
    } else if (j < 55) {
      c = j - 49;
    }
    // every lane shuffles, whatever its entry needs
    const float ac = __shfl_sync(kFull, am, c), bc = __shfl_sync(kFull, bm, c);
    const float ad = __shfl_sync(kFull, am, d), bd = __shfl_sync(kFull, bm, d);
    if (j < 49) {
      if (c < 6 && d < 6) return ac * ad * S[0] + (ac * bd + bc * ad) * S[1] + bc * bd * S[2];
      if (c < 6) return expo * (ac * S[3] + bc * S[4]);
      if (d < 6) return expo * (ad * S[3] + bd * S[4]);
      return expo * expo * S[5];
    }
    if (j < 55) return ac * S[6] + bc * S[7];
    if (j == 55) return expo * S[8];
    if (j == 56) return S[9];
    if (j == 57) return okf * static_cast<float>(kPs * kPs);
    return 0.0f;
  };
  e0 = entry(lane);
  e1 = entry(lane + 32);
}

__global__ void __launch_bounds__(kThreads)
photo_iteration_kernel(const float* __restrict__ img, const float* __restrict__ meta,
                       const float* __restrict__ ref, const float* __restrict__ par,
                       float* partials, unsigned* ticket, float* __restrict__ out,
                       int H, int W, int M, int max_slog) {
  __shared__ float P[kParW];
  __shared__ float win[kWarps][kWin][kWin];
  __shared__ float rows[kWarps][kOutW];
  __shared__ bool last;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  if (t < kParW) P[t] = par[t];
  __syncthreads();

  const int i = blockIdx.x * kWarps + w;
  float e0 = 0.0f, e1 = 0.0f;
  if (i < M) {  // uniform over the warp
    point_row(img, meta + static_cast<size_t>(i) * kMetaW,
              ref + static_cast<size_t>(i) * kPs * kPs, P, win[w], H, W,
              max_slog, lane, e0, e1);
  }
  rows[w][lane] = e0;
  rows[w][lane + 32] = e1;
  __syncthreads();

  // The block's partial row, in warp order; fenced before the ticket.
  if (t < kOutW) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += rows[k][t];
    partials[static_cast<size_t>(blockIdx.x) * kOutW + t] = s;
    __threadfence();
  }
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // The last block: column j, part p sums blocks [lo, hi) in order.
  const int j = t & (kOutW - 1);
  const int p = t / kOutW;
  const int nb = static_cast<int>(gridDim.x);
  const int per = (nb + kParts - 1) / kParts;
  const int lo = min(nb, p * per);
  const int hi = min(nb, lo + per);
  float s = 0.0f;
  for (int b = lo; b < hi; ++b) s += __ldcg(partials + static_cast<size_t>(b) * kOutW + j);
  rows[p][j] = s;
  __syncthreads();
  if (t < kOutW) out[t] = ((rows[0][t] + rows[1][t]) + rows[2][t]) + rows[3][t];
  if (t == 0) *ticket = 0u;
}

}  // namespace

extern "C" int photo_iteration_launch(const void* img, const void* meta,
                                      const void* ref, const void* par,
                                      void* partials, void* ticket, void* out,
                                      int H, int W, int M, int max_slog,
                                      int device, void* stream) {
  if (H < 1 || W < kWin || M < 0 || max_slog < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (max_slog > 27) max_slog = 27;  // 12 << 28 exceeds any int W
  while (max_slog > 0 && (kWin << max_slog) > W) --max_slog;
  const int blocks = M > 0 ? (M + kWarps - 1) / kWarps : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_on(device, [&] {
    photo_iteration_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(img), static_cast<const float*>(meta),
        static_cast<const float*>(ref), static_cast<const float*>(par),
        static_cast<float*>(partials), static_cast<unsigned*>(ticket),
        static_cast<float*>(out), H, W, M, max_slog);
  });
}
