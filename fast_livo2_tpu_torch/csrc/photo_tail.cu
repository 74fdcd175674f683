// The filter tail of one photometric ESIKF iteration, fused: everything
// core/vio._iterate_level computes once normal_equations(state) has
// returned (HTH (n x n), HTz (n), error), in one launch.
//
// It replaces no TPU kernel: the JAX package's tail is XLA ops inside
// its photometric while loop (fast_livo2_tpu/core/vio.py). On the H100
// that tail ran as ~150-165 small kernels an iteration (the 19 x 19
// inverse alone several cuSOLVER / cuBLAS kernels), 20 iterations a VIO
// frame in the device loop, each kernel a graph node of ~2 us whatever
// its work: this kernel is one node.
//
// What it computes, in FP32 (ops/photo_tail.photo_tail_plain is the same
// function in PyTorch ops, the tail as the port ran it):
//   A = P_scaled_inv + embed(HTH);  K = A^-1 E_n  (the n columns the
//     tail reads: K_1[:, 0:n] of the full inverse, with fewer FLOPs)
//   G[:, 0:n] = K HTH (other columns 0)
//   vec = boxminus(state_prop, state)  (so3.log with its branches: the
//     series below 1e-4 rad, the guarded sine, the axis from the
//     symmetric part within 1e-3 of pi)
//   sol = -K HTz + vec - G[:, 0:n] vec[0:n]
//   new = boxplus(state, sol)  (so3.exp with its series below 1e-4 rad)
//   accept = error <= last_error; in the device-loop form only while the
//     level has not stopped (active = !stop), and a stopped iteration
//     keeps state (back = active ? old : state); in the split form
//     back = old. Then old' = accept ? state : old,
//     state' = accept ? new : back, and G_keep, final_err, last_error
//     take G, error, error where accepted;
//   converged = |sol[0:3]| * 57.3 < 0.001 and |sol[3:6]| * 100 < 0.001;
//   device loop: iterations += active, stop |= !accept | converged;
//   split form: done = !accept | converged (read by the host).
// The level's carried values live in one float buffer, `carry`, and one
// int buffer, `flags` (layouts below and in ops/photo_tail.py), which
// the kernel reads whole and then rewrites in place: the loop carries
// them from iteration to iteration with no copy node, and the state
// tensors core/vio reads are views into `carry`.
//
// What bounds it: ~10^4 FMAs and ~2.3 KB read and written, nothing on
// the card's scale; its time is the launch plus a dependent chain: the
// 19 pivot steps of the solve (csrc/warp_solve.cuh), the n x n products,
// so3.exp, the selects. Design for that bound: one block of two warps.
// Warp 0 loads A's rows into registers (lane r holds row r) and runs the
// Gauss-Jordan solve with warp shuffles alone; warp 1 meanwhile computes
// vec (boxminus: the log's acos, sin and divisions) into shared memory.
// After one block barrier, warp 0's lane i forms row i of G, K HTz and
// sol[i]; lane 0 forms so3.exp and the new rotation while lanes 9-24
// add the other entries; the lanes then write state', old' and G_keep
// entry by entry. Every sum has a fixed order and no atomic is used, so
// the result is the same bits from run to run. FP32 FFMA only: no TF32,
// no fast math (acosf, sinf, cosf, sqrtf and the divisions are the
// correctly rounded / full-precision library forms). It allocates
// nothing and reads nothing back, so it captures in the frame graph.
//
// C interface for ctypes:
//   photo_tail_launch(carry, flags, P, p_s0, p_s1, hth, h_s0, h_s1,
//                     htz, z_s, err, n, device_loop, device, stream)
// carry (438 floats) and flags (3 ints), contiguous; P (19 x 19), hth
// (n x n) and htz (n) float32 with the given element strides; err one
// float; 1 <= n <= 7. Launches on `stream`, returns cudaGetLastError()
// (launch_on.cuh).

#include <cuda_runtime.h>

#include "launch_on.cuh"
#include "warp_solve.cuh"

namespace {

constexpr int kD = 19;    // the error state's dimension
constexpr int kMaxN = 7;  // the widest HTH the kernel takes
constexpr int kNav = 25;  // a NavState packed: rot(9) pos vel bg ba grav expo
// carry layout (ops/photo_tail.py)
constexpr int kProp = 0;
constexpr int kState = kProp + kNav;
constexpr int kOld = kState + kNav;
constexpr int kGKeep = kOld + kNav;
constexpr int kFinalErr = kGKeep + kD * kD;
constexpr int kLastErr = kFinalErr + 1;
constexpr int kCarryW = kLastErr + 1;
static_assert(kCarryW == 438, "ops/photo_tail.CARRY_W");
// flags layout
constexpr int kStop = 0;
constexpr int kIters = 1;
constexpr int kDone = 2;

constexpr float kSmall = 1e-4f;  // ops/so3._SMALL
constexpr float kEps = 1e-8f;    // ops/so3._EPS
constexpr float kEps2 = 1e-16f;  // _EPS * _EPS
// math.pi - 1e-3 as the float32 comparison sees it
constexpr float kNearPi = static_cast<float>(3.141592653589793 - 1e-3);

// x clamped to [lo, hi] with a NaN kept (torch.clamp), which fminf /
// fmaxf would drop.
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// ops/so3.log of the row-major 3 x 3 M.
__device__ void so3_log(const float (&M)[9], float (&w)[3]) {
  const float tr = M[0] + M[4] + M[8];
  const float theta = acosf(clampf((tr - 1.0f) * 0.5f, -1.0f, 1.0f));
  const float s = sinf(theta);
  const float safe = fabsf(s) < kEps ? kEps : s;
  const float scale = theta < kSmall ? 0.5f + theta * theta / 12.0f
                                     : theta / (2.0f * safe);
  if (!(theta > kNearPi)) {
    w[0] = (M[7] - M[5]) * scale;
    w[1] = (M[2] - M[6]) * scale;
    w[2] = (M[3] - M[1]) * scale;
    return;
  }
  // Near pi: the axis from the symmetric part, R ~ 2 a a^T - I.
  const float diag[3] = {M[0], M[4], M[8]};
  float ax[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float h = (diag[j] + 1.0f) * 0.5f;
    ax[j] = sqrtf(h < 0.0f ? 0.0f : h);
  }
  int k = 0;  // torch.argmax: the first maximum, a NaN the maximum
#pragma unroll
  for (int j = 1; j < 3; ++j) {
    const bool nan_j = ax[j] != ax[j], nan_k = ax[k] != ax[k];
    if (!nan_k && (nan_j || ax[j] > ax[k])) k = j;
  }
  const float off[3][3] = {{diag[0], M[1], M[2]},
                           {M[1], diag[1], M[5]},
                           {M[2], M[5], diag[2]}};
  float a[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float r = off[k][j];
    a[j] = ax[j] * signf(fabsf(r) < kEps ? 1.0f : r);
  }
  const float nrm = sqrtf(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
  const float div = nrm < kEps ? 1.0f : nrm;
#pragma unroll
  for (int j = 0; j < 3; ++j) w[j] = a[j] / div * theta;
}

// ops/so3.exp of w, row-major.
__device__ void so3_exp(const float (&w)[3], float (&R)[9]) {
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float theta = sqrtf(theta2 + kEps2);
  const bool small = theta < kSmall;
  const float a = small ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
  const float b = small ? 0.5f - theta2 / 24.0f
                        : (1.0f - cosf(theta)) / (theta2 + kEps2);
  const float K[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0], -w[1], w[0], 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j]
                       + K[3 * i + 2] * K[6 + j];
      R[3 * i + j] = ((i == j ? 1.0f : 0.0f) + a * K[3 * i + j]) + b * kk;
    }
  }
}

// boxminus(prop, state): Log(state.R^T prop.R), then plain differences,
// into the 19-vector order rot pos expo vel bg ba grav.
__device__ void boxminus(const float* prop, const float* st, float* vec) {
  float M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      M[3 * i + j] = st[i] * prop[j] + st[3 + i] * prop[3 + j]
                     + st[6 + i] * prop[6 + j];
    }
  }
  float w[3];
  so3_log(M, w);
  vec[0] = w[0];
  vec[1] = w[1];
  vec[2] = w[2];
#pragma unroll
  for (int q = 9; q < 24; ++q) vec[q < 12 ? q - 6 : q - 5] = prop[q] - st[q];
  vec[6] = prop[24] - st[24];
}

__global__ void __launch_bounds__(64) photo_tail_kernel(
    float* __restrict__ carry, int* __restrict__ flags,
    const float* __restrict__ P, int p_s0, int p_s1,
    const float* __restrict__ hth, int h_s0, int h_s1,
    const float* __restrict__ htz, int z_s, const float* __restrict__ err,
    int n, int device_loop) {
  __shared__ float s_nav[3 * kNav];  // prop | state | old
  __shared__ float s_hth[kMaxN][kMaxN];
  __shared__ float s_htz[kMaxN];
  __shared__ float s_vec[kD];
  __shared__ float s_x[kD][kMaxN];  // K = A^-1 E_n, row by row
  __shared__ float s_sol[kD];
  __shared__ float s_new[kNav];

  const int t = threadIdx.x;
  const int lane = t & 31;
  for (int i = t; i < 3 * kNav; i += blockDim.x) s_nav[i] = carry[kProp + i];
  if (t < kMaxN * kMaxN) {
    const int r = t / kMaxN, c = t % kMaxN;
    s_hth[r][c] = (r < n && c < n) ? hth[r * h_s0 + c * h_s1] : 0.0f;
  }
  if (t < kMaxN) s_htz[t] = t < n ? htz[t * z_s] : 0.0f;
  // Every thread's copy of the scalars, read before any write below.
  const float error = *err;
  const float final_err = carry[kFinalErr];
  const float last_error = carry[kLastErr];
  const bool stop = device_loop && flags[kStop] != 0;

  float a[kD];
  float b[kMaxN];
  if (t < 32) {
    // Row `lane` of A = P + embed(HTH) and of E_n.
#pragma unroll
    for (int c = 0; c < kD; ++c) {
      float v = 0.0f;
      if (lane < kD) {
        v = P[lane * p_s0 + c * p_s1];
        if (lane < n && c < n) v = hth[lane * h_s0 + c * h_s1] + v;
      }
      a[c] = v;
    }
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) b[j] = (lane == j && j < n) ? 1.0f : 0.0f;
  }
  __syncthreads();  // s_nav, s_hth, s_htz

  if (t < 32) {
    const int row = warp_gauss_jordan<kD, kMaxN>(a, b, lane);
    if (row >= 0) {
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) s_x[row][j] = b[j];
    }
  } else if (t == 32) {
    boxminus(s_nav, s_nav + kNav, s_vec);
  }
  __syncthreads();  // s_x, s_vec
  if (t >= 32) return;

  // Lane i < 19: row i of G (columns < n), (K HTz)[i] and sol[i].
  float g[kMaxN];
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) g[j] = 0.0f;
  if (lane < kD) {
    float kz = 0.0f;
#pragma unroll
    for (int m = 0; m < kMaxN; ++m) {
      if (m < n) kz = fmaf(s_x[lane][m], s_htz[m], kz);
    }
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < n) {
        float s = 0.0f;
#pragma unroll
        for (int m = 0; m < kMaxN; ++m) {
          if (m < n) s = fmaf(s_x[lane][m], s_hth[m][j], s);
        }
        g[j] = s;
      }
    }
    float gv = 0.0f;
#pragma unroll
    for (int m = 0; m < kMaxN; ++m) {
      if (m < n) gv = fmaf(g[m], s_vec[m], gv);
    }
    s_sol[lane] = (-kz + s_vec[lane]) - gv;
  }
  __syncwarp();

  // new = boxplus(state, sol): lane 0 the rotation, lanes 9-24 the rest.
  const float* st = s_nav + kNav;
  if (lane == 0) {
    const float w[3] = {s_sol[0], s_sol[1], s_sol[2]};
    float R[9];
    so3_exp(w, R);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        s_new[3 * i + j] = st[3 * i] * R[j] + st[3 * i + 1] * R[3 + j]
                           + st[3 * i + 2] * R[6 + j];
      }
    }
  } else if (lane >= 9 && lane < kNav) {
    const int k = lane == 24 ? 6 : (lane < 12 ? lane - 6 : lane - 5);
    s_new[lane] = st[lane] + s_sol[k];
  }
  __syncwarp();

  // The accept rule, the same in every lane.
  const bool active = !stop;
  const bool accept = active && error <= last_error;
  if (lane < kNav) {
    const float cur = st[lane], old = s_nav[2 * kNav + lane];
    const float back = (device_loop && !active) ? cur : old;
    carry[kState + lane] = accept ? s_new[lane] : back;
    carry[kOld + lane] = accept ? cur : old;
  }
  if (accept && lane < kD) {
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      float v = 0.0f;
#pragma unroll
      for (int m = 0; m < kMaxN; ++m) {
        if (m == j && m < n) v = g[m];
      }
      carry[kGKeep + lane * kD + j] = v;
    }
  }
  if (lane == 0) {
    const float rot_add = sqrtf(s_sol[0] * s_sol[0] + s_sol[1] * s_sol[1]
                                + s_sol[2] * s_sol[2]);
    const float t_add = sqrtf(s_sol[3] * s_sol[3] + s_sol[4] * s_sol[4]
                              + s_sol[5] * s_sol[5]);
    const bool converged = (rot_add * 57.3f < 0.001f) && (t_add * 100.0f < 0.001f);
    carry[kFinalErr] = accept ? error : final_err;
    carry[kLastErr] = accept ? error : last_error;
    if (device_loop) {
      flags[kIters] += active ? 1 : 0;
      flags[kStop] = (stop || !accept || converged) ? 1 : 0;
    } else {
      flags[kDone] = (!accept || converged) ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" int photo_tail_launch(float* carry, int* flags, const float* P,
                                 int p_s0, int p_s1, const float* hth,
                                 int h_s0, int h_s1, const float* htz, int z_s,
                                 const float* err, int n, int device_loop,
                                 int device, void* stream) {
  return launch_on(device, [&] {
    photo_tail_kernel<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(
        carry, flags, P, p_s0, p_s1, hth, h_s0, h_s1, htz, z_s, err, n,
        device_loop);
  });
}
