// Batched pose-only Gauss-Newton statistics for Hopper (sm_90a).
//
// Replaces the four TPU kernels of the JAX package's
// bundle_adjustment_solver_tpu/ops/pallas/pose_only_batched.py:
//   ba_bgn_mono          <- _bgn_mono_kernel (:117, batched_mono_gn_stats)
//   ba_bgn_stereo        <- _bgn_stereo_kernel (:128, batched_stereo_gn_stats)
//   ba_bgn_planar_mono   <- _bgn_planar_mono_kernel
//                           (:314, batched_planar_mono_gn_stats)
//   ba_bgn_planar_stereo <- _bgn_planar_stereo_kernel
//                           (:327, batched_planar_stereo_gn_stats)
// For each of B independent frames: warp the frame's P points by its pose,
// project, take the Manhattan-Huber weight, and reduce the frame's 21
// upper-triangle J^T W J entries, 6 J^T W r entries and robust cost (planar:
// 6 + 3 + 1) over its points; stereo adds the right camera, chained through
// the shared rig. The Python wrappers and the plain PyTorch versions of the
// same math live in ops/cuda/pose_only_batched.py.
//
// What bounds them on the H100: bytes. Each point costs ~150-200 float32
// operations per camera against 24 bytes (mono: x, y, z, pu, pv, valid) or
// 36 bytes (stereo) read once, about 6-8 operations per byte, below the
// card's ~20 float32 operations per byte. At 2048 frames x 256 points the
// mono kernels must read ~12.6 MB (~3.8 us at 3.35 TB/s) and the stereo
// ones ~18.9 MB (~5.6 us); the (B, 28) or (B, 10) output is small.
//
// What the design does about it:
//   * the planes are frame-major (k, B, P), and one CUDA block owns one
//     frame: its threads stride over the frame's points, so each plane is
//     read once, coalesced, with no padding lanes;
//   * each thread keeps its 28 (planar: 10) running sums in registers;
//   * the block reduces them with warp shuffles, then across its warps in
//     shared memory in a fixed order, and writes the frame's one output row:
//     no atomics, so the result is the same on every run;
//   * per-frame pose and intrinsics are read once per thread (the same
//     address across a warp), and the shared extrinsics come in as kernel
//     arguments, so no table is read for them.
// One frame per block suits the card better than the TPU's one frame per
// lane: 2048 frames give 2048 blocks of 128 threads across 132 SMs. A point
// count far above the block size would call for splitting a frame across
// blocks with a second pass; at P = 256 each thread sums two points.
//
// Semantics kept from the TPU kernels: the z -> 1 guard applies to invalid
// points only, so a valid point at z = 0 yields inf/NaN stats for its frame;
// w = huber / (|ru| + |rv|) above huber, 1 below, times valid. Accumulation
// is float32. Build flags keep IEEE division and no flush to zero.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// A shared (3, 4) extrinsic [R | t], row-major, passed by value.
struct Mat34 {
  float m[12];
};

// Guarded depth, residuals and Manhattan-Huber weight of one observation.
struct Weighted {
  float inv_z, ru, rv, w;
};

template <bool kPlanar>
__device__ __forceinline__ Weighted weigh(float xc, float yc, float zc,
                                          float pu, float pv, float fx,
                                          float fy, float cx, float cy,
                                          float valid, float huber) {
  Weighted o;
  zc = valid > 0.f ? zc : 1.f;
  o.inv_z = 1.f / zc;
  if (kPlanar) {
    o.ru = fx * xc * o.inv_z + cx - pu;
    o.rv = fy * yc * o.inv_z + cy - pv;
  } else {
    o.ru = fx * (xc * o.inv_z) + cx - pu;
    o.rv = fy * (yc * o.inv_z) + cy - pv;
  }
  const float man = fabsf(o.ru) + fabsf(o.rv);
  o.w = (man > huber ? huber / man : 1.f) * valid;
  return o;
}

// acc[0 .. n(n+1)/2) += upper-tri w (ju ju^T + jv jv^T), then n gradient
// entries w (ru ju + rv jv), then the cost w (ru^2 + rv^2).
template <int n>
__device__ __forceinline__ void accumulate(float* acc, const float* ju,
                                           const float* jv, float w, float ru,
                                           float rv) {
  int k = 0;
#pragma unroll
  for (int a = 0; a < n; ++a) {
#pragma unroll
    for (int b = a; b < n; ++b)
      acc[k++] += w * (ju[a] * ju[b] + jv[a] * jv[b]);
  }
  const float wru = w * ru, wrv = w * rv;
#pragma unroll
  for (int a = 0; a < n; ++a) acc[k++] += wru * ju[a] + wrv * jv[a];
  acc[k] += w * (ru * ru + rv * rv);
}

// One camera, 6-DoF: Jacobian with respect to this camera's frame
// (pose_only_batched._cam_stats_lanes).
__device__ __forceinline__ void cam_stats6(float* acc, float xc, float yc,
                                           float zc, float pu, float pv,
                                           float fx, float fy, float cx,
                                           float cy, float valid,
                                           float huber) {
  const Weighted o =
      weigh<false>(xc, yc, zc, pu, pv, fx, fy, cx, cy, valid, huber);
  const float xiz = xc * o.inv_z, yiz = yc * o.inv_z;
  const float fxiz = fx * o.inv_z, fyiz = fy * o.inv_z;
  const float ju[6] = {fxiz,           0.f,
                       -fxiz * xiz,    -fx * xiz * yiz,
                       fx * (1.f + xiz * xiz), -fx * yiz};
  const float jv[6] = {0.f,            fyiz,
                       -fyiz * yiz,    -fy * (1.f + yiz * yiz),
                       fy * xiz * yiz, fy * xiz};
  accumulate<6>(acc, ju, jv, o.w, o.ru, o.rv);
}

// One camera, planar 3-DoF: translation columns through columns 0/1 of the
// camera<-base rotation `rcb`, the psi column through the lever of the
// base-frame point (xb, yb) (pose_only_batched._cam_stats_planar_lanes).
__device__ __forceinline__ void cam_stats3(float* acc, float xc, float yc,
                                           float zc, float pu, float pv,
                                           float fx, float fy, float cx,
                                           float cy, float cpsi, float spsi,
                                           float xb, float yb,
                                           const Mat34& rcb, float valid,
                                           float huber) {
  const Weighted o =
      weigh<true>(xc, yc, zc, pu, pv, fx, fy, cx, cy, valid, huber);
  const float fx_inv_z = fx * o.inv_z, fy_inv_z = fy * o.inv_z;
  const float du_dz = -fx_inv_z * xc * o.inv_z;
  const float dv_dz = -fy_inv_z * yc * o.inv_z;
  const float ju_x = fx_inv_z * rcb.m[0] + du_dz * rcb.m[8];
  const float ju_y = fx_inv_z * rcb.m[1] + du_dz * rcb.m[9];
  const float jv_x = fy_inv_z * rcb.m[4] + dv_dz * rcb.m[8];
  const float jv_y = fy_inv_z * rcb.m[5] + dv_dz * rcb.m[9];
  const float A = -spsi * xb - cpsi * yb;
  const float B = cpsi * xb - spsi * yb;
  const float ju[3] = {ju_x, ju_y, ju_x * A + ju_y * B};
  const float jv[3] = {jv_x, jv_y, jv_x * A + jv_y * B};
  accumulate<3>(acc, ju, jv, o.w, o.ru, o.rv);
}

__device__ __forceinline__ void apply(const Mat34& T, float x, float y,
                                      float z, float& xo, float& yo,
                                      float& zo) {
  xo = T.m[0] * x + T.m[1] * y + T.m[2] * z + T.m[3];
  yo = T.m[4] * x + T.m[5] * y + T.m[6] * z + T.m[7];
  zo = T.m[8] * x + T.m[9] * y + T.m[10] * z + T.m[11];
}

// One block per frame. pose12 (12, B), intr8 (8, B), psi2 (2, B) rows;
// obs (kPlanes, B, P) planes; out (B, NS).
template <bool kStereo, bool kPlanar>
__global__ void __launch_bounds__(kThreads)
bgn_kernel(const float* __restrict__ pose12, const float* __restrict__ intr8,
           const float* __restrict__ psi2, const float* __restrict__ obs,
           float* __restrict__ out, int B, int P, float huber, Mat34 rcb,
           Mat34 rcbr, Mat34 rig) {
  constexpr int NS = kPlanar ? 10 : 28;
  __shared__ float red[kWarps][NS];

  const int b = blockIdx.x;
  Mat34 pose;  // this frame's point warp, [R | t] row-major
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      pose.m[4 * i + j] = __ldg(pose12 + (long long)(3 * i + j) * B + b);
    pose.m[4 * i + 3] = __ldg(pose12 + (long long)(9 + i) * B + b);
  }
  float in[8];
#pragma unroll
  for (int k = 0; k < (kStereo ? 8 : 4); ++k)
    in[k] = __ldg(intr8 + (long long)k * B + b);
  float cpsi = 0.f, spsi = 0.f;
  if (kPlanar) {
    cpsi = __ldg(psi2 + b);
    spsi = __ldg(psi2 + B + b);
  }

  float acc[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) acc[k] = 0.f;

  const long long plane = (long long)B * P;
  const float* f = obs + (long long)b * P;  // this frame's row of plane 0
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const float x = __ldg(f + p), y = __ldg(f + plane + p),
                z = __ldg(f + 2 * plane + p);
    const float pu = __ldg(f + 3 * plane + p), pv = __ldg(f + 4 * plane + p),
                v = __ldg(f + 5 * plane + p);
    float xl, yl, zl;
    apply(pose, x, y, z, xl, yl, zl);
    if (kPlanar)
      cam_stats3(acc, xl, yl, zl, pu, pv, in[0], in[1], in[2], in[3], cpsi,
                 spsi, x, y, rcb, v, huber);
    else
      cam_stats6(acc, xl, yl, zl, pu, pv, in[0], in[1], in[2], in[3], v,
                 huber);
    if (kStereo) {
      const float pur = __ldg(f + 6 * plane + p),
                  pvr = __ldg(f + 7 * plane + p),
                  vr = __ldg(f + 8 * plane + p);
      float xr, yr, zr;
      apply(rig, xl, yl, zl, xr, yr, zr);
      if (kPlanar)
        cam_stats3(acc, xr, yr, zr, pur, pvr, in[4], in[5], in[6], in[7],
                   cpsi, spsi, x, y, rcbr, vr, huber);
      else
        cam_stats6(acc, xr, yr, zr, pur, pvr, in[4], in[5], in[6], in[7], vr,
                   huber);
    }
  }

  // Block reduction in a fixed order: shuffles within each warp, then the
  // warps' partials summed in warp order by one thread per stat.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    float s = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < NS) {
    float s = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][threadIdx.x];
    out[(long long)b * NS + threadIdx.x] = s;
  }
}

Mat34 load(const void* host) {
  Mat34 T;
  const float* h = (const float*)host;
  for (int k = 0; k < 12; ++k) T.m[k] = h[k];
  return T;
}

template <bool kStereo, bool kPlanar>
int launch(const void* pose12, const void* intr8, const void* psi2,
           const Mat34& rcb, const Mat34& rcbr, const Mat34& rig,
           const void* obs, void* out, int B, int P, float huber,
           void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  bgn_kernel<kStereo, kPlanar><<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pose12, (const float*)intr8, (const float*)psi2,
      (const float*)obs, (float*)out, B, P, huber, rcb, rcbr, rig);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success). Device pointers: pose12,
// intr8, psi2, obs, out. Host pointers: the (3, 4) float32 extrinsics rig
// (right <- left), rcb (camera <- base) and rcbr (R_rl R_cb, zero
// translation), copied into the launch's arguments.

int ba_bgn_mono(const void* pose12, const void* intr8, const void* obs,
                void* out, int B, int P, float huber, void* stream) {
  const Mat34 none = {};
  return launch<false, false>(pose12, intr8, nullptr, none, none, none, obs,
                              out, B, P, huber, stream);
}

int ba_bgn_stereo(const void* pose12, const void* intr8, const void* rig,
                  const void* obs, void* out, int B, int P, float huber,
                  void* stream) {
  const Mat34 none = {};
  return launch<true, false>(pose12, intr8, nullptr, none, none, load(rig),
                             obs, out, B, P, huber, stream);
}

int ba_bgn_planar_mono(const void* pose12, const void* intr8, const void* psi2,
                       const void* rcb, const void* obs, void* out, int B,
                       int P, float huber, void* stream) {
  const Mat34 none = {};
  return launch<false, true>(pose12, intr8, psi2, load(rcb), none, none, obs,
                             out, B, P, huber, stream);
}

int ba_bgn_planar_stereo(const void* pose12, const void* intr8,
                         const void* psi2, const void* rcb, const void* rcbr,
                         const void* rig, const void* obs, void* out, int B,
                         int P, float huber, void* stream) {
  return launch<true, true>(pose12, intr8, psi2, load(rcb), load(rcbr),
                            load(rig), obs, out, B, P, huber, stream);
}

}  // extern "C"
