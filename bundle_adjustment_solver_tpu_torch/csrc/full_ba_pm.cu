// Point-major full-BA kernels for Hopper (sm_90a): assembly, Schur matvec,
// cost.
//
// Replaces the TPU kernels of the JAX package's
// bundle_adjustment_solver_tpu/ops/pallas/full_ba_pm.py:
//   ba_assemble_pm  <- _assemble_kernel (entry assemble_pm_tbl)
//   ba_matvec_pm    <- _matvec_kernel   (entry _run_matvec: matvec_corr_pm,
//                                        rhs_corr_pm)
//   ba_cost_pm      <- _cost_kernel     (entry cost_pm_tbl)
// Each computes what its TPU kernel computes, on the same planes (layout in
// models/layout.py); the Python wrappers and the plain PyTorch versions of
// the same math live in ops/cuda/full_ba_pm.py.
//
// What bounds them on the H100: bytes. Per landmark the assembly does a few
// hundred flops per (slot, camera) against ~900 bytes of planes moved
// (obs, slot planes, X in; U, Cb out), far below the card's ~20 flop/byte
// float32 balance point; the matvec and the cost pass do even less work
// per byte. At the flagship layout (Kp = 8, C = 2, Mp ~ 1M) the assembly
// must move ~917 MB (bound ~0.27 ms at 3.35 TB/s), the matvec ~650 MB
// (~0.19 ms), the cost pass ~240 MB (~0.07 ms).
//
// What the design does about it:
//   * one CUDA block per layout block of bm landmarks, one thread per
//     landmark (strided), so every plane row is read and written coalesced
//     along the landmark axis, once;
//   * the block's window of P pose-table (or x-table) rows is staged in
//     shared memory, and the pose-side gather is an indexed read of it;
//   * the pose-side scatter accumulates into a (P, cols) panel in shared
//     memory with shared atomics and is written out once per block; a tiny
//     second-level sum (a torch op, as in the JAX package) finishes it.
//     Windows wider than kSmemRows rows read the table and add into the
//     (pre-zeroed) output panel in device memory instead;
//   * the assembly's B Cinv b term needs every slot's C before any slot's
//     U v, so it runs a second pass over the slots that re-reads the
//     just-written U (only for slots that scatter). That re-read is the
//     main excess over the byte bound, left for a later optimisation.
// Accumulation is float32 throughout. Atomic panel sums land in a
// run-dependent order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPoseCols = 16;   // pose table: R row-major (9), t (3), pad
constexpr int kPanelCols = 40;  // A panel: A tri (21), a (6), B Cinv b (6), pad
constexpr int kXCols = 8;       // x table / matvec panel: 6 used, 2 pad
constexpr int kSmemRows = 256;  // widest window staged in shared memory

struct Cam {
  float fx, fy, cx, cy;
  float r[9];
  float t[3];
};

__device__ __forceinline__ Cam load_cam(const float* __restrict__ cam_tbl,
                                        int c) {
  const float* p = cam_tbl + c * 16;
  Cam cm;
  cm.fx = __ldg(p + 0);
  cm.fy = __ldg(p + 1);
  cm.cx = __ldg(p + 2);
  cm.cy = __ldg(p + 3);
#pragma unroll
  for (int i = 0; i < 9; ++i) cm.r[i] = __ldg(p + 4 + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) cm.t[i] = __ldg(p + 13 + i);
  return cm;
}

// Pose row of one slot: 12 floats (R row-major, t) from the staged window,
// or zeros when the slot's pose lies outside the block's window (padding
// slots), exactly like the TPU kernel's one-hot gather that matches nothing.
__device__ __forceinline__ void gather_pose(const float* win, int row, int P,
                                            float g[12]) {
  if (row >= 0 && row < P) {
#pragma unroll
    for (int i = 0; i < 12; ++i) g[i] = win[row * kPoseCols + i];
  } else {
#pragma unroll
    for (int i = 0; i < 12; ++i) g[i] = 0.f;
  }
}

struct Residual {
  float xc, yc, inv_z, ru, rv, w, valid;
};

// Rig reference frame -> camera frame -> pixel residual and the
// Manhattan-Huber weight (JAX: _warp_and_project).
__device__ __forceinline__ Residual project(const Cam& cm, float xr, float yr,
                                           float zr, float pu, float pv,
                                           float valid, float huber) {
  Residual o;
  o.xc = cm.r[0] * xr + cm.r[1] * yr + cm.r[2] * zr + cm.t[0];
  o.yc = cm.r[3] * xr + cm.r[4] * yr + cm.r[5] * zr + cm.t[1];
  const float zc = cm.r[6] * xr + cm.r[7] * yr + cm.r[8] * zr + cm.t[2];
  // Guard padded slots (gathered zeros give zc == 0).
  const float zsafe = fabsf(zc) > 1e-12f ? zc : 1.0f;
  o.inv_z = 1.0f / zsafe;
  o.ru = cm.fx * o.xc * o.inv_z + cm.cx - pu;
  o.rv = cm.fy * o.yc * o.inv_z + cm.cy - pv;
  const float man = fabsf(o.ru) + fabsf(o.rv);
  o.w = (man > huber ? huber / fmaxf(man, 1e-30f) : 1.0f) * valid;
  o.valid = valid;
  return o;
}

// Closed-form inverse of a symmetric 3x3 [xx, xy, xz, yy, yz, zz]; zeros
// when singular (JAX: _inverse_sym3).
__device__ __forceinline__ void inverse_sym3(const float c[6], float o[6]) {
  const float a = c[0], b = c[1], c_ = c[2], d = c[3], e = c[4], f = c[5];
  const float co00 = d * f - e * e;
  const float co01 = c_ * e - b * f;
  const float co02 = b * e - c_ * d;
  const float det = a * co00 + b * co01 + c_ * co02;
  const float inv_det = det > 1e-30f ? 1.0f / det : 0.0f;
  o[0] = co00 * inv_det;
  o[1] = co01 * inv_det;
  o[2] = co02 * inv_det;
  o[3] = (a * f - c_ * c_) * inv_det;
  o[4] = (b * c_ - a * e) * inv_det;
  o[5] = (a * d - b * b) * inv_det;
}

__global__ void __launch_bounds__(kThreads)
assemble_kernel(const float* __restrict__ pose_tbl,
                const float* __restrict__ cam_tbl,
                const float* __restrict__ scal,
                const float* __restrict__ obs,
                const int* __restrict__ slot_pose,
                const int* __restrict__ slot_opt,
                const float* __restrict__ X,
                const int* __restrict__ gbase,
                const int* __restrict__ sbase,
                float* __restrict__ U, float* __restrict__ Cb,
                float* __restrict__ panels, int Kp, int C, int bm, int P,
                long long Mp, int use_smem) {
  extern __shared__ float smem[];
  const int blk = blockIdx.x;
  const int gb = gbase[blk];
  const int sb = sbase[blk];
  const float* win;
  float* pan;
  if (use_smem) {
    float* s_win = smem;
    float* s_pan = smem + P * kPoseCols;
    const float* src = pose_tbl + (long long)gb * kPoseCols;
    for (int i = threadIdx.x; i < P * kPoseCols; i += blockDim.x)
      s_win[i] = src[i];
    for (int i = threadIdx.x; i < P * kPanelCols; i += blockDim.x)
      s_pan[i] = 0.f;
    __syncthreads();
    win = s_win;
    pan = s_pan;
  } else {
    win = pose_tbl + (long long)gb * kPoseCols;
    pan = panels + (long long)blk * P * kPanelCols;  // zeroed by the caller
  }
  const float lam = scal[0];
  const float huber = scal[1];
  const long long KpMp = (long long)Kp * Mp;
  const int KC = Kp * C;

  for (int l = threadIdx.x; l < bm; l += blockDim.x) {
    const long long m = (long long)blk * bm + l;
    const float x = X[m], y = X[Mp + m], z = X[2 * Mp + m];
    const float pmask = X[3 * Mp + m];
    float Cs[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float bv[3] = {0.f, 0.f, 0.f};
    float slots_used = 0.f;

    for (int k = 0; k < Kp; ++k) {
      float g[12];
      gather_pose(win, slot_pose[k * Mp + m] - gb, P, g);
      // World -> rig reference frame (full cpp:744-745).
      const float xr = g[0] * x + g[1] * y + g[2] * z + g[9];
      const float yr = g[3] * x + g[4] * y + g[5] * z + g[10];
      const float zr = g[6] * x + g[7] * y + g[8] * z + g[11];

      float Ue[18], At[21], av[6];
#pragma unroll
      for (int i = 0; i < 18; ++i) Ue[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 21; ++i) At[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) av[i] = 0.f;
      float used = 0.f;

      for (int c = 0; c < C; ++c) {
        const Cam cm = load_cam(cam_tbl, c);
        const long long r0 = (long long)(c * Kp + k) * Mp + m;
        const Residual rs = project(cm, xr, yr, zr, obs[r0],
                                    obs[(long long)KC * Mp + r0],
                                    obs[2LL * KC * Mp + r0], huber);
        // Analytic Jacobians (full cpp:770-828): J_p through the rig
        // extrinsic, the [J_p | -J_p [X_ref]_x] pose block, Rj = J_p R_jw.
        const float fx_iz = cm.fx * rs.inv_z;
        const float fy_iz = cm.fy * rs.inv_z;
        const float du_dz = -fx_iz * rs.xc * rs.inv_z;
        const float dv_dz = -fy_iz * rs.yc * rs.inv_z;
        float ju[3], jv[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          ju[i] = fx_iz * cm.r[i] + du_dz * cm.r[6 + i];
          jv[i] = fy_iz * cm.r[3 + i] + dv_dz * cm.r[6 + i];
        }
        const float Qu[6] = {ju[0], ju[1], ju[2],
                             ju[2] * yr - ju[1] * zr,
                             ju[0] * zr - ju[2] * xr,
                             ju[1] * xr - ju[0] * yr};
        const float Qv[6] = {jv[0], jv[1], jv[2],
                             jv[2] * yr - jv[1] * zr,
                             jv[0] * zr - jv[2] * xr,
                             jv[1] * xr - jv[0] * yr};
        float Ru[3], Rv[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          Ru[i] = ju[0] * g[i] + ju[1] * g[3 + i] + ju[2] * g[6 + i];
          Rv[i] = jv[0] * g[i] + jv[1] * g[3 + i] + jv[2] * g[6 + i];
        }
        const float w = rs.w, ru = rs.ru, rv = rs.rv;
        used = fmaxf(used, rs.valid);

        // Point block C += w (Ru Ru^T + Rv Rv^T), b -= w Rj^T r.
        int n = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = a; b < 3; ++b, ++n)
            Cs[n] += w * (Ru[a] * Ru[b] + Rv[a] * Rv[b]);
#pragma unroll
        for (int a = 0; a < 3; ++a) bv[a] += -w * (Ru[a] * ru + Rv[a] * rv);
        // Coupling U += w Q^T Rj, summed over cameras.
#pragma unroll
        for (int a = 0; a < 6; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            Ue[a * 3 + b] += w * (Qu[a] * Ru[b] + Qv[a] * Rv[b]);
        // Pose block A += w Q^T Q (upper tri), a -= w Q^T r.
        n = 0;
#pragma unroll
        for (int a = 0; a < 6; ++a)
#pragma unroll
          for (int b = a; b < 6; ++b, ++n)
            At[n] += w * (Qu[a] * Qu[b] + Qv[a] * Qv[b]);
#pragma unroll
        for (int a = 0; a < 6; ++a) av[a] -= w * (Qu[a] * ru + Qv[a] * rv);
      }
      slots_used += used;

      // U planes, masked so fixed landmarks never couple.
#pragma unroll
      for (int e = 0; e < 18; ++e)
        U[e * KpMp + k * Mp + m] = Ue[e] * pmask;

      // Scatter A and a into the slot's panel row; fixed and padding
      // slots (slot_opt = -1) fall outside [0, P) and are dropped.
      const int prow = slot_opt[k * Mp + m] - sb;
      if (prow >= 0 && prow < P) {
        float* dst = pan + prow * kPanelCols;
#pragma unroll
        for (int i = 0; i < 21; ++i) atomicAdd(dst + i, At[i]);
#pragma unroll
        for (int i = 0; i < 6; ++i) atomicAdd(dst + 21 + i, av[i]);
      }
    }

    // Damped point block and its closed-form inverse; fixed landmarks
    // (pmask == 0) zero C -> Cinv = 0 -> they drop out of the Schur system.
    const float damp = 1.0f + lam;
    float Cd[6], Ci[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) Cd[i] = Cs[i] * pmask;
    Cd[0] *= damp;
    Cd[3] *= damp;
    Cd[5] *= damp;
    inverse_sym3(Cd, Ci);
    const float b0 = bv[0] * pmask, b1 = bv[1] * pmask, b2 = bv[2] * pmask;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      Cb[i * Mp + m] = Cd[i];
      Cb[(9 + i) * Mp + m] = Ci[i];
    }
    Cb[6 * Mp + m] = b0;
    Cb[7 * Mp + m] = b1;
    Cb[8 * Mp + m] = b2;
    Cb[15 * Mp + m] = slots_used;

    // Reduced-rhs correction B Cinv b: v = Cinv b, per slot U v.
    const float v0 = Ci[0] * b0 + Ci[1] * b1 + Ci[2] * b2;
    const float v1 = Ci[1] * b0 + Ci[3] * b1 + Ci[4] * b2;
    const float v2 = Ci[2] * b0 + Ci[4] * b1 + Ci[5] * b2;
    for (int k = 0; k < Kp; ++k) {
      const int prow = slot_opt[k * Mp + m] - sb;
      if (prow < 0 || prow >= P) continue;
      float* dst = pan + prow * kPanelCols + 27;
      const float* Uk = U + k * Mp + m;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const float r = Uk[(a * 3) * KpMp] * v0 + Uk[(a * 3 + 1) * KpMp] * v1 +
                        Uk[(a * 3 + 2) * KpMp] * v2;
        atomicAdd(dst + a, r);
      }
    }
  }

  if (use_smem) {
    __syncthreads();
    float* out = panels + (long long)blk * P * kPanelCols;
    for (int i = threadIdx.x; i < P * kPanelCols; i += blockDim.x)
      out[i] = pan[i];
  }
}

__global__ void __launch_bounds__(kThreads)
matvec_kernel(const float* __restrict__ x_tbl, const float* __restrict__ U,
              const float* __restrict__ Cb, const int* __restrict__ slot_opt,
              const int* __restrict__ sbase, float* __restrict__ panels,
              float* __restrict__ t_out, int Kp, int bm, int P, long long Mp,
              int rhs_mode, int use_smem) {
  extern __shared__ float smem[];
  const int blk = blockIdx.x;
  const int sb = sbase[blk];
  const float* xw;
  float* pan;
  if (use_smem) {
    float* s_x = smem;
    float* s_pan = smem + P * kXCols;
    if (!rhs_mode) {
      const float* src = x_tbl + (long long)sb * kXCols;
      for (int i = threadIdx.x; i < P * kXCols; i += blockDim.x)
        s_x[i] = src[i];
    }
    for (int i = threadIdx.x; i < P * kXCols; i += blockDim.x) s_pan[i] = 0.f;
    __syncthreads();
    xw = s_x;
    pan = s_pan;
  } else {
    xw = x_tbl + (long long)sb * kXCols;
    pan = panels + (long long)blk * P * kXCols;  // zeroed by the caller
  }
  const long long KpMp = (long long)Kp * Mp;

  for (int l = threadIdx.x; l < bm; l += blockDim.x) {
    const long long m = (long long)blk * bm + l;
    float t0, t1, t2;
    if (rhs_mode) {
      // t := b, so the scatter below gives B Cinv b (cpp:887-888).
      t0 = Cb[6 * Mp + m];
      t1 = Cb[7 * Mp + m];
      t2 = Cb[8 * Mp + m];
    } else {
      // t = sum over slots of U^T x at the slot's pose (fixed and padding
      // slots gather zeros, so they are skipped).
      t0 = t1 = t2 = 0.f;
      for (int k = 0; k < Kp; ++k) {
        const int row = slot_opt[k * Mp + m] - sb;
        if (row < 0 || row >= P) continue;
        const float* xr = xw + row * kXCols;
        const float* Uk = U + k * Mp + m;
        float acc[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float s = Uk[c * KpMp] * xr[0];
#pragma unroll
          for (int a = 1; a < 6; ++a) s += Uk[(a * 3 + c) * KpMp] * xr[a];
          acc[c] = s;
        }
        t0 += acc[0];
        t1 += acc[1];
        t2 += acc[2];
      }
    }
    t_out[m] = t0;
    t_out[Mp + m] = t1;
    t_out[2 * Mp + m] = t2;
    t_out[3 * Mp + m] = 0.f;

    // v = Cinv t.
    float ci[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) ci[i] = Cb[(9 + i) * Mp + m];
    const float v0 = ci[0] * t0 + ci[1] * t1 + ci[2] * t2;
    const float v1 = ci[1] * t0 + ci[3] * t1 + ci[4] * t2;
    const float v2 = ci[2] * t0 + ci[4] * t1 + ci[5] * t2;

    // U v per slot, scattered into the slot's panel row.
    for (int k = 0; k < Kp; ++k) {
      const int prow = slot_opt[k * Mp + m] - sb;
      if (prow < 0 || prow >= P) continue;
      const float* Uk = U + k * Mp + m;
      float* dst = pan + prow * kXCols;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const float r = Uk[(a * 3) * KpMp] * v0 + Uk[(a * 3 + 1) * KpMp] * v1 +
                        Uk[(a * 3 + 2) * KpMp] * v2;
        atomicAdd(dst + a, r);
      }
    }
  }

  if (use_smem) {
    __syncthreads();
    float* out = panels + (long long)blk * P * kXCols;
    for (int i = threadIdx.x; i < P * kXCols; i += blockDim.x) out[i] = pan[i];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
cost_kernel(const float* __restrict__ pose_tbl,
            const float* __restrict__ cam_tbl, const float* __restrict__ scal,
            const float* __restrict__ obs, const int* __restrict__ slot_pose,
            const float* __restrict__ X, const int* __restrict__ gbase,
            float* __restrict__ partial, int Kp, int C, int bm, int P,
            long long Mp, int use_smem) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads / 32][4];
  const int blk = blockIdx.x;
  const int gb = gbase[blk];
  const float* win;
  if (use_smem) {
    const float* src = pose_tbl + (long long)gb * kPoseCols;
    for (int i = threadIdx.x; i < P * kPoseCols; i += blockDim.x)
      smem[i] = src[i];
    __syncthreads();
    win = smem;
  } else {
    win = pose_tbl + (long long)gb * kPoseCols;
  }
  const float huber = scal[1];
  const int KC = Kp * C;
  float s_norm = 0.f, s_wsq = 0.f, s_sq = 0.f, s_cnt = 0.f;

  for (int l = threadIdx.x; l < bm; l += blockDim.x) {
    const long long m = (long long)blk * bm + l;
    const float x = X[m], y = X[Mp + m], z = X[2 * Mp + m];
    for (int k = 0; k < Kp; ++k) {
      float g[12];
      gather_pose(win, slot_pose[k * Mp + m] - gb, P, g);
      const float xr = g[0] * x + g[1] * y + g[2] * z + g[9];
      const float yr = g[3] * x + g[4] * y + g[5] * z + g[10];
      const float zr = g[6] * x + g[7] * y + g[8] * z + g[11];
      for (int c = 0; c < C; ++c) {
        const Cam cm = load_cam(cam_tbl, c);
        const long long r0 = (long long)(c * Kp + k) * Mp + m;
        const Residual rs = project(cm, xr, yr, zr, obs[r0],
                                    obs[(long long)KC * Mp + r0],
                                    obs[2LL * KC * Mp + r0], huber);
        const float sq = rs.ru * rs.ru + rs.rv * rs.rv;
        s_norm += rs.valid * sqrtf(fmaxf(sq, 0.f));
        s_wsq += rs.w * sq;
        s_sq += rs.valid * sq;
        s_cnt += rs.valid;
      }
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  s_norm = warp_sum(s_norm);
  s_wsq = warp_sum(s_wsq);
  s_sq = warp_sum(s_sq);
  s_cnt = warp_sum(s_cnt);
  if (lane == 0) {
    red[warp][0] = s_norm;
    red[warp][1] = s_wsq;
    red[warp][2] = s_sq;
    red[warp][3] = s_cnt;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float s = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w][threadIdx.x];
    partial[blk * 4 + threadIdx.x] = s;
  }
}

}  // namespace

extern "C" {

// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success).

int ba_assemble_pm(const void* pose_tbl, const void* cam_tbl, const void* scal,
                   const void* obs, const void* slot_pose, const void* slot_opt,
                   const void* X, const void* gbase, const void* sbase, void* U,
                   void* Cb, void* panels, int Kp, int C, int bm, int P,
                   long long Mp, int nblocks, void* stream) {
  const int use_smem = P <= kSmemRows;
  const size_t smem =
      use_smem ? (size_t)P * (kPoseCols + kPanelCols) * sizeof(float) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  assemble_kernel<<<nblocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pose_tbl, (const float*)cam_tbl, (const float*)scal,
      (const float*)obs, (const int*)slot_pose, (const int*)slot_opt,
      (const float*)X, (const int*)gbase, (const int*)sbase, (float*)U,
      (float*)Cb, (float*)panels, Kp, C, bm, P, Mp, use_smem);
  return (int)cudaGetLastError();
}

int ba_matvec_pm(const void* x_tbl, const void* U, const void* Cb,
                 const void* slot_opt, const void* sbase, void* panels,
                 void* t_out, int Kp, int bm, int P, long long Mp, int nblocks,
                 int rhs_mode, void* stream) {
  const int use_smem = P <= kSmemRows;
  const size_t smem = use_smem ? (size_t)P * 2 * kXCols * sizeof(float) : 0;
  matvec_kernel<<<nblocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x_tbl, (const float*)U, (const float*)Cb,
      (const int*)slot_opt, (const int*)sbase, (float*)panels, (float*)t_out,
      Kp, bm, P, Mp, rhs_mode, use_smem);
  return (int)cudaGetLastError();
}

int ba_cost_pm(const void* pose_tbl, const void* cam_tbl, const void* scal,
               const void* obs, const void* slot_pose, const void* X,
               const void* gbase, void* partial, int Kp, int C, int bm, int P,
               long long Mp, int nblocks, void* stream) {
  const int use_smem = P <= kSmemRows;
  const size_t smem = use_smem ? (size_t)P * kPoseCols * sizeof(float) : 0;
  cost_kernel<<<nblocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pose_tbl, (const float*)cam_tbl, (const float*)scal,
      (const float*)obs, (const int*)slot_pose, (const float*)X,
      (const int*)gbase, (float*)partial, Kp, C, bm, P, Mp, use_smem);
  return (int)cudaGetLastError();
}

}  // extern "C"
