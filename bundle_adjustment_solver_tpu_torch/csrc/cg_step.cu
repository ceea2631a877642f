// Fused pose-side PCG step for Hopper (sm_90a).
//
// Replaces the TPU kernel _cg_step_kernel of the JAX package's
// bundle_adjustment_solver_tpu/ops/pallas/cg_step.py (entry cg_pose_step):
// one PCG iteration's pose-side algebra on the plane layout (components
// along rows, poses along the Np-long row):
//     Sp = A p - corr, alpha = rz / (p . Sp), x' = x + alpha p,
//     r' = r - alpha Sp, z = M^-1 r', rz' = r' . z, beta = rz' / rz,
//     p' = z + beta p, rr = r' . r'.
// The Python wrapper and the plain PyTorch version live in
// ops/cuda/cg_step.py.
//
// What bounds it on the H100: launch latency. It moves ~3.4 MB at the
// flagship (Np = 10,112: A and M^-1 tri planes 42 rows, four 6-row state
// planes in, three out), ~1 us at 3.35 TB/s, less than one launch costs.
//
// What the design does about it: everything is one launch of one block of
// 1024 threads striding over the poses, with the three global dot products
// as block reductions, so alpha and beta never leave the chip. rz comes in
// and (alpha, rz', rr) go out through device memory, so the step causes no
// host synchronisation; the caller's loop reads rr once per iteration for
// its stopping test. Sp is recomputed in the second phase instead of being
// stored (36 multiply-adds per pose), and z is parked in p' until beta is
// known. Accumulation is float32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

// Flat index of entry (a, b) of a symmetric 6x6 in upper-triangle row-major
// order (ops/sym6.py _TRI6).
__device__ __forceinline__ constexpr int tri_idx(int a, int b) {
  return a <= b ? a * 6 - a * (a - 1) / 2 + (b - a)
                : b * 6 - b * (b - 1) / 2 + (a - b);
}

// y = T v for one pose lane; T's 21 tri rows start at row `base` of T.
__device__ __forceinline__ void sym6_apply(const float* __restrict__ T,
                                           int base, int Np, int i,
                                           const float v[6], float y[6]) {
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float acc = T[(long long)(base + tri_idx(a, 0)) * Np + i] * v[0];
#pragma unroll
    for (int b = 1; b < 6; ++b)
      acc += T[(long long)(base + tri_idx(a, b)) * Np + i] * v[b];
    y[a] = acc;
  }
}

// Sum over the block; every thread gets the result.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  return red[32];
}

__global__ void __launch_bounds__(kThreads)
cg_step_kernel(const float* __restrict__ AP, const float* __restrict__ corr,
               const float* __restrict__ x, const float* __restrict__ r,
               const float* __restrict__ p, const float* __restrict__ rz_in,
               float* __restrict__ xo, float* __restrict__ ro,
               float* __restrict__ po, float* __restrict__ sc, int Np) {
  __shared__ float red[33];

  // Phase 1: p . Sp.
  float part = 0.f;
  for (int i = threadIdx.x; i < Np; i += blockDim.x) {
    float pv[6], Ap[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) pv[a] = p[a * Np + i];
    sym6_apply(AP, 0, Np, i, pv, Ap);
#pragma unroll
    for (int a = 0; a < 6; ++a) part += pv[a] * (Ap[a] - corr[a * Np + i]);
  }
  const float pSp = block_sum(part, red);
  const float rz = rz_in[0];
  const float alpha = rz / fmaxf(pSp, 1e-30f);

  // Phase 2: x', r', z = M^-1 r' (parked in po), r'.z and r'.r'.
  float prz = 0.f, prr = 0.f;
  for (int i = threadIdx.x; i < Np; i += blockDim.x) {
    float pv[6], Ap[6], rn[6], zv[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) pv[a] = p[a * Np + i];
    sym6_apply(AP, 0, Np, i, pv, Ap);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float sp = Ap[a] - corr[a * Np + i];
      xo[a * Np + i] = x[a * Np + i] + alpha * pv[a];
      rn[a] = r[a * Np + i] - alpha * sp;
      ro[a * Np + i] = rn[a];
    }
    sym6_apply(AP, 21, Np, i, rn, zv);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      prz += rn[a] * zv[a];
      prr += rn[a] * rn[a];
      po[a * Np + i] = zv[a];
    }
  }
  const float rz_new = block_sum(prz, red);
  const float rr = block_sum(prr, red);
  const float beta = rz_new / fmaxf(rz, 1e-30f);

  // Phase 3: p' = z + beta p (each thread revisits only its own lanes).
  for (int i = threadIdx.x; i < Np; i += blockDim.x) {
#pragma unroll
    for (int a = 0; a < 6; ++a)
      po[a * Np + i] = po[a * Np + i] + beta * p[a * Np + i];
  }
  if (threadIdx.x == 0) {
    sc[0] = alpha;
    sc[1] = rz_new;
    sc[2] = rr;
  }
}

}  // namespace

extern "C" {

// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError() (0 on success).
int ba_cg_step(const void* AP, const void* corr, const void* x, const void* r,
               const void* p, const void* rz, void* xo, void* ro, void* po,
               void* sc, int Np, void* stream) {
  cg_step_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)AP, (const float*)corr, (const float*)x, (const float*)r,
      (const float*)p, (const float*)rz, (float*)xo, (float*)ro, (float*)po,
      (float*)sc, Np);
  return (int)cudaGetLastError();
}

}  // extern "C"
