// Masked moments over flat per-entry candidate blocks, for Hopper.
//
// Replaces the TPU kernel nimrud_tpu/ops/pallas/multiscale_kernel.py
// entry_moments (body _kernel).  Per entry of Q queries and F candidates,
// both already in the entry-local frame, it forms the EXPANDED distance
//     d2 = max((|q|^2 + |s|^2) - 2 q.s, 0)
// tests it against each radius, and sums [v, x, y, z, xx, xy, xz, yy,
// yz, zz] * v of the candidates inside (v = 1 for a valid candidate, 0
// for padding), one 16-wide slab per radius (rows 10..15 zero).
//
// What bounds it on an H100: the pair tests.  On the tiled path at the
// 1M-point bench scene an entry batch pairs up to 256 entries of up to
// 512 queries with F = 125 * s_cap (1000-4000) candidates: up to ~0.5G
// pair tests per batch at about 20 f32 operations each (estimate from
// the shapes, not measured) against a few MB of input, so CUDA-core f32
// throughput is the limit, not HBM.
//
// What the design does about it: one thread owns one query and keeps
// its 10 x n_r sums in registers; a block of 128 queries of one entry
// streams the entry's candidates through shared memory in tiles of 256,
// where each candidate's |s|^2 and its validity-weighted moment terms
// are formed once for the whole block and then read as broadcasts.  Any
// Q (not only multiples of 128) and any F are taken.
//
// Contracts kept: the expanded form is evaluated elementwise in one
// fixed order with every product and sum rounded on its own (no FMA):
//     qq = (q0*q0 + q1*q1) + q2*q2,  ss alike,
//     qs = (q0*s0 + q1*s1) + q2*s2,  d2 = (qq + ss) - 2*qs,
// the order of the port's plain version, so both give equal counts.
// d2 is compared against the f32 value of r*r computed by the caller.
// Sums use fmaf(m, t, s) with m in {0, 1}: exactly s or round(s + t).
//
// Built as a plain C library (nvcc -shared) and called through ctypes:
// the launcher runs on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // queries per block, one per thread
constexpr int kTile = 256;      // candidates per shared-memory tile
constexpr int kPad = 16;        // slab width per radius (MOMENT_PAD)
constexpr int kMaxRadii = 4;

struct Radii {
  float r2[kMaxRadii];
};

__device__ __forceinline__ float sum_sq(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
entry_moments_kernel(const float* __restrict__ q_local,
                     const float* __restrict__ s_local,
                     const unsigned char* __restrict__ s_valid, Radii radii,
                     int q_cap, int flat, float* __restrict__ out) {
  __shared__ float4 s_p[kTile];   // x, y, z, ss
  __shared__ float4 s_m[kTile];   // v, x v, y v, z v
  __shared__ float4 s_n[kTile];   // xx v, xy v, xz v, yy v
  __shared__ float2 s_o[kTile];   // yz v, zz v

  const int e = blockIdx.x;
  const int q = blockIdx.y * kThreads + threadIdx.x;
  const bool live = q < q_cap;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* qe = q_local + (static_cast<size_t>(e) * q_cap + q) * 3;
    qx = qe[0];
    qy = qe[1];
    qz = qe[2];
  }
  const float qq = sum_sq(qx, qy, qz);

  float r2[NR];
  float acc[NR][10];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    r2[r] = radii.r2[r];
#pragma unroll
    for (int k = 0; k < 10; ++k) acc[r][k] = 0.f;
  }

  const float* se = s_local + static_cast<size_t>(e) * flat * 3;
  const unsigned char* ve = s_valid + static_cast<size_t>(e) * flat;

  for (int tile = 0; tile < flat; tile += kTile) {
    const int w = min(kTile, flat - tile);
    __syncthreads();   // the previous tile is consumed
    for (int j = threadIdx.x; j < w; j += kThreads) {
      const float* s = se + static_cast<size_t>(tile + j) * 3;
      const float x = s[0], y = s[1], z = s[2];
      const float v = ve[tile + j] ? 1.f : 0.f;
      s_p[j] = make_float4(x, y, z, sum_sq(x, y, z));
      s_m[j] = make_float4(v, __fmul_rn(x, v), __fmul_rn(y, v),
                           __fmul_rn(z, v));
      s_n[j] = make_float4(__fmul_rn(__fmul_rn(x, x), v),
                           __fmul_rn(__fmul_rn(x, y), v),
                           __fmul_rn(__fmul_rn(x, z), v),
                           __fmul_rn(__fmul_rn(y, y), v));
      s_o[j] = make_float2(__fmul_rn(__fmul_rn(y, z), v),
                           __fmul_rn(__fmul_rn(z, z), v));
    }
    __syncthreads();
    for (int j = 0; j < w; ++j) {
      const float4 p = s_p[j];
      const float4 a = s_m[j];
      const float4 b = s_n[j];
      const float2 c = s_o[j];
      const float qs = __fadd_rn(
          __fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
          __fmul_rn(qz, p.z));
      const float d2 =
          fmaxf(__fsub_rn(__fadd_rn(qq, p.w), __fmul_rn(2.f, qs)), 0.f);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        // m is exactly 0 or 1, so fmaf(m, t, s) is s or round(s + t)
        const float m = d2 <= r2[r] ? 1.f : 0.f;
        acc[r][0] = fmaf(m, a.x, acc[r][0]);
        acc[r][1] = fmaf(m, a.y, acc[r][1]);
        acc[r][2] = fmaf(m, a.z, acc[r][2]);
        acc[r][3] = fmaf(m, a.w, acc[r][3]);
        acc[r][4] = fmaf(m, b.x, acc[r][4]);
        acc[r][5] = fmaf(m, b.y, acc[r][5]);
        acc[r][6] = fmaf(m, b.z, acc[r][6]);
        acc[r][7] = fmaf(m, b.w, acc[r][7]);
        acc[r][8] = fmaf(m, c.x, acc[r][8]);
        acc[r][9] = fmaf(m, c.y, acc[r][9]);
      }
    }
  }

  if (!live) return;
  float* o = out + (static_cast<size_t>(e) * q_cap + q) * (NR * kPad);
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int k = 0; k < 10; ++k) o[r * kPad + k] = acc[r][k];
#pragma unroll
    for (int k = 10; k < kPad; ++k) o[r * kPad + k] = 0.f;
  }
}

template <int NR>
void launch(dim3 grid, cudaStream_t s, const float* q_local,
            const float* s_local, const unsigned char* s_valid,
            const Radii& radii, int q_cap, int flat, float* out) {
  entry_moments_kernel<NR><<<grid, kThreads, 0, s>>>(
      q_local, s_local, s_valid, radii, q_cap, flat, out);
}

}  // namespace

// q_local (E, Q, 3), s_local (E, F, 3) float32, s_valid (E, F) bool
// (one byte each), out (E, Q, n_radii * 16) float32: contiguous, on
// `device`.  r2_*: f32 squared radii (unused ones ignored).  Returns a
// cudaError_t.
extern "C" int entry_moments_launch(
    const float* q_local, const float* s_local,
    const unsigned char* s_valid, float* out, int n_entries, int q_cap,
    int flat, int n_radii, float r2_0, float r2_1, float r2_2, float r2_3,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_entries <= 0 || q_cap <= 0) return 0;
  const Radii radii = {{r2_0, r2_1, r2_2, r2_3}};
  const dim3 grid(n_entries, (q_cap + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_radii) {
    case 1: launch<1>(grid, s, q_local, s_local, s_valid, radii, q_cap,
                      flat, out); break;
    case 2: launch<2>(grid, s, q_local, s_local, s_valid, radii, q_cap,
                      flat, out); break;
    case 3: launch<3>(grid, s, q_local, s_local, s_valid, radii, q_cap,
                      flat, out); break;
    case 4: launch<4>(grid, s, q_local, s_local, s_valid, radii, q_cap,
                      flat, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
