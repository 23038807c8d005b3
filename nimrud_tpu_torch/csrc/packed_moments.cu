// Masked moment slabs over dense packed candidate blocks, for Hopper.
//
// Replaces the TPU kernel nimrud_tpu/ops/pallas/packed_kernel.py
// packed_moments (body _packed_body / _entry_sweep).  Per entry of q_cap
// queries and c_cap packed candidates it forms the entry-local frame by
// f32 subtraction of the entry center, tests d2 = dx*dx + dy*dy + dz*dz
// against each radius, and sums [1, x, y, z, xx, xy, xz, yy, yz, zz] of
// the candidates inside, one 16-wide slab per radius (rows 10..15 zero).
//
// What bounds it on an H100: the pair tests.  At the 1M-point serving
// workload each band packs about 2.3-3.0M candidate lanes against 512
// queries per entry, about 1.5G pair tests per band and 4.6G per step;
// at about 25 f32 operations per pair that is about 115 GFLOP against
// tens of MB of input, so CUDA-core f32 throughput is the limit, not
// HBM (estimate from the code's shapes, not measured).
//
// What the design does about it: one thread owns one query and keeps
// its 10 x n_r sums in registers; a block of 128 queries of one entry
// streams the entry's candidates through shared memory in tiles of 256,
// where each candidate's local coordinates and its six products are
// formed once for the whole block and then read as broadcasts, so the
// per-pair work is the distance, the compares and ten fused adds.  The
// mask products are left on the CUDA cores; moving them onto the tensor
// cores is later work.
//
// Contracts kept (the reference's exact boundary ownership): the
// distance uses no FMA -- every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn), in the reference's order -- and
// is compared against the f32 value of r*r, computed by the caller.
// Dead slots hold the FAR = 1e6 sentinel: d2 ~ 3e12 fails every radius
// and their finite products add m * v = 0.  Counts are exact (f32 sums
// of 1.0 below 2^24).
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

template <int NR>
__global__ void __launch_bounds__(kThreads)
packed_moments_kernel(const float* __restrict__ q_t,
                      const float* __restrict__ cand_t,
                      const float* __restrict__ centers, Radii radii,
                      int q_cap, int c_cap, long long lanes,
                      float* __restrict__ out) {
  __shared__ float4 s_a[kTile];   // x, y, z, xx (entry-local)
  __shared__ float4 s_b[kTile];   // xy, xz, yy, yz
  __shared__ float s_c[kTile];    // zz

  const int e = blockIdx.x;
  const int q = blockIdx.y * kThreads + threadIdx.x;
  const bool live = q < q_cap;
  const float cx = centers[3 * e + 0];
  const float cy = centers[3 * e + 1];
  const float cz = centers[3 * e + 2];

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* qe = q_t + static_cast<size_t>(e) * 3 * q_cap;
    qx = __fsub_rn(qe[q], cx);
    qy = __fsub_rn(qe[q_cap + q], cy);
    qz = __fsub_rn(qe[2 * q_cap + q], cz);
  }

  float r2[NR];
  float acc[NR][10];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    r2[r] = radii.r2[r];
#pragma unroll
    for (int k = 0; k < 10; ++k) acc[r][k] = 0.f;
  }

  const size_t first = static_cast<size_t>(e) * c_cap;
  const float* cand_x = cand_t + first;
  const float* cand_y = cand_t + lanes + first;
  const float* cand_z = cand_t + 2 * lanes + first;

  for (int tile = 0; tile < c_cap; tile += kTile) {
    const int w = min(kTile, c_cap - tile);
    __syncthreads();   // the previous tile is consumed
    for (int j = threadIdx.x; j < w; j += kThreads) {
      const float x = __fsub_rn(cand_x[tile + j], cx);
      const float y = __fsub_rn(cand_y[tile + j], cy);
      const float z = __fsub_rn(cand_z[tile + j], cz);
      s_a[j] = make_float4(x, y, z, __fmul_rn(x, x));
      s_b[j] = make_float4(__fmul_rn(x, y), __fmul_rn(x, z),
                           __fmul_rn(y, y), __fmul_rn(y, z));
      s_c[j] = __fmul_rn(z, z);
    }
    __syncthreads();
    for (int j = 0; j < w; ++j) {
      const float4 a = s_a[j];
      const float4 b = s_b[j];
      const float c = s_c[j];
      const float dx = __fsub_rn(qx, a.x);
      const float dy = __fsub_rn(qy, a.y);
      const float dz = __fsub_rn(qz, a.z);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
          __fmul_rn(dz, dz));
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        // m is exactly 0 or 1, so fmaf(m, v, s) is s or round(s + v)
        const float m = d2 <= r2[r] ? 1.f : 0.f;
        acc[r][0] = __fadd_rn(acc[r][0], m);
        acc[r][1] = fmaf(m, a.x, acc[r][1]);
        acc[r][2] = fmaf(m, a.y, acc[r][2]);
        acc[r][3] = fmaf(m, a.z, acc[r][3]);
        acc[r][4] = fmaf(m, a.w, acc[r][4]);
        acc[r][5] = fmaf(m, b.x, acc[r][5]);
        acc[r][6] = fmaf(m, b.y, acc[r][6]);
        acc[r][7] = fmaf(m, b.z, acc[r][7]);
        acc[r][8] = fmaf(m, b.w, acc[r][8]);
        acc[r][9] = fmaf(m, c, acc[r][9]);
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

}  // namespace

// q_t (E, 3, q_cap), cand_t (3, E * c_cap), centers (E, 3) and
// out (E, q_cap, n_radii * 16): contiguous float32 on `device`.
// r2_*: f32 squared radii (unused ones ignored).  Returns a cudaError_t.
extern "C" int packed_moments_launch(
    const float* q_t, const float* cand_t, const float* centers,
    float* out, int n_entries, int q_cap, int c_cap, int n_radii,
    float r2_0, float r2_1, float r2_2, float r2_3, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_entries <= 0 || q_cap <= 0) return 0;
  const Radii radii = {{r2_0, r2_1, r2_2, r2_3}};
  const dim3 grid(n_entries, (q_cap + kThreads - 1) / kThreads);
  const long long lanes = static_cast<long long>(n_entries) * c_cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_radii) {
    case 1:
      packed_moments_kernel<1><<<grid, kThreads, 0, s>>>(
          q_t, cand_t, centers, radii, q_cap, c_cap, lanes, out);
      break;
    case 2:
      packed_moments_kernel<2><<<grid, kThreads, 0, s>>>(
          q_t, cand_t, centers, radii, q_cap, c_cap, lanes, out);
      break;
    case 3:
      packed_moments_kernel<3><<<grid, kThreads, 0, s>>>(
          q_t, cand_t, centers, radii, q_cap, c_cap, lanes, out);
      break;
    case 4:
      packed_moments_kernel<4><<<grid, kThreads, 0, s>>>(
          q_t, cand_t, centers, radii, q_cap, c_cap, lanes, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
