// Masked moment slabs over candidate spans of a tile-sorted cloud, for
// Hopper.
//
// Replaces the TPU kernel nimrud_tpu/ops/pallas/gather_kernel.py
// span_moments (body _kernel_body).  Each entry of q_cap queries owns
// n_span candidate spans: contiguous row ranges [start, start + len) of
// the search cloud sorted by fine tile id, one per (dy, dz) x-row of its
// candidate box.  Per entry it forms the entry-local frame by f32
// subtraction of the entry center, tests d2 = dx*dx + dy*dy + dz*dz
// against each radius, and sums [1, x, y, z, xx, xy, xz, yy, yz, zz] of
// the candidates inside, one 16-wide slab per radius (rows 10..15
// zero).  Every live row of a span counts; spans of length 0 add
// nothing.
//
// What bounds it on an H100: the pair tests, as in packed_moments.cu
// (about 25 f32 operations a pair, tens of MB of input a band at the 1M
// bench scene; estimate from the code's shapes, not measured).  What
// the TPU kernel fought -- the latency of one DMA per short span (real
// spans hold about 17 live rows) -- becomes the cost of a barrier per
// span if spans are staged one by one.
//
// What the design does about it: one block per (entry, 128 queries),
// one thread per query with its 10 x n_r sums in registers.  The block
// loads the entry's span lengths into shared memory and takes their
// exclusive scan, then streams the CONCATENATION of the live spans
// through shared memory in chunks of 1024 rows: chunk slot j maps back
// to its span by a binary search over the scan and to row start + (j -
// offset).  So loads stay coalesced within a span and the block pays
// one __syncthreads pair per chunk, not per span.  Each row's local
// coordinates and six products are formed once per block and read as
// broadcasts.
//
// Contracts kept (the reference's exact boundary ownership): no FMA in
// the distance -- every product and sum rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn) in the reference's order -- and a
// compare against the f32 value of r*r, computed by the caller.  Sums
// use fmaf(m, v, s) with m in {0, 1}.  Lengths are clamped to
// [0, span_rows] as the plan clamps them; a row outside the cloud
// (never produced by the plan) is read as a far point and adds nothing.
//
// Built as a plain C library (nvcc -shared) and called through ctypes:
// the launcher runs on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // queries per block, one per thread
constexpr int kChunk = 1024;    // span rows per shared-memory chunk
constexpr int kMaxSpans = 256;  // spans per entry ((m + 2)^2, m <= 8)
constexpr int kPad = 16;        // slab width per radius (MOMENT_PAD)
constexpr int kMaxRadii = 4;
constexpr float kFar = 1.0e6f;

struct Radii {
  float r2[kMaxRadii];
};

template <int NR>
__global__ void __launch_bounds__(kThreads)
span_moments_kernel(const float* __restrict__ q_local,
                    const float* __restrict__ centers,
                    const int* __restrict__ span_starts,
                    const int* __restrict__ span_lens,
                    const float* __restrict__ pts, long long n_pts,
                    Radii radii, int q_cap, int n_span, int span_rows,
                    float* __restrict__ out) {
  __shared__ float4 s_a[kChunk];   // x, y, z, xx (entry-local)
  __shared__ float4 s_b[kChunk];   // xy, xz, yy, yz
  __shared__ float s_c[kChunk];    // zz
  __shared__ int s_off[kMaxSpans + 1];
  __shared__ int s_start[kMaxSpans];

  const int e = blockIdx.x;
  const int q = blockIdx.y * kThreads + threadIdx.x;
  const bool live = q < q_cap;
  const float cx = centers[3 * e + 0];
  const float cy = centers[3 * e + 1];
  const float cz = centers[3 * e + 2];

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* qe = q_local + (static_cast<size_t>(e) * q_cap + q) * 3;
    qx = qe[0];
    qy = qe[1];
    qz = qe[2];
  }

  // the entry's span table; s_off[k + 1] holds span k's clamped length
  // until thread 0 turns the lengths into their exclusive scan
  const size_t first_span = static_cast<size_t>(e) * n_span;
  for (int k = threadIdx.x; k < n_span; k += kThreads) {
    s_start[k] = span_starts[first_span + k];
    s_off[k + 1] = min(max(span_lens[first_span + k], 0), span_rows);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s_off[0] = 0;
    for (int k = 1; k <= n_span; ++k) s_off[k] += s_off[k - 1];
  }
  __syncthreads();
  const int total = s_off[n_span];

  float r2[NR];
  float acc[NR][10];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    r2[r] = radii.r2[r];
#pragma unroll
    for (int k = 0; k < 10; ++k) acc[r][k] = 0.f;
  }

  for (int base = 0; base < total; base += kChunk) {
    const int w = min(kChunk, total - base);
    __syncthreads();   // the previous chunk is consumed
    for (int j = threadIdx.x; j < w; j += kThreads) {
      const int slot = base + j;
      // the last span whose offset is <= slot owns it (empty spans
      // share their successor's offset and are skipped)
      int lo = 0, hi = n_span - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_off[mid] <= slot) lo = mid; else hi = mid - 1;
      }
      const long long row =
          static_cast<long long>(s_start[lo]) + (slot - s_off[lo]);
      float px = kFar, py = kFar, pz = kFar;
      if (row >= 0 && row < n_pts) {
        px = pts[3 * row + 0];
        py = pts[3 * row + 1];
        pz = pts[3 * row + 2];
      }
      const float x = __fsub_rn(px, cx);
      const float y = __fsub_rn(py, cy);
      const float z = __fsub_rn(pz, cz);
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

template <int NR>
void launch(dim3 grid, cudaStream_t s, const float* q_local,
            const float* centers, const int* starts, const int* lens,
            const float* pts, long long n_pts, const Radii& radii,
            int q_cap, int n_span, int span_rows, float* out) {
  span_moments_kernel<NR><<<grid, kThreads, 0, s>>>(
      q_local, centers, starts, lens, pts, n_pts, radii, q_cap, n_span,
      span_rows, out);
}

}  // namespace

// q_local (E, q_cap, 3), centers (E, 3), pts (n_pts, 3) float32;
// span_starts / span_lens (E, n_span) int32; out (E, q_cap,
// n_radii * 16) float32: contiguous, on `device`.  r2_*: f32 squared
// radii (unused ones ignored).  Returns a cudaError_t.
extern "C" int span_moments_launch(
    const float* q_local, const float* centers, const int* span_starts,
    const int* span_lens, const float* pts, float* out, int n_entries,
    int q_cap, int n_span, int span_rows, long long n_pts, int n_radii,
    float r2_0, float r2_1, float r2_2, float r2_3, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_entries <= 0 || q_cap <= 0) return 0;
  if (n_span < 1 || n_span > kMaxSpans)
    return static_cast<int>(cudaErrorInvalidValue);
  const Radii radii = {{r2_0, r2_1, r2_2, r2_3}};
  const dim3 grid(n_entries, (q_cap + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_radii) {
    case 1: launch<1>(grid, s, q_local, centers, span_starts, span_lens,
                      pts, n_pts, radii, q_cap, n_span, span_rows, out);
      break;
    case 2: launch<2>(grid, s, q_local, centers, span_starts, span_lens,
                      pts, n_pts, radii, q_cap, n_span, span_rows, out);
      break;
    case 3: launch<3>(grid, s, q_local, centers, span_starts, span_lens,
                      pts, n_pts, radii, q_cap, n_span, span_rows, out);
      break;
    case 4: launch<4>(grid, s, q_local, centers, span_starts, span_lens,
                      pts, n_pts, radii, q_cap, n_span, span_rows, out);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
