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
// What bounds it on an H100: the distance test on the CUDA cores, as in
// packed_moments.cu (8 unfusable f32 operations a pair; the tensor-core
// sums a quarter of that at one radius, the bytes far less).  What the
// TPU kernel fought -- the latency of one DMA per short span (real spans
// hold about 17 live rows) -- becomes the cost of a barrier per span if
// spans are staged one by one.
//
// What the design does about it: the block loads the entry's span
// lengths into shared memory and takes their exclusive scan, then
// streams the CONCATENATION of the live spans through shared memory in
// tiles of 256 rows: slot j maps back to its span by a binary search
// over the scan and to row start + (j - offset).  Loads stay coalesced
// within a span and the block pays one barrier pair per tile, not per
// span; the next tile's rows are read into registers while the current
// one is summed.  Each row is staged once per block as local f32
// coordinates and its aug row split into bf16 hi + mid + lo; the masked
// sums run on the tensor cores (moment_mma.cuh: mma.sync m16n8k16, the mask built in
// registers from the distance test).  The ragged tail of the
// concatenation is padded to a multiple of 16 with FAR rows, whose mask
// is 0; nothing past the concatenated total is read.
//
// Contracts kept: no FMA in the distance -- every product and sum
// rounded on its own in the reference's order -- and a compare against
// the caller's f32(r*r).  Counts are exact (sums of 0/1 products in f32
// below 2^24); the other moments differ from an f32 sum only in the
// order of the sums.  Lengths are clamped to [0, span_rows] as the plan
// clamps them; a row outside the cloud (never produced by the plan) is
// read as a far point and adds nothing.  precision="highest" and
// "bf16x2" run this one kernel.
//
// exclude_radius (_kernel_body's base_mask) keeps the pairs with
// f32(e*e) <= d2 <= f32(r*r): span_excl_kernel<NR> runs span_body with the
// Excluding<Difference> policy of moment_mma.cuh (1 compare and 1 select
// a pair); a kernel of its own name, so span_moments_kernel<NR> compiles
// as before.
//
// Built as a plain C library (nvcc -shared) and called through ctypes:
// the launcher runs on the caller's stream and returns
// cudaGetLastError().

#include "moment_mma.cuh"

namespace {

namespace mm = moment_mma;

constexpr int kMaxSpans = 256;  // spans per entry ((m + 2)^2, m <= 8)

// One block: entry blockIdx.x, queries from blockIdx.y * kQueries; the
// shared arrays are the kernel's.
template <int NR, class Dist>
__device__ __forceinline__ void span_body(
    mm::Smem& smem, int (&s_off)[kMaxSpans + 1], int (&s_start)[kMaxSpans],
    const float* __restrict__ q_local, const float* __restrict__ centers,
    const int* __restrict__ span_starts, const int* __restrict__ span_lens,
    const float* __restrict__ pts, long long n_pts, mm::Radii radii,
    int q_cap, int n_span, int span_rows, float* __restrict__ out,
    const Dist& dist) {
  using W = mm::Warp<NR>;

  const int e = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_first = blockIdx.y * mm::Shape<NR>::kQueries
                      + warp * 16 * W::MT;
  const bool busy = q_first < q_cap;      // a warp of dead rows only stages
  const float cx = centers[3 * e + 0];
  const float cy = centers[3 * e + 1];
  const float cz = centers[3 * e + 2];

  W w;
  w.zero();
#pragma unroll
  for (int m = 0; m < W::MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q_first + m * 16 + (lane >> 2) + 8 * i;
      const float* qe = q_local + (static_cast<size_t>(e) * q_cap + q) * 3;
      const bool live = q < q_cap;
#pragma unroll
      for (int k = 0; k < 3; ++k) w.q[m][i][k] = live ? qe[k] : 0.f;
    }
  float r2[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) r2[r] = radii.r2[r];

  // the entry's span table; s_off[k + 1] holds span k's clamped length
  // until thread 0 turns the lengths into their exclusive scan
  const size_t first_span = static_cast<size_t>(e) * n_span;
  for (int k = threadIdx.x; k < n_span; k += mm::kThreads) {
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

  // this thread's row of a tile (FAR past the concatenated total or
  // outside the cloud); the next tile's is loaded before the current one
  // is summed, to hide its latency
  auto load = [&](int base, float& px, float& py, float& pz) {
    const int slot = base + threadIdx.x;
    px = py = pz = mm::kFar;
    if (slot >= total) return;
    // the last span whose offset is <= slot owns it (empty spans share
    // their successor's offset and are skipped)
    int lo = 0, hi = n_span - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_off[mid] <= slot) lo = mid; else hi = mid - 1;
    }
    const long long row =
        static_cast<long long>(s_start[lo]) + (slot - s_off[lo]);
    if (row >= 0 && row < n_pts) {
      px = pts[3 * row + 0];
      py = pts[3 * row + 1];
      pz = pts[3 * row + 2];
    }
  };
  float px, py, pz;
  load(0, px, py, pz);
  for (int base = 0; base < total; base += mm::kTile) {
    const int w_tile = min(mm::kTile, total - base);
    __syncthreads();   // the previous tile is consumed
    mm::stage_row(smem.tile, px, py, pz, cx, cy, cz);
    __syncthreads();
    load(base + mm::kTile, px, py, pz);
    if (busy) w.accumulate(smem.tile, (w_tile + 15) / 16, r2, dist);
  }
  __syncthreads();     // the tile's shared memory becomes the epilogue's
  if (busy) w.store(smem, out, e, q_first, q_cap);
}

template <int NR>
__global__ void __launch_bounds__(mm::kThreads)
span_moments_kernel(const float* __restrict__ q_local,
                    const float* __restrict__ centers,
                    const int* __restrict__ span_starts,
                    const int* __restrict__ span_lens,
                    const float* __restrict__ pts, long long n_pts,
                    mm::Radii radii, int q_cap, int n_span, int span_rows,
                    float* __restrict__ out) {
  __shared__ mm::Smem smem;
  __shared__ int s_off[kMaxSpans + 1];
  __shared__ int s_start[kMaxSpans];
  span_body<NR>(smem, s_off, s_start, q_local, centers, span_starts,
                span_lens, pts, n_pts, radii, q_cap, n_span, span_rows, out,
                mm::Difference());
}

// exclude_radius: the pairs with d2 >= e2 only.
template <int NR>
__global__ void __launch_bounds__(mm::kThreads)
span_excl_kernel(const float* __restrict__ q_local,
                 const float* __restrict__ centers,
                 const int* __restrict__ span_starts,
                 const int* __restrict__ span_lens,
                 const float* __restrict__ pts, long long n_pts,
                 mm::Radii radii, float e2, int q_cap, int n_span,
                 int span_rows, float* __restrict__ out) {
  __shared__ mm::Smem smem;
  __shared__ int s_off[kMaxSpans + 1];
  __shared__ int s_start[kMaxSpans];
  span_body<NR>(smem, s_off, s_start, q_local, centers, span_starts,
                span_lens, pts, n_pts, radii, q_cap, n_span, span_rows, out,
                mm::Excluding<mm::Difference>(e2));
}

template <int NR>
void launch(bool exclude, float e2, int n_entries, int q_cap,
            cudaStream_t s, const float* q_local, const float* centers,
            const int* starts, const int* lens, const float* pts,
            long long n_pts, const mm::Radii& radii, int n_span,
            int span_rows, float* out) {
  constexpr int kQ = mm::Shape<NR>::kQueries;
  const dim3 grid(n_entries, (q_cap + kQ - 1) / kQ);
  if (exclude)
    span_excl_kernel<NR><<<grid, mm::kThreads, 0, s>>>(
        q_local, centers, starts, lens, pts, n_pts, radii, e2, q_cap,
        n_span, span_rows, out);
  else
    span_moments_kernel<NR><<<grid, mm::kThreads, 0, s>>>(
        q_local, centers, starts, lens, pts, n_pts, radii, q_cap, n_span,
        span_rows, out);
}

}  // namespace

// q_local (E, q_cap, 3), centers (E, 3), pts (n_pts, 3) float32;
// span_starts / span_lens (E, n_span) int32; out (E, q_cap,
// n_radii * 16) float32: contiguous, on `device`.  exclude: nonzero for
// exclude_radius, e2 = f32(e*e) its threshold.  r2_*: f32 squared radii
// (unused ones ignored).  Returns a cudaError_t.
extern "C" int span_moments_launch(
    const float* q_local, const float* centers, const int* span_starts,
    const int* span_lens, const float* pts, float* out, int n_entries,
    int q_cap, int n_span, int span_rows, long long n_pts, int n_radii,
    int exclude, float e2, float r2_0, float r2_1, float r2_2, float r2_3,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_entries <= 0 || q_cap <= 0) return 0;
  if (n_span < 1 || n_span > kMaxSpans)
    return static_cast<int>(cudaErrorInvalidValue);
  const mm::Radii radii = {{r2_0, r2_1, r2_2, r2_3}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool excl = exclude != 0;
  switch (n_radii) {
    case 1: launch<1>(excl, e2, n_entries, q_cap, s, q_local, centers,
                      span_starts, span_lens, pts, n_pts, radii, n_span,
                      span_rows, out);
      break;
    case 2: launch<2>(excl, e2, n_entries, q_cap, s, q_local, centers,
                      span_starts, span_lens, pts, n_pts, radii, n_span,
                      span_rows, out);
      break;
    case 3: launch<3>(excl, e2, n_entries, q_cap, s, q_local, centers,
                      span_starts, span_lens, pts, n_pts, radii, n_span,
                      span_rows, out);
      break;
    case 4: launch<4>(excl, e2, n_entries, q_cap, s, q_local, centers,
                      span_starts, span_lens, pts, n_pts, radii, n_span,
                      span_rows, out);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
