// Masked moments over flat per-entry candidate blocks, for Hopper.
//
// Replaces the TPU kernel nimrud_tpu/ops/pallas/multiscale_kernel.py
// entry_moments (body _kernel).  Per entry of Q queries and F candidate
// slots, both already in the entry-local frame, it forms the EXPANDED
// distance
//     d2 = max((|q|^2 + |s|^2) - 2 q.s, 0)
// tests it against each radius, and sums [1, x, y, z, xx, xy, xz, yy,
// yz, zz] of the valid candidates inside, one 16-wide slab per radius
// (rows 10..15 zero).  Invalid slots add nothing.
//
// What bounds it on an H100: the distance tests of the VALID pairs on
// the CUDA cores (8 f32 operations each, none fusable by contract).  On
// the tiled path at the 1M-point bench scene an entry holds 125
// neighbour tiles x s_cap slots (F = 1000 at s_cap 8), of which about
// 14% are valid: every search tile holds about one voxel center on
// average and the host table pads each to s_cap.  A kernel that tests
// every slot spends 86% of its pair work on padding.
//
// What the design does about it: each block (one entry,
// moment_mma::Shape<NR> queries, 8 warps) first COMPACTS the entry's valid slots -- each
// thread reads 16 validity bytes, a warp shuffle scan and a block
// prefix give every valid slot its place, and the slot offsets go to a
// shared list (int16, relative to the chunk) -- then stages dense tiles
// of valid candidates only, so an entry runs ceil(valid / 16) k16
// groups.  F of any size is taken: slots are compacted kChunk at a
// time, and the valid rows that do not fill a tile at the end of a
// chunk are carried in registers into the next chunk's first tile
// (F <= kChunk, s_cap <= 32 at m = 3, is one pass).  The masked sums
// run on the tensor cores through moment_mma.cuh (the aug row split
// into bf16 hi + mid + lo beside a column of ones, the 0/1 mask built in
// registers, mma.sync m16n8k16); a pad row past the last valid
// candidate has a zero aug row.
//
// Contracts kept: the expanded form is evaluated elementwise in one
// fixed order with every product and sum rounded on its own (no FMA):
//     qq = (q0*q0 + q1*q1) + q2*q2,  ss alike,
//     qs = (q0*s0 + q1*s1) + q2*s2,  d2 = (qq + ss) - 2*qs,
// the order of the port's plain version, so both give equal counts; no
// matmul or tensor core forms qs.  d2 is compared against the f32 value
// of r*r computed by the caller, without the clamp (moment_mma.cuh
// Expanded says why): a NaN query or candidate counts nowhere, as in
// the reference.  Counts are exact (sums of 0/1 products in f32 below
// 2^24); the other moments differ from an f32 sum only in the order of
// the sums.
//
// exclude_radius (_kernel's exclusion) keeps the pairs whose clamped
// max(d2, 0) >= f32(e*e): entry_excl_kernel<NR> runs entry_body with the
// Excluding<Expanded> policy of moment_mma.cuh, whose test takes the
// reference's clamp with a NaN-propagating max (max.NaN.f32; fmaxf would
// pass a NaN pair): a pair whose expanded d2 rounds below 0 passes e2 = 0,
// as in the reference.  1 compare, 1 select and the max a pair; a kernel
// of its own name, so entry_moments_kernel<NR> compiles as before.
//
// Built as a plain C library (nvcc -shared) and called through ctypes:
// the launcher runs on the caller's stream and returns
// cudaGetLastError().

#include "moment_mma.cuh"

namespace {

namespace mm = moment_mma;

constexpr int kChunk = 4096;                    // slots compacted a pass
constexpr int kPerThread = kChunk / mm::kThreads;   // 16 validity bytes

// One block: entry blockIdx.x, queries from blockIdx.y * kQueries.  Dist
// is Expanded<MT> or Excluding<Expanded<MT>>; its ss and qq are set here.
template <int NR, class Dist>
__device__ __forceinline__ void entry_body(
    mm::Smem& smem, float (&s_ss)[mm::kTile],
    short (&s_list)[kChunk + mm::kTile], int (&s_warp_total)[mm::kWarps],
    const float* __restrict__ q_local, const float* __restrict__ s_local,
    const unsigned char* __restrict__ s_valid, mm::Radii radii, int q_cap,
    int flat, float* __restrict__ out, Dist dist) {
  using W = mm::Warp<NR>;
  constexpr int MT = W::MT;

  const int e = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_first = blockIdx.y * mm::Shape<NR>::kQueries + warp * 16 * MT;
  const bool busy = q_first < q_cap;      // a warp of dead rows only stages

  W w;
  w.zero();
  dist.ss = s_ss;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q_first + m * 16 + (lane >> 2) + 8 * i;
      const float* qe = q_local + (static_cast<size_t>(e) * q_cap + q) * 3;
      const bool live = q < q_cap;
#pragma unroll
      for (int k = 0; k < 3; ++k) w.q[m][i][k] = live ? qe[k] : 0.f;
      dist.qq[m][i] = mm::sum_sq(w.q[m][i][0], w.q[m][i][1], w.q[m][i][2]);
    }
  float r2[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) r2[r] = radii.r2[r];

  const float* se = s_local + static_cast<size_t>(e) * flat * 3;
  const unsigned char* ve = s_valid + static_cast<size_t>(e) * flat;

  // This thread's next row to stage (entry-local; zero and dead past the
  // valid rows).  Valid rows that do not fill a tile at the end of a
  // chunk stay here, row `threadIdx.x` of the next chunk's first tile:
  // the list positions below `carry` are taken by them.
  float x = 0.f, y = 0.f, z = 0.f;
  bool live = false;
  int carry = 0;
  for (int base = 0; base < flat; base += kChunk) {
    // -- compact: this thread's 16 slots, in slot order -------------------
    const int first = threadIdx.x * kPerThread;
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int slot = base + first + i;
      if (slot < flat && ve[slot]) bits |= 1u << i;
    }
    const int mine = __popc(bits);
    int incl = mine;                        // inclusive scan over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_warp_total[warp] = incl;
    __syncthreads();   // warp totals published, the last list read done
    int pos = carry + incl - mine, chunk_valid = 0;
#pragma unroll
    for (int k = 0; k < mm::kWarps; ++k) {
      const int total = s_warp_total[k];
      pos += k < warp ? total : 0;
      chunk_valid += total;
    }
    while (bits) {
      const int i = __ffs(bits) - 1;
      bits &= bits - 1;
      s_list[pos++] = static_cast<short>(first + i);
    }
    __syncthreads();   // the list is complete

    // -- stage and sum whole tiles; the last chunk also its ragged tail ----
    const int n = carry + chunk_valid;
    const int staged = base + kChunk >= flat ? n : n - n % mm::kTile;
    // the row at list position j >= carry
    auto load = [&](int j) {
      live = j < n;
      x = y = z = 0.f;
      if (!live) return;
      const float* s = se + static_cast<size_t>(base + s_list[j]) * 3;
      x = s[0];
      y = s[1];
      z = s[2];
    };
    if (threadIdx.x >= carry) load(threadIdx.x);
    for (int k = 0; k < staged; k += mm::kTile) {
      const int w_tile = min(mm::kTile, staged - k);
      __syncthreads();   // the previous tile is consumed
      mm::stage_local(smem.tile, x, y, z, live);
      s_ss[threadIdx.x] = live ? mm::sum_sq(x, y, z) : 0.f;
      __syncthreads();
      load(k + mm::kTile + threadIdx.x);   // the next tile's, or the carry
      if (busy) w.accumulate(smem.tile, (w_tile + 15) / 16, r2, dist);
    }
    carry = n - staged;
  }
  __syncthreads();     // the tile's shared memory becomes the epilogue's
  if (busy) w.store(smem, out, e, q_first, q_cap);
}

template <int NR>
__global__ void __launch_bounds__(mm::kThreads)
entry_moments_kernel(const float* __restrict__ q_local,
                     const float* __restrict__ s_local,
                     const unsigned char* __restrict__ s_valid,
                     mm::Radii radii, int q_cap, int flat,
                     float* __restrict__ out) {
  __shared__ mm::Smem smem;
  __shared__ alignas(16) float s_ss[mm::kTile];          // sum_sq of a row
  __shared__ short s_list[kChunk + mm::kTile];  // valid slots - chunk base
  __shared__ int s_warp_total[mm::kWarps];
  entry_body<NR>(smem, s_ss, s_list, s_warp_total, q_local, s_local,
                 s_valid, radii, q_cap, flat, out,
                 mm::Expanded<mm::Shape<NR>::kMT>());
}

// exclude_radius: the pairs with max(d2, 0) >= e2 only.
template <int NR>
__global__ void __launch_bounds__(mm::kThreads)
entry_excl_kernel(const float* __restrict__ q_local,
                  const float* __restrict__ s_local,
                  const unsigned char* __restrict__ s_valid,
                  mm::Radii radii, float e2, int q_cap, int flat,
                  float* __restrict__ out) {
  __shared__ mm::Smem smem;
  __shared__ alignas(16) float s_ss[mm::kTile];
  __shared__ short s_list[kChunk + mm::kTile];
  __shared__ int s_warp_total[mm::kWarps];
  entry_body<NR>(smem, s_ss, s_list, s_warp_total, q_local, s_local,
                 s_valid, radii, q_cap, flat, out,
                 mm::Excluding<mm::Expanded<mm::Shape<NR>::kMT>>(e2));
}

template <int NR>
void launch(bool exclude, float e2, int n_entries, int q_cap,
            cudaStream_t s, const float* q_local, const float* s_local,
            const unsigned char* s_valid, const mm::Radii& radii, int flat,
            float* out) {
  constexpr int kQ = mm::Shape<NR>::kQueries;
  const dim3 grid(n_entries, (q_cap + kQ - 1) / kQ);
  if (exclude)
    entry_excl_kernel<NR><<<grid, mm::kThreads, 0, s>>>(
        q_local, s_local, s_valid, radii, e2, q_cap, flat, out);
  else
    entry_moments_kernel<NR><<<grid, mm::kThreads, 0, s>>>(
        q_local, s_local, s_valid, radii, q_cap, flat, out);
}

}  // namespace

// q_local (E, Q, 3), s_local (E, F, 3) float32, s_valid (E, F) bool
// (one byte each), out (E, Q, n_radii * 16) float32: contiguous, on
// `device`.  exclude: nonzero for exclude_radius, e2 = f32(e*e) its
// threshold.  r2_*: f32 squared radii (unused ones ignored).  Returns a
// cudaError_t.
extern "C" int entry_moments_launch(
    const float* q_local, const float* s_local,
    const unsigned char* s_valid, float* out, int n_entries, int q_cap,
    int flat, int n_radii, int exclude, float e2, float r2_0, float r2_1,
    float r2_2, float r2_3, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_entries <= 0 || q_cap <= 0) return 0;
  const mm::Radii radii = {{r2_0, r2_1, r2_2, r2_3}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool excl = exclude != 0;
  switch (n_radii) {
    case 1: launch<1>(excl, e2, n_entries, q_cap, s, q_local, s_local,
                      s_valid, radii, flat, out); break;
    case 2: launch<2>(excl, e2, n_entries, q_cap, s, q_local, s_local,
                      s_valid, radii, flat, out); break;
    case 3: launch<3>(excl, e2, n_entries, q_cap, s, q_local, s_local,
                      s_valid, radii, flat, out); break;
    case 4: launch<4>(excl, e2, n_entries, q_cap, s, q_local, s_local,
                      s_valid, radii, flat, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
