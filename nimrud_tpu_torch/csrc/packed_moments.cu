// Masked moment slabs over dense packed candidate blocks, for Hopper.
//
// Replaces the TPU kernel nimrud_tpu/ops/pallas/packed_kernel.py
// packed_moments (body _packed_body / _entry_sweep).  Per entry of q_cap
// queries and c_cap packed candidates it forms the entry-local frame by
// f32 subtraction of the entry center, tests d2 = dx*dx + dy*dy + dz*dz
// against each radius, and sums [1, x, y, z, xx, xy, xz, yy, yz, zz] of
// the candidates inside, one 16-wide slab per radius (rows 10..15 zero).
// The sazo instance (_packed_body's with_sazo) also writes rows 10 / 11:
// the masked max and min of the signed z offset s_z - q_z of the
// candidates inside (-1e30 / +1e30 where there is none).
//
// What bounds it on an H100: the distance test on the CUDA cores.  The
// contract forbids fusing any of its 8 f32 operations (3 sub, 3 mul, 2
// add), so at 132 SMs x 128 lanes x 1.98 GHz the card tests at most
// 4.2e12 pairs a second; the masked sums, as bf16 products on the
// tensor cores, need a quarter of that time at one radius, and the bytes
// (candidates, queries, slabs) well under a tenth.
//
// What the design does about it: the masked sums leave the CUDA cores.
// The TPU kernel sums with a dot product on the MXU, and its bf16x2
// branch splits aug into bf16 hi + mid + lo; here moment_mma.cuh does the
// same with mma.sync m16n8k16 (bf16 in, f32 accumulate), the 0/1 mask
// built in registers straight from the distance test.  Per pair the CUDA
// cores do the 8 distance operations and about 1.5 more per radius (a
// compare, half a byte permute).  A block takes one entry and 256 (one
// radius) or 128 of its queries and stages its candidates 256 at a time,
// the next tile's read into registers while the current one is summed;
// k16 groups holding only FAR lanes are skipped, so the dead tail of a
// packed block costs its staging only.
//
// Contracts kept: the distance keeps the reference's exact boundary
// ownership (no FMA, the reference's order, a compare against the
// caller's f32(r*r)).  Counts are exact: sums of 0/1 products in f32,
// below 2^24.  The other moments differ from an f32 sum only in the
// order of the sums.  FAR lanes (the 1e6 sentinel at all three
// coordinates) add 0.  precision="highest" and "bf16x2" run this one
// kernel.
//
// The sazo fold: per pair and radius inside, a min and a max of the
// distance's own dz = q_z - s_z in registers (2 more CUDA-core
// operations a pair and radius, in the bound's distance term); rows
// 10 / 11 are -min and -max.  Negation, min and max are exact and
// fl(a - b) = -fl(b - a), so the rows are bit-equal to the reference's
// fold of -dz.  The instance is a template flag: the four instances
// without it compile as before.
//
// The attribute instances (_entry_sweep's n_attr, the V_MSO path) carry
// up to 6 candidate attribute rows (cand_t rows 3..3+A, global values)
// into the masked sums: packed_attr_kernel<NR, NATTR> stages them in a
// B operand widened to 32, 40 or 48 columns (NATTR 1, 4 or 6 slots, the
// n8 tile above 28 + 3 NATTR; moment_mma.cuh) and writes their sums to
// slab rows 10..10+A.  packed_interp_kernel<NATTR> is the same at one
// radius under the chebyshev metric (the packed attribute interp):
// max(|dx|, |dy|, |dz|) <= f32(r), the maximum propagating a NaN as
// jnp.maximum does.  The slots past A are staged as zeros; a call picks
// the smallest instance that holds A.  The instances without attributes
// keep their 32-column B and compile as before.
//
// exclude_radius (_entry_sweep's base_mask) keeps the pairs with
// f32(e*e) <= d2 <= f32(r*r): packed_excl_kernel<NR, SAZO> and
// packed_attr_excl_kernel<NR, NATTR> run packed_body with the
// Excluding<Difference> policy of moment_mma.cuh (an excluded pair's d2
// becomes a NaN, which fails every radius and the sazo fold: 1 compare
// and 1 select a pair, in the bound's distance term).  They are kernels
// of their own names, so the instances without exclusion compile as
// before and each family keeps its launch count and ptxas line.  The
// chebyshev metric takes no exclusion, as in the reference.
//
// Built as a plain C library (nvcc -shared) and called through ctypes:
// the launcher runs on the caller's stream and returns
// cudaGetLastError().

#include "moment_mma.cuh"

namespace {

namespace mm = moment_mma;

// One block: entry blockIdx.x, queries from blockIdx.y * kQueries.
// NATTR attribute slots read n_attr <= NATTR attribute rows of cand_t
// (rows 3.. past the coordinates, `lanes` apart); the other slots are 0.
template <int NR, bool SAZO, int NATTR, class Dist>
__device__ __forceinline__ void packed_body(
    mm::SmemT<mm::cols_for(NATTR)>& smem, const float* __restrict__ q_t,
    const float* __restrict__ cand_t, const float* __restrict__ centers,
    mm::Radii radii, int q_cap, int c_cap, long long lanes, int n_attr,
    float* __restrict__ out, const Dist& dist) {
  using W = mm::Warp<NR, SAZO, NATTR>;
  constexpr int kSlots = NATTR > 0 ? NATTR : 1;

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
  const float* qe = q_t + static_cast<size_t>(e) * 3 * q_cap;
#pragma unroll
  for (int m = 0; m < W::MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q_first + m * 16 + (lane >> 2) + 8 * i;
      const bool live = q < q_cap;
      w.q[m][i][0] = live ? __fsub_rn(qe[q], cx) : 0.f;
      w.q[m][i][1] = live ? __fsub_rn(qe[q_cap + q], cy) : 0.f;
      w.q[m][i][2] = live ? __fsub_rn(qe[2 * q_cap + q], cz) : 0.f;
    }
  float r2[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) r2[r] = radii.r2[r];

  const size_t first = static_cast<size_t>(e) * c_cap;
  const float* cand_x = cand_t + first;
  const float* cand_y = cand_t + lanes + first;
  const float* cand_z = cand_t + 2 * lanes + first;
  const float* cand_a = cand_t + 3 * lanes + first;

  // this thread's candidate of a tile, FAR past c_cap; the next tile's
  // is loaded before the current one is summed, to hide its latency
  auto load = [&](int tile, float& px, float& py, float& pz,
                  float (&pa)[kSlots]) {
    const int j = tile + threadIdx.x;
    const bool in = j < c_cap;
    px = in ? cand_x[j] : mm::kFar;
    py = in ? cand_y[j] : mm::kFar;
    pz = in ? cand_z[j] : mm::kFar;
    if constexpr (NATTR > 0) {
#pragma unroll
      for (int a = 0; a < NATTR; ++a)
        pa[a] = in && a < n_attr ? cand_a[a * lanes + j] : 0.f;
    }
  };
  float px, py, pz, pa[kSlots];
  load(0, px, py, pz, pa);
  for (int tile = 0; tile < c_cap; tile += mm::kTile) {
    const int w_tile = min(mm::kTile, c_cap - tile);   // a multiple of 128
    __syncthreads();   // the previous tile is consumed
    if constexpr (NATTR > 0)
      mm::stage_row_attr<NATTR>(smem.tile, px, py, pz, cx, cy, cz, pa);
    else
      mm::stage_row(smem.tile, px, py, pz, cx, cy, cz);
    __syncthreads();
    load(tile + mm::kTile, px, py, pz, pa);
    if (busy) w.accumulate(smem.tile, w_tile / 16, r2, dist);
  }
  __syncthreads();     // the tile's shared memory becomes the epilogue's
  if (busy) w.store(smem, out, e, q_first, q_cap);
}

template <int NR, bool SAZO>
__global__ void __launch_bounds__(mm::kThreads)
packed_moments_kernel(const float* __restrict__ q_t,
                      const float* __restrict__ cand_t,
                      const float* __restrict__ centers, mm::Radii radii,
                      int q_cap, int c_cap, long long lanes,
                      float* __restrict__ out) {
  __shared__ mm::Smem smem;
  packed_body<NR, SAZO, 0>(smem, q_t, cand_t, centers, radii, q_cap, c_cap,
                           lanes, 0, out, mm::Difference());
}

// exclude_radius: the pairs with d2 >= e2 only.
template <int NR, bool SAZO>
__global__ void __launch_bounds__(mm::kThreads)
packed_excl_kernel(const float* __restrict__ q_t,
                   const float* __restrict__ cand_t,
                   const float* __restrict__ centers, mm::Radii radii,
                   float e2, int q_cap, int c_cap, long long lanes,
                   float* __restrict__ out) {
  __shared__ mm::Smem smem;
  packed_body<NR, SAZO, 0>(smem, q_t, cand_t, centers, radii, q_cap, c_cap,
                           lanes, 0, out,
                           mm::Excluding<mm::Difference>(e2));
}

// The vector extraction: euclidean, NATTR attribute slots.
template <int NR, int NATTR>
__global__ void __launch_bounds__(mm::kThreads)
packed_attr_kernel(const float* __restrict__ q_t,
                   const float* __restrict__ cand_t,
                   const float* __restrict__ centers, mm::Radii radii,
                   int q_cap, int c_cap, long long lanes, int n_attr,
                   float* __restrict__ out) {
  __shared__ mm::SmemT<mm::cols_for(NATTR)> smem;
  packed_body<NR, false, NATTR>(smem, q_t, cand_t, centers, radii, q_cap,
                                c_cap, lanes, n_attr, out, mm::Difference());
}

// The vector extraction with exclude_radius.
template <int NR, int NATTR>
__global__ void __launch_bounds__(mm::kThreads)
packed_attr_excl_kernel(const float* __restrict__ q_t,
                        const float* __restrict__ cand_t,
                        const float* __restrict__ centers, mm::Radii radii,
                        float e2, int q_cap, int c_cap, long long lanes,
                        int n_attr, float* __restrict__ out) {
  __shared__ mm::SmemT<mm::cols_for(NATTR)> smem;
  packed_body<NR, false, NATTR>(smem, q_t, cand_t, centers, radii, q_cap,
                                c_cap, lanes, n_attr, out,
                                mm::Excluding<mm::Difference>(e2));
}

// The packed attribute interp: chebyshev, one radius, NATTR slots.
template <int NATTR>
__global__ void __launch_bounds__(mm::kThreads)
packed_interp_kernel(const float* __restrict__ q_t,
                     const float* __restrict__ cand_t,
                     const float* __restrict__ centers, mm::Radii radii,
                     int q_cap, int c_cap, long long lanes, int n_attr,
                     float* __restrict__ out) {
  __shared__ mm::SmemT<mm::cols_for(NATTR)> smem;
  packed_body<1, false, NATTR>(smem, q_t, cand_t, centers, radii, q_cap,
                               c_cap, lanes, n_attr, out, mm::Chebyshev());
}

dim3 grid_of(int n_entries, int q_cap, int n_radii) {
  const int per_block = n_radii == 1 ? mm::Shape<1>::kQueries
                                     : mm::Shape<2>::kQueries;
  return dim3(n_entries, (q_cap + per_block - 1) / per_block);
}

template <int NR, bool SAZO>
void launch_nr(bool exclude, float e2, int n_entries, int q_cap,
               cudaStream_t s, const float* q_t, const float* cand_t,
               const float* centers, const mm::Radii& radii, int c_cap,
               long long lanes, float* out) {
  constexpr int kQ = mm::Shape<NR>::kQueries;
  const dim3 grid(n_entries, (q_cap + kQ - 1) / kQ);
  if (exclude)
    packed_excl_kernel<NR, SAZO><<<grid, mm::kThreads, 0, s>>>(
        q_t, cand_t, centers, radii, e2, q_cap, c_cap, lanes, out);
  else
    packed_moments_kernel<NR, SAZO><<<grid, mm::kThreads, 0, s>>>(
        q_t, cand_t, centers, radii, q_cap, c_cap, lanes, out);
}

template <int NR>
void launch(bool sazo, bool exclude, float e2, int n_entries, int q_cap,
            cudaStream_t s, const float* q_t, const float* cand_t,
            const float* centers, const mm::Radii& radii, int c_cap,
            long long lanes, float* out) {
  if (sazo)
    launch_nr<NR, true>(exclude, e2, n_entries, q_cap, s, q_t, cand_t,
                        centers, radii, c_cap, lanes, out);
  else
    launch_nr<NR, false>(exclude, e2, n_entries, q_cap, s, q_t, cand_t,
                         centers, radii, c_cap, lanes, out);
}

template <int NR, int NATTR>
void launch_attr_nr(bool exclude, float e2, dim3 grid, int q_cap,
                    cudaStream_t s, const float* q_t, const float* cand_t,
                    const float* centers, const mm::Radii& radii, int c_cap,
                    long long lanes, int n_attr, float* out) {
  if (exclude)
    packed_attr_excl_kernel<NR, NATTR><<<grid, mm::kThreads, 0, s>>>(
        q_t, cand_t, centers, radii, e2, q_cap, c_cap, lanes, n_attr, out);
  else
    packed_attr_kernel<NR, NATTR><<<grid, mm::kThreads, 0, s>>>(
        q_t, cand_t, centers, radii, q_cap, c_cap, lanes, n_attr, out);
}

template <int NATTR>
cudaError_t launch_attr(bool chebyshev, bool exclude, float e2, int n_radii,
                        int n_entries, int q_cap, cudaStream_t s,
                        const float* q_t, const float* cand_t,
                        const float* centers, const mm::Radii& radii,
                        int c_cap, long long lanes, int n_attr, float* out) {
  const dim3 grid = grid_of(n_entries, q_cap, n_radii);
  if (chebyshev) {
    if (n_radii != 1 || exclude) return cudaErrorInvalidValue;
    packed_interp_kernel<NATTR><<<grid, mm::kThreads, 0, s>>>(
        q_t, cand_t, centers, radii, q_cap, c_cap, lanes, n_attr, out);
    return cudaSuccess;
  }
  switch (n_radii) {
    case 1: launch_attr_nr<1, NATTR>(exclude, e2, grid, q_cap, s, q_t,
                                     cand_t, centers, radii, c_cap, lanes,
                                     n_attr, out);
      break;
    case 2: launch_attr_nr<2, NATTR>(exclude, e2, grid, q_cap, s, q_t,
                                     cand_t, centers, radii, c_cap, lanes,
                                     n_attr, out);
      break;
    case 3: launch_attr_nr<3, NATTR>(exclude, e2, grid, q_cap, s, q_t,
                                     cand_t, centers, radii, c_cap, lanes,
                                     n_attr, out);
      break;
    case 4: launch_attr_nr<4, NATTR>(exclude, e2, grid, q_cap, s, q_t,
                                     cand_t, centers, radii, c_cap, lanes,
                                     n_attr, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// q_t (E, 3, q_cap), cand_t (3, E * c_cap), centers (E, 3) and
// out (E, q_cap, n_radii * 16): contiguous float32 on `device`.
// with_sazo: nonzero for the sazo instance (slab rows 10 / 11).
// exclude: nonzero for exclude_radius, e2 = f32(e*e) its threshold.
// r2_*: f32 squared radii (unused ones ignored).  Returns a cudaError_t.
extern "C" int packed_moments_launch(
    const float* q_t, const float* cand_t, const float* centers,
    float* out, int n_entries, int q_cap, int c_cap, int n_radii,
    int with_sazo, int exclude, float e2, float r2_0, float r2_1,
    float r2_2, float r2_3, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_entries <= 0 || q_cap <= 0) return 0;
  const mm::Radii radii = {{r2_0, r2_1, r2_2, r2_3}};
  const long long lanes = static_cast<long long>(n_entries) * c_cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sazo = with_sazo != 0, excl = exclude != 0;
  switch (n_radii) {
    case 1: launch<1>(sazo, excl, e2, n_entries, q_cap, s, q_t, cand_t,
                      centers, radii, c_cap, lanes, out);
      break;
    case 2: launch<2>(sazo, excl, e2, n_entries, q_cap, s, q_t, cand_t,
                      centers, radii, c_cap, lanes, out);
      break;
    case 3: launch<3>(sazo, excl, e2, n_entries, q_cap, s, q_t, cand_t,
                      centers, radii, c_cap, lanes, out);
      break;
    case 4: launch<4>(sazo, excl, e2, n_entries, q_cap, s, q_t, cand_t,
                      centers, radii, c_cap, lanes, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The attribute and chebyshev instances.  cand_t (3 + n_attr, E * c_cap)
// with 0 <= n_attr <= 6 attribute rows; chebyshev: nonzero for the
// max-norm metric (one radius, no exclusion); exclude / e2 as for
// packed_moments_launch.  lim_*: f32 squared radii (euclidean) or f32
// radii (chebyshev), unused ones ignored.  Returns a cudaError_t.
extern "C" int packed_attr_launch(
    const float* q_t, const float* cand_t, const float* centers,
    float* out, int n_entries, int q_cap, int c_cap, int n_radii,
    int n_attr, int chebyshev, int exclude, float e2, float lim_0,
    float lim_1, float lim_2, float lim_3, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_attr < 0 || n_attr > 6) return static_cast<int>(cudaErrorInvalidValue);
  if (n_entries <= 0 || q_cap <= 0) return 0;
  const mm::Radii radii = {{lim_0, lim_1, lim_2, lim_3}};
  const long long lanes = static_cast<long long>(n_entries) * c_cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cheb = chebyshev != 0, excl = exclude != 0;
  if (n_attr <= 1)
    err = launch_attr<1>(cheb, excl, e2, n_radii, n_entries, q_cap, s, q_t,
                         cand_t, centers, radii, c_cap, lanes, n_attr, out);
  else if (n_attr <= 4)
    err = launch_attr<4>(cheb, excl, e2, n_radii, n_entries, q_cap, s, q_t,
                         cand_t, centers, radii, c_cap, lanes, n_attr, out);
  else
    err = launch_attr<6>(cheb, excl, e2, n_radii, n_entries, q_cap, s, q_t,
                         cand_t, centers, radii, c_cap, lanes, n_attr, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
