// Tensor-core masked moment sums, shared by packed_moments.cu,
// span_moments.cu and entry_moments.cu.
//
// A block takes one entry and kWarps * 16 * MT of its queries; each warp
// owns MT m16 query tiles.  Candidates are staged in shared memory in
// tiles of kTile (one per thread): the entry-local f32 coordinates for
// the distance, and the row aug = [1, x, y, z, xx, xy, xz, yy, yz, zz]
// split into bf16 hi + mid + lo (three bf16 terms rebuild an f32
// exactly), stored as the 32 columns of an mma B operand:
//
//   column 0        1 (the count; 1.0 is exact in bf16)
//   columns 1..9    hi of x .. zz
//   columns 10..18  mid
//   columns 19..27  lo
//   columns 28..31  0
//
// An instance with NATTR attribute slots (packed_moments' attribute and
// chebyshev instances) widens B to cols_for(NATTR) columns, the n8 tile
// above 28 + 3 NATTR (32 for 1 slot, 40 for 4, 48 for 6): slot a's
// value, a global attribute (no center subtracted), takes columns
// 28 + 3a .. 30 + 3a as hi, mid, lo, and the slab's row 10 + a gets
// their sum; unused slots and the columns above them stay 0.
//
// For each k16 step a lane forms the distances of its 2 query rows x 4
// candidate columns of the m16 x k16 A fragment through a distance
// policy (Difference: dx = q - x, (dx*dx + dy*dy) + dz*dz; Expanded:
// (|q|^2 + |s|^2) - 2 q.s; every operation rounded on its own, no FMA,
// in the order of the kernel's reference), compares each with the
// caller's f32(r*r) and packs the 0/1 results as bf16 pairs (the
// Chebyshev policy forms the max-norm max(|dx|, |dy|, |dz|) instead and
// is compared with f32(r)).  Per radius, one mma.sync m16n8k16 (bf16
// in, f32 accumulate) per n8 tile of B multiplies that mask by the
// columns.  The products are exact (0/1 times a bf16 term), so counts
// are exact and the moments differ from an f32 sum only in the order
// of the sums.  The epilogue adds hi + mid + lo
// per moment in f32 and writes the (q_cap, 16 * NR) slab rows; rows
// past q_cap are never stored.
//
// Excluding<Policy> adds exclude_radius to a policy: a pair that fails
// the exclusion test d2 >= f32(e*e) gets a NaN distance, which fails
// every radius test and the sazo fold's.
//
// A k16 group of candidates that holds only dead rows (the FAR sentinel
// at all three coordinates, a row staged with its live flag off, or the
// pad past a ragged tail) is skipped: its rows would add 0.
//
// With SAZO (packed_moments' sazo instance) each lane also folds, per
// radius and query row, the smallest and largest z difference
// dz = q_z - s_z of the candidates inside on the CUDA cores, beside the
// mask; the quad's four lanes then reduce them, and the slab's rows
// 10 / 11 get -min and -max: the masked max and min of the signed z
// offset s_z - q_z (+-1e30 where no candidate is inside).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace moment_mma {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = kThreads;         // candidates per tile, one a thread
constexpr int kGroups = kTile / 16;     // k16 steps per tile
constexpr int kCols = 32;               // B columns (see the header)
constexpr int kLd = kTile + 8;          // B column stride: 16-byte pad, so
                                        // ldmatrix rows hit distinct banks
constexpr int kPad = 16;                // slab width per radius (MOMENT_PAD)
constexpr int kMaxRadii = 4;
constexpr float kFar = 1.0e6f;
constexpr float kBig = 1.0e30f;         // identity of the sazo folds

struct Radii {
  float r2[kMaxRadii];
};

// B columns of an instance with `nattr` attribute slots: the count, the
// nine moment terms and the slots, each term in three bf16 parts,
// rounded up to the n8 tile.
__host__ __device__ constexpr int cols_for(int nattr) {
  return (28 + 3 * nattr + 7) / 8 * 8;
}

// m16 query tiles per warp: two at one radius (the main path), one at
// more radii so the accumulators stay in registers
template <int NR>
struct Shape {
  static constexpr int kMT = NR == 1 ? 2 : 1;
  static constexpr int kQueries = kWarps * 16 * kMT;   // per block
};

template <int COLS = kCols>
struct TileT {
  float x[kTile], y[kTile], z[kTile];
  alignas(16) unsigned short aug[COLS * kLd];   // bf16 bits
  int live[kGroups];
};
using Tile = TileT<>;

template <int COLS = kCols>
union SmemT {
  TileT<COLS> tile;
  float epi[kWarps][16][COLS + 1];      // per-warp epilogue staging
};
using Smem = SmemT<>;

__device__ __forceinline__ void split3(float v, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  const float rem = __fsub_rn(v, __bfloat162float(hi));
  mid = __float2bfloat16_rn(rem);
  lo = __float2bfloat16_rn(__fsub_rn(rem, __bfloat162float(mid)));
}

// Stage entry-local row (x, y, z) of thread j, and its NATTR attribute
// slots, into the tile.  A dead row (live false) keeps its coordinates
// and gets a zero aug row, so it adds 0 whatever its distance test
// says.  Every thread of the block calls this once per tile; the warp
// then publishes one live flag per k16 group.
template <int NATTR>
__device__ __forceinline__ void stage_cols(
    TileT<cols_for(NATTR)>& s, float x, float y, float z, bool live,
    const float (&attr)[NATTR > 0 ? NATTR : 1]) {
  const int j = threadIdx.x;
  s.x[j] = x;
  s.y[j] = y;
  s.z[j] = z;
  const float v[9] = {x, y, z,
                      __fmul_rn(x, x), __fmul_rn(x, y), __fmul_rn(x, z),
                      __fmul_rn(y, y), __fmul_rn(y, z), __fmul_rn(z, z)};
  unsigned short* col = s.aug + j;
  col[0] = live ? 0x3f80 : 0;                        // bf16 1.0 or 0
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    __nv_bfloat16 hi, mid, lo;
    split3(live ? v[i] : 0.f, hi, mid, lo);
    col[(1 + i) * kLd] = __bfloat16_as_ushort(hi);
    col[(10 + i) * kLd] = __bfloat16_as_ushort(mid);
    col[(19 + i) * kLd] = __bfloat16_as_ushort(lo);
  }
#pragma unroll
  for (int a = 0; a < NATTR; ++a) {
    __nv_bfloat16 hi, mid, lo;
    split3(live ? attr[a] : 0.f, hi, mid, lo);
    col[(28 + 3 * a) * kLd] = __bfloat16_as_ushort(hi);
    col[(29 + 3 * a) * kLd] = __bfloat16_as_ushort(mid);
    col[(30 + 3 * a) * kLd] = __bfloat16_as_ushort(lo);
  }
#pragma unroll
  for (int c = 28 + 3 * NATTR; c < cols_for(NATTR); ++c) col[c * kLd] = 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  const int lane = threadIdx.x & 31;
  if ((lane & 15) == 0)
    s.live[j >> 4] = ((ballot >> (lane & 16)) & 0xffffu) != 0;
}

// The row without attributes (the 32-column B of every instance that
// carries none).
__device__ __forceinline__ void stage_local(Tile& s, float x, float y,
                                            float z, bool live) {
  const float none[1] = {0.f};
  stage_cols<0>(s, x, y, z, live, none);
}

// Stage candidate j (global coordinates p*, entry center c*) into the
// tile.  Dead rows -- all three coordinates at the FAR sentinel -- keep
// their far local coordinates (every distance test fails) and a zero
// aug row.
__device__ __forceinline__ void stage_row(Tile& s, float px, float py,
                                          float pz, float cx, float cy,
                                          float cz) {
  const bool live = !(px == kFar && py == kFar && pz == kFar);
  stage_local(s, __fsub_rn(px, cx), __fsub_rn(py, cy), __fsub_rn(pz, cz),
              live);
}

// stage_row with the candidate's NATTR attribute slots, staged as the
// global values they are (the reference sums them as given).
template <int NATTR>
__device__ __forceinline__ void stage_row_attr(
    TileT<cols_for(NATTR)>& s, float px, float py, float pz, float cx,
    float cy, float cz, const float (&attr)[NATTR]) {
  const bool live = !(px == kFar && py == kFar && pz == kFar);
  stage_cols<NATTR>(s, __fsub_rn(px, cx), __fsub_rn(py, cy),
                    __fsub_rn(pz, cz), live, attr);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The reference's distance: no FMA, every operation rounded on its own.
// Hands back its z difference qz - z (the sazo fold's).
__device__ __forceinline__ float dist2(float qx, float qy, float qz,
                                       float x, float y, float z,
                                       float& dz) {
  const float dx = __fsub_rn(qx, x);
  const float dy = __fsub_rn(qy, y);
  dz = __fsub_rn(qz, z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Two 0/1 masks as a bf16 pair, the lower column in the low half:
// (d2 <= r2) is 1.0f = 0x3f800000 or 0, whose high half is bf16 1 or 0.
__device__ __forceinline__ uint32_t mask_pair(float d2_lo, float d2_hi,
                                              float r2) {
  return __byte_perm(__float_as_uint(d2_lo <= r2 ? 1.f : 0.f),
                     __float_as_uint(d2_hi <= r2 ? 1.f : 0.f), 0x7632);
}

// Distance policies of Warp::accumulate.  `columns` loads what the
// policy needs of staged columns ka, ka + 1, kb, kb + 1 beside their
// coordinates; the call gives the squared distance of query row i of
// m16 tile m (entry-local q) to one column.

// The difference form of packed_moments and span_moments; the second
// call also hands back the z difference for the sazo fold.
struct Difference {
  // what Excluding compares with f32(e*e): the distance itself
  __device__ __forceinline__ static float exclusion_test(float d2) {
    return d2;
  }
  __device__ __forceinline__ void columns(int, int, float (&)[4]) const {}
  __device__ __forceinline__ float operator()(int, int, const float (&q)[3],
                                              float x, float y, float z,
                                              float, float& dz) const {
    return dist2(q[0], q[1], q[2], x, y, z, dz);
  }
  __device__ __forceinline__ float operator()(int m, int i,
                                              const float (&q)[3], float x,
                                              float y, float z,
                                              float s) const {
    float dz;
    return (*this)(m, i, q, x, y, z, s, dz);
  }
};

// max with the NaN rule of jnp.maximum: a NaN operand gives a NaN.
// fmaxf returns the other operand instead, which would let a NaN
// coordinate pass the chebyshev test on the other axes.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The max-norm of packed_moments' chebyshev metric (the packed
// attribute interp's ball): dx, dy, dz as in Difference (the entry-local
// frame, no FMA), then max(|dx|, |dy|, |dz|), compared with the
// caller's f32(r).  The maximum propagates a NaN, so `d <= r` is
// |dx| <= r && |dy| <= r && |dz| <= r for every input: the same decision
// for finite values, and a NaN on any axis fails it, as in the
// reference.
struct Chebyshev {
  __device__ __forceinline__ void columns(int, int, float (&)[4]) const {}
  __device__ __forceinline__ float operator()(int, int, const float (&q)[3],
                                              float x, float y, float z,
                                              float) const {
    return max_nan(max_nan(fabsf(__fsub_rn(q[0], x)),
                           fabsf(__fsub_rn(q[1], y))),
                   fabsf(__fsub_rn(q[2], z)));
  }
};

__device__ __forceinline__ float sum_sq(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}

// The expanded form of entry_moments: d2 = (qq + ss) - 2 qs with
// qq = sum_sq(q) per query row (registers), ss = sum_sq(s) per staged
// row (the caller's shared array beside the tile) and
// qs = (q0*s0 + q1*s1) + q2*s2.  The reference clamps max(d2, 0) before
// its tests; for r2 >= 0 that clamp never changes d2 <= r2 (a negative d2
// passes either way, a NaN fails either way), so the radius test leaves it
// out.  The exclusion test d2 >= e2 does depend on it: a pair whose d2
// rounds below 0 passes e2 = 0 (and every e2 that rounds to 0) only
// clamped, so exclusion_test takes the clamp, with max.NaN so that a NaN
// still fails (fmaxf would turn it into 0 and pass it).
template <int MT>
struct Expanded {
  const float* ss;                 // kTile, 8-byte aligned
  float qq[MT][2];

  __device__ __forceinline__ static float exclusion_test(float d2) {
    return max_nan(d2, 0.f);
  }

  __device__ __forceinline__ void columns(int ka, int kb,
                                          float (&aux)[4]) const {
    const float2 a = *reinterpret_cast<const float2*>(ss + ka);
    const float2 b = *reinterpret_cast<const float2*>(ss + kb);
    aux[0] = a.x;
    aux[1] = a.y;
    aux[2] = b.x;
    aux[3] = b.y;
  }
  __device__ __forceinline__ float operator()(int m, int i,
                                              const float (&q)[3], float x,
                                              float y, float z,
                                              float s) const {
    const float qs = __fadd_rn(__fadd_rn(__fmul_rn(q[0], x),
                                         __fmul_rn(q[1], y)),
                               __fmul_rn(q[2], z));
    return __fsub_rn(__fadd_rn(qq[m][i], s), __fmul_rn(2.f, qs));
  }
};

// exclude_radius on a distance policy: the base policy's d2 where the
// pair passes the reference's exclusion test Base::exclusion_test(d2) >=
// e2 (e2 = f32(e*e), rounded by the caller), a quiet NaN otherwise.  The
// NaN fails d2 <= r2 at every radius and the sazo fold's own test, so the
// test is one compare and one select a pair, shared by all radii;
// mask_pair and the fold are unchanged.  The radius test reads the base
// policy's d2 as it is.  Dead rows at the FAR sentinel pass the exclusion
// (their d2 is about 1e12) and still fail every radius.  The instances
// without exclusion never instantiate it.
template <class Base>
struct Excluding : Base {
  float e2;

  __device__ __forceinline__ explicit Excluding(float e2_)
      : Base(), e2(e2_) {}
  template <class... Args>
  __device__ __forceinline__ float operator()(Args&&... args) const {
    const float d2 = Base::operator()(args...);
    return Base::exclusion_test(d2) >= e2 ? d2 : __int_as_float(0x7fc00000);
  }
};

// One warp's query tiles: entry-local coordinates of rows g and g + 8 of
// each m16 tile, and the accumulators (per radius, tile and n8 tile of
// the cols_for(NATTR) columns: 4 without attributes, 4-6 with).
// With SAZO also this lane's sazo folds (per radius, tile and row): the
// smallest and largest dz of its columns inside the radius.
//
// The fold trusts the distance test alone, as the sums do through the
// zero aug rows: it needs every dead candidate row to fail the test at
// every radius, which holds for rows staged by stage_row (the FAR
// sentinel).  A kernel that stages rows with their live flag off but
// real coordinates (entry_moments) must not take SAZO; it is tied to the
// difference form, which only packed_moments and span_moments use.
template <int NR, bool SAZO = false, int NATTR = 0>
struct Warp {
  static_assert(!(SAZO && NATTR), "sazo and attributes both claim slab "
                "rows 10+");
  static constexpr int MT = Shape<NR>::kMT;
  static constexpr int COLS = cols_for(NATTR);
  static constexpr int NT = COLS / 8;       // n8 tiles of B
  float q[MT][2][3];
  float acc[NR][MT][NT][4];
  float zmin[NR][MT][2], zmax[NR][MT][2];   // SAZO only

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][m][n][k] = 0.f;
        if constexpr (SAZO) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            zmin[r][m][i] = kBig;
            zmax[r][m][i] = -kBig;
          }
        }
      }
  }

  // Sum the first n_groups k16 groups of the staged tile.
  template <class Dist = Difference>
  __device__ __forceinline__ void accumulate(const TileT<COLS>& s,
                                             int n_groups,
                                             const float (&r2)[NR],
                                             const Dist& dist = Dist()) {
    static_assert(!SAZO || std::is_base_of<Difference, Dist>::value,
                  "the sazo fold takes the difference form's dz");
    const int lane = threadIdx.x & 31;
    const int t = lane & 3;
    // this lane's ldmatrix row: matrix lane >> 3 is (n8 tile, k half)
    // = ((lane >> 4), (lane >> 3) & 1) of the first x4, n8 tiles 2 and
    // 3 in the second
    const int mat = lane >> 3;
    const uint32_t base =
        static_cast<uint32_t>(__cvta_generic_to_shared(s.aug)) +
        2u * static_cast<uint32_t>(((mat >> 1) * 8 + (lane & 7)) * kLd +
                                   (mat & 1) * 8);
    for (int kg = 0; kg < n_groups; ++kg) {
      if (!s.live[kg]) continue;                       // warp-uniform
      const int k0 = kg * 16;
      uint32_t b_lo[4], b_hi[4];
      ldmatrix_x4(b_lo, base + 2u * k0);               // n8 tiles 0, 1
      ldmatrix_x4(b_hi, base + 2u * (k0 + 16 * kLd));  // n8 tiles 2, 3
      uint32_t b[2 * NT] = {b_lo[0], b_lo[1], b_lo[2], b_lo[3],
                            b_hi[0], b_hi[1], b_hi[2], b_hi[3]};
      if constexpr (NT > 4) {                          // attribute tiles
        uint32_t b_ex[4];
        if constexpr (NT == 6)
          ldmatrix_x4(b_ex, base + 2u * (k0 + 32 * kLd));   // tiles 4, 5
        else
          ldmatrix_x2(b_ex, base + 2u * (k0 + 32 * kLd));   // tile 4
#pragma unroll
        for (int i = 0; i < 2 * (NT - 4); ++i) b[8 + i] = b_ex[i];
      }
      // candidate columns 2t, 2t + 1, 2t + 8, 2t + 9 of this k16 step
      const float2 xa = *reinterpret_cast<const float2*>(s.x + k0 + 2 * t);
      const float2 xb =
          *reinterpret_cast<const float2*>(s.x + k0 + 8 + 2 * t);
      const float2 ya = *reinterpret_cast<const float2*>(s.y + k0 + 2 * t);
      const float2 yb =
          *reinterpret_cast<const float2*>(s.y + k0 + 8 + 2 * t);
      const float2 za = *reinterpret_cast<const float2*>(s.z + k0 + 2 * t);
      const float2 zb =
          *reinterpret_cast<const float2*>(s.z + k0 + 8 + 2 * t);
      const float cx[4] = {xa.x, xa.y, xb.x, xb.y};
      const float cy[4] = {ya.x, ya.y, yb.x, yb.y};
      const float cz[4] = {za.x, za.y, zb.x, zb.y};
      float aux[4] = {0.f, 0.f, 0.f, 0.f};
      dist.columns(k0 + 2 * t, k0 + 8 + 2 * t, aux);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float d2[2][4], dz[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if constexpr (SAZO)
              d2[i][j] = dist(m, i, q[m][i], cx[j], cy[j], cz[j], aux[j],
                              dz[i][j]);
            else
              d2[i][j] = dist(m, i, q[m][i], cx[j], cy[j], cz[j], aux[j]);
          }
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          // A fragment: {row g, cols 2t..}, {row g+8, cols 2t..},
          // {row g, cols 2t+8..}, {row g+8, cols 2t+8..}
          const uint32_t a[4] = {mask_pair(d2[0][0], d2[0][1], r2[r]),
                                 mask_pair(d2[1][0], d2[1][1], r2[r]),
                                 mask_pair(d2[0][2], d2[0][3], r2[r]),
                                 mask_pair(d2[1][2], d2[1][3], r2[r])};
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma_bf16(acc[r][m][n], a, b[2 * n], b[2 * n + 1]);
          if constexpr (SAZO) {
            // the mask's own test; a NaN coordinate or an excluded pair
            // makes d2 NaN, which fails it, so fminf's / fmaxf's NaN rule
            // never matters
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const bool in = d2[i][j] <= r2[r];
                zmin[r][m][i] = in ? fminf(zmin[r][m][i], dz[i][j])
                                   : zmin[r][m][i];
                zmax[r][m][i] = in ? fmaxf(zmax[r][m][i], dz[i][j])
                                   : zmax[r][m][i];
              }
          }
        }
      }
    }
  }

  // Write the slab rows of this warp's queries [q_first, q_first + 16 MT)
  // of `entry` that lie below q_cap.  The tile's shared memory is free
  // (the caller synchronised the block after the last accumulate).
  // With SAZO the quad's lanes (one row pair, 16 columns between them)
  // first reduce their folds, and the fold columns 28 / 29 of the
  // epilogue (the accumulators stage zeros there: B's columns 28..31 are
  // zero) carry -zmin / -zmax to slab rows 10 / 11.  With NATTR, slab
  // row 10 + a sums the hi, mid and lo columns of slot a.
  __device__ __forceinline__ void store(SmemT<COLS>& sm,
                                        float* __restrict__ out,
                                        long long entry, int q_first,
                                        int q_cap) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    float(*epi)[COLS + 1] = sm.epi[threadIdx.x >> 5];
    const int row = lane & 15, half = lane >> 4;
    if constexpr (SAZO) {
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int k = 1; k <= 2; k <<= 1) {
              float& lo = zmin[r][m][i];
              float& hi = zmax[r][m][i];
              lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, k));
              hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, k));
            }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int qi = q_first + m * 16 + row;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        __syncwarp();
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          epi[g][n * 8 + 2 * t] = acc[r][m][n][0];
          epi[g][n * 8 + 2 * t + 1] = acc[r][m][n][1];
          epi[g + 8][n * 8 + 2 * t] = acc[r][m][n][2];
          epi[g + 8][n * 8 + 2 * t + 1] = acc[r][m][n][3];
        }
        if constexpr (SAZO) {
          __syncwarp();                          // over the zeros staged
          if (t == 0) {
            epi[g][28] = -zmin[r][m][0];
            epi[g][29] = -zmax[r][m][0];
            epi[g + 8][28] = -zmin[r][m][1];
            epi[g + 8][29] = -zmax[r][m][1];
          }
        }
        __syncwarp();
        if (qi < q_cap) {
          float o[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int k = half * 8 + c;          // slab column
            o[c] = k == 0 ? epi[row][0]
                 : k < 10 ? __fadd_rn(__fadd_rn(epi[row][k], epi[row][9 + k]),
                                      epi[row][18 + k])
                 : SAZO && k < 12 ? epi[row][18 + k]
                 : NATTR && k < 10 + NATTR
                     ? __fadd_rn(__fadd_rn(epi[row][3 * k - 2],
                                           epi[row][3 * k - 1]),
                                 epi[row][3 * k])
                          : 0.f;
          }
          float4* dst = reinterpret_cast<float4*>(
              out + (entry * q_cap + qi) * (NR * kPad) + r * kPad + half * 8);
          dst[0] = make_float4(o[0], o[1], o[2], o[3]);
          dst[1] = make_float4(o[4], o[5], o[6], o[7]);
        }
      }
    }
  }
};

}  // namespace moment_mma
