// The random-projection forest's walk and decision, for Hopper: feature
// rows in, class probabilities out, in one kernel.
//
// Replaces no TPU kernel: the JAX package walks the forest in XLA
// (nimrud_tpu/learning/rpt.py _walk_forest_dense, and its blocked form
// _walk_forest_blocked, three levels a gather), and the port's plain twin
// (ops/kernels/forest_walk.py walk_dense_plain) ran the same level-
// synchronous walk as PyTorch calls.  Added because that walk was the
// largest block of device time in the forest's serving step: 15 levels,
// each a (trees, rows, D + 1) row gather of about 0.75 GB at the 1M
// scan's 1.44M slot rows, then a multiply and a sum of it -- about 2 GB
// of device memory a level and 50 ms a scan, where the rows in and the
// probabilities out are tens of MB.
//
// What bounds it on an H100: at the 1M scan's 1.44M slot rows (10
// trees, D 12) the walk projects 44.7M times and stops at 14.4M leaves.
// The device-memory bytes (the rows, the answers, and once each table
// row the walk reaches; ops/kernels/forest_walk.py forest_walk_work)
// and the CUDA-core operations (D products, D - 1 sums and a compare a
// projection, then the decision) take under 40 us each.  But every node
// visited reads a Dpad-float table row, 3.8 GB in all, each load
// waiting on the one before it (the dense tables, 10 x 65,536 x 17
// floats, fit the 50 MB L2; their top levels, which every row visits,
// stay in L1).  So it is bound by the latency of those loads and by
// L1 / L2 throughput: 0.205 ms on an H100 80GB HBM3 at 700 W.
//
// What the design does about it: one thread owns one feature row and
// holds its D floats in registers for the whole walk, so the only
// traffic a level is the node's row, read as Dpad / 4 16-byte loads all
// issued before the leaf test (the split rides the row's last slot).
// A pair leaves its tree at the first leaf (an infinite split) instead
// of running every level, and the rows of a warp are neighbouring
// slots of one plan entry, whose similar features walk the same nodes:
// their loads coalesce into one L1 line.  The decision function runs in
// registers after the walk, so nothing but the answers is written.
// The top levels are not staged in shared memory: at 0.2 ms of a scan's
// 60 ms the time does not call for it.
//
// Forests past the register instances (rows of more than 64 floats,
// that is 64 features or more, more than kMaxTrees trees or more than
// kMaxClasses classes: a workflow's kernel map or trees embedding gives
// hundreds of columns) take forest_walk_wide_kernel: the same walk and
// decision with the feature row read from memory (L1) beside each
// table row's 16-byte chunks, no per-tree leaf array (wmean walks the
// trees twice: once for the weights' sum, once for the proportions)
// and the classes summed in the answer row itself.  Its results are the
// register instances' bit for bit.
//
// Contracts kept (the plain twin's, ops/kernels/forest_walk.py):
// * the walk: the row read is min(tag, size - 1); where its split is
//   infinite the pair's leaf is tag, else tag = 2 * tag + (proj >
//   split); at most max_depth + 1 levels; a pair at no leaf after them
//   reads the tree's statistics row 0.
// * the projection sums x[0] * v[0] ... x[D - 1] * v[D - 1] in that
//   order, each product and sum rounded on its own (__fmul_rn /
//   __fadd_rn, no contraction), so it differs from the twin's f32 sum
//   only in the order of the sums: a row can take another branch only
//   where its projection lies within rounding of a split
//   (utils/checks.walk_witness).
// * wmean: w_t = 1 - gini_t, S = w_0 + ... + w_{T-1} in tree order,
//   p_c = sum_t prop_tc * (w_t / (S + eps)) in tree order; wmax: p_c =
//   max_t prop_tc * w_t.  All float32, IEEE division.
//
// Tables (ops/kernels/forest_walk.py pack_tables, built once when the
// forest's tables are installed): vecs (trees, size, DPAD) with the
// projection vector in slots [0, D), zeros up to DPAD - 1 and the split
// in slot DPAD - 1; stats (trees, size, 1 + C) with gini then the C
// class proportions.  DPAD is the smallest register instance's width
// above D (a template argument), or past the widest the next multiple
// of 4 above D (the wide kernel's argument); D, C, the tree count, the
// size and the depth are the call's.
//
// Built as a plain C library (nvcc -shared) and called through ctypes:
// the launcher runs on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTrees = 64;
constexpr int kMaxClasses = 16;

// One thread a feature row: walk every tree, then the decision.
template <int DPAD>
__global__ void __launch_bounds__(kThreads) forest_walk_kernel(
    const float* __restrict__ data, const float* __restrict__ vecs,
    const float* __restrict__ stats, float* __restrict__ out,
    long long n_rows, int dim, int n_classes, int n_trees, int size,
    int max_depth, int wmax, float eps) {
  constexpr int kVec = DPAD / 4;
  const long long row = static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x;
  if (row >= n_rows) return;

  float x[DPAD - 1];
  const float* xr = data + row * dim;
#pragma unroll
  for (int i = 0; i < DPAD - 1; ++i) x[i] = i < dim ? __ldg(xr + i) : 0.f;

  const int width = 1 + n_classes;
  const unsigned last = static_cast<unsigned>(size - 1);
  int leaf[kMaxTrees];
  float total = 0.f;
  for (int t = 0; t < n_trees; ++t) {
    const float4* tree = reinterpret_cast<const float4*>(
        vecs + static_cast<size_t>(t) * size * DPAD);
    unsigned tag = 1, node = 0;
    for (int level = 0; level <= max_depth; ++level) {
      const float4* r = tree + static_cast<size_t>(min(tag, last)) * kVec;
      float v[DPAD];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float4 q = __ldg(r + k);
        v[4 * k] = q.x;
        v[4 * k + 1] = q.y;
        v[4 * k + 2] = q.z;
        v[4 * k + 3] = q.w;
      }
      const float split = v[DPAD - 1];
      if (isinf(split)) {
        node = tag;
        break;
      }
      float proj = __fmul_rn(x[0], v[0]);
#pragma unroll
      for (int i = 1; i < DPAD - 1; ++i)
        if (i < dim) proj = __fadd_rn(proj, __fmul_rn(x[i], v[i]));
      tag = (tag << 1) | (proj > split ? 1u : 0u);
    }
    leaf[t] = static_cast<int>(node);
    const float gini = __ldg(stats + (static_cast<size_t>(t) * size + node)
                                     * width);
    total = t == 0 ? __fsub_rn(1.f, gini)
                   : __fadd_rn(total, __fsub_rn(1.f, gini));
  }

  const float denom = __fadd_rn(total, eps);
  float acc[kMaxClasses] = {};
  for (int t = 0; t < n_trees; ++t) {
    const float* s = stats + (static_cast<size_t>(t) * size + leaf[t])
                             * width;
    const float w = __fsub_rn(1.f, __ldg(s));
    const float scale = wmax ? w : __fdiv_rn(w, denom);
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c < n_classes) {
        const float p = __fmul_rn(__ldg(s + 1 + c), scale);
        if (t == 0)
          acc[c] = p;
        else
          acc[c] = wmax ? (p > acc[c] ? p : acc[c]) : __fadd_rn(acc[c], p);
      }
    }
  }
  float* o = out + row * n_classes;
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c)
    if (c < n_classes) o[c] = acc[c];
}

// The leaf one tree's walk reaches for the feature row at xr, read from
// memory (0 where it stands at no leaf after max_depth + 1 levels).
__device__ unsigned walk_wide(const float* __restrict__ xr,
                              const float4* __restrict__ tree, int dim,
                              int kvec, unsigned last, int max_depth) {
  unsigned tag = 1;
  for (int level = 0; level <= max_depth; ++level) {
    const float4* r = tree + static_cast<size_t>(min(tag, last)) * kvec;
    const float split = __ldg(reinterpret_cast<const float*>(r + kvec) - 1);
    if (isinf(split)) return tag;
    float proj = 0.f;
    for (int k = 0; k < kvec; ++k) {
      const float4 q = __ldg(r + k);
      const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * k + j;
        if (i < dim) {
          const float p = __fmul_rn(__ldg(xr + i), v[j]);
          proj = i == 0 ? p : __fadd_rn(proj, p);
        }
      }
    }
    tag = (tag << 1) | (proj > split ? 1u : 0u);
  }
  return 0;
}

// One thread a feature row, for any width, tree count and class count.
__global__ void __launch_bounds__(kThreads) forest_walk_wide_kernel(
    const float* __restrict__ data, const float* __restrict__ vecs,
    const float* __restrict__ stats, float* __restrict__ out,
    long long n_rows, int dim, int dpad, int n_classes, int n_trees,
    int size, int max_depth, int wmax, float eps) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x;
  if (row >= n_rows) return;
  const float* xr = data + row * dim;
  const int kvec = dpad / 4;
  const int width = 1 + n_classes;
  const unsigned last = static_cast<unsigned>(size - 1);
  const float4* trees = reinterpret_cast<const float4*>(vecs);

  float denom = 0.f;
  if (!wmax) {
    float total = 0.f;
    for (int t = 0; t < n_trees; ++t) {
      const unsigned node = walk_wide(
          xr, trees + static_cast<size_t>(t) * size * kvec, dim, kvec, last,
          max_depth);
      const float gini = __ldg(stats + (static_cast<size_t>(t) * size
                                        + node) * width);
      total = t == 0 ? __fsub_rn(1.f, gini)
                     : __fadd_rn(total, __fsub_rn(1.f, gini));
    }
    denom = __fadd_rn(total, eps);
  }
  float* o = out + row * n_classes;
  for (int t = 0; t < n_trees; ++t) {
    const unsigned node = walk_wide(
        xr, trees + static_cast<size_t>(t) * size * kvec, dim, kvec, last,
        max_depth);
    const float* s = stats + (static_cast<size_t>(t) * size + node) * width;
    const float w = __fsub_rn(1.f, __ldg(s));
    const float scale = wmax ? w : __fdiv_rn(w, denom);
    for (int c = 0; c < n_classes; ++c) {
      const float p = __fmul_rn(__ldg(s + 1 + c), scale);
      if (t == 0)
        o[c] = p;
      else
        o[c] = wmax ? (p > o[c] ? p : o[c]) : __fadd_rn(o[c], p);
    }
  }
}

template <int DPAD>
void launch(cudaStream_t s, const float* data, const float* vecs,
            const float* stats, float* out, long long n_rows, int dim,
            int n_classes, int n_trees, int size, int max_depth, int wmax,
            float eps) {
  const unsigned blocks = static_cast<unsigned>(
      (n_rows + kThreads - 1) / kThreads);
  forest_walk_kernel<DPAD><<<blocks, kThreads, 0, s>>>(
      data, vecs, stats, out, n_rows, dim, n_classes, n_trees, size,
      max_depth, wmax, eps);
}

}  // namespace

// data (n_rows, dim), vecs (n_trees, size, dpad), stats (n_trees, size,
// 1 + n_classes) and out (n_rows, n_classes): contiguous float32 on
// `device`, vecs 16-byte aligned.  dpad: a multiple of 4 above dim; the
// register instances take 4 ... 32 by 4, 40, 48, 56 and 64 with at most
// kMaxTrees trees and kMaxClasses classes, the wide kernel the rest.
// wmax: nonzero for the weighted max, else the weighted mean with `eps`.
// Returns a cudaError_t.
extern "C" int forest_walk_launch(
    const float* data, const float* vecs, const float* stats, float* out,
    long long n_rows, int dim, int dpad, int n_classes, int n_trees,
    int size, int max_depth, int wmax, float eps, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dim < 1 || dim >= dpad || dpad % 4 || n_trees < 1 || n_classes < 1
      || size < 2 || max_depth < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool in_registers = n_trees <= kMaxTrees && n_classes <= kMaxClasses;
  switch (in_registers ? dpad : 0) {
#define FOREST_WALK_CASE(W)                                                \
    case W: launch<W>(s, data, vecs, stats, out, n_rows, dim, n_classes,  \
                      n_trees, size, max_depth, wmax, eps);               \
      break;
    FOREST_WALK_CASE(4)
    FOREST_WALK_CASE(8)
    FOREST_WALK_CASE(12)
    FOREST_WALK_CASE(16)
    FOREST_WALK_CASE(20)
    FOREST_WALK_CASE(24)
    FOREST_WALK_CASE(28)
    FOREST_WALK_CASE(32)
    FOREST_WALK_CASE(40)
    FOREST_WALK_CASE(48)
    FOREST_WALK_CASE(56)
    FOREST_WALK_CASE(64)
#undef FOREST_WALK_CASE
    default: {
      const unsigned blocks = static_cast<unsigned>(
          (n_rows + kThreads - 1) / kThreads);
      forest_walk_wide_kernel<<<blocks, kThreads, 0, s>>>(
          data, vecs, stats, out, n_rows, dim, dpad, n_classes, n_trees,
          size, max_depth, wmax, eps);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
