// Host-side spatial binning of the port (the C++ host runtime of
// nimrud_tpu/native/tilesort.cpp, copied whole).
//
// The tiled neighbor-search plan (nimrud_tpu_torch/ops/grid.py) needs, per
// cloud: tile ids, a stable counting sort by tile, per-tile counts,
// fixed-capacity index tables, and voxel dedup; serving needs the cloud's
// bounds and its uint16 quantization.  At millions of points the
// vectorized-NumPy version of this costs tens of milliseconds to seconds;
// these single-pass C++ loops run at memory bandwidth.  Each function has
// a NumPy twin in nimrud_tpu_torch/ops/native.py that it must equal bit
// for bit.
//
// The three parallel loops (fill_table, neighbor_rows, quantize_u16) run
// on threads of their own (parallel_for below), where the reference runs
// its first two under OpenMP and the third on one thread: the port loads
// this library into a process that holds torch, whose own OpenMP runtime
// then serves the library's parallel regions too, and a small region
// there waited tens of milliseconds for torch's pool.  Plain threads
// share no runtime with torch.
//
// Built by nimrud_tpu_torch/ops/native.py (g++ -O3 -pthread, no
// -march=native, -ffp-contract=off), loaded via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include <sched.h>
#include <system_error>
#include <thread>

namespace {

// Worker threads for the parallel loops: the CPUs this process may run
// on (its affinity mask), one at the least.
int64_t worker_count() {
    cpu_set_t set;
    if (sched_getaffinity(0, sizeof(set), &set) != 0) return 1;
    return std::max(1, CPU_COUNT(&set));
}

// body(i) for i in [0, n), in static contiguous chunks over the workers
// (the caller's thread takes the first); loops of fewer than `grain`
// iterations a worker stay on the caller's thread.  Where a thread cannot
// be started, the caller runs the chunks left.  Returns the workers that
// ran, the caller's thread included.
template <class Body>
int64_t parallel_for(int64_t n, int64_t grain, Body body) {
    int64_t workers = std::min(worker_count(), n / grain);
    if (workers <= 1) {
        for (int64_t i = 0; i < n; ++i) body(i);
        return 1;
    }
    int64_t chunk = (n + workers - 1) / workers;
    auto run = [&body, n, chunk](int64_t w) {
        int64_t end = std::min(n, (w + 1) * chunk);
        for (int64_t i = w * chunk; i < end; ++i) body(i);
    };
    std::vector<std::thread> pool;
    try {
        for (int64_t w = 1; w < workers; ++w) pool.emplace_back(run, w);
    } catch (const std::system_error&) {
        // no thread to be had: an exception must not cross the C entry
    }
    int64_t started = static_cast<int64_t>(pool.size()) + 1;
    run(0);
    for (int64_t w = started; w < workers; ++w) run(w);
    for (auto& t : pool) t.join();
    return started;
}

// One row of uint16 grid steps: round((p - lo) / step), ties up, clipped
// to [0, 65535].  The division matches the NumPy twin bit for bit; do
// not pass a reciprocal.
inline void quantize_row(const float* p, const double* lo, double step,
                         uint16_t* out) {
    for (int axis = 0; axis < 3; ++axis) {
        double g = (static_cast<double>(p[axis]) - lo[axis]) / step;
        int64_t q = static_cast<int64_t>(g + 0.5);
        if (q < 0) q = 0;
        if (q > 65535) q = 65535;
        out[axis] = static_cast<uint16_t>(q);
    }
}

// Rows a block of quantize_u16, and the fewest blocks a worker takes
// (1M rows).  On an H100 machine's host (8 CPUs), threads started for a
// pass inside the serving loop began their rows 6-9 ms after the call,
// longer than one thread's whole pass over a 1M-row bucket (~7.3 ms),
// while a 16M-row bucket's pass fell from ~133 to ~28 ms on 8 workers.
// So every bucket up to 1M rows stays on the caller's thread.
constexpr int64_t kQuantizeBlock = 16384;
constexpr int64_t kQuantizeGrain = 64;

}  // namespace

extern "C" {

// Compute per-point tile ids on the (optionally factor-coarsened) grid
// and counting-sort the points by id.
//   pts:     n x 3 float32
//   lo:      grid origin (3 doubles)
//   edge:    tile edge length (division matches the NumPy oracle
//            bit-for-bit; do not pass a reciprocal)
//   dims:    fine-grid dimensions (3 int64)
//   factor:  coarsening factor (1 = fine grid)
//   ids_out:    n int32   (linear tile id per point, coarsened grid)
//   order_out:  n int32   (stable sort permutation by id)
//   counts_out: G int64   (per-tile counts; G = prod(ceil(dims/factor)))
// Returns 0 on success, -1 if the coarsened grid exceeds int32 ids.
int64_t tile_sort(const float* pts, int64_t n,
                  const double* lo, double edge,
                  const int64_t* dims, int64_t factor,
                  int32_t* ids_out, int32_t* order_out,
                  int64_t* counts_out) {
    int64_t qd0 = (dims[0] + factor - 1) / factor;
    int64_t qd1 = (dims[1] + factor - 1) / factor;
    int64_t qd2 = (dims[2] + factor - 1) / factor;
    int64_t grid = qd0 * qd1 * qd2;
    if (grid > INT32_MAX) return -1;

    std::memset(counts_out, 0, sizeof(int64_t) * grid);

    for (int64_t i = 0; i < n; ++i) {
        const float* p = pts + 3 * i;
        int64_t c[3];
        for (int axis = 0; axis < 3; ++axis) {
            double g = std::floor(
                (static_cast<double>(p[axis]) - lo[axis]) / edge);
            int64_t gi = static_cast<int64_t>(g);
            if (gi < 0) gi = 0;
            if (gi > dims[axis] - 1) gi = dims[axis] - 1;
            c[axis] = gi / factor;
        }
        int64_t id = c[0] + c[1] * qd0 + c[2] * qd0 * qd1;
        ids_out[i] = static_cast<int32_t>(id);
        counts_out[id] += 1;
    }

    // exclusive prefix -> cursors, then stable scatter
    std::vector<int64_t> cursor(grid);
    int64_t running = 0;
    for (int64_t g = 0; g < grid; ++g) {
        cursor[g] = running;
        running += counts_out[g];
    }
    for (int64_t i = 0; i < n; ++i) {
        order_out[cursor[ids_out[i]]++] = static_cast<int32_t>(i);
    }
    return 0;
}

// Fill a (K+1) x cap index table: row k holds the sorted-order point
// indices of tile wanted[k] (padded with -1; the trailing row stays all
// -1 as the "empty tile" row).
void fill_table(const int32_t* order, const int64_t* starts_all,
                const int64_t* counts_all, const int64_t* wanted,
                int64_t n_wanted, int64_t cap, int32_t* out) {
    parallel_for(n_wanted, 8192, [=](int64_t k) {
        int64_t tile = wanted[k];
        int64_t start = starts_all[tile];
        int64_t count = counts_all[tile];
        if (count > cap) count = cap;
        std::memcpy(out + k * cap, order + start,
                    sizeof(int32_t) * count);
        std::memset(out + k * cap + count, 0xFF,
                    sizeof(int32_t) * (cap - count));
    });
    std::memset(out + n_wanted * cap, 0xFF, sizeof(int32_t) * cap);
}

// Mark every fine-grid tile adjacent (offsets -1..m per axis) to one of
// the given coarse query tiles.  mask must be G zeroed bytes.
void mark_neighbors(const int64_t* tile_ids, int64_t n_tiles,
                    const int64_t* dims, const int64_t* qdims,
                    int64_t m, uint8_t* mask) {
    for (int64_t t = 0; t < n_tiles; ++t) {
        int64_t id = tile_ids[t];
        int64_t b0 = (id % qdims[0]) * m;
        int64_t b1 = ((id / qdims[0]) % qdims[1]) * m;
        int64_t b2 = (id / (qdims[0] * qdims[1])) * m;
        for (int64_t dz = -1; dz <= m; ++dz) {
            int64_t z = b2 + dz;
            if (z < 0 || z >= dims[2]) continue;
            for (int64_t dy = -1; dy <= m; ++dy) {
                int64_t y = b1 + dy;
                if (y < 0 || y >= dims[1]) continue;
                int64_t rowbase = y * dims[0] + z * dims[0] * dims[1];
                for (int64_t dx = -1; dx <= m; ++dx) {
                    int64_t x = b0 + dx;
                    if (x < 0 || x >= dims[0]) continue;
                    mask[rowbase + x] = 1;
                }
            }
        }
    }
}

// Candidate-table row index for every (query tile, neighbor offset):
// grid_row[nid] for in-bounds neighbors, empty_row otherwise.
// out has n_tiles * (m+2)^3 int32 slots, offset order x-fastest.
void neighbor_rows(const int64_t* tile_ids, int64_t n_tiles,
                   const int64_t* dims, const int64_t* qdims,
                   int64_t m, const int32_t* grid_row,
                   int32_t empty_row, int32_t* out) {
    int64_t span = m + 2;
    parallel_for(n_tiles, 2048, [=](int64_t t) {
        int64_t id = tile_ids[t];
        int64_t b0 = (id % qdims[0]) * m;
        int64_t b1 = ((id / qdims[0]) % qdims[1]) * m;
        int64_t b2 = (id / (qdims[0] * qdims[1])) * m;
        int32_t* row = out + t * span * span * span;
        int64_t slot = 0;
        for (int64_t dx = -1; dx <= m; ++dx) {
            for (int64_t dy = -1; dy <= m; ++dy) {
                for (int64_t dz = -1; dz <= m; ++dz) {
                    int64_t x = b0 + dx, y = b1 + dy, z = b2 + dz;
                    if (x < 0 || x >= dims[0] || y < 0 || y >= dims[1]
                        || z < 0 || z >= dims[2]) {
                        row[slot++] = empty_row;
                    } else {
                        row[slot++] = grid_row[
                            x + y * dims[0] + z * dims[0] * dims[1]];
                    }
                }
            }
        }
    });
}

// Voxel dedup: unique occupied cells of a 64-bit-addressable grid,
// returned as cell center coordinates (float32), sorted by linear cell
// id (z-major, matching the VoxelFilter address order).  Returns the
// number of unique cells; centers_out must hold n*3 floats.
int64_t voxel_unique(const float* pts, int64_t n,
                     const double* lo, double edge,
                     const int64_t* dims, float* centers_out) {
    std::vector<int64_t> keys(n);
    for (int64_t i = 0; i < n; ++i) {
        const float* p = pts + 3 * i;
        int64_t c[3];
        for (int axis = 0; axis < 3; ++axis) {
            double g = std::floor(
                (static_cast<double>(p[axis]) - lo[axis]) / edge);
            int64_t gi = static_cast<int64_t>(g);
            if (gi < 0) gi = 0;
            if (gi > dims[axis] - 1) gi = dims[axis] - 1;
            c[axis] = gi;
        }
        keys[i] = c[0] + c[1] * dims[0] + c[2] * dims[0] * dims[1];
    }
    std::sort(keys.begin(), keys.end());

    int64_t unique = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (i > 0 && keys[i] == keys[i - 1]) continue;
        int64_t key = keys[i];
        int64_t c0 = key % dims[0];
        int64_t c1 = (key / dims[0]) % dims[1];
        int64_t c2 = key / (dims[0] * dims[1]);
        centers_out[3 * unique + 0] =
            static_cast<float>((c0 + 0.5) * edge + lo[0]);
        centers_out[3 * unique + 1] =
            static_cast<float>((c1 + 0.5) * edge + lo[1]);
        centers_out[3 * unique + 2] =
            static_cast<float>((c2 + 0.5) * edge + lo[2]);
        unique += 1;
    }
    return unique;
}

// Quantize float32 coordinates to uint16 grid steps (quantize_row) into
// `rows` >= count rows of out: rows [count, rows) repeat row count - 1,
// the device grid's padding (zeros where count is 0).  One pass, used to
// halve host->device transfer volume; the rows are independent, so
// blocks of them run over parallel_for's workers with the same bits.
// Returns the workers used.
int64_t quantize_u16(const float* pts, int64_t count, int64_t rows,
                     const double* lo, double step, uint16_t* out) {
    uint16_t pad[3] = {0, 0, 0};
    if (count > 0) quantize_row(pts + 3 * (count - 1), lo, step, pad);
    int64_t blocks = (rows + kQuantizeBlock - 1) / kQuantizeBlock;
    return parallel_for(blocks, kQuantizeGrain, [=](int64_t b) {
        int64_t start = b * kQuantizeBlock;
        int64_t end = std::min(rows, start + kQuantizeBlock);
        int64_t split = std::max(start, std::min(end, count));
        for (int64_t i = start; i < split; ++i)
            quantize_row(pts + 3 * i, lo, step, out + 3 * i);
        for (int64_t i = split; i < end; ++i)
            std::memcpy(out + 3 * i, pad, sizeof(pad));
    });
}

// Per-axis min/max of an (n, 3) float32 cloud in one pass.  The hot
// serving path needs cloud bounds for grid specs AND quantization; this
// replaces several numpy reductions with one scan.
void minmax3(const float* pts, int64_t n, float* lo, float* hi) {
    if (n <= 0) return;
    float lo0 = pts[0], lo1 = pts[1], lo2 = pts[2];
    float hi0 = pts[0], hi1 = pts[1], hi2 = pts[2];
    for (int64_t i = 1; i < n; ++i) {
        const float* p = pts + 3 * i;
        if (p[0] < lo0) lo0 = p[0];
        if (p[0] > hi0) hi0 = p[0];
        if (p[1] < lo1) lo1 = p[1];
        if (p[1] > hi1) hi1 = p[1];
        if (p[2] < lo2) lo2 = p[2];
        if (p[2] > hi2) hi2 = p[2];
    }
    lo[0] = lo0; lo[1] = lo1; lo[2] = lo2;
    hi[0] = hi0; hi[1] = hi1; hi[2] = hi2;
}

// Fast delimited-ASCII point parser: reads up to max_rows rows of
// exactly `cols` numeric fields separated by commas/whitespace.
// Returns rows parsed, or -1 on malformed input.
int64_t parse_ascii(const char* text, int64_t length, int64_t cols,
                    int64_t max_rows, float* out) {
    const char* cursor = text;
    const char* end = text + length;
    int64_t rows = 0;
    while (cursor < end && rows < max_rows) {
        // skip blank / comment lines
        while (cursor < end && (*cursor == '\n' || *cursor == '\r'))
            ++cursor;
        if (cursor >= end) break;
        if (*cursor == '#') {
            while (cursor < end && *cursor != '\n') ++cursor;
            continue;
        }
        for (int64_t c = 0; c < cols; ++c) {
            char* after = nullptr;
            float value = std::strtof(cursor, &after);
            if (after == cursor) return -1;
            out[rows * cols + c] = value;
            cursor = after;
            while (cursor < end &&
                   (*cursor == ',' || *cursor == ' ' || *cursor == '\t'
                    || *cursor == ';'))
                ++cursor;
        }
        while (cursor < end && *cursor != '\n') ++cursor;
        ++rows;
    }
    return rows;
}

}  // extern "C"
