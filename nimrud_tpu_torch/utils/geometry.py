"""
Host-side spatial indexing: voxel filtering and nested (buffered) spatial
partitioning (copy of ``nimrud_tpu/utils/geometry.py``, host NumPy,
float64 where the input is).

These are the NumPy data-structure layer of the framework: the full
64-bit voxel address contract (``features.multiscale
.extract_scaleset_device`` sorts its queries by these addresses before
the dense method, as the reference does; ``archive.store`` keeps one
real point a voxel with them), and the partition planners of the
out-of-core outer loop.

Capability parity (reference: nimrud/utils/geometry.py):
  * ``VoxelFilter``         -- bit-packed integer voxel addresses (:16-172)
  * ``nested_regions``      -- buffered query/search region indexing (:203-253)
  * ``NestedOctree``        -- recursive buffered octree partitioner (:257-411;
                               the reference left ``partition`` and two cube
                               generators unfinished -- implemented fully here)
  * ``ProceduralNestedPartitioner`` -- cell-glomming partitioner (:451-508,
                               a docstring and a raise in the reference)
  * ``NestedGrid``          -- uniform-cube partitioner (:415-441; stub in the
                               reference, implemented fully here)
"""

from itertools import product

import numpy as np

# Voxel addresses must fit one signed 64-bit integer.
MAX_ADDRESS_LENGTH = 64


# ---------------------------------------------------------------------------
# voxel filter
# ---------------------------------------------------------------------------

class VoxelFilter:
    """
    A cubic grid over a 2-D or 3-D point cloud.  Point coordinates map to a
    single integer address by packing the per-axis grid coordinates into
    disjoint bit fields; addresses map back to voxel-center coordinates.

    The grid's first voxel (address 0) is centered on the minimum corner of
    the input cloud: the bounding region is expanded by half an edge length
    on every side.
    """

    def __init__(self, points, edge_length):
        points = np.asarray(points)
        if points.ndim != 2:
            raise ValueError("point cloud must be a 2-D array (rows = points)")
        if points.shape[1] not in (2, 3):
            raise ValueError("only 2-D and 3-D point clouds are supported")
        if points.shape[0] < 2:
            raise ValueError("need at least 2 points to define a voxel grid")

        self.edge_length = edge_length
        self.minimum_corner = points.min(0) - edge_length / 2
        self.maximum_corner = points.max(0) + edge_length / 2

        self.shifts, self.widths = self._calculate_shift()
        self.masks = self._calculate_masks()

    # -- address layout ----------------------------------------------------

    def _calculate_shift(self):
        """
        Decide how many address bits each axis needs and where each axis'
        bit field starts.  Raises if the total exceeds the 64-bit budget.
        """
        span = self.maximum_corner - self.minimum_corner
        widths = np.ceil(np.log2(span / self.edge_length))
        if widths.sum() > MAX_ADDRESS_LENGTH:
            raise ValueError(
                "edge length too small: this region needs "
                f"{int(widths.sum())} address bits (max {MAX_ADDRESS_LENGTH})")
        shifts = np.cumsum(widths)[:-1]
        return shifts.astype(np.int64), widths.astype(np.int64)

    def _calculate_masks(self):
        """Per-axis bit masks for extracting grid coordinates from addresses."""
        field = [(1 << int(w)) - 1 for w in self.widths]
        out = [field[0]]
        for width_bits, shift in zip(field[1:], self.shifts):
            out.append(width_bits << int(shift))
        return out

    # -- validation ---------------------------------------------------------

    def _check_in_bounds(self, points):
        """
        Validate that ``points`` live inside this filter's bounding region
        with the right dimensionality.  Returns an at-least-2-D view.
        """
        points = np.atleast_2d(points)
        if points.ndim != 2:
            raise ValueError("wrong array shape for a point cloud")
        if points.shape[1] != self.widths.size:
            raise ValueError("wrong number of spatial dimensions")
        if (np.any(points.min(0) < self.minimum_corner)
                or np.any(points.max(0) > self.maximum_corner)):
            raise ValueError("points fall outside the filter's bounding region")
        return points

    # -- transforms ----------------------------------------------------------

    def coordinate_to_address(self, points):
        """Real-world coordinates -> packed integer voxel addresses."""
        points = self._check_in_bounds(points)
        grid = np.floor(
            (points - self.minimum_corner) / self.edge_length).astype(np.int64)
        address = grid[:, 0].copy()
        for axis, shift in enumerate(self.shifts, start=1):
            # fields are disjoint, so OR == add
            address |= grid[:, axis] << shift
        return address

    def address_to_coordinate(self, addresses):
        """Packed integer voxel addresses -> voxel-center coordinates."""
        addresses = np.atleast_1d(addresses)
        columns = [(addresses & self.masks[0]).reshape(-1, 1)]
        for mask, shift in zip(self.masks[1:], self.shifts):
            columns.append(((addresses & mask) >> shift).reshape(-1, 1))
        grid = np.concatenate(columns, axis=1)
        # +0.5 edge: voxel center, not minimum corner
        return (grid * self.edge_length
                + self.minimum_corner
                + self.edge_length * 0.5)

    def unique_voxels(self, points):
        """Center coordinates of every grid cell occupied by ``points``."""
        addresses = self.coordinate_to_address(points)
        return self.address_to_coordinate(np.unique(addresses))

    # -- adjacency -----------------------------------------------------------

    def _neighbor_addresses(self, address, offsets):
        """Addresses of in-bounds voxels at the given grid offsets."""
        grid = self.address_to_coordinate(address)
        grid = np.floor(
            (grid - self.minimum_corner) / self.edge_length).astype(np.int64)
        candidates = grid + offsets
        # reject cells outside the addressable grid
        limits = np.floor(
            (self.maximum_corner - self.minimum_corner) / self.edge_length
        ).astype(np.int64)
        keep = np.all((candidates >= 0) & (candidates <= limits), axis=1)
        candidates = candidates[keep]
        address = candidates[:, 0].copy()
        for axis, shift in enumerate(self.shifts, start=1):
            address |= candidates[:, axis] << shift
        return address

    def find_neighbors(self, address):
        """
        Addresses of every voxel directly adjacent to ``address`` (sharing a
        face, edge or corner): up to 8 in 2-D, 26 in 3-D.  (Unimplemented in
        the reference; implemented here.)
        """
        dim = self.widths.size
        offsets = np.array(
            [o for o in product((-1, 0, 1), repeat=dim) if any(o)],
            dtype=np.int64)
        return self._neighbor_addresses(address, offsets)

    def find_facing_neighbors(self, address):
        """
        Addresses of every voxel sharing an edge (2-D) or face (3-D) with
        ``address``: up to 4 in 2-D, 6 in 3-D.  (Unimplemented in the
        reference; implemented here.)
        """
        dim = self.widths.size
        offsets = []
        for axis in range(dim):
            for sign in (-1, 1):
                o = [0] * dim
                o[axis] = sign
                offsets.append(o)
        return self._neighbor_addresses(address, np.asarray(offsets, np.int64))


# ---------------------------------------------------------------------------
# nested partitioning
# ---------------------------------------------------------------------------
#
# Two colocated clouds -- a query set and a search space -- are partitioned
# simultaneously: query partitions tile the query set without overlap, and
# each search partition is the query partition's box *expanded by a buffer
# radius* on every side (a halo), so a tile can compute every query point's
# full neighborhood independently.  This buffered-region semantics is what
# the reference's multi-chip tile sharding replicates with halo exchange.


def nested_regions(query_set, search_space, buffer_radius,
                   minimum_corner, maximum_corner):
    """
    Index every query point inside the box [minimum_corner, maximum_corner]
    and every search point inside that box expanded by ``buffer_radius``.
    Returns ``(query_indices, search_indices)``.
    """

    def box_indices(points, low, high):
        # Skip per-axis comparisons that cannot exclude any point.
        lo_pt = points.min(0)
        hi_pt = points.max(0)
        mask = None
        for axis in range(points.shape[1]):
            column = points[:, axis]
            if lo_pt[axis] < low[axis]:
                m = column >= low[axis]
                mask = m if mask is None else (mask & m)
            if hi_pt[axis] > high[axis]:
                m = column <= high[axis]
                mask = m if mask is None else (mask & m)
        if mask is None:
            return np.arange(points.shape[0])
        return mask.nonzero()[0]

    query_idx = box_indices(query_set, minimum_corner, maximum_corner)
    search_idx = box_indices(
        search_space,
        minimum_corner - buffer_radius,
        maximum_corner + buffer_radius)
    return query_idx, search_idx


def _validate_cloud_3d(points):
    if points.ndim != 2:
        raise ValueError("wrong point cloud array shape")
    if points.shape[1] != 3:
        raise ValueError("only 3-D point clouds are supported")
    if points.shape[0] < 2:
        raise ValueError("need at least 2 points to partition")


class NestedOctree:
    """
    Recursive buffered octree partitioner.

    Each level bounds the *query set* and, if the buffered search population
    exceeds ``max_population``, splits the region into 8 cubes.  Cubes whose
    edge is still much larger than the buffer radius recurse as octrees;
    small cubes hand off to a :class:`NestedGrid`.  ``partition_generator``
    yields ``(query_indices, search_indices)`` pairs, indices into the
    clouds this instance was constructed with.

    The reference sketched this class but left the recursion and two of the
    three cube generators unfinished; this implementation is complete.
    """

    def __init__(self, query_set, search_space, buffer_radius):
        _validate_cloud_3d(query_set)
        _validate_cloud_3d(search_space)
        if buffer_radius <= 0:
            raise ValueError("buffer radius must be positive")

        self.query_set = query_set
        self.search_space = search_space
        self.buffer_radius = buffer_radius
        self.minimum_corner = query_set.min(0)
        self.maximum_corner = query_set.max(0)
        self.cubes = []

        self.cube_generators = {
            "naive": self._naive_cube_generator,
            "take_one": self._take_one_cube_generator,
            "take_three": self._take_three_cube_generator,
        }

    # -- cube generation ----------------------------------------------------

    def _cube_bounds(self, cube_edge):
        """Min/max corners of the 8 equal cubes covering the query bounds."""
        offsets = np.asarray(list(product((0, 1), repeat=3)))
        lows = offsets * cube_edge + self.minimum_corner
        return lows, lows + cube_edge

    def _naive_cube_generator(self, cube_edge):
        """One independent nested_regions call per cube."""
        lows, highs = self._cube_bounds(cube_edge)
        for low, high in zip(lows, highs):
            q_idx, s_idx = nested_regions(
                self.query_set, self.search_space, self.buffer_radius,
                low, high)
            yield (self.query_set.take(q_idx, axis=0),
                   self.search_space.take(s_idx, axis=0))

    def _take_one_cube_generator(self, cube_edge):
        """
        Split each cloud once along the first axis, then run the remaining
        box test only on the matching half.  One big take per half instead
        of eight full-cloud scans.
        """
        lows, highs = self._cube_bounds(cube_edge)
        mid = self.minimum_corner[0] + cube_edge

        halves = {}
        for side, keep in (
                (0, self.query_set[:, 0] <= mid),
                (1, self.query_set[:, 0] >= mid)):
            halves[("q", side)] = self.query_set[keep]
        for side, keep in (
                (0, self.search_space[:, 0] <= mid + self.buffer_radius),
                (1, self.search_space[:, 0] >= mid - self.buffer_radius)):
            halves[("s", side)] = self.search_space[keep]

        for low, high, offset in zip(lows, highs,
                                     product((0, 1), repeat=3)):
            side = offset[0]
            q_half = halves[("q", side)]
            s_half = halves[("s", side)]
            q_idx, s_idx = nested_regions(
                q_half, s_half, self.buffer_radius, low, high)
            yield (q_half.take(q_idx, axis=0), s_half.take(s_idx, axis=0))

    def _take_three_cube_generator(self, cube_edge):
        """
        Precompute the six half-space masks (two per axis) once, and build
        each cube's membership as a 3-way AND.  No repeated comparisons.
        """
        lo = self.minimum_corner
        mid = lo + cube_edge
        hi = lo + 2 * cube_edge

        def axis_masks(points, slack):
            # per axis: membership in the low cube [lo, mid] and the high
            # cube [mid, hi], each expanded by slack
            lows, highs = [], []
            for axis in range(3):
                column = points[:, axis]
                lows.append((column >= lo[axis] - slack)
                            & (column <= mid[axis] + slack))
                highs.append((column >= mid[axis] - slack)
                             & (column <= hi[axis] + slack))
            return lows, highs

        q_low, q_high = axis_masks(self.query_set, 0.0)
        s_low, s_high = axis_masks(self.search_space, self.buffer_radius)

        for offset in product((0, 1), repeat=3):
            q_mask = np.ones(self.query_set.shape[0], dtype=bool)
            s_mask = np.ones(self.search_space.shape[0], dtype=bool)
            for axis, side in enumerate(offset):
                if side == 0:
                    q_mask &= q_low[axis]
                    s_mask &= s_low[axis]
                else:
                    q_mask &= q_high[axis]
                    s_mask &= s_high[axis]
            yield self.query_set[q_mask], self.search_space[s_mask]

    def cube_generator(self, cube_edge, algorithm="naive"):
        """
        Yield ``(query_points, search_points)`` for each of the 8 cubes of
        edge ``cube_edge`` covering this octree's query bounds.
        """
        try:
            generate = self.cube_generators[algorithm]
        except KeyError:
            raise NameError(
                f"{algorithm!r} is not a known cube generator algorithm")
        yield from generate(cube_edge)

    # -- recursive partitioning ----------------------------------------------

    def partition(self, max_population, minimum_factor=3):
        """
        Recursively partition until every region's *buffered search
        population* is at most ``max_population``.  Regions whose cube edge
        falls below ``minimum_factor * buffer_radius`` stop recursing and
        finish with a NestedGrid instead (an octree level would no longer
        shrink the halo overhead meaningfully).
        """
        local = nested_regions(
            self.query_set, self.search_space, self.buffer_radius,
            self.minimum_corner, self.maximum_corner)

        if local[1].size <= max_population:
            self.cubes.append(local)
            return

        cube_edge = max(self.maximum_corner - self.minimum_corner) * 0.5
        offsets = np.asarray(list(product((0, 1), repeat=3)))
        lows = offsets * cube_edge + self.minimum_corner
        # rounded low+edge sums can land one ulp below the true region
        # corner, silently orphaning extreme points -- clamp outer faces
        # to the exact region bound
        highs = np.where(offsets == 1,
                         np.maximum(lows + cube_edge, self.maximum_corner),
                         lows + cube_edge)
        for low, high in zip(lows, highs):
            q_idx, s_idx = nested_regions(
                self.query_set, self.search_space, self.buffer_radius,
                low, high)
            if q_idx.size == 0:
                continue
            if s_idx.size <= max_population:
                self.cubes.append((q_idx, s_idx))
                continue
            sub_query = self.query_set.take(q_idx, axis=0)
            sub_search = self.search_space.take(s_idx, axis=0)
            if (cube_edge > minimum_factor * self.buffer_radius
                    and sub_query.shape[0] >= 2 and sub_search.shape[0] >= 2):
                child = NestedOctree(sub_query, sub_search, self.buffer_radius)
                child.partition(max_population, minimum_factor)
            else:
                child = NestedGrid(sub_query, sub_search, self.buffer_radius,
                                   max_population)
            # remap the child's local indices into this level's clouds
            self.cubes.append((child, q_idx, s_idx))

    def partition_generator(self):
        """
        Yield ``(query_indices, search_indices)`` for every leaf partition,
        in this instance's index space.
        """
        for cube in self.cubes:
            if isinstance(cube, tuple) and len(cube) == 3:
                child, q_map, s_map = cube
                for q_idx, s_idx in child.partition_generator():
                    yield q_map.take(q_idx), s_map.take(s_idx)
            else:
                yield cube


class ProceduralNestedPartitioner:
    """
    Cell-glomming nested partitioner.

    The reference described this algorithm in a docstring and raised on
    construction (reference: nimrud/utils/geometry.py:451-508); this is a
    working implementation of that design: build a voxel grid with edge
    = buffer_radius over both clouds, then grow partitions by greedily
    glomming face-adjacent query cells while the union of their
    26-neighborhoods' search population stays within ``max_population``.
    A query cell whose own neighborhood exceeds the budget is yielded as
    a singleton (the reference's "let the user decide" case).

    ``partition_generator`` yields ``(query_indices, search_indices)``;
    every query point appears in exactly one partition, and each
    partition's search set contains every search point within
    buffer_radius (Chebyshev) of its query cells.
    """

    def __init__(self, query_set, search_space, buffer_radius,
                 max_population, num_tries=5, seed=0):
        _validate_cloud_3d(query_set)
        _validate_cloud_3d(search_space)
        if buffer_radius <= 0:
            raise ValueError("buffer radius must be positive")
        self.query_set = query_set
        self.search_space = search_space
        self.buffer_radius = buffer_radius
        self.max_population = max_population
        self.num_tries = num_tries
        self.seed = seed

        both = np.vstack([query_set, search_space])
        self._filter = VoxelFilter(both, buffer_radius)
        self._query_cells = self._bucket(query_set)
        self._search_cells = self._bucket(search_space)

    def _bucket(self, points):
        addresses = self._filter.coordinate_to_address(points)
        order = np.argsort(addresses, kind="stable")
        sorted_addr = addresses[order]
        uniq, starts = np.unique(sorted_addr, return_index=True)
        stops = np.append(starts[1:], len(points))
        return {int(a): order[lo:hi]
                for a, lo, hi in zip(uniq, starts, stops)}

    def _neighborhood(self, address):
        """The cell and its 26 neighbors (covers the buffer radius)."""
        cells = {int(address)}
        cells.update(
            int(a) for a in self._filter.find_neighbors(
                np.asarray([address])))
        return cells

    def _search_count(self, cells):
        return sum(len(self._search_cells.get(c, ())) for c in cells)

    def partition_generator(self):
        rng = np.random.RandomState(self.seed)
        remaining = dict(self._query_cells)
        while remaining:
            keys = sorted(remaining)
            cell = keys[rng.randint(len(keys))]
            region = self._neighborhood(cell)
            if self._search_count(region) > self.max_population:
                # oversized single-cell neighborhood: yield as-is
                query_idx = remaining.pop(cell)
                yield query_idx, self._collect_search(region)
                continue

            accepted = {cell}
            search_cells = set(region)
            rejected = set()
            frontier = [cell]
            while frontier:
                candidates = []
                for f in frontier:
                    for n in self._filter.find_facing_neighbors(
                            np.asarray([f])):
                        n = int(n)
                        if (n in remaining and n not in accepted
                                and n not in rejected):
                            candidates.append(n)
                if not candidates:
                    break
                frontier = []
                for candidate in candidates[:self.num_tries * 4]:
                    if candidate in accepted or candidate in rejected:
                        continue
                    proposal = search_cells \
                        | self._neighborhood(candidate)
                    if self._search_count(proposal) > self.max_population:
                        rejected.add(candidate)
                    else:
                        accepted.add(candidate)
                        search_cells = proposal
                        frontier.append(candidate)

            query_idx = np.concatenate(
                [remaining.pop(c) for c in sorted(accepted)])
            yield query_idx, self._collect_search(search_cells)

    def _collect_search(self, cells):
        found = [self._search_cells[c] for c in sorted(cells)
                 if c in self._search_cells]
        if not found:
            return np.empty(0, dtype=np.int64)
        return np.sort(np.concatenate(found))


class NestedGrid:
    """
    Single-level buffered partitioner: a uniform tiling of identical cubes
    over the query bounds.  The cube edge starts at the full region span and
    shrinks geometrically until every cube's buffered search population
    satisfies ``max_population`` (or a minimum edge of one buffer radius is
    reached, at which point the constraint is unsatisfiable and the best
    effort tiling is kept).

    Stub in the reference; implemented fully here (the shrink strategy
    follows the reference's legacy ``_rigid`` rulebook: geometric shrink
    with a hard floor, reference nimrud/prototypes/mso.py:931-1035).
    """

    SHRINK = 0.7

    def __init__(self, query_set, search_space, buffer_radius,
                 max_population):
        _validate_cloud_3d(query_set)
        _validate_cloud_3d(search_space)
        if buffer_radius <= 0:
            raise ValueError("buffer radius must be positive")
        self.query_set = query_set
        self.search_space = search_space
        self.buffer_radius = buffer_radius
        self.max_population = max_population
        self.minimum_corner = query_set.min(0)
        self.maximum_corner = query_set.max(0)
        self.cubes = []
        self._build()

    def _tiling(self, edge):
        """Partition with cubes of the given edge; return list + max pop."""
        span = self.maximum_corner - self.minimum_corner
        counts = np.maximum(1, np.ceil(span / edge).astype(int))
        cubes = []
        worst = 0
        for offset in product(*(range(c) for c in counts)):
            offset = np.asarray(offset)
            low = self.minimum_corner + offset * edge
            # clamp outermost cubes to the exact region bound so rounded
            # low+edge sums cannot orphan extreme points
            high = np.where(offset == counts - 1,
                            np.maximum(low + edge, self.maximum_corner),
                            low + edge)
            q_idx, s_idx = nested_regions(
                self.query_set, self.search_space, self.buffer_radius,
                low, high)
            if q_idx.size == 0:
                continue
            worst = max(worst, s_idx.size)
            cubes.append((q_idx, s_idx))
        return cubes, worst

    def _build(self):
        edge = float(max(self.maximum_corner - self.minimum_corner))
        if edge <= 0:
            edge = self.buffer_radius
        floor = self.buffer_radius
        while True:
            cubes, worst = self._tiling(edge)
            if worst <= self.max_population or edge <= floor:
                self.cubes = cubes
                return
            edge *= self.SHRINK

    def partition_generator(self):
        """Yield ``(query_indices, search_indices)`` per cube."""
        yield from self.cubes
