"""
The card the benchmark reckons against, and the least time the work of
the features needs on it.

Rates: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power
limit -- the CUDA-core float32 rate at the 1.98 GHz boost clock (132 SMs
x 128 lanes, one operation a lane and cycle), the dense bf16
tensor-core rate and the HBM3 rate.  Frozen from
``nimrud_tpu_torch.ops.kernels.multiscale_kernel`` (``CUDA_CORE_OPS``,
``TENSOR_FLOPS``, ``HBM_BYTES``, ``moment_bound``).

The work is what the features need, whatever implements them: per band,
the in-radius pairs of every query with the band's voxel centres (the
benchmark's reference counts them), each pair a distance test of
``DISTANCE_OPS`` float32 operations on the CUDA cores and its masked
sums (``MOMENT_COLS`` columns for the geometric layouts, 1 + A for the
``vector`` layout's A attribute columns, each a float32 product formed
as ``SPLIT_TERMS`` bf16 terms) on the tensor cores; and the bytes: the
served cloud read once, each band's voxel centres read once, and each
band's float32 sums a point written once.  The ``vector`` layout's
interp (:func:`interp_bound_s`) tests every raw point against the voxel
centres whose chebyshev ball of one edge holds it (``CHEBYSHEV_OPS``
operations a pair) and sums its 1 + A columns.
"""

CARD = "NVIDIA H100 80GB HBM3"
CUDA_CORE_OPS = 132 * 128 * 1.98e9      # float32 operations a second
TENSOR_FLOPS = 989e12                    # dense bf16, a second
HBM_BYTES = 3.35e12                      # bytes a second
DISTANCE_OPS = 8        # difference form: 3 sub, 3 mul, 2 add
CHEBYSHEV_OPS = 5       # 3 sub, 2 max (each |.| an operand modifier)
MOMENT_COLS = 10        # count and the nine moment terms
SPLIT_TERMS = 3         # bf16 hi + mid + lo of each float32 term
POINT_BYTES = 12        # three float32 coordinates


def _least(terms):
    term = max(terms, key=terms.get)
    return terms[term], term


def moments_terms(points, pairs, voxels, cols=MOMENT_COLS,
                  pair_ops=DISTANCE_OPS, voxel_bytes=POINT_BYTES):
    """The seconds of each term of one cloud's moment work on an H100
    (``distance``, ``tensor``, ``bytes``): ``points`` served points,
    ``pairs`` and ``voxels`` one entry a band; ``cols`` sums a pair and
    radius (10 moments, or 1 + A for the ``vector`` layout's attribute
    means), ``pair_ops`` operations a distance test, ``voxel_bytes``
    read a voxel centre (its coordinates, and for ``vector`` its A
    interpolated columns)."""
    total_pairs = float(sum(pairs))
    return {
        "distance": total_pairs * pair_ops / CUDA_CORE_OPS,
        "tensor": total_pairs * cols * SPLIT_TERMS * 2 / TENSOR_FLOPS,
        "bytes": (points * POINT_BYTES + sum(voxels) * voxel_bytes
                  + len(pairs) * points * cols * 4) / HBM_BYTES,
    }


def moments_bound_s(points, pairs, voxels, **kw):
    """The least seconds an H100 needs for one cloud's moment work
    (:func:`moments_terms`, with its keywords): (seconds, the term that
    bounds it)."""
    return _least(moments_terms(points, pairs, voxels, **kw))


def interp_terms(points, interp_pairs, voxels, cols):
    """The seconds of each term of one cloud's attribute interp on an
    H100: ``interp_pairs`` (raw point, voxel centre) pairs in the
    chebyshev ball and ``voxels`` centres, one entry a band, ``cols`` =
    1 + A sums a pair (the count and A columns); the bytes are the raw
    cloud and its A columns read once and each centre's ``cols`` sums
    written once."""
    total_pairs = float(sum(interp_pairs))
    return {
        "distance": total_pairs * CHEBYSHEV_OPS / CUDA_CORE_OPS,
        "tensor": total_pairs * cols * SPLIT_TERMS * 2 / TENSOR_FLOPS,
        "bytes": (points * (POINT_BYTES + 4 * (cols - 1))
                  + sum(voxels) * cols * 4) / HBM_BYTES,
    }


def interp_bound_s(points, interp_pairs, voxels, cols):
    """The least seconds an H100 needs for one cloud's attribute interp
    (:func:`interp_terms`): (seconds, the term that bounds it)."""
    return _least(interp_terms(points, interp_pairs, voxels, cols))
