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
sums (``MOMENT_COLS`` columns, each a float32 product formed as
``SPLIT_TERMS`` bf16 terms) on the tensor cores; and the bytes: the
served cloud read once, each band's voxel centres read once, and each
band's ``MOMENT_COLS`` float32 sums a point written once.
"""

CARD = "NVIDIA H100 80GB HBM3"
CUDA_CORE_OPS = 132 * 128 * 1.98e9      # float32 operations a second
TENSOR_FLOPS = 989e12                    # dense bf16, a second
HBM_BYTES = 3.35e12                      # bytes a second
DISTANCE_OPS = 8        # difference form: 3 sub, 3 mul, 2 add
MOMENT_COLS = 10        # count and the nine moment terms
SPLIT_TERMS = 3         # bf16 hi + mid + lo of each float32 term
POINT_BYTES = 12        # three float32 coordinates


def moments_bound_s(points, pairs, voxels):
    """The least seconds an H100 needs for one cloud's moment work:
    ``points`` served points, ``pairs`` and ``voxels`` one entry a band.
    Returns (seconds, the term that bounds it)."""
    total_pairs = float(sum(pairs))
    terms = {
        "distance": total_pairs * DISTANCE_OPS / CUDA_CORE_OPS,
        "tensor": total_pairs * MOMENT_COLS * SPLIT_TERMS * 2 / TENSOR_FLOPS,
        "bytes": (points * POINT_BYTES + sum(voxels) * POINT_BYTES
                  + len(pairs) * points * MOMENT_COLS * 4) / HBM_BYTES,
    }
    term = max(terms, key=terms.get)
    return terms[term], term
