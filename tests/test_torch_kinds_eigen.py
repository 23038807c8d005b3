"""
The two eigenvector- and eigenvalue-shaped kinds on the port's packed
path against the JAX package, as ``test_torch_kinds_packed.py`` holds
the others.  Their labels differ from the reference's at more points:

* ``oriented`` serves the xy components of the two smallest
  eigenvectors.  Their signs are arbitrary (they follow the branch the
  eigensolver takes, which rounding may change), and where two
  eigenvalues nearly coincide -- the bench scene's flat ground on the
  voxel lattice -- rounding may turn a vector anywhere in its plane.
* ``eigen`` serves ratios, an entropy and a cube root of the
  eigenvalues, which magnify the rounding noise of l3 (and l2) in flat
  and linear neighborhoods.

Every differing label away from a near-tie must have its witness
(``layouts.reconcile``): with the signs turned to the reference's and
the rounding-bound columns taken from it, the port's rows lie within
the feature tolerance of the reference's and give its labels.
"""

import pytest

from test_torch_kinds_packed import N, check_kind_serving


@pytest.mark.parametrize("kind", ["oriented", "eigen"])
def test_served_labels_match_reference_classifier(kind):
    report = check_kind_serving(kind)
    # the share the sign and the rounding-bound vectors move, measured
    # on this scene: 46 (oriented) and 1 (eigen) of 6000
    assert report["differ"] <= 0.02 * N
