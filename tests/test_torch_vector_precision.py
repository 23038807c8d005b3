"""
``precision="bf16x2"`` threaded through the port's serving path: a
bench model of the port and of the JAX package, both at bf16x2, serve
another cloud with the reference's fitted classifier; counters equal
(0) and labels equal except at reference near-ties.  For ``minimal``
(the main path) and ``vector`` (the attribute instance; the interp sums
at "highest" in both, as the reference's does).
"""

import pytest

from nimrud_tpu.utils import workload as jwl

from nimrud_tpu_torch.utils import workload as twl
from test_torch_pipeline import _carried
from test_torch_vector_pipeline import N, SAMPLE, serve_both


@pytest.mark.parametrize("kind", ["minimal", "vector"])
def test_bf16x2_labels_match_reference(kind):
    cloud, labels = twl.make_bench_cloud(N, seed=0)
    other, truth = twl.make_bench_cloud(N, seed=2)
    attrs = serve_attrs = None
    if kind == "vector":
        attrs = twl.make_bench_attributes(labels)
        serve_attrs = twl.make_bench_attributes(truth, seed=5)
    ref = jwl.make_bench_model(cloud, kind=kind, precision="bf16x2")
    ref.fit(cloud, labels, sample=SAMPLE, attributes=attrs)
    port = twl.make_bench_model(cloud, kind=kind, precision="bf16x2",
                                device="cpu")
    assert port.precision == "bf16x2"
    port.install_classifier(_carried(ref.classifier), cloud,
                            attributes=attrs)
    served = serve_both(ref, port, other, serve_attrs)
    assert float((served == truth).mean()) > 0.8
