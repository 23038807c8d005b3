"""The serving step's live slots, in percent: the query rows the plan
placed (counter ``slots_live``) over the entry slots the step lays out,
runs the moment kernel on and classifies (``slots``, e_cap x q_cap over
the entry chunks), over the traced segment's scans; from the program's
counters (``nimrud_tpu_torch.utils.profiling.collected()``, the scans
``classify_ms.traced`` pairs with the segment).  None where the program
counts nothing."""

from perfbench.metrics.classify_ms import traced


def share(records, live, launched):
    """100 x counter ``live`` / counter ``launched``, or None."""
    got = traced(records)
    if got is None or not got["counters"].get(launched):
        return None
    counters = got["counters"]
    return 100.0 * counters.get(live, 0) / counters[launched]


def read(records):
    return share(records, "slots_live", "slots")
