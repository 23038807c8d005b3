"""The moment kernel's live lanes, in percent: the candidate lanes that
hold a search point (counter ``lanes_live``) over the lanes launched
(``lanes``: entries x c_cap over bands, capacity buckets and entry
chunks), over the traced segment; from the program's counters
(``nimrud_tpu_torch.utils.profiling.collected()``, the scans
``classify_ms.traced`` pairs with the segment).  None where the
program counts nothing."""

from perfbench.metrics.slot_live_share import share


def read(records):
    return share(records, "lanes_live", "lanes")
