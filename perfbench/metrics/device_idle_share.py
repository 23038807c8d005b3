"""The device's idle share, in percent: 1 - busy / window over the
traced segment (several whole served clouds, staging and the copies to
the host included), busy being the union of the device events'
intervals in the profiler's trace."""

from perfbench.core import trace as tracing


def read(records):
    trace = records.get("trace")
    if trace is None or not trace["device"]:
        return None
    lo, hi = trace["window_us"]
    return 100.0 * (1.0 - tracing.busy_us(trace["device"]) / (hi - lo))
