"""The serving step: the median, over the traced run's window, of the
host clock to synchronize around ``predict_staged`` (the plan, the
voxel dedup, the moment kernel, the layout and the classifier)."""

import statistics


def read(records):
    values = [c["predict_ms"] for c in records["clouds"]]
    return statistics.median(values) if values else None
