"""Host staging: the median, over the traced run's window, of the host
clock to synchronize around ``GeometryClassifier.stage`` (bounds,
uint16 quantization, the upload; for the designated map the float32
upload)."""

import statistics


def read(records):
    values = [c["stage_ms"] for c in records["clouds"]]
    return statistics.median(values) if values else None
