"""
Small host-side helpers shared across the framework (copy of
``nimrud_tpu/utils/generic.py``).

Capability parity: ``batcher`` matches the chunking generator of the
reference toolkit (reference: nimrud/utils/generic.py:8-26).
"""

import numpy as np


def batcher(collection, chunk_size):
    """
    Yield successive chunks of ``collection`` of length ``chunk_size`` (the
    final chunk may be shorter).  Arrays and lists are sliced; any other
    iterable is consumed lazily into list chunks.
    """
    if chunk_size <= 0:
        raise ValueError("chunk_size must be positive")

    if isinstance(collection, (np.ndarray, list)):
        for start in range(0, len(collection), chunk_size):
            yield collection[start:start + chunk_size]
        return

    chunk = []
    for item in collection:
        chunk.append(item)
        if len(chunk) == chunk_size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def round_up(value, multiple):
    """Round ``value`` up to the nearest multiple of ``multiple``."""
    return ((int(value) + multiple - 1) // multiple) * multiple


def pad_rows(array, target_rows, fill=0.0):
    """
    Pad a 2-D array with ``fill`` rows up to ``target_rows``.  Returns the
    padded array and a boolean validity mask of shape (target_rows,).
    """
    array = np.asarray(array)
    n = array.shape[0]
    if n > target_rows:
        raise ValueError(f"array has {n} rows > target {target_rows}")
    mask = np.zeros(target_rows, dtype=bool)
    mask[:n] = True
    if n == target_rows:
        return array, mask
    pad_shape = (target_rows - n,) + array.shape[1:]
    padded = np.concatenate(
        [array, np.full(pad_shape, fill, dtype=array.dtype)], axis=0)
    return padded, mask
