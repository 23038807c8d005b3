"""
Fixed-shape sort-based unique for voxel keys (port of
``nimrud_tpu/ops/unique.py``): sort, flag segment heads, compact the
unique keys to the front of a same-length buffer, return a count.
Padding uses ``packing.PAD_KEY`` (INT32_MAX), which valid keys never
equal because the key budget is 30 bits.
"""

import torch

from nimrud_tpu_torch.ops.packing import PAD_KEY

_PAD = int(PAD_KEY)


def _sorted_unique_flags(keys, valid=None):
    """Sort keys (invalid rows forced to PAD_KEY) and flag the first
    occurrence of each live key.  Returns ``(sorted_keys, is_unique)``."""
    if valid is not None:
        keys = torch.where(valid, keys, _PAD)
    keys = torch.sort(keys).values
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=keys.device),
                      keys[1:] != keys[:-1]])
    return keys, head & (keys != _PAD)


def unique_keys(keys, valid=None):
    """
    Deduplicate int32 keys.

    Returns ``(unique, count)``: ``unique`` is (N,) int32 with the sorted
    unique keys in the first ``count`` slots and PAD_KEY elsewhere.
    """
    keys, is_unique = _sorted_unique_flags(keys, valid)
    out = torch.sort(torch.where(is_unique, keys, _PAD)).values
    return out, is_unique.sum()


def unique_voxels(points, spec, valid=None, tile_spec=None):
    """
    Voxel-downsample: encode, dedup, decode.

    Returns ``(centers, count, mask)``: (N, dim) voxel centers (sorted by
    key, or by ``tile_spec`` fine-tile id when given; padded rows hold
    the center of key 0), the live count, and the validity mask.

    With ``tile_spec`` (a ``device_grid.DeviceGridSpec``) the compaction
    sort orders survivors by that spec's fine-tile id, carrying the key
    as payload, so the output feeds
    ``device_grid._search_tables(..., presorted=True)``.  Within a tile
    the order stays voxel-key order: both sorts are stable over a
    key-sorted input.
    """
    keys = spec.encode(points)
    if tile_spec is None:
        uniq, count = unique_keys(keys, valid=valid)
        mask = uniq != _PAD
        centers = spec.decode(torch.where(mask, uniq, 0))
        return centers, count, mask

    from nimrud_tpu_torch.ops import device_grid
    keys, is_unique = _sorted_unique_flags(keys, valid)
    # fine-tile id of each survivor's center, computed exactly as the
    # band's span tables compute it; duplicates and pads sort last
    tid = device_grid._encode(
        spec.decode(torch.where(keys != _PAD, keys, 0)),
        tile_spec, coarse=False)
    order = torch.sort(torch.where(is_unique, tid, _PAD),
                       stable=True).indices
    uniq = torch.where(is_unique, keys, _PAD)[order]
    mask = uniq != _PAD
    centers = spec.decode(torch.where(mask, uniq, 0))
    return centers, is_unique.sum(), mask
