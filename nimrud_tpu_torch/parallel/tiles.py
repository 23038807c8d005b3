"""
Host-side spatial sharding (copy of ``nimrud_tpu/parallel/tiles.py``,
host NumPy): split a cloud into per-device slabs or rectangular columns
with halo-capacity planning.

The reference's buffered-partition semantics (each search region
expanded by the largest analysis scale so tiles process independently)
become the multi-device contract here: each device owns a contiguous
slab (or column block) of the cloud, and the boundary points it must
receive from its neighbors are the points within ``buffer_radius`` of
its faces.  The halo capacities model the device's exact band choice
(``parallel.mesh._band_by_value``), so every shard table, mask,
permutation and capacity equals the reference's.
"""

import numpy as np


def shard_cloud(points, n_devices, buffer_radius, *, axis=0,
                extras=None):
    """
    Split ``points`` into ``n_devices`` equal-size slabs along ``axis``.

    Returns a dict with:
      slabs:     (n_devices, rows, 3) float32, rows padded to equal size
                 (padding repeats each slab's last point, marked invalid)
      valid:     (n_devices, rows) bool
      order:     (N,) permutation applied to the cloud (sorted by axis,
                 then slab-partitioned); invert to restore caller order
      halo:      rows needed from each neighbor = max points within
                 buffer_radius of any slab face, padded to a power of two
      extras:    optional list of per-point arrays sharded identically
    """
    points = np.asarray(points, dtype=np.float32)
    n = len(points)
    order = np.argsort(points[:, axis], kind="stable")
    sorted_pts = points[order]

    per = -(-n // n_devices)
    rows = per
    slabs = np.zeros((n_devices, rows, 3), dtype=np.float32)
    valid = np.zeros((n_devices, rows), dtype=bool)
    sharded_extras = None
    if extras is not None:
        extras = [np.asarray(e)[order] for e in extras]
        sharded_extras = [
            np.zeros((n_devices, rows) + e.shape[1:], dtype=e.dtype)
            for e in extras]

    halo_need = 1
    for d in range(n_devices):
        lo, hi = d * per, min((d + 1) * per, n)
        count = hi - lo
        if count > 0:
            slabs[d, :count] = sorted_pts[lo:hi]
            if count < rows:
                slabs[d, count:] = sorted_pts[hi - 1]
            valid[d, :count] = True
            if extras is not None:
                for out, src in zip(sharded_extras, extras):
                    out[d, :count] = src[lo:hi]
        # halo need: points of this slab within buffer of either face
        if count > 0 and n_devices > 1:
            coords = sorted_pts[lo:hi, axis]
            left_face, right_face = coords[0], coords[-1]
            halo_need = max(
                halo_need,
                int((coords <= left_face + buffer_radius).sum()),
                int((coords >= right_face - buffer_radius).sum()))

    halo = 1
    while halo < halo_need:
        halo *= 2
    halo = min(halo, rows)

    return {
        "slabs": slabs,
        "valid": valid,
        "order": order,
        "halo": halo,
        "extras": sharded_extras,
        "axis": axis,
        "buffer_radius": float(buffer_radius),
    }


def shard_cloud_2d(points, mesh_shape, buffer_radius, *, extras=None):
    """
    Split ``points`` into an (mx, my) grid of rectangular columns: sort
    by x into mx slabs, then each slab by y into my blocks.

    Halo plan for the two-phase exchange (x bands first, then y bands of
    the augmented set, so corners ride the second phase):
      halo_x: max points within ``buffer_radius`` of any block's x faces
      halo_y: max points within the buffer of any block's y faces,
              measured on the block PLUS its x-phase halo bands

    Returns a dict of blocks (mx*my, rows, 3) in device-major order
    (x-major: device (i, j) = row i * my + j), validity, the applied
    permutation, halo caps, and sharded extras.
    """
    points = np.asarray(points, dtype=np.float32)
    n = len(points)
    mx, my = int(mesh_shape[0]), int(mesh_shape[1])
    n_dev = mx * my

    order_x = np.argsort(points[:, 0], kind="stable")
    per_col = -(-n // mx)
    order = []
    col_of = []
    for i in range(mx):
        rows_i = order_x[i * per_col: min((i + 1) * per_col, n)]
        sub = rows_i[np.argsort(points[rows_i, 1], kind="stable")]
        order.append(sub)
        col_of.append(np.full(len(sub), i))
    order = np.concatenate(order) if order else np.zeros(0, np.int64)
    sorted_pts = points[order]

    # block boundaries: each column splits into my equal blocks
    rows = -(-per_col // my)
    blocks = np.zeros((n_dev, rows, 3), np.float32)
    valid = np.zeros((n_dev, rows), bool)
    sharded_extras = None
    if extras is not None:
        extras = [np.asarray(e)[order] for e in extras]
        sharded_extras = [
            np.zeros((n_dev, rows) + e.shape[1:], dtype=e.dtype)
            for e in extras]

    spans = []          # (lo, hi) row range per device in sorted_pts
    offset = 0
    for i in range(mx):
        col_n = min((i + 1) * per_col, n) - i * per_col
        for j in range(my):
            lo = offset + min(j * rows, col_n)
            hi = offset + min((j + 1) * rows, col_n)
            spans.append((lo, hi))
            count = hi - lo
            d = i * my + j
            if count > 0:
                blocks[d, :count] = sorted_pts[lo:hi]
                if count < rows:
                    blocks[d, count:] = sorted_pts[hi - 1]
                valid[d, :count] = True
                if extras is not None:
                    for out, src in zip(sharded_extras, extras):
                        out[d, :count] = src[lo:hi]
        offset += col_n

    def pow2(v):
        out = 1
        while out < v:
            out *= 2
        return out

    # halo capacity planning (host, models the device's exact top-k
    # band selection: the x bands sent are the halo_x most x-extreme
    # points, which can include beyond-buffer points -- the y-face need
    # must be measured on THAT augmented set, not the ideal bands)
    halo_x = 1
    for lo, hi in spans:
        pts = sorted_pts[lo:hi]
        if not len(pts):
            continue
        x0, x1 = pts[:, 0].min(), pts[:, 0].max()
        halo_x = max(
            halo_x,
            int((pts[:, 0] <= x0 + buffer_radius).sum()),
            int((pts[:, 0] >= x1 - buffer_radius).sum()))
    halo_x = min(pow2(halo_x), rows)

    band_pts = {}
    for d, (lo, hi) in enumerate(spans):
        pts = sorted_pts[lo:hi]
        if not len(pts):
            band_pts[d] = (pts, pts)
            continue
        by_x = pts[np.argsort(pts[:, 0], kind="stable")]
        band_pts[d] = (by_x[:halo_x], by_x[-halo_x:])
    halo_y = 1
    for d, (lo, hi) in enumerate(spans):
        pts = sorted_pts[lo:hi]
        i, j = divmod(d, my)
        aug = [pts]
        if i > 0:
            aug.append(band_pts[(i - 1) * my + j][1])   # left's high band
        if i < mx - 1:
            aug.append(band_pts[(i + 1) * my + j][0])   # right's low band
        aug = np.vstack([a for a in aug if len(a)]) \
            if any(len(a) for a in aug) else pts
        if not len(aug):
            continue
        y0, y1 = aug[:, 1].min(), aug[:, 1].max()
        halo_y = max(
            halo_y,
            int((aug[:, 1] <= y0 + buffer_radius).sum()),
            int((aug[:, 1] >= y1 - buffer_radius).sum()))

    return {
        "blocks": blocks,
        "valid": valid,
        "order": order,
        "halo_x": halo_x,
        "halo_y": min(pow2(halo_y), rows + 2 * halo_x),
        "extras": sharded_extras,
        "mesh_shape": (mx, my),
        "buffer_radius": float(buffer_radius),
    }


def unshard(per_device_values, valid, order, n_total):
    """
    Reassemble per-device outputs (n_devices, rows, ...) into caller
    order (n_total, ...).
    """
    flat = per_device_values.reshape(
        (-1,) + per_device_values.shape[2:])[valid.reshape(-1)]
    inverse = np.empty_like(order)
    inverse[order] = np.arange(n_total)
    return flat[inverse]
