"""
Multi-device execution (port of ``nimrud_tpu/parallel/mesh.py``):
slab- and tile-sharded feature extraction with halo exchange,
data-parallel classifier training, and the exchange and gather
primitives of multi-device serving
(``GeometryClassifier.predict_multichip``), on a single-process device
mesh.

The reference runs each shard's program under ``shard_map`` in one JAX
process over ``jax.devices()``; here one PyTorch process drives a grid
of ``torch.device``s (:class:`Mesh`).  Every shard program is enqueued
on its own device, in turn (no synchronization between shards: on
distinct devices they overlap, on a repeated device they run one after
another).  The collectives become tensor moves between those devices:

* :func:`ppermute` -- the reference's ``lax.ppermute`` over one mesh
  axis with the same ``(source, destination)`` pair lists; the
  wrap-around pairs move too, and the callers mask them out with the
  reference's end masks (``index > 0``, ``index < n - 1``), so a
  receiving shard always gets a band of the same shape;
* :func:`pmean` -- the mean over the mesh, on one device.

A mesh's devices may repeat (the JAX ``Mesh`` forbids it): four entries
of ``cuda:0`` run every shard program, the exchange and the kernels at
shard shapes on one card, as the reference's tests run eight forced
host devices on one CPU.

Per shard: the cloud is sorted along the slab axis (or split into
(mx, my) rectangular columns, :mod:`nimrud_tpu_torch.parallel.tiles`),
each shard exchanges its boundary bands with its lattice neighbors
(the lattice is a line, not a ring), then computes masked-moment
features of its own points against its block plus halos.  With
``buffer_radius`` at least the largest analysis radius these equal a
single-device run over the whole cloud: distances come from raw global
coordinates, so ball membership does not depend on the partition.
"""

import numpy as np
import torch

from nimrud_tpu_torch.features import layouts
from nimrud_tpu_torch.ops import device_grid, moments, packing, unique
from nimrud_tpu_torch.parallel import tiles

AXIS = "shards"
AXIS_X, AXIS_Y = "mesh_x", "mesh_y"


class Mesh:
    """A grid of ``torch.device``s with named axes: ``devices`` (an
    object array of the grid's shape), ``axis_names``, and ``flat`` (the
    devices in device-major order, the shard order of
    :mod:`~nimrud_tpu_torch.parallel.tiles`).  Devices may repeat."""

    def __init__(self, devices, axis_names, shape=None):
        self.flat = [_indexed(d) for d in devices]
        grid = np.empty(len(self.flat), dtype=object)
        grid[:] = self.flat
        self.devices = grid.reshape(shape or (len(self.flat),))
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-D device grid")

    @property
    def shape(self):
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return len(self.flat)

    @property
    def distinct(self):
        """The distinct devices, in first-appearance order."""
        return list(dict.fromkeys(self.flat))

    def index(self, axis):
        """Each shard's index along ``axis``, device-major."""
        ax = self.axis_names.index(axis)
        return [c[ax] for c in np.ndindex(self.devices.shape)]


def _indexed(device):
    """``device`` with its index: a bare ``"cuda"`` is the current CUDA
    device (tensors report an index, and shards key on it); a CUDA
    device where CUDA is unavailable raises."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise ValueError("a CUDA mesh needs a CUDA device")
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _visible(device_type="cuda"):
    """The devices a default mesh takes: every visible CUDA device (none
    where CUDA is unavailable; a CPU mesh is always given explicitly)."""
    if device_type != "cuda" or not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices=None, devices=None):
    """1-axis mesh (``AXIS``) over ``devices`` (default the visible CUDA
    devices), the first ``n_devices`` of them (default all)."""
    devices = _visible() if devices is None else list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices) or n_devices < 1:
        raise ValueError(
            f"requested {n_devices} devices, have {len(devices)}")
    return Mesh(devices[:n_devices], (AXIS,))


def make_mesh_2d(shape, devices=None):
    """(mx, my) device mesh (``AXIS_X``, ``AXIS_Y``) for 2-D spatial
    sharding over ``devices`` (default the visible CUDA devices)."""
    devices = _visible() if devices is None else list(devices)
    mx, my = int(shape[0]), int(shape[1])
    if mx * my > len(devices) or mx * my < 1:
        raise ValueError(
            f"mesh {mx}x{my} needs {mx * my} devices, "
            f"have {len(devices)}")
    return Mesh(devices[:mx * my], (AXIS_X, AXIS_Y), (mx, my))


def shards_on(mesh, values, dtype=None):
    """Per-shard tensors on their shards' devices: ``values`` is an
    (n_shards, ...) array or tensor (device-major), or a sequence of one
    tensor a shard."""
    out = []
    for d, dev in enumerate(mesh.flat):
        v = values[d]
        v = torch.as_tensor(np.ascontiguousarray(v)
                            if isinstance(v, np.ndarray) else v)
        out.append(v.to(device=dev, dtype=dtype or v.dtype))
    return out


def gather_host(values):
    """Per-shard tensors -> one (n_shards, ...) NumPy array."""
    return np.stack([v.detach().cpu().numpy() for v in values])


def ppermute(values, mesh, axis, perm):
    """``lax.ppermute`` of one tensor a shard (device-major) over mesh
    axis ``axis``: the shard at index ``dst`` along the axis receives the
    value of the shard at ``src`` for each ``(src, dst)`` in ``perm``
    (other coordinates equal), moved to its device; a shard no pair
    reaches receives zeros."""
    ax = mesh.axis_names.index(axis)
    shape = mesh.devices.shape
    src_of = {int(dst): int(src) for src, dst in perm}
    out = []
    for flat, coord in enumerate(np.ndindex(shape)):
        dev = mesh.flat[flat]
        src = src_of.get(coord[ax])
        if src is None:
            out.append(torch.zeros_like(values[flat], device=dev))
            continue
        at = list(coord)
        at[ax] = src
        out.append(values[int(np.ravel_multi_index(at, shape))].to(dev))
    return out


def pmean(values, device):
    """The mean of one tensor a shard, on ``device`` (differentiable)."""
    return torch.stack([v.to(device) for v in values]).mean(0)


def _halo_exchange(slabs, valids, halo, mesh):
    """Exchange boundary bands with lattice neighbors along ``AXIS``.
    Returns each shard's local search set: [own slab, band from the
    left neighbor, band from the right neighbor] with a validity mask
    (the wrap-around bands at the two ends are masked out)."""
    n = mesh.shape[AXIS]
    index = mesh.index(AXIS)
    # slabs are sorted along the slab axis, so boundary bands are slices
    low = [s[:halo] for s in slabs]
    low_v = [v[:halo] for v in valids]
    high = [s[-halo:] for s in slabs]
    high_v = [v[-halo:] for v in valids]
    shift_right = [(i, (i + 1) % n) for i in range(n)]
    shift_left = [(i, (i - 1) % n) for i in range(n)]
    # from the left neighbor: its high band moves right
    from_left = ppermute(high, mesh, AXIS, shift_right)
    from_left_v = ppermute(high_v, mesh, AXIS, shift_right)
    # from the right neighbor: its low band moves left
    from_right = ppermute(low, mesh, AXIS, shift_left)
    from_right_v = ppermute(low_v, mesh, AXIS, shift_left)
    out = []
    for d, i in enumerate(index):
        out.append((
            torch.cat([slabs[d], from_left[d], from_right[d]]),
            torch.cat([valids[d], from_left_v[d] & (i > 0),
                       from_right_v[d] & (i < n - 1)])))
    return out


def _chunked_moments(query, search, search_valid, radii, chunk_size,
                     exclude_radius, with_sazo=False):
    """``moments.chunk_moments`` over ``chunk_size`` queries at a time,
    the last chunk padded with zero rows (as the reference's
    ``lax.map`` pads it: a chunk's frame is its own midpoint)."""
    n = query.shape[0]
    pad = (-n) % chunk_size
    padded = torch.cat([query, query.new_zeros((pad, 3))]) if pad else query
    parts = [moments.chunk_moments(
        chunk, search, search_valid, radii, exclude_radius=exclude_radius,
        with_sazo=with_sazo)
        for chunk in padded.split(chunk_size)]
    return {key: torch.cat([p[key] for p in parts])[:n] for key in parts[0]}


def _layout(kind, got, query, radii):
    """Per-radius feature blocks of one shard, concatenated."""
    return torch.cat([layouts.build_block(
        kind, got["count"][:, ri], got["mean"][:, ri], got["cov"][:, ri],
        query, float(radius),
        sazo=got["sazo"][:, ri] if "sazo" in got else None)
        for ri, radius in enumerate(radii)], dim=-1)


def _shard_features(slab, search, search_valid, radii, kind, chunk_size,
                    exclude_radius):
    """Per-shard body after the exchange: masked-moment features of the
    slab's points against slab + halos."""
    got = _chunked_moments(slab, search, search_valid, radii, chunk_size,
                           exclude_radius, layouts.needs_sazo(kind))
    return _layout(kind, got, slab, radii)


def _features_1d(mesh, slabs, valids, halo, radii, kind, chunk_size,
                 exclude_radius):
    searches = _halo_exchange(slabs, valids, halo, mesh)
    return [_shard_features(s, search, sv, radii, kind, chunk_size,
                            exclude_radius)
            for s, (search, sv) in zip(slabs, searches)]


def sharded_extract(mesh, slabs, valid, halo, radii, kind="minimal", *,
                    chunk_size=256, exclude_radius=None):
    """
    Multi-device feature extraction.  ``slabs``/``valid`` come from
    :func:`nimrud_tpu_torch.parallel.tiles.shard_cloud` (arrays, or one
    tensor a shard).  Returns one (rows, width) feature tensor a shard,
    on its device.
    """
    radii = tuple(float(r) for r in radii)
    with torch.no_grad():
        return _features_1d(
            mesh, shards_on(mesh, slabs, torch.float32),
            shards_on(mesh, valid, torch.bool), halo, radii, kind,
            chunk_size, exclude_radius)


def _softmax_loss(params, feats, valid, labels, weight_decay):
    """One shard's loss: the valid-weighted mean negative log likelihood
    (``sum(nll * w) / max(sum w, 1)``), plus the weight decay."""
    logits = feats @ params["w"] + params["b"]
    nll = -torch.log_softmax(logits, dim=1).gather(
        1, labels[:, None].to(torch.int64))[:, 0]
    weight = valid.to(torch.float32)
    loss = (nll * weight).sum() / torch.clamp(weight.sum(), min=1.0)
    if weight_decay:
        loss = loss + weight_decay * (params["w"] ** 2).sum()
    return loss


def _train_step(mesh, features, optimizer, weight_decay):
    """One data-parallel step over per-shard features: each shard's loss
    on its own copy of the replicated parameters, the losses' mean over
    the mesh (the reference's ``pmean`` of the per-shard means, so the
    gradients are the mean of the per-shard gradients), then the
    optimizer's step.  Returns ``step(params, shards, valid, labels) ->
    loss``."""

    def step(params, shards, valid, labels):
        home = next(iter(params.values())).device
        with torch.no_grad():
            feats = features(shards_on(mesh, shards, torch.float32),
                             shards_on(mesh, valid, torch.bool))
        labs = shards_on(mesh, labels, torch.int64)
        valids = shards_on(mesh, valid, torch.bool)
        losses = []
        for f, v, lab in zip(feats, valids, labs):
            local = {k: p.to(f.device) for k, p in params.items()}
            losses.append(_softmax_loss(local, f, v, lab, weight_decay))
        loss = pmean(losses, home)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_train_step(mesh, halo, radii, kind, n_classes, optimizer, *,
                    chunk_size=256, exclude_radius=None, weight_decay=0.0):
    """
    A multi-device training step of the softmax classifier:

      step(params, slabs, valid, labels) -> loss

    ``params`` is the dict of leaf tensors (``"w"`` (width, n_classes),
    ``"b"`` (n_classes,)) that ``optimizer`` (a ``torch.optim``
    optimizer) holds, replicated to each shard's device every step.
    Each shard extracts features of its slab (with the halo exchange)
    and takes the loss on its points; the loss is the mean over the
    mesh of the per-shard losses.  ``n_classes`` is the reference's
    argument; the parameters' shapes carry it.
    """
    radii = tuple(float(r) for r in radii)
    return _train_step(
        mesh, lambda s, v: _features_1d(mesh, s, v, halo, radii, kind,
                                        chunk_size, exclude_radius),
        optimizer, weight_decay)


def _fused_specs(scaleset, bounds_lo, bounds_hi, rows, **spec_kw):
    """Per-band (voxel grid, tile spec, radii) on the global bounds, so
    every shard bins into the same grids (``spec_kw``: the tile grid's
    options, e.g. ``q_cap`` and ``x_seg``)."""
    specs = []
    for edge, radii in scaleset:
        if edge <= 0:
            raise ValueError("fused multi-chip extraction needs "
                             "voxelized bands (edge > 0)")
        radii = tuple(float(r) for r in radii)
        specs.append((packing.GridSpec.fit_bounds(bounds_lo, bounds_hi, edge),
                      device_grid.make_spec(bounds_lo, bounds_hi, max(radii),
                                            n_query=rows, voxel_edge=edge,
                                            **spec_kw),
                      radii))
    return tuple(specs)


def _fused_bands(block, v, search, s_valid, specs, kind, precision, rows):
    """Per band: voxelize the shard's search set on the global grid and
    run the XLA candidate-table extraction of the block's queries."""
    bands = []
    for vox_spec, dev_spec, radii in specs:
        centers, _, mask = unique.unique_voxels(search, vox_spec,
                                                valid=s_valid)
        bands.append(device_grid.fused_extract(
            block, v, centers, mask, dev_spec, radii, kind, None, precision,
            rows))
    return torch.cat(bands, dim=1)


def make_fused_extract(mesh, halo, scaleset, kind, bounds_lo, bounds_hi,
                       rows, *, precision="highest"):
    """
    Multi-device FUSED extraction: each shard voxelizes its slab +
    exchanged halos on a globally anchored grid, builds its tile tables
    on its device, and runs the XLA candidate-table extraction
    (``device_grid.fused_extract``).

    Args:
      halo / scaleset / kind: as elsewhere.
      bounds_lo/hi: GLOBAL cloud bounds (so every shard bins into the
        same grid and per-shard voxelization equals the global one).
      rows: slab row count.

    Returns f(slabs, valid) -> one (rows, width) tensor a shard.
    """
    specs = _fused_specs(scaleset, bounds_lo, bounds_hi, rows)

    def run(slabs, valid):
        with torch.no_grad():
            slabs = shards_on(mesh, slabs, torch.float32)
            valids = shards_on(mesh, valid, torch.bool)
            searches = _halo_exchange(slabs, valids, halo, mesh)
            return [_fused_bands(s, v, search, sv, specs, kind, precision,
                                 rows)
                    for s, v, (search, sv) in zip(slabs, valids, searches)]

    return run


def _band_by_value(points, valid, axis, k, largest):
    """Fixed-capacity boundary band selected by coordinate VALUE (works
    for any intra-block ordering): the k most extreme valid points, in
    ``lax.top_k``'s order -- descending score in float32 total order
    (-0.0 below +0.0), ties by ascending row -- through ``torch.topk``
    on a unique int64 key (``torch.topk`` promises no order among
    ties)."""
    coords = points[:, axis]
    big = torch.tensor(3e38, dtype=torch.float32, device=points.device)
    score = torch.where(valid, coords, -big) if largest \
        else torch.where(valid, -coords, -big)
    bits = score.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    rows = torch.arange(score.shape[0], dtype=torch.int64,
                        device=points.device)
    key = ordered * (1 << 32) + ((1 << 32) - 1 - rows)
    top = torch.topk(key, k, sorted=True).values
    idx = (1 << 32) - 1 - (top & ((1 << 32) - 1))
    return points[idx], valid[idx]


def _halo_bands_2d(blocks, valids, halo_x, halo_y, mesh):
    """
    Two-phase halo exchange on the (``AXIS_X``, ``AXIS_Y``) mesh: x-face
    bands first, then y-face bands of the augmented set (own + x halos),
    so corner regions ride the second phase.  Returns each shard's
    received halo points and validity only, concatenated as
    ``[from_left, from_right, from_below, from_above]`` (the caller
    owns its block and puts it first: the stable sorts downstream
    depend on that order).
    """
    nx, ny = mesh.devices.shape
    ix, iy = mesh.index(AXIS_X), mesh.index(AXIS_Y)

    right = [(i, (i + 1) % nx) for i in range(nx)]
    left = [(i, (i - 1) % nx) for i in range(nx)]
    low_x = [_band_by_value(b, v, 0, halo_x, largest=False)
             for b, v in zip(blocks, valids)]
    high_x = [_band_by_value(b, v, 0, halo_x, largest=True)
              for b, v in zip(blocks, valids)]
    from_left = ppermute([h[0] for h in high_x], mesh, AXIS_X, right)
    from_left_v = [r & (i > 0) for r, i in zip(
        ppermute([h[1] for h in high_x], mesh, AXIS_X, right), ix)]
    from_right = ppermute([lo[0] for lo in low_x], mesh, AXIS_X, left)
    from_right_v = [r & (i < nx - 1) for r, i in zip(
        ppermute([lo[1] for lo in low_x], mesh, AXIS_X, left), ix)]

    aug = [torch.cat([b, fl, fr])
           for b, fl, fr in zip(blocks, from_left, from_right)]
    aug_v = [torch.cat([v, fl, fr])
             for v, fl, fr in zip(valids, from_left_v, from_right_v)]

    up = [(j, (j + 1) % ny) for j in range(ny)]
    down = [(j, (j - 1) % ny) for j in range(ny)]
    low_y = [_band_by_value(a, v, 1, halo_y, largest=False)
             for a, v in zip(aug, aug_v)]
    high_y = [_band_by_value(a, v, 1, halo_y, largest=True)
              for a, v in zip(aug, aug_v)]
    from_below = ppermute([h[0] for h in high_y], mesh, AXIS_Y, up)
    from_below_v = [r & (j > 0) for r, j in zip(
        ppermute([h[1] for h in high_y], mesh, AXIS_Y, up), iy)]
    from_above = ppermute([lo[0] for lo in low_y], mesh, AXIS_Y, down)
    from_above_v = [r & (j < ny - 1) for r, j in zip(
        ppermute([lo[1] for lo in low_y], mesh, AXIS_Y, down), iy)]

    return [(torch.cat([fl, fr, fb, fa]), torch.cat([vl, vr, vb, va]))
            for fl, fr, fb, fa, vl, vr, vb, va in zip(
                from_left, from_right, from_below, from_above,
                from_left_v, from_right_v, from_below_v, from_above_v)]


def _outer6(delta):
    dx, dy, dz = delta[..., 0], delta[..., 1], delta[..., 2]
    return torch.stack(
        [dx * dx, dx * dy, dx * dz, dy * dy, dy * dz, dz * dz], dim=-1)


def _combine_moment_groups(groups):
    """
    Merge per-group neighborhood statistics over DISJOINT search groups
    (parallel-axis theorem on the packed covariance): moments are
    additive, so a shard's own-block and halo contributions combine
    exactly afterwards.  The sazo statistic takes the larger magnitude
    (the earlier group on a tie).
    """
    count = sum(g["count"] for g in groups)
    denom = torch.clamp(count, min=1.0)
    mean = sum(g["count"][..., None] * g["mean"] for g in groups) \
        / denom[..., None]
    cov = sum(g["count"][..., None] * (g["cov"] + _outer6(g["mean"] - mean))
              for g in groups) / denom[..., None]
    out = {"count": count, "mean": mean, "cov": cov}
    if "sazo" in groups[0]:
        sazo = groups[0]["sazo"]
        for g in groups[1:]:
            sazo = torch.where(g["sazo"].abs() > sazo.abs(), g["sazo"], sazo)
        out["sazo"] = sazo
    return out


def _features_2d(mesh, blocks, valids, halo_x, halo_y, radii, kind,
                 chunk_size, exclude_radius):
    """Per shard: the two-phase exchange, then moments against the own
    block and against the halo bands, combined."""
    with_sazo = layouts.needs_sazo(kind)
    halos = _halo_bands_2d(blocks, valids, halo_x, halo_y, mesh)
    out = []
    for block, v, (halo_pts, halo_v) in zip(blocks, valids, halos):
        own = _chunked_moments(block, block, v, radii, chunk_size,
                               exclude_radius, with_sazo)
        halo = _chunked_moments(block, halo_pts, halo_v, radii, chunk_size,
                                exclude_radius, with_sazo)
        out.append(_layout(kind, _combine_moment_groups([own, halo]), block,
                           radii))
    return out


def sharded_extract_2d(mesh, blocks, valid, halo_x, halo_y, radii,
                       kind="minimal", *, chunk_size=256,
                       exclude_radius=None):
    """
    2-D mesh feature extraction: each shard runs the x/y halo exchange,
    computes moments against its OWN block and against the halo group,
    and combines them (additive decomposition).  ``blocks``/``valid``
    from :func:`nimrud_tpu_torch.parallel.tiles.shard_cloud_2d`,
    device-major.  Returns one (rows, width) tensor a shard.
    """
    radii = tuple(float(r) for r in radii)
    with torch.no_grad():
        return _features_2d(
            mesh, shards_on(mesh, blocks, torch.float32),
            shards_on(mesh, valid, torch.bool), halo_x, halo_y, radii, kind,
            chunk_size, exclude_radius)


def make_train_step_2d(mesh, halo_x, halo_y, radii, kind, n_classes,
                       optimizer, *, chunk_size=256, exclude_radius=None,
                       weight_decay=0.0):
    """
    Training step on the 2-D tile mesh: per-shard feature extraction
    (two-phase halo exchange), softmax loss on the shard's points, the
    loss's mean over BOTH mesh axes.  Signature mirrors
    :func:`make_train_step`.
    """
    radii = tuple(float(r) for r in radii)
    return _train_step(
        mesh, lambda b, v: _features_2d(mesh, b, v, halo_x, halo_y, radii,
                                        kind, chunk_size, exclude_radius),
        optimizer, weight_decay)


def make_fused_extract_2d(mesh, halo_x, halo_y, scaleset, kind,
                          bounds_lo, bounds_hi, rows, *,
                          precision="highest"):
    """
    The fused extraction on the 2-D tile mesh: each shard runs the
    two-phase halo exchange, voxelizes its block + halos on the globally
    anchored grid, builds its tile tables on its device, and runs the
    XLA candidate-table extraction.  Args mirror
    :func:`make_fused_extract`; ``rows`` is the per-shard block row
    count.  Returns f(blocks, valid) -> one (rows, width) tensor a
    shard.
    """
    specs = _fused_specs(scaleset, bounds_lo, bounds_hi, rows)

    def run(blocks, valid):
        with torch.no_grad():
            blocks = shards_on(mesh, blocks, torch.float32)
            valids = shards_on(mesh, valid, torch.bool)
            halos = _halo_bands_2d(blocks, valids, halo_x, halo_y, mesh)
            return [_fused_bands(b, v, torch.cat([b, hp]), torch.cat([v, hv]),
                                 specs, kind, precision, rows)
                    for b, v, (hp, hv) in zip(blocks, valids, halos)]

    return run


def _params_on(clf_params, device):
    """A serving classifier's parameters (a dict of values, tensors and
    dicts of tensors) with every tensor on ``device``."""
    out = {}
    for key, value in clf_params.items():
        if isinstance(value, torch.Tensor):
            value = value.to(device)
        elif isinstance(value, dict):
            value = {k: v.to(device) for k, v in value.items()}
        out[key] = value
    return out


def extract_multichip_2d(points, radii, kind="minimal", *, mesh_shape,
                         mesh=None, buffer_radius=None, chunk_size=256,
                         exclude_radius=None):
    """End-to-end 2-D mesh extraction: shard, extract, reassemble in
    caller order (a NumPy array).  ``mesh`` defaults to
    ``make_mesh_2d(mesh_shape)`` over the visible CUDA devices."""
    if buffer_radius is None:
        buffer_radius = max(radii)
    if buffer_radius < max(radii):
        raise ValueError("buffer_radius must be >= the largest radius")
    if mesh is None:
        mesh = make_mesh_2d(mesh_shape)
    shards = tiles.shard_cloud_2d(points, mesh_shape, buffer_radius)
    feats = sharded_extract_2d(
        mesh, shards["blocks"], shards["valid"], shards["halo_x"],
        shards["halo_y"], radii, kind, chunk_size=chunk_size,
        exclude_radius=exclude_radius)
    return tiles.unshard(gather_host(feats), shards["valid"],
                         shards["order"], len(points))


def extract_multichip(points, radii, kind="minimal", *, mesh=None,
                      buffer_radius=None, chunk_size=256,
                      exclude_radius=None):
    """
    Convenience end-to-end: shard a cloud across every device of
    ``mesh`` (default every visible CUDA device), extract features with
    the halo exchange, reassemble in caller order (a NumPy array).
    """
    if mesh is None:
        mesh = make_mesh()
    if buffer_radius is None:
        buffer_radius = max(radii)
    if buffer_radius < max(radii):
        raise ValueError("buffer_radius must be >= the largest radius")
    shards = tiles.shard_cloud(points, mesh.size, buffer_radius)
    feats = sharded_extract(
        mesh, shards["slabs"], shards["valid"], shards["halo"],
        radii, kind, chunk_size=chunk_size, exclude_radius=exclude_radius)
    return tiles.unshard(gather_host(feats), shards["valid"],
                         shards["order"], len(points))
