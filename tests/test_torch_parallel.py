"""
The multi-device layer of the port (``nimrud_tpu_torch.parallel``)
against the JAX package's (``nimrud_tpu.parallel``) on the same NumPy
inputs: the reference under ``shard_map`` on the CPU's eight forced host
devices, the port on a single-process mesh of eight entries of
``torch.device("cpu")``.

* ``tiles``: shard tables, valid masks, permutations, halo caps and
  extras EQUAL to the reference's; ``unshard`` restores caller order.
* ``_band_by_value``: the rows and their order equal ``lax.top_k``'s,
  with exact coordinate ties at the k-th place, -0.0 against +0.0 and
  invalid rows; the two-phase halo bands of every shard equal the
  reference's ``_halo_bands_2d`` (points, validity, order).
* ``sharded_extract`` / ``sharded_extract_2d`` (``minimal``, and
  ``sazo`` max-combined across halos): the tolerances of
  ``tests/test_parallel.py`` against the reference's; on the bench
  scene the populations equal the reference's, including the few
  points its halo_y plan leaves short of neighbors.
* One step of ``make_train_step`` / ``make_train_step_2d`` from the
  same parameters (optax ``sgd`` against ``torch.optim.SGD``): the loss
  and the parameters after the step within 1e-5, the step (the rate
  times the mesh-mean gradient) within 1e-4.
* ``make_fused_extract`` / ``make_fused_extract_2d`` against the
  port's single-device fused XLA extraction: populations equal.
* ``RPTEnsemble.fit_device_mesh``: tables bit-equal to the port's
  ``fit_device`` on the device-major flattening of the valid rows;
  held-out accuracy within 0.03 of the reference's ``fit_device_mesh``.
* The mesh: ``ppermute``'s pair semantics, repeated devices, and no
  default mesh without CUDA devices.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from nimrud_tpu.learning import linear as jlinear
from nimrud_tpu.learning.rpt import RPTEnsemble as JRPT
from nimrud_tpu.parallel import mesh as jmesh
from nimrud_tpu.parallel import tiles as jtiles

from nimrud_tpu_torch.features import multiscale as tms
from nimrud_tpu_torch.learning.rpt import RPTEnsemble
from nimrud_tpu_torch.parallel import mesh as pmesh
from nimrud_tpu_torch.parallel import tiles as ttiles
from torch_rpt_cases import forest_data
from torch_thread_cases import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
POP_COLS = [0, 4]


def _cpu_mesh_1d(n=8):
    return pmesh.make_mesh(n, devices=[CPU] * n)


def _cpu_mesh_2d(shape):
    return pmesh.make_mesh_2d(shape, devices=[CPU] * (shape[0] * shape[1]))


def _cloud(n, extent, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)) * extent).astype(np.float32)


def _blobs(seed):
    """The reference training tests' classes: a planar sheet, a vertical
    line and an isotropic blob (labels 0 / 1 / 2)."""
    rng = np.random.default_rng(seed)
    per = 300
    sheet = rng.random((per, 3)) * [6, 6, 0.02]
    line = rng.random((per, 3)) * [0.02, 0.02, 6] + [8, 3, 0]
    blob = rng.normal([14, 3, 3], 0.8, (per, 3))
    points = np.vstack([sheet, line, blob]).astype(np.float32)
    return points, np.repeat([0, 1, 2], per).astype(np.int32)


# -- tiles --------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["slabs", "tiles_4x2", "tiles_1x3"])
def test_shard_tables_equal_reference(layout):
    points = _cloud(3001, [16, 8, 4], 1)
    extra = np.random.default_rng(2).integers(0, 5, len(points))
    if layout == "slabs":
        ref = jtiles.shard_cloud(points, 8, 0.5, extras=[extra])
        got = ttiles.shard_cloud(points, 8, 0.5, extras=[extra])
        table = "slabs"
    else:
        shape = (4, 2) if layout == "tiles_4x2" else (1, 3)
        ref = jtiles.shard_cloud_2d(points, shape, 0.5, extras=[extra])
        got = ttiles.shard_cloud_2d(points, shape, 0.5, extras=[extra])
        table = "blocks"
    assert got.keys() == ref.keys()
    for key in got:
        if key == "extras":
            np.testing.assert_array_equal(got[key][0], ref[key][0])
        else:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(ref[key]), err_msg=key)
    restored = ttiles.unshard(got[table], got["valid"], got["order"],
                              len(points))
    np.testing.assert_array_equal(restored, points)
    np.testing.assert_array_equal(
        ttiles.unshard(got["extras"][0], got["valid"], got["order"],
                       len(points)), extra)


# -- the band choice and the exchange -----------------------------------------

def _tie_block():
    """Rows whose x repeats: 0.5 eight times around the k-th largest,
    -0.0 and +0.0 around the k-th smallest (of -x), and invalid rows
    holding the extremes."""
    rng = np.random.default_rng(5)
    x = rng.choice(np.float32([-2.0, -0.0, 0.0, 0.5, 1.0, 1.5]), 64)
    x[[3, 17, 40, 41, 50, 60, 62, 63]] = 0.5
    pts = np.stack([x, rng.random(64), rng.random(64)],
                   axis=1).astype(np.float32)
    valid = rng.random(64) > 0.15
    valid[[0, 1]] = False
    pts[0, 0], pts[1, 0] = 9.0, -9.0
    return pts, valid


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("k", [5, 17, 33])
def test_band_by_value_tie_order(largest, k):
    pts, valid = _tie_block()
    j_pts, j_valid = jmesh._band_by_value(jnp.asarray(pts),
                                          jnp.asarray(valid), 0, k, largest)
    t_pts, t_valid = pmesh._band_by_value(torch.from_numpy(pts),
                                          torch.from_numpy(valid), 0, k,
                                          largest)
    # bit patterns: -0.0 and +0.0 rows are told apart
    np.testing.assert_array_equal(t_pts.numpy().view(np.int32),
                                  np.asarray(j_pts).view(np.int32))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))


def _reference_halos(blocks, valid, halo_x, halo_y, shape):
    mesh = jmesh.make_mesh_2d(shape)
    axes = (jmesh.AXIS_X, jmesh.AXIS_Y)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(P(axes), P(axes)),
                       out_specs=(P(axes), P(axes)))
    def run(b, v):
        pts, ok = jmesh._halo_bands_2d(b[0], v[0], halo_x, halo_y)
        return pts[None], ok[None]

    pts, ok = run(jnp.asarray(blocks), jnp.asarray(valid))
    return np.asarray(pts), np.asarray(ok)


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)])
def test_halo_bands_equal_reference(shape):
    # a 1/4 m lattice: many exact coordinate ties at every band edge
    points = (np.floor(_cloud(2400, [12, 6, 3], 7) * 4) / 4).astype(
        np.float32)
    shards = ttiles.shard_cloud_2d(points, shape, 0.6)
    hx, hy = shards["halo_x"], shards["halo_y"]
    j_pts, j_ok = _reference_halos(shards["blocks"], shards["valid"], hx, hy,
                                   shape)
    mesh = _cpu_mesh_2d(shape)
    got = pmesh._halo_bands_2d(
        pmesh.shards_on(mesh, shards["blocks"], torch.float32),
        pmesh.shards_on(mesh, shards["valid"], torch.bool), hx, hy, mesh)
    for d, (pts, ok) in enumerate(got):
        np.testing.assert_array_equal(ok.numpy(), j_ok[d])
        np.testing.assert_array_equal(pts.numpy(), j_pts[d])


def test_ppermute_pairs_and_repeated_devices():
    mesh = _cpu_mesh_2d((2, 3))
    assert mesh.shape == {pmesh.AXIS_X: 2, pmesh.AXIS_Y: 3}
    assert mesh.distinct == [CPU] and mesh.size == 6
    values = [torch.full((2,), float(d)) for d in range(6)]
    # along y (size 3), shift up without wrap-around: index 0 gets zeros
    got = pmesh.ppermute(values, mesh, pmesh.AXIS_Y, [(0, 1), (1, 2)])
    assert [float(v[0]) for v in got] == [0.0, 0.0, 1.0, 0.0, 3.0, 4.0]
    # along x with wrap-around
    got = pmesh.ppermute(values, mesh, pmesh.AXIS_X, [(0, 1), (1, 0)])
    assert [float(v[0]) for v in got] == [3.0, 4.0, 5.0, 0.0, 1.0, 2.0]
    np.testing.assert_allclose(float(pmesh.pmean(values, CPU)[0]), 2.5)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 4 devices, have 0"):
            pmesh.make_mesh_2d((2, 2))
        with pytest.raises(ValueError, match="requested"):
            pmesh.make_mesh()


# -- extraction ---------------------------------------------------------------

def _hold_features(got, ref):
    """``tests/test_parallel.py``'s contract between two extractions."""
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[:, POP_COLS], ref[:, POP_COLS])
    sturdy = np.all(got[:, POP_COLS] >= 3, axis=1)
    np.testing.assert_allclose(got[sturdy], ref[sturdy], atol=2e-3)
    np.testing.assert_allclose(got, ref, atol=5e-2)


def test_sharded_extract_matches_reference():
    points = _cloud(1500, [16, 4, 4], 3)
    radii = (0.5, 0.25)
    ref = jmesh.extract_multichip(points, radii, kind="minimal")
    got = pmesh.extract_multichip(points, radii, kind="minimal",
                                  mesh=_cpu_mesh_1d())
    _hold_features(got, ref)


def test_sharded_extract_2d_matches_reference():
    points = _cloud(2500, [12, 6, 3], 4)
    radii = (0.5, 0.25)
    ref = jmesh.extract_multichip_2d(points, radii, kind="minimal",
                                     mesh_shape=(4, 2))
    got = pmesh.extract_multichip_2d(points, radii, kind="minimal",
                                     mesh_shape=(4, 2),
                                     mesh=_cpu_mesh_2d((4, 2)))
    _hold_features(got, ref)


def test_sharded_extract_2d_sazo_combines_across_halos():
    points = _cloud(2000, [10, 5, 4], 6)
    radii = (0.6,)
    ref = jmesh.extract_multichip_2d(points, radii, kind="sazo",
                                     mesh_shape=(2, 4))
    got = pmesh.extract_multichip_2d(points, radii, kind="sazo",
                                     mesh_shape=(2, 4),
                                     mesh=_cpu_mesh_2d((2, 4)))
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-6)
    np.testing.assert_array_equal(got[:, 4], ref[:, 4])
    np.testing.assert_allclose(got, ref, atol=5e-2)


def test_narrow_buffer_rejected():
    points = _cloud(200, [4, 4, 4], 8)
    with pytest.raises(ValueError, match="buffer_radius"):
        pmesh.extract_multichip(points, (0.5,), buffer_radius=0.1,
                                mesh=_cpu_mesh_1d())
    with pytest.raises(ValueError, match="buffer_radius"):
        pmesh.extract_multichip_2d(points, (0.5,), mesh_shape=(2, 2),
                                   buffer_radius=0.1,
                                   mesh=_cpu_mesh_2d((2, 2)))


@pytest.mark.parametrize("layout", ["slabs", "tiles"])
def test_fused_extract_matches_single_device(layout):
    # the XLA candidate-table path plans every coarse tile of the global
    # grid on each shard: a compact site and edge = radius keep it small
    points = _cloud(600, [6, 3, 3], 9)
    scaleset = [(0.5, (0.5,))]
    single = tms.extract_scaleset_fused(points, points, scaleset,
                                        kind="minimal", backend="xla",
                                        device="cpu").numpy()
    lo, hi = points.min(0).astype(np.float64), points.max(0).astype(
        np.float64)
    if layout == "slabs":
        shards = ttiles.shard_cloud(points, 3, buffer_radius=1.0)
        table = "slabs"
        run = pmesh.make_fused_extract(
            _cpu_mesh_1d(3), shards["halo"], scaleset, "minimal", lo, hi,
            shards[table].shape[1])
    else:
        shards = ttiles.shard_cloud_2d(points, (2, 2), buffer_radius=1.0)
        table = "blocks"
        run = pmesh.make_fused_extract_2d(
            _cpu_mesh_2d((2, 2)), shards["halo_x"], shards["halo_y"],
            scaleset, "minimal", lo, hi, shards[table].shape[1])
    multi = ttiles.unshard(
        pmesh.gather_host(run(shards[table], shards["valid"])),
        shards["valid"], shards["order"], len(points))
    assert multi.shape == single.shape
    np.testing.assert_array_equal(multi[:, 0], single[:, 0])
    sturdy = multi[:, 0] >= 3
    np.testing.assert_allclose(multi[sturdy], single[sturdy], atol=2e-3)


# -- training -----------------------------------------------------------------

@pytest.mark.parametrize("layout", ["slabs", "tiles"])
def test_train_step_matches_reference(layout):
    points, labels = _blobs(11)
    radii = (1.0, 0.5)
    width, lr = 4 * len(radii), 0.1
    j_params = {k: jnp.asarray(v, jnp.float32) for k, v in
                jlinear.init_params(jax.random.PRNGKey(0), width, 3).items()}
    optimizer = optax.sgd(lr)
    t_params = {k: torch.tensor(np.asarray(v), requires_grad=True)
                for k, v in j_params.items()}
    t_opt = torch.optim.SGD(list(t_params.values()), lr=lr)
    if layout == "slabs":
        shards = ttiles.shard_cloud(points, 8, max(radii), extras=[labels])
        data = (shards["slabs"], shards["valid"], shards["extras"][0])
        j_step = jmesh.make_train_step(jmesh.make_mesh(), shards["halo"],
                                       radii, "minimal", 3, optimizer,
                                       weight_decay=1e-3)
        t_step = pmesh.make_train_step(_cpu_mesh_1d(), shards["halo"],
                                       radii, "minimal", 3, t_opt,
                                       weight_decay=1e-3)
    else:
        shards = ttiles.shard_cloud_2d(points, (4, 2), max(radii),
                                       extras=[labels])
        data = (shards["blocks"], shards["valid"], shards["extras"][0])
        j_step = jmesh.make_train_step_2d(
            jmesh.make_mesh_2d((4, 2)), shards["halo_x"], shards["halo_y"],
            radii, "minimal", 3, optimizer, weight_decay=1e-3)
        t_step = pmesh.make_train_step_2d(
            _cpu_mesh_2d((4, 2)), shards["halo_x"], shards["halo_y"], radii,
            "minimal", 3, t_opt, weight_decay=1e-3)
    j_new, _, j_loss = j_step(j_params, optimizer.init(j_params),
                              *(jnp.asarray(a) for a in data))
    t_loss = t_step(t_params, *data)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    for key in ("w", "b"):
        got = t_params[key].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(j_new[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
        # the step itself: the mesh-mean gradient times the rate
        np.testing.assert_allclose(
            np.asarray(j_params[key]) - got,
            np.asarray(j_params[key]) - np.asarray(j_new[key]),
            rtol=1e-4, atol=1e-6, err_msg=key)


# -- the forest across the mesh -----------------------------------------------

@pytest.mark.parametrize("n_dev,n_trees", [(4, 5), (8, 8)])
def test_fit_device_mesh_bit_equal_to_fit_device(n_dev, n_trees):
    rng = np.random.default_rng(4)
    rows, dim = 150, 6
    feats = rng.random((n_dev, rows, dim)).astype(np.float32)
    valid = rng.random((n_dev, rows)) > 0.2
    labels = rng.integers(0, 3, (n_dev, rows)).astype(np.int32)
    single = RPTEnsemble(n_estimators=n_trees, seed=11, device="cpu")
    single.fit_device(torch.from_numpy(feats[valid]), labels[valid], depth=8)
    dist = RPTEnsemble(n_estimators=n_trees, seed=11, device="cpu")
    dist.fit_device_mesh(feats, valid, labels, _cpu_mesh_1d(n_dev), depth=8)
    for key, value in single._tables.items():
        assert torch.equal(dist._tables[key], value), key
    assert dist.walk_depth_ == single.walk_depth_
    probe = rng.random((64, dim)).astype(np.float32)
    np.testing.assert_array_equal(single.predict_proba(probe),
                                  dist.predict_proba(probe))


def test_fit_device_mesh_accuracy_matches_reference():
    n_dev, rows = 4, 750
    feats, labels = forest_data(n_dev * rows, 0, 0.5)
    test_x, test_y = forest_data(4000, 1, 0.5)
    valid = np.random.default_rng(3).random((n_dev, rows)) > 0.1
    shaped = feats.reshape(n_dev, rows, -1)
    shaped_labels = labels.reshape(n_dev, rows)
    ref = JRPT(seed=0)
    ref.fit_device_mesh(shaped, valid, shaped_labels, jmesh.make_mesh(n_dev))
    port = RPTEnsemble(seed=0, device="cpu")
    port.fit_device_mesh(shaped, valid, shaped_labels, _cpu_mesh_1d(n_dev))
    acc_ref = (ref.predict(test_x) == test_y).mean()
    acc_port = (port.predict(test_x) == test_y).mean()
    print(f"held-out accuracy: reference {acc_ref:.4f}, port {acc_port:.4f}")
    assert acc_port > 0.9
    assert abs(acc_port - acc_ref) <= 0.03


def test_bench_2d_extract_matches_reference_at_its_halo_fault():
    # On the bench scene the reference's halo_y plan undersizes the y
    # band (ROADMAP Queue C): its (2, 2) extraction misses neighbors of
    # a few points near a y face.  The port's tables equal the
    # reference's, so its populations equal the reference's, misses
    # included.
    from nimrud_tpu_torch.utils import workload
    cloud, _ = workload.make_bench_cloud(20_000, seed=0)
    radii = (1.0, 0.5)
    ref = jmesh.extract_multichip_2d(cloud, radii, mesh_shape=(2, 2))
    whole = jmesh.extract_multichip_2d(cloud, radii, mesh_shape=(1, 1))
    got = pmesh.extract_multichip_2d(cloud, radii, mesh_shape=(2, 2),
                                     mesh=_cpu_mesh_2d((2, 2)))
    np.testing.assert_array_equal(got[:, POP_COLS], ref[:, POP_COLS])
    missed = np.any(ref[:, POP_COLS] != whole[:, POP_COLS], axis=1)
    assert 0 < missed.sum() <= 1e-3 * len(cloud)
    assert np.all(ref[missed][:, POP_COLS] <= whole[missed][:, POP_COLS])
