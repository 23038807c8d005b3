"""
Inputs of the ``exclude_radius`` tests, in NumPy only (the card tests
import this where jax is not installed).

Every coordinate lies on a dyadic grid fine enough for the boundary
pairs below and coarse enough that every f32 operation of the
difference-form distance is exact, so both kernels decide every pair
the same way:

* self pairs (a candidate equal to its query, ``d2 = 0``): kept at
  ``exclude_radius`` 0 and 1e-30 (``f32(1e-60) = 0``), dropped above;
* pairs ``2^-14 k`` apart along x (``d2 = 2^-28 k^2``): k = 1 falls
  below ``f32(1e-4 ** 2)``, k = 2 above it;
* pairs ``(0.375, 2^-13 k, 0)`` apart (``d2 = 0.140625 + 2^-26 k^2``,
  exact): with ``E_ROUND`` the pair k = 1 sits exactly on the threshold
  ``f32(E_ROUND * E_ROUND)`` and is kept (``>=``), while the threshold
  ``f32(f32(E_ROUND) * f32(E_ROUND))`` is larger and would drop it;
* pairs exactly at a radius along an axis: kept (``<=``).
"""

import numpy as np

F32 = np.float32
RING = 0.375                  # the E_ROUND pairs' x offset


def _rounding_radius():
    """An exclusion radius e whose f32(e*e) (the product in float64, as
    the reference takes it) is the exact d2 of the k = 1 ring pair,
    while f32(f32(e) * f32(e)) is larger."""
    target = F32(RING * RING + 2.0 ** -26)
    e = float(np.sqrt(np.float64(target)))
    assert F32(e * e) == target
    assert F32(F32(e) * F32(e)) > target
    return e


E_ROUND = _rounding_radius()
EXCLUDE_RADII = (0.0, 1e-4, E_ROUND, 1e-30)


def boundary_offsets(radii):
    """(k, 3) local offsets of the boundary pairs from their query."""
    offsets = [(0.0, 0.0, 0.0)] * 2
    offsets += [(2.0 ** -14 * k, 0.0, 0.0) for k in (1, 2, 3)]
    offsets += [(RING, 2.0 ** -13 * k, 0.0) for k in (0, 1, 2, 3)]
    for i, r in enumerate(radii):
        axis = np.zeros(3)
        axis[i % 3] = r if i % 2 else -r
        offsets.append(tuple(axis))
    return np.asarray(offsets)


def _local_block(rng, n_entries, q_cap, n_cand, radii):
    """Entry-local queries on a 1/8 grid and candidates on it, the first
    ones at ``boundary_offsets`` of the first queries."""
    q = rng.integers(-8, 9, (n_entries, q_cap, 3)) / 8.0
    s = rng.integers(-24, 25, (n_entries, n_cand, 3)) / 8.0
    offsets = boundary_offsets(radii)
    n_pairs = min(len(offsets), n_cand)
    for i in range(n_pairs):
        s[:, i] = q[:, i % q_cap] + offsets[i]
    return q, s


def _centers(rng, n_entries):
    return np.round(rng.random((n_entries, 3)) * 200) / 4   # 1/4 grid


def packed_problem(n_entries, q_cap, c_cap, radii, seed, n_attr=0):
    """``packed_moments`` inputs (q_t (E, 3, q_cap), cand_t (3 + A,
    E * c_cap), centers (E, 3)): the boundary pairs in every entry, the
    last quarter of each block FAR, the attribute rows random (FAR on
    the dead lanes).  The last entry holds NaN: query 3 + a at axis a,
    and one candidate a coordinate each."""
    rng = np.random.default_rng(seed)
    centers = _centers(rng, n_entries)
    q, s = _local_block(rng, n_entries, q_cap, c_cap, radii)
    q_t = (q + centers[:, None]).transpose(0, 2, 1).astype(F32)
    cand = (s + centers[:, None]).astype(F32)
    cand[:, c_cap * 3 // 4:] = F32(1.0e6)
    for axis in range(3):
        q_t[-1, axis, 3 + axis] = np.nan
        cand[-1, 20 + axis, axis] = np.nan
    cand_t = cand.reshape(-1, 3).T
    if n_attr:
        attrs = rng.normal(0, 2, (n_attr, cand_t.shape[1])).astype(F32)
        attrs[:, cand_t[0] == F32(1.0e6)] = F32(1.0e6)
        cand_t = np.concatenate([cand_t, attrs])
    return (np.ascontiguousarray(q_t), np.ascontiguousarray(cand_t),
            centers.astype(F32))


def span_problem(n_entries, q_cap, n_span, span_rows, radii, seed):
    """``span_moments`` inputs (q_local, centers, span_starts, span_lens,
    sorted_pts): each entry's spans over its own block of the cloud,
    span 0 holding the boundary pairs, a third of the others empty."""
    rng = np.random.default_rng(seed)
    centers = _centers(rng, n_entries)
    block = 4 * span_rows
    q, s = _local_block(rng, n_entries, q_cap, block, radii)
    pts = (s + centers[:, None]).reshape(-1, 3).astype(F32)
    base = (np.arange(n_entries) * block)[:, None]
    lens = rng.integers(0, span_rows + 1, (n_entries, n_span))
    lens[rng.random((n_entries, n_span)) < 1 / 3] = 0
    starts = base + rng.integers(0, block - span_rows + 1,
                                 (n_entries, n_span))
    starts[:, 0] = base[:, 0]
    lens[:, 0] = min(len(boundary_offsets(radii)), span_rows)
    return (q.astype(F32), centers.astype(F32), starts.astype(np.int32),
            lens.astype(np.int32), pts)


def entry_problem(n_entries, q_cap, flat, radii, seed, share=0.7):
    """``entry_moments`` inputs (q_local, s_local, s_valid): the
    boundary pairs valid in every entry, the other slots valid with
    probability ``share``; entry 0 without a valid slot."""
    rng = np.random.default_rng(seed)
    q, s = _local_block(rng, n_entries, q_cap, flat, radii)
    valid = rng.random((n_entries, flat)) < share
    valid[:, :len(boundary_offsets(radii))] = True
    valid[0] = False
    return q.astype(F32), s.astype(F32), valid


def expanded_d2(q, s):
    """The expanded-form distance in the entry kernel's order, in f32:
    ``(qq + ss) - 2 qs`` with ``qq = (q0*q0 + q1*q1) + q2*q2``, ``ss``
    alike and ``qs = (q0*s0 + q1*s1) + q2*s2``."""
    q, s = np.asarray(q, F32), np.asarray(s, F32)
    qq = (q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]) + q[..., 2] * q[..., 2]
    ss = (s[..., 0] * s[..., 0] + s[..., 1] * s[..., 1]) + s[..., 2] * s[..., 2]
    qs = (q[..., 0] * s[..., 0] + q[..., 1] * s[..., 1]) + q[..., 2] * s[..., 2]
    return (qq + ss) - F32(2.0) * qs


def clamp_problem(seed=0):
    """One entry for the clamp of ``entry_moments``' exclusion test.
    Query 0 and candidate 0 are a self pair up to a few ulps (a query
    exactly equal to a candidate gives d2 = 0 in this order: qs = qq =
    ss), whose exact d2 is tiny and positive but whose expanded f32 d2
    is negative: clamped it passes ``exclude_radius`` 0, unclamped it
    fails.  Candidate 1 holds a NaN (nobody's neighbour), query 1 too
    (it counts nothing); the other candidates lie out of reach.  Returns
    (q_local (1, 8, 3), s_local (1, 16, 3), s_valid (1, 16), the pair's
    expanded d2)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.5, 1.5, (4096, 3)).astype(F32)
    s = (q + rng.integers(-2, 3, q.shape) * np.spacing(q)).astype(F32)
    d2 = expanded_d2(q, s)
    i = int(np.argmin(d2))
    q_local = np.full((1, 8, 3), 40.0, F32)
    s_local = np.full((1, 16, 3), -40.0, F32)
    q_local[0, 0], s_local[0, 0] = q[i], s[i]
    q_local[0, 1, 0] = np.nan
    s_local[0, 1] = q[i]
    s_local[0, 1, 2] = np.nan
    return q_local, s_local, np.ones((1, 16), bool), float(d2[i])
