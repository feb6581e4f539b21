"""Parity of the correlative matcher's two kernels' plain PyTorch versions
(hectorgrapher_tpu_torch/ops) with the Pallas kernels they replace, run in
interpret mode as the JAX package's own tests run them.

K1 tolerance: the port rounds every multiply and add of the cell
computation on its own; XLA on the CPU may contract c*px - s*py into an
FMA, which flips a floor at a cell boundary. Mismatched outputs may make up
at most 1e-5 of all outputs, and each is one cell on one axis.

K2 tolerance: |delta| <= 1e-4 * n_valid — both sides sum at most n_valid
bf16 values, each at most 1, in f32, in different orders.

The K2 kernel pads the table's rows to row_stride(pw) lanes and computes
a one-hot bucket product followed by shifted window sums; its
decomposition is written out here in torch (kernel_decomposition) and
held against the plain gather-sum.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.mapping.scan_matching.correlative_2d import (
    _candidate_thetas,
    _prep_candidates,
    _wide_patch_table,
    _window_geometry,
    make_search_window,
)
from hectorgrapher_tpu.ops.pallas_corr2d import LANES, correlative_scores_2d_batched
from hectorgrapher_tpu.ops.pallas_prep2d import correlative_prep_2d_batched
from hectorgrapher_tpu.transform.rigid import Rigid2
from hectorgrapher_tpu_torch.mapping.scan_matching import correlative_2d as tcorr
from hectorgrapher_tpu_torch.ops.correlative_prep_2d import correlative_prep_2d
from hectorgrapher_tpu_torch.ops.correlative_scores_2d import (
    correlative_scores_2d,
    correlative_scores_2d_plain,
    row_stride,
)
from torch_parity import bf16_to_torch, perturbations, room_grid_and_cloud

torch.set_num_threads(1)

B = 8


@pytest.fixture(scope="module")
def scene():
    grid, cloud, max_range = room_grid_and_cloud(size=256, num_rays=720, capacity=1024)
    return grid, cloud, max_range


def _inputs(scene, linear_window):
    """K1's inputs for B perturbed matches, as numpy, built the way
    _match_correlative_2d_batched_pallas builds them (cos/sin by XLA)."""
    grid, cloud, max_range = scene
    window = make_search_window(linear_window, np.radians(10.0), 0.05, max_range)
    k, gsz, half, m, pw, n_th, n_groups = _window_geometry(window)
    nx, ny = grid.shape
    offs, angs = perturbations(11, B)
    angles = jnp.asarray(angs)[:, None] + _candidate_thetas(window)[None, :]
    params = np.zeros((B, 8), np.float32)
    params[:, 0:2] = offs
    params[:, 2:4] = np.asarray(grid.meta.min_corner)
    params[:, 4] = np.float32(grid.meta.resolution)
    pts = np.broadcast_to(np.asarray(cloud.positions), (B,) + cloud.positions.shape)
    arrays = dict(
        params=params,
        px=np.ascontiguousarray(pts[..., 0]),
        py=np.ascontiguousarray(pts[..., 1]),
        ca=np.array(jnp.cos(angles)),
        sa=np.array(jnp.sin(angles)),
    )
    statics = dict(n_groups=n_groups, gsz=gsz, margin=m, ex=nx + 2 * m, ey=ny + 2 * m)
    return window, offs, angs, arrays, statics


def _assert_cells_agree(flat_a, flat_b, dlin_a, dlin_b, ey, gsz):
    flat_a, flat_b = np.asarray(flat_a), np.asarray(flat_b)
    dlin_a, dlin_b = np.asarray(dlin_a), np.asarray(dlin_b)
    assert flat_a.shape == flat_b.shape and dlin_a.shape == dlin_b.shape
    bad_f = flat_a != flat_b
    bad_d = dlin_a != dlin_b
    n_bad = int(bad_f.sum() + bad_d.sum())
    assert n_bad <= 1e-5 * (flat_a.size + dlin_a.size), n_bad
    for a, b, div in ((flat_a[bad_f], flat_b[bad_f], ey), (dlin_a[bad_d], dlin_b[bad_d], gsz)):
        step = np.abs(np.stack(np.divmod(a, div)) - np.stack(np.divmod(b, div))).sum(axis=0)
        np.testing.assert_array_equal(step, 1)


@pytest.mark.parametrize("linear_window", [0.15, 0.1])  # pw = 11 (the slice), 9 (default)
def test_prep_plain_matches_pallas_interpret(scene, linear_window):
    window, _, _, arrays, statics = _inputs(scene, linear_window)
    flat_j, dlin_j = correlative_prep_2d_batched(
        *(jnp.asarray(arrays[k]) for k in ("params", "px", "py", "ca", "sa")), **statics, interpret=True
    )
    before = correlative_prep_2d.launches
    flat_t, dlin_t = correlative_prep_2d(
        *(torch.from_numpy(arrays[k]) for k in ("params", "px", "py", "ca", "sa")), **statics
    )
    assert correlative_prep_2d.launches == before  # CPU tensors: the plain version, no launch
    assert flat_t.dtype == torch.int32 and dlin_t.dtype == torch.int32
    _assert_cells_agree(flat_j, flat_t, dlin_j, dlin_t, statics["ey"], statics["gsz"])


@pytest.mark.parametrize("linear_window", [0.15, 0.1])
def test_prep_plain_matches_xla_prep(scene, linear_window):
    grid, cloud, _ = scene
    window, offs, angs, arrays, statics = _inputs(scene, linear_window)
    nx, ny = grid.shape
    flat_t, dlin_t = correlative_prep_2d(
        *(torch.from_numpy(arrays[k]) for k in ("params", "px", "py", "ca", "sa")), **statics
    )
    prep = jax.jit(_prep_candidates, static_argnums=(3, 4, 5))
    for i in range(B):
        pose = Rigid2(translation=jnp.asarray(offs[i]), angle=jnp.asarray(angs[i]))
        flat_j, dlin_j = prep(grid.meta, cloud.positions[:, :2], pose, window, nx, ny)
        _assert_cells_agree(flat_j, flat_t[i], dlin_j, dlin_t[i], statics["ey"], statics["gsz"])


@pytest.mark.parametrize("linear_window", [0.15, 0.1])
def test_wide_patch_table_bit_equal(scene, linear_window):
    grid, _, _ = scene
    window = make_search_window(linear_window, np.radians(10.0), 0.05, 5.0)
    k, gsz, half, *_ = _window_geometry(window)
    prob = grid.probability()
    table_j = bf16_to_torch(_wide_patch_table(prob, k, half))
    table_t = tcorr._wide_patch_table(torch.from_numpy(np.asarray(prob, np.float32)), k, half)
    assert table_t.dtype == torch.bfloat16
    assert torch.equal(table_t.view(torch.int16), table_j.view(torch.int16))


@pytest.mark.parametrize("linear_window", [0.15, 0.1])
def test_scores_plain_matches_pallas_interpret(scene, linear_window):
    grid, cloud, _ = scene
    window, _, _, arrays, statics = _inputs(scene, linear_window)
    k, gsz, half, m, pw, n_th, n_groups = _window_geometry(window)
    d = 2 * k + 1
    flat_j, dlin_j = correlative_prep_2d_batched(
        *(jnp.asarray(arrays[k_]) for k_ in ("params", "px", "py", "ca", "sa")), **statics, interpret=True
    )
    table = _wide_patch_table(grid.probability(), k, half)
    valid = jnp.broadcast_to(cloud.mask, (B,) + cloud.mask.shape).astype(jnp.float32)
    rows = jnp.take(jnp.pad(table, ((0, 0), (0, LANES - pw * pw))), flat_j, axis=0)
    wide = np.asarray(
        correlative_scores_2d_batched(dlin_j, valid, rows, n_groups=n_groups, gsz=gsz, pw=pw, interpret=True)
    )
    lanes = (np.arange(d)[:, None] * pw + np.arange(d)[None, :]).reshape(-1)
    ref = wide[:, :, lanes].reshape(B, n_groups * gsz, d, d)

    before = correlative_scores_2d.launches
    got = correlative_scores_2d(
        bf16_to_torch(table),
        torch.from_numpy(np.array(flat_j)),
        torch.from_numpy(np.array(dlin_j)),
        torch.from_numpy(np.array(valid)),
        n_groups, gsz, pw, k,
    )
    assert correlative_scores_2d.launches == before
    assert got.shape == (B, n_groups * gsz, d, d) and got.dtype == torch.float32
    n_valid = float(np.asarray(cloud.mask).sum())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * n_valid)


def test_wrappers_refuse_other_devices():
    meta = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError):
        correlative_prep_2d(meta, meta, meta, meta, meta, n_groups=1, gsz=5, margin=5, ex=10, ey=10)
    with pytest.raises(ValueError):
        correlative_scores_2d(meta, meta.int(), meta.int(), meta, 1, 5, 11, 3)


@pytest.mark.parametrize("linear_window", [0.15, 0.1])
def test_prepared_table_is_pallas_table_p(scene, linear_window):
    """prepare_correlative_table's padded rows are, bit for bit, the table_p
    the Pallas path gathers from (correlative_2d.py:391)."""
    grid, _, _ = scene
    window = make_search_window(linear_window, np.radians(10.0), 0.05, 5.0)
    k, gsz, half, m, pw, *_ = _window_geometry(window)
    prob = grid.probability()
    table_p = bf16_to_torch(jnp.pad(_wide_patch_table(prob, k, half), ((0, 0), (0, LANES - pw * pw))))
    prob_t = torch.from_numpy(np.array(prob, np.float32))
    table_t = tcorr.prepare_correlative_table(SimpleNamespace(probability=lambda: prob_t), window)
    assert table_t.shape == table_p.shape and table_t.shape[1] == row_stride(pw) == LANES
    assert torch.equal(table_t.view(torch.int16), table_p.view(torch.int16))


@pytest.mark.parametrize("linear_window", [0.15, 0.1])
def test_scores_plain_on_padded_table_matches_pallas_interpret(scene, linear_window):
    grid, cloud, _ = scene
    window, _, _, arrays, statics = _inputs(scene, linear_window)
    k, gsz, half, m, pw, n_th, n_groups = _window_geometry(window)
    d = 2 * k + 1
    flat_j, dlin_j = correlative_prep_2d_batched(
        *(jnp.asarray(arrays[k_]) for k_ in ("params", "px", "py", "ca", "sa")), **statics, interpret=True
    )
    table_p = jnp.pad(_wide_patch_table(grid.probability(), k, half), ((0, 0), (0, LANES - pw * pw)))
    valid = jnp.broadcast_to(cloud.mask, (B,) + cloud.mask.shape).astype(jnp.float32)
    wide = np.asarray(correlative_scores_2d_batched(
        dlin_j, valid, jnp.take(table_p, flat_j, axis=0), n_groups=n_groups, gsz=gsz, pw=pw, interpret=True
    ))
    lanes = (np.arange(d)[:, None] * pw + np.arange(d)[None, :]).reshape(-1)
    ref = wide[:, :, lanes].reshape(B, n_groups * gsz, d, d)
    got = correlative_scores_2d(
        bf16_to_torch(table_p), torch.from_numpy(np.array(flat_j)), torch.from_numpy(np.array(dlin_j)),
        torch.from_numpy(np.array(valid)), n_groups, gsz, pw, k,
    )
    n_valid = float(np.asarray(cloud.mask).sum())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * n_valid)


def kernel_decomposition(table, flat, delta_lin, valid, n_groups, gsz, pw, k):
    """K2's computation written out in torch: per (match, group) the one-hot
    (gsz^3, N) matrix [delta(l, n) = j] * valid(n), rows (l, j) l-major,
    times the gathered rows -> bucket (gsz^3, stride) in f32; then
    scores[l, ox, oy] = sum over j, in j order, of bucket[(l, j)] at lane
    (ox + jx) * pw + oy + jy."""
    d = 2 * k + 1
    b, g, n = flat.shape
    gsz2 = gsz * gsz
    rows = table[flat.long()].float()  # (B, G, N, stride)
    dl = delta_lin.reshape(b, g, gsz, 1, n).long()
    onehot = (dl == torch.arange(gsz2).reshape(1, 1, 1, gsz2, 1)) & (valid > 0)[:, None, None, None, :]
    bucket = onehot.float().reshape(b, g, gsz * gsz2, n) @ rows  # (B, G, gsz^3, stride)
    bucket = bucket.reshape(b, g, gsz, gsz2, -1)
    r = torch.arange(d)
    out = torch.zeros((b, g, gsz, d, d))
    for j in range(gsz2):
        jx, jy = divmod(j, gsz)
        q = (r[:, None] + jx) * pw + r[None, :] + jy  # (d, d)
        out = out + bucket[:, :, :, j][..., q]
    return out.reshape(b, g * gsz, d, d)


@pytest.mark.parametrize("k", [1, 3, 5])  # pw^2 = 49, 121, 225 (> 128: two lane chunks)
def test_kernel_decomposition_is_the_plain_gather_sum(k):
    rng = np.random.default_rng(k)
    gsz, b, g, n = 5, 3, 4, 150
    pw = 2 * k + gsz
    stride = row_stride(pw)
    table = np.zeros((40, stride), np.float32)
    table[:, : pw * pw] = rng.uniform(0, 1, (40, pw * pw))
    table = torch.from_numpy(table).to(torch.bfloat16)
    flat = torch.from_numpy(rng.integers(0, 40, (b, g, n)).astype(np.int32))
    dlin = torch.from_numpy(rng.integers(0, gsz * gsz, (b, g * gsz, n)).astype(np.int32))
    valid = (rng.random((b, n)) < 0.6).astype(np.float32)
    valid[1] = 0.0  # a match with no valid point scores 0
    valid = torch.from_numpy(valid)
    args = (table, flat, dlin, valid, g, gsz, pw, k)
    got = kernel_decomposition(*args)
    want = correlative_scores_2d_plain(*args)
    n_valid = float(valid.sum(dim=1).max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * n_valid)
    assert float(got[1].abs().max()) == 0.0
