"""3D range-data insertion (counterpart of hectorgrapher_tpu/mapping/
inserters_3d.py).

Occupancy (ref: mapping/3d/range_data_inserter_3d.cc Insert +
InsertMissesIntoGrid): one odds update per hit cell, misses only on the
last num_free_space_voxels samples before each hit, a hit winning over a
miss in the same cell. Both are set-scatters of a constant into a mask,
so the card's result is deterministic and equal to the JAX package's bit
for bit.

TSDF (ref: mapping/3d/tsdf_range_data_inserter_3d.cc — ray-directed updates
(InsertHit, :294) with exponential weight drop-off behind the surface
(:333-341), or normal-directed ones (InsertHitWithNormal, :197) with the
normals of the organized cloud's neighbours (CLOUD_STRUCTURE, :503-607) or
of a k-NN PCA (KNN_PCA, PCL, OPEN3D: Open3D's EstimateNormals, :405-489),
or triangle fill-in between adjacent rays (TRIANGLE_FILL_IN, :83-195);
weighted-average cell update (UpdateCell, :725), insertion_ratio
subsampling).

The per-sample UpdateCell loop becomes a scatter-add of (sum w, sum w*d)
followed by one combined update: the running weighted mean is
order-independent, except that the weight cap applies once at scan end.
On the card index_add_ sums with atomics in no fixed order (ROADMAP C3),
so a map matches the JAX package's to a tolerance, not bit for bit.

make_tsdf_inserter_3d dispatches as the JAX package does: CLOUD_STRUCTURE
and TRIANGLE_FILL_IN need organized range data (width > 0, from the
classic 3D builder and the tools); the CT builder hands over width 0, so
they fall through to the ray mode there, while the k-NN PCA methods run
at any width. knn_pca_normals forms the dense (P, P) distances, takes the
k nearest with topk and the smallest eigenvector of each neighbourhood's
covariance with eigh, all on the grid's device.
"""

from __future__ import annotations

import math

import torch

from hectorgrapher_tpu_torch.mapping import probability_values as pv
from hectorgrapher_tpu_torch.mapping.grids import ProbabilityGrid, TSDFGrid, cell_center, cell_index, flat_index
from hectorgrapher_tpu_torch.sensor.types import RangeData


def insertion_ratio_mask(valid, ratio: float):
    """Deterministic subsampling: keep a point while the running kept count
    stays <= ratio * processed count (ref: tsdf_range_data_inserter_3d.cc
    :503-519 insertion_ratio gate), over the valid sequence."""
    if ratio >= 1.0:
        return valid
    c = torch.cumsum(valid.to(torch.int32), dim=0)  # processed count including self
    kept_before = torch.floor(ratio * (c - 1).to(torch.float32))
    kept_incl = torch.floor(ratio * c.to(torch.float32))
    return valid & (kept_incl > kept_before)


def insert_probability_3d(
    grid: ProbabilityGrid,
    range_data: RangeData,
    hit_log_odds: float,
    miss_log_odds: float,
    num_free_space_voxels: int = 2,
) -> ProbabilityGrid:
    """(inserters_3d.py insert_probability_3d :59-111.) Hits: one odds
    update per hit cell. Misses: the cells origin + (delta * pos) // n of
    the last num_free_space_voxels sample positions pos < n before each
    hit, n the hit's Chebyshev cell distance from the origin's cell. Hits
    take priority over misses in the same scan."""
    shape = grid.shape
    hits = range_data.returns.positions
    valid = range_data.returns.mask
    hit_idx = cell_index(grid.meta, hits)
    hit_mask = _scatter_mask3(shape, flat_index(hit_idx, shape), valid)
    if num_free_space_voxels > 0:
        origin_cell = cell_index(grid.meta, range_data.origin[None, :])[0]
        delta = hit_idx - origin_cell[None, :]
        num_samples = torch.amax(torch.abs(delta), dim=-1)  # (P,)
        offsets = torch.arange(num_free_space_voxels, dtype=torch.int32, device=hits.device)
        pos = num_samples[:, None] - num_free_space_voxels + offsets[None, :]
        pos_valid = (pos >= 0) & (pos < num_samples[:, None]) & valid[:, None]
        n_safe = torch.clamp(num_samples, min=1)[:, None, None]
        # delta is negative behind the origin: floor division, as JAX's //.
        miss_cells = origin_cell + torch.div(delta[:, None, :] * pos[:, :, None], n_safe, rounding_mode="floor")
        miss_mask = _scatter_mask3(shape, flat_index(miss_cells, shape).reshape(-1), pos_valid.reshape(-1))
        miss_mask = miss_mask & ~hit_mask
    else:
        miss_mask = torch.zeros(shape, dtype=torch.bool, device=hits.device)
    f32 = dict(dtype=torch.float32, device=hits.device)
    delta_lo = torch.where(hit_mask, torch.tensor(hit_log_odds, **f32), 0.0) + torch.where(
        miss_mask, torch.tensor(miss_log_odds, **f32), 0.0)
    touched = hit_mask | miss_mask
    return grid._replace(
        log_odds=torch.where(touched, pv.clamp_log_odds(grid.log_odds + delta_lo), grid.log_odds),
        known=grid.known | touched,
    )


def _scatter_mask3(shape, flat_idx, valid):
    """A bool grid of `shape`, True at flat_idx where valid (flat_index
    sends out-of-grid cells to the drop slot at the end)."""
    size = math.prod(shape)
    mask = torch.zeros(size + 1, dtype=torch.bool, device=flat_idx.device)
    mask[torch.where(valid, flat_idx, size)] = True
    return mask[:size].reshape(shape)


def make_probability_inserter_3d(options):
    """Bind ProbabilityGridRangeDataInserterOptions3D: the hit and miss
    log-odds in Python float64, as the JAX package computes them."""
    hit_lo = math.log(options.hit_probability / (1 - options.hit_probability))
    miss_lo = math.log(options.miss_probability / (1 - options.miss_probability))
    k = int(options.num_free_space_voxels)

    def insert(grid: ProbabilityGrid, range_data: RangeData) -> ProbabilityGrid:
        return insert_probability_3d(grid, range_data, hit_lo, miss_lo, num_free_space_voxels=k)

    return insert


def structured_cloud_normals(cloud, origin, width: int, vertical_stride: int = 1, horizontal_stride: int = 5,
                             resolution: float = 0.1):
    """Surface normals from an organized cloud's neighbour structure
    (inserters_3d.py :137-207; ref: tsdf_range_data_inserter_3d.cc:503-607
    CLOUD_STRUCTURE): per point, the index offsets up to +-vertical_stride
    (adjacent points) and +-horizontal_stride * width (adjacent scan
    lines) are tried farthest-first for a neighbour whose range differs by
    at most resolution / 0.05, falling back to the point's own index; the
    normal is the normalized cross product of the two neighbour
    differences, valid where each axis found two distinct indices.
    Returns (normals (N, 3), valid (N,))."""
    pts = cloud.positions
    n = pts.shape[0]
    r = torch.linalg.vector_norm(pts - origin[None, :], dim=-1)
    max_range_delta = resolution / 0.05
    base = torch.arange(n, device=pts.device)

    def find_neighbor(offsets):
        best, found = base, torch.zeros(n, dtype=torch.bool, device=pts.device)
        for off in offsets:
            j = base + off
            jc = torch.clamp(j, 0, n - 1)
            ok = (j >= 0) & (j < n) & cloud.mask[jc] & (torch.abs(r - r[jc]) <= max_range_delta)
            best = torch.where(~found & ok, j, best)
            found = found | ok
        return best, found

    up = list(range(vertical_stride, 0, -1))
    h = max(1, horizontal_stride) * max(1, width)
    right = list(range(h, 0, -max(1, width)))
    i_vu, f_vu = find_neighbor(up)
    i_vl, f_vl = find_neighbor([-o for o in up])
    i_hu, f_hu = find_neighbor(right)
    i_hl, f_hl = find_neighbor([-o for o in right])
    normal = torch.linalg.cross(pts[i_hl] - pts[i_hu], pts[i_vl] - pts[i_vu])
    norm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    ok = cloud.mask & (f_vu | f_vl) & (f_hu | f_hl) & (i_vu != i_vl) & (i_hu != i_hl) & (norm[:, 0] > 1e-9)
    return normal / torch.clamp(norm, min=1e-9), ok


def knn_pca_normals(points, valid, origin, k: int = 16, radius: float = 0.4):
    """k-NN PCA surface normals (inserters_3d.py :406-439; ref:
    tsdf_range_data_inserter_3d.cc:405-489, Open3D EstimateNormals with a
    hybrid radius / k-NN search): the dense (P, P) squared distances of
    the valid points, the k nearest (self included) by topk, the
    covariance of those within `radius`, the eigenvector of its smallest
    eigenvalue (eigh), turned toward the sensor. Returns (normals (P, 3),
    ok (P,)): ok needs >= 3 neighbours in the radius. An eigenvector is
    defined up to its sign and, for a repeated smallest eigenvalue, up to
    a rotation within its eigenspace."""
    p = points.shape[0]
    d2 = torch.sum((points[:, None, :] - points[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(valid[None, :] & valid[:, None], d2, 1e30)
    neg, idx = torch.topk(-d2, min(k, p), dim=1)
    nbr = points[idx]
    w = ((-neg) <= radius * radius) & valid[idx] & valid[:, None]
    n = torch.clamp(torch.sum(w, dim=-1), min=1).to(points.dtype)[:, None]
    mean = torch.sum(torch.where(w[..., None], nbr, 0.0), dim=1) / n
    centered = torch.where(w[..., None], nbr - mean[:, None, :], 0.0)
    cov = torch.einsum("pki,pkj->pij", centered, centered) / n[..., None]
    _, eigvecs = torch.linalg.eigh(cov)  # ascending eigenvalues
    normal = eigvecs[..., 0]
    flip = torch.sum(normal * (origin[None, :] - points), dim=-1) < 0.0
    normal = torch.where(flip[:, None], -normal, normal)
    return normal, valid & (torch.sum(w, dim=-1) >= 3)


def _update_cells(grid: TSDFGrid, flat, ok, w, d) -> TSDFGrid:
    """The weighted-average cell update (UpdateCell, :725) of the samples
    at flat cell indices where ok, with weights w and distances d: a
    scatter-add of (sum w, sum w*d), then one update. Half planes (f16,
    bf16) are read in f32 and the update rounded back to their dtype to
    nearest even, as the JAX package's astype does. A bf16 weight holds
    integers exactly only up to 256: above that it stops growing, in the
    JAX package and here alike."""
    size = grid.tsd.numel()
    device = flat.device
    slot = torch.where(ok, flat, size).reshape(-1)
    w_sum = torch.zeros(size + 1, dtype=torch.float32, device=device).index_add_(
        0, slot, torch.where(ok, w, 0.0).reshape(-1))[:size].reshape(grid.shape)
    wd_sum = torch.zeros(size + 1, dtype=torch.float32, device=device).index_add_(
        0, slot, torch.where(ok, w * d, 0.0).reshape(-1))[:size].reshape(grid.shape)
    tsd32 = grid.tsd.to(torch.float32)
    wgt32 = grid.weight.to(torch.float32)
    new_w_raw = wgt32 + w_sum
    new_tsd = torch.where(w_sum > 0, (tsd32 * wgt32 + wd_sum) / torch.clamp(new_w_raw, min=1e-9), tsd32)
    return grid._replace(tsd=new_tsd.to(grid.tsd.dtype),
                         weight=torch.minimum(new_w_raw, grid.max_weight).to(grid.weight.dtype))


def insert_tsdf_3d(
    grid: TSDFGrid,
    hits,
    valid,
    origin,
    num_band_samples: int,
    weight_epsilon: float,
    weight_sigma: float,
    normals=None,
) -> TSDFGrid:
    """TSDF integration (inserters_3d.py insert_tsdf_3d :215-290). Without
    normals, the ray mode (ref InsertHit :294): the truncation band is
    swept along the ray through each hit; the update distance is range -
    |cell_center - origin|, with an exponential weight drop-off behind the
    surface (:333-341). With normals (N, 3) (ref InsertHitWithNormal
    :197): the band is swept along the normal, turned against the ray
    (:210-211), the distance is (cell_center - hit) . normal, weight 1."""
    td = grid.truncation_distance
    ray = hits - origin[None, :]
    ranges = torch.linalg.vector_norm(ray, dim=-1)
    ray_dir = ray / torch.clamp(ranges[:, None], min=1e-9)
    valid = valid & (ranges > td)

    s = torch.linspace(-1.0, 1.0, num_band_samples, dtype=torch.float32, device=hits.device)
    if normals is not None:
        nd = torch.where(torch.sum(normals * ray, dim=-1) > 0, -1.0, 1.0)
        n_oriented = nd[:, None] * normals
        band_pts = hits[:, None, :] + (s[None, :, None] * td) * n_oriented[:, None, :]
        idx = cell_index(grid.meta, band_pts)
        centers = cell_center(grid.meta, idx)
        d = torch.clamp(torch.sum((centers - hits[:, None, :]) * n_oriented[:, None, :], dim=-1), -td, td)
        w = torch.ones_like(d)
    else:
        band_pts = hits[:, None, :] + (s[None, :, None] * td) * ray_dir[:, None, :]
        idx = cell_index(grid.meta, band_pts)
        centers = cell_center(grid.meta, idx)
        d = ranges[:, None] - torch.linalg.vector_norm(centers - origin[None, None, :], dim=-1)
        d = torch.clamp(d, -td, td)
        nd_norm = d / td
        w = torch.where(
            nd_norm < -weight_epsilon,
            torch.exp(-weight_sigma * (-nd_norm - weight_epsilon) ** 2),
            torch.ones_like(nd_norm),
        )
    flat = flat_index(idx, grid.shape)
    return _update_cells(grid, flat, valid[:, None].expand(flat.shape), w, d)


def insert_tsdf_3d_triangles(grid: TSDFGrid, cloud, origin, width: int, num_layers: int, bary_samples: int = 6,
                             max_edge: float = 1.0) -> TSDFGrid:
    """TRIANGLE_FILL_IN (inserters_3d.py :296-404; ref:
    tsdf_range_data_inserter_3d.cc:83-195 InsertTriangle/RasterTriangle):
    each quad of the organized cloud forms two triangles (edges below
    max_edge, oriented toward the sensor); each is sampled on a fixed
    barycentric grid on num_layers layers offset along its normal by
    multiples of the resolution, with distance (cell_center - v0) .
    normal, weight 1."""
    td = grid.truncation_distance
    res = grid.meta.resolution
    pts = cloud.positions
    device = pts.device
    rows = pts.shape[0] // width
    idx = torch.arange((rows - 1) * (width - 1), device=device)
    r, c = idx // (width - 1), idx % (width - 1)
    i00 = r * width + c
    i01, i10 = i00 + 1, i00 + width
    i11 = i10 + 1
    norm = lambda x: torch.linalg.vector_norm(x, dim=-1)

    def tri_arrays(a, b, cc):
        v0, v1, v2 = pts[a], pts[b], pts[cc]
        e = torch.maximum(norm(v1 - v0), torch.maximum(norm(v2 - v0), norm(v2 - v1)))
        nrm = torch.linalg.cross(v1 - v0, v2 - v0)
        nn = norm(nrm)[:, None]
        valid = cloud.mask[a] & cloud.mask[b] & cloud.mask[cc] & (e < max_edge) & (nn[:, 0] > 1e-9)
        nrm = nrm / torch.clamp(nn, min=1e-9)
        flip = torch.sum(nrm * (origin[None, :] - v0), dim=-1) < 0
        return v0, v1, v2, torch.where(flip[:, None], -nrm, nrm), valid

    v0, v1, v2, nrm, valid = (torch.cat(pair) for pair in zip(tri_arrays(i00, i01, i10), tri_arrays(i01, i11, i10)))
    lin = (torch.arange(bary_samples, dtype=torch.float32, device=device) + 0.5) / bary_samples
    aa, bb = torch.meshgrid(lin, lin, indexing="ij")
    bary_ok = ((aa + bb) <= 1.0).reshape(-1)
    aa, bb = aa.reshape(-1), bb.reshape(-1)
    offsets = (torch.arange(num_layers, dtype=torch.float32, device=device) - num_layers // 2) * res
    base = v0[:, None, :] + aa[None, :, None] * (v1 - v0)[:, None, :] + bb[None, :, None] * (v2 - v0)[:, None, :]
    q = base[:, None, :, :] + offsets[None, :, None, None] * nrm[:, None, None, :]
    cell = cell_index(grid.meta, q)
    centers = cell_center(grid.meta, cell)
    d = torch.clamp(torch.sum((centers - v0[:, None, None, :]) * nrm[:, None, None, :], dim=-1), -td, td)
    flat = flat_index(cell, grid.shape)
    ok = (valid[:, None, None] & bary_ok[None, None, :]).expand(flat.shape)
    return _update_cells(grid, flat, ok, torch.ones_like(d), d)


def make_tsdf_inserter_3d(options, resolution: float):
    """Bind TSDFRangeDataInserterOptions3D into an insert function; the
    normal_computation_method dispatch of inserters_3d.py :441-506:
    TRIANGLE_FILL_IN and CLOUD_STRUCTURE on organized range data (width >
    0), KNN_PCA / PCL / OPEN3D at any width, else the ray mode."""
    num_band_samples = max(4, int(2.0 * options.relative_truncation_distance / 0.5) + 1)
    method = options.normal_computation_method
    num_layers = 2 * int(round(options.relative_truncation_distance)) + 1
    weights = dict(weight_epsilon=options.weight_function_epsilon, weight_sigma=options.weight_function_sigma)

    def insert(grid: TSDFGrid, range_data: RangeData) -> TSDFGrid:
        hits = range_data.returns.positions
        r = torch.linalg.vector_norm(hits - range_data.origin[None, :], dim=-1)
        valid = range_data.returns.mask & (r >= options.min_range) & (r <= options.max_range)
        valid = insertion_ratio_mask(valid, float(options.insertion_ratio))
        width = int(range_data.width)
        if method == "TRIANGLE_FILL_IN" and width > 0:
            return insert_tsdf_3d_triangles(grid, range_data.returns._replace(mask=valid), range_data.origin,
                                            width=width, num_layers=num_layers)
        normals = None
        if method == "CLOUD_STRUCTURE" and width > 0:
            normals, n_ok = structured_cloud_normals(
                range_data.returns, range_data.origin, width=width,
                vertical_stride=int(options.normal_computation_vertical_stride),
                horizontal_stride=int(options.normal_computation_horizontal_stride), resolution=resolution)
            valid = valid & n_ok
        elif method in ("KNN_PCA", "PCL", "OPEN3D"):
            normals, n_ok = knn_pca_normals(hits, valid, range_data.origin, k=int(options.normal_estimate_max_nn),
                                            radius=float(options.normal_estimate_radius))
            valid = valid & n_ok
        return insert_tsdf_3d(grid, hits, valid, range_data.origin, num_band_samples=num_band_samples,
                              normals=normals, **weights)

    return insert
