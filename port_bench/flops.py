"""The work of one training step, counted from the configuration's widths
and the batch's own geometry, whatever kernel runs it (the yardstick of
``mfu_pct.train`` and ``bev2d_roofline_pct.train``).

- A dense convolution or a matmul counts 2 x output elements x contraction
  (a transposed convolution of kernel = stride: contraction Cin).
- A sparse convolution counts 2 x rulebook pairs x Cin x Cout, the pairs
  worked out here again from voxel coordinates derived from the points: the
  voxels of the in-range valid points in lexicographic (b, x, y, z) order,
  the first VOXEL_CAP kept; a strided convolution's outputs every cell whose
  receptive field holds an input, the first ``out_cap`` in (b, z, y, x)
  order; a pair is an (input, kernel offset) whose output is kept (a
  submanifold convolution: both sites active).
- Rows of a point or RoI MLP: every row the layer computes (keypoints x
  samples, RoIs x grid points x samples), the samples a ball query did not
  fill included.
- A training step counts each product three times: the forward, the input
  gradient and the weight gradient.

Bytes (the roofline's other bound) are each convolution's input, weights and
output once for each of the three products, float32. Elementwise work
(batch norms, activations, losses) is counted in neither.
"""

from __future__ import annotations

import torch

TRAIN = 3  # forward, input gradient, weight gradient
F32 = 4
# the sparse backbones: stage channels c0..c4 and whether stages are residual
BACKBONES_3D = {"VoxelResBackBone8x": ((16, 16, 32, 64, 128), True),
                "VoxelBackBone8x": ((16, 16, 32, 64, 64), False)}
CONV_OUT_CHANNELS = 128
# CenterHead's shared conv and its heads' widths (hm takes the class count)
CENTER_SHARED, CENTER_OUTS = 64, (2, 1, 3, 2)
# VoxelSetAbstraction's groups (source, cin, MLP) beside the BEV map, its
# samples a keypoint and its output width
PFE_NSAMPLE, PFE_OUT = 16, 128
# PVRCNNHead: samples a grid point, its MLP width and the FC trunk
ROI_NSAMPLE, ROI_MLP, ROI_FC = 16, 64, (256, 256)


def _keys(coords, shape):
    """Linear keys of (b, z, y, x) coords in a (D, H, W) grid."""
    D, H, W = shape
    return ((coords[:, 0] * D + coords[:, 1]) * H + coords[:, 2]) * W + coords[:, 3]


def voxel_sites(points, valid, pcr, voxel_size, cap):
    """The kept voxels' (b, z, y, x) coords [V, 4] int64 and the occupied
    voxels of each sample before the cap. ``points`` [B, N, 4] (column 0
    unused), ``valid`` [B, N]."""
    B, N, _ = points.shape
    dev = points.device
    origin = torch.tensor(pcr[:3], dtype=points.dtype, device=dev)
    hi = torch.tensor(pcr[3:], dtype=points.dtype, device=dev)
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=dev)
    xyz = points[..., 1:4]
    ok = valid & ((xyz >= origin) & (xyz < hi)).all(-1)
    cell = torch.floor((xyz - origin) / vs).long()  # the VFE's arithmetic, in the points' dtype
    grid = [int(round((pcr[i + 3] - pcr[i]) / voxel_size[i])) for i in range(3)]
    b = torch.arange(B, device=dev)[:, None].expand(B, N)
    key = ((b * grid[0] + cell[..., 0]) * grid[1] + cell[..., 1]) * grid[2] + cell[..., 2]
    uniq = torch.unique(key[ok])  # sorted: (b, x, y, z) lexicographic
    per_sample = [int(v) for v in torch.bincount(uniq // (grid[0] * grid[1] * grid[2]),
                                                 minlength=B)]
    uniq = uniq[:cap]
    z = uniq % grid[2]
    y = (uniq // grid[2]) % grid[1]
    x = (uniq // (grid[2] * grid[1])) % grid[0]
    bb = uniq // (grid[0] * grid[1] * grid[2])
    return torch.stack([bb, z, y, x], 1), per_sample


def _offsets(ks, dev):
    axes = [torch.arange(k, device=dev) for k in ks]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def subm_pairs(coords, shape):
    """Pairs of a 3x3x3 submanifold convolution over the active ``coords``."""
    keys = torch.sort(_keys(coords, shape)).values
    total = 0
    lim = torch.tensor(shape, device=coords.device)
    for off in _offsets((3, 3, 3), coords.device) - 1:
        nb = coords[:, 1:] + off
        inside = ((nb >= 0) & (nb < lim)).all(1)
        k = _keys(torch.cat([coords[:, :1], nb], 1), shape)
        pos = torch.searchsorted(keys, k).clamp(max=keys.numel() - 1)
        total += int((inside & (keys[pos] == k)).sum())
    return total


def strided(coords, shape, ks, stride, pad, out_cap):
    """(output coords, output shape, pairs) of a strided sparse convolution."""
    dev = coords.device
    out_shape = tuple((shape[i] + 2 * pad[i] - ks[i]) // stride[i] + 1 for i in range(3))
    st, pd = torch.tensor(stride, device=dev), torch.tensor(pad, device=dev)
    zyx = coords[None, :, 1:] + pd - _offsets(ks, dev)[:, None, :]
    op = torch.div(zyx, st, rounding_mode="floor")
    ok = ((zyx % st == 0).all(-1) & (op >= 0).all(-1)
          & (op < torch.tensor(out_shape, device=dev)).all(-1))
    cand = torch.cat([coords[None, :, :1].expand(ok.shape + (1,)), op], -1)[ok]
    ck = _keys(cand, out_shape)
    kept = torch.unique(ck)[:out_cap]
    pos = torch.searchsorted(kept, ck).clamp(max=max(kept.numel() - 1, 0))
    pairs = int((kept[pos] == ck).sum()) if kept.numel() else 0
    D, H, W = out_shape
    out = torch.stack([kept // (D * H * W), (kept // (H * W)) % D, (kept // W) % H, kept % W], 1)
    return out, out_shape, pairs


def _conv2d(b, cin, cout, h_out, w_out, k, h_in, w_in):
    """(flops, bytes) of one training step of a dense 2D convolution."""
    flops = 2 * b * cout * h_out * w_out * cin * k * k
    nbytes = (b * cin * h_in * w_in + cin * cout * k * k + b * cout * h_out * w_out) * F32
    return TRAIN * flops, TRAIN * nbytes


def _linear(rows, cin, cout):
    return TRAIN * 2 * rows * cin * cout


def step_work(cfg, points, valid):
    """The work of one training step on one batch: a dict of ``flops`` (the
    step), ``bev_flops`` and ``bev_bytes`` (BaseBEVBackbone's convolutions),
    ``parts`` (flops by layer), ``voxels_per_sample`` (before the cap) and
    ``voxels_kept``."""
    model, data = cfg["MODEL"], cfg["DATA_CONFIG"]
    pcr = [float(v) for v in data["POINT_CLOUD_RANGE"]]
    vs = [float(v) for v in data["VOXEL_SIZE"]]
    grid = [int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3)]
    cap = int(model["VOXEL_CAP"])
    B = points.shape[0]
    n_feat = len(data["POINT_FEATURE_ENCODING"]["used_feature_list"])
    n_cls = len(cfg["CLASS_NAMES"])
    parts = {}

    # sparse 3D backbone
    (c, residual) = BACKBONES_3D[model["BACKBONE_3D"]["NAME"]]
    sites, per_sample = voxel_sites(points, valid, pcr, vs, cap)
    shape = (grid[2] + 1, grid[1], grid[0])
    p = subm_pairs(sites, shape)
    sparse = p * n_feat * c[0] + (4 * p * c[1] * c[1] if residual else p * c[0] * c[1])
    caps = {2: cap, 3: max(cap // 2, 1), 4: max(cap // 4, 1)}
    for s in (2, 3, 4):
        sites, shape, pd = strided(sites, shape, (3, 3, 3), (2, 2, 2), (1, 1, 1), caps[s])
        p = subm_pairs(sites, shape)
        sparse += pd * c[s - 1] * c[s] + (4 if residual else 2) * p * c[s] * c[s]
    sites, shape, pd = strided(sites, shape, (3, 1, 1), (2, 1, 1), (0, 0, 0), caps[4])
    sparse += pd * c[4] * CONV_OUT_CHANNELS
    parts["sparse3d"] = TRAIN * 2 * sparse
    D, H, W = shape
    bev_c = CONV_OUT_CHANNELS * D

    # BaseBEVBackbone
    b2d = model["BACKBONE_2D"]
    bev_flops = bev_bytes = 0
    cin, h, w, ups = bev_c, H, W, []
    for i, n_layers in enumerate(b2d["LAYER_NUMS"]):
        f, s = int(b2d["NUM_FILTERS"][i]), int(b2d["LAYER_STRIDES"][i])
        ho, wo = (h + 2 - 3) // s + 1, (w + 2 - 3) // s + 1
        for layer in [(cin, f, 3, h, w)] + [(f, f, 3, ho, wo)] * int(n_layers):
            fl, by = _conv2d(B, layer[0], layer[1], ho, wo, layer[2], layer[3], layer[4])
            bev_flops, bev_bytes = bev_flops + fl, bev_bytes + by
        u, fu = int(b2d["UPSAMPLE_STRIDES"][i]), int(b2d["NUM_UPSAMPLE_FILTERS"][i])
        # a transposed conv of kernel = stride u: each output reads one input pixel
        fl, by = _conv2d(B, f, fu, ho * u, wo * u, 1, ho, wo)
        if u > 1:
            by += TRAIN * f * fu * (u * u - 1) * F32  # its u x u kernel
        bev_flops, bev_bytes = bev_flops + fl, bev_bytes + by
        ups.append((fu, ho * u, wo * u))
        cin, h, w = f, ho, wo
    parts["bev2d"] = bev_flops
    c2d = sum(u[0] for u in ups)
    h2, w2 = ups[0][1], ups[0][2]

    # dense head
    head = model["DENSE_HEAD"]
    if head["NAME"] == "CenterHead":
        fl = _conv2d(B, c2d, CENTER_SHARED, h2, w2, 3, h2, w2)[0]
        fl += _conv2d(B, CENTER_SHARED, n_cls + sum(CENTER_OUTS), h2, w2, 3, h2, w2)[0]
    elif head["NAME"] == "AnchorHeadSingle":
        anchors = sum(len(a["anchor_sizes"]) * len(a["anchor_rotations"])
                      * len(a["anchor_bottom_heights"]) for a in head["ANCHOR_GENERATOR_CONFIG"])
        fl = _conv2d(B, c2d, anchors * (n_cls + 7 + 2), h2, w2, 1, h2, w2)[0]
    else:
        raise KeyError(head["NAME"])
    parts["dense_head"] = fl

    # PV-RCNN's keypoint branch and RoI head
    if "PFE" in model:
        k = B * int(model["PFE"]["NUM_KEYPOINTS"])
        rows = k * PFE_NSAMPLE
        groups = [(n_feat - 3, (16, 16)), (c[3], (32, 32)), (c[4], (32, 32))]
        fl, width = 0, bev_c
        for cin_g, mlp in groups:
            ci = 3 + cin_g
            for co in mlp:
                fl += _linear(rows, ci, co)
                ci = co
            width += mlp[-1]
        fl += _linear(k, width, PFE_OUT)
        parts["pfe"] = fl
    if "ROI_HEAD" in model:
        r = B * int(model["ROI_HEAD"].get("NMS_POST_MAXSIZE", 128))
        g3 = int(model["ROI_HEAD"].get("GRID_SIZE", 6)) ** 3
        fl = _linear(r * g3 * ROI_NSAMPLE, 3 + PFE_OUT, ROI_MLP)
        ci = ROI_MLP * g3
        for co in ROI_FC:
            fl += _linear(r, ci, co)
            ci = co
        fl += _linear(r, ci, 1 + 7)
        parts["roi_head"] = fl

    return dict(flops=sum(parts.values()), bev_flops=bev_flops, bev_bytes=bev_bytes,
                parts=parts, voxels_per_sample=per_sample,
                voxels_kept=min(cap, sum(per_sample)))

