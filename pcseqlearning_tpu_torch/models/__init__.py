"""Model registry (counterpart of pcseqlearning_tpu.models): ``build_network``
dispatches on MODEL.NAME. The port has the extraction pipeline's entry model,
``SimpleReg``, and the detectors CenterPoint (SST-CenterPoint is CenterPoint
with the SST backbone), SECONDNet, SECONDNetIoU, PointPillar, VoxelRCNN,
PartA2Net, PVRCNN, PVRCNNPlusPlus, PVRCNNPlusPlusCoTrain, PointRCNN and
CaDDN: every config of tools/cfgs/waymo_models. Another name raises
KeyError."""

from __future__ import annotations

DETECTORS = ("CenterPoint", "SECONDNet", "SECONDNetIoU", "PointPillar", "VoxelRCNN",
             "PartA2Net", "PVRCNN", "PVRCNNPlusPlus", "PVRCNNPlusPlusCoTrain", "PointRCNN",
             "CaDDN")


def build_network(model_cfg, runtime_cfg=None, dataset=None, device="cuda"):
    """The model of MODEL.NAME on ``device``. A detector takes its geometry
    from ``runtime_cfg`` (``data_cfg``, ``class_names``, ``voxel_cap``, as the
    JAX ``build_detector`` does) and the VFE's width from ``dataset``'s point
    feature encoding when a dataset is given."""
    from .detectors import build_detector

    name = model_cfg["NAME"]
    if name == "SimpleReg":
        from ..preprocessing import SimpleReg

        return SimpleReg(model_cfg, runtime_cfg, dataset, device=device)
    if name in DETECTORS:
        runtime_cfg = dict(runtime_cfg or {})
        if dataset is not None:
            runtime_cfg.setdefault("num_point_features",
                                   dataset.point_feature_encoder.num_point_features)
        return build_detector(model_cfg, runtime_cfg, device=device)
    raise KeyError(name)
