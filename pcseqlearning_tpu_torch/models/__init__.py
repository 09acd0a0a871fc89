"""Model registry (counterpart of pcseqlearning_tpu.models): ``build_network``
dispatches on MODEL.NAME. The port has the extraction pipeline's entry model,
``SimpleReg``; the detectors are not ported yet."""

from __future__ import annotations


def build_network(model_cfg, runtime_cfg=None, dataset=None, device="cuda"):
    name = model_cfg["NAME"]
    if name == "SimpleReg":
        from ..preprocessing import SimpleReg

        return SimpleReg(model_cfg, runtime_cfg, dataset, device=device)
    raise NotImplementedError(f"build_network: the detector {name!r} is not ported yet "
                              "(ROADMAP.md §2, detector slice)")
