"""The extraction pipeline: ground removal -> multi-radius cluster proposal
-> cluster tracking, driven per sequence by SimpleReg; ``PREPROCESSORS``
maps the config NAMEs to the stages."""

from .cluster_proposal import ClusterProposal  # noqa: F401
from .cluster_tracking import ClusterTracking  # noqa: F401
from .ground_removal import GroundPlaneRemover  # noqa: F401
from .simple_reg import SimpleReg  # noqa: F401

PREPROCESSORS = {
    "GroundPlaneRemover": GroundPlaneRemover,
    "ClusterProposal": ClusterProposal,
    "ClusterTracking": ClusterTracking,
}
