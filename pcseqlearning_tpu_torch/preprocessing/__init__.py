"""The extraction pipeline: ground removal -> multi-radius cluster proposal
-> batched cluster tracking."""

from .cluster_proposal import ClusterProposal  # noqa: F401
from .cluster_tracking import ClusterTracking  # noqa: F401
from .ground_removal import GroundPlaneRemover  # noqa: F401
