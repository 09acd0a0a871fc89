"""JAX-side stage configs -> the port's explicit configs.

The extraction pipeline has no learned parameters; what carries across
from the JAX package is its configuration, including three defaults that
the JAX modules read from the environment at import time:

  PCSEQ_ANGLE_VELO_EXEMPT (default 0.05)  -> tracking ANGLE_VELO_EXEMPT
  PCSEQ_FINE_CANDIDATES   (default 256)   -> tracking FINE_CANDIDATES
  PCSEQ_CELL_CAP          (default 48)    -> tracking CELL_CAP: the hash
      grid's per-probe scan cap (``hash_graph.DEFAULT_CELL_CAP``), used by
      the registration correspondences and the host and device walks'
      member extraction. (bench.py's 24 is a different cap, that of the CPU
      kNN-graph CC, which the port does not have.)

``config_from_jax`` copies a stage config and writes those values as
explicit keys (a key already in the config wins), so both packages can be
pinned to the same settings.
"""

from __future__ import annotations

import os

from .utils.edict import EDict


def config_from_jax(cfg, env=os.environ):
    """Explicit port config for one stage config (ground removal, proposal
    or tracking) under the environment ``env``."""
    out = EDict(cfg)
    if "REGISTRATION" in out:  # the tracking stage
        out.setdefault("ANGLE_VELO_EXEMPT", float(env.get("PCSEQ_ANGLE_VELO_EXEMPT", 0.05)))
        out.setdefault("FINE_CANDIDATES", int(env.get("PCSEQ_FINE_CANDIDATES", 256)))
        out.setdefault("CELL_CAP", int(env.get("PCSEQ_CELL_CAP", 48)))
    return out
