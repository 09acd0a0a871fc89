"""JAX-side stage configs -> the port's explicit configs.

The extraction pipeline has no learned parameters; what carries across
from the JAX package is its configuration, including the settings that the
JAX modules take from the environment or the backend:

  PCSEQ_ANGLE_VELO_EXEMPT (default 0.05)  -> tracking ANGLE_VELO_EXEMPT
  PCSEQ_FINE_CANDIDATES   (default 256)   -> tracking FINE_CANDIDATES
  PCSEQ_CELL_CAP          (default 48)    -> tracking CELL_CAP: the hash
      grid's per-probe scan cap (``hash_graph.DEFAULT_CELL_CAP``), used by
      the registration correspondences and the host and device walks'
      member extraction
  PCSEQ_CELL_CAP          (default 24)    -> proposal CC_CELL_CAP: the cap
      of the kNN-graph CC (min(CELL_CAP, this), as the JAX module takes it)
  the JAX backend, PCSEQ_PALLAS, PCSEQ_PALLAS_SCAN -> proposal CC_GRAPH:
      the JAX module runs the radius-graph CC kernel ("radius") only on a
      TPU with neither variable set to 0 (``pallas_scan.use_pallas_scan``),
      and the kNN-graph CC ("knn") otherwise

``config_from_jax`` copies a stage config and writes those values as
explicit keys (a key already in the config wins), so both packages can be
pinned to the same settings and the same path.
"""

from __future__ import annotations

import os

from .utils.edict import EDict


def jax_cc_graph(env=os.environ, jax_backend="tpu"):
    """The proposal CC path the JAX package takes under ``env`` on
    ``jax_backend``."""
    if env.get("PCSEQ_PALLAS", "1") == "0" or env.get("PCSEQ_PALLAS_SCAN", "1") == "0":
        return "knn"
    return "radius" if jax_backend == "tpu" else "knn"


def config_from_jax(cfg, env=os.environ, jax_backend="tpu"):
    """Explicit port config for one stage config (ground removal, proposal
    or tracking) under the environment ``env``, as the JAX package would
    run it on ``jax_backend`` (default "tpu", the backend whose kernels the
    port carries)."""
    out = EDict(cfg)
    if "REGISTRATION" in out:  # the tracking stage
        out.setdefault("ANGLE_VELO_EXEMPT", float(env.get("PCSEQ_ANGLE_VELO_EXEMPT", 0.05)))
        out.setdefault("FINE_CANDIDATES", int(env.get("PCSEQ_FINE_CANDIDATES", 256)))
        out.setdefault("CELL_CAP", int(env.get("PCSEQ_CELL_CAP", 48)))
    elif "GRAPH" in out:  # the proposal stage
        out.setdefault("CC_GRAPH", jax_cc_graph(env, jax_backend))
        cell_cap = int(out.get("CELL_CAP", env.get("PCSEQ_CELL_CAP", 48)))
        out.setdefault("CC_CELL_CAP", min(cell_cap, int(env.get("PCSEQ_CELL_CAP", 24))))
    return out
