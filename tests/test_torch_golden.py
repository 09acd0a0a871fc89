"""Golden-sequence parity of the port, on the CPU (slow: ~12 min).

The port runs tools/parity_harness.py's scene and configs (12 frames x 20k
points) through its plain PyTorch kernels. Each stat must lie within its
GOLDEN tolerance of GOLDEN or of the JAX package's Pallas-path reference
(``pcseqlearning_tpu_torch.pipeline.PALLAS_PATH_REFERENCE``): GOLDEN was
pinned with kNN-graph CC and the XLA pair_min, while the port computes the
Pallas kernels' exact radius CC and direct-difference distances.
"""

import pytest

from pcseqlearning_tpu_torch import pipeline
from pcseqlearning_tpu_torch.scene import scene_dict


@pytest.mark.slow
def test_port_golden_stats_on_cpu():
    from test_golden_parity import GOLDEN

    d, _ = pipeline.run(scene_dict(12, 20_000, frame_id="parity_seq_000"),
                        pipeline.build_stages(pipeline.PARITY, device="cpu"))
    errs = pipeline.golden_errors(pipeline.parity_stats(d), GOLDEN)
    assert not errs, "; ".join(errs)


@pytest.mark.slow
def test_chip_smoke_cpu_rehearsal():
    """chip_smoke.py's phases on the CPU at a tiny size (~5 min): the
    script's own plumbing, checked without a card."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "chip_smoke.py", "--cpu-rehearsal"], cwd=repo,
                         capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "cpu rehearsal finished" in out.stdout
    assert '"ok": true' not in out.stdout
