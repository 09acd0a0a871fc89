"""The port's process-group plumbing, ``utils.dist_utils``, against the JAX
package's multi-host tests (tests/test_multichip.py): the rank-0 result
merge with the ranks monkeypatched, the single-process fast paths, and a
real run of two gloo ranks (spawned processes joined through a FileStore
under the test's tmp_path, so no TCP port is shared between test workers)
for the gathers, the mean, an all-reduce sum (the counterpart of JAX's
in-mesh psum of eval counts), a broadcast and the merge behind a real
barrier. Also: ``init_distributed`` makes no group at world size 1, a
CUDA rank raises without a card, and ``launch_ranks`` ends a hung rank.

No tolerance: every value is an integer or a sum of two exact floats.
This file imports no JAX, so the spawned ranks (which import it) do not.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pcseqlearning_tpu_torch.utils import dist_utils

torch.set_num_threads(1)


def test_merge_results_dist_multirank_order_and_truncation(tmp_path, monkeypatch):
    """Three ranks write their loader shards; rank 0 reassembles them in
    rank-strided dataset order and cuts the sampler's padding (JAX's
    test, with the ranks and the barrier monkeypatched)."""
    world = 3
    parts = {0: [0, 3, 6], 1: [1, 4, 7], 2: [2, 5, 7]}
    monkeypatch.setattr(dist_utils, "barrier", lambda group=None: None)
    for rank in range(1, world):
        monkeypatch.setattr(dist_utils, "get_dist_info", lambda group=None, r=rank: (r, world))
        assert dist_utils.merge_results_dist(parts[rank], size=8, tmpdir=str(tmp_path)) is None
    monkeypatch.setattr(dist_utils, "get_dist_info", lambda group=None: (0, world))
    merged = dist_utils.merge_results_dist(parts[0], size=8, tmpdir=str(tmp_path))
    assert merged == [0, 1, 2, 3, 4, 5, 6, 7]


def test_all_gather_arrays_and_average_reduce_single_process():
    tree = {"a": np.arange(4), "b": np.float32(2.5)}
    out = dist_utils.all_gather_arrays(tree)
    assert len(out) == 1
    np.testing.assert_array_equal(np.asarray(out[0]["a"]), np.arange(4))
    assert dist_utils.average_reduce_value(3.25) == 3.25
    assert dist_utils.get_dist_info() == (0, 1)
    assert dist_utils.merge_results_dist([1, 2, 3], size=2) == [1, 2]
    t = torch.arange(3.0)
    assert dist_utils.all_reduce(t) is t and torch.equal(t, torch.arange(3.0))


def _two_rank_worker(rank, world, merge_dir):
    tree = {"a": torch.arange(4) + 10 * rank, "b": {"c": np.float32(rank + 0.5)}}
    gathered = dist_utils.all_gather_arrays(tree)
    mean = dist_utils.average_reduce_value(rank + 1.5)
    tp = torch.arange(32, dtype=torch.float32)[rank * 16:(rank + 1) * 16]
    total = dist_utils.all_reduce(tp.sum().reshape(1))
    src = torch.full((3,), float(rank + 7))
    dist_utils.broadcast(src, 0)
    # a rank-strided eval shard of a 7-sample dataset, padded to 4 per rank
    merged = dist_utils.merge_results_dist(list(range(rank, 8, world)), size=7, tmpdir=merge_dir)
    return dict(gathered=gathered, mean=mean, total=float(total), broadcast=src,
                merged=merged, info=dist_utils.get_dist_info())


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("two_ranks")
    return dist_utils.launch_ranks(_two_rank_worker, 2, str(root / "store"),
                                   args=(str(root / "merge"),), timeout=60)


def test_two_ranks_all_gather_arrays(two_ranks):
    for r in range(2):
        g = two_ranks[r]["gathered"]
        assert len(g) == 2
        for s in range(2):
            assert torch.equal(g[s]["a"], torch.arange(4) + 10 * s)
            assert g[s]["b"]["c"] == np.float32(s + 0.5)


def test_two_ranks_average_all_reduce_and_broadcast(two_ranks):
    for r in range(2):
        assert two_ranks[r]["info"] == (r, 2)
        assert two_ranks[r]["mean"] == 2.0
        assert two_ranks[r]["total"] == float(np.arange(32).sum())
        assert torch.equal(two_ranks[r]["broadcast"], torch.full((3,), 7.0))


def test_two_ranks_merge_results_behind_a_barrier(two_ranks):
    assert two_ranks[0]["merged"] == list(range(7))
    assert two_ranks[1]["merged"] is None


def test_init_distributed_world_size_one_makes_no_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert dist_utils.init_distributed() == (0, 1)
    assert dist_utils.init_distributed(world_size=1, rank=0, device="cpu") == (0, 1)
    assert not dist.is_initialized()


def test_init_distributed_on_cuda_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        dist_utils.init_distributed(address=f"file://{tmp_path}/store", world_size=2, rank=0)
    assert not dist.is_initialized()


def _hang(rank, world):
    if rank == 1:
        time.sleep(120)
    return rank


def test_launch_ranks_ends_a_hung_rank(tmp_path):
    """The hung rank 1 is named and both are ended. Whether the healthy rank
    0 is still starting when the 8 s run out depends on the machine's load
    (in a six-worker test run it can be), so it may be named too."""
    t0 = time.time()
    with pytest.raises(TimeoutError, match=r"ranks \[(0, )?1\] still running"):
        dist_utils.launch_ranks(_hang, 2, str(tmp_path / "store"), timeout=8)
    assert time.time() - t0 < 60
