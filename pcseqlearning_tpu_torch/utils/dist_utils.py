"""Process groups, collectives and result merging (counterpart of
pcseqlearning_tpu.utils.dist_utils).

``init_distributed`` takes the place of ``jax.distributed.initialize``: the
world comes from explicit arguments or from torchrun's environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK), and at world size 1 no
group is made. The collectives below take a process group (default: the
default group); without a process group they return at once (a group of
one rank still runs them, so its backend's path is exercised). Under the
gloo backend a
CUDA tensor is staged through the host (copied to the CPU, reduced there and
copied back), so gloo ranks may share one card; under nccl the tensor stays
on its card. ``merge_results_dist`` is the rank-0 file merge of per-rank
Python results. ``launch_ranks`` runs a function in K spawned processes
that share a FileStore, for a single-host run without torchrun.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def local_rank():
    """This process's card index on its host (torchrun's LOCAL_RANK, else 0)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def get_dist_info(group=None):
    """(rank, world size) in ``group``; (0, 1) without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def init_distributed(address=None, world_size=None, rank=None, backend=None, device="cuda"):
    """Join the default process group; returns (rank, world size).

    Explicit arguments win over torchrun's environment (WORLD_SIZE, RANK,
    and ``tcp://MASTER_ADDR:MASTER_PORT``); ``address`` is any init method
    torch takes (``tcp://host:port``, ``file:///path``). At world size 1 it
    makes no group and returns (0, 1). When a default group exists it
    returns that group's rank and size. The backend is nccl for ``device``
    "cuda" and gloo for "cpu" unless one is given; a CUDA rank binds
    ``cuda:LOCAL_RANK`` and raises when that card is not there."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return 0, 1
    dev = resolve_device(device)
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if address is None:
        address = "tcp://%s:%s" % (os.environ.get("MASTER_ADDR", "localhost"),
                                   os.environ.get("MASTER_PORT", "29500"))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if local_rank() >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local_rank()} but only "
                               f"{torch.cuda.device_count()} CUDA devices are visible")
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=address, world_size=world_size, rank=rank)
    return dist.get_rank(), dist.get_world_size()


def _no_group():
    return not (dist.is_available() and dist.is_initialized())


def _staged(tensor, group):
    """Whether ``tensor`` goes through the host for a collective of ``group``."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(tensor, op=dist.ReduceOp.SUM, group=None):
    """In-place all-reduce of ``tensor`` over ``group``; returns it."""
    if _no_group():
        return tensor
    if _staged(tensor, group):
        host = tensor.cpu()
        dist.all_reduce(host, op=op, group=group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, op=op, group=group)
    return tensor


def broadcast(tensor, src=0, group=None):
    """In-place broadcast of ``tensor`` from rank ``src``; returns it."""
    if _no_group():
        return tensor
    if _staged(tensor, group):
        host = tensor.cpu()
        dist.broadcast(host, src=src, group=group)
        tensor.copy_(host)
    else:
        dist.broadcast(tensor, src=src, group=group)
    return tensor


def all_gather(tensor, group=None):
    """[world] list of every rank's ``tensor`` (equal shapes), on its device."""
    if _no_group():
        return [tensor]
    world = get_dist_info(group)[1]
    src = tensor.cpu() if _staged(tensor, group) else tensor.contiguous()
    out = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(out, src, group=group)
    return [o.to(tensor.device) for o in out]


def barrier(group=None):
    if not _no_group():
        dist.barrier(group=group)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _rebuild(tree, values, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, prefix + (k,)) for k, v in tree.items()}
    return values[prefix]


def all_gather_arrays(tree, group=None):
    """Every rank's ``tree`` (nested dicts of equally shaped arrays,
    tensors or scalars) as a list in rank order; ``[tree]`` in one process.
    Tensors come back as tensors on their device, the rest as NumPy."""
    rank_world = get_dist_info(group)
    if rank_world[1] == 1:
        return [tree]
    per_rank = [{} for _ in range(rank_world[1])]
    for path, leaf in _leaves(tree):
        t = leaf if torch.is_tensor(leaf) else torch.as_tensor(np.asarray(leaf))
        for r, g in enumerate(all_gather(t, group)):
            per_rank[r][path] = g if torch.is_tensor(leaf) else g.numpy()
    return [_rebuild(tree, v) for v in per_rank]


def average_reduce_value(value, group=None):
    """Mean of a host scalar over the ranks."""
    world = get_dist_info(group)[1]
    if world == 1:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64)
    all_reduce(t, group=group)
    return float(t[0]) / world


def merge_results_dist(part_results, size, tmpdir=None):
    """Rank 0's merge of every rank's list of results: each rank pickles
    its part to ``tmpdir`` (a directory all ranks see), a barrier, then rank
    0 loads the parts, interleaves them in rank-strided dataset order and
    truncates to ``size``; other ranks return None. In one process: the
    first ``size`` results."""
    rank, world = get_dist_info()
    if world == 1:
        return part_results[:size]
    tmpdir = tmpdir or os.path.join(tempfile.gettempdir(), "pcseq_dist_merge")
    os.makedirs(tmpdir, exist_ok=True)
    with open(os.path.join(tmpdir, f"result_part_{rank}.pkl"), "wb") as f:
        pickle.dump(part_results, f)
    barrier()
    if rank != 0:
        return None
    merged = []
    for r in range(world):
        path = os.path.join(tmpdir, f"result_part_{r}.pkl")
        for _ in range(100):
            if os.path.exists(path):
                break
            time.sleep(0.1)
        with open(path, "rb") as f:
            merged.append(pickle.load(f))
    ordered = []
    for i in range(max(len(m) for m in merged)):
        for r in range(world):
            if i < len(merged[r]):
                ordered.append(merged[r][i])
    return ordered[:size]


def _rank_main(fn, rank, world_size, store_dir, backend, args):
    init_distributed(address="file://" + os.path.join(store_dir, "store"),
                     world_size=world_size, rank=rank, backend=backend,
                     device="cuda" if backend == "nccl" else "cpu")
    try:
        out = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(store_dir, f"rank{rank}.pt"))


def launch_ranks(fn, world_size, store_dir, args=(), backend="gloo", timeout=120.0, env=None):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one process group through a FileStore under
    ``store_dir`` (which must not hold an earlier store); returns their
    results (``torch.save``-able) in rank order. ``fn`` and ``args`` must
    pickle (``fn`` a module-level function). ``env`` sets environment
    variables in the children (LOCAL_RANK, for ranks that share a card).
    A rank still running after ``timeout`` seconds is terminated, with all
    others, and the call raises; so does a rank that exits with an error."""
    os.makedirs(store_dir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, store_dir, backend, tuple(args)))
                 for r in range(world_size)]
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.time(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} still running after {timeout} s")
        failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"ranks exited with errors (rank, exit code): {failed}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
                if p.is_alive():
                    p.kill()
    return [torch.load(os.path.join(store_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world_size)]
