"""Placing and starting the ranks of a run on a mesh.

    placement(device)        this rank's device and backend, the one rule
                             every caller uses (`init_from_env`,
                             `make_mesh`, `run_ranks`)
    init_from_env(device)    join the process group torchrun describes
                             (RANK, WORLD_SIZE, LOCAL_RANK,
                             LOCAL_WORLD_SIZE, MASTER_ADDR / MASTER_PORT);
                             the training CLI's --mesh
    run_ranks(fn, n, ...)    spawn n ranks on this host, each joined to a
                             fresh process group, and return fn's results

NCCL runs when every rank of the host has a card of its own, gloo on the
CPU or when ranks share a card (NCCL refuses two ranks on one device;
gloo runs the all-reduce and the broadcast on CUDA tensors by staging them
through the host).
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, List, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from music_fader_nets_tpu_torch import resolve_device


def placement(device=None) -> Tuple[torch.device, str]:
    """(device, backend) of this rank, from LOCAL_RANK / LOCAL_WORLD_SIZE
    (RANK / WORLD_SIZE when unset, else 0 / 1). The CPU over gloo for device="cpu". A card named
    by index ("cuda:0") is shared by every rank of the host, over gloo
    unless it is the only rank. Otherwise `cuda:LOCAL_RANK` over NCCL when
    the host has a card for each rank, and card 0, shared over gloo, when
    it has one card; a host with more than one card but fewer than its
    ranks raises RuntimeError rather than leave cards idle. RuntimeError
    without a card unless device="cpu"."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev, "gloo"
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", 1)))
    cards = torch.cuda.device_count()
    if dev.index is None and cards >= local_world:
        return torch.device("cuda", local), "nccl"
    if dev.index is None and cards > 1:
        raise RuntimeError(
            f"{local_world} ranks on a host with {cards} cards: start one "
            "rank per card, or name the card they share (device='cuda:0')")
    return (torch.device("cuda", dev.index or 0),
            "nccl" if local_world == 1 else "gloo")


def init_from_env(device=None) -> torch.device:
    """Join the default process group from the torchrun environment (a
    world of one, in this process, when RANK is not set) and return this
    rank's device (`placement`). A group that is already initialised is
    joined as it is."""
    dev, backend = placement(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if "RANK" in os.environ:
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev


def _rank_main(rank: int, fn, args, world: int, device, out_dir: str,
               timeout: float) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    dev, backend = placement(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(out_dir, 'rendezvous')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    path = os.path.join(out_dir, f"rank{rank}.pt")
    torch.save(result, path + ".tmp")
    os.replace(path + ".tmp", path)


def run_ranks(fn: Callable, world_size: int, args=(), device="cpu",
              timeout: float = 120.0) -> List:
    """`fn(*args)` in `world_size` spawned processes on this host (one CPU
    thread each), each a rank of a fresh default process group placed by
    `placement(device)` (RANK / WORLD_SIZE / LOCAL_RANK / LOCAL_WORLD_SIZE
    set, rendezvous through a file). Returns the ranks' results in rank
    order (each must be picklable); `fn` must be importable by name.
    Raises RuntimeError with the traceback of every rank that failed as
    soon as one fails (the others are terminated), and TimeoutError when
    the ranks are not done after `timeout` seconds (they are killed)."""
    out_dir = tempfile.mkdtemp(prefix="fader_ranks_")
    ctx = mp.start_processes(
        _rank_main, args=(fn, args, world_size, device, out_dir, timeout),
        nprocs=world_size, join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"ranks {[p.pid for p in ctx.processes if p.is_alive()]}"
                    f" of {world_size} still running after {timeout} s")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        # the first rank to fail is the one reported; a peer blocked in a
        # collective with it may have failed too: report every traceback
        traces = []
        for r, path in enumerate(ctx.error_files):
            if os.path.exists(path):
                with open(path, "rb") as f:
                    traces.append(f"rank {r} of {world_size} failed:\n"
                                  f"{pickle.load(f)}")
        raise RuntimeError("\n".join(traces) or str(e)) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        for path in ctx.error_files:
            if os.path.exists(path):
                os.remove(path)
        shutil.rmtree(out_dir, ignore_errors=True)
