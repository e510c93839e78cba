"""Ranks of a client mesh: one process a rank under `torch.distributed`.

The vectorized engine on a client mesh (`FleetConfig.mesh`) runs the same
program in every rank. Two ways to start the ranks:

  - under `torchrun --nproc-per-node W ...`, which sets RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT: `init_from_env(backend)`;
  - from one Python process: `spawn(fn, W, backend, *args)` starts W
    processes (the `spawn` start method, which CUDA needs), joins them in
    one group through a `file://` rendezvous in a fresh temporary
    directory, so that groups started side by side never meet, and calls
    `fn(rank, W, *args)` in each.

NCCL puts rank r on CUDA device r mod the device count; it refuses two
ranks on one device, so ranks that share a card take gloo, whose
collectives go through host memory. Every rank calls
`torch.set_num_threads(1)` when it runs on the CPU (`cpu_threads`), since W
ranks' intra-op pools would otherwise contend for the same cores. Nothing
here falls back to a single process: a rank that fails raises in the
caller of `spawn`.

Ranks sharing a card over gloo: gloo's own collectives take CUDA tensors,
but the functional collectives through which DTensor redistributes
(`torch.ops._c10d_functional`) crashed the process on CUDA tensors over
gloo (PyTorch 2.11 on the H100). `stage_functional_collectives()` gives
their CUDA kernels a named host-staged form: copy to host memory, the same
collective over gloo on the CPU, copy back. It is installed only by a
program whose ranks share a card over gloo, and `STAGED` counts its calls.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import torch
import torch.distributed as dist


def init(rank: int, world: int, backend: str, init_method: str) -> None:
    """Join the default process group as `rank` of `world`; under NCCL
    first take CUDA device rank mod the device count."""
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)


def init_from_env(backend: str = "gloo") -> int:
    """Join the group that `torchrun` describes in the environment; -> this
    process's rank."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    init(rank, world, backend, "env://")
    return rank


def under_launcher() -> bool:
    """Whether a launcher (torchrun) started this process as one rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def cpu_threads() -> None:
    """One intra-op thread: W ranks share the host's cores."""
    torch.set_num_threads(1)


# Calls of each host-staged functional collective (see the module's
# docstring), by op name.
STAGED = {}
_STAGED_LIB = []
_STAGED_OPS = ("all_reduce", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single", "broadcast")


def stage_functional_collectives() -> None:
    """Run the CUDA kernels of `torch.ops._c10d_functional`'s all_reduce,
    all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single and
    broadcast through host memory: the input copied to the CPU, the CPU
    kernel (gloo), the result copied back to the input's device. For ranks
    that share a card over gloo; NCCL ranks never call it. Idempotent."""
    if _STAGED_LIB:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    fc = torch.ops._c10d_functional

    def staged(name):
        op = getattr(fc, name)

        def impl(x, *args):
            STAGED[name] = STAGED.get(name, 0) + 1
            out = fc.wait_tensor(op(x.detach().cpu(), *args))
            return out.to(x.device)
        return impl

    for name in _STAGED_OPS:
        lib.impl(name, staged(name), "CUDA")
    _STAGED_LIB.append(lib)


def _rank_main(rank, world, backend, init_method, fn, args):
    init(rank, world, backend, init_method)
    try:
        fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str, *args) -> None:
    """Run `fn(rank, world, *args)` in `world` new processes joined in one
    process group of `backend`; returns when all have finished, raises if
    any failed. `fn` and `args` must pickle (a module-level function)."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="ranks-")
    try:
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(world, backend, f"file://{tmp}/rendezvous", fn, args))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
