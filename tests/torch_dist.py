"""torch.distributed helpers of the port's client-mesh tests on the CPU:
a one-rank gloo process group in this process."""
import contextlib
import shutil
import tempfile

import torch.distributed as dist

from repro_torch import sharding


@contextlib.contextmanager
def one_rank_mesh():
    """A one-rank client mesh over a gloo group of this process alone,
    reached through a `file://` rendezvous in a fresh temporary directory
    (so that test processes running side by side never share one). A group
    that is already up is reused and left up."""
    if dist.is_initialized():
        yield sharding.client_mesh(1)
        return
    tmp = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=0, world_size=1)
    try:
        yield sharding.client_mesh(1)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
