"""PyTorch + CUDA port of the CoRS reproduction (`src/repro/` is the JAX
reference).

The package mirrors the reference's layout module for module
(`repro_torch/core/losses.py` <-> `repro/core/losses.py`, ...). It imports
torch and numpy only: nothing of `jax` and nothing of `repro`. Entry points
run on the CUDA device unless the caller passes `device="cpu"`; with no GPU
and no explicit "cpu" they raise (see `device.resolve_device`). The Pallas
kernels of the reference are hand-written CUDA kernels here
(`kernels/csrc/`), built at first use and dispatched by `kernels/ops.py`.
"""
