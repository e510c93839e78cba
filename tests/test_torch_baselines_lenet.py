"""fd and fedavg with the paper's LeNet clients: the port's two engines
against the reference's, as tests/test_torch_baselines.py holds the MLP
fleet (its helpers from tests/test_torch_relay_policies.py).

Held at tests/test_torch_vec_collab.py's LeNet bounds, every pair: weights
5e-3, observations, prototypes and mean logits 2e-2, grad_norm rtol 1e-2;
ring integers and ledger exactly. The reason is that file's: a 2 x 2
max-pool window whose two largest values are equal up to rounding routes
its gradient by that rounding, and Adam's first steps turn the moved
gradient into moved weights. Here it shows between the port's and the
reference's sequential engines too, not only under the vectorized
engine's grouped convolutions: in fd, client 0's second local step meets
one such window in conv2's pooling (the two largest values within 1e-6 of
each other); from the same weights the two packages' conv gradients then
differ by 4.4e-3 while fc1's agree to 7e-8, and after two rounds the
weights are 5.4e-4 and the observations 1.1e-3 apart.
"""
import pytest

from test_torch_relay_policies import build_four, run_and_compare

LENET = {"weights": 5e-3, "relay": 2e-2, "grad_rtol": 1e-2}


@pytest.mark.parametrize("mode", ["fd", "fedavg"])
def test_lenet_baselines_match_reference(mode):
    run_and_compare(build_four("flat", mode, kind="cnn"), kind="cnn",
                    tol=LENET)
