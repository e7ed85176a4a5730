"""The port's example runs on the CPU at their quick sizes.

`ins_tpu_torch/examples/neural_closure_training.py`: ``run(quick=True,
device="cpu")`` reports finite errors and an a-priori error below the
untrained one, the conditions `tests/test_examples.py` asks of the JAX
package's example.
"""

import math

import numpy as np
import pytest
import torch

from ins_tpu_torch.examples import neural_closure_training


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: many small operations, which oversubscribed
    threads slow by orders of magnitude when the test lane runs several
    files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_neural_closure_training_quick():
    out = neural_closure_training.run(quick=True, device="cpu")
    assert all(math.isfinite(out[k]) for k in ("relerr_init", "relerr_prior", "loss_post"))
    assert out["relerr_prior"] < out["relerr_init"]
    assert set(out["seconds"]) == {"data", "prior", "post"}
    # 16² LES from a 64² DNS, snapshots every 4 steps of 0.05 / 1e-3
    assert out["io"]["u"].shape == out["io"]["c"].shape == (13, 16, 16, 2)
    assert np.all(np.isfinite(out["io"]["c"]))


def test_neural_closure_training_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        neural_closure_training.run(quick=True)
