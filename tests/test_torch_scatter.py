"""The backend's assembly scatter, ``solver/problem.py:scatter_sum``: on the
CPU it equals ``index_add`` bit for bit and batches under vmap; on the card
(marked ``cuda``, skipped without one) it gives the same bits on every
call, where ``index_add``'s atomics do not, so a replay on the card is
repeatable. This file imports no jax, so the card's machine runs it:
``python3 -m pytest tests/test_torch_scatter.py -m cuda``."""

import numpy as np
import pytest
import torch

from ic_gvins_tpu_torch.solver import problem as tprob


def _scatter_rows(n_rows, n_targets, seed=5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, n_targets, (n_rows,), generator=g),
            torch.randn(n_rows, 6, 6, generator=g, dtype=torch.float64))


def test_scatter_sum_equals_index_add_and_batches():
    """The assembly's scatter adds each target's rows in row order on the
    CPU, bit for bit as ``index_add`` and a serial loop do, and batches
    under ``over_problems``' vmap."""
    idx, vals = _scatter_rows(3000, 7)
    out = tprob.scatter_sum(vals.new_zeros((7, 6, 6)), idx, vals)
    serial = torch.zeros(7, 6, 6, dtype=torch.float64)
    for i in range(len(idx)):
        serial[idx[i]] += vals[i]
    assert torch.equal(out, serial)
    onto = tprob.scatter_sum(serial, idx, vals)          # out of place, onto what is there
    assert torch.equal(onto, serial.index_add(0, idx, vals)) and not torch.equal(onto, serial)
    batched = torch.func.vmap(lambda i, v: tprob.scatter_sum(v.new_zeros((7, 6, 6)), i, v))(
        idx.reshape(2, -1), vals.reshape(2, -1, 6, 6))
    for b in range(2):
        assert torch.equal(batched[b], tprob.scatter_sum(vals.new_zeros((7, 6, 6)), idx.reshape(2, -1)[b],
                                                         vals.reshape(2, -1, 6, 6)[b]))


@pytest.mark.cuda
def test_scatter_sum_is_repeatable_on_the_card():
    """On the card ``index_add`` adds by atomics, in an order that changes
    from call to call; ``scatter_sum`` gives the same bits every call and
    agrees with the CPU's sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx, vals = _scatter_rows(1 << 18, 16)
    i, v = idx.cuda(), vals.cuda()
    runs = [tprob.scatter_sum(v.new_zeros((16, 6, 6)), i, v).cpu() for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    np.testing.assert_allclose(runs[0].numpy(), torch.zeros(16, 6, 6, dtype=torch.float64).index_add(0, idx, vals)
                               .numpy(), rtol=0, atol=1e-9)
