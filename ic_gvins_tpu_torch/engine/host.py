"""Device -> host reads of the replay loop, counted.

Every value the host needs from the device on the replay path (a solver's
``done`` flag, a preintegration summary, a chunk of trajectory samples)
comes through :func:`fetch`: one transfer for all the tensors a caller
needs at that point, and ``fetch.reads`` counts the transfers, as the
kernel wrappers count their launches. On the card each read is a
synchronization of the host with the device.
"""

import numpy as np
import torch


def fetch(*tensors):
    """numpy float64 copies of ``tensors`` in one device -> host transfer.
    The arrays own their memory: writing to them never reaches a tensor."""
    fetch.reads += 1
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, o = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[o:o + n].reshape(tuple(t.shape)))
        o += n
    return tuple(out)


fetch.reads = 0


def upload(arrays, device):
    """float64 tensors on ``device`` from numpy arrays in one host -> device
    copy (``torch.tensor`` copies: the tensors never alias the host arrays,
    which the estimator mutates in place: a device read racing an in-place
    shift of a mirror was the JAX package's worst fault,
    ic_gvins_tpu/engine/estimator.py:465-471)."""
    arrays = [np.asarray(a, np.float64) for a in arrays]
    flat = torch.tensor(np.concatenate([a.reshape(-1) for a in arrays]), device=device)
    out, o = [], 0
    for a in arrays:
        out.append(flat[o:o + a.size].reshape(a.shape))
        o += a.size
    return out
