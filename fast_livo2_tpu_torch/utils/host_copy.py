"""Host copies of device tensors that land without a host sync.

A copy is a pair (host tensor, event or None): `host_copy` queues a device
tensor's copy to pinned memory and marks its landing with an event;
`host_value` reads it, waiting only if it has not landed yet;
`landed_copy` wraps a host array (a restored checkpoint's) as a copy that
has already landed.
"""

import numpy as np
import torch


def host_copy(t: torch.Tensor):
    """(host tensor, event or None): a copy of a device tensor queued to
    pinned memory, its landing marked by an event; on the CPU a clone."""
    if t.device.type != "cuda":
        return t.clone(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def host_value(copy) -> np.ndarray:
    """The numpy value of a copy, waiting for its event only if the copy
    has not landed yet (query() does not block)."""
    host, ev = copy
    if ev is not None and not ev.query():
        ev.synchronize()
    return host.numpy()


def landed_copy(array) -> tuple:
    """A host array as a copy that has landed."""
    return torch.from_numpy(np.asarray(array)), None
