"""Host <-> device transfers.

Counterpart of c_orb_slam_tpu/utils/host.py. ``fetch`` copies tensors to
numpy (one ``.cpu()`` each: the first waits for the stream, the rest are
plain copies). ``fetch_async`` starts non-blocking copies into pinned host
tensors and records a CUDA event; its future is done when the event is.
Every pipelined stage (tracking, mapping, loop closing) reads its future
with ``result()`` at a fixed point of its schedule, never when ``done()``
first says so: the device is done when the host ends its enqueue, so the
wait costs almost nothing.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        # Copy: a CPU tensor's .numpy() would alias storage that device
        # code may later update in place (slam_map/devicemap.py).
        return x.detach().cpu().numpy().copy()
    return x


def fetch(*arrays):
    """Device -> host copy of all given tensors; numpy arrays (or the
    non-tensor arguments unchanged), one per argument."""
    out = tuple(_to_numpy(a) for a in arrays)
    return out if len(arrays) != 1 else out[0]


class Fetch:
    """Result of fetch_async: ``done()`` polls, ``result()`` waits and
    returns exactly what ``fetch(*arrays)`` would."""

    def __init__(self, arrays):
        self._event = None
        self._host = []
        for a in arrays:
            if isinstance(a, torch.Tensor) and a.is_cuda:
                h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                h.copy_(a.detach(), non_blocking=True)
                self._host.append(h)
            else:  # CPU: snapshot now, as the copy on the card would
                self._host.append(_to_numpy(a))
        if any(isinstance(a, torch.Tensor) and a.is_cuda for a in arrays):
            self._event = torch.cuda.Event()
            self._event.record()

    def done(self) -> bool:
        return self._event is None or self._event.query()

    def result(self):
        if self._event is not None:
            self._event.synchronize()
        return fetch(*self._host)


def fetch_async(*arrays) -> Fetch:
    """Start a device -> host copy of `arrays` on the current stream; read
    it with ``.result()`` at apply time (usually already landed)."""
    return Fetch(arrays)


def to_device(device: torch.device, *arrays):
    """Host numpy arrays (or scalars) -> tensors on `device`, one per
    argument; uint32 descriptor words keep their bit pattern as int32."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return tuple(out) if len(out) != 1 else out[0]
