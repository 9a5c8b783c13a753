"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch

# force_virtual's settings by device type: (n logical devices, the device
# they lie on).
_VIRTUAL: Dict[str, Tuple[int, torch.device]] = {}


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  With no card and no explicit device this raises: the port never
    carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def physical(device: torch.device) -> torch.device:
    """``device`` with its index made explicit (``cuda`` is the current
    card), so that two names of one card compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def force_virtual(n: int, device: Union[str, torch.device] = "cuda") -> None:
    """Make ``devices(device)`` answer ``n`` logical devices over the one
    ``device`` (the counterpart of the JAX package's
    ``jaxenv.force_cpu(n)``): a mesh of n shards then holds every shard's
    tables on that device.  ``n`` 0 undoes it for that device's type."""
    dev = torch.device(device)
    if n:
        _VIRTUAL[dev.type] = (int(n), physical(dev))
    else:
        _VIRTUAL.pop(dev.type, None)


def devices(device: Optional[Union[str, torch.device]] = None
            ) -> List[torch.device]:
    """The devices a mesh may use, in order (the counterpart of
    ``jax.devices()``): after ``force_virtual(n, d)`` for ``device``'s
    type, n times ``d``; otherwise every visible card
    for a CUDA device (``cuda`` when None), or the one device named."""
    dev = resolve(device)
    if dev.type in _VIRTUAL:
        n, on = _VIRTUAL[dev.type]
        return [on] * n
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]
