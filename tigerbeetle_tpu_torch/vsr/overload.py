"""The one function of ``tigerbeetle_tpu/vsr/overload.py`` the commit
pipeline reads (``TorchStateMachine.fuse_batches``), copied; the rest of
that module (admission, the fusion planner) belongs to the serving slice
and imports the wire format."""

from __future__ import annotations

import os
from typing import Optional


def fusion_enabled(env: Optional[dict] = None) -> bool:
    """TB_FUSE gate ('' / '0' / 'off' all mean off; the CLI's
    --fuse-batches sets it).  Off is bit-identical: no signature is ever
    computed and every run dispatches exactly as before."""
    value = (env if env is not None else os.environ).get("TB_FUSE", "")
    return str(value).strip().lower() not in ("", "0", "off", "false")
