"""The host layer of checkpoint I/O: the in-process host executor and
the multi-process transport behind :class:`HostCollectiveIO`."""
from repro_torch.checkpoint.host_io import (  # noqa: F401
    HostCollectiveIO, IOTimings, resolve_knobs,
)
