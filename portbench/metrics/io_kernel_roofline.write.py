"""Share of the HBM roofline that the port's I/O kernels reach in a
collective write: the least time their calls could take, bytes over the
card's bandwidth, summed over every call of the window, over the
profiler's device time of the same kernels by name.

The bytes are counted at the ``kernels.ops`` call from its arguments, so
they are the same whatever implements the call: each input read once
and each output written once. They are counted on one write made after
the traced window (``Tracer.observing``), since the counting launches
reductions of its own. Where the work depends on the data, the
count takes what these inputs need: ``coalesce`` reads only the live
(non-padding) entries of its offset-sorted rows, and the drain reads
only the payload its requests cover. The outputs are whole rows, since
the call returns them padded.
"""
import torch

UNIT = "%"
MOVES = "write_GBps"
WRAPS = ("repro_torch.kernels.ops.sort_requests_with",
         "repro_torch.kernels.ops.coalesce",
         "repro_torch.kernels.ops.fused_drain_pack")
# device kernels of those calls (csrc/bitonic.cuh, coalesce_kernel.cu,
# pack_tiles.cuh)
KERNELS = ("sort_blocks_kernel", "sort_merge_kernel",
           "coalesce_cluster_kernel", "pack_tiles_kernel")
PAD_OFFSET = 2**31 - 1
I32 = 4


def sort_bytes(r, starts, *_, **__):
    """Offsets, lengths and starts in, the same three sorted out."""
    return 2 * 3 * r.offsets.numel() * I32


def coalesce_bytes(r, out):
    """The live offsets and lengths in; the runs and counts out."""
    live = (r.offsets != PAD_OFFSET).sum(dtype=torch.int64)
    return 2 * I32 * live + (2 * out.offsets.numel()
                             + out.count.numel()) * I32


def drain_bytes(r, starts, data, base, out_len, *_, **__):
    """Unsorted offsets, lengths and starts, the payload the requests
    cover and a base a row in; the window and its mask out."""
    rows = r.offsets.numel() // r.capacity
    covered = r.lengths.sum(dtype=torch.int64) * data.element_size()
    return (3 * r.offsets.numel() + rows) * I32 + covered \
        + 2 * rows * out_len * data.element_size()


def observe(target, args, kwargs, out, state):
    name = target.rpartition(".")[2]
    if name == "coalesce":
        b = coalesce_bytes(*args, out, **kwargs)
    elif name == "sort_requests_with":
        b = sort_bytes(*args, **kwargs)
    else:
        b = drain_bytes(*args, **kwargs)
    state.setdefault("bytes", []).append(b)


def read(trace):
    """``observe`` saw one write after the window; every write of the
    window moves the same bytes, since the inputs fix them."""
    if trace.device is None or any(trace.span_ms(t) is None for t in WRAPS):
        return None
    moved = trace.steps * sum(int(b) for b in trace.state.get("bytes", []))
    busy = sum(s for name, s in trace.device.kernel_s.items()
               if any(k in name for k in KERNELS))
    if not moved or not busy:
        return None
    return 100.0 * moved / trace.peaks["hbm_bytes_per_s"] / busy
