"""Slow-hop codec registry (port of ``repro.core.codec``).

The planner looks codecs up by name (``passes.effective_workload`` and
``resolve_codec``) and reads their modeling attributes (``lossless``,
``modeled_ratio``, ``jax_wire_overhead`` — the static wire width of one
encoded element, kept under the reference's name so the two registries
read alike). The host byte codecs (``encode_bytes`` / ``decode_bytes``)
are numpy and come along unchanged.

The tensor hooks are what the round engine (``core.rounds``) wraps
around the slow hop: ``init_state(shape, dtype, device)`` makes the
residual state (the empty tuple for stateless codecs),
``tensor_encode(data, state) -> (wire_parts, state)`` runs before the
node-axis exchange, ``tensor_decode(wire_parts) -> data`` after it.
Every wire part keeps the leading axes of ``data``; a per-row part
(``ef-int8``'s scale) drops only the last one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core._tensor import stable_partition_order

# Wire-format constants of the zero-run byte codec: a u32 raw-length
# header, then (u32 literal_len, u32 zero_len, literal bytes) records.
_HDR = np.dtype("<u4")
RLE_HEADER_BYTES = 4
RLE_RECORD_BYTES = 8
RLE_MIN_RUN = 16      # zero runs shorter than a record header stay literal


class Codec:
    """One slow-hop wire transform.

    name:      registry key (``IOPlan.slow_hop_codec`` value).
    lossless:  byte-exact round trip — the byte-identity harnesses run
               with these enabled; lossy codecs are rejected by the
               host write path (its payloads are raw bytes).
    stateful:  carries residual state through the round loop
               (``state`` argument of :meth:`tensor_encode`).

    The numpy hooks (:meth:`encode_bytes` / :meth:`decode_bytes`) move
    real bytes on the host; the tensor hooks (:meth:`tensor_encode` /
    :meth:`tensor_decode`) transform the static-shape payload buckets
    around the node-axis exchange.
    """

    name: str = "abstract"
    lossless: bool = True
    stateful: bool = False
    # static wire size of one encoded payload element, in units of the
    # payload element (static buffers cannot shrink, so the ring carries
    # this much per element regardless of achieved compression);
    # rounds.peak_aggregator_buffer_elems charges it
    jax_wire_overhead: float = 1.0

    # ---- host (numpy) side: real byte movement -----------------------
    def encode_bytes(self, buf: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def decode_bytes(self, wire: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # ---- tensor side: static-shape window transform ------------------
    def init_state(self, shape, dtype, device=None):
        """Residual state carried through the round loop (stateless
        codecs carry the empty tuple)."""
        return ()

    def tensor_encode(self, data: torch.Tensor, state):
        """``data [..., cap] -> (wire_parts tuple, new_state)``."""
        raise NotImplementedError

    def tensor_decode(self, parts) -> torch.Tensor:
        """Inverse of :meth:`tensor_encode`'s wire tuple."""
        raise NotImplementedError

    # ---- modeling ----------------------------------------------------
    def modeled_ratio(self, zero_fraction: float,
                      total_bytes: float) -> float:
        """Expected raw/wire ratio for a payload with the given zero
        fraction (drives the cost model's slow-hop discount and the
        ``"auto"`` codec resolution)."""
        return 1.0


class IdentityCodec(Codec):
    """Passthrough — the codec seam with zero transform (useful to
    measure the seam's own overhead and as the registry default)."""

    name = "identity"
    lossless = True

    def encode_bytes(self, buf):
        return np.asarray(buf, np.uint8)

    def decode_bytes(self, wire):
        return np.asarray(wire, np.uint8)

    def tensor_encode(self, data, state):
        return (data,), state

    def tensor_decode(self, parts):
        (data,) = parts
        return data


class RleCodec(Codec):
    """Zero-run byte codec for sparse checkpoint pages.

    Host wire format (byte-exact for ARBITRARY input, including empty
    and all-zero): a little-endian u32 raw length, then records of
    ``(u32 literal_len, u32 zero_len, literal bytes)``. Only zero runs
    of at least ``RLE_MIN_RUN`` bytes are collapsed — shorter runs ride
    inside literals, so incompressible payloads pay only the constant
    header + one record (never a blow-up proportional to content).

    On the device the codec is the zero-SKIPPING form of the same codec:
    per row the nonzero elements are compacted to the front with their
    positions (``(values, positions)``, both at bucket capacity, hence a
    static wire width of 2 elements per element). "Nonzero" is
    ``data != 0`` in the payload's type, so a float -0.0 is skipped and
    a NaN is kept. The transform is exact for every dtype.
    """

    name = "rle"
    lossless = True
    jax_wire_overhead = 2.0      # (values, int32 positions) per element

    def encode_bytes(self, buf):
        buf = np.ascontiguousarray(np.asarray(buf, np.uint8))
        n = buf.size
        header = np.array([n], _HDR).view(np.uint8)
        if n == 0:
            return header.copy()
        z = buf == 0
        d = np.diff(z.astype(np.int8))
        starts = np.flatnonzero(d == 1) + 1
        ends = np.flatnonzero(d == -1) + 1
        if z[0]:
            starts = np.concatenate([[0], starts])
        if z[-1]:
            ends = np.concatenate([ends, [n]])
        runlen = ends - starts
        keep = runlen >= RLE_MIN_RUN
        gs, ge, gl = starts[keep], ends[keep], runlen[keep]
        lit_starts = np.concatenate([[0], ge])
        lit_ends = np.concatenate([gs, [n]])
        zero_lens = np.concatenate([gl, [0]])
        chunks = [header]
        for ls, le, zl in zip(lit_starts, lit_ends, zero_lens):
            if le == ls and zl == 0:
                continue              # empty trailing record
            chunks.append(np.array([le - ls, zl], _HDR).view(np.uint8))
            chunks.append(buf[ls:le])
        return np.concatenate(chunks)

    def decode_bytes(self, wire):
        wire = np.ascontiguousarray(np.asarray(wire, np.uint8))
        n = int(wire[:4].view(_HDR)[0])
        out = np.zeros(n, np.uint8)
        pos, w = 0, 4
        while pos < n:
            nlit, nzero = (int(v) for v in wire[w:w + 8].view(_HDR))
            w += 8
            out[pos:pos + nlit] = wire[w:w + nlit]
            w += nlit
            pos += nlit + nzero
        return out

    def tensor_encode(self, data, state):
        nz = data != 0
        # a stable partition on zero-ness compacts the nonzeros to the
        # front in position order (the reference's stable argsort)
        order = stable_partition_order(nz)
        live = nz.gather(-1, order)
        vals = torch.where(live, data.gather(-1, order),
                           torch.zeros((), dtype=data.dtype,
                                       device=data.device))
        pos = torch.where(live, order, -1).to(torch.int32)
        return (vals, pos), state

    def tensor_decode(self, parts):
        vals, pos = parts
        cap = vals.shape[-1]
        v2 = vals.reshape(-1, cap)
        idx = pos.reshape(-1, cap).to(torch.int64)
        idx = torch.where(idx >= 0, idx, cap)        # invalid -> pad slot
        out = torch.zeros((v2.shape[0], cap + 1), dtype=vals.dtype,
                          device=vals.device)
        out.scatter_(1, idx, v2)
        return out[:, :cap].reshape(vals.shape)

    def modeled_ratio(self, zero_fraction, total_bytes):
        total = max(float(total_bytes), 1.0)
        zf = min(max(float(zero_fraction), 0.0), 1.0)
        wire = (total * (1.0 - zf)
                + RLE_HEADER_BYTES + 2 * RLE_RECORD_BYTES)
        return max(total / wire, 1e-9)


def int8_encode(x: torch.Tensor):
    """Symmetric int8 quantization over the LAST axis: per-row scale
    ``max|x| / 127`` (at least 1e-30 / 127), round half to even, clip to
    +-127. Returns ``(q int8, scale float32)`` with ``scale`` shaped
    like ``x`` minus its last axis. Float32 arithmetic throughout, as in
    the reference."""
    x = x.to(torch.float32)
    scale = x.abs().amax(dim=-1).clamp(min=1e-30) / 127.0
    q = torch.round(x / scale.unsqueeze(-1)).clamp_(-127, 127)
    return q.to(torch.int8), scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale.unsqueeze(-1)


class EfInt8Codec(Codec):
    """Error-feedback int8 for float payloads (lossy).

    Each round's send is quantized to int8 with a per-destination-row
    scale; the quantization error ``x - decode(encode(x))`` is the
    codec's STATE, added to the next round's send before quantizing
    (EF-SGD). The round engine carries that residual through its loop in
    round order at every ring depth. For a write, element-wise the file
    sees ``x + r_t - r_{t+1}``: bounded by about twice one round's
    quantization step.
    """

    name = "ef-int8"
    lossless = False
    stateful = True
    jax_wire_overhead = 0.3      # int8 codes (1/4 of f32) + per-row
    # scale + the f32 residual rides OUTSIDE the ring count (one copy,
    # not one per in-flight window)

    def encode_bytes(self, buf):   # pragma: no cover - guarded by host
        raise TypeError(
            "ef-int8 is a lossy float codec; the host write path moves "
            "raw bytes — use a lossless codec ('identity', 'rle')")

    decode_bytes = encode_bytes

    def init_state(self, shape, dtype, device=None):
        if not dtype.is_floating_point:
            raise TypeError(
                f"slow_hop_codec='ef-int8' quantizes float payloads; "
                f"got dtype {dtype}")
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def tensor_encode(self, data, state):
        x = data.to(torch.float32)
        if not isinstance(state, tuple):   # residual rides along
            x = x + state
        q, scale = int8_encode(x)
        new_state = (state if isinstance(state, tuple)
                     else x - int8_decode(q, scale))
        return (q, scale), new_state

    def tensor_decode(self, parts):
        return int8_decode(*parts)

    def modeled_ratio(self, zero_fraction, total_bytes):
        return 4.0      # f32 -> int8 (+ one scale per row, amortized)


_REGISTRY: dict[str, Codec] = {}


def register(codec: Codec) -> Codec:
    """Add a codec to the registry (last registration of a name wins —
    deliberate, so tests/experiments can shadow a builtin)."""
    _REGISTRY[codec.name] = codec
    return codec


def get_codec(name: str) -> Codec:
    """Look up a codec by name; raises ``ValueError`` with the known
    names so a typo dies at plan time, not mid-exchange."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown slow_hop_codec {name!r}; "
            f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_codecs() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def lossless_codecs() -> tuple[str, ...]:
    return tuple(sorted(n for n, c in _REGISTRY.items() if c.lossless))


register(IdentityCodec())
register(RleCodec())
register(EfInt8Codec())


def zero_fraction(bufs) -> float:
    """Fraction of zero bytes across an iterable of uint8 payloads —
    the measurable statistic behind ``rle``'s modeled ratio (sparse
    checkpoint pages are zero-dominated)."""
    total = zeros = 0
    for b in bufs:
        b = np.asarray(b)
        total += b.size
        zeros += int((b == 0).sum())
    return zeros / total if total else 0.0
