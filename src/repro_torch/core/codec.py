"""Slow-hop codec registry: the numpy half.

The port's copy of the reference's codec registry (``repro.core.codec``)
without its tensor hooks. The planner looks codecs up by name
(``passes.effective_workload`` and ``resolve_codec``) and reads their
modeling attributes (``lossless``, ``modeled_ratio``,
``jax_wire_overhead`` — the static wire width of one encoded element,
kept under the reference's name so the two registries read alike), so
this registry is enough to compile every plan the reference compiles.
The host byte codecs (``encode_bytes`` / ``decode_bytes``) are numpy
and come along unchanged.

The round engine's tensor encode/decode of the slow-hop payload is not
ported yet: ``repro_torch.core.rounds`` raises ``NotImplementedError``
for a plan whose ``slow_hop_codec`` is not ``None``.
"""
from __future__ import annotations

import numpy as np

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
    stateful:  carries residual state through the round loop.

    The numpy hooks (:meth:`encode_bytes` / :meth:`decode_bytes`) move
    real bytes; the tensor hooks of the reference are not ported yet.
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



class RleCodec(Codec):
    """Zero-run byte codec for sparse checkpoint pages.

    Host wire format (byte-exact for ARBITRARY input, including empty
    and all-zero): a little-endian u32 raw length, then records of
    ``(u32 literal_len, u32 zero_len, literal bytes)``. Only zero runs
    of at least ``RLE_MIN_RUN`` bytes are collapsed — shorter runs ride
    inside literals, so incompressible payloads pay only the constant
    header + one record (never a blow-up proportional to content).

    On the device the codec is the zero-SKIPPING form of the same codec
    (``(values, positions)`` at bucket capacity, hence a static wire
    width of 2 elements per element); that half is not ported yet.
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

    def modeled_ratio(self, zero_fraction, total_bytes):
        total = max(float(total_bytes), 1.0)
        zf = min(max(float(zero_fraction), 0.0), 1.0)
        wire = (total * (1.0 - zf)
                + RLE_HEADER_BYTES + 2 * RLE_RECORD_BYTES)
        return max(total / wire, 1e-9)


class EfInt8Codec(Codec):
    """Error-feedback int8 for float payloads (lossy).

    Each round's send is quantized to int8 with a per-destination-row
    scale and the quantization error is fed back into the next round's
    send (EF-SGD). Only its registry entry and modeling hooks are
    ported; its tensor half waits with the other codecs.
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
