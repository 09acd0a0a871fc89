"""TFRecord reader and writer with no TensorFlow (counterpart of
pcseqlearning_tpu.datasets.tfrecord_io: the same bytes, the same CRCs).

A TFRecord file is a run of records, each

    uint64 length (little-endian)
    uint32 masked_crc32c(length bytes)
    bytes  data[length]
    uint32 masked_crc32c(data)

with CRC32C (Castagnoli, reflected) and TensorFlow's masking rotation.

The JAX package runs the CRC's table loop in Python, one byte at a time,
which takes seconds over a frame of several MB. Here the same CRC is
computed over NumPy arrays. The CRC register is linear over GF(2), so the
payload is cut into K equal chunks (zero bytes in front, which leave a zero
register as it is), the K registers advance together one byte column at a
time from 0, and the chunks are folded pairwise, a chunk's register being
carried across the bytes after it by the operator "advance over L zero
bytes" (four 256-entry tables). The initial register 0xFFFFFFFF is carried
across the whole payload by the same operator.
"""

from __future__ import annotations

import struct

import numpy as np

_POLY = 0x82F63B78  # Castagnoli, reflected


def _byte_table():
    """The 256-entry table of the byte-at-a-time CRC32C update."""
    c = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        c = np.where(c & 1, (c >> 1) ^ np.uint32(_POLY), c >> 1).astype(np.uint32)
    return c


_TABLE = _byte_table()


def _zero_byte_operator():
    """The 32 columns (images of the register's bits) of the map that
    advances the register over one zero byte: r -> T[r & 0xFF] ^ (r >> 8)."""
    bits = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return (_TABLE[bits & np.uint32(0xFF)] ^ (bits >> np.uint32(8))).astype(np.uint32)


def _apply(cols, x):
    """The linear map with columns ``cols`` [32] applied to ``x`` (uint32
    array): the XOR of the columns of x's set bits."""
    x = np.asarray(x, np.uint32)
    out = np.zeros_like(x)
    for i in range(32):
        out ^= np.where((x >> np.uint32(i)) & np.uint32(1), cols[i], np.uint32(0))
    return out


def _power(cols, n):
    """The columns of the map applied ``n`` times (square and multiply)."""
    result = np.uint32(1) << np.arange(32, dtype=np.uint32)  # identity
    base = cols
    while n:
        if n & 1:
            result = _apply(base, result)
        base = _apply(base, base)
        n >>= 1
    return result


def _tables(cols):
    """Four 256-entry tables for applying the map byte by byte."""
    b = np.arange(256, dtype=np.uint32)
    return [_apply(cols, b << np.uint32(8 * k)) for k in range(4)]


def _apply_tables(tabs, x):
    return (tabs[0][x & 0xFF] ^ tabs[1][(x >> 8) & 0xFF] ^ tabs[2][(x >> 16) & 0xFF]
            ^ tabs[3][x >> 24])


_ONE_ZERO_BYTE = _zero_byte_operator()


def crc32c(data: bytes) -> int:
    """CRC32C of ``data`` (init 0xFFFFFFFF, final XOR 0xFFFFFFFF)."""
    buf = np.frombuffer(data, np.uint8)
    n = buf.size
    init = int(_apply(_power(_ONE_ZERO_BYTE, n), np.uint32(0xFFFFFFFF)))
    if n == 0:
        return init ^ 0xFFFFFFFF
    k = 1 << max(0, min(12, (n.bit_length() - 1) // 2))  # ~sqrt(n) chunks, at most 4096
    length = -(-n // k)
    cols = np.zeros(k * length, np.uint8)
    cols[k * length - n:] = buf
    cols = np.ascontiguousarray(cols.reshape(k, length).T)  # [length, k]
    reg = np.zeros(k, np.uint32)
    for c in cols:
        reg = _TABLE[(reg ^ c) & 0xFF] ^ (reg >> np.uint32(8))
    # fold: chunk i's register carried over the chunk after it, then XORed
    step = _power(_ONE_ZERO_BYTE, length)
    while reg.size > 1:
        reg = _apply_tables(_tables(step), reg[0::2]) ^ reg[1::2]
        step = _apply(step, step)
    return (int(reg[0]) ^ init) ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def read_tfrecord(path, verify_crc=False):
    """Yield record payload bytes from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (crc,) = struct.unpack("<I", header[8:12])
                if crc != _masked_crc(header[:8]):
                    raise IOError(f"{path}: corrupt record length crc")
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"{path}: truncated record")
            footer = f.read(4)
            if verify_crc:
                (crc,) = struct.unpack("<I", footer)
                if crc != _masked_crc(data):
                    raise IOError(f"{path}: corrupt record data crc")
            yield data


def write_tfrecord(path, payloads):
    """Write an iterable of bytes payloads as a TFRecord file."""
    with open(path, "wb") as f:
        for data in payloads:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))
