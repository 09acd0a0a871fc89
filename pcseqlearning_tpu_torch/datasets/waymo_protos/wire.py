"""A protobuf wire-format reader and writer for a fixed proto2 schema, with
no protobuf package.

A message class lists its fields (``Field``: number, name, kind, repeated,
packed, message class, enum values). ``Message.decode(buf)`` reads the
wire format as protobuf's parser does:

- a field whose number is unknown, or whose wire type does not match its
  kind, is skipped, whatever its wire type (varint, fixed64,
  length-delimited, group, fixed32);
- a repeated number (int32, int64, enum, float, double) is read packed or
  unpacked, whichever the writer chose, and chunks of both add up in order;
- a closed enum's value outside its declared set is skipped (protobuf keeps
  it as an unknown field and the field reads its default);
- a singular message field given twice merges the two, as protobuf does;
- an absent optional field reads as its default (0, 0.0, b"", "", or an
  empty message), a repeated one as empty.

Repeated numbers decode to NumPy arrays (``float32`` for float, ``float64``
for double, ``int32`` for int32 and enum, ``int64`` for int64): a packed
float is one ``np.frombuffer``, a packed varint is decoded by array
operations (a negative int32 takes ten bytes). Repeated strings, bytes and
messages decode to lists.

``msg.encode()`` writes the fields that were set, in field-number order, as
protobuf does; repeated numbers marked ``packed`` as one packed field, the
others one tag per element.
"""

from __future__ import annotations

import struct

import numpy as np

DOUBLE, FLOAT, INT32, INT64, ENUM, STRING, BYTES, MESSAGE = (
    "double", "float", "int32", "int64", "enum", "string", "bytes", "message")
VARINT, FIXED64, LEN, START_GROUP, END_GROUP, FIXED32 = 0, 1, 2, 3, 4, 5
_WIRE = {DOUBLE: FIXED64, FLOAT: FIXED32, INT32: VARINT, INT64: VARINT, ENUM: VARINT,
         STRING: LEN, BYTES: LEN, MESSAGE: LEN}
_DTYPE = {DOUBLE: np.dtype("<f8"), FLOAT: np.dtype("<f4"), INT32: np.dtype(np.int32),
          ENUM: np.dtype(np.int32), INT64: np.dtype(np.int64)}
_DEFAULT = {DOUBLE: 0.0, FLOAT: 0.0, INT32: 0, INT64: 0, ENUM: 0, STRING: "", BYTES: b""}
_MASK64 = (1 << 64) - 1


class DecodeError(ValueError):
    """The bytes are not a valid encoding of the message."""


class Field:
    __slots__ = ("number", "name", "kind", "repeated", "packed", "message", "enum")

    def __init__(self, number, name, kind, repeated=False, packed=False, message=None,
                 enum=None):
        self.number, self.name, self.kind = number, name, kind
        self.repeated, self.packed, self.message = repeated, packed, message
        self.enum = None if enum is None else frozenset(enum)


# -- varints -------------------------------------------------------------------

def _read_varint(buf, pos, end):
    result = shift = 0
    while True:
        if pos >= end:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


def _encode_varint(v):
    v &= _MASK64
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def decode_varints(raw):
    """Every varint of ``raw`` (bytes) as uint64 [n], by array operations."""
    b = np.frombuffer(raw, np.uint8)
    if b.size == 0:
        return np.zeros(0, np.uint64)
    last = b < 0x80
    if not last[-1]:
        raise DecodeError("truncated packed varint")
    ends = np.flatnonzero(last)
    starts = np.concatenate([[0], ends[:-1] + 1])
    if int((ends - starts).max()) >= 10:
        raise DecodeError("varint longer than 10 bytes")
    group = np.repeat(np.arange(ends.size), ends - starts + 1)
    shift = (np.arange(b.size) - starts[group]).astype(np.uint64) * np.uint64(7)
    parts = (b & 0x7F).astype(np.uint64) << shift
    return np.bitwise_or.reduceat(parts, starts)


def encode_varints(values):
    """The packed varint encoding of integer ``values`` (negative ones as
    their 64-bit two's complement, ten bytes), by array operations."""
    v = np.asarray(values).astype(np.int64).view(np.uint64).reshape(-1)
    if v.size == 0:
        return b""
    nbits = np.zeros(v.size, np.int64)
    for k in range(1, 10):  # bytes needed: 1 + the number of 7-bit groups above the first
        nbits += (v >> np.uint64(7 * k)) > 0
    nbytes = nbits + 1
    k = np.arange(10)
    digits = ((v[:, None] >> (np.uint64(7) * k.astype(np.uint64))) & np.uint64(0x7F)).astype(
        np.uint8)
    digits |= np.where(k[None, :] < (nbytes[:, None] - 1), 0x80, 0).astype(np.uint8)
    return digits[k[None, :] < nbytes[:, None]].tobytes()


def _to_int32(v):
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _to_int64(v):
    return v - (1 << 64) if v >= 1 << 63 else v


# -- skipping unknown fields -------------------------------------------------

def _skip(buf, pos, end, wire, number):
    if wire == VARINT:
        return _read_varint(buf, pos, end)[1]
    if wire == FIXED64:
        pos += 8
    elif wire == FIXED32:
        pos += 4
    elif wire == LEN:
        n, pos = _read_varint(buf, pos, end)
        pos += n
    elif wire == START_GROUP:
        while True:
            key, pos = _read_varint(buf, pos, end)
            if key & 7 == END_GROUP:
                if key >> 3 != number:
                    raise DecodeError("mismatched end group")
                return pos
            pos = _skip(buf, pos, end, key & 7, key >> 3)
    else:
        raise DecodeError(f"unexpected wire type {wire}")
    if pos > end:
        raise DecodeError("truncated field")
    return pos


# -- messages -----------------------------------------------------------------

class Message:
    """A proto2 message of the class's ``FIELDS``. Construct with keyword
    arguments; an attribute never set reads as its default."""

    FIELDS = ()

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._by_number = {f.number: f for f in cls.FIELDS}
        cls._by_name = {f.name: f for f in cls.FIELDS}

    def __init__(self, **fields):
        for k, v in fields.items():
            if k not in self._by_name:
                raise AttributeError(f"{type(self).__name__} has no field {k!r}")
            setattr(self, k, v)

    def __getattr__(self, name):
        f = type(self)._by_name.get(name) if not name.startswith("_") else None
        if f is None:
            raise AttributeError(name)
        if f.repeated:
            return np.zeros(0, _DTYPE[f.kind]) if f.kind in _DTYPE else []
        return f.message() if f.kind == MESSAGE else _DEFAULT[f.kind]

    def has(self, name):
        """Whether the field ``name`` was set (read, or given)."""
        return name in self.__dict__

    # -- reading --------------------------------------------------------------
    @classmethod
    def decode(cls, buf):
        """The message encoded in ``buf`` (bytes-like)."""
        buf = bytes(buf)
        return cls._decode(buf, 0, len(buf))

    @classmethod
    def _decode(cls, buf, pos, end):
        msg = cls.__new__(cls)
        chunks = {}  # repeated numbers: their decoded pieces, in order
        while pos < end:
            key, pos = _read_varint(buf, pos, end)
            number, wire = key >> 3, key & 7
            if number == 0:
                raise DecodeError("field number 0")
            f = cls._by_number.get(number)
            if f is None or (wire != _WIRE[f.kind] and not (
                    wire == LEN and f.repeated and f.kind in _DTYPE)):
                pos = _skip(buf, pos, end, wire, number)
                continue
            if wire == LEN:
                n, pos = _read_varint(buf, pos, end)
                stop = pos + n
                if stop > end:
                    raise DecodeError(f"truncated field {f.name}")
                if f.kind == MESSAGE:
                    value = f.message._decode(buf, pos, stop)
                elif f.kind == BYTES:
                    value = buf[pos:stop]
                elif f.kind == STRING:
                    value = buf[pos:stop].decode("utf-8")
                else:  # a packed run of numbers
                    chunks.setdefault(f.name, []).append(_packed(f, buf[pos:stop]))
                    pos = stop
                    continue
                pos = stop
            elif wire == VARINT:
                value, pos = _read_varint(buf, pos, end)
                value = _to_int64(value) if f.kind == INT64 else _to_int32(value)
                if f.enum is not None and value not in f.enum:
                    continue  # a closed enum's unknown value
            else:
                width = 8 if wire == FIXED64 else 4
                if pos + width > end:
                    raise DecodeError(f"truncated field {f.name}")
                value = struct.unpack_from("<d" if width == 8 else "<f", buf, pos)[0]
                pos += width
            if f.repeated:
                chunks.setdefault(f.name, []).append(value)
            elif f.kind == MESSAGE and f.name in msg.__dict__:
                msg.__dict__[f.name]._merge(value)  # a message given twice merges
            else:
                msg.__dict__[f.name] = value
        for name, parts in chunks.items():
            f = cls._by_name[name]
            if f.kind in _DTYPE:
                parts = [np.atleast_1d(np.asarray(p, _DTYPE[f.kind])) for p in parts]
                msg.__dict__[name] = np.concatenate(parts)
            else:
                msg.__dict__[name] = parts
        if pos != end:
            raise DecodeError("field runs past the message's end")
        return msg

    def _merge(self, other):
        """Merge ``other`` into this message as protobuf's parser does: set
        scalars replace, repeated fields append, messages merge."""
        for name, v in other.__dict__.items():
            f = self._by_name[name]
            if name not in self.__dict__:
                self.__dict__[name] = v
            elif f.repeated:
                old = self.__dict__[name]
                self.__dict__[name] = (np.concatenate([old, v]) if f.kind in _DTYPE
                                       else list(old) + list(v))
            elif f.kind == MESSAGE:
                self.__dict__[name]._merge(v)
            else:
                self.__dict__[name] = v

    # -- writing --------------------------------------------------------------
    def encode(self):
        """The wire bytes of the fields that were set."""
        out = []
        for f in sorted(self.FIELDS, key=lambda f: f.number):
            if f.name not in self.__dict__:
                continue
            v = self.__dict__[f.name]
            if not f.repeated:
                out.append(_encode_one(f, v))
            elif f.kind in _DTYPE and f.packed:
                payload = _encode_packed(f, v)
                if payload:
                    out.append(_encode_varint(f.number << 3 | LEN) + _encode_varint(len(payload))
                               + payload)
            else:
                out.extend(_encode_one(f, x) for x in (
                    np.asarray(v, _DTYPE[f.kind]).reshape(-1).tolist() if f.kind in _DTYPE
                    else v))
        return b"".join(out)


def _packed(f, raw):
    if f.kind in (DOUBLE, FLOAT):
        width = _DTYPE[f.kind].itemsize
        if len(raw) % width:
            raise DecodeError(f"packed {f.name} of {len(raw)} bytes")
        return np.frombuffer(raw, _DTYPE[f.kind]).astype(_DTYPE[f.kind].newbyteorder("="))
    v = decode_varints(raw)
    if f.kind == INT64:
        return v.view(np.int64)
    v = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    if f.enum is not None:
        v = v[np.isin(v, np.fromiter(f.enum, np.int32))]
    return v


def _encode_packed(f, values):
    v = np.asarray(values).reshape(-1)
    if f.kind in (DOUBLE, FLOAT):
        return v.astype(_DTYPE[f.kind]).tobytes()
    return encode_varints(v)


def _encode_one(f, v):
    wire = _WIRE[f.kind]
    key = _encode_varint(f.number << 3 | wire)
    if f.kind == MESSAGE:
        body = v.encode()
        return key + _encode_varint(len(body)) + body
    if f.kind in (STRING, BYTES):
        body = v.encode("utf-8") if f.kind == STRING else bytes(v)
        return key + _encode_varint(len(body)) + body
    if f.kind == DOUBLE:
        return key + struct.pack("<d", float(v))
    if f.kind == FLOAT:
        return key + struct.pack("<f", float(v))
    return key + _encode_varint(int(v))
