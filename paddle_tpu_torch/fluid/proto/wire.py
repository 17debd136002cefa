"""Minimal proto2 wire-format codec, schema-driven.

Purpose: serialize ProgramDesc to the reference's framework.proto wire format
(the reference's paddle/fluid/framework/framework.proto) without a runtime
dependency on the protobuf package — the schema is small, fixed, and
version-pinned, so a ~150-line codec is simpler and more portable than
shipping generated code tied to a protoc/runtime version pair. The
conformance test (tests/test_program_proto.py) cross-checks the JAX
package's copy of this codec against protoc-generated code, and
tests/test_torch_program_proto.py holds this copy to that one's bytes.

Schema model: a message is a ``Schema`` of fields ``(num, name, label, type)``
with label in {"opt", "req", "rep"} and type one of "int32", "int64", "uint64",
"bool", "enum", "float", "string", "bytes", or a nested Schema. Messages are
plain dicts; repeated fields are lists. Unknown fields are skipped on decode
(forward compatibility). Repeated scalars encode unpacked (proto2 default,
matching the reference encoder) but decode accepts packed too.
"""
import struct

__all__ = ["Schema", "encode", "decode"]

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


class Schema(object):
    def __init__(self, name, fields):
        self.name = name
        self.fields = fields
        self.by_num = {f[0]: f for f in fields}


# ---- primitives -----------------------------------------------------------

def _write_varint(out, v):
    if v < 0:
        v &= (1 << 64) - 1  # two's complement, 10 bytes — proto2 int32/int64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _signed(v, bits=64):
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def _key(num, wt):
    return (num << 3) | wt


# ---- encode ---------------------------------------------------------------

def _encode_scalar(out, num, typ, v):
    if typ in ("int32", "int64", "uint64", "enum"):
        _write_varint(out, _key(num, _VARINT))
        _write_varint(out, int(v))
    elif typ == "bool":
        _write_varint(out, _key(num, _VARINT))
        _write_varint(out, 1 if v else 0)
    elif typ == "float":
        _write_varint(out, _key(num, _I32))
        out.extend(struct.pack("<f", float(v)))
    elif typ in ("string", "bytes"):
        data = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        _write_varint(out, _key(num, _LEN))
        _write_varint(out, len(data))
        out.extend(data)
    elif isinstance(typ, Schema):
        data = encode(typ, v)
        _write_varint(out, _key(num, _LEN))
        _write_varint(out, len(data))
        out.extend(data)
    else:
        raise TypeError("unknown field type %r" % (typ,))


def encode(schema, msg):
    """dict -> bytes following `schema`. Missing optional fields are omitted;
    missing required fields raise."""
    out = bytearray()
    for num, name, label, typ in schema.fields:
        v = msg.get(name)
        if label == "rep":
            for item in (v or ()):
                _encode_scalar(out, num, typ, item)
            continue
        if v is None:
            if label == "req":
                raise ValueError(
                    "%s: required field %r missing" % (schema.name, name))
            continue
        _encode_scalar(out, num, typ, v)
    return bytes(out)


# ---- decode ---------------------------------------------------------------

def _skip(buf, pos, wt):
    if wt == _VARINT:
        _, pos = _read_varint(buf, pos)
    elif wt == _I64:
        pos += 8
    elif wt == _LEN:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wt == _I32:
        pos += 4
    else:
        raise ValueError("unsupported wire type %d" % wt)
    return pos


def _decode_value(buf, pos, wt, typ):
    if isinstance(typ, Schema):
        if wt != _LEN:
            raise ValueError("submessage field with wire type %d" % wt)
        n, pos = _read_varint(buf, pos)
        return decode(typ, buf[pos:pos + n]), pos + n
    if typ == "float":
        if wt != _I32:
            raise ValueError("float field with wire type %d" % wt)
        return struct.unpack("<f", buf[pos:pos + 4])[0], pos + 4
    if typ in ("string", "bytes"):
        n, pos = _read_varint(buf, pos)
        raw = bytes(buf[pos:pos + n])
        return (raw.decode("utf-8") if typ == "string" else raw), pos + n
    # varint family
    v, pos = _read_varint(buf, pos)
    if typ == "bool":
        return bool(v), pos
    if typ in ("int32", "int64"):
        # negative values are 64-bit two's-complement varints in proto2
        return _signed(v), pos
    return v, pos  # enum / uint64


def decode(schema, buf):
    """bytes -> dict. Repeated fields always decode to lists; packed repeated
    scalars are unpacked transparently."""
    msg = {}
    for num, name, label, typ in schema.fields:
        if label == "rep":
            msg[name] = []
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        num, wt = key >> 3, key & 7
        field = schema.by_num.get(num)
        if field is None:
            pos = _skip(buf, pos, wt)
            continue
        _, name, label, typ = field
        if label == "rep" and wt == _LEN and not isinstance(typ, Schema) \
                and typ not in ("string", "bytes"):
            # packed repeated scalars
            n, pos = _read_varint(buf, pos)
            sub_end = pos + n
            while pos < sub_end:
                v, pos = _decode_value(
                    buf, pos, _I32 if typ == "float" else _VARINT, typ)
                msg[name].append(v)
            continue
        v, pos = _decode_value(buf, pos, wt, typ)
        if label == "rep":
            msg[name].append(v)
        else:
            msg[name] = v
    return msg
