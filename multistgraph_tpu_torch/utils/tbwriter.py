"""Minimal TensorBoard event-file writer (no TensorFlow dependency).

A copy of multistgraph_tpu/utils/tbwriter.py, which is pure Python; the
port keeps its own so that it imports nothing of the JAX package.

The reference logs 'training loss' / 'eval loss' scalars per epoch through
torch.utils.tensorboard's SummaryWriter
(ref: libcity/executor/traffic_state_executor.py:38,347,447). This module
writes the same `events.out.tfevents.*` files by hand-encoding the two tiny
protobuf messages involved (Event, Summary) and the TFRecord framing
(length + masked CRC32C), so standard TensorBoard can read the training
curves without pulling TF into the image.

Wire format notes:
  * TFRecord: u64le(len) crc(len) data crc(data), each CRC the 'masked'
    CRC32C  ((c >> 15 | c << 17) + 0xa282ead8) mod 2^32.
  * Event proto fields: wall_time(1, double) step(2, int64)
    file_version(3, string) summary(5, message).
  * Summary.Value fields: tag(1, string) simple_value(2, float).
"""

import os
import socket
import struct
import time
from typing import List

# ---------------------------------------------------------------- CRC32C
_CRC_TABLE: List[int] = []


def _build_table() -> None:
    poly = 0x82F63B78  # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _string(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _string(1, tag.encode()) + _key(2, 5) + struct.pack("<f", float(value))
    return _string(1, val)  # Summary.value (repeated field 1)


def _event(wall_time: float, step: int, body: bytes = b"") -> bytes:
    msg = _key(1, 1) + struct.pack("<d", wall_time) + _key(2, 0) + _varint(step) + body
    return msg


class SummaryWriter:
    """Append-only scalar writer, TensorBoard-compatible."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.{}.{}".format(int(time.time()), socket.gethostname())
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._write(_event(time.time(), 0, _string(3, b"brain.Event:2")))

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step, _string(5, _scalar_summary(tag, value))))

    def close(self) -> None:
        self._f.close()


def read_scalars(path: str):
    """Parse scalars back out of an event file (tests / offline tooling).

    Returns a list of (step, tag, value). A deliberately small parser: it
    understands exactly what SummaryWriter emits.
    """

    def get_varint(buf, i):
        shift = n = 0
        while True:
            b = buf[i]
            i += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n, i
            shift += 7

    out = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        (length,) = struct.unpack_from("<Q", data, i)
        i += 12  # len + len-crc
        record = data[i : i + length]
        i += length + 4  # record + record-crc
        # walk Event fields
        j = 0
        step = 0
        while j < len(record):
            key, j = get_varint(record, j)
            field, wire = key >> 3, key & 7
            if wire == 1:
                j += 8
            elif wire == 0:
                val, j = get_varint(record, j)
                if field == 2:
                    step = val
            elif wire == 5:
                j += 4
            else:
                ln, j = get_varint(record, j)
                payload = record[j : j + ln]
                j += ln
                if field == 5:  # summary -> repeated Value
                    k = 0
                    while k < len(payload):
                        vkey, k = get_varint(payload, k)
                        vlen, k = get_varint(payload, k)
                        vmsg = payload[k : k + vlen]
                        k += vlen
                        tag, value, m = None, None, 0
                        while m < len(vmsg):
                            fkey, m = get_varint(vmsg, m)
                            ff, fw = fkey >> 3, fkey & 7
                            if fw == 2:
                                fl, m = get_varint(vmsg, m)
                                if ff == 1:
                                    tag = vmsg[m : m + fl].decode()
                                m += fl
                            elif fw == 5:
                                if ff == 2:
                                    (value,) = struct.unpack_from("<f", vmsg, m)
                                m += 4
                            elif fw == 1:
                                m += 8
                            else:
                                _, m = get_varint(vmsg, m)
                        if tag is not None and value is not None:
                            out.append((step, tag, value))
    return out
