"""Dependency-free TensorBoard event-file writer (the port's own copy of
leclip_tpu/utils/tb_events.py).

The reference logs scalars through torch's SummaryWriter
(ref: dassl/engine/trainer.py:228-246 init_writer/write_scalar); neither
TensorFlow nor tensorboardX is baked into this image, so this emits the
on-disk format directly: a TFRecord stream of ``Event`` protobufs
(``events.out.tfevents.*``), which TensorBoard tails natively.

Only the scalar subset is encoded (the reference never writes anything
else): Event{wall_time=1:double, step=2:int64, file_version=3:string,
summary=5:Summary{value=1:Value{tag=1:string, simple_value=2:float}}},
framed as TFRecords (LE uint64 length + masked-CRC32C of the length bytes,
payload + masked-CRC32C of the payload)."""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time


def _crc32c_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _event(wall_time: float, step: int = 0, file_version: str = "",
           tag: str = "", value: float = None) -> bytes:
    ev = _field(1, 1) + struct.pack("<d", wall_time)
    if step:
        ev += _field(2, 0) + _varint(step)
    if file_version:
        raw = file_version.encode()
        ev += _field(3, 2) + _varint(len(raw)) + raw
    if value is not None:
        raw_tag = tag.encode()
        val = (_field(1, 2) + _varint(len(raw_tag)) + raw_tag
               + _field(2, 5) + struct.pack("<f", value))
        summary = _field(1, 2) + _varint(len(val)) + val
        ev += _field(5, 2) + _varint(len(summary)) + summary
    return ev


_writer_count = itertools.count()


class EventFileWriter:
    """Append scalar events to one ``events.out.tfevents.*`` file."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        # pid + per-process counter uniquify the name: two writers opened in
        # the same directory within the same second (resume, tests) must not
        # append to ONE file and interleave TFRecords (matches the TF
        # SummaryWriter convention of suffixing the filename)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}.{next(_writer_count)}")
        self._file = open(os.path.join(log_dir, name), "ab")
        self._record(_event(time.time(), file_version="brain.Event:2"))

    def _record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._file.write(header + struct.pack("<I", _masked_crc(header))
                         + payload + struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._record(_event(time.time(), step=int(step), tag=tag,
                            value=float(value)))

    def flush(self):
        self._file.flush()

    def close(self):
        self._file.close()
