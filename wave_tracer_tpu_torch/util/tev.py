"""Live preview over the tev image viewer's socket protocol.

Port of wave_tracer_tpu/util/tev.py, with `socket`, `struct` and numpy
only. Wire format (tev ≥ 1.26): little-endian packets
[uint32 total length][uint8 opcode][payload]; CreateImage, then
UpdateImage (v3) with the float32 pixels interleaved.
"""

from __future__ import annotations

import socket
import struct

import numpy as np

OP_RELOAD = 1
OP_CLOSE = 2
OP_CREATE = 4
OP_UPDATE_V3 = 6


def _pack_str(s: str) -> bytes:
    return s.encode() + b"\0"


class TevClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 14158,
                 timeout: float = 2.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass

    def _send(self, opcode: int, payload: bytes):
        body = bytes([opcode]) + payload
        self.sock.sendall(struct.pack("<I", len(body) + 4) + body)

    def create_image(self, name: str, width: int, height: int,
                     channels=("R", "G", "B")):
        payload = b"\1" + _pack_str(name) \
            + struct.pack("<ii", width, height) \
            + struct.pack("<i", len(channels))
        for c in channels:
            payload += _pack_str(c)
        self._send(OP_CREATE, payload)

    def update_image(self, name: str, img: np.ndarray,
                     channels=("R", "G", "B"), x: int = 0, y: int = 0):
        """img (H, W, C) float32 tile at offset (x, y)."""
        img = np.asarray(img, np.float32)
        H, W, C = img.shape
        payload = b"\1" + _pack_str(name) \
            + struct.pack("<i", C)
        for c in channels:
            payload += _pack_str(c)
        payload += struct.pack("<iiii", x, y, W, H)
        # channel offsets/strides into the interleaved data
        for ci in range(C):
            payload += struct.pack("<q", ci)
        for _ in range(C):
            payload += struct.pack("<q", C)
        payload += img.tobytes()
        self._send(OP_UPDATE_V3, payload)

    def close_image(self, name: str):
        self._send(OP_CLOSE, _pack_str(name))


class TevPreview:
    """A film preview: one tev image, updated in place."""

    def __init__(self, address: str, name: str, width: int, height: int):
        host, _, port = address.partition(":")
        self.client = TevClient(host or "127.0.0.1",
                                int(port) if port else 14158)
        self.name = name
        self.client.create_image(name, width, height)

    def update(self, img01: np.ndarray):
        img = np.asarray(img01, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        self.client.update_image(self.name, img[..., :3])
