"""Checkpoints of the port (counterpart of ``houv_tpu/train/checkpoint.py``).

A checkpoint of the port is a ``torch.save`` of ``{"model": state_dict,
"optimizer": state_dict, "epoch": int}`` (under ``use_gan`` also
``"critic"`` and ``"critic_optimizer"``, as the JAX package's state holds
``d_params`` and ``d_opt_state``); a file holding a bare model
``state_dict`` loads too. The JAX package's checkpoints (flax msgpack, as
``flax.serialization.msgpack_serialize`` writes them) are read by
``read_flax_msgpack`` into a tree of numpy arrays, with a decoder of its own
(no ``msgpack`` package); ``houv_tpu_torch.state.state_from_flax`` maps
that tree onto a model of the port. ``load_checkpoint`` takes either, told
apart by the file's content: ``torch.save`` writes a zip archive, flax a
msgpack map. In a job of several ranks (a ``parallel.mesh.Mesh``), rank 0
writes and every rank reads.
"""

from __future__ import annotations

import logging
import os
import struct
import zipfile

import numpy as np
import torch
import torch.distributed


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None,
                    epoch: int = 0, mesh=None,
                    extra: dict | None = None) -> str:
    """Write ``path`` (through a temporary file). ``extra`` adds entries
    beside the model's (a GAN's critic and its optimizer state), which
    ``load_checkpoint`` does not read. With a ``mesh`` of several ranks
    only rank 0 writes, and every rank returns once the file is there."""
    if mesh is not None and mesh.size > 1:
        if mesh.rank == 0:
            save_checkpoint(path, model, optimizer, epoch, extra=extra)
        torch.distributed.barrier()
        return path
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {"model": model.state_dict(), "epoch": int(epoch)}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    state.update(extra or {})
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None) -> int:
    """Load ``path`` into ``model`` (strictly) and, when both are there,
    into ``optimizer``. Returns the checkpoint's epoch (0 for a model-only
    file). Tensors land on the device the model already lies on. A JAX
    package's checkpoint gives its ``params`` and ``batch_stats`` (mapped
    by ``state_from_flax``) and its epoch; its optimizer state is not
    carried across, and ``optimizer`` stays as it is."""
    if not zipfile.is_zipfile(path):
        from houv_tpu_torch.state import state_from_flax

        tree = read_flax_msgpack(path)
        model.load_state_dict(state_from_flax(tree, model), strict=True)
        epoch = int(tree.get("epoch", 0))
        logging.getLogger("houv_tpu_torch").info(
            "%s: a JAX package checkpoint: parameters and running "
            "statistics mapped, epoch %d restored, the optimizer state "
            "left fresh", path, epoch)
        return epoch
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "model" not in state:            # a bare state_dict
        state = {"model": state}
    model.load_state_dict(state["model"], strict=True)
    if optimizer is not None and "optimizer" in state:
        optimizer.load_state_dict(state["optimizer"])
    return int(state.get("epoch", 0))


# flax/serialization.py's extension types: 1 an ndarray, 3 a numpy scalar,
# each a packed (shape, dtype name, bytes)
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Unpacker:
    """A msgpack decoder for the types a flax checkpoint holds: nil, bool,
    ints, floats, str, bin, arrays, maps and the extension types above."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _uint(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def _int(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big", signed=True)

    def unpack(self):
        tag = self._uint(1)
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self._map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.unpack() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return str(self._take(tag & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in simple:
            return simple[tag]
        if tag in (0xC4, 0xC5, 0xC6):                       # bin 8/16/32
            return bytes(self._take(self._uint(1 << (tag - 0xC4))))
        if tag in (0xC7, 0xC8, 0xC9):                       # ext 8/16/32
            n = self._uint(1 << (tag - 0xC7))
            return self._ext(self._int(1), n)
        if tag == 0xCA:
            return struct.unpack(">f", self._take(4))[0]
        if tag == 0xCB:
            return struct.unpack(">d", self._take(8))[0]
        if 0xCC <= tag <= 0xCF:                             # uint 8..64
            return self._uint(1 << (tag - 0xCC))
        if 0xD0 <= tag <= 0xD3:                             # int 8..64
            return self._int(1 << (tag - 0xD0))
        if 0xD4 <= tag <= 0xD8:                             # fixext 1..16
            code = self._int(1)
            return self._ext(code, 1 << (tag - 0xD4))
        if tag in (0xD9, 0xDA, 0xDB):                       # str 8/16/32
            return str(self._take(self._uint(1 << (tag - 0xD9))), "utf-8")
        if tag in (0xDC, 0xDD):                             # array 16/32
            return [self.unpack()
                    for _ in range(self._uint(2 << (tag - 0xDC)))]
        if tag in (0xDE, 0xDF):                             # map 16/32
            return self._map(self._uint(2 << (tag - 0xDE)))
        raise ValueError(f"msgpack type byte 0x{tag:02x} is not read here")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.unpack()
            out[key] = self.unpack()
        return out

    def _ext(self, code: int, n: int):
        payload = bytes(self._take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not a flax "
                             "ndarray (1) or numpy scalar (3)")
        shape, name, buf = _Unpacker(payload).unpack()
        arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr


def read_flax_msgpack(path: str) -> dict:
    """The tree a JAX checkpoint holds (what ``flax.serialization.
    msgpack_restore`` returns): nested dicts with numpy arrays and numpy
    scalars as leaves. (An array leaf over 1 GiB, which flax writes in
    chunks, comes back as the dict of chunks flax wrote.)"""
    with open(path, "rb") as f:
        unpacker = _Unpacker(f.read())
    tree = unpacker.unpack()
    if unpacker.pos != len(unpacker.data):
        raise ValueError(f"{path}: trailing bytes after the msgpack tree")
    return tree
