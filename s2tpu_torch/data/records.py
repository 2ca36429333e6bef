"""Sharded record corpus format (.s2rec): on-disk datasets beyond one memmap (the port of ``s2tpu/data/records.py``).

``PackedSource`` (``data/dataset.py``) is the hot-path corpus: two monolithic
memmapped arrays. That stops being practical when the corpus outgrows one
filesystem object, needs incremental growth or per-host file ownership, or
compressed storage (Sentinel-2 int16 DN rasters compress 2-3x). This module
keeps the JAX package's format byte for byte, so a corpus written by either
package reads in the other: fixed-shape records, O(1) random access, and
zlib-per-record compression as an option.

On-disk layout (one directory):
    meta.json            corpus metadata (shapes, dtypes, shard table)
    shard-00000.s2rec    concatenated records (image bytes + label bytes
                         [+ uint32 crc32 footer]), zlib-compressed per
                         record when enabled
    shard-00000.idx.npy  uint64 (n+1,) record byte offsets (compressed
                         shards only; uncompressed records are fixed-size)

Random access = shard lookup (prefix-sum bisect) + one read + one reshape;
no codec for the uncompressed case. Shards are opened lazily, so a process
that reads a subset of the samples opens only the shards they touch.
"""

from __future__ import annotations

import json
import typing
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from s2tpu_torch.data.dataset import Sample, SegmentSource

_MAGIC = "s2rec/1"


@dataclass(frozen=True)
class _ShardInfo:
    file: str
    n: int


def _record_nbytes(meta: dict) -> int:
    img = int(np.prod(meta["image_shape"])) * np.dtype(meta["image_dtype"]).itemsize
    lbl = int(np.prod(meta["label_shape"])) * np.dtype(meta["label_dtype"]).itemsize
    return img + lbl + (4 if meta["crc"] else 0)


def write_sharded_records(
    source: SegmentSource,
    out_dir: str | Path,
    records_per_shard: int = 512,
    compress: bool = False,
    crc: bool = True,
) -> "RecordSource":
    """Pack any SegmentSource into a sharded .s2rec corpus.

    ``records_per_shard`` bounds shard size (512 full 512x512x6 segments
    ~= 1.7 GB uncompressed); ``compress`` trades read CPU for 2-3x disk;
    ``crc`` appends a crc32 footer per record, verified on read when the
    source is opened with verify=True.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = len(source)
    if n == 0:
        raise ValueError("empty source")
    first = source[0]
    meta = {
        "magic": _MAGIC,
        "n": n,
        "image_shape": list(first.x.shape),
        "image_dtype": str(np.dtype(np.int16)),
        "label_shape": list(first.y.shape),
        "label_dtype": str(np.dtype(np.uint8)),
        "compress": compress,
        "crc": crc,
        "records_per_shard": records_per_shard,
        "shards": [],
    }
    shard_idx = 0
    i = 0
    while i < n:
        count = min(records_per_shard, n - i)
        name = f"shard-{shard_idx:05d}.s2rec"
        offsets = np.zeros(count + 1, np.uint64)
        with open(out / name, "wb") as f:
            for k in range(count):
                s = source[i + k]
                payload = (
                    np.ascontiguousarray(s.x, np.int16).tobytes()
                    + np.ascontiguousarray(s.y, np.uint8).tobytes()
                )
                if crc:
                    payload += np.uint32(zlib.crc32(payload)).tobytes()
                if compress:
                    payload = zlib.compress(payload, level=1)
                f.write(payload)
                offsets[k + 1] = offsets[k] + len(payload)
        if compress:
            np.save(out / f"shard-{shard_idx:05d}.idx.npy", offsets)
        meta["shards"].append({"file": name, "n": count})
        i += count
        shard_idx += 1
    (out / "meta.json").write_text(json.dumps(meta))
    return RecordSource(out)


class RecordSource(SegmentSource):
    """Random-access reader over a sharded .s2rec corpus.

    File handles are opened lazily per shard (a process touching a subset
    of the samples never opens the other shards).
    """

    def __init__(self, record_dir: str | Path, verify: bool = False) -> None:
        self.dir = Path(record_dir)
        self.meta = json.loads((self.dir / "meta.json").read_text())
        if self.meta.get("magic") != _MAGIC:
            raise ValueError(f"not an s2rec corpus: {self.dir}")
        self.verify = verify
        shards = [_ShardInfo(**s) for s in self.meta["shards"]]
        self._shards = shards
        self._starts = np.concatenate([[0], np.cumsum([s.n for s in shards])])
        if self._starts[-1] != self.meta["n"]:
            raise ValueError(f"{self.dir}: shard table inconsistent with n")
        self._files: dict[int, typing.BinaryIO] = {}
        self._offsets: dict[int, np.ndarray] = {}
        self._img_shape = tuple(self.meta["image_shape"])
        self._lbl_shape = tuple(self.meta["label_shape"])
        self._img_nbytes = int(np.prod(self._img_shape)) * 2
        self._lbl_nbytes = int(np.prod(self._lbl_shape))
        self._rec_nbytes = _record_nbytes(self.meta)

    def __len__(self) -> int:
        return self.meta["n"]

    def _shard_of(self, idx: int) -> tuple[int, int]:
        shard = int(np.searchsorted(self._starts, idx, side="right") - 1)
        return shard, idx - int(self._starts[shard])

    def _file(self, shard: int) -> typing.BinaryIO:
        f = self._files.get(shard)
        if f is None:
            f = open(self.dir / self._shards[shard].file, "rb")
            self._files[shard] = f
        return f

    def _read_record(self, shard: int, local: int) -> bytes:
        f = self._file(shard)
        if self.meta["compress"]:
            offs = self._offsets.get(shard)
            if offs is None:
                offs = np.load(self.dir / f"shard-{shard:05d}.idx.npy")
                self._offsets[shard] = offs
            start, end = int(offs[local]), int(offs[local + 1])
            f.seek(start)
            payload = zlib.decompress(f.read(end - start))
        else:
            f.seek(local * self._rec_nbytes)
            payload = f.read(self._rec_nbytes)
        if self.meta["crc"]:
            payload, footer = payload[:-4], payload[-4:]
            if self.verify:
                expect = int(np.frombuffer(footer, np.uint32)[0])
                got = zlib.crc32(payload)
                if got != expect:
                    raise IOError(
                        f"crc mismatch in {self._shards[shard].file} record {local}: "
                        f"{got:#x} != {expect:#x}"
                    )
        return payload

    def __getitem__(self, idx: int) -> Sample:
        shard, local = self._shard_of(int(idx))
        payload = self._read_record(shard, local)
        x = np.frombuffer(payload, np.int16, count=self._img_nbytes // 2).reshape(self._img_shape)
        y = np.frombuffer(payload[self._img_nbytes :], np.uint8, count=self._lbl_nbytes).reshape(
            self._lbl_shape
        )
        return Sample(x=x, y=y)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
