"""Pure-numpy multichannel WAV reader/writer.

The port's own copy of airwave_tpu/io/wav.py, the same code: the port
imports no module of the JAX package.

Replaces the reference's AVFoundation-based loader
(Airwave/WAVLoader.swift:26-99) with a dependency-free RIFF
parser. Matches the reference's normalization contract: int16 / 32768,
int32 / 2^31 (WAVLoader.swift:78, 86); float32 passed through natively.
int24 (not supported by the reference loader) is normalized by 2^23.

Writer produces float32 or PCM16 WAVs and is decode-identical for float32
(the contract the offline converter validates, ref
tools/ss2-to-hesuvi/convert.py:529-542).
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import BinaryIO, Union

import numpy as np

from airwave_tpu_torch.utils.errors import WAVError

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclasses.dataclass
class WAVData:
    """Loaded WAV contents (ref WAVLoader.swift:12-17).

    ``audio`` has shape [channels, frames], float32.
    """

    sample_rate: float
    audio: np.ndarray

    @property
    def channel_count(self) -> int:
        return int(self.audio.shape[0])

    @property
    def frame_count(self) -> int:
        return int(self.audio.shape[1])


def _read_exact(f: BinaryIO, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise WAVError("WAV file truncated")
    return data


def load(source: Union[str, bytes, BinaryIO]) -> WAVData:
    """Load a WAV file from a path, bytes, or file object."""
    if isinstance(source, (str,)):
        with open(source, "rb") as f:
            return load(f)
    if isinstance(source, (bytes, bytearray)):
        return load(io.BytesIO(source))
    f = source

    riff, _size, wave = struct.unpack("<4sI4s", _read_exact(f, 12))
    if riff != b"RIFF" or wave != b"WAVE":
        raise WAVError("not a RIFF/WAVE file")

    fmt = None
    data_bytes = None
    while True:
        header = f.read(8)
        if len(header) < 8:
            break
        chunk_id, chunk_size = struct.unpack("<4sI", header)
        payload = _read_exact(f, chunk_size)
        if chunk_size % 2 == 1:  # RIFF chunks are word-aligned
            f.read(1)
        if chunk_id == b"fmt ":
            fmt = payload
        elif chunk_id == b"data":
            data_bytes = payload
        if fmt is not None and data_bytes is not None:
            break

    if fmt is None:
        raise WAVError("missing fmt chunk")
    if data_bytes is None:
        raise WAVError("missing data chunk")
    if len(fmt) < 16:
        raise WAVError("fmt chunk too small")

    (audio_format, channels, sample_rate, _byte_rate, _block_align,
     bits_per_sample) = struct.unpack("<HHIIHH", fmt[:16])

    if audio_format == _WAVE_FORMAT_EXTENSIBLE:
        if len(fmt) < 40:
            raise WAVError("extensible fmt chunk too small")
        # SubFormat GUID: first two bytes carry the real format tag.
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if channels <= 0:
        raise WAVError(f"Invalid channel count: {channels}")

    def _frames(dtype: str, width: int) -> np.ndarray:
        # A truncated data chunk must surface as a typed WAVError (the
        # import preflight's contract), not np.frombuffer's bare
        # ValueError; tolerate the ragged tail like the 24-bit path does.
        usable = (len(data_bytes) // width) * width
        return np.frombuffer(data_bytes[:usable], dtype=dtype)

    if audio_format == _WAVE_FORMAT_IEEE_FLOAT and bits_per_sample == 32:
        samples = _frames("<f4", 4).astype(np.float32)
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT and bits_per_sample == 64:
        samples = _frames("<f8", 8).astype(np.float32)
    elif audio_format == _WAVE_FORMAT_PCM and bits_per_sample == 16:
        samples = _frames("<i2", 2).astype(np.float32) / 32768.0
    elif audio_format == _WAVE_FORMAT_PCM and bits_per_sample == 32:
        samples = _frames("<i4", 4).astype(np.float32) / 2147483648.0
    elif audio_format == _WAVE_FORMAT_PCM and bits_per_sample == 24:
        raw = np.frombuffer(data_bytes, dtype=np.uint8)
        usable = (len(raw) // 3) * 3
        raw = raw[:usable].reshape(-1, 3)
        as_int = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        as_int = np.where(as_int >= 1 << 23, as_int - (1 << 24), as_int)
        samples = as_int.astype(np.float32) / float(1 << 23)
    else:
        raise WAVError(
            f"Unsupported WAV format: tag={audio_format}, bits={bits_per_sample}"
        )

    frames = len(samples) // channels
    if frames <= 0:
        raise WAVError("WAV file is empty (0 frames)")
    samples = samples[: frames * channels].reshape(frames, channels)
    return WAVData(sample_rate=float(sample_rate), audio=samples.T.copy())


def save(path: Union[str, BinaryIO], audio: np.ndarray, sample_rate: float,
         dtype: str = "float32") -> None:
    """Write [channels, frames] audio to a WAV file.

    dtype: 'float32' (default, decode-identical) or 'int16'.
    """
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None, :]
    channels, frames = audio.shape
    interleaved = np.ascontiguousarray(audio.T)

    if dtype == "float32":
        fmt_tag, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
        payload = interleaved.astype("<f4").tobytes()
    elif dtype == "int16":
        fmt_tag, bits = _WAVE_FORMAT_PCM, 16
        clipped = np.clip(interleaved, -1.0, 1.0 - 1.0 / 32768.0)
        payload = (clipped * 32768.0).round().astype("<i2").tobytes()
    else:
        raise WAVError(f"unsupported write dtype {dtype}")

    block_align = channels * bits // 8
    byte_rate = int(sample_rate) * block_align
    fmt_chunk = struct.pack(
        "<HHIIHH", fmt_tag, channels, int(sample_rate), byte_rate, block_align, bits
    )
    body = (
        b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
        + b"data" + struct.pack("<I", len(payload)) + payload
    )
    blob = b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body

    if isinstance(path, str):
        with open(path, "wb") as f:
            f.write(blob)
    else:
        path.write(blob)


def extract_stereo(wav: WAVData) -> tuple:
    """(left, right) extraction with mono duplication (ref WAVLoader.swift:105-122)."""
    if wav.channel_count < 1:
        raise WAVError(f"Invalid channel count: {wav.channel_count}")
    left = wav.audio[0]
    right = wav.audio[1] if wav.channel_count >= 2 else left
    return left, right
