"""Self-contained WAV audio I/O (no soundfile/librosa dependency).

The port's copy of zeronotesamba_tpu/data/audio_io.py: a pure-numpy
RIFF/WAVE reader supporting PCM 8/16/24/32-bit and IEEE float32/64, mono or
multi-channel, and a PCM16/float32 writer. MP3 is not supported; callers get
a clear error and should pre-convert to WAV.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file.

    Returns ``(signal, sample_rate)`` where ``signal`` is float32 in [-1, 1]
    with shape ``(num_samples,)`` for mono or ``(num_samples, channels)``.
    """
    with open(path, "rb") as fh:
        data = fh.read()

    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == _WAVE_FORMAT_EXTENSIBLE:
        # SubFormat GUID's first 2 bytes carry the real format tag.
        # They live at offset 24 of the fmt chunk body (8 bytes past cbSize).
        raise ValueError(f"{path}: WAVE_FORMAT_EXTENSIBLE not supported yet")

    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 8:
            sig = (raw_np(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            sig = raw_np(raw, np.dtype("<i2")).astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            sig = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            sig = raw_np(raw, np.dtype("<i4")).astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            sig = raw_np(raw, np.dtype("<f4")).astype(np.float32)
        elif bits == 64:
            sig = raw_np(raw, np.dtype("<f8")).astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format tag {audio_format:#x} (mp3? convert to wav)")

    if channels > 1:
        sig = sig[: (len(sig) // channels) * channels].reshape(-1, channels)
    return sig, int(sample_rate)


def raw_np(raw: bytes, dtype: np.dtype) -> np.ndarray:
    itemsize = np.dtype(dtype).itemsize
    usable = (len(raw) // itemsize) * itemsize
    return np.frombuffer(raw[:usable], dtype=dtype)


def write_wav(path: str, signal: np.ndarray, sample_rate: int, *, dtype: str = "int16") -> None:
    """Write mono or (N, C) float signal to a PCM16 or float32 WAV file."""
    sig = np.asarray(signal)
    if sig.ndim == 1:
        sig = sig[:, None]
    channels = sig.shape[1]
    if dtype == "int16":
        body = np.clip(np.round(sig * 32767.0), -32768, 32767).astype("<i2").tobytes()
        fmt_tag, bits = _WAVE_FORMAT_PCM, 16
    elif dtype == "float32":
        body = sig.astype("<f4").tobytes()
        fmt_tag, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
    else:
        raise ValueError(f"unsupported dtype {dtype}")

    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    fmt_chunk = struct.pack("<HHIIHH", fmt_tag, channels, sample_rate, byte_rate, block_align, bits)
    riff_size = 4 + (8 + len(fmt_chunk)) + (8 + len(body))
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", riff_size) + b"WAVE")
        fh.write(b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk)
        fh.write(b"data" + struct.pack("<I", len(body)) + body)


def convert_to_mono(signal: np.ndarray) -> np.ndarray:
    """Fold a (N,C)/(C,N) signal to mono by channel mean.

    Capability parity with reference utilities.convert_to_mono
    (zeroNoteSamba/processing/utilities.py:6-27) but channel-count agnostic.
    """
    sig = np.asarray(signal)
    if sig.ndim == 1:
        return sig
    if sig.ndim != 2:
        raise ValueError("signal must be 1D or 2D")
    # Orient to (N, C): assume the longer axis is time.
    if sig.shape[0] < sig.shape[1]:
        sig = sig.T
    if sig.shape[1] == 1:
        return sig[:, 0]
    return sig.mean(axis=1).astype(sig.dtype)


def load_audio(path: str, target_sr: int | None = None) -> Tuple[np.ndarray, int]:
    """Load a WAV file as mono float32, optionally resampled.

    Equivalent of reference utilities.convert_to_xxhz/preprocess
    (zeroNoteSamba/processing/utilities.py:30-53).
    """
    if not path.endswith(".wav"):
        raise ValueError(f"{path}: only .wav supported (pre-convert mp3 to wav)")
    sig, sr = read_wav(path)
    mono = convert_to_mono(sig)
    if target_sr is not None and target_sr != sr:
        from zeronotesamba_torch.ops.resample import resample_poly_host

        mono = resample_poly_host(mono, sr, target_sr)
        sr = target_sr
    return mono.astype(np.float32), sr
