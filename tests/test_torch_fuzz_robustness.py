"""Robustness fuzzing of the PyTorch port: the cases of
tests/test_fuzz_robustness.py against airwave_tpu_torch's io/apo, io/wav,
graph/frame_adapter and tools/sofa. The loaders and parsers fail only with
their typed errors, and the frame adapter conserves samples under random
callback schedules. Then the same seeded blobs go through both packages:
either both raise their typed error (with the same message), or both parse
to equal definitions and equal audio."""

import dataclasses
import io as _io

import numpy as np
import pytest

from airwave_tpu.io import apo as japo
from airwave_tpu.io import wav as jwav
from airwave_tpu.utils.errors import EqualizerParseError as JParseError
from airwave_tpu.utils.errors import WAVError as JWAVError
from airwave_tpu_torch.graph.frame_adapter import FrameAdapter
from airwave_tpu_torch.io import apo, wav
from airwave_tpu_torch.utils.errors import EqualizerParseError, WAVError

WORDS = ["Filter", "Preamp:", "ON", "OFF", "PK", "LSC", "HSC", "Fc", "Hz",
         "Gain", "dB", "Q", "1:", "-3.0", "nan", "1e3", "#x", ":", "100", "0",
         "-", "âˆž"]


def random_bytes(seed: int, count: int, longest: int):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        n = int(rng.integers(0, longest))
        yield bytes(rng.integers(0, 256, n, dtype=np.uint8))


def random_apo_text(seed: int, count: int):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        lines = [
            " ".join(rng.choice(WORDS, size=rng.integers(1, 9)))
            for _ in range(rng.integers(1, 8))
        ]
        yield "\n".join(lines).encode()


def corrupted_wavs(seed: int, count: int, save=wav.save):
    rng = np.random.default_rng(seed)
    buf = _io.BytesIO()
    save(buf, rng.standard_normal((2, 64)).astype(np.float32), 48_000)
    blob = bytearray(buf.getvalue())
    for _ in range(count):
        corrupted = bytearray(blob)
        pos = int(rng.integers(0, len(corrupted)))
        corrupted[pos] = int(rng.integers(0, 256))
        yield bytes(corrupted)


def test_apo_parser_never_crashes_on_random_bytes():
    for i, blob in enumerate(random_bytes(0, 200, 400)):
        try:
            definition = apo.parse(blob, f"fuzz-{i}.txt")
            assert definition.preamp_db != 0 or definition.enabled_filters
        except EqualizerParseError:
            pass  # the only acceptable failure mode


def test_apo_parser_never_crashes_on_random_text_lines():
    for i, blob in enumerate(random_apo_text(1, 200)):
        try:
            apo.parse(blob, f"fuzz-{i}.txt")
        except EqualizerParseError:
            pass


def test_wav_loader_never_crashes_on_random_bytes():
    for blob in random_bytes(2, 200, 300):
        try:
            wav.load(blob)
        except WAVError:
            pass


def test_wav_loader_handles_corrupted_valid_header():
    for blob in corrupted_wavs(3, 100):
        try:
            data = wav.load(blob)
            assert data.channel_count > 0
        except WAVError:
            pass


def test_frame_adapter_conservation_under_random_schedules():
    """Property: real (non-inserted) output samples come out in order and
    unmodified, never more than the input, and equal the input minus what
    is still pending or in the FIFO; inserted zeros appear only on
    underflow."""
    rng = np.random.default_rng(4)
    for trial in range(10):
        block = int(rng.choice([8, 32, 512]))
        adapter = FrameAdapter(lambda b: b[:, :2], batch=1, in_channels=2,
                               block_size=block,
                               max_frames_per_callback=4096)
        seq = np.arange(1, 20_001, dtype=np.float32)
        cursor, outputs = 0, []
        for _ in range(int(rng.integers(5, 30))):
            n = int(rng.integers(1, 4097))
            chunk = seq[cursor:cursor + n]
            if len(chunk) < n:
                break
            cursor += n
            x = np.tile(chunk[None, None, :], (1, 2, 1))
            outputs.append(adapter.process(x))
        y = np.concatenate(outputs, axis=-1)[0, 0]
        nonzero = y[y != 0]
        np.testing.assert_array_equal(nonzero, seq[: len(nonzero)])
        assert len(nonzero) <= cursor
        backlog = adapter.pending_count + adapter.fifo_count
        assert len(nonzero) == cursor - backlog


def test_sofa_reader_rejects_truncated_hdf5(tmp_path):
    from airwave_tpu_torch.tools.sofa import ConversionError, read_sofa_hrir
    from tests.test_tools import FULL_RING, write_sofa

    path = write_sofa(tmp_path / "x.sofa", FULL_RING)
    blob = open(path, "rb").read()
    bad = tmp_path / "trunc.sofa"
    bad.write_bytes(blob[: len(blob) // 3])
    with pytest.raises(ConversionError):
        read_sofa_hrir(str(bad))


def random_presets(seed: int, count: int):
    """Preset-shaped text: preamp and filter lines with random types and
    values, some of them out of range, misspelt or missing."""
    rng = np.random.default_rng(seed)
    kinds = ["PK", "LSC", "HSC", "LS", "HS", "XX"]
    for _ in range(count):
        lines = []
        if rng.random() < 0.7:
            lines.append(f"Preamp: {rng.uniform(-12, 3):.2f} dB")
        for n in range(int(rng.integers(0, 6))):
            state = "ON" if rng.random() < 0.9 else "OFF"
            fc = float(rng.choice([rng.uniform(20, 20_000), 30_000.0, 0.0]))
            q = float(rng.choice([rng.uniform(0.3, 4), 0.0]))
            line = (f"Filter {n + 1}: {state} {rng.choice(kinds)} Fc {fc:.1f}"
                    f" Hz Gain {rng.uniform(-12, 12):.2f} dB Q {q:.3f}")
            if rng.random() < 0.1:
                line = line[: int(rng.integers(1, len(line)))]
            lines.append(line)
        yield "\n".join(lines).encode()


def _definition(d) -> tuple:
    """A package-neutral record of a parsed definition."""
    return (d.preamp_db, tuple(
        tuple(v.name if hasattr(v, "name") else v
              for v in dataclasses.astuple(f)) for f in d.filters))


def _outcome(parse, error, blob, name):
    try:
        return "ok", parse(blob, name)
    except error as err:
        return "error", str(err)


BLOBS = {
    "apo_bytes": lambda: random_bytes(0, 200, 400),
    "apo_text": lambda: random_apo_text(1, 200),
    "apo_presets": lambda: random_presets(5, 200),
    "wav_bytes": lambda: random_bytes(2, 200, 300),
    "wav_corrupted": lambda: corrupted_wavs(3, 100, jwav.save),
}


@pytest.mark.parametrize("kind", sorted(BLOBS))
def test_both_packages_agree_on_random_blobs(kind):
    if kind.startswith("apo"):
        both = ((japo.parse, JParseError), (apo.parse, EqualizerParseError))
    else:
        both = ((lambda b, _: jwav.load(b), JWAVError),
                (lambda b, _: wav.load(b), WAVError))
    kinds = set()
    for i, blob in enumerate(BLOBS[kind]()):
        (jk, jv), (tk, tv) = (_outcome(parse, error, blob, f"fuzz-{i}.txt")
                              for parse, error in both)
        assert jk == tk, (i, jv, tv)
        kinds.add(jk)
        if jk == "error":
            assert jv == tv, i
        elif kind.startswith("apo"):
            assert _definition(jv) == _definition(tv), i
        else:
            assert jv.sample_rate == tv.sample_rate, i
            np.testing.assert_array_equal(jv.audio, tv.audio)
    if kind in ("apo_presets", "wav_corrupted"):
        assert kinds == {"ok", "error"}  # both outcomes were exercised
