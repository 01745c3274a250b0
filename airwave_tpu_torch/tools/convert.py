"""SOFA -> 14-channel HeSuVi WAV converter (offline HRIR dataset production).

Produces datasets interchangeable with the reference tool
(tools/ss2-to-hesuvi/convert.py), so the numeric contract is
pinned — everything else here is this framework's own design:
  - target azimuths FC 0deg, FL/FR +-30 (configurable up to 90), SL/SR +-90,
    BL/BR +-135; +azimuth = listener-left (ref :21-29, 340-350)
  - nearest measurement per target by great-circle error against the
    horizontal target direction; near-ties (within 1e-10 deg) resolve to the
    lowest measurement index; selection fails above the max-error limit,
    default 5 deg (ref :353-383)
  - fractional source delays rendered with a 65-tap Blackman-windowed sinc;
    integer parts zero-padded per channel (ref :386-428)
  - loudness: one global gain matching the mean FL/FR binaural L2 energy to
    a reference target (ref :118-162)
  - float32 WAV output validated decode-identical + schema-v2 JSON manifest
    with hashes, directions, delays, and gain (ref :451-542)

CLI: python -m airwave_tpu_torch.tools.convert SRC [SRC...] --output-dir DIR

Port of airwave_tpu/tools/convert.py, the same host code: the port keeps its
own copy and imports no module of the JAX package. One difference: main() leaves the process's SIGPIPE disposition
alone (the JAX tool resets it to the default, which makes an embedding
process die on a socket's peer close); only the `__main__` entry does.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from airwave_tpu_torch.io import wav as wav_io
from airwave_tpu_torch.tools.sofa import ConversionError, SofaHRIR, read_sofa_hrir, sha256_file

# +azimuth is listener-left (matches the SOFA listener frame's left axis).
DEFAULT_TARGET_AZIMUTHS: Dict[str, float] = {
    "FC": 0.0, "FL": 30.0, "FR": -30.0,
    "SL": 90.0, "SR": -90.0, "BL": 135.0, "BR": -135.0,
}

# HeSuVi 14-track order (see assets/channel_maps.py hesuvi_14_channel).
HESUVI_LAYOUT: Tuple[Tuple[str, str], ...] = (
    ("FL", "left"), ("FL", "right"),
    ("SL", "left"), ("SL", "right"),
    ("BL", "left"), ("BL", "right"),
    ("FC", "left"),
    ("FR", "right"), ("FR", "left"),
    ("SR", "right"), ("SR", "left"),
    ("BR", "right"), ("BR", "left"),
    ("FC", "right"),
)

# Track indices of the two front binaural pairs in HESUVI_LAYOUT, used by
# the loudness calibration: FL -> (left ear, right ear), FR likewise.
FRONT_PAIR_TRACKS: Tuple[Tuple[int, int], ...] = ((0, 1), (8, 7))

FRACTIONAL_DELAY_TAPS = 65
TIE_TOLERANCE_DEG = 1e-10
EPSILON = 1e-9

# Mean FL/FR binaural L2 energy of the known-good preset the ecosystem
# calibrates against (dht.wav; pinned in BASELINE.md).
DEFAULT_LOUDNESS_TARGET = 1.0163817234826116


@dataclasses.dataclass(frozen=True)
class DirectionSelection:
    speaker: str
    target_azimuth_deg: float
    measurement_index: int
    actual_azimuth_deg: float
    actual_elevation_deg: float
    angular_error_deg: float


def target_azimuths(front_azimuth_deg: float = 30.0) -> Dict[str, float]:
    if not (np.isfinite(front_azimuth_deg) and 0 < front_azimuth_deg <= 90):
        raise ConversionError(
            f"front azimuth {front_azimuth_deg} is outside (0, 90] deg"
        )
    targets = dict(DEFAULT_TARGET_AZIMUTHS)
    targets["FL"] = float(front_azimuth_deg)
    targets["FR"] = -float(front_azimuth_deg)
    return targets


def _nearest_measurement(
    source_vectors: np.ndarray, azimuth_deg: float
) -> Tuple[int, float]:
    """Index of the measurement closest (great-circle) to a horizontal
    direction, and its error in degrees. Near-ties within TIE_TOLERANCE_DEG
    go to the lowest index so reruns are reproducible."""
    rad = math.radians(azimuth_deg)
    target = np.array([math.cos(rad), math.sin(rad), 0.0])
    cosines = np.clip(source_vectors @ target, -1.0, 1.0)
    errors = np.degrees(np.arccos(cosines))
    best = float(errors.min())
    index = int(np.argmax(errors <= best + TIE_TOLERANCE_DEG))
    return index, best


def select_directions(
    data: SofaHRIR,
    max_error_deg: float = 5.0,
    targets: Dict[str, float] = None,
) -> Dict[str, DirectionSelection]:
    if targets is None:
        targets = DEFAULT_TARGET_AZIMUTHS
    if not np.isfinite(max_error_deg) or max_error_deg < 0:
        raise ConversionError(
            f"max angular error {max_error_deg} must be a finite value >= 0"
        )
    out: Dict[str, DirectionSelection] = {}
    for speaker, azimuth in targets.items():
        index, error = _nearest_measurement(data.source_vectors, azimuth)
        if error > max_error_deg + EPSILON:
            raise ConversionError(
                f"no measurement within {max_error_deg:.6f} deg of {speaker} "
                f"(closest is {error:.6f} deg away)"
            )
        out[speaker] = DirectionSelection(
            speaker=speaker,
            target_azimuth_deg=azimuth,
            measurement_index=index,
            actual_azimuth_deg=float(data.source_azimuths[index]),
            actual_elevation_deg=float(data.source_elevations[index]),
            angular_error_deg=error,
        )
    return out


def fractional_delay_kernel(fraction: float,
                            taps: int = FRACTIONAL_DELAY_TAPS) -> np.ndarray:
    if taps < 3 or taps % 2 == 0:
        raise ValueError(f"tap count {taps} must be odd and >= 3")
    half = taps // 2
    offsets = np.arange(-half, half + 1, dtype=np.float64)
    kernel = np.sinc(offsets - fraction) * np.blackman(taps)
    return kernel / np.sum(kernel)


def _shift_channel(samples: np.ndarray, delay: float,
                   use_kernel: bool) -> np.ndarray:
    """One channel's delay: sinc-interpolate the fractional part (when the
    matrix has any fractional delay at all, so every channel carries the
    same causal kernel group delay), zero-pad the integer part."""
    delay = float(delay)
    pad = int(math.floor(delay + 1e-12))
    if use_kernel:
        # Against PAD, not floor(delay): for a delay sitting within the
        # 1e-12 epsilon below an integer, floor(delay) is one less than
        # pad and the kernel would re-add the whole sample the epsilon
        # just rounded away (fraction ~ 1.0 -> a full extra sample).
        fraction = delay - pad
        samples = np.convolve(samples, fractional_delay_kernel(fraction))
    return np.concatenate([np.zeros(pad), samples]) if pad else samples


def materialize_delays(
    channels: Sequence[np.ndarray], delays: Sequence[float]
) -> np.ndarray:
    """Apply per-channel sample delays; returns [frames, channels] float32."""
    if not channels or len(channels) != len(delays):
        raise ConversionError(
            f"{len(channels)} channels vs {len(delays)} delays"
        )
    arrays = [np.asarray(c, np.float64) for c in channels]
    if any(a.ndim != 1 or a.size == 0 for a in arrays):
        raise ConversionError("each channel must be a 1-D array with samples")
    delay_values = np.asarray(delays, np.float64)
    if not np.all(np.isfinite(delay_values)) or np.any(delay_values < 0):
        raise ConversionError("delays must all be finite and >= 0 samples")

    any_fractional = bool(
        np.any(np.abs(delay_values - np.rint(delay_values)) > 1e-9)
    )
    rendered = [
        _shift_channel(samples, delay, any_fractional)
        for samples, delay in zip(arrays, delay_values)
    ]
    frames = max(c.size for c in rendered)
    output = np.zeros((frames, len(rendered)), np.float32)
    for i, c in enumerate(rendered):
        output[: c.size, i] = c.astype(np.float32)
    if not np.all(np.isfinite(output)):
        raise ConversionError("delay rendering left NaN/inf in the output")
    return output


def front_stereo_binaural_energy(samples: np.ndarray) -> float:
    """Mean L2 energy across the FL and FR binaural pairs (the calibration
    statistic the dataset ecosystem is normalized on)."""
    array = np.asarray(samples, np.float64)
    if array.ndim != 2 or array.shape[0] == 0 or array.shape[1] != 14:
        raise ConversionError(
            f"loudness statistic needs [frames, 14] audio, got "
            f"{getattr(array, 'shape', None)}"
        )
    if not np.all(np.isfinite(array)):
        raise ConversionError("loudness statistic input has NaN/inf samples")
    norms = np.linalg.norm(array, axis=0)
    pair_energies = [
        math.hypot(norms[a], norms[b]) for a, b in FRONT_PAIR_TRACKS
    ]
    energy = float(np.mean(pair_energies))
    if not np.isfinite(energy) or energy <= EPSILON:
        raise ConversionError("front binaural tracks carry no impulse energy")
    return energy


def calibrate_loudness(
    samples: np.ndarray, target_energy: float = DEFAULT_LOUDNESS_TARGET
):
    """One global gain to hit the front-stereo binaural energy target.
    Returns (calibrated float32 [frames, 14], source_energy, gain)."""
    if not np.isfinite(target_energy) or target_energy <= EPSILON:
        raise ConversionError(
            f"loudness target {target_energy} is not a usable positive number"
        )
    source = front_stereo_binaural_energy(samples)
    gain = target_energy / source
    output = (np.asarray(samples, np.float64) * gain).astype(np.float32)
    if not np.all(np.isfinite(output)):
        raise ConversionError("loudness gain overflowed float32")
    return output, source, gain


def build_output(data: SofaHRIR, selections: Dict[str, DirectionSelection]):
    """Gather per-(speaker, ear) IRs into the HeSuVi track order."""
    ears = {"left": data.left_receiver, "right": data.right_receiver}
    channels, delays = [], []
    for speaker, ear in HESUVI_LAYOUT:
        m = selections[speaker].measurement_index
        r = ears[ear]
        channels.append(data.impulse_responses[m, r, :])
        delays.append(float(data.delays[m, r]))
    return materialize_delays(channels, delays), delays


def validate_output(path: str, expected: np.ndarray, sample_rate: int) -> None:
    """Decode-identical check: the written float32 WAV reads back bit-exact."""
    loaded = wav_io.load(path)
    if loaded.sample_rate != sample_rate:
        raise ConversionError(
            f"written WAV decodes at {loaded.sample_rate} Hz, not {sample_rate}"
        )
    actual = loaded.audio.T  # [frames, channels]
    if actual.shape != expected.shape:
        raise ConversionError(
            f"written WAV decodes as {actual.shape}, not {expected.shape}"
        )
    if not np.array_equal(actual, expected):
        raise ConversionError("written WAV does not decode bit-identical")


def build_manifest(
    data: SofaHRIR,
    output_name: str,
    output_hash: str,
    frames: int,
    selections: Dict[str, DirectionSelection],
    channel_delays: Sequence[float],
    source_energy: float,
    gain: float,
    target_energy: float,
) -> dict:
    return {
        "schema_version": 2,
        "source": {
            "path": os.path.basename(data.source_path),
            "sha256": data.source_hash,
            "sofa_convention": "SimpleFreeFieldHRIR",
            "data_type": "FIR",
            "database": data.database_name,
            "listener": data.listener_short_name,
            "license": data.license_name,
            "measurement_count": int(data.impulse_responses.shape[0]),
            "ir_frames": int(data.impulse_responses.shape[2]),
        },
        "output": {
            "path": output_name,
            "sha256": output_hash,
            "sample_rate_hz": data.sample_rate,
            "frames": frames,
            "channels": 14,
            "wav_subtype": "FLOAT",
        },
        "receiver_indices": {
            "left": data.left_receiver, "right": data.right_receiver
        },
        "loudness_calibration": {
            "method": "global_gain_to_reference_front_stereo_binaural_l2_energy",
            "uncalibrated_front_stereo_binaural_energy": source_energy,
            "target_front_stereo_binaural_energy": target_energy,
            "linear_gain": gain,
            "gain_db": 20.0 * math.log10(gain),
        },
        "directions": [
            {
                "speaker": s.speaker,
                "target_azimuth_deg": s.target_azimuth_deg,
                "measurement_index": s.measurement_index,
                "actual_azimuth_deg": round(s.actual_azimuth_deg, 9),
                "actual_elevation_deg": round(s.actual_elevation_deg, 9),
                "angular_error_deg": round(s.angular_error_deg, 9),
                "source_delays_samples": {
                    "left": float(data.delays[s.measurement_index,
                                              data.left_receiver]),
                    "right": float(data.delays[s.measurement_index,
                                               data.right_receiver]),
                },
            }
            for s in selections.values()
        ],
        "channel_map": [
            {"index": i, "speaker": speaker, "ear": ear,
             "delay_samples": float(channel_delays[i])}
            for i, (speaker, ear) in enumerate(HESUVI_LAYOUT)
        ],
    }


def convert_file(
    source_path: str,
    output_dir: str,
    max_error_deg: float = 5.0,
    front_azimuth_deg: float = 30.0,
    loudness_target: float = DEFAULT_LOUDNESS_TARGET,
) -> Tuple[str, str]:
    """Convert one SOFA file. Returns (wav_path, manifest_path)."""
    data = read_sofa_hrir(source_path)
    selections = select_directions(
        data, max_error_deg, target_azimuths(front_azimuth_deg)
    )
    raw, channel_delays = build_output(data, selections)
    calibrated, source_energy, gain = calibrate_loudness(raw, loudness_target)

    os.makedirs(output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(source_path))[0]
    wav_path = os.path.join(output_dir, f"{stem}.wav")
    manifest_path = os.path.join(output_dir, f"{stem}.json")

    wav_io.save(wav_path, calibrated.T, data.sample_rate, dtype="float32")
    validate_output(wav_path, calibrated, data.sample_rate)

    manifest = build_manifest(
        data, os.path.basename(wav_path), sha256_file(wav_path),
        calibrated.shape[0], selections, channel_delays,
        source_energy, gain, loudness_target,
    )
    with open(manifest_path, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return wav_path, manifest_path


def discover_sources(paths: Sequence[str]) -> List[str]:
    found: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            for root, _dirs, files in os.walk(path):
                found.extend(
                    os.path.join(root, f) for f in sorted(files)
                    if f.lower().endswith(".sofa")
                )
        else:
            found.append(path)
    return found


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert SimpleFreeFieldHRIR SOFA files to 14-ch HeSuVi WAVs"
    )
    parser.add_argument("sources", nargs="+", help="SOFA files or directories")
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--max-error-deg", type=float, default=5.0)
    parser.add_argument("--front-azimuth-deg", type=float, default=30.0)
    parser.add_argument("--loudness-target", type=float,
                        default=DEFAULT_LOUDNESS_TARGET)
    args = parser.parse_args(argv)

    sources = discover_sources(args.sources)
    if not sources:
        parser.error("no .sofa sources found")
    failures = 0
    for source in sources:
        try:
            wav_path, manifest_path = convert_file(
                source, args.output_dir, args.max_error_deg,
                args.front_azimuth_deg, args.loudness_target,
            )
            print(f"ok: {source} -> {wav_path}")
        except ConversionError as err:
            failures += 1
            print(f"FAIL: {source}: {err}")
    return 1 if failures else 0


if __name__ == "__main__":
    from airwave_tpu_torch.tools import die_quietly_on_sigpipe

    die_quietly_on_sigpipe()
    raise SystemExit(main())
